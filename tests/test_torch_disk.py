"""lightglue_tpu_torch DISK against lightglue_tpu on the CPU, on the same
seeded numpy inputs and weights (the JAX package's init, key 0; DISK's
instance norms keep its activations at unit scale, so the random heatmap
is not flat): the layer functions, the trunk, the heatmap, the
descriptors at keypoints, ``models.disk.forward`` in fp32 and at mp, the
state-dict converter, and images to matches through ``match_pair`` and
``make_end_to_end`` into the ``"disk"`` matcher preset.

Tolerances: fp32 keypoints and ``valid`` equal, scores and descriptors
within 1e-5 (the two sum each conv in another order); the tap-product
conv, PReLU, instance norm, pool and upsampling at bf16 equal to the bit.
At mp a conv's fp32 sum rounded to bf16 lands one step apart where the
two orders straddle a rounding boundary (a few outputs in a thousand
after one block; the instance norms carry a flip into the next block), so
whole extractions are held as test_torch_mp_extract.py holds SuperPoint's
and ALIKED's: every keypoint one side keeps and the other does not is a
near-tie, within 4 steps of its score of the top-k's cut or of its NMS
window's runner-up (scripts/keypoint_margins.py), and the shared ones'
descriptors agree. The JAX references at mp compile with XLA's
``xla_allow_excess_precision`` off (else XLA on the CPU drops bf16 round
trips that the port keeps).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightglue_tpu import configs as jconfigs
from lightglue_tpu import end_to_end as jend_to_end
from lightglue_tpu import nn as jnn
from lightglue_tpu import pipeline as jpipeline
from lightglue_tpu import weights as jweights
from lightglue_tpu.models import disk as jdisk
from lightglue_tpu.models import lightglue as jlg
from lightglue_tpu_torch import DISK, LightGlue, configs, end_to_end, match_pair
from lightglue_tpu_torch import nn, pipeline, weights
from lightglue_tpu_torch.models import disk
from lightglue_tpu_torch.scripts import keypoint_margins as km
from lightglue_tpu_torch.synthetic import image_pair

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
K = 256  # keypoints per image at 96 x 128
BF = torch.bfloat16


def _strict(fn, *args, **static):
    """fn(*args, **static), compiled by XLA with every bf16 rounding kept."""
    f = jax.jit(functools.partial(fn, **static))
    return f.lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


@functools.lru_cache(maxsize=None)
def _params():
    """(JAX tree, port tree) of the JAX package's init, key 0."""
    jp = jax.tree.map(np.asarray, jax.jit(jdisk.init_params, static_argnums=1)(
        jax.random.key(0), jconfigs.DISKConfig()))
    return jp, weights.disk_from_jax_params(jp)


def _images(seed=0, b=2, h=96, w=128):
    rng = np.random.default_rng(seed)
    return np.stack([image_pair(rng, h, w)[0] for _ in range(b)])[..., None]


def _nchw(x):
    return torch.from_numpy(np.array(jnp.asarray(x).astype(jnp.float32))
                            ).permute(0, 3, 1, 2).contiguous()


def _np(t):
    t = t.float()
    return (t.permute(0, 2, 3, 1) if t.dim() == 4 else t).numpy()


@functools.lru_cache(maxsize=None)
def _jax_run(mp):
    """The JAX package's trunk (NHWC), heatmap and features on _images(),
    at mp with every bf16 rounding kept."""
    jp, _ = _params()
    img = jnp.asarray(np.repeat(_images(), 3, -1))
    x = img.astype(jnp.bfloat16) if mp else img
    run = _strict if mp else (lambda fn, *a, **s: jax.jit(
        functools.partial(fn, **s))(*a))
    z = run(jdisk.unet_trunk, jp, x)
    heat = run(jdisk._heatmap_tapmat, jp, z, desc_dim=128)
    conf = jconfigs.DISKConfig(max_num_keypoints=K, mp=mp)
    feats = run(lambda p, x: jdisk.forward(p, conf, x), jp,
                jnp.asarray(_images()))
    return z, heat, feats


# --- the building blocks ------------------------------------------------------


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("bias", [False, True])
def test_tapmat_bf16_equals_jax_to_the_bit(k, bias):
    """nn.conv2d_tapmat on bf16 against the JAX package's conv2d_tapmat at
    bf16 (each tap's partial rounded, fp32 tap sums rounded, the bias in
    bf16): equal to the bit, at DISK's heatmap shape (80 -> 1, 5x5) and
    ALIKED's score head's (8 -> 4, 3x3)."""
    rng = np.random.default_rng(k)
    cin, cout = (80, 1) if k == 5 else (8, 4)
    x = jnp.asarray(rng.standard_normal((2, 24, 40, cin)), jnp.bfloat16)
    w = rng.standard_normal((k, k, cin, cout)).astype(np.float32) * 0.2
    p = {"w": jnp.asarray(w)}
    if bias:
        p["b"] = jnp.asarray(rng.standard_normal(cout).astype(np.float32))
    want = np.asarray(_strict(jnn.conv2d_tapmat, p, x).astype(jnp.float32))
    tp = {"w": torch.from_numpy(w.transpose(3, 2, 0, 1).copy())}
    if bias:
        tp["b"] = torch.from_numpy(np.asarray(p["b"]))
    got = nn.conv2d_tapmat(tp, _nchw(x).to(BF))
    assert got.dtype == BF
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_layer_functions_match_jax(dtype):
    """PReLU, instance norm, the 2x2 average pool and the x2 bilinear
    upsampling against the JAX package's on one map: equal to the bit at
    bf16, and PReLU and the pool in fp32; in fp32 the instance norm within
    1e-6 (its statistics summed in another order) and the upsampling within
    2e-6 of values up to about 12, one step of its products (XLA's product
    rounds a tap that the port fuses at this shape, ``nn.upsample2``)."""
    jp, tp = _params()
    rng = np.random.default_rng(3)
    y = jnp.asarray(rng.standard_normal((2, 24, 32, 16)) * 3, dtype)
    yt = _nchw(y).to(BF if dtype == jnp.bfloat16 else torch.float32)
    run = _strict if dtype == jnp.bfloat16 else (lambda f, *a: jax.jit(f)(*a))
    for name, want, got in (
            ("prelu", run(jdisk._prelu, jp["down"]["1"]["gate"], y),
             nn.prelu(tp["down"]["1"]["gate"]["alpha"], yt)),
            ("instance_norm", run(jnn.instance_norm, y), nn.instance_norm(yt)),
            ("avg_pool", run(jdisk._avg_pool2, y), disk.avg_pool2(yt)),
            ("upsample", run(jdisk._upsample2_bilinear, y), nn.upsample2(yt))):
        assert got.dtype == yt.dtype, name
        want = np.asarray(want.astype(jnp.float32))
        if name == "upsample" and dtype == jnp.float32:
            np.testing.assert_allclose(_np(got), want, rtol=0, atol=2e-6,
                                       err_msg=name)
        elif name == "instance_norm" and dtype == jnp.float32:
            np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(_np(got), want, err_msg=name)


def test_upsample_single_plane_equals_jax_to_the_bit():
    """At one plane (SIFT's first octave) XLA's product fuses both taps as
    ``nn.upsample2`` does: equal to the bit in fp32."""
    x = np.random.default_rng(5).random((96, 128)).astype(np.float32) * 255
    want = np.asarray(jax.jit(lambda v: jax.image.resize(
        v, (192, 256), "bilinear"))(jnp.asarray(x)))
    np.testing.assert_array_equal(nn.upsample2(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("shape", [(96, 128), (2, 3, 7, 9)])
def test_upsample_interpolate_form_within_ulps(shape):
    """``nn.upsample2``'s form for an fp32 CUDA tensor (``F.interpolate``,
    run here on the CPU) against its fused-tap form: the same taps, within
    2 ulp of the input's largest magnitude."""
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(shape)
                         .astype(np.float32))
    got = nn.upsample2_interp(x)
    assert got.shape == (*shape[:-2], 2 * shape[-2], 2 * shape[-1])
    np.testing.assert_allclose(got.numpy(), nn.upsample2(x).numpy(), rtol=0,
                               atol=2.0 ** -22 * float(x.abs().max()))


# --- the model ------------------------------------------------------------------


def test_trunk_heatmap_descriptors_fp32():
    """The trunk and the heatmap within 1e-5 of the JAX package's
    (relative to max(1, |JAX|)); the descriptors at the JAX package's
    keypoints, computed on its trunk, within 1e-5."""
    jp, tp = _params()
    z, heat, feats = _jax_run(False)
    img = torch.from_numpy(np.repeat(_images(), 3, -1)).permute(0, 3, 1, 2)
    zt = disk.unet_trunk(tp, img.contiguous())
    zj = np.asarray(z)
    assert np.abs(_np(zt) - zj).max() <= 1e-5 * max(1.0, np.abs(zj).max())
    ht = disk.heatmap(tp, zt, 128)
    np.testing.assert_allclose(ht.numpy(), np.asarray(heat), atol=1e-5, rtol=0)
    want = jdisk._desc_at_keypoints(jp, z, feats.keypoints, 128)
    got = disk.desc_at_keypoints(tp, _nchw(z), torch.from_numpy(
        np.asarray(feats.keypoints)), 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_forward_fp32_matches_jax():
    """models.disk.forward in fp32: keypoints and valid equal to the JAX
    package's, scores and descriptors within 1e-5."""
    _, tp = _params()
    _, _, want = _jax_run(False)
    got = disk.forward(tp, configs.DISKConfig(max_num_keypoints=K),
                       torch.from_numpy(_images()))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert int(got.valid.sum()) >= 100
    np.testing.assert_array_equal(got.keypoints.numpy(),
                                  np.asarray(want.keypoints))
    for f in ("keypoint_scores", "descriptors"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), atol=1e-5,
                                   rtol=0, err_msg=f)


def test_mp_heatmap_and_descriptors_on_the_same_trunk():
    """At mp, on the JAX package's bf16 trunk: the heatmap (the 5x5
    tap-product form) equal to the bit, the descriptors (fp32 sums of bf16
    products, not rounded back) within 1e-5, fp32."""
    jp, tp = _params()
    z, heat, feats = _jax_run(True)
    zt = _nchw(z).to(BF)
    ht = disk.heatmap(tp, zt, 128)
    assert ht.dtype == torch.float32
    np.testing.assert_array_equal(ht.numpy(), np.asarray(heat.astype(jnp.float32)))
    want = _strict(jdisk._desc_at_keypoints, jp, z, feats.keypoints, desc_dim=128)
    got = disk.desc_at_keypoints(tp, zt, torch.from_numpy(
        np.asarray(feats.keypoints)), 128)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_mp_blocks_flip_by_at_most_one_step():
    """Each conv block at mp on the same bf16 input: at most 1 % of the
    outputs differ, each by at most one bf16 step of the sum before its
    bias (|output| + |bias| bounds it): the fp32 sum rounded to the other
    neighbour (measured 0.6 % on block 1)."""
    jp, tp = _params()
    rng = np.random.default_rng(7)
    for name, cin in (("1", 16), ("2", 32)):
        y = jnp.asarray(rng.standard_normal((2, 24, 32, cin)), jnp.bfloat16)
        want = np.asarray(_strict(jdisk._conv_block, jp["down"][name], y)
                          .astype(jnp.float32))
        got = _np(disk._block(tp["down"][name], _nchw(y).to(BF)))
        diff = np.abs(got - want)
        bias = np.abs(np.asarray(jp["down"][name]["conv"]["b"]))
        step = km.ulp(torch.from_numpy(np.maximum(np.abs(want), np.abs(got))
                                       + bias)).numpy()
        assert (diff > 0).mean() <= 0.01, (name, (diff > 0).mean())
        assert (diff <= step).all(), name


def test_mp_unshared_keypoints_are_near_ties():
    """models.disk.forward at mp against the JAX package's at mp: valid
    within 2 of each other an image, at least 0.85 of the keypoints in
    common (measured 0.93), their descriptors within 2e-2 (a bf16 trunk's
    noise; fp32 against mp moves them by more), and every keypoint that
    one side keeps and the other does not within 4 steps of its score
    (one bf16 step of the heatmap) of the cut or of its window's
    runner-up, on its own side's heatmap (measured: all within 1 step of
    the runner-up)."""
    jp, tp = _params()
    conf = configs.DISKConfig(max_num_keypoints=K, mp=True)
    _, heat_j, want = _jax_run(True)
    img = torch.from_numpy(_images())
    got = disk.forward(tp, conf, img)
    assert got.descriptors.dtype == torch.float32
    gv, wv = got.valid.numpy(), np.asarray(want.valid)
    assert (np.abs(gv.sum(1) - wv.sum(1)) <= 2).all()
    gk, wk = got.keypoints.numpy(), np.asarray(want.keypoints)
    for i in range(gk.shape[0]):
        a = {tuple(p): j for j, p in enumerate(gk[i][gv[i]])}
        both = [(a[tuple(p)], j) for j, p in enumerate(wk[i][wv[i]])
                if tuple(p) in a]
        assert len(both) >= 0.85 * wv[i].sum(), (i, len(both), wv[i].sum())
        gi, wi = zip(*both)
        gd = got.descriptors.numpy()[i][gv[i]][list(gi)]
        wd = np.asarray(want.descriptors)[i][wv[i]][list(wi)]
        assert np.abs(gd - wd).max() <= 2e-2
    x = img.expand(-1, -1, -1, 3).permute(0, 3, 1, 2).contiguous().to(BF)
    heat_t = disk.heatmap(tp, disk.unet_trunk(tp, x), 128)
    heat_j = torch.from_numpy(np.asarray(heat_j.astype(jnp.float32)))
    maps = [(h, disk.detection_map(h, conf), km.ulp(h)) for h in (heat_t, heat_j)]
    m = km.unshared_margins(maps[0], maps[1], K, conf.detection_threshold,
                            conf.nms_window_size // 2)
    print(km.summary(m))
    assert km.faults(m["a"]) == 0 and km.faults(m["b"]) == 0, km.summary(m)


def test_gray_rgb_stride_and_image_size():
    """A gray image is its RGB repeat; H and W must be multiples of 16;
    no keypoint lies outside the true extent given by image_size."""
    _, tp = _params()
    conf = configs.DISKConfig(max_num_keypoints=64)
    img = torch.from_numpy(_images(b=1))
    a = disk.forward(tp, conf, img)
    b = disk.forward(tp, conf, img.expand(-1, -1, -1, 3))
    np.testing.assert_array_equal(a.keypoints.numpy(), b.keypoints.numpy())
    with pytest.raises(ValueError, match="multiples of 16"):
        disk.forward(tp, conf, img[:, :88])
    c = disk.forward(tp, conf, img, torch.tensor([[100.0, 80.0]]))
    kv = c.keypoints[c.valid]
    assert len(kv) and (kv[:, 0] < 100).all() and (kv[:, 1] < 80).all()


# --- weights --------------------------------------------------------------------


def test_state_dict_converter_and_round_trip():
    """disk_from_state_dict takes the key list of kornia's DISK layout
    (tests/fixtures/disk_depth.json), gives the JAX package's
    convert_disk tree transposed, and round-trips through
    disk_to_state_dict; a leftover or a wrong width raises."""
    with open(os.path.join(FIXTURES, "disk_depth.json")) as f:
        keys = json.load(f)["keys"]
    rng = np.random.default_rng(0)
    sd = {k: rng.standard_normal(s).astype(np.float32) for k, s in keys.items()}
    tree = weights.disk_from_state_dict(sd)
    assert "gate" not in tree["down"]["0"] and "gate" in tree["down"]["1"]
    back = weights.disk_to_state_dict(tree)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)
    via_jax = weights.disk_from_jax_params(jweights.convert_disk(sd))
    flat_a = weights.flatten_params(tree)
    flat_b = weights.flatten_params(via_jax)
    assert set(flat_a) == set(flat_b)
    for k in flat_a:
        np.testing.assert_array_equal(flat_a[k], flat_b[k], err_msg=k)
    with pytest.raises(ValueError, match="unconsumed"):
        weights.disk_from_state_dict({**sd, "unet.extra.weight": np.zeros(3)})
    bad = dict(sd)
    bad["unet.path_up.3.conv.2.weight"] = np.zeros((65, 80, 5, 5), np.float32)
    with pytest.raises(ValueError, match="expected"):
        weights.disk_from_state_dict(bad)


def test_jax_params_bridge():
    """disk_from_jax_params reads the flat npz layout and the nested tree
    alike; a missing key or a wrong shape raises."""
    jp, tp = _params()
    flat = {k: np.asarray(v) for k, v in jweights.flatten_tree(jp).items()}
    a = weights.flatten_params(weights.disk_from_jax_params(flat))
    b = weights.flatten_params(tp)
    assert set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)
    with pytest.raises(KeyError):
        weights.disk_from_jax_params({k: v for k, v in flat.items()
                                      if k != "up/3/conv/b"})
    with pytest.raises(ValueError, match="shape"):
        weights.disk_from_jax_params({**flat, "up/3/conv/b": np.zeros(5)})


def test_configs_match_jax():
    mine, theirs = configs.DISKConfig(), jconfigs.DISKConfig()
    assert set(mine.__dataclass_fields__) == set(theirs.__dataclass_fields__)
    for f in mine.__dataclass_fields__:
        assert getattr(mine, f) == getattr(theirs, f), f


@pytest.mark.parametrize("window", [5, 3])
def test_auto_kpts_bucket_matches_jax(window):
    """max_num_keypoints=None: DISK's capacity from its window's radius,
    as the JAX package's."""
    for h, w in ((33, 47), (96, 128), (768, 1024)):
        assert pipeline._auto_kpts_bucket(
            configs.DISKConfig(nms_window_size=window), h, w) == \
            jpipeline._auto_kpts_bucket(
                jconfigs.DISKConfig(nms_window_size=window), h, w)


# --- images to matches ----------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _matcher_flat():
    mconf = jconfigs.lightglue_config("disk", pruning_min_kpts=32)
    return {k: np.asarray(v) for k, v in jweights.flatten_tree(
        jlg.init_params(jax.random.key(1), mconf)).items()}


def _matchers():
    mflat = _matcher_flat()
    mine = LightGlue("disk", params=weights.from_jax_params(
        mflat, configs.lightglue_config("disk")), pruning_min_kpts=32,
        device="cpu")
    theirs = jpipeline.LightGlue("disk", params=jweights.unflatten_tree(mflat),
                                 pruning_min_kpts=32)
    return mine, theirs


def test_match_pair_matches_jax(tmp_path):
    """match_pair(DISK, LightGlue("disk")) on a generated pair, seeded
    random weights in both packages: features as forward's, matches, prune
    and stop equal, matching scores within 1e-3."""
    jp, _ = _params()
    path = str(tmp_path / "disk.npz")
    np.savez(path, **{k: np.asarray(v) for k, v in
                      jweights.flatten_tree(jp).items()})
    ext = DISK(params=path, max_num_keypoints=K, device="cpu")
    jext = jpipeline.DISK(params=jp, max_num_keypoints=K)
    m, jm = _matchers()
    img0, img1, _ = image_pair(np.random.default_rng(4), 96, 128)
    f0, f1, got = match_pair(ext, m, img0, img1, resize=None)
    jf0, jf1, want = jpipeline.match_pair(jext, jm, img0, img1, resize=None)
    for g, w in ((f0, jf0), (f1, jf1)):
        for k in ("valid", "image_size", "keypoints"):
            np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=k)
        for k in ("keypoint_scores", "descriptors"):
            np.testing.assert_allclose(g[k], np.asarray(w[k]), atol=1e-5,
                                       rtol=0, err_msg=k)
    for k in ("matches0", "matches1", "prune0", "prune1"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(got["matching_scores0"],
                               np.asarray(want["matching_scores0"]), atol=1e-3)
    assert got["stop"] == want["stop"]
    with pytest.raises(FileNotFoundError, match="not in this repository"):
        DISK(pretrained=True, device="cpu")
    assert DISK.stride == 16


def test_make_end_to_end_matches_jax():
    """make_end_to_end(disk.forward, "disk" matcher) at B 2 against the JAX
    package's: keypoints, valid, matches equal, scores within 1e-3."""
    jp, tp = _params()
    mflat = _matcher_flat()
    dconf = configs.DISKConfig(max_num_keypoints=K)
    mconf = configs.lightglue_config("disk", pruning_min_kpts=32)
    run = end_to_end.make_end_to_end(disk.forward, tp, dconf,
                                     weights.from_jax_params(mflat, mconf), mconf)
    jrun = jend_to_end.make_end_to_end(
        jdisk.forward, jp, jconfigs.DISKConfig(max_num_keypoints=K),
        jweights.unflatten_tree(mflat),
        jconfigs.lightglue_config("disk", pruning_min_kpts=32))
    a, b = _images(1), _images(2)
    sizes = np.array([[128.0, 96.0]] * 2, np.float32)
    got = run(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(sizes),
              torch.from_numpy(sizes))
    want = jrun(jnp.asarray(a), jnp.asarray(b), jnp.asarray(sizes),
                jnp.asarray(sizes))
    for s in ("feats0", "feats1"):
        for f in ("keypoints", "valid"):
            np.testing.assert_array_equal(
                getattr(getattr(got, s), f).numpy(),
                np.asarray(getattr(getattr(want, s), f)), err_msg=f)
    for f in ("matches0", "matches1"):
        np.testing.assert_array_equal(getattr(got.matches, f).numpy(),
                                      np.asarray(getattr(want.matches, f)))
    np.testing.assert_allclose(got.matches.matching_scores0.numpy(),
                               np.asarray(want.matches.matching_scores0),
                               atol=1e-3)
