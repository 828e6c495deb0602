"""lightglue_tpu_torch SIFT against lightglue_tpu on the CPU, on the same
seeded numpy images: the host backend (``SIFT(backend="opencv")``, equal
to the JAX package's), the DoG scale space (``models.sift_device``
against ``models/sift_jax.py``) stage by stage and whole, and images to
matches through ``match_pair`` and ``make_end_to_end`` from
``SIFTDevice`` into the trained ``"sift"`` matcher
(``weights/synthetic_sift_lightglue.npz``), and ``match_sequence``.

One JAX program (``_jax_stages``, compiled once) gives every stage's
output for one image; each port stage is fed the JAX package's input of
that stage. Exact where the arithmetic is the same: the pyramid (the
CPU's blur, ``sift_device._blur_fma``, reproduces XLA's fused
multiply-adds; the convolutions a CUDA tensor takes are held within an
ulp or two of it), the candidates, the refinement. The orientation histograms, peaks and descriptors go
through exp, atan2, sin, cos and pow, which PyTorch and XLA compute to
within a few ulp of each other, and long sums in another order: held to
1e-5 relative (histograms, angles) and 1e-3 of the 512-scaled
descriptors; a peak kept by one side only must be a near-tie of the 0.8
ratio, with its margin printed (none on these images). The whole
extraction: keypoints, scores and valid equal, scales and oris within
1e-5, the RootSIFT descriptors within 1e-5. Two JAX programs are compiled
(about 22 s each): the stages, and the JAX SIFTDevice's forward, which
serves match_pair and make_end_to_end.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightglue_tpu import configs as jconfigs
from lightglue_tpu import pipeline as jpipeline
from lightglue_tpu.models import sift as jsift
from lightglue_tpu.models import sift_jax as sj
from lightglue_tpu_torch import (LightGlue, SIFT, SIFTDevice, configs,
                                 end_to_end, match_pair, match_sequence)
from lightglue_tpu_torch.models import sift as tsift
from lightglue_tpu_torch.models import sift_device as sd
from lightglue_tpu_torch.synthetic import image_pair

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "weights", "synthetic_sift_lightglue.npz")
K = 128
H, W = 96, 128
CONF = configs.SIFTConfig(max_num_keypoints=K, backend="device")
JCONF = jconfigs.SIFTConfig(max_num_keypoints=K, backend="jax")


@functools.lru_cache(maxsize=None)
def _pair():
    a, b, _ = image_pair(np.random.default_rng(0), H, W)
    return a, b


def _t(x):
    return torch.from_numpy(np.array(x))


def _stages_fn(image):
    """sift_jax.extract_single's stages, each octave's outputs returned."""
    s, k_total = JCONF.num_scales_per_octave, JCONF.max_num_keypoints
    gaussians, dogs, n_oct = sj.build_pyramid(image, JCONF)
    thr = float(np.floor(0.5 * JCONF.detection_threshold / s * 255.0))
    out = []
    for o in range(n_oct):
        n_cand = max(256, (4 * k_total) >> o)
        dog_stack = jax.lax.optimization_barrier(jnp.stack(dogs[o]))
        cand = jax.lax.optimization_barrier(
            sj._extrema_candidates(dog_stack, n_cand, thr))
        ref = jax.lax.optimization_barrier(sj._refine(dog_stack, *cand, JCONF))
        fl, fy, fx, resp, valid = ref
        if n_cand > k_total:
            _, keep = jax.lax.top_k(jnp.where(valid, resp, -1.0), k_total)
            fl, fy, fx, resp, valid = jax.lax.optimization_barrier(
                tuple(a[keep] for a in (fl, fy, fx, resp, valid)))
        sigma_rel = sj.SIGMA0 * (2.0 ** (fl / s))
        lg_idx = jnp.clip(jnp.round(fl).astype(jnp.int32), 0, s + 2)
        dxs, dys = jax.lax.optimization_barrier(
            jax.vmap(sj._gradients)(jnp.stack(gaussians[o])))
        hist = sj._orientation_hist(dxs, dys, lg_idx, fy, fx, sigma_rel)
        angles, aok = jax.lax.optimization_barrier(sj._hist_peaks(hist))
        desc = sj._descriptors(dxs, dys, lg_idx, fy, fx, sigma_rel, angles[:, 0])
        out.append(dict(dogs=dog_stack, gauss=jnp.stack(gaussians[o]),
                        cand=cand, ref=ref, pts=(fl, fy, fx, resp, valid),
                        sigma_rel=sigma_rel, lg_idx=lg_idx, hist=hist,
                        angles=angles, aok=aok, desc=desc))
    return out


@functools.lru_cache(maxsize=None)
def _jax_stages():
    return jax.tree.map(np.asarray, jax.jit(_stages_fn)(jnp.asarray(_pair()[0])))


# --- the host backend -----------------------------------------------------------


@pytest.mark.parametrize("shape, uint8", [((H, W), False), ((H, W), True),
                                          ((768, 1024), False)])
def test_opencv_backend_equals_jax(shape, uint8):
    """SIFT(backend="opencv") against the JAX package's: every array equal
    (cv2 on the same uint8 image; 768 x 1024 through the default resize to
    1024, which leaves it as it is; the small image with resize=None)."""
    img = image_pair(np.random.default_rng(1), *shape)[0]
    if uint8:
        img = (img * 255).astype(np.uint8)
    kw = dict(max_num_keypoints=512)
    if shape[0] < 768:
        kw["resize"] = None
    got = SIFT(device="cpu", **kw).extract(img)
    want = jpipeline.SIFT(**kw).extract(img)
    assert set(got) == set(want)
    assert got["valid"].sum() > 20
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def test_host_helpers_equal_jax():
    """filter_dog_point (duplicates and radius NMS), RootSIFT and the
    padding against the JAX package's on random detections."""
    rng = np.random.default_rng(2)
    pts = rng.integers(0, 40, (300, 2)).astype(np.float32) + 0.5
    scales = rng.random(300).astype(np.float32)
    angles = rng.choice([-1.0, 0.5, 1.0], 300).astype(np.float32)
    scores = rng.choice([0.1, 0.2, 0.3], 300).astype(np.float32)
    for r in (0, 2):
        np.testing.assert_array_equal(
            tsift.filter_dog_point(pts, scales, angles, (40, 40), r, scores),
            jsift.filter_dog_point(pts, scales, angles, (40, 40), r, scores))
    d = rng.random((50, 128)).astype(np.float32) * 100
    np.testing.assert_array_equal(tsift.sift_to_rootsift(d),
                                  jsift.sift_to_rootsift(d))
    pred = {"keypoints": pts[:7], "scales": scales[:7], "oris": angles[:7],
            "descriptors": d[:7], "keypoint_scores": scores[:7]}
    got, want = tsift.pad_features(pred, 16), jsift.pad_features(pred, 16)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_configs_and_backends():
    """SIFTConfig's fields and defaults are the JAX package's; the port's
    own DoG backend is "device", and "jax" raises naming it; a pycolmap
    backend raises ImportError (pycolmap is not installed)."""
    mine, theirs = configs.SIFTConfig(), jconfigs.SIFTConfig()
    assert set(mine.__dataclass_fields__) == set(theirs.__dataclass_fields__)
    for f in mine.__dataclass_fields__:
        assert getattr(mine, f) == getattr(theirs, f), f
    with pytest.raises(ValueError, match="'device'"):
        configs.SIFTConfig(backend="jax")
    with pytest.raises(ValueError, match="Unknown SIFT backend"):
        configs.SIFTConfig(backend="colmap")
    with pytest.raises(ImportError, match="'device'"):
        SIFT(backend="pycolmap", device="cpu").extract(_pair()[0])


# --- the DoG scale space, stage by stage -------------------------------------


def test_pyramid_equals_jax_to_the_bit():
    """Every Gaussian layer and DoG of every octave (6 at 96 x 128, the
    image doubled first) equal to the bit."""
    want = _jax_stages()
    gaussians, dogs, n = sd.build_pyramid(_t(_pair()[0]), CONF)
    assert n == len(want)
    for o in range(n):
        np.testing.assert_array_equal(torch.stack(gaussians[o]).numpy(),
                                      want[o]["gauss"], err_msg=f"octave {o}")
        np.testing.assert_array_equal(torch.stack(dogs[o]).numpy(),
                                      want[o]["dogs"], err_msg=f"octave {o}")


@pytest.mark.parametrize("shape", [(192, 256), (6, 9)])
def test_conv_blur_within_ulps_of_the_fma_blur(shape):
    """The blur's two forms on the same plane, at every sigma of an octave:
    the convolutions (a CUDA tensor's form, run here on the CPU) within
    5e-7 relative of XLA's fused tap chain (the CPU's form; measured at
    most 2e-7, an ulp or two), also on a plane smaller than the kernel's
    radius, where the padding reflects twice."""
    x = sd.upsample2(_t(_pair()[0]) * 255.0)[: shape[0], : shape[1]]
    for sigma in [np.sqrt(sd.SIGMA0 ** 2 - 1.0)] + sd.layer_sigmas(4)[1:]:
        k = sd.gaussian_kernel(sigma)
        np.testing.assert_allclose(sd._blur_conv(x, k).numpy(),
                                   sd._blur_fma(x, k).numpy(), rtol=5e-7,
                                   atol=1e-6, err_msg=f"sigma {sigma}")


def test_candidates_and_refinement_equal_jax():
    """On the JAX package's DoG stack of each octave: the candidates
    (layer, y, x, valid) equal, and the refinement (five Newton steps, the
    contrast and edge tests) equal to the bit: positions, responses and
    valid."""
    s = CONF.num_scales_per_octave
    thr = float(np.floor(0.5 * CONF.detection_threshold / s * 255.0))
    n_valid = 0
    for o, want in enumerate(_jax_stages()):
        n_cand = max(256, (4 * K) >> o)
        dogs = _t(want["dogs"])
        cand = sd.extrema_candidates(dogs, n_cand, thr)
        for g, w, name in zip(cand, want["cand"], ("li", "yi", "xi", "valid")):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{o} {name}")
        wl, wy, wx, wv = (_t(a) for a in want["cand"])
        ref = sd.refine(dogs, wl.long(), wy.long(), wx.long(), wv, CONF)
        for g, w, name in zip(ref, want["ref"], ("fl", "fy", "fx", "resp", "valid")):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{o} {name}")
        n_valid += int(want["ref"][4].sum())
    assert n_valid > 30


def _peak_margins(hist, ok_a, ok_b):
    """For each orientation slot kept by one side only: |peak / max - 0.8|
    on the port's histogram."""
    vals, _ = sd.stable_topk(torch.where(
        (hist > torch.roll(hist, 1, -1)) & (hist > torch.roll(hist, -1, -1)),
        hist, torch.full_like(hist, -np.inf)), sd.MAX_ORI)
    ratio = vals / hist.max(-1, keepdim=True).values
    return (ratio - sd.ORI_PEAK_RATIO).abs()[ok_a != ok_b]


def test_orientations_and_descriptors_match_jax():
    """On the JAX package's refined points of each octave: sigma_rel and
    the histograms within 1e-5 relative, the kept peaks equal but for
    near-ties of the 0.8 ratio (margin under 1e-5, printed), their angles
    within 1e-5 rad; the descriptors at the JAX package's first angle
    within 1e-3 of the 512-scaled values."""
    s = CONF.num_scales_per_octave
    for o, want in enumerate(_jax_stages()):
        fl, fy, fx, resp, valid = (_t(a) for a in want["pts"])
        sigma_rel = sd.SIGMA0 * torch.pow(2.0, fl / s)
        np.testing.assert_allclose(sigma_rel.numpy(), want["sigma_rel"],
                                   rtol=1e-6)
        lg_idx = torch.round(fl).long().clamp(0, s + 2)
        np.testing.assert_array_equal(lg_idx.numpy(), want["lg_idx"])
        dxs, dys = sd.gradients(_t(want["gauss"]))
        srel = _t(want["sigma_rel"])
        hist = sd.orientation_hist(dxs, dys, lg_idx, fy, fx, srel)
        scale = np.abs(want["hist"]).max(-1, keepdims=True) + 1e-30
        assert (np.abs(hist.numpy() - want["hist"]) / scale).max() <= 1e-5, o
        angles, aok = sd.hist_peaks(_t(want["hist"]))
        margins = _peak_margins(_t(want["hist"]), aok, _t(want["aok"]))
        print(f"octave {o}: {int(want['aok'].sum())} peaks, "
              f"{len(margins)} unshared, margins {margins.tolist()}")
        assert (margins < 1e-5).all()
        both = aok.numpy() & want["aok"]
        np.testing.assert_allclose(angles.numpy()[both], want["angles"][both],
                                   atol=1e-5, rtol=0)
        desc = sd.descriptors(dxs, dys, lg_idx, fy, fx, srel,
                              _t(want["angles"][:, 0]))
        np.testing.assert_allclose(desc.numpy(), want["desc"], atol=1e-3, rtol=0)


def test_extract_single_matches_jax():
    """The whole extraction against the JAX package's (its SIFTDevice's
    forward at B 1: extract_single, then RootSIFT): keypoints, scores and
    valid equal, scales and oris within 1e-5, the RootSIFT descriptors
    within 1e-5."""
    want = _jax_features()[0]
    got = sd.extract_single(_t(_pair()[0]), CONF)
    assert got["valid"].sum() > 30
    for k in ("keypoints", "keypoint_scores", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(getattr(want, k))[0],
                                      err_msg=k)
    for k in ("scales", "oris"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(getattr(want, k))[0],
                                   atol=1e-5, rtol=0, err_msg=k)
    v = got["valid"]
    desc = torch.where(v[:, None], sd.rootsift(got["descriptors"]), 0.0)
    np.testing.assert_allclose(desc.numpy(), np.asarray(want.descriptors)[0],
                               atol=1e-5, rtol=0)


def test_forward_gray_rgb_and_batch():
    """forward on (B, H, W, 1) equals extract_single per image (RootSIFT
    applied); RGB turns grey as the JAX package's product with the
    reference's weights does, to the bit; the wrapper needs CUDA unless
    asked for the CPU."""
    a, b = _pair()
    f = sd.forward(None, CONF, _t(np.stack([a, b]))[..., None])
    one = sd.extract_single(_t(b), CONF)
    np.testing.assert_array_equal(f.keypoints[1].numpy(), one["keypoints"].numpy())
    v = one["valid"]
    np.testing.assert_allclose(f.descriptors[1][v].numpy(),
                               sd.rootsift(one["descriptors"][v]).numpy())
    assert f.scales is not None and f.oris is not None
    rgb = np.stack([a, np.sqrt(a), a * a], -1)[None].astype(np.float32)
    want = jax.jit(lambda x: x @ jnp.asarray([0.299, 0.587, 0.114], x.dtype))(
        jnp.asarray(rgb))
    gray = sd.to_gray(_t(rgb))
    np.testing.assert_array_equal(gray.numpy(), np.asarray(want))
    g = sd.forward(None, CONF, _t(rgb))
    np.testing.assert_array_equal(
        g.keypoints.numpy(), sd.extract_single(gray[0], CONF)["keypoints"][None].numpy())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            SIFTDevice()


def test_device_backend_is_siftdevice():
    """SIFT(backend="device") is SIFTDevice's extraction: every array of
    its output equal to SIFTDevice's on the same image (grey and uint8
    RGB); SIFTDevice refuses a config that names another backend."""
    a = _pair()[0]
    rgb = (np.stack([a, np.sqrt(a), a * a], -1) * 255).astype(np.uint8)
    host = SIFT(backend="device", max_num_keypoints=K, device="cpu")
    dev = SIFTDevice(max_num_keypoints=K, device="cpu")
    for img in (a, rgb):
        got, want = host.extract(img, resize=None), dev.extract(img, resize=None)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="'device'"):
        SIFTDevice(configs.SIFTConfig(), device="cpu")


# --- images to matches ----------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_pipeline():
    """The JAX package's SIFTDevice and trained "sift" matcher, and its
    match_pair on _pair()."""
    ext = jpipeline.SIFTDevice(max_num_keypoints=K)
    m = jpipeline.LightGlue("sift", params=NPZ)
    return ext, m, jpipeline.match_pair(ext, m, *_pair(), resize=None)


def _jax_features():
    """The JAX package's SIFTDevice forward on each image of _pair() at B 1
    (compiled once, with match_pair's)."""
    ext = _jax_pipeline()[0]
    sizes = jnp.asarray([[W, H]], jnp.float32)
    return [ext._jit_forward(None, ext.conf, jnp.asarray(x)[None, ..., None],
                             sizes) for x in _pair()]


def _check_feats(got, want):
    for k in ("keypoints", "keypoint_scores", "valid", "image_size"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    for k in ("scales", "oris"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-5,
                                   rtol=0, err_msg=k)
    np.testing.assert_allclose(got["descriptors"], np.asarray(want["descriptors"]),
                               atol=1e-5, rtol=0)


def _check_matches(got, want):
    for k in ("matches0", "matches1"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(np.asarray(got["matching_scores0"]),
                               np.asarray(want["matching_scores0"]), atol=1e-3)


def test_match_pair_matches_jax():
    """match_pair(SIFTDevice, LightGlue("sift", trained npz)) against the
    JAX package's: features as above (RootSIFT descriptors within 1e-5),
    matches equal, matching scores within 1e-3, the same stop; the
    trained matcher finds matches."""
    _, _, (jf0, jf1, want) = _jax_pipeline()
    ext = SIFTDevice(max_num_keypoints=K, device="cpu")
    m = LightGlue("sift", params=NPZ, device="cpu")
    f0, f1, got = match_pair(ext, m, *_pair(), resize=None)
    _check_feats(f0, jf0)
    _check_feats(f1, jf1)
    _check_matches(got, want)
    assert got["stop"] == want["stop"]
    assert (got["matches0"] >= 0).sum() >= 10


def test_make_end_to_end_and_sequence():
    """make_end_to_end(sift_device.forward, "sift") at B 2 on the pairs
    (a, b) and (b, a), each against the JAX package's SIFTDevice and
    matcher on that pair (its forward and its matcher call, the two halves
    of its make_end_to_end): keypoints and valid equal, matches equal,
    scores within 1e-3. match_sequence(SIFTDevice, window 1) on [a, b, a]
    equals make_end_to_end on each pair: features and matches."""
    _, jm, _ = _jax_pipeline()
    a, b = _pair()
    sizes = np.array([[W, H]], np.float32)
    jfeats = _jax_features()

    def jax_pair(f0, f1):
        d = [{"keypoints": f.keypoints, "descriptors": f.descriptors,
              "valid": f.valid, "scales": f.scales, "oris": f.oris,
              "image_size": sizes} for f in (f0, f1)]
        return jm({"image0": d[0], "image1": d[1]})

    m = LightGlue("sift", params=NPZ, device="cpu")
    run = end_to_end.make_end_to_end(sd.forward, None, CONF, m.params, m.conf)
    im0 = _t(np.stack([a, b]))[..., None]
    im1 = _t(np.stack([b, a]))[..., None]
    size = _t(np.repeat(sizes, 2, 0))
    got = run(im0, im1, size, size)
    for i, (p, q) in enumerate(((0, 1), (1, 0))):
        want = jax_pair(jfeats[p], jfeats[q])
        for s, j in (("feats0", p), ("feats1", q)):
            for f in ("keypoints", "valid"):
                np.testing.assert_array_equal(
                    getattr(getattr(got, s), f)[i].numpy(),
                    np.asarray(getattr(jfeats[j], f))[0], err_msg=f)
        mine = {"matches0": got.matches.matches0[i].numpy(),
                "matches1": got.matches.matches1[i].numpy(),
                "matching_scores0": got.matches.matching_scores0[i].numpy()}
        _check_matches(mine, {k: np.asarray(want[k])[0] for k in
                              ("matches0", "matches1", "matching_scores0")})

    seq_ext = SIFTDevice(max_num_keypoints=K, device="cpu")
    feats, pairs = match_sequence(seq_ext, m, np.stack([a, b, a]), window=1)
    assert feats["scales"].shape == (3, K) and feats["oris"].shape == (3, K)
    for i in range(2):  # pair (i, i + 1): (a, b) then (b, a)
        for f in ("keypoints", "descriptors", "valid"):
            np.testing.assert_array_equal(feats[f][i],
                                          getattr(got.feats0, f)[i].numpy())
        np.testing.assert_array_equal(pairs["matches0"][i],
                                      got.matches.matches0[i].numpy())
        np.testing.assert_allclose(pairs["matching_scores0"][i],
                                   got.matches.matching_scores0[i].numpy(),
                                   atol=1e-6)
