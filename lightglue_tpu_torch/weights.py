"""Parameters from the JAX package's flat checkpoints, from reference
state dicts and from the released checkpoints (counterpart of
lightglue_tpu/weights.py).

A checkpoint is a flat ``"a/b/c" -> array`` dict, as
``lightglue_tpu.weights.flatten_tree`` writes it and the npz files hold.
Matcher: linear weights ``(in, out)``, transformer layers stacked on axis 0;
the port keeps that layout, so conversion is a key-for-key copy into float32
tensors with every key and shape checked against the configuration. The
reference's state dict (``transformers.{i}.self_attn.Wqkv.weight``, ...)
converts through ``from_state_dict``, which transposes and stacks it.
HardNet: kornia's ``features.{i}`` dicts through ``hardnet_from_state_dict``.
SuperPoint and ALIKED: conv weights are HWIO in the JAX package and OIHW in
the port and in the reference's state dicts (``conv1a.weight``,
``conv1a.bias``, ...), so they are transposed once here. ALIKED's batch
norms keep their four running tensors (scale, bias, mean, var), and its
aggregation weights ``(M, dim, dim)`` are the same in every layout.
DISK: the same HWIO -> OIHW transpose, and kornia's state dicts parsed as
the JAX package's ``convert_disk`` parses them. ``to_jax_params`` writes
any of these trees back in the JAX layout, ``save_params`` as its npz.

The released checkpoints (``REGISTRY``, the JAX package's twelve entries)
resolve through ``fetch``, as ``pretrained=True`` on every wrapper does:
a converted ``{name}.npz`` in the cache, else a ``{name}.pth`` there
(converted and cached as npz), else a download of the release URL. The
cache is the repository's ``weights/``, which the JAX package's ``fetch``
fills too; both write the JAX layout, so each reads what the other wrote.
Offline, ``WeightsUnavailableError`` names the path to drop the file at.
"""

from __future__ import annotations

import dataclasses
import shutil
import urllib.error
import urllib.request
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from . import nn
from .configs import (ALIKEDConfig, LightGlueConfig, SuperPointConfig,
                      lightglue_config)


def _tensor(a) -> torch.Tensor:
    """A float32 tensor of its own memory, C-contiguous (a transposed
    view's copy would keep its strides, and the kernels take only
    contiguous weights)."""
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def expected_shapes(conf: LightGlueConfig) -> Dict[str, tuple]:
    """Every parameter key of a matcher with ``conf``, with its shape."""
    d, L = conf.descriptor_dim, conf.n_layers
    lin = lambda key, i, o, *lead: {f"{key}/w": (*lead, i, o),
                                    f"{key}/b": (*lead, o)}
    ln = lambda key, n, *lead: {f"{key}/scale": (*lead, n),
                                f"{key}/bias": (*lead, n)}
    shapes = {}
    if conf.input_dim != d:
        shapes.update(lin("input_proj", conf.input_dim, d))
    shapes["posenc/Wr/w"] = (2 + 2 * int(conf.add_scale_ori), conf.head_dim // 2)
    for block, projs in (
        ("self_attn", (("Wqkv", d, 3 * d), ("out_proj", d, d))),
        ("cross_attn", (("to_qk", d, d), ("to_v", d, d), ("to_out", d, d))),
    ):
        pre = f"transformers/{block}"
        for name, i, o in projs:
            shapes.update(lin(f"{pre}/{name}", i, o, L))
        shapes.update(lin(f"{pre}/ffn/lin1", 2 * d, 2 * d, L))
        shapes.update(ln(f"{pre}/ffn/ln", 2 * d, L))
        shapes.update(lin(f"{pre}/ffn/lin2", 2 * d, d, L))
    shapes.update(lin("log_assignment/matchability", d, 1, L))
    shapes.update(lin("log_assignment/final_proj", d, d, L))
    shapes.update(lin("token_confidence/token", d, 1, L - 1))
    return shapes


def _check_keys(flat, want) -> None:
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise KeyError(f"checkpoint keys do not fit the config: missing "
                       f"{missing}, unexpected {extra}")


def from_jax_params(
    flat: Dict[str, np.ndarray], conf: Optional[LightGlueConfig] = None
) -> nn.Params:
    """The port's parameter tree from a flat JAX checkpoint. Raises on any
    missing or unexpected key and on any shape that does not fit ``conf``
    (default: the superpoint matcher at full width)."""
    conf = conf or LightGlueConfig()
    want = expected_shapes(conf)
    _check_keys(flat, want)
    tree: dict = {}
    for key, shape in want.items():
        arr = np.asarray(flat[key])
        if arr.shape != shape:
            raise ValueError(f"{key}: shape {arr.shape}, expected {shape}")
        node = tree
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = _tensor(arr)
    return tree


def load_params(path: str, conf: Optional[LightGlueConfig] = None) -> nn.Params:
    """Read a flat npz with numpy (float16 storage is upcast to float32)
    and convert it with ``from_jax_params``."""
    with np.load(path) as f:
        flat = {k: f[k] for k in f.files}
    return from_jax_params(flat, conf)


def flatten_params(tree: nn.Params, prefix: str = "") -> Dict[str, np.ndarray]:
    """Inverse of ``from_jax_params``: the flat ``"a/b/c"`` numpy dict (of a
    tree of tensors or arrays)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten_params(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu()
    return {prefix[:-1]: np.asarray(tree)}


def superpoint_shapes(conf: Optional[SuperPointConfig] = None) -> Dict[str, tuple]:
    """Every SuperPoint conv of ``conf``: name -> OIHW weight shape."""
    from .models.superpoint import layer_shapes

    return {n: (o, i, k, k)
            for n, (i, o, k) in layer_shapes(conf or SuperPointConfig()).items()}


def _superpoint_tree(get_w, get_b, conf) -> nn.Params:
    """Every conv from ``get_w(name)`` (OIHW) and ``get_b(name)``, shapes
    checked against ``conf``."""
    shapes = superpoint_shapes(conf)
    tree = {}
    for name, shape in shapes.items():
        w, b = np.asarray(get_w(name)), np.asarray(get_b(name))
        if w.shape != shape or b.shape != shape[:1]:
            raise ValueError(f"{name}: weight {w.shape} and bias {b.shape}, "
                             f"expected {shape} and {shape[:1]}")
        tree[name] = {"w": _tensor(w),
                      "b": _tensor(b)}
    return tree


def superpoint_from_jax_params(
    flat: Dict[str, np.ndarray], conf: Optional[SuperPointConfig] = None
) -> nn.Params:
    """The port's SuperPoint parameters from the JAX package's flat dict
    (``conv1a/w`` HWIO, ``conv1a/b``, ...). Raises on any missing or
    unexpected key and on any shape that does not fit ``conf``."""
    names = superpoint_shapes(conf)
    _check_keys(flat, [f"{n}/{k}" for n in names for k in ("w", "b")])
    return _superpoint_tree(
        lambda n: np.transpose(np.asarray(flat[f"{n}/w"]), (3, 2, 0, 1)),
        lambda n: flat[f"{n}/b"], conf)


def superpoint_from_state_dict(
    sd: Dict[str, np.ndarray], conf: Optional[SuperPointConfig] = None
) -> nn.Params:
    """The port's SuperPoint parameters from a reference state dict
    (``conv1a.weight`` OIHW, ``conv1a.bias``, ...; superpoint.py:121-145),
    every key and shape checked."""
    names = superpoint_shapes(conf)
    sd = {k: np.asarray(v) for k, v in sd.items()}
    _check_keys(sd, [f"{n}.{k}" for n in names for k in ("weight", "bias")])
    return _superpoint_tree(lambda n: sd[f"{n}.weight"],
                            lambda n: sd[f"{n}.bias"], conf)


def superpoint_to_state_dict(params: nn.Params) -> Dict[str, np.ndarray]:
    """Inverse of ``superpoint_from_state_dict``."""
    out = {}
    for name, p in params.items():
        out[f"{name}.weight"] = p["w"].detach().cpu().numpy()
        out[f"{name}.bias"] = p["b"].detach().cpu().numpy()
    return out


def aliked_entries(conf: Optional[ALIKEDConfig] = None):
    """Every ALIKED parameter of ``conf`` as (tree path, reference
    state-dict key, shape in the port; conv weights OIHW), in the layout of
    the JAX package's ``convert_aliked`` (weights.py:184-234)."""
    from .models.aliked import CFGS

    c1, c2, c3, c4, dim, k, m = CFGS[(conf or ALIKEDConfig()).model_name]
    out = []

    def conv(path, key, cin, cout, ks, bias=False):
        out.append((path + ("w",), f"{key}.weight", (cout, cin, ks, ks)))
        if bias:
            out.append((path + ("b",), f"{key}.bias", (cout,)))

    def bn(path, key, ch):
        for leaf, name in (("scale", "weight"), ("bias", "bias"),
                           ("mean", "running_mean"), ("var", "running_var")):
            out.append((path + (leaf,), f"{key}.{name}", (ch,)))

    conv(("block1", "conv1"), "block1.conv1", 3, c1, 3)
    bn(("block1", "bn1"), "block1.bn1", c1)
    conv(("block1", "conv2"), "block1.conv2", c1, c1, 3)
    bn(("block1", "bn2"), "block1.bn2", c1)
    for i, (cin, cout) in ((2, (c1, c2)), (3, (c2, c3)), (4, (c3, c4))):
        blk = f"block{i}"
        for j, ci in ((1, cin), (2, cout)):
            path, key = (blk, f"conv{j}"), f"{blk}.conv{j}"
            if i == 2:
                conv(path, key, ci, cout, 3)
            else:  # deformable: offsets for the 9 taps, then the taps' conv
                conv(path + ("offset_conv",), f"{key}.offset_conv", ci, 18, 3,
                     bias=True)
                conv(path + ("regular_conv",), f"{key}.regular_conv", ci,
                     cout, 3)
            bn((blk, f"bn{j}"), f"{blk}.bn{j}", cout)
        conv((blk, "downsample"), f"{blk}.downsample", cin, cout, 1, bias=True)
    for i, ch in enumerate((c1, c2, c3, dim), 1):
        conv((f"conv{i}",), f"conv{i}", ch, dim // 4, 1)
    for name, cin, cout, ks in (("0", dim, 8, 1), ("2", 8, 4, 3),
                                ("4", 4, 4, 3), ("6", 4, 1, 3)):
        conv(("score_head", name), f"score_head.{name}", cin, cout, ks)
    conv(("desc_head", "offset_conv1"), "desc_head.offset_conv.0", dim, 2 * m,
         k, bias=True)
    conv(("desc_head", "offset_conv2"), "desc_head.offset_conv.2", 2 * m,
         2 * m, 1, bias=True)
    conv(("desc_head", "sf_conv"), "desc_head.sf_conv", dim, dim, 1)
    out.append((("desc_head", "agg_weights"), "desc_head.agg_weights",
                (m, dim, dim)))
    return out


def _aliked_tree(get, conf) -> nn.Params:
    tree: dict = {}
    for path, key, shape in aliked_entries(conf):
        arr = np.asarray(get(path, key, len(shape)))
        if arr.shape != shape:
            raise ValueError(f"{key}: shape {arr.shape}, expected {shape}")
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = _tensor(arr)
    return tree


def aliked_from_jax_params(
    flat: Dict[str, np.ndarray], conf: Optional[ALIKEDConfig] = None
) -> nn.Params:
    """The port's ALIKED parameters from the JAX package's flat dict
    (``block1/conv1/w`` HWIO, ``block1/bn1/scale``, ...). Raises on any
    missing or unexpected key and on any shape that does not fit ``conf``
    (default: aliked-n16)."""
    _check_keys(flat, ["/".join(p) for p, _, _ in aliked_entries(conf)])

    def get(path, _, ndim):
        arr = np.asarray(flat["/".join(path)])  # conv weights HWIO -> OIHW
        return arr.transpose(3, 2, 0, 1) if ndim == 4 == arr.ndim else arr

    return _aliked_tree(get, conf)


def aliked_from_state_dict(
    sd: Dict[str, np.ndarray], conf: Optional[ALIKEDConfig] = None
) -> nn.Params:
    """The port's ALIKED parameters from a reference state dict
    (lightglue/aliked.py:637-695), every key and shape checked."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    _check_keys(sd, [key for _, key, _ in aliked_entries(conf)])
    return _aliked_tree(lambda _, key, __: sd[key], conf)


def aliked_to_state_dict(
    params: nn.Params, conf: Optional[ALIKEDConfig] = None
) -> Dict[str, np.ndarray]:
    """Inverse of ``aliked_from_state_dict``."""
    out = {}
    for path, key, _ in aliked_entries(conf):
        node = params
        for part in path:
            node = node[part]
        out[key] = node.detach().cpu().numpy()
    return out


def disk_from_jax_params(flat, conf=None) -> nn.Params:
    """The port's DISK parameters from the JAX package's flat dict
    (``down/1/conv/w`` HWIO, ``down/1/conv/b``, ``down/1/gate/alpha``, ...)
    or its nested tree. Raises on any missing or unexpected key and on any
    shape that does not fit ``conf`` (default: desc_dim 128); the first
    block is gated where the checkpoint gates it."""
    from .configs import DISKConfig
    from .models.disk import KERNEL, block_channels

    if any(isinstance(v, dict) for v in flat.values()):  # the nested tree
        flat = flatten_params(flat)
    flat = {k: np.asarray(v) for k, v in flat.items()}
    want, tree = [], {"down": {}, "up": {}}
    for path, i, cin, cout, gated in block_channels(conf or DISKConfig()):
        pre = f"{path}/{i}"
        gated = gated or f"{pre}/gate/alpha" in flat
        entries = [(("conv", "w"), (KERNEL, KERNEL, cin, cout)),
                   (("conv", "b"), (cout,))]
        if gated:
            entries.append((("gate", "alpha"), (cin,)))
        node = tree[path].setdefault(str(i), {})
        for leaf, shape in entries:
            key = "/".join((pre,) + leaf)
            want.append(key)
            arr = flat.get(key)
            if arr is not None and arr.shape != shape:
                raise ValueError(f"{key}: shape {arr.shape}, expected {shape}")
            if arr is not None:
                if len(shape) == 4:  # HWIO -> OIHW
                    arr = arr.transpose(3, 2, 0, 1)
                node.setdefault(leaf[0], {})[leaf[1]] = _tensor(arr)
    _check_keys(flat, want)
    return tree


def disk_from_state_dict(sd: Dict[str, np.ndarray], conf=None) -> nn.Params:
    """The port's DISK parameters from a kornia DISK state dict
    (``unet.path_down.{i}`` / ``unet.path_up.{i}``), parsed as the JAX
    package's ``convert_disk`` parses it (lightglue_tpu/weights.py:
    308-390): within each block prefix the conv is the one 4-d
    ``.weight`` and the PReLU gate the one 1-d tensor whose size is the
    conv's input channels, whatever the Sequential indices. It checks the
    channel plan (down [16, 32, 64, 64, 64], up [64, 64, 64, desc_dim + 1]
    over the skip concatenation), refuses an ambiguous gate and any tensor
    left over."""
    from .configs import DISKConfig
    from .models.disk import block_channels

    sd = {k: np.asarray(v) for k, v in sd.items()}
    consumed = set()
    tree = {"down": {}, "up": {}}
    for path, i, cin, cout, _ in block_channels(conf or DISKConfig()):
        prefix = f"unet.path_{path}.{i}."
        conv_keys = sorted(k for k in sd if k.startswith(prefix)
                           and k.endswith(".weight") and sd[k].ndim == 4)
        if len(conv_keys) != 1:
            raise ValueError(f"{prefix}: expected exactly 1 conv weight, got "
                             f"{conv_keys}")
        ck = conv_keys[0][: -len(".weight")]
        w = sd[ck + ".weight"]  # OIHW
        if (w.shape[1], w.shape[0]) != (cin, cout):
            raise ValueError(f"{ck}: conv (in,out)=({w.shape[1]},{w.shape[0]}) "
                             f"!= expected ({cin},{cout})")
        conv = {"w": _tensor(w)}
        consumed.add(ck + ".weight")
        if ck + ".bias" in sd:
            conv["b"] = _tensor(sd[ck + ".bias"])
            consumed.add(ck + ".bias")
        p = {"conv": conv}
        gate_keys = sorted(k for k in sd if k.startswith(prefix)
                           and sd[k].ndim == 1 and sd[k].shape[0] == w.shape[1]
                           and k not in consumed)
        if gate_keys:
            if len(gate_keys) > 1:
                raise ValueError(f"{prefix}: ambiguous 1-d tensors {gate_keys}"
                                 " — cannot identify the PReLU gate")
            p["gate"] = {"alpha": _tensor(sd[gate_keys[0]])}
            consumed.add(gate_keys[0])
        tree[path][str(i)] = p
    leftover = [k for k in sd if k not in consumed
                and not k.endswith("num_batches_tracked")]
    if leftover:
        raise ValueError(f"unconsumed DISK tensors: {leftover[:8]}")
    return tree


def disk_to_state_dict(params: nn.Params) -> Dict[str, np.ndarray]:
    """Inverse of ``disk_from_state_dict``, in kornia's layout: a gated
    block's PReLU at ``conv.0``, its conv at ``conv.2`` (the instance norm,
    ``conv.1``, holds nothing); an ungated block's conv at ``conv.0``."""
    out = {}
    for path in ("down", "up"):
        for i, p in params[path].items():
            pre = f"unet.path_{path}.{i}.conv."
            if "gate" in p:
                out[pre + "0.weight"] = p["gate"]["alpha"].detach().cpu().numpy()
            conv = pre + ("2" if "gate" in p else "0")
            out[conv + ".weight"] = p["conv"]["w"].detach().cpu().numpy()
            if "b" in p["conv"]:
                out[conv + ".bias"] = p["conv"]["b"].detach().cpu().numpy()
    return out


# --- the matcher's reference state dict (lightglue_tpu/weights.py:74-130) ----

# the reference's module names under a tree path, and its parameter names
_REF_MODULES = {"lin1": "0", "ln": "1", "lin2": "3", "token": "token.0"}
_REF_LEAVES = {"w": "weight", "b": "bias", "scale": "weight", "bias": "bias"}
# the per-layer module lists: their tree paths stack the layers on axis 0
_LAYERED = ("transformers", "log_assignment", "token_confidence")


def _ref_key(key: str, layer: Optional[int]) -> str:
    """The reference's state-dict key of tree key ``key`` (at ``layer``)."""
    top, *mid, leaf = key.split("/")
    parts = [top] + ([str(layer)] if top in _LAYERED else [])
    parts += [_REF_MODULES.get(m, m) for m in mid] + [_REF_LEAVES[leaf]]
    return ".".join(parts)


def upgrade_legacy_keys(sd: Dict[str, np.ndarray],
                        n_layers: int) -> Dict[str, np.ndarray]:
    """Old checkpoints name the blocks ``self_attn.{i}`` / ``cross_attn.{i}``
    (reference migration, lightglue.py:427-434): renamed to
    ``transformers.{i}.self_attn`` / ``.cross_attn``, as the JAX package's
    ``upgrade_legacy_keys`` does."""
    out = dict(sd)
    for i in range(n_layers):
        for old, new in ((f"self_attn.{i}", f"transformers.{i}.self_attn"),
                         (f"cross_attn.{i}", f"transformers.{i}.cross_attn")):
            out = {k.replace(old, new): v for k, v in out.items()}
    return out


def from_state_dict(sd: Dict[str, np.ndarray],
                    conf: Optional[LightGlueConfig] = None) -> nn.Params:
    """The port's matcher tree from a reference LightGlue state dict
    (``transformers.{i}.self_attn.Wqkv.weight``, ...; legacy names
    upgraded first): linear weights transposed to (in, out), each module
    list stacked on a leading layer axis, as the JAX package's
    ``convert_lightglue`` builds it. The ``confidence_thresholds`` buffer
    is ignored (as ``convert_lightglue`` ignores it: the thresholds are
    computed from ``conf``). Every key of ``conf``'s matcher is required,
    every shape checked, and any other key refused: ``input_proj`` exists
    only where input_dim != descriptor_dim (not in the superpoint preset)."""
    conf = conf or LightGlueConfig()
    sd = upgrade_legacy_keys({k: v for k, v in sd.items()
                              if k != "confidence_thresholds"}, conf.n_layers)
    flat, used = {}, set()
    for key, shape in expected_shapes(conf).items():
        layered = key.split("/")[0] in _LAYERED
        arrs = []
        for i in range(shape[0]) if layered else [None]:
            ref = _ref_key(key, i)
            if ref not in sd:
                raise KeyError(f"state dict lacks {ref} (for {key})")
            a = _numpy(sd[ref])
            arrs.append(a.T if key.endswith("/w") else a)
            used.add(ref)
        flat[key] = np.stack(arrs) if layered else arrs[0]
    extra = sorted(set(sd) - used)
    if extra:
        raise KeyError(f"unexpected state-dict keys: {extra[:8]}")
    return from_jax_params(flat, conf)


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x)


def to_state_dict(params: nn.Params,
                  conf: Optional[LightGlueConfig] = None) -> Dict[str, np.ndarray]:
    """Inverse of ``from_state_dict``: the reference's keys and layouts
    (without ``confidence_thresholds``)."""
    conf = conf or LightGlueConfig()
    flat = flatten_params(params)
    out = {}
    for key in expected_shapes(conf):
        layered = key.split("/")[0] in _LAYERED
        for i, a in enumerate(flat[key]) if layered else [(None, flat[key])]:
            out[_ref_key(key, i)] = np.ascontiguousarray(
                a.T if key.endswith("/w") else a)
    return out


# --- HardNet (lightglue_tpu/weights.py:237-305) -------------------------------

_BN_LEAVES = (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
              ("var", "running_var"))


def _hardnet_tree(get_w, get_bn) -> nn.Params:
    """Every conv from ``get_w(n)`` (OIHW) and batch norm from
    ``get_bn(n)`` (dict of the four leaves), shapes checked."""
    from .models.hardnet import LAYERS

    tree = {}
    for n, (ci, co, ks, *_) in enumerate(LAYERS):
        w = np.asarray(get_w(n))
        if w.shape != (co, ci, ks, ks):
            raise ValueError(f"conv{n}: weight {w.shape}, expected "
                             f"{(co, ci, ks, ks)}")
        bn = {k: np.asarray(v) for k, v in get_bn(n).items()}
        if any(a.shape != (co,) for a in bn.values()):
            raise ValueError(f"bn{n}: shapes {[a.shape for a in bn.values()]}, "
                             f"expected ({co},)")
        tree[f"conv{n}"] = {"w": _tensor(w)}
        tree[f"bn{n}"] = {k: _tensor(a) for k, a in bn.items()}
    return tree


def hardnet_from_jax_params(flat, conf=None) -> nn.Params:
    """The port's HardNet parameters from the JAX package's flat dict
    (``conv0/w`` HWIO, ``bn0/scale``, ...) or its nested tree; ``conf`` is
    unused. Raises on any missing or unexpected key and on any shape that
    does not fit the architecture."""
    if any(isinstance(v, dict) for v in flat.values()):  # the nested tree
        flat = flatten_params(flat)
    flat = {k: np.asarray(v) for k, v in flat.items()}
    _check_keys(flat, [f"conv{n}/w" for n in range(7)]
                + [f"bn{n}/{leaf}" for n in range(7) for leaf, _ in _BN_LEAVES])
    return _hardnet_tree(
        lambda n: flat[f"conv{n}/w"].transpose(3, 2, 0, 1),
        lambda n: {leaf: flat[f"bn{n}/{leaf}"] for leaf, _ in _BN_LEAVES})


def hardnet_from_state_dict(sd: Dict[str, np.ndarray], conf=None) -> nn.Params:
    """The port's HardNet parameters from a kornia HardNet state dict
    (``features.{i}.*``, reference dog_hardnet.py:13), parsed as the JAX
    package's ``convert_hardnet``: the convs (a 4-d ``.weight``) and batch
    norms (a ``.running_mean``) are found from the keys, not from fixed
    Sequential indices; a batch norm without affine parameters (kornia's)
    takes scale 1 and bias 0; ``conf`` is unused. The checks of
    ``convert_hardnet``'s strict mode always run: exactly 7 convs and 7
    batch norms, each after its conv, every shape as the architecture's,
    and no tensor left over but ``num_batches_tracked``."""
    sd = {k: _numpy(v) for k, v in sd.items()}
    idxs = sorted({int(k.split(".")[1]) for k in sd if k.startswith("features.")})
    convs = [i for i in idxs if f"features.{i}.weight" in sd
             and sd[f"features.{i}.weight"].ndim == 4]
    bns = [i for i in idxs if f"features.{i}.running_mean" in sd]
    if len(convs) != 7 or len(bns) != 7:
        raise ValueError(f"HardNet layout mismatch: found {len(convs)} convs / "
                         f"{len(bns)} BNs at features.{convs}/{bns}, expected 7+7")
    if any(bi <= ci for ci, bi in zip(convs, bns)):
        raise ValueError(f"a batch norm precedes its conv: {convs} / {bns}")
    consumed = set()

    def bn(n):
        pre = f"features.{bns[n]}."
        dim = sd[pre + "running_mean"].shape[0]
        out = {"scale": sd.get(pre + "weight", np.ones(dim, np.float32)),
               "bias": sd.get(pre + "bias", np.zeros(dim, np.float32)),
               "mean": sd[pre + "running_mean"], "var": sd[pre + "running_var"]}
        consumed.update(pre + name for _, name in _BN_LEAVES if pre + name in sd)
        return out

    def conv(n):
        consumed.add(f"features.{convs[n]}.weight")
        return sd[f"features.{convs[n]}.weight"]

    tree = _hardnet_tree(conv, bn)
    leftover = [k for k in sd if k not in consumed
                and not k.endswith("num_batches_tracked")]
    if leftover:
        raise ValueError(f"unconsumed HardNet tensors: {leftover[:8]}")
    return tree


def hardnet_to_state_dict(params: nn.Params) -> Dict[str, np.ndarray]:
    """Inverse of ``hardnet_from_state_dict``, in kornia's layout: conv n at
    ``features.{3n}`` and its batch norm at ``features.{3n + 1}`` (the
    Dropout before the last conv shifts it to 19 and 20); a batch norm's
    scale and bias only where they are not 1 and 0 (kornia's have none)."""
    out = {}
    for n in range(7):
        ci = 3 * n + (1 if n == 6 else 0)
        out[f"features.{ci}.weight"] = _numpy(params[f"conv{n}"]["w"])
        bn = {k: _numpy(v) for k, v in params[f"bn{n}"].items()}
        affine = not ((bn["scale"] == 1).all() and (bn["bias"] == 0).all())
        for leaf, name in _BN_LEAVES:
            if affine or leaf in ("mean", "var"):
                out[f"features.{ci + 1}.{name}"] = bn[leaf]
    return out


# --- writing the JAX layout (lightglue_tpu/weights.py:148-169) ----------------


def to_jax_params(tree: nn.Params) -> Dict[str, np.ndarray]:
    """The flat ``"a/b/c"`` numpy dict of the JAX package's layout, as its
    ``flatten_tree`` writes its converters' trees: the inverse of
    ``from_jax_params`` (the matcher), ``superpoint_``, ``aliked_``,
    ``disk_`` and ``hardnet_from_jax_params``. The port's tree paths are
    the JAX package's, and its layouts differ only in the conv weights, 4-d
    leaves OIHW here and HWIO there; no other leaf of these models is 4-d
    (the matcher's stacked linears are 3-d), so that transpose is the whole
    inverse."""
    return {k: np.ascontiguousarray(v.transpose(2, 3, 1, 0) if v.ndim == 4 else v)
            for k, v in flatten_params(tree).items()}


def save_params(path, flat: Dict[str, np.ndarray]) -> None:
    """Write a flat dict (``to_jax_params``) as the npz that both packages'
    ``load_params`` and ``fetch`` read."""
    np.savez(path, **flat)


# --- the released checkpoints (lightglue_tpu/weights.py:393-566) ----------------
#
# The reference's versioned-URL weight loading (lightglue.py:348-349,
# 415-434 for the matcher; superpoint.py:144-145; aliked.py:620, 692-695;
# DISK's and HardNet's weights are kornia's in the reference, disk.py:26 /
# dog_hardnet.py:13, and the URLs below are the upstream checkpoints those
# kornia models load), with the JAX package's names, URLs and unwrap keys.

_LIGHTGLUE_VERSION = "v0.1_arxiv"  # reference lightglue.py:348
_LIGHTGLUE_URL = "https://github.com/cvg/LightGlue/releases/download/{}/{}.pth"


class WeightsUnavailableError(RuntimeError):
    """A released checkpoint is neither cached nor downloadable."""


@dataclasses.dataclass(frozen=True)
class WeightSpec:
    """One released checkpoint: where it lives and how to convert it."""

    url: str
    converter: str  # a key of _CONVERTERS
    # keys to try unwrapping a nested torch checkpoint with (the first one
    # present wins); () = the file is the state dict
    unwrap: tuple = ()
    # the matcher checkpoints' feature preset (the LightGlueConfig whose
    # layers the converter stacks)
    features: Optional[str] = None


REGISTRY: Dict[str, WeightSpec] = {
    # matcher checkpoints (reference lightglue.py:351-374 presets)
    **{
        f"{feats}_lightglue": WeightSpec(
            url=_LIGHTGLUE_URL.format(_LIGHTGLUE_VERSION, f"{feats}_lightglue"),
            converter="lightglue",
            features=feats,
        )
        for feats in ("superpoint", "disk", "aliked", "sift", "doghardnet")
    },
    # extractor checkpoints
    "superpoint_v1": WeightSpec(
        # reference superpoint.py:144
        url=("https://github.com/cvg/LightGlue/releases/download/"
             "v0.1_arxiv/superpoint_v1.pth"),
        converter="superpoint",
    ),
    **{
        name: WeightSpec(
            # reference aliked.py:620
            url=f"https://github.com/Shiaoming/ALIKED/raw/main/models/{name}.pth",
            converter="aliked",
        )
        for name in ("aliked-t16", "aliked-n16", "aliked-n16rot", "aliked-n32")
    },
    "disk_depth": WeightSpec(
        # the upstream cvg/DISK checkpoint kornia's DISK.from_pretrained
        # ("depth") loads (reference disk.py:26)
        url="https://github.com/cvg/DISK/raw/master/depth-save.pth",
        converter="disk",
        unwrap=("extractor", "state_dict", "model"),
    ),
    "hardnet_liberty_aug": WeightSpec(
        # the upstream HardNet checkpoint kornia's HardNet.from_pretrained
        # loads (reference dog_hardnet.py:13)
        url=("https://github.com/DagnyT/hardnet/raw/master/pretrained/"
             "train_liberty_with_aug/checkpoint_liberty_with_aug.pth"),
        converter="hardnet",
        unwrap=("state_dict",),
    ),
}

# converter -> (reference state dict -> tree, the JAX package's flat dict
# -> tree), each called with the entry's configuration (``_entry_conf``)
_CONVERTERS = {
    "lightglue": (from_state_dict, from_jax_params),
    "superpoint": (superpoint_from_state_dict, superpoint_from_jax_params),
    "aliked": (aliked_from_state_dict, aliked_from_jax_params),
    "disk": (disk_from_state_dict, disk_from_jax_params),
    "hardnet": (hardnet_from_state_dict, hardnet_from_jax_params),
}


def _entry_conf(name: str):
    """The configuration a registry entry converts under: the matcher's
    feature preset, ALIKED's model (the four differ in width), else the
    model's default (None)."""
    spec = REGISTRY[name]
    if spec.converter == "lightglue":
        return lightglue_config(spec.features)
    if spec.converter == "aliked":
        return ALIKEDConfig(model_name=name)
    return None


def default_cache_dir() -> Path:
    """The repository's ``weights/``, the JAX package's cache too
    (lightglue_tpu/weights.py:479; the reference's local fallback looks
    there, lightglue.py:422-425)."""
    return Path(__file__).resolve().parent.parent / "weights"


def _unwrap_state_dict(obj, unwrap: tuple) -> Dict[str, np.ndarray]:
    """Peel a checkpoint's wrapper dicts (the first of ``unwrap`` present),
    a pickled module and DataParallel's ``module.`` prefixes down to
    ``{key: ndarray}``."""
    for key in unwrap:
        if isinstance(obj, dict) and key in obj:
            obj = obj[key]
            break
    if hasattr(obj, "state_dict"):  # a whole pickled module
        obj = obj.state_dict()
    if not (isinstance(obj, dict) and obj
            and all(hasattr(v, "shape") for v in obj.values())):
        raise WeightsUnavailableError(
            "checkpoint structure not understood: "
            f"{list(obj)[:6] if isinstance(obj, dict) else type(obj)}")
    return {k.removeprefix("module."): _numpy(v) for k, v in obj.items()}


def fetch(name: str, cache_dir=None, retries: int = 2) -> nn.Params:
    """The port's parameter tree (float32, on the CPU) of a released
    checkpoint, resolved as the JAX package's ``fetch`` resolves it: the
    converted ``{cache}/{name}.npz`` (the JAX layout, whichever package
    wrote it), else the torch ``{cache}/{name}.pth`` (converted, and cached
    as that npz), else a download of the registry URL into that ``.pth``.
    ``cache_dir`` defaults to ``default_cache_dir()``. Offline the download
    raises ``WeightsUnavailableError``, naming where to put the file."""
    if name not in REGISTRY:
        raise KeyError(f"unknown weights {name!r}; known: {sorted(REGISTRY)}")
    spec = REGISTRY[name]
    from_sd, from_flat = _CONVERTERS[spec.converter]
    conf = _entry_conf(name)
    cache = Path(cache_dir) if cache_dir is not None else default_cache_dir()
    cache.mkdir(parents=True, exist_ok=True)
    npz = cache / f"{name}.npz"
    if npz.exists():
        with np.load(npz) as f:
            return from_flat({k: f[k] for k in f.files}, conf)
    pth = cache / f"{name}.pth"
    if not pth.exists():
        _download(spec.url, pth, retries=retries)
    # a release file is a pickled training checkpoint, as the JAX package
    # loads it (lightglue_tpu/weights.py:536)
    obj = torch.load(str(pth), map_location="cpu", weights_only=False)
    params = from_sd(_unwrap_state_dict(obj, spec.unwrap), conf)
    save_params(npz, to_jax_params(params))
    return params


def _download(url: str, dest: Path, retries: int = 2, timeout: float = 30.0):
    """``url`` into ``dest`` through ``dest.part``, renamed once whole; a
    failed try removes the part file."""
    tmp = dest.with_suffix(dest.suffix + ".part")
    last = None
    for _ in range(max(1, retries)):
        try:
            with urllib.request.urlopen(url, timeout=timeout) as r, \
                    open(tmp, "wb") as f:
                shutil.copyfileobj(r, f, 1 << 20)
            tmp.rename(dest)
            return
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            last = e
            tmp.unlink(missing_ok=True)
    raise WeightsUnavailableError(
        f"could not download {url}: {last!r}. If this environment is "
        f"offline, place the file manually at {dest} and re-run.")
