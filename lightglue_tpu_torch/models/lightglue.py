"""LightGlue matcher in PyTorch (counterpart of
lightglue_tpu/models/lightglue.py:91-615, 662-677).

Same parameter tree and the same masked static-shape semantics as the JAX
package: variable keypoint counts are validity masks, and width pruning is a
per-image mask update. The layer loop is a Python loop; the adaptive path
reads its stop flag on the host once per layer.

At the default configuration each SelfBlock is one op, kernel B5
(ops/flash_self.py, N <= 2048), and each CrossBlock one op, kernel B6
(ops/flash_cross_block.py, max(M, N) <= 1024, head_dim 64). Otherwise the
blocks are composed from the attention, cross-attention and FFN kernels
(ops/flash.py, ops/flash_cross.py, ops/ffn.py), with plain ``x @ w``
projections around them; at head_dim 128 the cross attention is B1'
(ops/flash.py::flash_cross_pair, always exact, as the JAX matcher calls
it). The assignment head is kernel ops/assignment_fused.py.
``conf.flash=False`` and ``conf.fused_ffn=False`` switch to the composed ops
of ops/attention.py and ops/assignment.py, as in the JAX package. The
dispatch follows the JAX package's order of tests (lightglue.py:235-341).

``conf.mp`` casts the descriptors to bf16 after they are read
(lightglue.py:419-421): the transformer then runs the bf16 forms of those
kernels (bf16 activations and weights, fp32 sums, rounded where the TPU
kernels round), the token confidence takes its linear in bf16 and its
sigmoid in fp32, and the assignment head (B2) casts back to fp32, as the
JAX matcher does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from .. import nn
from ..configs import LightGlueConfig
from ..ops import assignment as asg
from ..ops import assignment_fused as fasg_ops
from ..ops import attention as attn_ops
from ..ops import block_tc
from ..ops import ffn as ffn_ops
from ..ops import flash as flash_ops
from ..ops import flash_cross as flash_cross_ops
from ..ops import flash_cross_block as flash_cross_block_ops
from ..ops import flash_self as flash_self_ops
from ..ops import rotary
from ..ops.keypoints import normalize_keypoints

# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _ffn_init(dim: int, g: torch.Generator) -> nn.Params:
    """2d -> 2d -> LN -> GELU -> d (reference: lightglue.py:152-157)."""
    return {
        "lin1": nn.linear_init(2 * dim, 2 * dim, g),
        "ln": nn.layer_norm_init(2 * dim),
        "lin2": nn.linear_init(2 * dim, dim, g),
    }


def init_params(conf: LightGlueConfig, generator: torch.Generator) -> nn.Params:
    """Random parameters in the JAX package's tree layout (lightglue.py:
    388-413 of the reference), drawn from ``generator`` on the CPU."""
    g = generator
    d = conf.descriptor_dim
    params = {}
    if conf.input_dim != d:
        params["input_proj"] = nn.linear_init(conf.input_dim, d, g)
    m_dim = 2 + 2 * int(conf.add_scale_ori)
    params["posenc"] = rotary.fourier_posenc_init(m_dim, conf.head_dim, g)
    params["transformers"] = nn.stack_params([
        {
            "self_attn": {
                "Wqkv": nn.linear_init(d, 3 * d, g),
                "out_proj": nn.linear_init(d, d, g),
                "ffn": _ffn_init(d, g),
            },
            "cross_attn": {
                "to_qk": nn.linear_init(d, d, g),
                "to_v": nn.linear_init(d, d, g),
                "to_out": nn.linear_init(d, d, g),
                "ffn": _ffn_init(d, g),
            },
        }
        for _ in range(conf.n_layers)
    ])
    params["log_assignment"] = nn.stack_params(
        [asg.match_assignment_init(d, g) for _ in range(conf.n_layers)]
    )
    params["token_confidence"] = nn.stack_params(
        [{"token": nn.linear_init(d, 1, g)} for _ in range(conf.n_layers - 1)]
    )
    return params


def confidence_thresholds(n_layers: int) -> np.ndarray:
    """Per-layer early-exit thresholds (reference: lightglue.py:631-634)."""
    i = np.arange(n_layers)
    return np.clip(0.8 + 0.1 * np.exp(-4.0 * i / n_layers), 0, 1).astype(
        np.float32)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, N, D) -> (B, H, N, D/H), contiguous."""
    b, n, d = x.shape
    return x.reshape(b, n, num_heads, d // num_heads).transpose(1, 2).contiguous()


def _ffn_residual(p, x, message, conf: LightGlueConfig) -> torch.Tensor:
    """x + FFN(cat[x, message]): kernel B4, or the composed FFN when
    conf.flash or conf.fused_ffn is off."""
    if conf.flash and conf.fused_ffn:
        return ffn_ops.fused_ffn_residual(x, message.contiguous(), p)
    y = nn.linear(p["lin1"], torch.cat([x, message], -1))
    y = nn.gelu(nn.layer_norm(p["ln"], y))
    return x + nn.linear(p["lin2"], y)


def _fused_self_ok(conf: LightGlueConfig, n: int) -> bool:
    """JAX self_block's test for the whole-block kernel (lightglue.py:
    249-256): the attention kernels on (head_dim 64 or 128, _check_conf),
    N a multiple of 128 and at most MAX_FUSED_N."""
    return (conf.flash and conf.fused_self and conf.fused_ffn
            and n % 128 == 0 and n <= flash_self_ops.MAX_FUSED_N)


def _fused_cross_ok(conf: LightGlueConfig, m: int, n: int) -> bool:
    """JAX cross_block's test (lightglue.py:301-307): B6 takes head_dim 64
    only."""
    return (conf.flash and conf.fused_cross and conf.fused_ffn
            and conf.head_dim <= flash_cross_ops.HEAD_DIM
            and m % 128 == 0 and n % 128 == 0
            and max(m, n) <= flash_cross_block_ops.MAX_FUSED_N)


_PREPARED = WeakIdKeyDictionary()


def prepared_blocks(params, conf: LightGlueConfig):
    """Per layer, the (B5, B6) kernel weights of ``params``: built once per
    parameter tree and configuration (keyed by the tree's stacked Wqkv
    tensor, then by heads, shifts and ``mp``, so that fp32 and bf16
    weights never mix), not in every layer call. An edit in place of a
    tree's tensors is not seen: build a new tree."""
    key = params["transformers"]["self_attn"]["Wqkv"]["w"]
    per_conf = _PREPARED.setdefault(key, {})
    ck = (conf.num_heads, conf.self_softmax_shift, conf.cross_softmax_shift,
          conf.mp)
    if ck not in per_conf:
        per_conf[ck] = [
            (flash_self_ops.prepare(layer["self_attn"], conf.num_heads,
                                    conf.self_softmax_shift, conf.mp),
             flash_cross_block_ops.prepare(layer["cross_attn"], conf.num_heads,
                                           conf.cross_softmax_shift, conf.mp))
            for layer in (nn.index_params(params["transformers"], i)
                          for i in range(conf.n_layers))]
    return per_conf[ck]


_BF16_TREES = WeakIdKeyDictionary()


def compute_params(params, conf: LightGlueConfig):
    """``params`` as the layers read them under ``conf.mp``: the linears
    that take bf16 activations (input projection, the attention linears of
    the composed blocks, token confidence) cast to bf16 once per tree
    (keyed as prepared_blocks), so that nn.linear's cast to x's type does
    nothing per call. The rest (the FFN, which B4 prepares, the rotary
    projection and the assignment head, fp32 under mp) is the tree's own.
    Without mp: ``params``."""
    if not conf.mp:
        return params
    key = params["transformers"]["self_attn"]["Wqkv"]["w"]
    tree = _BF16_TREES.get(key)
    if tree is None:
        def bf16(p):
            return nn.map_params(p, lambda t: t.to(torch.bfloat16))

        sa, ca = (params["transformers"][n] for n in ("self_attn",
                                                      "cross_attn"))
        tree = dict(params, transformers={
            "self_attn": dict(sa, Wqkv=bf16(sa["Wqkv"]),
                              out_proj=bf16(sa["out_proj"])),
            "cross_attn": dict(ca, to_qk=bf16(ca["to_qk"]),
                               to_v=bf16(ca["to_v"]),
                               to_out=bf16(ca["to_out"]))})
        for n in ("input_proj", "token_confidence"):
            if n in params:
                tree[n] = bf16(params[n])
        _BF16_TREES[key] = tree
    return tree


def _block_weights(params, conf: LightGlueConfig):
    """Per layer, the (B5, B6) weights when a whole-block kernel may run,
    else (None, None)."""
    if conf.flash and conf.fused_ffn and (conf.fused_self or conf.fused_cross):
        return prepared_blocks(params, conf)
    return [(None, None)] * conf.n_layers


def self_block(p, x, encoding, conf: LightGlueConfig, key_mask=None,
               fused=None):
    """Self-attention block (reference SelfBlock, lightglue.py:159-172).
    encoding (2, B, 1, N, head_dim/2); key_mask (B, N) True = valid;
    ``fused``: this layer's B5 weights (prepared_blocks)."""
    b, n, d = x.shape
    if fused is not None and _fused_self_ok(conf, n):
        return flash_self_ops.fused_self_block(fused, x, encoding, key_mask)
    h = conf.num_heads
    qkv = nn.linear(p["Wqkv"], x)
    # reference packing: unflatten(-1, (heads, head_dim, 3)) (lightglue.py:166)
    qkv = qkv.reshape(b, n, h, d // h, 3).transpose(1, 2)
    q = rotary.apply_rotary(encoding, qkv[..., 0]).contiguous()
    k = rotary.apply_rotary(encoding, qkv[..., 1]).contiguous()
    v = qkv[..., 2].contiguous()
    if conf.flash:
        context = flash_ops.flash_sdpa(q, k, v, key_mask,
                                       shift=conf.self_softmax_shift)
    else:
        mask = None if key_mask is None else key_mask[:, None, None, :]
        context = attn_ops.sdpa(q, k, v, mask)
    message = nn.linear(p["out_proj"], block_tc.merge_heads(context))
    return _ffn_residual(p["ffn"], x, message, conf)


def cross_block(p, x0, x1, conf: LightGlueConfig, mask0=None, mask1=None,
                fused=None):
    """Shared-QK bidirectional cross attention (reference CrossBlock,
    lightglue.py:201-230); ``fused``: this layer's B6 weights. With the
    kernels, head_dim 64 takes K2 and 128 takes B1', which the JAX matcher
    calls without a shift (lightglue.py:319-330): cross_softmax_shift has
    no effect there."""
    if fused is not None and _fused_cross_ok(conf, x0.shape[1], x1.shape[1]):
        return flash_cross_block_ops.fused_cross_block(fused, x0, x1, mask0,
                                                       mask1)
    h = conf.num_heads
    qk0 = _split_heads(nn.linear(p["to_qk"], x0), h)
    qk1 = _split_heads(nn.linear(p["to_qk"], x1), h)
    v0 = _split_heads(nn.linear(p["to_v"], x0), h)
    v1 = _split_heads(nn.linear(p["to_v"], x1), h)
    if conf.flash and conf.head_dim <= flash_cross_ops.HEAD_DIM:
        m0, m1 = flash_cross_ops.fused_cross_attention(
            qk0, qk1, v0, v1, mask0, mask1, shift=conf.cross_softmax_shift)
    elif conf.flash:
        m0, m1 = flash_ops.flash_cross_pair(qk0, qk1, v0, v1, mask0, mask1)
    else:
        mask = None
        if mask0 is not None or mask1 is not None:
            b, dev = x0.shape[0], x0.device
            m0_ = mask0 if mask0 is not None else torch.ones(
                b, x0.shape[1], dtype=torch.bool, device=dev)
            m1_ = mask1 if mask1 is not None else torch.ones(
                b, x1.shape[1], dtype=torch.bool, device=dev)
            mask = m0_[:, None, :, None] & m1_[:, None, None, :]
        m0, m1 = attn_ops.bidirectional_cross_attention(qk0, qk1, v0, v1, mask)
    m0 = nn.linear(p["to_out"], block_tc.merge_heads(m0))
    m1 = nn.linear(p["to_out"], block_tc.merge_heads(m1))
    if conf.flash and conf.fused_ffn:  # B4 over the rows of both images
        return ffn_ops.fused_ffn_residual_pair(x0, m0, x1, m1, p["ffn"])
    return (_ffn_residual(p["ffn"], x0, m0, conf),
            _ffn_residual(p["ffn"], x1, m1, conf))


def transformer_layer(p, desc0, desc1, enc0, enc1, conf, mask0=None,
                      mask1=None, fused=(None, None)):
    """One self+self+cross layer (reference TransformerLayer,
    lightglue.py:239-262); ``fused``: this layer's (B5, B6) weights."""
    desc0 = self_block(p["self_attn"], desc0, enc0, conf, mask0, fused[0])
    desc1 = self_block(p["self_attn"], desc1, enc1, conf, mask1, fused[0])
    return cross_block(p["cross_attn"], desc0, desc1, conf, mask0, mask1,
                       fused[1])


def token_confidence(p, desc0, desc1):
    """Per-point confidence (reference TokenConfidence, lightglue.py:84-94):
    the linear in the descriptors' type, the sigmoid in fp32."""
    c0 = torch.sigmoid(nn.linear(p["token"], desc0).float())[..., 0]
    c1 = torch.sigmoid(nn.linear(p["token"], desc1).float())[..., 0]
    return c0, c1


def _assign_and_filter(la, conf: LightGlueConfig, desc0, desc1, mask0, mask1):
    """Final assignment + mutual-nearest filtering: kernel K4 on the
    projected descriptors, or the composed head when conf.flash is off."""
    d0, d1 = desc0.float(), desc1.float()
    if conf.flash:
        inv = d0.shape[-1] ** -0.25
        mdesc0 = (nn.linear(la["final_proj"], d0) * inv).contiguous()
        mdesc1 = (nn.linear(la["final_proj"], d1) * inv).contiguous()
        z0 = nn.linear(la["matchability"], d0)[..., 0]
        z1 = nn.linear(la["matchability"], d1)[..., 0]
        return fasg_ops.fused_filter_matches(
            mdesc0, mdesc1, z0, z1, conf.filter_threshold, mask0, mask1)
    scores, _ = asg.match_assignment(la, d0, d1, mask0, mask1)
    return asg.filter_matches(scores, conf.filter_threshold, mask0, mask1)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


class MatchOutput(NamedTuple):
    """Static-shape matcher output (lightglue_tpu MatchOutput): matches0
    (B, M) int32 index into image 1 or -1; matches1 (B, N); scores; stop,
    the number of layers run; prune0/prune1, each point's survival depth."""

    matches0: torch.Tensor
    matches1: torch.Tensor
    matching_scores0: torch.Tensor
    matching_scores1: torch.Tensor
    stop: int
    prune0: torch.Tensor
    prune1: torch.Tensor


def _check_conf(conf: LightGlueConfig) -> None:
    if conf.flash and conf.head_dim not in flash_ops.HEAD_DIMS:
        raise ValueError(
            f"the attention kernels take head_dim in {flash_ops.HEAD_DIMS}, "
            f"got {conf.head_dim}; use flash=False for the composed ops")


def _prepare(params, conf, kpts0, kpts1, desc0, desc1, size0, size1, mask0,
             mask1, scales0=None, oris0=None, scales1=None, oris1=None):
    """Normalization, scale/ori channels, input projection, rotary tables
    (reference: lightglue.py:492-525)."""
    _check_conf(conf)
    kn0 = normalize_keypoints(kpts0, size0, mask0)
    kn1 = normalize_keypoints(kpts1, size1, mask1)
    if conf.add_scale_ori:
        kn0 = torch.cat([kn0, scales0[..., None].float(),
                         oris0[..., None].float()], -1)
        kn1 = torch.cat([kn1, scales1[..., None].float(),
                         oris1[..., None].float()], -1)
    dtype = torch.bfloat16 if conf.mp else torch.float32
    desc0 = desc0.to(dtype)
    desc1 = desc1.to(dtype)
    if "input_proj" in params:
        desc0 = nn.linear(params["input_proj"], desc0)
        desc1 = nn.linear(params["input_proj"], desc1)
    enc0 = rotary.fourier_posenc(params["posenc"], kn0)
    enc1 = rotary.fourier_posenc(params["posenc"], kn1)
    return desc0.contiguous(), desc1.contiguous(), enc0, enc1


def forward_fixed(params, conf: LightGlueConfig, kpts0, kpts1, desc0, desc1,
                  size0=None, size1=None, mask0=None, mask1=None,
                  scales0=None, oris0=None, scales1=None, oris1=None):
    """All ``n_layers`` run (reference loop lightglue.py:538-543 with depth
    and width confidence disabled)."""
    b, m, _ = kpts0.shape
    n = kpts1.shape[1]
    tree = compute_params(params, conf)
    desc0, desc1, enc0, enc1 = _prepare(
        tree, conf, kpts0, kpts1, desc0, desc1, size0, size1, mask0, mask1,
        scales0, oris0, scales1, oris1)
    fused = _block_weights(params, conf)
    for i in range(conf.n_layers):
        desc0, desc1 = transformer_layer(
            nn.index_params(tree["transformers"], i), desc0, desc1,
            enc0, enc1, conf, mask0, mask1, fused[i])
    last = nn.index_params(params["log_assignment"], conf.n_layers - 1)
    m0, m1, ms0, ms1 = _assign_and_filter(last, conf, desc0, desc1, mask0,
                                          mask1)
    dev = desc0.device
    return MatchOutput(
        m0, m1, ms0, ms1, conf.n_layers,
        torch.full((b, m), conf.n_layers, dtype=torch.int32, device=dev),
        torch.full((b, n), conf.n_layers, dtype=torch.int32, device=dev),
    )


def forward_adaptive(params, conf: LightGlueConfig, kpts0, kpts1, desc0,
                     desc1, size0=None, size1=None, mask0=None, mask1=None,
                     scales0=None, oris0=None, scales1=None, oris1=None):
    """Depth early exit (reference break, lightglue.py:547-549) and width
    pruning as mask updates (reference index_select, lightglue.py:551-566).
    The stop decision pools over the batch, as the reference's does;
    pruning masks are per image. The loop reads its stop flag on the host
    once per layer; ``parallel/graphs.py`` captures the same steps
    (``adaptive_start``, ``adaptive_layer``, ``adaptive_finish``) one CUDA
    graph each."""
    state = adaptive_start(params, conf, kpts0, kpts1, desc0, desc1, size0,
                           size1, mask0, mask1, scales0, oris0, scales1,
                           oris1)
    fused = _block_weights(params, conf)
    for i in range(conf.n_layers):
        state, stop = adaptive_layer(params, conf, i, state, fused)
        if stop is None or bool(stop):  # host sync: one per layer
            break
    return adaptive_finish(params, conf, i + 1, state)


class AdaptiveState(NamedTuple):
    """The adaptive loop's state between layers: descriptors, active
    (unpruned, valid) masks, survival depths, and what every layer reads
    (the rotary tables and the number of valid points)."""

    desc0: torch.Tensor
    desc1: torch.Tensor
    act0: torch.Tensor
    act1: torch.Tensor
    prune0: torch.Tensor
    prune1: torch.Tensor
    enc0: torch.Tensor
    enc1: torch.Tensor
    num_points: torch.Tensor


def adaptive_start(params, conf: LightGlueConfig, kpts0, kpts1, desc0, desc1,
                   size0=None, size1=None, mask0=None, mask1=None,
                   scales0=None, oris0=None, scales1=None, oris1=None
                   ) -> AdaptiveState:
    """The adaptive loop's state before its first layer."""
    b, m, _ = kpts0.shape
    n = kpts1.shape[1]
    desc0, desc1, enc0, enc1 = _prepare(
        compute_params(params, conf), conf, kpts0, kpts1, desc0, desc1, size0,
        size1, mask0, mask1, scales0, oris0, scales1, oris1)
    dev = desc0.device
    act0 = mask0 if mask0 is not None else torch.ones(
        b, m, dtype=torch.bool, device=dev)
    act1 = mask1 if mask1 is not None else torch.ones(
        b, n, dtype=torch.bool, device=dev)
    num_points = (act0.sum() + act1.sum()).float()
    prune0 = torch.ones(b, m, dtype=torch.int32, device=dev)
    prune1 = torch.ones(b, n, dtype=torch.int32, device=dev)
    return AdaptiveState(desc0, desc1, act0, act1, prune0, prune1, enc0, enc1,
                         num_points)


def adaptive_layer(params, conf: LightGlueConfig, i: int, s: AdaptiveState,
                   fused):
    """Layer ``i`` of the reference's loop with break and pruning
    (lightglue.py:538-566); ``fused``: ``_block_weights(params, conf)``.
    Returns (state after it, the stop flag as a device bool, or None after
    the last layer, which has no confidence head)."""
    tree = compute_params(params, conf)
    d0, d1 = transformer_layer(
        nn.index_params(tree["transformers"], i), s.desc0, s.desc1, s.enc0,
        s.enc1, conf, s.act0, s.act1, fused[i])
    s = s._replace(desc0=d0, desc1=d1)
    if i == conf.n_layers - 1:
        return s, None
    do_early_stop = conf.depth_confidence > 0
    th = float(confidence_thresholds(conf.n_layers)[i])
    stop = torch.zeros((), dtype=torch.bool, device=d0.device)
    conf0 = conf1 = None
    if do_early_stop:
        tok = nn.index_params(tree["token_confidence"], i)
        conf0, conf1 = token_confidence(tok, d0, d1)
        # fraction of confident (or pruned/padded) points above
        # depth_confidence (reference: lightglue.py:645-656)
        unconf = (s.act0 & (conf0 < th)).sum() + (s.act1 & (conf1 < th)).sum()
        stop = (1.0 - unconf.float() / s.num_points) > conf.depth_confidence
    if conf.width_confidence > 0:
        la = nn.index_params(params["log_assignment"], i)
        act0, prune0 = _prune(la, conf, d0, s.act0, s.prune0, conf0, stop, th,
                              do_early_stop)
        act1, prune1 = _prune(la, conf, d1, s.act1, s.prune1, conf1, stop, th,
                              do_early_stop)
        s = s._replace(act0=act0, act1=act1, prune0=prune0, prune1=prune1)
    return s, stop


def adaptive_finish(params, conf: LightGlueConfig, layers: int,
                    s: AdaptiveState) -> MatchOutput:
    """The assignment head of layer ``layers`` - 1 after ``layers`` layers
    ran."""
    la = nn.index_params(params["log_assignment"], layers - 1)
    m0, m1, ms0, ms1 = _assign_and_filter(la, conf, s.desc0, s.desc1, s.act0,
                                          s.act1)
    prune0, prune1 = s.prune0, s.prune1
    if not conf.width_confidence > 0:
        prune0 = torch.full_like(prune0, conf.n_layers)
        prune1 = torch.full_like(prune1, conf.n_layers)
    return MatchOutput(m0, m1, ms0, ms1, layers, prune0, prune1)


def _prune(la, conf, desc, act, prune, confidences, stop, th, do_early_stop):
    """Keep high-matchability or low-confidence points (reference:
    lightglue.py:636-643), in images with more than pruning_min_kpts active
    points (lightglue.py:551, 559)."""
    ran = (~stop & (act.sum(1) > conf.pruning_min_kpts))[:, None]
    keep = asg.get_matchability(la, desc) > (1.0 - conf.width_confidence)
    if do_early_stop:
        keep = keep | (confidences <= th)
    act = act & (keep | ~ran)
    return act, prune + (ran & act).int()


def forward(params, conf: LightGlueConfig, **kw) -> MatchOutput:
    """Adaptive when either confidence is on, else fixed."""
    if conf.depth_confidence > 0 or conf.width_confidence > 0:
        return forward_adaptive(params, conf, **kw)
    return forward_fixed(params, conf, **kw)
