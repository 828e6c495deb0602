"""ALIKED detector and descriptor (counterpart of
lightglue_tpu/models/aliked.py; reference lightglue/aliked.py, from
Shiaoming/ALIKED).

* Encoder: a ConvBlock and three ResBlocks, the last two with the
  deformable conv of ``ops/deform.py``, NCHW, cuDNN convs in full fp32.
  Block 1 and its two consumers run through kernel B10 on the lazy path
  when ``conf.fused_stem`` and block 1 has 16 channels (aliked-n16).
* Aggregation: each branch through a 1x1 conv and SELU (y1 at full
  resolution, y2-y4 at 1/2, 1/8, 1/32). The score head's 1x1 stage is
  applied per branch at the branch's resolution and the 8-channel parts
  are upsampled and summed (exact: the 1x1 conv commutes with the
  channel-wise lerp); its 3x3 tail runs through B11 (lazy path) or B12
  (dense path) when ``conf.fused_score_head``.
* DKD: NMS (kernel B9, radius 2), border zeroing, an exact tie-stable
  top-k, a 5x5 soft-argmax at temperature 0.1 and a bilinear score lookup.
* SDDH: a 3x3 patch at each keypoint, the offset MLP, bilinear samples of
  the L2-normalized feature map at M positions, a 1x1 conv, SELU and the
  learned aggregation.

With ``conf.lazy_fm`` the full-resolution 128-channel feature map is never
built: SDDH evaluates each row it reads from the branch maps (kept
channels-last for those row gathers). A branch of height or width 1 takes
its single row or column there, as the upsampling does; the JAX package's
corner-quad table clamps it to a row that does not exist.

Images enter as (B, H, W, C), the JAX package's layout, H and W multiples
of 32 (the pipeline pads them); ``image_size`` gives the true extent.

With ``conf.mp`` the image becomes bf16 and the encoder, the aggregation and
the feature rows run in bf16 (lightglue_tpu/models/aliked.py:725-757): B10,
B11 and B12 in their bf16 forms, the convs and deformable convs in bf16,
the score parts summed in fp32 and the score map, the offsets, the
descriptor head's products and the descriptors fp32, as the JAX package
at mp.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import nn
from ..configs import ALIKEDConfig
from ..ops import aliked_stem, score_head
from ..ops.deform import deformable_conv_block
from ..ops.sampling import bilinear_sample, simple_nms, top_k_keypoints, upsample
from .superpoint import Features

BF16 = torch.bfloat16

# c1, c2, c3, c4, dim, K, M  (reference aliked.py:625-630)
CFGS = {
    "aliked-t16": (8, 16, 32, 64, 64, 3, 16),
    "aliked-n16": (16, 32, 64, 128, 128, 3, 16),
    "aliked-n16rot": (16, 32, 64, 128, 128, 3, 16),
    "aliked-n32": (16, 32, 64, 128, 128, 3, 32),
}
STRIDE = 32  # H and W must be multiples of it


def init_params(
    conf: ALIKEDConfig = ALIKEDConfig(),
    generator: Optional[torch.Generator] = None,
) -> nn.Params:
    """Random parameters with the reference shapes (OIHW), drawn from
    ``generator`` on the CPU: torch's Conv2d default for the convs,
    identity batch norms, U(0, 1) aggregation weights, as the JAX package's
    init. With them the score map is nearly flat (see
    ``chip_smoke.py::aliked_params`` for the stand-in that spreads it)."""
    g = generator or torch.Generator().manual_seed(0)
    c1, c2, c3, c4, dim, k, m = CFGS[conf.model_name]

    def conv(cin, cout, ks, bias=False):
        return nn.conv2d_init(cin, cout, ks, g, bias)

    def block_conv(cin, cout, deform):
        if not deform:
            return conv(cin, cout, 3)
        return {"offset_conv": conv(cin, 18, 3, True),
                "regular_conv": conv(cin, cout, 3)}

    def block(cin, cout, deform=False, res=True):
        p = {"conv1": block_conv(cin, cout, deform),
             "bn1": nn.batch_norm_init(cout),
             "conv2": block_conv(cout, cout, deform),
             "bn2": nn.batch_norm_init(cout)}
        if res:
            p["downsample"] = conv(cin, cout, 1, True)
        return p

    return {
        "block1": block(3, c1, res=False),
        "block2": block(c1, c2),
        "block3": block(c2, c3, deform=True),
        "block4": block(c3, c4, deform=True),
        "conv1": conv(c1, dim // 4, 1),
        "conv2": conv(c2, dim // 4, 1),
        "conv3": conv(c3, dim // 4, 1),
        "conv4": conv(dim, dim // 4, 1),
        "score_head": {"0": conv(dim, 8, 1), "2": conv(8, 4, 3),
                       "4": conv(4, 4, 3), "6": conv(4, 1, 3)},
        "desc_head": {
            "offset_conv1": conv(dim, 2 * m, k, True),
            "offset_conv2": conv(2 * m, 2 * m, 1, True),
            "sf_conv": conv(dim, dim, 1),
            "agg_weights": torch.rand(m, dim, dim, generator=g),
        },
    }


# ---------------------------------------------------------------------------
# Encoder and aggregation
# ---------------------------------------------------------------------------


def _res_block(p: nn.Params, x: torch.Tensor, deform: bool) -> torch.Tensor:
    """The reference ResBlock (aliked.py:386-436), NCHW."""
    conv = deformable_conv_block if deform else nn.conv2d
    with nn.fp32_convs():
        out = nn.selu(nn.batch_norm(p["bn1"], conv(p["conv1"], x)))
        out = nn.batch_norm(p["bn2"], conv(p["conv2"], out))
        return nn.selu(out + nn.conv2d(p["downsample"], x))


def _coarse_blocks(params: nn.Params, x2: torch.Tensor):
    """Blocks 3 and 4 after block 2's output x2 (NCHW)."""
    x3 = _res_block(params["block3"], nn.avg_pool(x2, 4), True)
    x4 = _res_block(params["block4"], nn.avg_pool(x3, 4), True)
    return x3, x4


def _branch(p: nn.Params, x: torch.Tensor) -> torch.Tensor:
    with nn.fp32_convs():
        return nn.selu(nn.conv2d(p, x))


def _score_parts(sh: nn.Params, ys, channels_last: bool):
    """The score head's 1x1 stage applied to each branch at its own
    resolution: four (B, 8, hk, wk) parts whose upsampled sum is s0, fp32
    (bf16 branches with the weights in bf16, fp32 sums)."""
    w0 = sh["0"]["w"][:, :, 0, 0]  # (8, dim)
    parts, c = [], 0
    for y in ys:
        ch = y.shape[-1 if channels_last else 1]
        wk = w0[:, c:c + ch].to(y.dtype).float()
        c += ch
        parts.append(torch.einsum("bhwc,sc->bshw" if channels_last
                                  else "bchw,sc->bshw", y.float(), wk).contiguous())
    if "b" in sh["0"]:
        parts[0] = parts[0] + sh["0"]["b"][:, None, None]
    return parts


def _tapmat_bf16(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A 3x3 conv (no bias) of bf16 x as XLA runs the JAX package's
    ``conv2d_tapmat`` at mp (lightglue_tpu/nn.py:158-189): each tap's
    product over the input channels rounded to bf16, the nine shifted
    partials summed in fp32 in tap order, rounded to bf16."""
    cout, cin = w.shape[:2]
    _, _, h, wd = x.shape
    # every tap's partial at once, channels-last: [ci][tap][co] columns
    wt = w.to(BF16).float().permute(1, 2, 3, 0).reshape(cin, 9 * cout)
    u = nn.round_bf16(x.float().permute(0, 2, 3, 1) @ wt)  # (B, H, W, 9 cout)
    u = torch.nn.functional.pad(u, (0, 0, 1, 1, 1, 1))
    acc = None
    for t in range(9):
        dy, dx = divmod(t, 3)
        ut = u[:, dy:dy + h, dx:dx + wd, t * cout:(t + 1) * cout]
        acc = ut if acc is None else acc + ut
    return acc.permute(0, 3, 1, 2).to(BF16)


def _score_tail(sh: nn.Params, parts, fused: bool, lazy: bool, mp: bool):
    """The score map from the 1x1 parts: B11 (lazy) or B12 (dense) when
    ``fused``, else the composed tail; at mp the composed path rounds and
    resamples each coarse part in bf16 and runs the tail in bf16, as the
    JAX package's XLA path (lightglue_tpu/models/aliked.py:268-285,
    449-467)."""
    if fused and lazy:
        return score_head.score_head_lazy(sh, *parts, mp=mp)
    if not mp:
        s0 = score_head.upsampled_sum(*parts)
        tail = score_head.score_head_cplane if fused else score_head.score_tail_plain
        return tail(sh, s0)
    size = parts[0].shape[-2:]
    s0 = parts[0]
    for sk in parts[1:]:
        s0 = s0 + upsample(sk.to(BF16), size).float()
    if fused:
        return score_head.score_head_cplane(sh, s0, mp=True)
    s = nn.selu(s0.to(BF16))
    s = nn.selu(_tapmat_bf16(sh["2"]["w"], s))
    s = nn.selu(_tapmat_bf16(sh["4"]["w"], s))
    return torch.sigmoid(_tapmat_bf16(sh["6"]["w"], s).float())[:, 0]


def _dense_raw(params: nn.Params, image: torch.Tensor,
               fused_score: bool = False):
    """(B, 3, H, W) image -> (feature map (B, H, W, dim) channels-last,
    before its L2 normalization, score map (B, H, W)) (reference
    aliked.py:709-740). B12 scores it when ``fused_score``. A bf16 image
    runs the bf16 path (mp)."""
    x1 = aliked_stem.conv_block(params["block1"], image)
    x2 = _res_block(params["block2"], nn.avg_pool(x1, 2), False)
    x3, x4 = _coarse_blocks(params, x2)
    ys = [_branch(params[f"conv{i}"], x) for i, x in enumerate((x1, x2, x3, x4), 1)]
    size = image.shape[2:]
    fm = torch.cat([ys[0]] + [upsample(y, size) for y in ys[1:]], 1)
    parts = _score_parts(params["score_head"], ys, False)
    score = _score_tail(params["score_head"], parts, fused_score, False,
                        image.dtype == BF16)
    return fm.permute(0, 2, 3, 1).contiguous(), score


def extract_dense_map(params: nn.Params, image: torch.Tensor,
                      fused_score: bool = False):
    """(B, 3, H, W) -> (L2-normalized feature map (B, H, W, dim), score map
    (B, H, W))."""
    fm, sm = _dense_raw(params, image, fused_score)
    return nn.l2_normalize(fm), sm


def _dense_branches(params: nn.Params, image: torch.Tensor,
                    fused_score: bool = False, fused_stem: bool = True):
    """Encoder and aggregation without the full-resolution feature map:
    returns ((y1, y2, y3, y4) channels-last, score map). B10 runs block 1
    when ``fused_stem`` and block 1 has 16 channels, as in the JAX package
    (lightglue_tpu/models/aliked.py:397-400), so that aliked-t16 rounds
    block 1 where the JAX package does. B11 runs the score head when
    ``fused_score``. A bf16 image runs the bf16 path (mp)."""
    fused_stem = fused_stem and params["conv1"]["w"].shape[1] == 16
    stem = aliked_stem.fused_aliked_stem if fused_stem \
        else aliked_stem.composed_stem
    y1, x1p = stem({"block1": params["block1"], "conv1": params["conv1"]}, image)
    x2 = _res_block(params["block2"], x1p, False)
    x3, x4 = _coarse_blocks(params, x2)
    ys = [y1] + [_branch(params[f"conv{i}"], x).permute(0, 2, 3, 1).contiguous()
                 for i, x in ((2, x2), (3, x3), (4, x4))]
    parts = _score_parts(params["score_head"], ys, True)
    return ys, _score_tail(params["score_head"], parts, fused_score, True,
                           image.dtype == BF16)


# ---------------------------------------------------------------------------
# DKD: keypoint detection (reference aliked.py:94-261)
# ---------------------------------------------------------------------------


def _extent(h: int, w: int, device) -> torch.Tensor:
    """(w - 1, h - 1), filled on the device: a host tensor here would cost a
    copy and a sync."""
    return torch.stack([torch.full((), w - 1.0, device=device),
                        torch.full((), h - 1.0, device=device)])


def _gather_patches(maps: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
                    r: int) -> torch.Tensor:
    """(2r+1)^2 patches of (B, H, W) maps at integer centres (B, K), zero
    outside, row-major. Returns (B, K, (2r+1)^2)."""
    b, h, w = maps.shape
    ks = 2 * r + 1
    padded = torch.nn.functional.pad(maps, (r, r, r, r)).reshape(b, -1)
    d = torch.arange(ks, device=maps.device)
    idx = ((iy[..., None, None] + d[:, None]) * (w + 2 * r)
           + ix[..., None, None] + d[None, :])  # (B, K, ks, ks)
    return torch.gather(padded, 1, idx.reshape(b, -1)).reshape(b, -1, ks * ks)


def detection_map(score_map: torch.Tensor, conf: ALIKEDConfig,
                  image_size: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The map the top-k reads: ``simple_nms`` of the score map (B, H, W),
    then the border band of nms_radius at 0, measured from the true extent
    when the image is padded."""
    b, h, w = score_map.shape
    r = conf.nms_radius
    dev = score_map.device
    nms = simple_nms(score_map, r)
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    if image_size is not None:
        size = image_size.to(dev, torch.float32)
        tw, th = size[:, 0, None, None], size[:, 1, None, None]
    else:
        tw = torch.full((b, 1, 1), float(w), device=dev)
        th = torch.full((b, 1, 1), float(h), device=dev)
    border = (ys < r) | (ys >= th - r) | (xs < r) | (xs >= tw - r)
    return torch.where(border, torch.zeros_like(nms), nms)


def dkd_detect(score_map: torch.Tensor, conf: ALIKEDConfig,
               image_size: Optional[torch.Tensor] = None):
    """Static-k detection with sub-pixel refinement. score_map (B, H, W).
    Returns (keypoints (B, K, 2) in pixels, scores (B, K), valid (B, K))."""
    _, h, w = score_map.shape
    r = conf.nms_radius
    dev = score_map.device
    kpts, _, valid = top_k_keypoints(
        detection_map(score_map, conf, image_size), conf.max_num_keypoints,
        conf.detection_threshold, approx_recall=conf.approx_topk,
        twolevel=conf.twolevel_topk)

    # sub-pixel refinement: soft-argmax over the raw scores around each peak
    ks = 2 * r + 1
    patches = _gather_patches(score_map, kpts[..., 1].long(),
                              kpts[..., 0].long(), r)
    lin = torch.linspace(-r, r, ks, device=dev)
    grid = torch.stack([lin.repeat(ks), lin.repeat_interleave(ks)], -1)
    max_v = patches.max(-1, keepdim=True).values
    x_exp = torch.exp((patches - max_v) / 0.1)  # temperature (aliked.py:117)
    residual = (x_exp @ grid) / x_exp.sum(-1, keepdim=True)
    kpts = kpts + residual
    # the score at the refined location (aliked.py:226-233)
    kscore = bilinear_sample(score_map[..., None],
                             kpts / _extent(h, w, dev) * 2.0 - 1.0)[..., 0]
    return kpts, kscore, valid


# ---------------------------------------------------------------------------
# SDDH: deformable descriptor head (reference aliked.py:479-609)
# ---------------------------------------------------------------------------


def _patch_corners(keypoints: torch.Tensor, ps: int, h: int, w: int):
    """Pixel rows yy, xx (B, K ps^2) of the ps x ps patch at each keypoint:
    keypoints truncated to integers, corner at ikpt - ps/2 + 1, clamped
    into the map (reference aliked.py:48-54, 551)."""
    b = keypoints.shape[0]
    ik = keypoints.to(torch.int32).float()
    cx = torch.clamp((ik[..., 0] - ps / 2 + 1).to(torch.int64), 0, w - 1 - ps)
    cy = torch.clamp((ik[..., 1] - ps / 2 + 1).to(torch.int64), 0, h - 1 - ps)
    d = torch.arange(ps, device=keypoints.device)
    yy = cy[..., None] + d.repeat_interleave(ps)
    xx = cx[..., None] + d.repeat(ps)
    return yy.reshape(b, -1), xx.reshape(b, -1)


def _offsets(p: nn.Params, patches: torch.Tensor, m: int, max_offset: float):
    """The offset MLP on (B, K, ps^2, C) patches -> (B, K, M, 2) pixel
    offsets as (x, y) (reference view(N, 2, M), aliked.py:571)."""
    b, kp = patches.shape[:2]
    w1 = p["offset_conv1"]["w"].permute(2, 3, 1, 0).reshape(-1, 2 * m)
    # fp32 (bf16 rows at mp promote against the fp32 weights, as in JAX)
    x = nn.selu(patches.reshape(b, kp, -1).float() @ w1 + p["offset_conv1"]["b"])
    x = x @ p["offset_conv2"]["w"][:, :, 0, 0].t() + p["offset_conv2"]["b"]
    x = torch.clamp(x, -max_offset, max_offset)
    return x.reshape(b, kp, 2, m).transpose(2, 3)


def _aggregate(p: nn.Params, feats: torch.Tensor) -> torch.Tensor:
    """(B, K, M, C) samples -> (B, K, C) L2-normalized descriptors, fp32."""
    feats = nn.selu(feats.float() @ p["sf_conv"]["w"][:, :, 0, 0].t())
    descs = torch.einsum("bkpc,pcd->bkd", feats, p["agg_weights"])
    return nn.l2_normalize(descs)


def sddh_describe(p: nn.Params, feature_map: torch.Tensor,
                  keypoints: torch.Tensor, conf: ALIKEDConfig,
                  prenormalized: bool = True) -> torch.Tensor:
    """feature_map (B, H, W, C) channels-last; keypoints (B, K, 2) pixels.
    ``prenormalized=False`` takes the raw map and L2-normalizes each row it
    gathers. Returns (B, K, C) L2-normalized descriptors."""
    b, h, w, c = feature_map.shape
    *_, ps, m = CFGS[conf.model_name]
    kp = keypoints.shape[1]
    yy, xx = _patch_corners(keypoints, ps, h, w)
    idx = (yy * w + xx)[..., None].expand(-1, -1, c)
    patches = torch.gather(feature_map.reshape(b, h * w, c), 1, idx)
    if not prenormalized:
        patches = nn.l2_normalize(patches)
    off = _offsets(p, patches.reshape(b, kp, ps * ps, c), m, max(h, w) / 4.0)
    pos = keypoints[:, :, None, :] + off
    wh = _extent(h, w, pos.device)
    feats = bilinear_sample(feature_map, (2.0 * pos / wh - 1.0).reshape(b, -1, 2),
                            row_l2_normalize=not prenormalized)
    return _aggregate(p, feats.reshape(b, kp, m, c))


def _gather_rows(y: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor):
    """Rows of a channels-last map y (B, h, w, C) at (B, S) pixels."""
    b, h, w, c = y.shape
    idx = (iy * w + ix)[..., None].expand(-1, -1, c)
    return torch.gather(y.reshape(b, h * w, c), 1, idx)


def _branch_rows(y: torch.Tensor, cy: torch.Tensor, cx: torch.Tensor):
    """A branch map's bilinear values at fractional coordinates (B, S)
    inside it, with the two-point weights of the align-corners upsampling
    (rows first, then columns, as ``upsample``). A dimension of 1 takes its
    single row or column with weight 0 on the (same) second one."""
    _, hk, wk, _ = y.shape
    y0, x0 = torch.floor(cy), torch.floor(cx)
    # the lerp in the map's type (bf16 at mp), as the JAX package's
    wy = (cy - y0)[..., None].to(y.dtype)
    wx = (cx - x0)[..., None].to(y.dtype)
    y0, x0 = y0.long(), x0.long()
    y1, x1 = torch.clamp(y0 + 1, max=hk - 1), torch.clamp(x0 + 1, max=wk - 1)
    q00, q10, q01, q11 = _gather_rows(
        y, torch.cat([y0, y1, y0, y1], 1),
        torch.cat([x0, x0, x1, x1], 1)).chunk(4, 1)
    left = q00 * (1 - wy) + q10 * wy
    right = q01 * (1 - wy) + q11 * wy
    return left * (1 - wx) + right * wx


def _fm_rows_lazy(ys, iy: torch.Tensor, ix: torch.Tensor, h: int, w: int):
    """L2-normalized rows fm[iy, ix] of fm = concat(y1, up(y2), up(y3),
    up(y4)), evaluated from the branch maps: y1 gives its own pixel, each
    coarser branch its value at the align-corners coordinate. iy, ix (B, S)
    inside the map. Returns (B, S, dim)."""
    parts = [_gather_rows(ys[0], iy, ix)]
    for y in ys[1:]:
        hk, wk = y.shape[1:3]
        cy = iy.float() * ((hk - 1.0) / (h - 1.0))
        cx = ix.float() * ((wk - 1.0) / (w - 1.0))
        parts.append(_branch_rows(y, cy, cx))
    return nn.l2_normalize(torch.cat(parts, -1))


def sddh_describe_lazy(p: nn.Params, ys, keypoints: torch.Tensor,
                       conf: ALIKEDConfig, h: int, w: int) -> torch.Tensor:
    """``sddh_describe(prenormalized=False)`` against the branch maps: every
    feature-map row it reads is evaluated by ``_fm_rows_lazy``; offset
    samples are 0 outside the map (grid_sample's zero padding)."""
    b, kp = keypoints.shape[:2]
    *_, dim, ps, m = CFGS[conf.model_name]
    yy, xx = _patch_corners(keypoints, ps, h, w)
    patches = _fm_rows_lazy(ys, yy, xx, h, w).reshape(b, kp, ps * ps, dim)
    pos = keypoints[:, :, None, :] + _offsets(p, patches, m, max(h, w) / 4.0)
    px, py = pos[..., 0].reshape(b, -1), pos[..., 1].reshape(b, -1)
    x0, y0 = torch.floor(px), torch.floor(py)
    wdt = ys[0].dtype  # the lerp in the map's type (bf16 at mp)
    wx, wy = (px - x0)[..., None].to(wdt), (py - y0)[..., None].to(wdt)
    # the four corners' rows in one evaluation, corner by corner along S
    yi = torch.cat([y0, y0, y0 + 1, y0 + 1], 1)
    xi = torch.cat([x0, x0 + 1, x0, x0 + 1], 1)
    inside = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
    v = _fm_rows_lazy(ys, torch.clamp(yi, 0, h - 1).long(),
                      torch.clamp(xi, 0, w - 1).long(), h, w)
    v00, v01, v10, v11 = torch.where(inside[..., None], v, 0.0).chunk(4, 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    feats = top * (1 - wy) + bot * wy
    return _aggregate(p, feats.reshape(b, kp, m, dim))


@torch.inference_mode()
def forward(
    params: nn.Params,
    conf: ALIKEDConfig,
    image: torch.Tensor,
    image_size: Optional[torch.Tensor] = None,
) -> Features:
    """(B, H, W, C) image (C 1 or 3, H and W multiples of 32) -> static-k
    Features. ``image_size`` (B, 2) as (w, h): the true extent of a padded
    image; detections in the pad band are suppressed with the border.
    Every image of the batch is computed at once (the JAX package maps
    over them one by one, a TPU scheduling choice with the same results)."""
    if image.shape[1] % STRIDE or image.shape[2] % STRIDE:
        raise ValueError(f"H and W must be multiples of {STRIDE}, got "
                         f"{tuple(image.shape[1:3])}")
    if image.shape[-1] == 1:
        image = image.expand(-1, -1, -1, 3)
    x = image.permute(0, 3, 1, 2).contiguous().float()
    if conf.mp:
        x = x.to(BF16)
    h, w = x.shape[2:]
    if conf.lazy_fm:
        ys, score_map = _dense_branches(params, x, conf.fused_score_head,
                                        conf.fused_stem)
        kpts, kscores, valid = dkd_detect(score_map, conf, image_size)
        descs = sddh_describe_lazy(params["desc_head"], ys, kpts, conf, h, w)
    else:
        fm, score_map = _dense_raw(params, x, conf.fused_score_head)
        kpts, kscores, valid = dkd_detect(score_map, conf, image_size)
        descs = sddh_describe(params["desc_head"], fm, kpts, conf,
                              prenormalized=False)
    return Features(
        keypoints=kpts,
        keypoint_scores=torch.where(valid, kscores, torch.zeros_like(kscores)),
        descriptors=torch.where(valid[..., None], descs, torch.zeros_like(descs)),
        valid=valid,
    )
