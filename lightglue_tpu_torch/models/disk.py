"""DISK detector and descriptor (counterpart of lightglue_tpu/models/disk.py;
reference lightglue/disk.py, the thin U-Net of kornia's DISK).

The U-Net runs in NCHW: input 3 channels, down channels [16, 32, 64, 64,
64], up channels [64, 64, 64, desc_dim + 1], 5x5 convolutions in
pre-activation blocks (PReLU gate, instance norm, conv; the first block
ungated), 2x2 average pooling down, x2 bilinear upsampling with skip
concatenation up. The last block's conv is never run densely: its heatmap
channel is one conv to a single channel (at ``mp`` the tap-product form of
the JAX package, ``nn.conv2d_tapmat``), and its descriptor channels are
evaluated only at the K detected keypoints, as one product of their 5x5
patches with the reshaped weight. Detection is kornia's: a window-max NMS,
a threshold and a static top-k; descriptors are L2-normalized in fp32.

In fp32 the convolutions run in full fp32 (no TF32). ``conf.mp`` runs the
image and the U-Net in bf16 with the JAX package's rounding points: the
conv's fp32 sum rounded before its bias is added in bf16, the gate's
product in bf16, the instance norm's fp32 statistics rounded once, the
pool a bf16 sum divided by 4, each upsampling axis rounded; the heatmap is
cast to fp32 and the descriptors are fp32 sums of bf16 products.
Images enter as (B, H, W, C), the JAX package's layout; H and W are
multiples of 16.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .. import nn
from ..configs import DISKConfig
from ..ops.sampling import top_k_keypoints
from .superpoint import Features

DOWN = [16, 32, 64, 64, 64]
UP = [64, 64, 64]  # then desc_dim + 1
KERNEL = 5
STRIDE = 16  # H and W multiples of this (four 2x2 pools)


def block_channels(conf: DISKConfig = DISKConfig()):
    """[("down" | "up", index, in channels, out channels, gated)] of every
    block, the up blocks' inputs being the upsampled map and the skip."""
    out, cin = [], 3
    for i, cout in enumerate(DOWN):
        out.append(("down", i, cin, cout, i > 0))
        cin = cout
    for i, cout in enumerate(UP + [conf.desc_dim + 1]):
        full = cin + DOWN[len(DOWN) - 2 - i]
        out.append(("up", i, full, cout, True))
        cin = cout
    return out


def init_params(
    conf: DISKConfig = DISKConfig(),
    generator: Optional[torch.Generator] = None,
) -> nn.Params:
    """Random parameters at the published widths, OIHW, drawn from
    ``generator`` on the CPU (torch's Conv2d default; PReLU gates at
    0.25), as the JAX package's ``init_params``."""
    g = generator or torch.Generator().manual_seed(0)
    params: dict = {"down": {}, "up": {}}
    for path, i, cin, cout, gated in block_channels(conf):
        p = {"conv": nn.conv2d_init(cin, cout, KERNEL, g)}
        if gated:
            p["gate"] = {"alpha": torch.full((cin,), 0.25)}
        params[path][str(i)] = p
    return params


def _gate(p: nn.Params, x: torch.Tensor) -> torch.Tensor:
    """The block's PReLU and instance norm, where the block is gated (a
    converted checkpoint's first block may be)."""
    if "gate" not in p:
        return x
    return nn.instance_norm(nn.prelu(p["gate"]["alpha"], x))


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pooling as XLA's reduce_window sums it on the CPU: in
    fp32 the two rows' pairs, then their sum, divided by 4; in bf16 the
    row-major bf16 sum (``nn.avg_pool``)."""
    if x.dtype != torch.float32:
        return nn.avg_pool(x, 2)
    a, b = x[..., 0::2, 0::2], x[..., 0::2, 1::2]
    c, d = x[..., 1::2, 0::2], x[..., 1::2, 1::2]
    return ((a + b) + (c + d)) / 4


def _block(p: nn.Params, x: torch.Tensor) -> torch.Tensor:
    return nn.conv2d(p["conv"], _gate(p, x))


def unet_trunk(params: nn.Params, x: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) -> (B, 64 + DOWN[0], H, W): the gated and normalized
    input of the last up block, everything but its conv
    (lightglue_tpu/models/disk.py:97-138), in x's type. The JAX package
    runs the first conv phase-packed (a TPU layout of the same stride-1
    5x5 conv); here it is the plain conv."""
    feats = []
    for i in range(len(DOWN)):
        if i:
            x = avg_pool2(x)
        x = _block(params["down"][str(i)], x)
        feats.append(x)
    y = feats[-1]
    for i in range(len(UP)):
        y = torch.cat([nn.upsample2(y), feats[len(DOWN) - 2 - i]], 1)
        y = _block(params["up"][str(i)], y)
    y = torch.cat([nn.upsample2(y), feats[0]], 1)
    return _gate(params["up"][str(len(UP))], y)


def heatmap(params: nn.Params, z: torch.Tensor, desc_dim: int) -> torch.Tensor:
    """The last conv's heatmap channel on the trunk z: (B, H, W) fp32. A
    plain conv in fp32; the tap-product form at bf16 (each tap's partial
    rounded, the bias added in bf16), as the JAX package's
    ``_heatmap_tapmat``."""
    p = params["up"][str(len(UP))]["conv"]
    ph = {"w": p["w"][desc_dim:]}
    if "b" in p:
        ph["b"] = p["b"][desc_dim:]
    conv = nn.conv2d if z.dtype == torch.float32 else nn.conv2d_tapmat
    return conv(ph, z)[:, 0].float()


def desc_at_keypoints(params: nn.Params, z: torch.Tensor,
                      kpts: torch.Tensor, desc_dim: int) -> torch.Tensor:
    """The last conv's descriptor channels at K integer keypoints only:
    the 5x5 patches of z (B, C, H, W) at kpts (B, K, 2) (x, y) gathered
    and multiplied by the reshaped weight in one product, fp32 sums of
    z's type's operands plus the fp32 bias. Returns (B, K, desc_dim) fp32
    (not rounded back to z's type, lightglue_tpu/models/disk.py:149-189)."""
    p = params["up"][str(len(UP))]["conv"]
    cout, cin, k, _ = p["w"].shape
    b, _, h, w = z.shape
    r = k // 2
    zp = F.pad(z, (r, r, r, r)).permute(0, 2, 3, 1)  # (B, H + 2r, W + 2r, C)
    wp = w + 2 * r
    flat = zp.reshape(b, (h + 2 * r) * wp, cin)
    offs = torch.tensor([dy * wp + dx for dy in range(k) for dx in range(k)],
                        device=z.device)
    base = kpts[..., 1].long() * wp + kpts[..., 0].long()
    idx = (base[..., None] + offs).reshape(b, -1)  # (B, K * taps)
    rows = torch.gather(flat, 1, idx[..., None].expand(-1, -1, cin))
    cols = rows.reshape(b, kpts.shape[1], k * k * cin).float()
    # tap-major, channel-minor rows, as the patches
    wmat = p["w"][:desc_dim].permute(2, 3, 1, 0).reshape(k * k * cin, desc_dim)
    desc = cols @ wmat.to(z.dtype).float()
    if "b" in p:
        desc = desc + p["b"][:desc_dim].float()
    return desc


def detection_map(heat: torch.Tensor, conf: DISKConfig,
                  image_size: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The map the top-k reads: the heatmap where it equals the maximum of
    its nms_window_size window (-inf padding), else -inf, and -inf outside
    the true extent of a padded image (kornia's window NMS,
    lightglue_tpu/models/disk.py:192-224)."""
    win = conf.nms_window_size
    local_max = F.max_pool2d(heat[:, None], win, 1, win // 2)[:, 0]
    neg = torch.full_like(heat, -torch.inf)
    scores = torch.where(heat == local_max, heat, neg)
    if image_size is not None:
        _, h, w = heat.shape
        size = image_size.to(heat.device, torch.float32)
        ys = torch.arange(h, device=heat.device, dtype=torch.float32)
        xs = torch.arange(w, device=heat.device, dtype=torch.float32)
        inside = ((ys[None, :, None] < size[:, 1, None, None])
                  & (xs[None, None, :] < size[:, 0, None, None]))
        scores = torch.where(inside, scores, neg)
    return scores


def heatmap_to_keypoints(heat: torch.Tensor, conf: DISKConfig,
                         image_size: Optional[torch.Tensor] = None):
    """Window NMS, the image-size mask and the static top-k (ties toward
    the lower flat index). Returns (kpts (B, K, 2) (x, y), scores, valid):
    valid where the score is finite and above the threshold, scores 0
    elsewhere."""
    kpts, kscores, valid = top_k_keypoints(
        detection_map(heat, conf, image_size), conf.max_num_keypoints,
        conf.detection_threshold, approx_recall=conf.approx_topk,
        twolevel=conf.twolevel_topk)
    valid = valid & torch.isfinite(kscores)
    return kpts, torch.where(valid, kscores, torch.zeros_like(kscores)), valid


@torch.inference_mode()
def forward(
    params: nn.Params,
    conf: DISKConfig,
    image: torch.Tensor,
    image_size: Optional[torch.Tensor] = None,
) -> Features:
    """Full extraction: (B, H, W, C) image (gray images repeated to three
    channels) -> static-k Features. ``image_size`` (B, 2) as (w, h) gives
    the true extent of a padded image: no keypoint is taken outside it."""
    if image.shape[1] % STRIDE or image.shape[2] % STRIDE:
        raise ValueError(f"H and W must be multiples of {STRIDE}, got "
                         f"{tuple(image.shape[1:3])}")
    if image.shape[-1] == 1:
        image = image.expand(-1, -1, -1, 3)
    x = image.permute(0, 3, 1, 2).contiguous().float()
    if conf.mp:
        x = x.to(torch.bfloat16)
    with nn.fp32_convs():
        z = unet_trunk(params, x)
        heat = heatmap(params, z, conf.desc_dim)
    kpts, kscores, valid = heatmap_to_keypoints(heat, conf, image_size)
    descs = nn.l2_normalize(desc_at_keypoints(params, z, kpts, conf.desc_dim))
    return Features(
        keypoints=kpts,
        keypoint_scores=kscores,
        descriptors=torch.where(valid[..., None], descs, torch.zeros_like(descs)),
        valid=valid,
    )
