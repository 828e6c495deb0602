"""Deformable convolution (DCNv1), stride 1, in plain PyTorch (counterpart
of lightglue_tpu/ops/deform.py; reference aliked.py:291-349, which wraps
``torchvision.ops.deform_conv2d``).

The layouts are torchvision's: x (B, C, H, W), offset (B, 2 kh kw, H, W)
with channel 2t the dy and 2t + 1 the dx of tap t (row-major), weight OIHW.
Each tap samples its input bilinearly at the offset position, zero outside
the map: one gather of the four corners from the channels-last input, the
corners outside the map weighted 0, and one matrix product contracts the
samples with the weights. The JAX package's
corner-quad table and its coordinate clamp are a TPU gather layout with the
same values.

A bf16 x (mp) runs as the JAX package's at mp: the offsets from a bf16
conv, the bilinear samples formed in fp32 and rounded to bf16, then the
product with the bf16 weights in fp32 sums, rounded to bf16
(lightglue_tpu/ops/deform.py:126-141).
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import nn


def bilinear_taps(x: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor
                  ) -> torch.Tensor:
    """x (B, C, H, W) sampled at pixel coordinates fy, fx (B, ...), zero
    outside the map. Returns (B, ..., C)."""
    b, c, h, w = x.shape
    flat = x.float().permute(0, 2, 3, 1).reshape(b, h * w, c)
    y0, x0 = torch.floor(fy), torch.floor(fx)
    wy, wx = fy - y0, fx - x0
    # the four corners along a new last axis, gathered at once
    yi = torch.stack([y0, y0, y0 + 1, y0 + 1], -1)
    xi = torch.stack([x0, x0 + 1, x0, x0 + 1], -1)
    inside = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
    idx = (torch.clamp(yi, 0, h - 1) * w + torch.clamp(xi, 0, w - 1)).long()
    vals = torch.gather(flat, 1, idx.reshape(b, -1, 1).expand(-1, -1, c))
    wts = torch.stack([(1 - wy) * (1 - wx), (1 - wy) * wx,
                       wy * (1 - wx), wy * wx], -1)
    wts = torch.where(inside, wts, 0.0)[..., None]
    vals = vals.reshape(*idx.shape, c)
    # the corners combined as XLA compiles the JAX package's sum of four
    # products: fused multiply-adds, fma(v3, w3, fma(v2, w2, fma(v0, w0,
    # round(v1 w1)))). ``addcmul`` fuses its multiply and add on the CPU
    # and on CUDA (tests/test_torch_mp_extract.py holds the samples to the
    # JAX package's bit for bit, chip_smoke.py's phase 5f the card's to the
    # CPU's). Summed in another way the sample moves by an fp32 step, and
    # at mp its bf16 rounding can land on the other neighbour.
    out = torch.addcmul(vals[..., 1, :] * wts[..., 1, :], vals[..., 0, :],
                        wts[..., 0, :])
    for k in (2, 3):
        out = torch.addcmul(out, vals[..., k, :], wts[..., k, :])
    return out


def deform_conv2d(
    x: torch.Tensor,
    offset: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    padding: int = 1,
) -> torch.Tensor:
    """Deformable convolution, stride 1, output (B, O, H, W) (the SAME size
    as the input, as the reference's k 3, padding 1 use)."""
    b, c, h, w = x.shape
    o, _, kh, kw = weight.shape
    off = offset.reshape(b, kh * kw, 2, h, w).permute(0, 3, 4, 1, 2)
    dev = x.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :, None]
    tap_y = torch.arange(kh, dtype=torch.float32, device=dev).repeat_interleave(kw)
    tap_x = torch.arange(kw, dtype=torch.float32, device=dev).repeat(kh)
    fy = ys - padding + tap_y + off[..., 0].float()  # (B, H, W, kh kw)
    fx = xs - padding + tap_x + off[..., 1].float()
    patches = bilinear_taps(x, fy, fx).to(x.dtype)  # (B, H, W, kh kw, C)
    wmat = weight.permute(2, 3, 1, 0).reshape(kh * kw * c, o)
    out = nn.matmul(patches.reshape(b, h * w, kh * kw * c), wmat)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out.reshape(b, h, w, o).permute(0, 3, 1, 2)


def deformable_conv_block(p: nn.Params, x: torch.Tensor) -> torch.Tensor:
    """The reference's DeformableConv2d (aliked.py:291-349): a 3x3 conv
    predicts the offsets, clamped to +-max(H, W)/4, and the deformable conv
    applies ``regular_conv`` at the offset taps. x NCHW."""
    h, w = x.shape[2:]
    max_offset = max(h, w) / 4.0
    offset = torch.clamp(nn.conv2d(p["offset_conv"], x), -max_offset, max_offset)
    return deform_conv2d(x, offset, p["regular_conv"]["w"],
                         p["regular_conv"].get("b"))
