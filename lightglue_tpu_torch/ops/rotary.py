"""Rotary (learnable-Fourier) positional encoding (counterpart of
lightglue_tpu/ops/rotary.py:18-84; reference lightglue.py:58-81)."""

from __future__ import annotations

import torch

from .. import nn


def apply_rotary(enc: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Apply a half-layout encoding ``enc = (2, ..., N, F/2)`` (cos, sin,
    one entry per channel pair) to interleaved-layout ``t``:
    out[2i] = t[2i] c_i - t[2i+1] s_i; out[2i+1] = t[2i+1] c_i + t[2i] s_i.
    """
    cos = enc[0].to(t.dtype)[..., None]
    sin = enc[1].to(t.dtype)[..., None]
    x = t.reshape(*t.shape[:-1], -1, 2)
    x1 = x[..., 0:1]
    x2 = x[..., 1:2]
    o = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return o.reshape(t.shape)


def fourier_posenc_init(
    m_dim: int, f_dim: int, generator: torch.Generator, gamma: float = 1.0
) -> nn.Params:
    """W_r: R^M -> R^{F/2}, N(0, gamma^-2) (reference: lightglue.py:68-74)."""
    w = torch.randn(m_dim, f_dim // 2, generator=generator) * gamma**-2
    return {"Wr": {"w": w}}


def fourier_posenc(p: nn.Params, kpts: torch.Tensor) -> torch.Tensor:
    """Rotary tables for keypoints (B, N, M): (2, B, 1, N, F/2) fp32, the
    (cos, sin) of the projection, broadcastable over heads."""
    proj = kpts.float() @ p["Wr"]["w"].float()
    return torch.stack([torch.cos(proj), torch.sin(proj)], 0)[:, :, None]
