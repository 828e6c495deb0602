"""Image pairs: a procedural texture and its warp under a homography.

A copy of ``lightglue_tpu_torch/synthetic.py::texture`` (lines 105-129),
``random_homography`` (132-145), ``warp_points`` (148-151) and
``image_pair`` (154-166), the pixel work rewritten in PyTorch on the device
(value noise at three scales, discs and rectangles with sharp edges, their
count proportional to the area; the second image the first's bilinear
warp, 0 where it maps from outside), the shapes' and the homography's
parameters drawn in numpy. The images reach the program as uint8 host
arrays (B, H, W, C), grey or grey replicated to three channels.

Parameters (the traffic file): ``pairs_per_request``, ``requests`` (the
pool, cycled), ``height``, ``width``, ``channels`` (1 or 3).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def _bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """img (H, W) at float pixel coordinates; 0 outside."""
    h, w = img.shape
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    out = torch.zeros_like(x)
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            yy, xx = y0 + dy, x0 + dx
            ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            v = img[yy.clamp(0, h - 1).long(), xx.clamp(0, w - 1).long()]
            out = out + torch.where(ok, v, 0.0) * wx * wy
    return out


def texture(rng: np.random.Generator, h: int, w: int, device):
    img = torch.zeros(h, w, dtype=torch.float64, device=device)
    y, x = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=device),
                          torch.arange(w, dtype=torch.float64, device=device),
                          indexing="ij")
    for cell, amp in ((96, 0.35), (24, 0.2), (6, 0.1)):
        grid = torch.as_tensor(rng.uniform(size=(h // cell + 2,
                                                 w // cell + 2)),
                               device=device)
        img += amp * _bilinear(grid, x / cell, y / cell)
    for _ in range(max(4, h * w // 4000)):
        r = int(rng.integers(3, max(4, min(h, w) // 12)))
        cy, cx = int(rng.integers(0, h)), int(rng.integers(0, w))
        y0, y1 = max(cy - r, 0), min(cy + r + 1, h)
        x0, x1 = max(cx - r, 0), min(cx + r + 1, w)
        if rng.uniform() < 0.5:  # disc
            yy = torch.arange(y0, y1, device=device)[:, None]
            xx = torch.arange(x0, x1, device=device)[None, :]
            inside = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        else:  # rectangle of random aspect
            inside = torch.ones(y1 - y0, x1 - x0, dtype=torch.bool,
                                device=device)
            inside[:, int(rng.integers(1, inside.shape[1] + 1)):] = False
        patch = img[y0:y1, x0:x1]
        patch[inside] = patch[inside] * 0.3 + rng.uniform(0.0, 0.7)
    img -= img.min()
    return img / img.max().clamp(min=1e-6)


def random_homography(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    theta = rng.uniform(-0.25, 0.25)
    s = np.exp(rng.uniform(-0.16, 0.14))
    c, si = np.cos(theta) * s, np.sin(theta) * s
    cx, cy = w / 2, h / 2
    tx, ty = rng.uniform(-0.05, 0.05, 2) * (w, h)
    sim = np.array([[c, -si, cx - c * cx + si * cy + tx],
                    [si, c, cy - si * cx - c * cy + ty],
                    [0.0, 0.0, 1.0]])
    persp = np.eye(3)
    persp[2, :2] = rng.uniform(-0.1, 0.1, 2) / (w, h)
    return persp @ sim


def image_pair(rng: np.random.Generator, h: int, w: int, device):
    """(image0, image1) (h, w) float64 in [0, 1] on ``device``."""
    img0 = texture(rng, h, w, device)
    inv = torch.as_tensor(np.linalg.inv(random_homography(rng, h, w)),
                          device=device)
    y, x = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=device),
                          torch.arange(w, dtype=torch.float64, device=device),
                          indexing="ij")
    ph = torch.stack([x, y, torch.ones_like(x)], -1) @ inv.T
    return img0, _bilinear(img0, ph[..., 0] / ph[..., 2],
                           ph[..., 1] / ph[..., 2])


def to_u8(imgs: List[torch.Tensor], channels: int) -> np.ndarray:
    u8 = (torch.stack(imgs) * 255.0).round().clamp(0, 255).to(torch.uint8)
    return u8[..., None].expand(-1, -1, -1, channels).contiguous().cpu(
        ).numpy()


def make(params: Dict, seed: int, device) -> List[Tuple[np.ndarray, ...]]:
    """The pool: ``requests`` calls, each (images0, images1) uint8 (B, H, W,
    C) and their (B, 2) true (w, h) sizes."""
    rng = np.random.default_rng(seed)
    h, w, b = params["height"], params["width"], params["pairs_per_request"]
    pool = []
    for _ in range(params["requests"]):
        pairs = [image_pair(rng, h, w, device) for _ in range(b)]
        size = np.tile(np.array([[w, h]], np.float32), (b, 1))
        pool.append((to_u8([p[0] for p in pairs], params["channels"]),
                     to_u8([p[1] for p in pairs], params["channels"]), size))
    return pool
