"""Seeded synthetic inputs in numpy, so the JAX package, the CPU port and
the card see the same data.

``planted_pairs``: feature pairs with planted correspondences, in the manner
of lightglue_tpu/train.py::synthetic_batch (train.py:67-171). Matched point
i of image 0 lands at slot ``perm[i]`` of image 1 under a random similarity
transform, with a noisy copy of its unit descriptor. Unmatched slots hold
distractors, some of them lookalikes of another image-0 point (confusers)
that only geometry can reject.

``image_pair``: a procedural grayscale texture and its warp under a known
homography, with bilinear sampling, for the extractor (no OpenCV needed).

``hardnet_params``: seeded random HardNet weights whose batch norms hold
the statistics of real patches, the stand-in for the release weights.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def _unit(x: np.ndarray) -> np.ndarray:
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def planted_pairs(
    rng: np.random.Generator,
    batch: int,
    m: int,
    n: Optional[int] = None,
    desc_dim: int = 256,
    image_size: Tuple[float, float] = (1024.0, 768.0),
    p_match: float = 0.5,
    desc_noise: float = 0.35,
    kpt_noise: float = 1.0,
    p_confuse: float = 0.6,
) -> Dict[str, np.ndarray]:
    """``batch`` pairs with ``m`` keypoints in image 0 and ``n`` (default m,
    n >= m) in image 1. Returns float32 keypoints0/1 (B, M/N, 2),
    descriptors0/1 (B, M/N, D), image_size (B, 2) and gt_matches0 (B, M):
    the planted index into image 1, or -1."""
    n = m if n is None else n
    if n < m:
        raise ValueError(f"n ({n}) must be >= m ({m})")
    w, h = image_size
    wh = np.array([w, h])
    kpts0 = rng.uniform(size=(batch, m, 2)) * wh
    theta = rng.uniform(-0.8, 0.8, (batch, 1))
    scale = np.exp(rng.uniform(-0.3, 0.26, (batch, 1)))
    shift = (rng.uniform(size=(batch, 1, 2)) - 0.5) * wh * 0.2
    c, s = np.cos(theta) * scale, np.sin(theta) * scale
    x = kpts0 - wh / 2
    geo = np.stack([c * x[..., 0] - s * x[..., 1],
                    s * x[..., 0] + c * x[..., 1]], -1) + wh / 2 + shift
    geo = geo + kpt_noise * rng.standard_normal((batch, m, 2))
    # per-pair difficulty: match rate and descriptor noise vary
    p = rng.uniform(p_match * 0.4, min(0.95, p_match * 1.6), (batch, 1))
    dn = desc_noise * np.exp(rng.uniform(-0.8, 0.7, (batch, 1, 1)))
    inside = ((geo >= 0) & (geo < wh)).all(-1)
    matched = (rng.uniform(size=(batch, m)) < p) & inside

    d0 = _unit(rng.standard_normal((batch, m, desc_dim)))
    d1_match = _unit(d0 + dn * _unit(rng.standard_normal((batch, m, desc_dim))))
    d1 = _unit(rng.standard_normal((batch, n, desc_dim)))
    src = rng.integers(0, m, (batch, n))
    confusers = _unit(np.take_along_axis(d0, src[..., None], 1)
                      + dn * _unit(rng.standard_normal((batch, n, desc_dim))))
    confuse = rng.uniform(size=(batch, n)) < p_confuse
    d1 = np.where(confuse[..., None], confusers, d1)
    kpts1 = rng.uniform(size=(batch, n, 2)) * wh

    perm = np.stack([rng.permutation(n)[:m] for _ in range(batch)])
    rows = np.arange(batch)[:, None]
    d1[rows, perm] = np.where(matched[..., None], d1_match, d1[rows, perm])
    kpts1[rows, perm] = np.where(matched[..., None],
                                 np.clip(geo, 0, wh - 1), kpts1[rows, perm])
    return {
        "keypoints0": kpts0.astype(np.float32),
        "keypoints1": kpts1.astype(np.float32),
        "descriptors0": d0.astype(np.float32),
        "descriptors1": d1.astype(np.float32),
        "image_size": np.tile(np.array([[w, h]], np.float32), (batch, 1)),
        "gt_matches0": np.where(matched, perm, -1).astype(np.int32),
    }


def _bilinear(img: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """img (H, W) at float pixel coordinates; 0 outside the image."""
    h, w = img.shape
    x0, y0 = np.floor(x).astype(np.int64), np.floor(y).astype(np.int64)
    fx, fy = x - x0, y - y0
    out = np.zeros(x.shape, np.float64)
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            yy, xx = y0 + dy, x0 + dx
            ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            out += np.where(ok, img[np.clip(yy, 0, h - 1),
                                    np.clip(xx, 0, w - 1)], 0.0) * wx * wy
    return out


def texture(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """(h, w) float32 in [0, 1]: value noise at three scales plus discs and
    rectangles with sharp edges and corners, their count proportional to
    the area."""
    img = np.zeros((h, w))
    for cell, amp in ((96, 0.35), (24, 0.2), (6, 0.1)):
        grid = rng.uniform(size=(h // cell + 2, w // cell + 2))
        y, x = np.meshgrid(np.arange(h) / cell, np.arange(w) / cell,
                           indexing="ij")
        img += amp * _bilinear(grid, x, y)
    for _ in range(max(4, h * w // 4000)):
        r = int(rng.integers(3, max(4, min(h, w) // 12)))
        cy, cx = int(rng.integers(0, h)), int(rng.integers(0, w))
        ys = slice(max(cy - r, 0), min(cy + r + 1, h))
        xs = slice(max(cx - r, 0), min(cx + r + 1, w))
        if rng.uniform() < 0.5:  # disc
            yy, xx = np.mgrid[ys, xs]
            inside = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        else:  # rectangle of random aspect
            inside = np.ones((ys.stop - ys.start, xs.stop - xs.start), bool)
            inside[:, int(rng.integers(1, inside.shape[1] + 1)):] = False
        patch = img[ys, xs]
        patch[inside] = patch[inside] * 0.3 + rng.uniform(0.0, 0.7)
    img -= img.min()
    return (img / max(img.max(), 1e-6)).astype(np.float32)


def random_homography(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """A mild 3x3 homography about the image centre: rotation up to 0.25
    rad, scale 0.85-1.15, shift up to 5 % and a small perspective term."""
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


def warp_points(hom: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """(N, 2) (x, y) points through a 3x3 homography."""
    ph = np.concatenate([pts, np.ones_like(pts[:, :1])], 1) @ hom.T
    return ph[:, :2] / ph[:, 2:]


def image_pair(
    rng: np.random.Generator, h: int, w: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(image0, image1, hom): two (h, w) float32 grayscale images in
    [0, 1], image1 the warp of image0 under ``hom`` (image-0 pixel ->
    image-1 pixel), 0 where it maps from outside image 0."""
    img0 = texture(rng, h, w)
    hom = random_homography(rng, h, w)
    y, x = np.meshgrid(np.arange(h, dtype=np.float64),
                       np.arange(w, dtype=np.float64), indexing="ij")
    src = warp_points(np.linalg.inv(hom), np.stack([x.ravel(), y.ravel()], 1))
    img1 = _bilinear(img0.astype(np.float64), src[:, 0], src[:, 1])
    return img0, img1.reshape(h, w).astype(np.float32), hom


def hardnet_params(images, conf, seed: int = 0):
    """Seeded random HardNet weights (``models.hardnet.init_params``) whose
    batch norms hold, conv by conv, the per-channel mean and (biased)
    variance of that conv's output on the LAF patches at the SIFT
    detections (``conf``, a SIFTConfig) of ``images`` (B, H, W) grey, on
    their device: the stand-in for the release weights, which are not in
    the repository. With the init's identity batch norms the descriptors
    nearly coincide (ReLU outputs are positive, so the 8x8 conv's common
    part swamps the rest: cosines about 0.7 apart on average, and the
    trained matcher finds nothing); with these they spread (about 0)."""
    import torch

    from . import nn
    from .models import hardnet, sift_device

    p = hardnet.init_params(conf, torch.Generator().manual_seed(seed))
    p = nn.params_to(p, images.device)
    with torch.inference_mode():
        det = sift_device.extract_batch(images, conf)
        x = hardnet.extract_laf_patches_batch(
            images, det["keypoints"], hardnet.LAF_SCALE * det["scales"],
            det["oris"])[det["valid"]]
        x = hardnet._input_norm(x)
        with nn.fp32_convs():
            for i in range(len(hardnet.LAYERS)):
                x = hardnet.conv(p, i, x)
                p[f"bn{i}"]["mean"] = x.mean((0, 2, 3))
                p[f"bn{i}"]["var"] = x.var((0, 2, 3), unbiased=False)
                x = hardnet.norm(p, i, x)
    return {k: {n: t.clone() for n, t in v.items()} for k, v in p.items()}
