"""Planted-correspondence image pairs in numpy, in the manner of
lightglue_tpu/train.py::synthetic_batch (train.py:67-171).

Matched point i of image 0 lands at slot ``perm[i]`` of image 1 under a
random similarity transform, with a noisy copy of its unit descriptor.
Unmatched slots hold distractors, some of them lookalikes of another image-0
point (confusers) that only geometry can reject. The generator is seeded
numpy, so the JAX package, the CPU port and the card see the same inputs.
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
