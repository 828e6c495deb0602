"""Feature pairs with planted correspondences, made on the device.

A copy of ``lightglue_tpu_torch/synthetic.py::planted_pairs`` (lines 29-87),
rewritten in PyTorch so that a pool of hundreds of pairs at 2048 points is
drawn on the card from a ``torch.Generator`` in a fraction of a second:
matched point i of image 0 lands at slot ``perm[i]`` of image 1 under a
random similarity transform with keypoint noise, with a noisy copy of its
unit descriptor; unmatched slots hold distractors, some of them lookalikes
of another image-0 point (confusers). Defaults as the original's.

Parameters (the traffic file): ``pairs_per_request``, ``requests`` (the
pool, cycled), ``keypoints`` [lo, hi] (each image's count, uniform),
``size_seed`` (the counts are drawn once from it: every run seed serves the
same requests' counts, each request's pairs and the requests in another
order), ``image_size`` [w, h], ``desc_dim``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def sizes(params: Dict) -> List[List[Tuple[int, int]]]:
    """Each request's (n0, n1) pairs, before the seed's shuffles."""
    lo, hi = params["keypoints"]
    rng = np.random.default_rng(params["size_seed"])
    n = rng.integers(lo, hi + 1, (params["requests"],
                                  params["pairs_per_request"], 2))
    return [[(int(a), int(b)) for a, b in req] for req in n]


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True)


def pair(g: torch.Generator, n0: int, n1: int, params: Dict, device,
         p_match: float = 0.5, desc_noise: float = 0.35,
         kpt_noise: float = 1.0, p_confuse: float = 0.6):
    """One planted pair with n0 and n1 points, as two feature dicts of
    device tensors (keypoints (n, 2), descriptors (n, D), image_size)."""
    m, n = min(n0, n1), max(n0, n1)
    d = params.get("desc_dim", 256)
    w, h = params["image_size"]
    wh = torch.tensor([w, h], dtype=torch.float32, device=device)

    def u(*shape):
        return torch.rand(*shape, generator=g, device=device)

    def normal(*shape):
        return torch.randn(*shape, generator=g, device=device)

    kpts0 = u(m, 2) * wh
    theta = u(()) * 1.6 - 0.8
    scale = torch.exp(u(()) * 0.56 - 0.3)
    shift = (u(2) - 0.5) * wh * 0.2
    c, s = torch.cos(theta) * scale, torch.sin(theta) * scale
    x = kpts0 - wh / 2
    geo = torch.stack([c * x[:, 0] - s * x[:, 1], s * x[:, 0] + c * x[:, 1]],
                      -1) + wh / 2 + shift
    geo = geo + kpt_noise * normal(m, 2)
    p = p_match * 0.4 + u(()) * (min(0.95, p_match * 1.6) - p_match * 0.4)
    dn = desc_noise * torch.exp(u(()) * 1.5 - 0.8)
    inside = ((geo >= 0) & (geo < wh)).all(-1)
    matched = (u(m) < p) & inside
    d0 = _unit(normal(m, d))
    d1_match = _unit(d0 + dn * _unit(normal(m, d)))
    d1 = _unit(normal(n, d))
    src = torch.randint(0, m, (n,), generator=g, device=device)
    confusers = _unit(d0[src] + dn * _unit(normal(n, d)))
    d1 = torch.where((u(n) < p_confuse)[:, None], confusers, d1)
    kpts1 = u(n, 2) * wh
    perm = torch.randperm(n, generator=g, device=device)[:m]
    d1[perm] = torch.where(matched[:, None], d1_match, d1[perm])
    kpts1[perm] = torch.where(matched[:, None],
                              torch.minimum(geo.clamp(min=0), wh - 1),
                              kpts1[perm])
    size = wh.clone()
    f0 = {"keypoints": kpts0, "descriptors": d0, "image_size": size}
    f1 = {"keypoints": kpts1, "descriptors": d1, "image_size": size}
    return (f0, f1) if n0 <= n1 else (f1, f0)


def make(params: Dict, seed: int, device) -> List[List[Tuple[Dict, Dict]]]:
    """The pool: ``requests`` lists of (feats0, feats1) pairs of numpy
    arrays, as ``BatchMatcher.match_pairs`` takes them."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    order = np.random.default_rng(seed)
    base = sizes(params)
    pool = []
    for r in order.permutation(len(base)):
        req = [pair(g, *base[r][i], params, device)
               for i in order.permutation(len(base[r]))]
        pool.append([tuple({k: v.cpu().numpy() for k, v in f.items()}
                           for f in pr) for pr in req])
    return pool
