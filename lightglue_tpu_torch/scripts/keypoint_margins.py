"""Why two extractions of one image keep different keypoints: the score
margins of every keypoint that one keeps and the other does not.

Two bf16 extractions (the card and the CPU, or the port and the JAX
package) sum their convolutions in other orders, so a value rounded to
bf16 after its sum can land one bf16 step apart in the two. A keypoint can
then change sides only where its score lies close to what decides it: the
cut of the top-k (the lowest kept score, or the detection threshold when
fewer than k pass it) or the runner-up of its NMS window (the largest
other score within ``nms_radius``, which it must beat to stay a peak).
For each keypoint kept by extraction A and not by B, ``unshared_margins``
reads both margins on A's own maps, |score - cut| and score - runner-up
(0 for a keypoint below its runner-up, which survived a later NMS round),
in two units:

- the score's steps (``score_steps``), the gated unit: one bf16 step of
  the score or, where larger, the most that one bf16 step of each rounded
  value the score is computed from moves it. SuperPoint's score is an fp32
  softmax of bf16 logits: one step of a logit of 8 moves the score by
  2^-5 of itself, eight steps of its own. ALIKED's is an fp32 sigmoid of a
  bf16 value x: one step of x moves it by s (1 - s) u(x).
- bf16 steps of the score alone (2^(floor(log2 s) - 7)), printed beside.

A keypoint that clears both margins by more than ``FAULT_STEPS`` of the
score's steps was lost to more than one rounding of what its score is
computed from: ``faults`` counts those.

``detection_maps`` gives an extractor's dense score map, the map its
top-k reads (``models.superpoint.detection_map``,
``models.aliked.detection_map``) and the steps; keypoints are compared as
the integer pixels the top-k keeps (ALIKED's sub-pixel refinement comes
after). ``chip_smoke.py`` (phase 5f) counts the margins of the card against
the CPU port at mp; ``tests/test_torch_mp_extract.py`` of the port against
the JAX package at mp.

ALIKED's two deformable blocks (3 and 4) carry a one-step flip of an
offset, which moves where a tap samples, into every channel there, and
their maps are upsampled 8 and 32 times into the score: on the card
against the CPU at mp they make almost all of the keypoints the two do
not share. ``deformable_blocks`` records their outputs in one extraction
and replays them in another, so that the rest of the chain (the kernels
among it) is compared on its own.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models import aliked as al
from ..models import superpoint as sp
from ..ops.sampling import top_k_keypoints

FAULT_STEPS = 4.0  # both margins beyond this many steps: a fault


def detection_maps(kind: str, params, conf, image: torch.Tensor,
                   image_size: Optional[torch.Tensor] = None):
    """(dense score map (B, H, W) fp32, the map the top-k reads, the
    score's steps (``score_steps``)) of ``kind`` ("superpoint" or
    "aliked") on ``image`` (B, H, W, C), as the extractor's forward
    computes them."""
    with torch.inference_mode():
        if kind == "superpoint":
            logits = sp.dense_heads(params, image, conf.fused_stem,
                                    conf.mp)[0]
            raw = sp.dense_forward(params, image, conf.fused_stem,
                                   conf.mp)[0]
            return (raw, sp.detection_map(raw, conf, image_size),
                    score_steps(raw, logits=logits))
        if image.shape[-1] == 1:
            image = image.expand(-1, -1, -1, 3)
        x = image.permute(0, 3, 1, 2).contiguous().float()
        if conf.mp:
            x = x.to(torch.bfloat16)
        if conf.lazy_fm:
            raw = al._dense_branches(params, x, conf.fused_score_head,
                                     conf.fused_stem)[1]
        else:
            raw = al._dense_raw(params, x, conf.fused_score_head)[1]
        raw = raw.float()
        return (raw, al.detection_map(raw, conf, image_size),
                score_steps(raw, sigmoid=conf.mp))


@contextlib.contextmanager
def deformable_blocks(record: Optional[List] = None,
                      outputs: Optional[Tuple[torch.Tensor, ...]] = None):
    """Inside the block, ALIKED's blocks 3 and 4
    (``models.aliked._coarse_blocks``) append (their input x2, their
    outputs (x3, x4)) to ``record``, or return ``outputs`` in place of
    theirs, moved to the input's device."""
    run = al._coarse_blocks

    def blocks(params, x2):
        if outputs is not None:
            return tuple(t.to(x2.device) for t in outputs)
        out = run(params, x2)
        if record is not None:
            record.append((x2, out))
        return out

    al._coarse_blocks = blocks
    try:
        yield
    finally:
        al._coarse_blocks = run


def ulp(x: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """One step (unit in the last place) of each value in ``dtype``."""
    fi = torch.finfo(dtype)
    mag = x.abs().double().clamp(min=fi.tiny)
    return torch.exp2(torch.floor(torch.log2(mag))) * fi.eps


def score_steps(scores: torch.Tensor, logits: Optional[torch.Tensor] = None,
                sigmoid: bool = False) -> torch.Tensor:
    """The step of each score (B, H, W): one bf16 step of it, or the most
    that one bf16 step of each value it is computed from moves it, where
    that is more. ``logits`` (B, 65, H/8, W/8) bf16: SuperPoint's score
    p_c = softmax(l)_c, |d log p_c| <= (1 - p_c) u_c + sum_(j != c) p_j u_j
    with u the logits' steps (the dustbin's among them), laid out as the
    scores are. ``sigmoid``: s = sigmoid(x) of a bf16 x, |ds| <= s (1 - s)
    u(x)."""
    own = ulp(scores)
    if logits is not None and logits.dtype == torch.bfloat16:
        p = torch.softmax(logits.double(), dim=1)
        u = ulp(logits)
        total = (p * u).sum(1, keepdim=True)
        move = (p * ((1 - p) * u + total - p * u))[:, :-1]
        b, _, h, w = move.shape
        move = move.reshape(b, 8, 8, h, w).permute(0, 3, 1, 4, 2)
        own = torch.maximum(own, move.reshape(b, h * 8, w * 8))
    if sigmoid:
        s = scores.double().clamp(1e-30, 1 - 1e-7)
        x = torch.log(s) - torch.log1p(-s)
        own = torch.maximum(own, s * (1 - s) * ulp(x))
    return own


def kept(det: torch.Tensor, k: int, threshold: float):
    """Per image, the flat indices the top-k keeps (valid ones) and the cut:
    the lowest kept score when all k pass the threshold, else the
    threshold."""
    b, h, w = det.shape
    kpts, scores, valid = top_k_keypoints(det, k, threshold)
    out = []
    for i in range(b):
        v = valid[i]
        idx = (kpts[i, v, 1].long() * w + kpts[i, v, 0].long()).cpu().numpy()
        cut = float(scores[i, k - 1]) if bool(v.all()) else threshold
        out.append((idx, cut))
    return out


def window_max(a: np.ndarray, idx: np.ndarray, r: int,
               skip_centre: bool = False) -> np.ndarray:
    """The largest value of ``a`` (H, W) within r of each flat index (the
    index itself left out with ``skip_centre``; -inf off the map)."""
    h, w = a.shape
    padded = np.pad(a.astype(np.float64), r, constant_values=-np.inf)
    y, x = idx // w, idx % w
    best = np.full(idx.shape, -np.inf)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy or dx or not skip_centre:
                best = np.maximum(best, padded[y + r + dy, x + r + dx])
    return best


def unshared_margins(maps_a, maps_b, k: int, threshold: float, r: int
                     ) -> Dict[str, np.ndarray]:
    """For every image, the keypoints kept by A and not by B and those kept
    by B and not by A, each with its margins read on its own extraction's
    maps: |score - cut| and score - runner-up (0 where the runner-up is
    higher), in the score's steps (columns 0 and 1) and in bf16 steps of
    the score alone (columns 2 and 3). ``maps_*``: detection_maps' (raw,
    det, steps). Returns {"a": (n, 4), "b": (m, 4)} over all images, and
    the number of keypoints each kept ("kept_a", "kept_b")."""
    sides = {}
    for tag, (raw, det, steps), (_, det_o, _) in (
            ("a", maps_a, maps_b), ("b", maps_b, maps_a)):
        mine, theirs = kept(det, k, threshold), kept(det_o, k, threshold)
        rows, n = [], 0
        for i, ((idx, cut), (other, _)) in enumerate(zip(mine, theirs)):
            n += len(idx)
            lost = np.setdiff1d(idx, other)
            ri = raw[i].detach().cpu().numpy().astype(np.float64)
            s = ri.reshape(-1)[lost]
            step = steps[i].detach().cpu().numpy().reshape(-1)[lost]
            own = ulp(torch.from_numpy(s)).numpy()
            m_cut = np.abs(s - cut)
            # a keypoint below its window's runner-up survived a later
            # round of NMS (its rival suppressed by a third point): no
            # margin of its own
            m_nms = np.maximum(s - window_max(ri, lost, r, skip_centre=True),
                               0.0)
            rows.append(np.stack([m_cut / step, m_nms / step,
                                  m_cut / own, m_nms / own], -1))
        sides[tag] = np.concatenate(rows) if rows else np.zeros((0, 4))
        sides[f"kept_{tag}"] = n
    return sides


def faults(margins: np.ndarray, steps: float = FAULT_STEPS,
           plain: bool = False) -> int:
    """Keypoints whose cut and NMS margins both exceed ``steps`` of the
    score's steps (with ``plain``, of bf16 steps of the score alone)."""
    c = 2 if plain else 0
    return int(((margins[:, c] > steps) & (margins[:, c + 1] > steps)).sum())


def summary(m: Dict[str, np.ndarray]) -> str:
    """One line: kept and unshared keypoints, and the counts above 1, 2
    and 4 on each margin and on both, in the score's steps and in bf16
    steps of the score alone, for each side."""
    parts = []
    for tag in ("a", "b"):
        x = m[tag]
        above = lambda c, t: int((x[:, c] > t).sum())  # noqa: E731
        line = [f"{tag}: {x.shape[0]} of {m[f'kept_{tag}']} unshared"]
        for c, unit in ((0, "in steps"), (2, "in bf16 steps of the score")):
            line.append(
                f"{unit}: cut > 1/2/4 {above(c, 1)}/{above(c, 2)}/"
                f"{above(c, 4)}, NMS > 1/2/4 {above(c + 1, 1)}/"
                f"{above(c + 1, 2)}/{above(c + 1, 4)}, both > 4 "
                f"{faults(x, plain=c == 2)}")
        parts.append("; ".join(line))
    return " | ".join(parts)
