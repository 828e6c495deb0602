"""The comparison that decides ``correct`` for an extractor's outputs.

The reference extractor (fp32, TF32 off) runs on the same images:

- ``keypoint_gap`` (px): every valid keypoint of either side, its distance
  to the nearest valid keypoint of the other side, clipped at 4 px (a
  point that one side selected and the other did not counts 4); a
  request's number is the mean. Sound runs differ only where a near tie
  in the score map flips a selection.
- ``descriptor_gap``: ||program descriptor - reference descriptor at the
  program's keypoint|| (unit vectors), a request's mean over the program's
  valid keypoints: the descriptor head judged on the program's keypoints.
- ``kscore_gap``: |program keypoint score - the reference's score map at
  the program's keypoint|, a request's mean over the program's valid
  keypoints: the detector's map and its scoring judged where the program
  detected.
- ``cut_gap``: how far the reference's map of peaks (after NMS, the
  border at -1) at a program's keypoint lies below the score that the
  reference's own selection needed there (its k-th peak, or the
  threshold), 0 where it clears it; a request's mean over the program's
  valid keypoints: selection (NMS, the border, the top-k and the
  threshold) judged on the program's choice. A point that the
  reference's top-k cuts by a near tie reads that tie's small margin; one
  that it suppresses, or that is no peak of its map, reads the whole cut.

A run's numbers are the largest over its judged requests.
"""

from __future__ import annotations

import torch

CLIP_PX = 4.0


def keypoint_gaps(k0, v0, k1, v1) -> torch.Tensor:
    """Nearest-neighbour distances (clipped) of the valid points of one
    image's two keypoint sets, both directions."""
    a, b = k0[v0].double(), k1[v1].double()
    if len(a) == 0 or len(b) == 0:
        n = len(a) + len(b)
        return torch.full((max(n, 1),), CLIP_PX if n else 0.0,
                          dtype=torch.float64, device=k0.device)
    d = torch.cdist(a, b)
    return torch.cat([d.min(1).values, d.min(0).values]).clamp(max=CLIP_PX)


def descriptor_gaps(d_prog, d_ref, valid) -> torch.Tensor:
    return (d_prog.double() - d_ref.double())[valid].norm(dim=-1)


def kscore_gaps(s_prog, s_ref, valid) -> torch.Tensor:
    return (s_prog.double() - s_ref.double())[valid].abs()


def cut_gaps(pmap, cut, kpts, valid) -> torch.Tensor:
    """(cut - ``pmap`` at each valid keypoint) clipped at 0, for one image:
    ``pmap`` (H, W) the reference's peaks, ``kpts`` (K, 2) the program's
    integer keypoints as (x, y) px."""
    h, w = pmap.shape
    x = kpts[:, 0].round().long().clamp(0, w - 1)
    y = kpts[:, 1].round().long().clamp(0, h - 1)
    return (cut.double() - pmap[y, x].double()).clamp(min=0)[valid]
