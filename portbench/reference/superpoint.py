"""SuperPoint in plain PyTorch: the benchmark's reference extractor.

Written from the published model (cvg/LightGlue ``lightglue/superpoint.py``):
the VGG encoder (conv, ReLU, 2x2 max pools), the detector head's 65-way
softmax without its dustbin and its 8x8 pixel shuffle, ``simple_nms`` (two
rounds of max-pool suppression), the border band set to -1 (measured from
the image's true extent), the keypoints the ``max_num_keypoints`` highest
scores (ties to the lower flat index, a static top-k whose slots above
``detection_threshold`` are valid, as the program's static-shape output),
and descriptors sampled bilinearly from the L2-normalised descriptor map
(``sample_descriptors``) and normalised again. Convolutions through
``Precision`` (float32, TF32 off, for the reference). It imports nothing
of the program.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .precision import Precision


def simple_nms(scores: torch.Tensor, r: int) -> torch.Tensor:
    """The published two-round suppression over (B, H, W)."""
    def pool(x):
        return F.max_pool2d(x, 2 * r + 1, stride=1, padding=r)

    s = scores[:, None]
    zeros = torch.zeros_like(s)
    max_mask = s == pool(s)
    for _ in range(2):
        supp = pool(max_mask.float()) > 0
        supp_scores = torch.where(supp, zeros, s)
        new_max = supp_scores == pool(supp_scores)
        max_mask = max_mask | (new_max & ~supp)
    return torch.where(max_mask, s, zeros)[:, 0]


def top_k(scores: torch.Tensor, k: int):
    """The k highest of each (H, W) map, ties to the lower flat index:
    (keypoints (B, k, 2) as (x, y), scores (B, k))."""
    b, h, w = scores.shape
    vals, idx = torch.sort(scores.reshape(b, -1), dim=1, descending=True,
                           stable=True)
    idx = idx[:, :k]
    return torch.stack([idx % w, idx // w], -1).float(), vals[:, :k]


def bilinear(fmap: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """grid_sample (bilinear, align_corners=True, zeros) of (B, C, h, w) at
    normalised (x, y) points (B, K, 2) -> (B, K, C)."""
    return F.grid_sample(fmap, pts[:, None], mode="bilinear",
                         align_corners=True)[:, :, 0].transpose(1, 2)


class SuperPoint:
    def __init__(self, params: Dict, conf: Dict, prec: Precision):
        self.p, self.conf, self.prec = params, conf, prec

    def conv(self, name, x, relu=True):
        w = self.p[name]["w"]
        y = F.conv2d(self.prec(x), self.prec(w), self.p[name]["b"],
                     padding=w.shape[-1] // 2)
        return torch.relu(y) if relu else y

    def dense(self, image: torch.Tensor):
        """(B, 1, H, W) in [0, 1] -> (score map (B, H, W), L2-normalised
        descriptor map (B, D, H/8, W/8))."""
        x = self.conv("conv1b", self.conv("conv1a", image))
        x = F.max_pool2d(x, 2)
        x = F.max_pool2d(self.conv("conv2b", self.conv("conv2a", x)), 2)
        x = F.max_pool2d(self.conv("conv3b", self.conv("conv3a", x)), 2)
        x = self.conv("conv4b", self.conv("conv4a", x))
        logits = self.conv("convPb", self.conv("convPa", x), relu=False)
        scores = torch.softmax(logits, 1)[:, :-1]
        b, _, h, w = scores.shape
        scores = scores.permute(0, 2, 3, 1).reshape(b, h, w, 8, 8)
        scores = scores.permute(0, 1, 3, 2, 4).reshape(b, h * 8, w * 8)
        desc = self.conv("convDb", self.conv("convDa", x), relu=False)
        return scores, F.normalize(desc, p=2, dim=1)

    def detection_map(self, scores: torch.Tensor, size: torch.Tensor):
        """NMS, then the border band of ``remove_borders`` at -1 (measured
        from the true (w, h) ``size``)."""
        scores = simple_nms(scores, self.conf["nms_radius"])
        pad = self.conf["remove_borders"]
        _, h, w = scores.shape
        ys = torch.arange(h, device=scores.device)[None, :, None]
        xs = torch.arange(w, device=scores.device)[None, None, :]
        tw, th = size[:, 0, None, None], size[:, 1, None, None]
        border = (ys < pad) | (ys >= th - pad) | (xs < pad) | (xs >= tw - pad)
        return torch.where(border, -1.0, scores)

    @staticmethod
    def sample(desc: torch.Tensor, kpts: torch.Tensor, s: int = 8):
        """Descriptors at full-resolution keypoints (published
        ``sample_descriptors``), L2-normalised."""
        _, _, h, w = desc.shape
        kp = kpts - s / 2 + 0.5
        kp = kp / torch.tensor([w * s - s / 2 - 0.5, h * s - s / 2 - 0.5],
                               device=kpts.device)
        return F.normalize(bilinear(desc, kp * 2 - 1), p=2, dim=-1)

    def __call__(self, image: torch.Tensor, size: torch.Tensor) -> Dict:
        """(B, 1, H, W) images -> keypoints, keypoint_scores, descriptors,
        valid (static k), and the dense maps the judge reads: the score
        map, the map of peaks that selection reads (``peak_map``: after
        NMS, the border at -1) and the score a peak needs (``cut``)."""
        with self.prec.math():
            scores, desc = self.dense(image)
            det = self.detection_map(scores, size)
            kpts, kscores = top_k(det, self.conf["max_num_keypoints"])
            valid = kscores > self.conf["detection_threshold"]
            descs = self.sample(desc, kpts)
        # the score a peak needs to be selected: the k-th peak's, or the
        # threshold where fewer peaks clear it
        cut = kscores[:, -1].clamp(min=self.conf["detection_threshold"])
        return {"keypoints": kpts, "keypoint_scores": kscores,
                "descriptors": descs, "valid": valid, "desc_map": desc,
                "score_map": scores, "peak_map": det, "cut": cut}

    def describe(self, out: Dict, kpts: torch.Tensor) -> torch.Tensor:
        """The reference's descriptors at other keypoints (B, K, 2)."""
        with self.prec.math():
            return self.sample(out["desc_map"], kpts)

    @staticmethod
    def score_at(out: Dict, kpts: torch.Tensor) -> torch.Tensor:
        """The reference's score map at other (integer) keypoints (B, K)."""
        sm = out["score_map"]
        b, h, w = sm.shape
        x = kpts[..., 0].long().clamp(0, w - 1)
        y = kpts[..., 1].long().clamp(0, h - 1)
        return sm.reshape(b, -1).gather(1, y * w + x)
