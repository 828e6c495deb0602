"""Extract and match in one call on the device (counterpart of
lightglue_tpu/end_to_end.py).

Both images are extracted and matched without a host copy in between:
keypoints, descriptors and validity masks stay on the device, in the
preprocessed image's frame, and the matcher normalizes keypoints by the
true (unpadded) size of that image. The sequence forms extract each image
once and match its consecutive or windowed pairs in one batched matcher
call. They run eagerly.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from . import nn
from .models import lightglue as lg
from .models.superpoint import Features


class E2EOutput(NamedTuple):
    feats0: Features
    feats1: Features
    matches: lg.MatchOutput


def make_end_to_end(
    extractor_forward: Callable,
    extractor_params: nn.Params,
    extractor_conf,
    matcher_params: nn.Params,
    matcher_conf,
):
    """Build ``run(image0, image1, size0, size1) -> E2EOutput``.

    ``extractor_forward(params, conf, image, image_size) -> Features`` is
    any extractor's forward (``models.superpoint.forward``,
    ``models.aliked.forward``) with its parameters and config. Images:
    (B, H, W, C) float [0, 1] tensors on the parameters' device, padded to
    the extractor's stride; ``size0``, ``size1``: (B, 2) true (w, h)
    extents before padding."""

    @torch.inference_mode()
    def run(image0, image1, size0, size1) -> E2EOutput:
        f0 = extractor_forward(extractor_params, extractor_conf, image0, size0)
        f1 = extractor_forward(extractor_params, extractor_conf, image1, size1)
        out = lg.forward(
            matcher_params, matcher_conf,
            kpts0=f0.keypoints, kpts1=f1.keypoints,
            desc0=f0.descriptors, desc1=f1.descriptors,
            size0=size0, size1=size1,
            mask0=f0.valid, mask1=f1.valid,
            **_scale_ori_kw(f0, f1),
        )
        return E2EOutput(f0, f1, out)

    return run


def _scale_ori_kw(f0, f1) -> dict:
    """scales/oris matcher kwargs for SIFT-family features (consumed when
    matcher_conf.add_scale_ori; reference lightglue.py:495-501); the port's
    extractors give none."""
    if getattr(f0, "scales", None) is None:
        return {}
    return dict(
        scales0=f0.scales, oris0=f0.oris, scales1=f1.scales, oris1=f1.oris
    )


def _select(f, idx):
    """Features of the images at ``idx`` (a slice or an index tensor)."""
    return type(f)(*(None if a is None else a[idx] for a in f))


def make_sequence_end_to_end(
    extractor_forward: Callable,
    extractor_params: nn.Params,
    extractor_conf,
    matcher_params: nn.Params,
    matcher_conf,
):
    """Extract-once / match-consecutive pipeline: ``run(images (B, H, W,
    C), sizes (B, 2)) -> E2EOutput`` for the B-1 consecutive pairs
    (i, i+1), each image extracted once (the hloc pattern: features
    extracted once per image, then matched across pairs)."""

    @torch.inference_mode()
    def run(images, sizes) -> E2EOutput:
        f = extractor_forward(extractor_params, extractor_conf, images, sizes)
        sl0, sl1 = _select(f, slice(None, -1)), _select(f, slice(1, None))
        out = lg.forward(
            matcher_params, matcher_conf,
            kpts0=sl0.keypoints, kpts1=sl1.keypoints,
            desc0=sl0.descriptors, desc1=sl1.descriptors,
            size0=sizes[:-1], size1=sizes[1:],
            mask0=sl0.valid, mask1=sl1.valid,
            **_scale_ori_kw(sl0, sl1),
        )
        return E2EOutput(sl0, sl1, out)

    return run


def sequence_window_pairs(n_images: int, window: int):
    """Static pair index arrays (i0, i1) for windowed sequential matching:
    every (i, i+w) with 1 <= w <= window — the hloc ``pairs_from_sequential``
    overlap pattern. Returns two int arrays of length
    ``window*n - window*(window+1)/2``."""
    i0, i1 = [], []
    for w in range(1, window + 1):
        i0.extend(range(n_images - w))
        i1.extend(range(w, n_images))
    return np.asarray(i0, np.int32), np.asarray(i1, np.int32)


def make_windowed_sequence_end_to_end(
    extractor_forward: Callable,
    extractor_params: nn.Params,
    extractor_conf,
    matcher_params: nn.Params,
    matcher_conf,
    window: int = 4,
):
    """Extract-once / match-windowed pipeline: ``run(images (B, H, W, C),
    sizes (B, 2)) -> E2EOutput`` matching every pair (i, i+w) for w =
    1..window in one batched matcher call, each image extracted once.
    Window 1 is ``make_sequence_end_to_end``."""

    @torch.inference_mode()
    def run(images, sizes) -> E2EOutput:
        f = extractor_forward(extractor_params, extractor_conf, images, sizes)
        i0, i1 = (torch.from_numpy(i).to(images.device, torch.long)
                  for i in sequence_window_pairs(images.shape[0], window))
        sl0, sl1 = _select(f, i0), _select(f, i1)
        out = lg.forward(
            matcher_params, matcher_conf,
            kpts0=sl0.keypoints, kpts1=sl1.keypoints,
            desc0=sl0.descriptors, desc1=sl1.descriptors,
            size0=sizes[i0], size1=sizes[i1],
            mask0=sl0.valid, mask1=sl1.valid,
            **_scale_ori_kw(sl0, sl1),
        )
        return E2EOutput(sl0, sl1, out)

    return run
