"""Extract and match in one call on the device (counterpart of
lightglue_tpu/end_to_end.py:31-76).

Both images are extracted and matched without a host copy in between:
keypoints, descriptors and validity masks stay on the device, in the
preprocessed image's frame, and the matcher normalizes keypoints by the
true (unpadded) size of that image.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

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
        )
        return E2EOutput(f0, f1, out)

    return run
