"""Extract and match in one call on the device (counterpart of
lightglue_tpu/end_to_end.py).

Both images are extracted and matched without a host copy in between:
keypoints, descriptors and validity masks stay on the device, in the
preprocessed image's frame, and the matcher normalizes keypoints by the
true (unpadded) size of that image. The sequence forms extract each image
once and match its consecutive or windowed pairs in one batched matcher
call. They run eagerly.

With a ``mesh`` (``parallel/mesh.py``; the JAX programs run under ``with
mesh:`` on sharded inputs) each slot extracts its own block of the images
(contiguous, the larger blocks first where they do not divide) on its
device's copy of the parameters; the pairs are split over the slots the
same way, each pair's features copied to the slot that matches it (the
windowed pairing crosses block boundaries, where the JAX program inserts
its collectives), and the adaptive stop pools over every slot
(``models.lightglue.forward_slots``). The outputs come back in input
order on the first slot's device; ``run.launches`` holds each slot's
kernel launches.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from . import _build, nn
from .models import lightglue as lg
from .models.superpoint import Features
from .parallel import mesh as mesh_lib


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
    mesh: Optional[mesh_lib.Mesh] = None,
):
    """Build ``run(image0, image1, size0, size1) -> E2EOutput``.

    ``extractor_forward(params, conf, image, image_size) -> Features`` is
    any extractor's forward (``models.superpoint.forward``,
    ``models.aliked.forward``) with its parameters and config. Images:
    (B, H, W, C) float [0, 1] tensors on the parameters' device, padded to
    the extractor's stride; ``size0``, ``size1``: (B, 2) true (w, h)
    extents before padding. ``mesh``: each slot extracts and matches its
    block of the pairs (module docstring; default: one slot on the
    matcher parameters' device)."""
    slots = _MeshSlots(mesh, extractor_forward, extractor_params,
                       extractor_conf, matcher_params, matcher_conf)

    @torch.inference_mode()
    def run(image0, image1, size0, size1) -> E2EOutput:
        bounds = slots.bounds(image0.shape[0])
        f0 = slots.extract(image0, size0, bounds)
        f1 = slots.extract(image1, size1, bounds)
        return slots.match(f0, f1, slots.split(size0, bounds),
                           slots.split(size1, bounds))

    run.launches = slots.launches
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
    mesh: Optional[mesh_lib.Mesh] = None,
):
    """Extract-once / match-consecutive pipeline: ``run(images (B, H, W,
    C), sizes (B, 2)) -> E2EOutput`` for the B-1 consecutive pairs
    (i, i+1), each image extracted once (the hloc pattern: features
    extracted once per image, then matched across pairs):
    ``make_windowed_sequence_end_to_end`` at window 1."""
    return make_windowed_sequence_end_to_end(
        extractor_forward, extractor_params, extractor_conf, matcher_params,
        matcher_conf, window=1, mesh=mesh)


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
    mesh: Optional[mesh_lib.Mesh] = None,
):
    """Extract-once / match-windowed pipeline: ``run(images (B, H, W, C),
    sizes (B, 2)) -> E2EOutput`` matching every pair (i, i+w) for w =
    1..window in one batched matcher call, each image extracted once.
    Window 1 is ``make_sequence_end_to_end``. ``mesh``: each slot extracts
    its block of the images and matches its block of the pairs (module
    docstring; default: one slot on the matcher parameters' device)."""
    slots = _MeshSlots(mesh, extractor_forward, extractor_params,
                       extractor_conf, matcher_params, matcher_conf)

    @torch.inference_mode()
    def run(images, sizes) -> E2EOutput:
        n = images.shape[0]
        parts = slots.extract(images, sizes, slots.bounds(n))
        # every image's features on each device of the mesh
        f = {dev: mesh_lib.gather(parts, dev) for dev in slots.mesh.distinct}
        i0, i1 = sequence_window_pairs(n, window)
        pairs = slots.bounds(len(i0))
        take = [(dev, torch.from_numpy(i0[a:b]).to(dev, torch.long),
                 torch.from_numpy(i1[a:b]).to(dev, torch.long))
                for (a, b), dev in zip(pairs, slots.mesh.slots)]
        return slots.match(
            [_select(f[d], j0) for d, j0, _ in take],
            [_select(f[d], j1) for d, _, j1 in take],
            [sizes.to(d)[j0] for d, j0, _ in take],
            [sizes.to(d)[j1] for d, _, j1 in take])

    run.launches = slots.launches
    return run


class _MeshSlots:
    """The pipelines' slots: each distinct device's copy of both models'
    parameters, and each slot's launch counts. No mesh: one slot on the
    matcher parameters' device, which uses the parameters as they are."""

    def __init__(self, mesh, extractor_forward, extractor_params,
                 extractor_conf, matcher_params, matcher_conf):
        self.mesh = (mesh_lib.params_mesh(matcher_params) if mesh is None
                     else mesh)
        self.forward, self.conf = extractor_forward, extractor_conf
        self.matcher_conf = matcher_conf
        self.ex = mesh_lib.replicate(self.mesh, extractor_params)
        self.mt = mesh_lib.replicate(self.mesh, matcher_params)
        self.launches: List[dict] = [{} for _ in self.mesh.slots]

    def bounds(self, n: int):
        """Each slot's [start, stop) block of ``n`` rows (uneven allowed;
        a slot may get none)."""
        return mesh_lib.row_bounds(n, self.mesh.size, even=False)

    def split(self, x: torch.Tensor, bounds) -> list:
        """Each slot's rows of ``x`` on its device."""
        return [x[a:b].to(dev) for (a, b), dev in zip(bounds, self.mesh.slots)]

    def extract(self, images, sizes, bounds) -> List[Features]:
        """The extractor on each slot's block of ``images``, on its device,
        for the slots that have rows (``bounds`` puts empty blocks last)."""
        parts = []
        for k, ((a, b), dev) in enumerate(zip(bounds, self.mesh.slots)):
            if a < b:
                with _build.tally(self.launches[k]):
                    parts.append(self.forward(self.ex[dev], self.conf,
                                              images[a:b].to(dev),
                                              sizes[a:b].to(dev)))
        return parts

    def match(self, f0: List[Features], f1: List[Features], size0: list,
              size1: list) -> E2EOutput:
        """The matcher over the slots whose blocks hold pairs (block k of
        ``f0``, ``f1``, ``size0``, ``size1`` on slot k; empty blocks last),
        the stop pooled; the outputs gathered on the first slot's
        device."""
        used = [k for k, f in enumerate(f0) if f.keypoints.shape[0]]
        devs = [self.mesh.slots[k] for k in used]
        kws = [dict(kpts0=f0[k].keypoints, kpts1=f1[k].keypoints,
                    desc0=f0[k].descriptors, desc1=f1[k].descriptors,
                    size0=size0[k], size1=size1[k],
                    mask0=f0[k].valid, mask1=f1[k].valid,
                    **_scale_ori_kw(f0[k], f1[k])) for k in used]
        outs = lg.forward_slots([self.mt[d] for d in devs], self.matcher_conf,
                                kws, tallies=[self.launches[k] for k in used])
        home = self.mesh.slots[0]
        return E2EOutput(mesh_lib.gather([f0[k] for k in used], home),
                         mesh_lib.gather([f1[k] for k in used], home),
                         mesh_lib.gather(outs, home))
