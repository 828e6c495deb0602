"""What the persistent bf16 kernels that read their input rows by TMA share
on the host (B10: ``ops/aliked_stem.py``; B11 and B12:
``ops/score_head.py``): the prepared state of a parameter tree with its
cache of tensor maps, and the padded copy of an input that TMA cannot read
as it lies.

A tensor map (``CUtensorMap``, 128 bytes, encoded by the kernel's
``*_map`` entry point) holds an address and a shape, not the data: one
encoded for an earlier tensor at the same address and shape serves again,
so each tree keeps the last ``MAPS`` of them.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from .. import _build

MAPS = 8  # tensor maps kept per tree (the oldest goes first)


class Prepared16(NamedTuple):
    """A bf16 kernel's prepared state of one tree: its weights blob, and
    the tensor maps encoded for it (``tensor_map``)."""
    weights: torch.Tensor
    maps: Dict[Tuple[int, ...], torch.Tensor]


def tensor_map(prep: Prepared16, entry: str, x: torch.Tensor) -> torch.Tensor:
    """The tensor map of CUDA tensor x (B, C, H, Wp), as ``padded`` leaves
    it, encoded by the entry point ``entry`` (map, x, B, H, Wp), from
    ``prep``'s cache."""
    b, _, h, wp = x.shape
    key = (x.device.index, x.data_ptr(), b, h, wp)
    got = prep.maps.get(key)
    if got is None:
        got = torch.empty(128, dtype=torch.uint8)
        _build.launch(entry, x.device, got, x, b, h, wp)
        if len(prep.maps) >= MAPS:
            prep.maps.pop(next(iter(prep.maps)))
        prep.maps[key] = got
    return got


def padded(x: torch.Tensor) -> torch.Tensor:
    """x, or one copy zero-padded to a width of a multiple of 16 bytes,
    where TMA cannot read it as it lies: a row stride or an address that is
    not a multiple of 16 bytes."""
    w = x.shape[-1]
    align = 16 // x.element_size()
    wp = -(-w // align) * align
    if wp != w or x.data_ptr() % 16:
        x = torch.nn.functional.pad(x, (0, wp - w))
    return x
