"""Batched, bucketed serving on one device (counterpart of
lightglue_tpu/parallel/): ``batching`` pads and groups pairs, ``graphs``
replays one CUDA graph set per (bucket, batch, input signature)."""

from . import batching, graphs  # noqa: F401
