"""Batched, bucketed and data-parallel serving (counterpart of
lightglue_tpu/parallel/): ``batching`` pads and groups pairs, ``graphs``
replays one CUDA graph set per (bucket, batch, input signature), ``mesh``
makes meshes of device slots that batches shard over."""

from . import batching, graphs, mesh  # noqa: F401
