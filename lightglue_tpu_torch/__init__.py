"""lightglue_tpu_torch: SuperPoint, ALIKED, DISK, SIFT, DoGHardNet and the
LightGlue matcher in PyTorch with hand-written CUDA kernels for NVIDIA Hopper
(sm_90a).

The JAX package ``lightglue_tpu`` is the reference; this package imports
neither it nor JAX. Ops run their CUDA kernels on CUDA tensors (built from
``csrc/`` at first use, see ``_build.py``) and their plain PyTorch versions
on CPU tensors.
"""

from .configs import (
    FEATURES, ALIKEDConfig, DISKConfig, LightGlueConfig, PreprocessConfig,
    SIFTConfig, SuperPointConfig, lightglue_config)
from .pipeline import (
    ALIKED, DISK, SIFT, DoGHardNet, DoGHardNetDevice, LightGlue, SIFTDevice,
    SuperPoint, batch_to_device, compact_matches, map_tensor, match_pair,
    match_sequence, rbd)
from .parallel.batching import BatchMatcher

__all__ = [
    "ALIKED",
    "ALIKEDConfig",
    "BatchMatcher",
    "DISK",
    "DISKConfig",
    "DoGHardNet",
    "DoGHardNetDevice",
    "FEATURES",
    "LightGlue",
    "LightGlueConfig",
    "PreprocessConfig",
    "SIFT",
    "SIFTConfig",
    "SIFTDevice",
    "SuperPoint",
    "SuperPointConfig",
    "batch_to_device",
    "compact_matches",
    "lightglue_config",
    "map_tensor",
    "match_pair",
    "match_sequence",
    "rbd",
]
