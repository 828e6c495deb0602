"""Matcher, extractor and preprocessing configuration (counterpart of
lightglue_tpu/configs.py:16-240).

The same frozen dataclasses with the same fields, so one set of keyword
arguments configures both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class LightGlueConfig:
    """Matcher configuration (reference: lightglue/lightglue.py:322-335).

    ``depth_confidence``/``width_confidence`` < 0 disable adaptive depth /
    width. ``flash`` takes head_dim (descriptor_dim / num_heads) 64 or 128.
    ``fused_self``/``fused_cross`` (the JAX package's defaults, on) run each
    SelfBlock through the whole-block kernel B5 for N <= 2048 and each
    CrossBlock through B6 for max(M, N) <= 1024 at head_dim 64 (lengths
    multiples of 128); otherwise, or with them off, the blocks are composed
    from the attention (K1), cross-attention (K2 at head_dim 64, B1' at 128)
    and FFN (K3) kernels. ``self_softmax_shift`` / ``cross_softmax_shift``
    (nats) replace the softmax's row maximum by a constant in the kernels
    (exp2 form, no max pass); None is the exact softmax. B1' is always
    exact, as the JAX matcher calls it, so ``cross_softmax_shift`` has no
    effect at head_dim 128. ``mp`` computes the transformer in bf16 (the
    descriptors cast after they are read, as the JAX matcher does) on the
    bf16 forms of B5, B6, K1, K2 and B4 at head_dim 64, and of B5, K1 and
    B1' at 128; the assignment head (B2) stays fp32.
    ``compaction_bucket`` > 0 (with ``width_confidence`` > 0 and both
    images above the bucket) runs ``compaction_prefix`` layers at full
    size, then the survivors of each image, most matchable first, in a
    bucket of that many points (``models.lightglue.forward_adaptive_twostage``).
    """

    name: str = "lightglue"
    input_dim: int = 256
    descriptor_dim: int = 256
    add_scale_ori: bool = False
    n_layers: int = 9
    num_heads: int = 4
    flash: bool = True  # attention/assignment kernels (False: composed ops)
    mp: bool = False
    depth_confidence: float = 0.95
    width_confidence: float = 0.99
    filter_threshold: float = 0.1
    weights: Optional[str] = None
    pruning_min_kpts: int = 512
    compaction_bucket: int = 0
    compaction_prefix: int = 3
    cross_softmax_shift: Optional[float] = None
    self_softmax_shift: Optional[float] = None
    fused_ffn: bool = True  # FFN kernel (False: composed FFN)
    fused_self: bool = True
    fused_cross: bool = True

    def __post_init__(self):
        if self.descriptor_dim % self.num_heads != 0:
            raise ValueError(
                f"descriptor_dim {self.descriptor_dim} must be divisible by "
                f"num_heads {self.num_heads}"
            )
        if self.n_layers < 1:
            raise ValueError("n_layers must be >= 1")

    @property
    def head_dim(self) -> int:
        return self.descriptor_dim // self.num_heads

    def replace(self, **kw) -> "LightGlueConfig":
        return dataclasses.replace(self, **kw)


# Per-feature presets (reference: lightglue/lightglue.py:351-374).
FEATURES = {
    "superpoint": dict(weights="superpoint_lightglue", input_dim=256),
    "disk": dict(weights="disk_lightglue", input_dim=128),
    "aliked": dict(weights="aliked_lightglue", input_dim=128),
    "sift": dict(weights="sift_lightglue", input_dim=128, add_scale_ori=True),
    "doghardnet": dict(
        weights="doghardnet_lightglue", input_dim=128, add_scale_ori=True
    ),
}


def lightglue_config(
    features: Optional[str] = "superpoint", **conf
) -> LightGlueConfig:
    """A LightGlueConfig with a feature preset overlaid (lightglue.py:376-386)."""
    if features is not None:
        if features not in FEATURES:
            raise ValueError(
                f"Unsupported features: {features} not in {{{','.join(FEATURES)}}}"
            )
        conf = {**FEATURES[features], **conf}
    return LightGlueConfig(**conf)


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    """Image preprocessing (reference: lightglue/utils.py:12-24)."""

    resize: Optional[int] = None  # target edge length; None = no resize
    side: str = "long"  # which edge `resize` refers to
    interpolation: str = "bilinear"
    antialias: bool = True
    grayscale: bool = False

    def replace(self, **kw) -> "PreprocessConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class SuperPointConfig:
    """SuperPoint (reference: lightglue/superpoint.py:107-117).

    ``max_num_keypoints=None`` keeps every point above the threshold, as the
    reference does: the pipeline derives a static capacity from the image
    area and the NMS spacing (``pipeline._auto_kpts_bucket``).
    ``approx_topk > 0`` and ``twolevel_topk`` select keypoints faster on a
    TPU; the port always selects exactly and says so once
    (``ops.sampling.top_k_keypoints``). ``fused_stem`` switches between the
    conv1/conv2 kernels (B7, B8) and the plain cuDNN conv chain. ``mp`` runs
    the convolutions in bf16 (B7 and B8 in their bf16 forms); scores and
    descriptors stay fp32.
    """

    descriptor_dim: int = 256
    nms_radius: int = 4
    max_num_keypoints: Optional[int] = 2048
    detection_threshold: float = 0.0005
    remove_borders: int = 4
    resize: int = 1024
    mp: bool = False
    approx_topk: float = 0.0
    twolevel_topk: bool = False
    fused_stem: bool = True

    def replace(self, **kw) -> "SuperPointConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ALIKEDConfig:
    """ALIKED (reference: lightglue/aliked.py:631-644).

    ``max_num_keypoints``, ``approx_topk`` and ``twolevel_topk`` as in
    ``SuperPointConfig``. ``lazy_fm`` evaluates the descriptor head's
    feature-map rows from the four branch maps instead of building the
    full-resolution concat (``False``: the dense dataflow of the
    reference). ``fused_stem`` runs block 1 and its two consumers through
    kernel B10 on the lazy path where block 1 has 16 channels (not at
    aliked-t16, as in the JAX package). ``fused_score_head`` runs the
    score head's upsampling and 3x3 tail through B11 on the lazy path and
    its tail through B12 on the dense path; otherwise both are plain
    PyTorch.
    ``mp`` runs the encoder and the aggregation in bf16 (B10, B11 and B12 in
    their bf16 forms); scores and descriptors stay fp32.
    """

    model_name: str = "aliked-n16"
    max_num_keypoints: Optional[int] = 2048
    detection_threshold: float = 0.2
    nms_radius: int = 2
    resize: int = 1024
    approx_topk: float = 0.0
    twolevel_topk: bool = False
    mp: bool = False
    fused_score_head: bool = False
    lazy_fm: bool = True
    fused_stem: bool = True

    def replace(self, **kw) -> "ALIKEDConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class DISKConfig:
    """DISK (reference: lightglue/disk.py:8-20).

    ``max_num_keypoints``, ``approx_topk`` and ``twolevel_topk`` as in
    ``SuperPointConfig``. ``mp`` runs the U-Net in bf16; the heatmap, the
    top-k and the descriptors' norm stay fp32.
    """

    weights: str = "depth"
    max_num_keypoints: Optional[int] = 2048
    desc_dim: int = 128
    nms_window_size: int = 5
    detection_threshold: float = 0.0
    pad_if_not_divisible: bool = True
    resize: int = 1024
    approx_topk: float = 0.0
    twolevel_topk: bool = False
    mp: bool = False

    @property
    def nms_radius(self) -> int:
        """The suppression radius of the window max (a window of 2 r + 1)."""
        return self.nms_window_size // 2

    def replace(self, **kw) -> "DISKConfig":
        return dataclasses.replace(self, **kw)


SIFT_BACKENDS = ("opencv", "device", "pycolmap", "pycolmap_cpu", "pycolmap_cuda")


@dataclasses.dataclass(frozen=True)
class SIFTConfig:
    """SIFT (reference: lightglue/sift.py:80-93).

    ``backend``: "opencv" (the host's cv2.SIFT, as the reference),
    "device" (the DoG scale space on the wrapper's device,
    ``models.sift_device``) or "pycolmap*" (needs pycolmap, which is not
    installed). ``num_scales_per_octave`` defaults to 4: the reference passes
    its ``num_octaves`` to OpenCV's nOctaveLayers (sift.py:132), so both
    backends build the same pyramid. DoGHardNet takes the same config: its
    detections are SIFT's, and ``pipeline.SIFT``'s describe hook
    (``_describe``) replaces the SIFT descriptors by HardNet's, without
    RootSIFT (``rootsift`` is then unused).
    """

    rootsift: bool = True
    nms_radius: int = 0
    max_num_keypoints: int = 4096
    backend: str = "opencv"
    detection_threshold: float = 0.0066667
    edge_threshold: float = 10.0
    first_octave: int = -1
    num_octaves: int = 4
    num_scales_per_octave: int = 4
    resize: int = 1024

    def __post_init__(self):
        if self.backend == "jax":
            raise ValueError(
                "SIFT backend 'jax' is the JAX package's name; the port's own "
                "DoG scale space is backend='device'")
        if self.backend not in SIFT_BACKENDS:
            raise ValueError(f"Unknown SIFT backend: {self.backend!r} not in "
                             f"{SIFT_BACKENDS}")

    def replace(self, **kw) -> "SIFTConfig":
        return dataclasses.replace(self, **kw)
