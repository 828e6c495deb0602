"""Matcher, SuperPoint, ALIKED and preprocessing configuration (counterpart
of lightglue_tpu/configs.py:16-162, 184-213).

The same frozen dataclasses with the same fields, so one set of keyword
arguments configures both packages. Options whose kernels the port does not
have yet are refused at construction with the ROADMAP entry that adds them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# The ROADMAP entries that hold each refused option
_ROADMAP_COMPACTION = "ROADMAP.md, Queue A (A.3, two-stage compaction)"
_ROADMAP_MP_HEAD128 = ("ROADMAP.md, Queue B.3 (head_dim 128 under mp: B1' "
                       "and the d-128 walk in bf16)")


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
    bf16 forms of B5, B6, K1, K2 and B4, at head_dim 64 only; the
    assignment head (B2) stays fp32.
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
        unported = {
            "compaction_bucket > 0 (two-stage compaction)":
                (self.compaction_bucket > 0, _ROADMAP_COMPACTION),
            f"mp=True at head_dim {self.head_dim} (the bf16 kernels take 64)":
                (self.mp and self.head_dim != 64, _ROADMAP_MP_HEAD128),
        }
        for what, (asked, where) in unported.items():
            if asked:
                raise NotImplementedError(
                    f"{what} is not ported to lightglue_tpu_torch yet; see "
                    f"{where}."
                )

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
    kernel B10 on the lazy path. ``fused_score_head`` runs the score head's
    upsampling and 3x3 tail through B11 on the lazy path and its tail
    through B12 on the dense path; otherwise both are plain PyTorch.
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
