"""HardNet descriptors of LAF patches at the DoG detections (DoGHardNet;
counterpart of lightglue_tpu/models/hardnet.py, reference dog_hardnet.py).

SIFT's keypoints (``models.sift_device`` on the device, OpenCV on the host
in ``pipeline.DoGHardNet``) are described by kornia's HardNet (Mishchuk et
al., NeurIPS 2017) on 32 x 32 patches sampled about each keypoint's local
affine frame: LAF = scale * R(ori), scale = 6 x OpenCV's size, as kornia's
``laf_from_center_scale_ori``. The CNN: per-patch standardization (the
unbiased std, as torch.std), six 3x3 conv + batch norm (no affine) + ReLU
stages (strides 1, 1, 2, 1, 2, 1, padding 1), an 8x8 VALID conv + batch
norm to 128, L2-normalized. NCHW, OIHW weights without bias; on the card
the convolutions run in full fp32 (``nn.fp32_convs``: cuDNN's TF32 would
move the descriptors by about 1e-3).

The patch sampler keeps the JAX package's arithmetic where it is cheap:
the sample grid is ``jnp.linspace(-1, 1, 32)`` as XLA computes it (the
step times the rounded reciprocal of 31, the last point exact), and the
bilinear sample clamps its position to the image, reading the edge pixel
for the far corner there. ``F.grid_sample`` weighs the corners in another
order and is not used.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import nn
from . import sift_device

# conv stages: (in, out, kernel, stride), each padded by 1 and followed by
# a batch norm and a ReLU
_STAGES = [
    (1, 32, 3, 1),
    (32, 32, 3, 1),
    (32, 64, 3, 2),
    (64, 64, 3, 1),
    (64, 128, 3, 2),
    (128, 128, 3, 1),
]
PATCH_SIZE = 32
DESC_DIM = 128
LAF_SCALE = 6.0  # LAF scale = 6 x OpenCV's size (reference dog_hardnet.py:35)
# conv0 .. conv6: (in, out, kernel, stride, padding, ReLU after its batch
# norm); conv6 is the 8x8 VALID conv to the descriptor (kornia features.19)
LAYERS = ([(ci, co, ks, st, 1, True) for ci, co, ks, st in _STAGES]
          + [(128, DESC_DIM, 8, 1, "VALID", False)])


def init_params(conf=None, generator: Optional[torch.Generator] = None) -> nn.Params:
    """Random HardNet weights (torch's Conv2d default, no bias) and
    identity batch norms, drawn from ``generator`` on the CPU; ``conf``
    (the extractor's SIFTConfig) is unused."""
    g = generator or torch.Generator().manual_seed(0)
    p = {}
    for i, (ci, co, ks, *_) in enumerate(LAYERS):
        p[f"conv{i}"] = nn.conv2d_init(ci, co, ks, g, bias=False)
        p[f"bn{i}"] = nn.batch_norm_init(co)
    return p


def _input_norm(patches: torch.Tensor) -> torch.Tensor:
    """Per-patch standardization over (C, H, W) with the unbiased std."""
    mean = patches.mean((1, 2, 3), keepdim=True)
    std = patches.std((1, 2, 3), keepdim=True)
    return (patches - mean) / (std + 1e-6)


def conv(p: nn.Params, i: int, x: torch.Tensor) -> torch.Tensor:
    """conv``i`` of x (its stride and padding from LAYERS)."""
    _, _, _, stride, padding, _ = LAYERS[i]
    return nn.conv2d(p[f"conv{i}"], x, stride=stride, padding=padding)


def norm(p: nn.Params, i: int, x: torch.Tensor) -> torch.Tensor:
    """bn``i`` of conv``i``'s output, and its ReLU where LAYERS has one."""
    x = nn.batch_norm(p[f"bn{i}"], x)
    return torch.relu(x) if LAYERS[i][5] else x


def describe_patches(p: nn.Params, patches: torch.Tensor) -> torch.Tensor:
    """patches (N, 1, 32, 32) -> (N, 128) L2-normalized descriptors."""
    x = _input_norm(patches.float())
    with nn.fp32_convs():
        for i in range(len(LAYERS)):
            x = norm(p, i, conv(p, i, x))
    return nn.l2_normalize(x.flatten(1), -1)


def sample_grid(patch_size: int = PATCH_SIZE, device=None) -> torch.Tensor:
    """``jnp.linspace(-1, 1, patch_size)`` as XLA computes it: s = i times
    the fp32 reciprocal of (n - 1), then -(1 - s) + s; the last point 1."""
    i = torch.arange(patch_size - 1, dtype=torch.float32, device=device)
    s = i * torch.tensor(1.0 / (patch_size - 1), dtype=torch.float32)
    return torch.cat([s - (1 - s), torch.ones(1, device=device)])


def extract_laf_patches_batch(
    images: torch.Tensor,
    centers: torch.Tensor,
    scales: torch.Tensor,
    oris: torch.Tensor,
    patch_size: int = PATCH_SIZE,
) -> torch.Tensor:
    """Bilinear patches about local affine frames. images (B, H, W) grey;
    centers (B, K, 2) pixel (x, y); scales (B, K) the LAF scale; oris
    (B, K) radians. A patch's sample (u, v) on the grid of [-1, 1]^2 lies
    at c + (scale / 2) R(ori) (u, v), clamped to [0, W - 1] x [0, H - 1];
    rows are v (y), columns u (x). Returns (B, K, 1, ps, ps)."""
    b, h, w = images.shape
    ps = patch_size
    lin = sample_grid(ps, images.device)
    u, v = lin.repeat(ps), lin.repeat_interleave(ps)  # (ps * ps,) x, y
    cos, sin = torch.cos(oris)[..., None], torch.sin(oris)[..., None]
    half = (scales / 2.0)[..., None]
    px = centers[..., 0:1] + half * (u * cos - v * sin)
    py = centers[..., 1:2] + half * (u * sin + v * cos)
    fx, fy = px.clamp(0.0, w - 1.0), py.clamp(0.0, h - 1.0)
    x0, y0 = torch.floor(fx), torch.floor(fy)
    wx, wy = fx - x0, fy - y0
    x0i, y0i = x0.long(), y0.long()
    # the far corner at the last row / column is the edge pixel again
    x1i, y1i = (x0i + 1).clamp(max=w - 1), (y0i + 1).clamp(max=h - 1)
    flat = images.reshape(b, h * w)

    def at(yi, xi):
        return torch.gather(flat, 1, (yi * w + xi).reshape(b, -1)).reshape(yi.shape)

    vals = ((at(y0i, x0i) * (1 - wx) + at(y0i, x1i) * wx) * (1 - wy)
            + (at(y1i, x0i) * (1 - wx) + at(y1i, x1i) * wx) * wy)
    return vals.reshape(b, -1, 1, ps, ps)


def extract_laf_patches(image, centers, scales, oris,
                        patch_size: int = PATCH_SIZE) -> torch.Tensor:
    """``extract_laf_patches_batch`` of one (H, W) image: (K, 1, ps, ps)."""
    return extract_laf_patches_batch(image[None], centers[None], scales[None],
                                     oris[None], patch_size)[0]


@torch.inference_mode()
def forward(params: nn.Params, conf, images: torch.Tensor, sizes=None):
    """DoGHardNet on the device: ``sift_device``'s detections (``conf`` a
    SIFTConfig), then HardNet on their LAF patches. images: (B, H, W) or
    (B, H, W, C) in [0, 1] (RGB by the reference's grey weights); ``sizes``
    is unused. Returns Features with scales and oris; the descriptors of
    invalid slots are 0."""
    from .superpoint import Features

    gray = sift_device.to_gray(images)
    det = sift_device.extract_batch(gray, conf)
    patches = extract_laf_patches_batch(gray, det["keypoints"],
                                        LAF_SCALE * det["scales"], det["oris"])
    b, k = patches.shape[:2]
    desc = describe_patches(params, patches.flatten(0, 1)).reshape(b, k, -1)
    desc = torch.where(det["valid"][..., None], desc, torch.zeros_like(desc))
    return Features(
        keypoints=det["keypoints"],
        keypoint_scores=det["keypoint_scores"],
        descriptors=desc,
        valid=det["valid"],
        scales=det["scales"],
        oris=det["oris"],
    )
