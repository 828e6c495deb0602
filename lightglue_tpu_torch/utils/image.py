"""Image preprocessing in PyTorch (counterpart of
lightglue_tpu/utils/image.py:50-147; reference lightglue/utils.py:12-38,
72-128).

Images are (H, W, C) float32 tensors in [0, 1], channel-last as in the JAX
package, on any device; numpy arrays are taken too. Resizing needs neither
OpenCV nor PIL:
  * "area" is what cv2 INTER_AREA computes when it shrinks: each output
    pixel averages the input pixels under it, weighted by their fractional
    overlap, as two small matrix products (rows, then columns).
    ``F.interpolate(mode="area")`` is adaptive average pooling instead and
    differs from cv2 at non-integer factors.
  * "linear" and "cubic" are ``F.interpolate`` bilinear / bicubic with
    ``align_corners=False`` (cv2's half-pixel centres, a = -0.75), "nearest"
    is its "nearest" (cv2's floor rule).
Only ``read_image`` and ``load_image`` need a decoder: they import cv2, or
else PIL, when called. Nothing on the extraction path reads files.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..configs import PreprocessConfig

ImageLike = Union[np.ndarray, torch.Tensor]


def read_image(path: Union[str, Path], grayscale: bool = False) -> np.ndarray:
    """Read an image as RGB (H, W, 3) or grayscale (H, W) uint8
    (reference utils.py:72-82), with cv2 or else PIL."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"No image at path {path}.")
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        mode = cv2.IMREAD_GRAYSCALE if grayscale else cv2.IMREAD_COLOR
        image = cv2.imread(str(path), mode)
        if image is None:
            raise IOError(f"Could not read image at {path}.")
        if not grayscale:
            image = image[..., ::-1]
        return np.ascontiguousarray(image)
    try:
        from PIL import Image
    except ImportError:
        raise ImportError("read_image needs OpenCV (cv2) or PIL to decode "
                          "image files") from None
    with Image.open(path) as img:
        return np.asarray(img.convert("L" if grayscale else "RGB"))


def numpy_image_to_array(image: ImageLike) -> torch.Tensor:
    """uint8 HWC/HW -> float32 HWC in [0, 1] (reference utils.py:85-93,
    channel-last)."""
    image = torch.as_tensor(image)
    if image.dim() == 2:
        image = image[..., None]
    elif image.dim() != 3:
        raise ValueError(f"Not an image: {tuple(image.shape)}")
    return (image.double() / 255.0).float()


def _area_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_out, n_in) weights: output pixel j averages the input interval
    [j s, (j + 1) s), s = n_in / n_out, each input pixel weighted by its
    overlap with it."""
    s = n_in / n_out
    j = torch.arange(n_out, dtype=torch.float64)[:, None]
    i = torch.arange(n_in, dtype=torch.float64)[None, :]
    lo = torch.maximum(i, j * s)
    hi = torch.minimum(i + 1, (j + 1) * s)
    return (torch.clamp(hi - lo, min=0) / s).float().to(device)


def resize_image(
    image: ImageLike,
    size: Union[int, Tuple[int, int]],
    fn: str = "max",
    interp: str = "area",
) -> Tuple[torch.Tensor, Tuple[float, float]]:
    """Resize (H, W, C) to a fixed (h, w) or by its max/min edge; returns
    (image, (sx, sy)) (reference utils.py:96-121)."""
    image = torch.as_tensor(image)
    squeeze = image.dim() == 2
    if squeeze:
        image = image[..., None]
    h, w = image.shape[:2]
    agg = {"max": max, "min": min}[fn]
    if isinstance(size, int):
        scale = size / agg(h, w)
        h_new, w_new = int(round(h * scale)), int(round(w * scale))
    else:
        h_new, w_new = size
    x = image.float()
    if interp == "area":
        ah = _area_matrix(h, h_new, x.device)
        aw = _area_matrix(w, w_new, x.device)
        out = torch.einsum("ih,hwc->iwc", ah, x)
        out = torch.einsum("jw,iwc->ijc", aw, out)
    else:
        mode = {"linear": "bilinear", "cubic": "bicubic",
                "nearest": "nearest"}[interp]
        kw = {} if mode == "nearest" else {"align_corners": False}
        out = F.interpolate(x.permute(2, 0, 1)[None], size=(h_new, w_new),
                            mode=mode, **kw)[0].permute(1, 2, 0)
    out = out.contiguous()
    return (out[..., 0] if squeeze else out), (w_new / w, h_new / h)


def load_image(
    path: Union[str, Path], resize: Optional[int] = None, **kwargs
) -> torch.Tensor:
    """Read, optionally resize, and scale to [0, 1] (reference
    utils.py:124-128). Returns float32 (H, W, 3)."""
    image = numpy_image_to_array(read_image(path))
    if resize is not None:
        image, _ = resize_image(image, resize, **kwargs)
    return image


def pad_to_multiple(
    image: torch.Tensor, multiple: int
) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Replicate-pad (..., H, W, C) at the bottom and right to a multiple of
    ``multiple``. Returns (padded, (orig_h, orig_w))."""
    h, w = image.shape[-3:-1]
    ph, pw = (-h) % multiple, (-w) % multiple
    if ph or pw:
        rows = torch.clamp(torch.arange(h + ph, device=image.device), max=h - 1)
        cols = torch.clamp(torch.arange(w + pw, device=image.device), max=w - 1)
        image = image[..., rows, :, :][..., cols, :]
    return image, (h, w)


class ImagePreprocessor:
    """Resize with scale bookkeeping, as the reference does (utils.py:
    12-38)."""

    def __init__(self, conf: PreprocessConfig = PreprocessConfig(), **overrides):
        if overrides:
            conf = conf.replace(**overrides)
        self.conf = conf

    def __call__(self, image: torch.Tensor) -> Tuple[torch.Tensor, np.ndarray]:
        h, w = image.shape[:2]
        if self.conf.resize is not None:
            fn = "max" if self.conf.side == "long" else "min"
            interp = {
                "bilinear": "linear", "linear": "linear",
                "bicubic": "cubic", "cubic": "cubic",
                "nearest": "nearest", "area": "area",
            }[self.conf.interpolation]
            # antialias as kornia does it: an averaging filter only when
            # shrinking (reference utils.py:26-38)
            agg = max if fn == "max" else min
            downscale = self.conf.resize < agg(h, w)
            if self.conf.antialias and downscale and interp == "linear":
                interp = "area"
            image, _ = resize_image(image, self.conf.resize, fn=fn, interp=interp)
        scale = np.array([image.shape[1] / w, image.shape[0] / h], np.float32)
        return image, scale
