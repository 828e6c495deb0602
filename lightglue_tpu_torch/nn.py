"""Layer functions over nested parameter dicts (counterpart of
lightglue_tpu/nn.py:40-189, 297-371).

Linear weights keep the JAX package's layout, ``(in, out)``, so a layer is
``x @ w + b``, and the matcher's transformer layers are stacked along a
leading axis. Convolutions are PyTorch's own: NCHW activations and OIHW
weights (the JAX package's are NHWC and HWIO; ``weights.py`` transposes
once at load).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F

Params = dict


def linear_init(
    in_dim: int, out_dim: int, generator: torch.Generator, bias: bool = True
) -> Params:
    """U(-1/sqrt(in), 1/sqrt(in)) weights and bias, torch's Linear default."""
    bound = 1.0 / math.sqrt(in_dim)

    def uniform(*shape):
        return (torch.rand(*shape, generator=generator) * 2 - 1) * bound

    p = {"w": uniform(in_dim, out_dim)}
    if bias:
        p["b"] = uniform(out_dim)
    return p


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x @ w + b in x's type (w and b cast to it, as lightglue_tpu/nn.py:
    53-57: a bf16 x gives a bf16 output)."""
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def layer_norm_init(dim: int) -> Params:
    return {"scale": torch.ones(dim), "bias": torch.zeros(dim)}


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """fp32 LayerNorm over the last axis (biased variance, as jnp.var)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The exact erf GELU (torch nn.GELU default)."""
    return F.gelu(x, approximate="none")


def conv2d_init(
    in_ch: int, out_ch: int, kernel: int, generator: torch.Generator,
    bias: bool = True,
) -> Params:
    """OIHW weight and bias, U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the JAX
    package's conv2d_init (torch's Conv2d default)."""
    bound = 1.0 / math.sqrt(in_ch * kernel * kernel)

    def uniform(*shape):
        return (torch.rand(*shape, generator=generator) * 2 - 1) * bound

    p = {"w": uniform(out_ch, in_ch, kernel, kernel)}
    if bias:
        p["b"] = uniform(out_ch)
    return p


def batch_norm_init(dim: int) -> Params:
    return {"scale": torch.ones(dim), "bias": torch.zeros(dim),
            "mean": torch.zeros(dim), "var": torch.ones(dim)}


def fold_batch_norm(p: Params, eps: float = 1e-5):
    """Inference batch norm as one fp32 (scale, bias) pair per channel:
    scale = gamma * rsqrt(var + eps), bias = beta - mean * scale."""
    scale = p["scale"].float() * torch.rsqrt(p["var"].float() + eps)
    return scale, p["bias"].float() - p["mean"].float() * scale


def batch_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Inference batch norm (running statistics) over NCHW channels, in x's
    type (a bf16 x takes its scale and bias in bf16, as lightglue_tpu/nn.py:
    341-348)."""
    scale, bias = fold_batch_norm(p, eps)
    return (x * scale.to(x.dtype)[:, None, None]
            + bias.to(x.dtype)[:, None, None])


_SELU_ALPHA = 1.6732632423543772848170429916717
_SELU_SCALE = 1.0507009873554804934193349852946


def selu(x: torch.Tensor) -> torch.Tensor:
    """SELU; a bf16 x as jax.nn.selu computes it in bf16: its constants
    rounded to bf16 (JAX's weak-typed scalars take the array's type), each
    op rounded (expm1, times alpha, times scale), where F.selu rounds once."""
    if x.dtype != torch.bfloat16:
        return F.selu(x)
    alpha, scale = (float(torch.tensor(c).bfloat16())
                    for c in (_SELU_ALPHA, _SELU_SCALE))
    neg = alpha * torch.expm1(torch.where(x > 0, 0.0, x))
    return scale * torch.where(x > 0, x, neg)


def avg_pool(x: torch.Tensor, window: int) -> torch.Tensor:
    """NCHW average pooling, stride = window, VALID. A bf16 x sums its
    window in bf16 in row-major order, then divides, as the JAX package's
    reduce_window in bf16 (lightglue_tpu/models/aliked.py:152-155)."""
    if x.dtype != torch.bfloat16:
        return F.avg_pool2d(x, window, window)
    h, w = x.shape[-2] // window * window, x.shape[-1] // window * window
    s = None
    for dy in range(window):
        for dx in range(window):
            v = x[..., dy:h:window, dx:w:window]
            s = v if s is None else s + v
    return s / (window * window)


@contextlib.contextmanager
def fp32_convs():
    """cuDNN convolutions in full fp32 inside the block. cuDNN defaults to
    TF32 for fp32 convs, which moves SuperPoint's scores by ~1e-3 and
    changes which keypoints NMS and top-k select. (``cudnn.flags()`` is not
    used: its defaults switch cuDNN off altogether.)"""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (nearest even), as float32."""
    return x.to(torch.bfloat16).float()


def conv2d(p: Params, x: torch.Tensor, stride: int = 1,
           padding="SAME") -> torch.Tensor:
    """Convolution, NCHW with an OIHW weight, in x's type (lightglue_tpu/
    nn.py:97-124). ``padding``: "SAME" (stride 1, odd kernels: k // 2 on
    every side), "VALID" (none) or an int on every side. A bf16 x (mp)
    convolves with the weight in bf16 and fp32 sums, rounds to bf16, then
    adds the bias in bf16, as XLA does: cuDNN's bf16 convolution on the
    card; on the CPU an fp32 convolution of the bf16 operands, rounded
    (PyTorch's CPU bf16 convolution is slow)."""
    if padding == "SAME":
        if stride != 1:
            raise ValueError("padding 'SAME' is stride 1 only; pass an int")
        padding = p["w"].shape[-1] // 2
    elif padding == "VALID":
        padding = 0
    kw = dict(stride=stride, padding=padding)
    if x.dtype == torch.float32:
        return F.conv2d(x, p["w"], p.get("b"), **kw)
    w = p["w"].to(x.dtype)
    if x.is_cuda:
        y = F.conv2d(x, w, **kw)
    else:
        y = F.conv2d(x.float(), w.float(), **kw).to(x.dtype)
    return y + p["b"].to(x.dtype)[:, None, None] if "b" in p else y


def conv2d_tapmat(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME conv with an odd OIHW kernel (few output channels) as
    XLA runs the JAX package's ``conv2d_tapmat`` (lightglue_tpu/nn.py:
    158-189): every tap's product over the input channels at once (fp32
    sums of x's type's operands), each tap's partial rounded to x's type,
    the k*k shifted partials summed in fp32 in tap order and rounded to x's
    type, then the bias added in x's type. In fp32 the roundings are
    no-ops."""
    w = p["w"]
    cout, cin, k = w.shape[0], w.shape[1], w.shape[-1]
    _, _, h, wd = x.shape
    r = k // 2
    # every tap's partial at once, channels-last: [ci][tap][co] columns
    wt = w.to(x.dtype).float().permute(1, 2, 3, 0).reshape(cin, k * k * cout)
    u = (x.float().permute(0, 2, 3, 1) @ wt).to(x.dtype).float()
    u = F.pad(u, (0, 0, r, r, r, r))
    acc = None
    for t in range(k * k):
        dy, dx = divmod(t, k)
        ut = u[:, dy:dy + h, dx:dx + wd, t * cout:(t + 1) * cout]
        acc = ut if acc is None else acc + ut
    y = acc.permute(0, 3, 1, 2).to(x.dtype)
    return y + p["b"].to(x.dtype)[:, None, None] if "b" in p else y


def prelu(alpha: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """PReLU over NCHW channels in x's type: x where x >= 0, else
    alpha * x (alpha cast to x's type, lightglue_tpu/models/disk.py:41-43)."""
    return torch.where(x >= 0, x, alpha.to(x.dtype)[:, None, None] * x)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False) over NCHW: each (image, channel) plane
    normalized with fp32 statistics (biased variance), rounded once to x's
    type (lightglue_tpu/nn.py:324-329)."""
    xf = x.float()
    mean = xf.mean((2, 3), keepdim=True)
    var = (xf - mean).square().mean((2, 3), keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _upsample2_axis(x: torch.Tensor, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    a, b = x.narrow(dim, 0, n - 1), x.narrow(dim, 1, n - 1)  # x[i], x[i + 1]
    if x.dtype == torch.float32:
        # output 2i + 2 = 0.25 x[i] + 0.75 x[i + 1] rounded once (a fused
        # multiply-add after the exact quarter product); 2i + 1 = 0.75 x[i]
        # rounded, then plus 0.25 x[i + 1]
        even = (0.25 * a.double() + 0.75 * b.double()).float()
        odd = 0.75 * a + 0.25 * b
    else:  # both sums exact in fp32, rounded once to x's type
        af, bf = a.float(), b.float()
        even = (0.25 * af + 0.75 * bf).to(x.dtype)
        odd = (0.75 * af + 0.25 * bf).to(x.dtype)
    even = torch.cat([x.narrow(dim, 0, 1), even], dim)
    odd = torch.cat([odd, x.narrow(dim, n - 1, 1)], dim)
    return torch.stack([even, odd], dim + 1).flatten(dim, dim + 1)


def upsample2(x: torch.Tensor) -> torch.Tensor:
    """x2 bilinear upsampling of the last two axes (H, W) with
    align_corners=False, as ``jax.image.resize(..., "bilinear")`` computes
    it with XLA on the CPU: one product with a two-tap weight matrix an
    axis, W first, then H; the edge rows repeated (JAX renormalizes its
    triangle there, which gives the edge pixel, as torch's clamp does).
    XLA's dot sums a row's taps in index order with fused multiply-adds,
    which ``_upsample2_axis`` reproduces (equal to the bit at SIFT's single
    plane; at small multi-channel maps XLA's second product rounds its
    first tap, about one output in eight an ulp apart). bf16 inputs: each
    axis's fp32 lerp rounded to bf16, equal to the bit. An fp32 x on CUDA
    takes ``F.interpolate``'s bilinear x2 (the same taps, one launch; an
    ulp or so from the fused sums)."""
    if x.is_cuda and x.dtype == torch.float32:
        return upsample2_interp(x)
    return _upsample2_axis(_upsample2_axis(x, x.dim() - 1), x.dim() - 2)


def upsample2_interp(x: torch.Tensor) -> torch.Tensor:
    """``upsample2`` of an fp32 x through ``F.interpolate`` (bilinear,
    align_corners=False, its edge source index clamped to the edge)."""
    h, w = x.shape[-2:]
    y = F.interpolate(x.reshape(-1, 1, h, w), scale_factor=2.0,
                      mode="bilinear", align_corners=False)
    return y.reshape(*x.shape[:-2], 2 * h, 2 * w)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in x's type: a bf16 x takes w in bf16, the fp32 product of the
    bf16 operands rounded once (as XLA's bf16 dot with fp32 sums; cuBLAS's
    bf16 product may reduce in bf16)."""
    if x.dtype == torch.float32:
        return x @ w
    return (x.float() @ w.to(x.dtype).float()).to(x.dtype)


def max_pool(x: torch.Tensor, window: int) -> torch.Tensor:
    """NCHW max pooling, stride = window, VALID."""
    return F.max_pool2d(x, window, window)


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps), torch F.normalize(p=2); in fp32 for a bf16 x,
    rounded once at the end (lightglue_tpu/nn.py:356-359)."""
    xf = x.float()
    n = torch.linalg.vector_norm(xf, dim=dim, keepdim=True)
    return (xf / torch.clamp(n, min=eps)).to(x.dtype)


def stack_params(params_list) -> Params:
    """Stack identically structured trees along a new leading axis."""
    first = params_list[0]
    if isinstance(first, dict):
        return {k: stack_params([p[k] for p in params_list]) for k in first}
    return torch.stack(params_list, 0)


def index_params(p: Params, i: int) -> Params:
    """Layer ``i`` of stacked params."""
    return map_params(p, lambda x: x[i])


def map_params(p: Params, fn) -> Params:
    """Apply ``fn`` to every tensor of a nested parameter dict."""
    if isinstance(p, dict):
        return {k: map_params(v, fn) for k, v in p.items()}
    return fn(p)


def params_to(p: Params, device: Optional[torch.device] = None) -> Params:
    """Every tensor as float32 on ``device``."""
    return map_params(p, lambda x: x.to(device=device, dtype=torch.float32))
