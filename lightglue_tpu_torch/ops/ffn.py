"""FFN with residual, x + FFN(cat[x, msg]): kernel K3 and its plain version.

Counterpart of lightglue_tpu/ops/ffn.py::fused_ffn_residual (``_ffn_kernel``,
ffn.py:40-115): FFN = lin1 -> LayerNorm (eps 1e-5) -> exact erf GELU ->
lin2, with the concat algebraic (cat[x, m] W1 = x W1[:D] + m W1[D:]).
"""

from __future__ import annotations

import torch

from .. import _build, nn

DIMS = (128, 256)  # descriptor widths the kernel is built for


def fused_ffn_residual_plain(
    x: torch.Tensor, msg: torch.Tensor, p: nn.Params
) -> torch.Tensor:
    """x, msg (B, N, D); p {"lin1": {w (2D, 2D), b}, "ln": {scale, bias},
    "lin2": {w (2D, D), b}} (models/lightglue.py::_ffn_init layout)."""
    d = x.shape[-1]
    w1 = p["lin1"]["w"]
    s = x @ w1[:d] + msg @ w1[d:] + p["lin1"]["b"]
    mean = s.mean(-1, keepdim=True)
    c = s - mean
    var = (c * c).mean(-1, keepdim=True)
    hn = c * torch.rsqrt(var + 1e-5) * p["ln"]["scale"] + p["ln"]["bias"]
    return x + (nn.gelu(hn) @ p["lin2"]["w"] + p["lin2"]["b"])


def fused_ffn_residual(
    x: torch.Tensor, msg: torch.Tensor, p: nn.Params
) -> torch.Tensor:
    """K3 on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return fused_ffn_residual_plain(x, msg, p)
    d = x.shape[-1]
    w = dict(
        w1=p["lin1"]["w"], b1=p["lin1"]["b"], gamma=p["ln"]["scale"],
        beta=p["ln"]["bias"], w2=p["lin2"]["w"], b2=p["lin2"]["b"],
    )
    dev = _build.check_cuda(x=x, msg=msg, **w)
    if d not in DIMS:
        raise ValueError(f"fused_ffn_residual kernel takes D in {DIMS}, got {d}")
    if msg.shape != x.shape:
        raise ValueError(f"msg {tuple(msg.shape)} != x {tuple(x.shape)}")
    want = dict(w1=(2 * d, 2 * d), b1=(2 * d,), gamma=(2 * d,),
                beta=(2 * d,), w2=(2 * d, d), b2=(d,))
    for k, shape in want.items():
        if tuple(w[k].shape) != shape:
            raise ValueError(f"{k} must be {shape}, got {tuple(w[k].shape)}")
    rows = x.numel() // d
    out = torch.empty_like(x)
    _build.launch("lg_ffn_residual", dev, x, msg, w["w1"], w["b1"],
                  w["gamma"], w["beta"], w["w2"], w["b2"], out, rows, d)
    _build.count("fused_ffn_residual")
    return out
