"""int8 descriptor quantization for feature caches (counterpart of
lightglue_tpu/ops/quant.py).

Symmetric per-descriptor int8 codes with one fp32 scale a row: a cache of
unit descriptors 4x smaller, each value within scale / 2 (about 0.004) of
its own. Layout: codes int8 (..., D), scales fp32 (..., 1); dequant =
codes * scales. Rounding is half to even (``torch.round``, as
``jnp.round``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class QuantizedDescriptors(NamedTuple):
    codes: torch.Tensor   # int8 (..., D)
    scales: torch.Tensor  # fp32 (..., 1): dequant = codes * scales


def quantize_descriptors(desc: torch.Tensor) -> QuantizedDescriptors:
    """Symmetric per-row int8 quantization of (..., D) descriptors."""
    d32 = desc.float()
    amax = d32.abs().amax(-1, keepdim=True)
    scales = amax.clamp(min=1e-12) / 127.0
    codes = torch.round(d32 / scales).clamp(-127, 127).to(torch.int8)
    return QuantizedDescriptors(codes, scales)


def dequantize_descriptors(q: QuantizedDescriptors,
                           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.codes.float() * q.scales).to(dtype)
