"""The arithmetic the plain references compute in.

``fp32`` is the reference: float32 with TF32 off in cuBLAS and cuDNN.
The two lower precisions are the controls that the correctness check is
shown to fail on (PERF.md, "How correct is decided"):

- ``tf32``: the same code with TF32 allowed in cuBLAS and cuDNN, the step
  below a float32 cell (float32 with TF32 off);
- ``fp8``: every operand of every product (matrix products, convolutions,
  attention) rounded to float8 e4m3 before an fp32 product, the step below
  a bf16 cell.
"""

from __future__ import annotations

import contextlib

import torch

NAMES = ("fp32", "tf32", "fp8")


class Precision:
    """Rounds the operands of the references' products."""

    def __init__(self, name: str = "fp32"):
        if name not in NAMES:
            raise ValueError(f"precision {name!r} not in {NAMES}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as a product reads it (float32)."""
        x = x.float()
        if self.name == "fp8":
            return x.to(torch.float8_e4m3fn).float()
        return x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self(a) @ self(b)

    @contextlib.contextmanager
    def math(self):
        """TF32 switched on for ``tf32`` and off otherwise, restored after."""
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        on = self.name == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old
