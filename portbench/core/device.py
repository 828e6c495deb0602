"""The card: the check that one is there, what it is, and its peaks.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
limit): bf16 989 TFLOP/s; float32 cells are held to 165 TFLOP/s, the
3xTF32 rate (495 / 3), the fastest product the card gives at float32
accuracy, which the port's float32 kernels use; HBM 3.35 TB/s. A share of
a peak is stated beside the card's power limit.
"""

from __future__ import annotations

import subprocess
from typing import Dict

PEAK_FLOPS = {"bf16": 989e12, "fp32": 165e12}
PEAK_BYTES = 3.35e12


class NoCard(RuntimeError):
    """The run asked for more CUDA cards than the machine has."""


def require(chips: int) -> None:
    """Raise ``NoCard`` unless ``chips`` CUDA cards are visible."""
    import torch
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: this benchmark "
                     "measures the CUDA port and has no CPU fallback")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards, "
                     f"{torch.cuda.device_count()} are visible")


def power_limit() -> str:
    """The card's power limit as nvidia-smi reads it ("" if it cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        return ""
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else ""


def describe(chips: int) -> Dict:
    """The result line's ``device`` (peak memory added by the caller)."""
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "power_limit": power_limit()}
