"""The benchmark's own tests (``python -m pytest portbench/tests``).

Tests that need a CUDA card carry the ``card`` marker and ask for the
``card`` fixture, which skips them here, at run time, where there is none.
"""

import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips where there is none)")
    if os.environ.get("PYTEST_XDIST_WORKER"):
        # parallel workers each on all cores slow a request past a
        # rehearsal's window
        import torch
        torch.set_num_threads(2)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
