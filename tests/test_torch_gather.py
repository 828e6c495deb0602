"""Row gather of lightglue_tpu_torch (S1, ops/gather.py) against the
function the two Pallas kernels of scripts/micro_gather2.py compute.

Those kernels live inside that script's ``main()`` and cannot be imported
without running it on a TPU; both compute ``jnp.take(tbl, idx, axis=0)``,
so the plain version is held against that, bit for bit (a gather does no
arithmetic), at bf16 and fp32, on tables of the study's width and ragged
ones. The CUDA kernel itself runs only on the card (chip_smoke.py).
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightglue_tpu_torch.ops import gather
from lightglue_tpu_torch.scripts import micro_gather2

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("rows,cols,n", [(96, 256, 1000), (100, 3, 7),
                                         (5, 130, 1), (7, 2, 0)])
def test_gather_rows_plain_vs_take(dtype, rows, cols, n):
    rng = np.random.default_rng(61)
    tbl = rng.standard_normal((rows, cols)).astype(np.float32)
    idx = rng.integers(0, rows, (n,)).astype(np.int32)
    want = jnp.take(jnp.asarray(tbl).astype(dtype), jnp.asarray(idx), axis=0)
    got = gather.gather_rows(
        torch.from_numpy(tbl).to(getattr(torch, dtype)), torch.from_numpy(idx))
    assert got.dtype == getattr(torch, dtype) and got.shape == (n, cols)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_one_hot_gather_equals_the_row_gather():
    """The study's one-hot product form computes the same rows exactly."""
    rng = np.random.default_rng(62)
    tbl = torch.from_numpy(rng.standard_normal((40, 256)).astype(
        np.float32)).to(torch.bfloat16)
    idx = torch.from_numpy(rng.integers(0, 40, (70,)).astype(np.int32))
    assert torch.equal(micro_gather2.one_hot_gather(tbl, idx, blk=16),
                       gather.gather_rows_plain(tbl, idx))


def test_study_inputs_follow_the_jax_study():
    tbl, idx = micro_gather2.make_inputs(0, device="cpu")
    assert tbl.shape == (12288, 256) and tbl.dtype == torch.bfloat16
    assert idx.shape == (110592,) and idx.dtype == torch.int32
    assert 0 <= int(idx.min()) and int(idx.max()) < 12288
    again = micro_gather2.make_inputs(0, device="cpu")
    assert torch.equal(tbl, again[0]) and torch.equal(idx, again[1])


def test_word_size_is_the_widest_that_divides():
    assert gather._word_bytes(512, 256, 1024) == 16
    assert gather._word_bytes(12, 256, 1024) == 4
    assert gather._word_bytes(6, 256, 1024) == 2
    with pytest.raises(ValueError):
        gather._word_bytes(3, 256)


def test_gather_rows_refuses_what_the_kernel_does_not_take():
    """A tensor on neither the CPU nor a GPU is refused, not computed."""
    meta = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        gather.gather_rows(meta, torch.zeros(2, dtype=torch.int32,
                                             device="meta"))


def test_study_script_needs_a_card():
    """Without CUDA the study exits non-zero before printing a time."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run(
        [sys.executable, "-m", "lightglue_tpu_torch.scripts.micro_gather2",
         "--reps", "1"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "ms per call" not in res.stdout
