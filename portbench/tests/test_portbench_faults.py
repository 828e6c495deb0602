"""A run with the timed path broken underneath comes out not correct.

Each test rehearses a whole run on the CPU (the look for a card skipped)
with one fault of ``portbench/faults.py`` planted in the program: a step
that returns its state unchanged, half of a batch's answers left out
(copied from its first pair, or lost), an answer altered where it is
produced (in every batch, or in one bucket's only), the adaptive stop
taken at the wrong layer, keypoints moved. No
cell runs across chips, so no exchange between chips can be left out.
"""

import pytest

import tiny
from portbench import faults, run

SEED = 2**31 + 21


def pairs_cell():
    """The serving path at a batch of 4 (8 pairs a request), fp32: the
    latency cell's entry and limits with batches that hold several pairs."""
    c = tiny.cell("sp-lg.latency-b1", pairs_per_request=8)
    c.cell = dict(c.cell, max_batch=4, judge_requests=None)
    return c


CELLS = {"pairs": pairs_cell, "latency": lambda: tiny.cell("sp-lg.latency-b1"),
         "images": lambda: tiny.cell("sp-lg.images-b8")}


def go(cell):
    return run.execute(cell, SEED, 5.0, False, "cpu")


@pytest.mark.parametrize("name", sorted(CELLS))
def test_sound_run_is_correct(name):
    line = go(CELLS[name]())
    assert line["correct"], (line["check"], line["failed"], line["attempted"])


@pytest.mark.parametrize("fault", ["unchanged", "half", "lost", "altered",
                                   "stop_first", "stop_never"])
@pytest.mark.parametrize("name", ["latency", "pairs"])
def test_matcher_fault_is_caught(monkeypatch, name, fault):
    faults.FAULTS[fault](monkeypatch)
    line = go(CELLS[name]())
    assert not line["correct"], line["check"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "lost", "moved"])
def test_images_fault_is_caught(monkeypatch, fault):
    faults.FAULTS[fault](monkeypatch)
    line = go(CELLS["images"]())
    assert not line["correct"], line["check"]


def test_fault_in_one_bucket_is_caught(monkeypatch):
    """Answers altered only in the batches of the smaller bucket, which a
    minority of the latency cell's requests fill: the largest over
    requests sees them, where a median over requests would not."""
    cell = tiny.cell("sp-lg.latency-b1", requests=12)
    cell.cell = dict(cell.cell, judge_requests=None)
    clean = go(cell)
    assert clean["correct"], clean["check"]
    faults.altered(monkeypatch, bucket=256)
    cell = tiny.cell("sp-lg.latency-b1", requests=12)
    cell.cell = dict(cell.cell, judge_requests=None)
    entry = cell.entry().Entry(cell, "cpu")
    entry.make_pool(SEED)
    small = sum(max(len(f0["keypoints"]), len(f1["keypoints"])) <= 256
                for (f0, f1), in entry.pool)
    assert 0 < small < len(entry.pool) / 2
    line = go(cell)
    assert not line["correct"], line["check"]
