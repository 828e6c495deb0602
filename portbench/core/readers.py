"""The arithmetic of the metrics, shared by the readers in ``metrics/``.

Each reader takes the finished ``Run`` and returns a number, or None when
the run has nothing for it to read (then the metric is left out of the
line). A share of a peak or of a roofline is never made up as 0.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from . import device


def pairs_per_s(run) -> float:
    """Pairs whose answers are on the host, over the whole window."""
    return sum(r.units for r in run.window.requests) / run.window.seconds


def latency_ms(run, q: float) -> float:
    """The q-th percentile of every request's time in the window, ms."""
    return float(np.percentile([(r.end - r.start) * 1e3
                                for r in run.window.requests], q))


def work(run, ks):
    """(FLOPs, bytes) of requests ``ks``: each request's own count where the
    check counted its pool entry, else the mean of the counted entries (a
    cell whose check runs on a sample of its pool); None if none was
    counted."""
    counts = [run.entry.work(k) for k in ks]
    known = [c for c in counts if c[0] is not None]
    if not known:
        return None
    mean = tuple(sum(c[i] for c in known) / len(known) for i in (0, 1))
    return tuple(sum(c[i] if c[0] is not None else mean[i] for c in counts)
                 for i in (0, 1))


def mfu(run) -> Optional[float]:
    """FLOPs the window's work needs over its seconds and the peak of the
    cell's precision, %."""
    w = work(run, [r.k for r in run.window.requests if r.units])
    if w is None:
        return None
    return 100.0 * w[0] / run.window.seconds / device.PEAK_FLOPS[
        run.precision]


def kernels_roofline(run) -> Optional[float]:
    """The least time the traced slice's work needs (FLOPs at the peak or
    bytes at HBM's rate, whichever is longer) over the time its kernels
    took, %."""
    if run.slice is None or run.slice.kernel_s <= 0:
        return None
    w = work(run, run.slice_requests)
    if w is None:
        return None
    least = max(w[0] / device.PEAK_FLOPS[run.precision],
                w[1] / device.PEAK_BYTES)
    return 100.0 * least / run.slice.kernel_s


def idle_pct(run) -> Optional[float]:
    """Share of the traced slice with no kernel, copy or set on the
    device, %."""
    if run.slice is None or run.slice.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.slice.busy_s / run.slice.window_s)
