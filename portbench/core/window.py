"""The measured window: one client in closed loop.

Request k is sent when request k - 1 has completed; each is timed on the
host clock from the call to its answers on the host. The window runs for
``seconds``; the request under way at the close completes and counts (its
time too). One answer of each pool entry is kept for the check, the
occurrence drawn from the seed (reservoir sampling).
"""

from __future__ import annotations

import sys
import time
from typing import Callable, Dict, List, NamedTuple

import numpy as np


class Request(NamedTuple):
    k: int
    start: float  # perf_counter seconds
    end: float
    units: int  # pairs completed (0: failed)


class Window(NamedTuple):
    requests: List[Request]
    seconds: float  # first start to last end
    kept: Dict[int, object]  # pool index -> one of its answers
    failed: int


def run(serve: Callable[[int], tuple], pool: int, seconds: float,
        seed: int, span: Callable = None) -> Window:
    """Serve requests 0, 1, ... until ``seconds`` have passed.
    ``serve(k) -> (answer, units)``; ``span(k)`` a context manager around
    each request (the traced run's annotation), or None."""
    rng = np.random.default_rng(seed)
    seen = [0] * pool
    kept: Dict[int, object] = {}
    reqs: List[Request] = []
    failed = 0
    t0 = time.perf_counter()
    k = 0
    while True:
        a = time.perf_counter()
        try:
            if span is None:
                answer, units = serve(k)
            else:
                with span(k):
                    answer, units = serve(k)
        except Exception as e:  # a failed request counts; the run goes on
            print(f"request {k} failed: {type(e).__name__}: {e}",
                  file=sys.stderr, flush=True)
            answer, units = None, 0
        b = time.perf_counter()
        reqs.append(Request(k, a, b, units))
        if units == 0:
            failed += 1
        else:
            p = k % pool
            seen[p] += 1
            if rng.integers(seen[p]) == 0:
                kept[p] = answer
        k += 1
        if b - t0 >= seconds:
            break
    return Window(reqs, reqs[-1].end - reqs[0].start, kept, failed)
