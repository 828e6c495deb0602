"""The traced slice: ``torch.profiler`` (CUPTI) over a few steady requests.

Each request, and the harness's spans inside it (``span``), are
``record_function`` annotations, so host spans and device intervals
(kernels, copies, sets) share the trace's clock. The trace is exported to
a file in ``TMPDIR``, read and deleted.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from typing import Callable, Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
PREFIX = "portbench."


def span(name: str):
    """A harness span: an annotation in a traced run, nothing otherwise."""
    import torch
    return torch.profiler.record_function(PREFIX + name)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _covered(merged, a: float, b: float) -> float:
    return sum(max(0.0, min(y, b) - max(x, a)) for x, y in merged)


def profile(serve: Callable[[int], tuple], first: int, count: int):
    """Serve requests first .. first + count - 1 under the profiler;
    returns their answers and the parsed ``Slice``."""
    import torch
    from torch.profiler import ProfilerActivity
    answers = []
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        for k in range(first, first + count):
            with span("request"):
                answers.append(serve(k))
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        with contextlib.suppress(OSError):
            os.remove(path)
    return answers, Slice(events)


class Slice:
    """What the trace of the slice says (times in seconds)."""

    def __init__(self, events: List[Dict]):
        dev, kern, host, ann = [], [], [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                dev.append((a, b, e["name"]))
                if cat == "kernel":
                    kern.append((a, b))
            elif cat == "user_annotation" and e["name"].startswith(PREFIX):
                ann.append((a, b, e["name"][len(PREFIX):]))
            elif cat in HOST_CATS:
                host.append((a, b, e["name"]))
        reqs = sorted((a, b) for a, b, n in ann if n == "request")
        if not reqs:
            raise RuntimeError("the trace holds no request span")
        self.t0, self.t1 = reqs[0][0], reqs[-1][1]
        self.requests = reqs
        clip = [(max(a, self.t0), min(b, self.t1)) for a, b, _ in dev
                if b > self.t0 and a < self.t1]
        self.merged = _union(clip)
        self.window_s = (self.t1 - self.t0) * 1e-6
        self.busy_s = sum(b - a for a, b in self.merged) * 1e-6
        self.kernel_s = sum(min(b, self.t1) - max(a, self.t0)
                            for a, b in kern
                            if b > self.t0 and a < self.t1) * 1e-6
        self.dev, self.host, self.ann = dev, host, ann

    def host_ms(self) -> float:
        """Mean over the slice's requests of the request's span less the
        device time inside it, ms."""
        return sum((b - a) - _covered(self.merged, a, b)
                   for a, b in self.requests) / len(self.requests) * 1e-3

    def breakdown(self, top: int = 10) -> Dict:
        """The device operations that took most time, and the longest idle
        gaps by the harness span and the host operation under way."""
        by_name: Dict[str, float] = {}
        for a, b, n in self.dev:
            if b > self.t0 and a < self.t1:
                by_name[n] = by_name.get(n, 0.0) + (min(b, self.t1)
                                                    - max(a, self.t0)) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        edges = [self.t0] + [x for ab in self.merged for x in ab] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:top]:
            mid = (a + b) / 2
            spans = [(y - x, n) for x, y, n in self.ann if x <= mid <= y
                     and n != "request"]
            ops_at = [(y - x, n) for x, y, n in self.host if x <= mid <= y]
            label = min(spans)[1] if spans else "request"
            label += "/" + (min(ops_at)[1] if ops_at else "python")
            out.append([label, (b - a) * 1e-6])
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": out}
