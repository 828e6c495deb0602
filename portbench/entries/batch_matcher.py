"""Serving pre-extracted features: ``BatchMatcher.match_pairs``.

A request is a list of feature pairs (numpy, as the hloc pattern holds
them); it ends when every pair's matches are back on the host. The cell
file gives ``precision`` (``bf16``: the matcher's mp path; ``fp32``),
``adaptive`` (the configuration's confidences, or the matcher fixed) and
``max_batch``. The system under test is the port's ``BatchMatcher``; the
control (``system="tf32"`` / ``"fp8"``) is the plain reference in its
place, computed in that precision, through the same batches.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..judge import matcher as judge
from ..reference.lightglue import Matcher, load_npz
from ..reference.precision import Precision
from ..work import lightglue as work
from ..core.layout import ROOT

BUCKETS = (256, 512, 768, 1024, 1280, 1536, 2048, 4096)


def matcher_conf(config: Dict, cell: Dict) -> Dict:
    """The matcher's settings as the cell runs them."""
    conf = dict(config["matcher"])
    if not cell.get("adaptive", True):
        conf["depth_confidence"] = conf["width_confidence"] = -1.0
    return conf


def _prune_tie(out: Dict, n: int) -> float:
    """The smallest margin (logits) by which the reference's pruning test
    pruned or kept any point of the first ``n`` pairs of a batch."""
    t = [m[:n][m[:n] > 0] for m in out["pruned"]]
    t += [m[:n][torch.isfinite(m[:n])] for m in out["kept"]]
    t = torch.cat(t)
    return float(t.min()) if len(t) else float("inf")


class ReferenceServer:
    """The plain reference in the program's place (the control): the same
    batches, each run by ``reference.lightglue.Matcher`` in ``prec``."""

    def __init__(self, params, conf: Dict, max_batch: int, prec: str,
                 device):
        self.m = Matcher(params, conf, Precision(prec))
        self.max_batch, self.device = max_batch, device

    @torch.no_grad()
    def match_pairs(self, pairs) -> List[Dict]:
        results = [None] * len(pairs)
        with self.m.prec.math():
            for bucket, chunk, sel in judge.chunks(pairs, BUCKETS,
                                                   self.max_batch):
                out = self.m(**judge.padded(sel, bucket, self.device))
                for j, i in enumerate(chunk):
                    n0 = len(pairs[i][0]["keypoints"])
                    results[i] = {
                        "matches0": out["matches0"][j, :n0].cpu().numpy(),
                        "matching_scores0":
                            out["matching_scores0"][j, :n0].cpu().numpy(),
                        "stop": out["stop"]}
        return results


class Entry:
    """One cell's system, pool and checks."""

    def __init__(self, cell, device, system: str = "program"):
        self.cell, self.device, self.system = cell, torch.device(device), system
        self.conf = matcher_conf(cell.config, cell.cell)
        self.max_batch = cell.cell["max_batch"]
        self.tie = cell.cell.get("tie_logits", 0.0)
        self.weights = ROOT / cell.config["matcher"]["weights"]

    # --- set-up ----------------------------------------------------------
    def build(self, seed: int) -> None:
        """The system under test on the device, its weights read from the
        configuration's npz (the seed draws none; built once)."""
        if hasattr(self, "server"):
            return
        params = load_npz(str(self.weights), self.device)
        if self.system != "program":
            self.server = ReferenceServer(params, self.conf, self.max_batch,
                                          self.system, self.device)
            return
        from lightglue_tpu_torch.configs import lightglue_config
        from lightglue_tpu_torch.parallel.batching import BatchMatcher
        keys = ("input_dim", "descriptor_dim", "n_layers", "num_heads",
                "depth_confidence", "width_confidence", "filter_threshold",
                "pruning_min_kpts")
        conf = lightglue_config(self.cell.config["matcher"]["features"],
                                mp=self.cell.cell["precision"] == "bf16",
                                **{k: self.conf[k] for k in keys})
        self.server = BatchMatcher(conf, params, BUCKETS, self.max_batch,
                                   device=self.device)

    def make_pool(self, seed: int) -> None:
        self.pool = self.cell.generator().make(self.cell.traffic, seed,
                                               self.device)

    def warm(self) -> None:
        """Every signature the pool uses, once (its graphs captured)."""
        for req in self.pool:
            self.server.match_pairs(req)

    def record_spans(self, on: bool) -> None:
        """The harness has no span inside ``match_pairs`` to record."""

    def finish(self) -> None:
        """Read how the system batched each pool entry (``padded_batches``,
        the program's own; the control's are the published rules)."""
        self.batches = {}
        for p, req in enumerate(self.pool):
            if self.system == "program":
                self.batches[p] = [
                    (chunk, len(f0["keypoints"]), f0["keypoints"].shape[1])
                    for chunk, f0, _ in self.server.padded_batches(req)]
            else:
                self.batches[p] = [(chunk, len(sel), bucket) for bucket, chunk,
                                   sel in judge.chunks(req, BUCKETS,
                                                       self.max_batch)]

    def release(self) -> None:
        """Free the system under test before the reference runs."""
        del self.server

    # --- the timed request ----------------------------------------------
    def serve(self, k: int):
        """Request k of the window (the pool cycled): the results and the
        pairs completed."""
        req = self.pool[k % len(self.pool)]
        res = self.server.match_pairs(req)
        ok = len(res) == len(req) and all(
            r is not None and len(r["matches0"]) == len(p[0]["keypoints"])
            for r, p in zip(res, req))
        return res, len(req) if ok else 0

    # --- after the window -------------------------------------------------
    @torch.no_grad()
    def judge(self, kept: Dict[int, list]) -> Dict[str, float]:
        """Run the reference (fp32, TF32 off) over the pool entries whose
        answers were kept (pool index -> the program's results), judge
        them request by request (``judge.judge_ties``, the cell's
        ``tie_logits``; ``judge.run_numbers``; each request's
        numbers kept in ``self.detail``, with its stop, its last bucket and
        the reference's nearest pruning tie, ``_prune_tie``), and count
        each entry's work from the reference's run."""
        params = load_npz(str(self.weights), self.device)
        ref = Matcher(params, self.conf, Precision("fp32"))
        numbers, self.detail = {}, {}
        self.flops, self.bytes = {}, {}
        with ref.prec.math():
            for p, results in sorted(kept.items()):
                pairs = self.pool[p]
                flops = nbytes = stop_gap = 0.0
                tie = float("inf")
                gaps = []
                for chunk, batch, bucket in self.batches[p]:
                    # the batch as the system ran it, its dummy rows copies
                    # of its first pair
                    sel = [pairs[i] for i in chunk]
                    sel += [sel[0]] * (batch - len(sel))
                    stops = {results[i]["stop"] for i in chunk}
                    stop = stops.pop() if len(stops) == 1 else -1
                    if not 1 <= stop <= self.conf["n_layers"]:
                        return judge.run_numbers([])
                    batch = judge.padded(sel, bucket, self.device)
                    out = ref(**batch, layers=stop, tie=self.tie)
                    n0s = [len(pairs[i][0]["keypoints"]) for i in chunk]
                    n1s = [len(pairs[i][1]["keypoints"]) for i in chunk]
                    g, sg = judge.judge_ties(
                        lambda flips: ref(**batch, layers=stop, flips=flips),
                        out, [results[i] for i in chunk], n0s, n1s, stop,
                        self.conf["filter_threshold"])
                    gaps += g
                    stop_gap = max(stop_gap, sg)
                    tie = min(tie, _prune_tie(out, len(chunk)))
                    act = out["active"][:len(chunk)].cpu().numpy()
                    for j in range(len(chunk)):
                        flops += work.flops(self.conf, act[j])
                        nbytes += work.io_bytes(self.conf, n0s[j], n1s[j])
                    nbytes += work.weight_bytes(self.conf, stop)
                    del out
                numbers[p] = judge.request_numbers(gaps, stop_gap)
                self.detail[p] = dict(numbers[p], stop=stop, bucket=bucket,
                                      prune_tie=tie)
                self.flops[p], self.bytes[p] = flops, nbytes
        return judge.run_numbers(list(numbers.values()))

    def work(self, k: int):
        """(FLOPs, bytes) that request k needs (after ``judge``)."""
        p = k % len(self.pool)
        return self.flops.get(p), self.bytes.get(p)
