"""Images to matches: ``end_to_end.make_end_to_end`` over an extractor.

A request is a call of ``pairs_per_request`` image pairs handed over as
uint8 host arrays; it uploads and converts them, extracts both images of
every pair and matches each pair on the device, and ends when the matches
and keypoints are on the host. The configuration names the extractor
(``superpoint``, the one in ``EXTRACTORS``) and the matcher; the cell file
gives the ``precision`` (``bf16``: the extractor's and the matcher's mp
paths; ``fp32``). The matcher runs fixed (every layer; its confidences are
not trained for these features). The extractor's weights are drawn from
the seed on the card (``core/weights.py``); the matcher's are read from
the configuration's npz. The control (``system="tf32"`` / ``"fp8"``) is
the plain reference pipeline in the program's place.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch

from ..core import trace, weights
from ..core.layout import ROOT
from ..judge import extractor as xjudge
from ..judge import matcher as mjudge
from ..reference.lightglue import Matcher, load_npz
from ..reference.precision import Precision
from ..reference.superpoint import SuperPoint
from ..work import lightglue as lg_work
from ..work import superpoint as sp_work

# extractor name -> (its weight leaves, its plain reference, its work count)
EXTRACTORS = {"superpoint": (weights.superpoint_leaves, SuperPoint,
                             sp_work)}


def _images(u8: np.ndarray, device) -> torch.Tensor:
    """uint8 (B, H, W, C) host images as float (B, H, W, C) in [0, 1] on
    the device."""
    return torch.from_numpy(u8).to(device).float().div_(255.0)


class ReferencePipeline:
    """The plain reference extractor and matcher in ``prec`` (the control),
    answering as the program's runner does."""

    def __init__(self, ext, mparams, mconf, prec: str):
        self.ext, self.prec = ext, Precision(prec)
        self.m = Matcher(mparams, mconf, self.prec)

    @torch.no_grad()
    def __call__(self, img0, img1, size0, size1):
        f0 = self.ext(img0.permute(0, 3, 1, 2), size0)
        f1 = self.ext(img1.permute(0, 3, 1, 2), size1)
        with self.prec.math():
            out = self.m(f0["keypoints"], f1["keypoints"], f0["descriptors"],
                         f1["descriptors"], f0["valid"], f1["valid"], size0,
                         size1)
        return {"feats0": f0, "feats1": f1, "matches0": out["matches0"],
                "matching_scores0": out["matching_scores0"]}


class Entry:
    """One cell's system, pool and checks."""

    def __init__(self, cell, device, system: str = "program"):
        self.cell, self.device, self.system = cell, torch.device(device), system
        self.xconf = dict(cell.config["extractor"])
        self.mconf = dict(cell.config["matcher"], depth_confidence=-1.0,
                          width_confidence=-1.0)
        self.leaves, self.Ref, self.xwork = EXTRACTORS[self.xconf["name"]]
        self.mp = cell.cell["precision"] == "bf16"
        self.events, self.timing = [], False
        self.built_for = None

    # --- set-up ----------------------------------------------------------
    def params(self, seed: int):
        """(extractor tree, matcher tree): the extractor drawn from
        ``seed``, the matcher read from the configuration's npz."""
        xp = weights.tree(self.leaves(self.xconf), seed, self.device)
        mp = load_npz(str(ROOT / self.mconf["weights"]), self.device)
        return xp, mp

    def build(self, seed: int) -> None:
        if self.built_for == seed:
            return
        self.built_for = seed
        xp, mp = self.params(seed)
        if self.system != "program":
            self.runner = ReferencePipeline(
                self.Ref(xp, self.xconf, Precision(self.system)), mp,
                self.mconf, self.system)
            return
        from lightglue_tpu_torch.configs import (SuperPointConfig,
                                                 lightglue_config)
        from lightglue_tpu_torch.end_to_end import make_end_to_end
        from lightglue_tpu_torch.models import superpoint
        x = self.xconf
        fwd = superpoint.forward
        xc = SuperPointConfig(
            descriptor_dim=x["descriptor_dim"], nms_radius=x["nms_radius"],
            max_num_keypoints=x["max_num_keypoints"],
            detection_threshold=x["detection_threshold"],
            remove_borders=x["remove_borders"], mp=self.mp)
        keys = ("input_dim", "descriptor_dim", "n_layers", "num_heads",
                "depth_confidence", "width_confidence", "filter_threshold")
        mc = lightglue_config(self.mconf["features"], mp=self.mp,
                              **{k: self.mconf[k] for k in keys})

        def timed_forward(params, conf, image, image_size):
            """The extractor's forward between two CUDA events (a span of
            the benchmark's own, read by ``extract_ms_per_image``)."""
            if not self.timing:
                return fwd(params, conf, image, image_size)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fwd(params, conf, image, image_size)
            b.record()
            self.events.append((a, b, image.shape[0]))
            return out

        self.runner = make_end_to_end(timed_forward, xp, xc, mp, mc)

    def make_pool(self, seed: int) -> None:
        self.build(seed)
        self.pool = self.cell.generator().make(self.cell.traffic, seed,
                                               self.device)

    def warm(self) -> None:
        """The pool's one shape, once (kernels built, cuDNN's plans
        chosen), and every request once more."""
        for k in range(len(self.pool)):
            self.serve(k)

    def record_spans(self, on: bool) -> None:
        """Harness spans and extractor events in a traced run only."""
        self.timing = on and self.device.type == "cuda"

    def finish(self) -> None:
        """Nothing to read from the system after its requests."""

    def release(self) -> None:
        """Free the system under test before the reference runs."""
        del self.runner

    # --- the timed request ----------------------------------------------
    def _span(self, name):
        return trace.span(name) if self.timing else contextlib.nullcontext()

    def serve(self, k: int):
        """Request k: the answer (host arrays, and the device outputs kept
        for the check) and the pairs completed."""
        u0, u1, size = self.pool[k % len(self.pool)]
        with self._span("upload"):
            x0, x1 = _images(u0, self.device), _images(u1, self.device)
            s = torch.from_numpy(size).to(self.device)
        with self._span("call"):
            out = self.runner(x0, x1, s, s)
        with self._span("copy-out"):
            if self.system == "program":
                f0, f1 = out.feats0._asdict(), out.feats1._asdict()
                m0, ms0 = out.matches.matches0, out.matches.matching_scores0
            else:
                f0, f1 = out["feats0"], out["feats1"]
                m0, ms0 = out["matches0"], out["matching_scores0"]
            host = {"matches0": m0.cpu().numpy(),
                    "matching_scores0": ms0.cpu().numpy(),
                    "keypoints0": f0["keypoints"].cpu().numpy(),
                    "keypoints1": f1["keypoints"].cpu().numpy()}
        feats = {name: {key: f[key] for key in ("keypoints", "descriptors",
                                                "valid", "keypoint_scores")}
                 for name, f in (("feats0", f0), ("feats1", f1))}
        ok = host["matches0"].shape == f0["valid"].shape
        return (host, feats), len(size) if ok else 0

    def extract_ms(self):
        """Device ms an image of the extractor forward over the window."""
        if not self.events:
            return None
        torch.cuda.synchronize()
        ms = sum(a.elapsed_time(b) for a, b, _ in self.events)
        return ms / sum(n for _, _, n in self.events)

    # --- after the window -------------------------------------------------
    @torch.no_grad()
    def judge(self, kept: Dict[int, tuple]) -> Dict[str, float]:
        """The reference extractor (fp32, TF32 off) on each kept request's
        images, against the program's keypoints and descriptors; the
        reference matcher on the program's features (it follows the
        program's extraction, the stage judged just before), against its
        matches. A number is the largest over requests of each request's
        (each request's numbers kept in ``self.detail``)."""
        xp, mp = self.params(self.built_for)
        prec = Precision("fp32")
        ref_x = self.Ref(xp, self.xconf, prec)
        ref_m = Matcher(mp, self.mconf, prec)
        self.detail = {}
        self.flops, self.bytes = {}, {}
        for p, (host, feats) in sorted(kept.items()):
            u0, u1, size = self.pool[p]
            s = torch.from_numpy(size).to(self.device)
            gaps = {"keypoint_gap": [], "descriptor_gap": [],
                    "kscore_gap": [], "cut_gap": []}
            for side, u in ((0, u0), (1, u1)):
                f = feats[f"feats{side}"]
                img = _images(u, self.device)
                img = img[..., :1]  # SuperPoint reads grey
                ref = ref_x(img.permute(0, 3, 1, 2), s)
                for b in range(len(size)):
                    gaps["keypoint_gap"].append(xjudge.keypoint_gaps(
                        f["keypoints"][b], f["valid"][b],
                        ref["keypoints"][b], ref["valid"][b]))
                    gaps["cut_gap"].append(xjudge.cut_gaps(
                        ref["peak_map"][b], ref["cut"][b], f["keypoints"][b],
                        f["valid"][b]))
                at = ref_x.describe(ref, f["keypoints"].float())
                gaps["descriptor_gap"].append(xjudge.descriptor_gaps(
                    f["descriptors"], at, f["valid"]))
                gaps["kscore_gap"].append(xjudge.kscore_gaps(
                    f["keypoint_scores"], ref_x.score_at(
                        ref, f["keypoints"].float()), f["valid"]))
                del ref, at
            f0, f1 = feats["feats0"], feats["feats1"]
            with prec.math():
                out = ref_m(f0["keypoints"].float(), f1["keypoints"].float(),
                            f0["descriptors"].float(),
                            f1["descriptors"].float(), f0["valid"],
                            f1["valid"], s, s, layers=self.mconf["n_layers"])
            n0s = [int(v) for v in f0["valid"].sum(1)]
            n1s = [int(v) for v in f1["valid"].sum(1)]
            results = [{"matches0": host["matches0"][b, :n0s[b]],
                        "matching_scores0": host["matching_scores0"][b, :n0s[b]]}
                       for b in range(len(size))]
            mgaps, _ = mjudge.judge_batch(out, results, n0s, n1s,
                                          self.mconf["n_layers"],
                                          self.mconf["filter_threshold"])
            numbers = mjudge.request_numbers(mgaps)
            del numbers["stop_gap"]  # the matcher runs fixed
            for k, v in gaps.items():
                v = torch.cat(v)
                numbers[k] = float(v.mean()) if len(v) else 0.0
            self.detail[p] = numbers
            h, w = u0.shape[1:3]
            self.flops[p] = 2 * len(size) * self.xwork.flops(self.xconf, h, w)
            self.bytes[p] = 2 * len(size) * self.xwork.io_bytes(self.xconf, h,
                                                                w)
            for a, b in zip(n0s, n1s):
                self.flops[p] += lg_work.flops(self.mconf, [(a, b)] * self.mconf[
                    "n_layers"])
                self.bytes[p] += lg_work.io_bytes(self.mconf, a, b)
            self.bytes[p] += lg_work.weight_bytes(self.mconf,
                                                  self.mconf["n_layers"])
            del out
        return mjudge.run_numbers(list(self.detail.values()))

    def work(self, k: int):
        """(FLOPs, bytes) that request k needs (after ``judge``)."""
        p = k % len(self.pool)
        return self.flops.get(p), self.bytes.get(p)
