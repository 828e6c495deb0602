"""LightGlue in plain PyTorch: the benchmark's reference matcher.

Written from the published model (cvg/LightGlue ``lightglue/lightglue.py``:
the learnable Fourier positional encoding applied as rotary embeddings,
SelfBlock, CrossBlock with one shared QK projection, the FFN on
[x, message], the log double-softmax assignment with matchability
dustbins, the mutual-nearest filter, TokenConfidence, the early exit and
the point pruning of ``LightGlue._forward``). It runs a padded batch with
validity masks instead of ``index_select``: a pruned or padded point is
masked out of every attention and of the assignment, which is what the
published loop computes on its shortened arrays. The stop of a batch is
the published test over all of the batch's points (padded ones left out).

Everything is float32 through ``Precision`` (TF32 off for the reference,
the controls' rounding otherwise), and attention runs a few pairs at a
time so that a batch of 16 pairs at 2048 points fits beside the program's
freed state. It imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .precision import Precision

NEG = -1e30  # a masked logit; finite, so that an all-masked row gives 0


def load_npz(path: str, device) -> Dict:
    """The flat ``a/b/c`` npz as a nested dict of float32 tensors."""
    tree: Dict = {}
    with np.load(path) as f:
        for key in f.files:
            node = tree
            *parts, leaf = key.split("/")
            for p in parts:
                node = node.setdefault(p, {})
            node[leaf] = torch.from_numpy(
                np.ascontiguousarray(f[key], np.float32)).to(device)
    return tree


def layer(tree: Dict, i: int) -> Dict:
    """Layer ``i`` of a tree of stacked leaves."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def confidence_threshold(i: int, n_layers: int) -> float:
    """The published per-layer exit threshold, in float32."""
    return float(np.float32(min(max(
        0.8 + 0.1 * math.exp(-4.0 * i / n_layers), 0.0), 1.0)))


class Matcher:
    """The plain matcher over one parameter tree."""

    def __init__(self, params: Dict, conf: Dict, prec: Precision,
                 rows: int = 4):
        self.p, self.conf, self.prec, self.rows = params, conf, prec, rows
        self.h = conf["num_heads"]

    # --- pieces ---------------------------------------------------------
    def linear(self, p, x):
        y = self.prec.mm(x, p["w"])
        return y + p["b"] if "b" in p else y

    def ffn(self, p, x, message):
        y = self.linear(p["lin1"], torch.cat([x, message], -1))
        y = F.layer_norm(y, y.shape[-1:], p["ln"]["scale"], p["ln"]["bias"],
                         1e-5)
        return x + self.linear(p["lin2"], F.gelu(y))

    @staticmethod
    def rotary(enc, t):
        """t * cos + rotate_half(t) * sin on interleaved channel pairs."""
        cos, sin = (e.repeat_interleave(2, -1) for e in enc)
        x = t.unflatten(-1, (-1, 2))
        half = torch.stack([-x[..., 1], x[..., 0]], -1).flatten(-2)
        return t * cos + half * sin

    def attention(self, q, k, v, mask):
        """softmax(q k^T / sqrt(d)) v over (B, H, N, d), a few pairs at a
        time; ``mask`` (B, Nq, Nk) True = attend; rows with no key are 0."""
        out = []
        for a in range(0, q.shape[0], self.rows):
            s = slice(a, a + self.rows)
            sim = self.prec.mm(q[s], k[s].transpose(-1, -2)) / math.sqrt(
                q.shape[-1])
            m = mask[s, None]
            sim = torch.where(m, sim, NEG)
            attn = torch.softmax(sim, -1)
            o = self.prec.mm(attn, v[s])
            out.append(torch.where(m.any(-1, keepdim=True), o, 0.0))
        return torch.cat(out)

    def heads(self, x):
        return x.unflatten(-1, (self.h, -1)).transpose(1, 2)

    @staticmethod
    def merge(x):
        return x.transpose(1, 2).flatten(-2)

    def self_block(self, p, x, enc, act):
        qkv = self.linear(p["Wqkv"], x).unflatten(-1, (self.h, -1, 3))
        qkv = qkv.transpose(1, 2)
        q = self.rotary(enc, qkv[..., 0])
        k = self.rotary(enc, qkv[..., 1])
        mask = act[:, None, :].expand(-1, x.shape[1], -1)
        ctx = self.attention(q, k, qkv[..., 2], mask)
        return self.ffn(p["ffn"], x, self.linear(p["out_proj"],
                                                 self.merge(ctx)))

    def cross_block(self, p, x0, x1, act0, act1):
        qk0, qk1 = self.heads(self.linear(p["to_qk"], x0)), self.heads(
            self.linear(p["to_qk"], x1))
        v0, v1 = self.heads(self.linear(p["to_v"], x0)), self.heads(
            self.linear(p["to_v"], x1))
        mask = act0[:, :, None] & act1[:, None, :]
        m0 = self.attention(qk0, qk1, v1, mask)
        m1 = self.attention(qk1, qk0, v0, mask.transpose(1, 2))
        m0 = self.linear(p["to_out"], self.merge(m0))
        m1 = self.linear(p["to_out"], self.merge(m1))
        return self.ffn(p["ffn"], x0, m0), self.ffn(p["ffn"], x1, m1)

    def log_assignment(self, la, d0, d1, act0, act1):
        """The (B, M+1, N+1) log assignment, masked pairs at NEG."""
        md0 = self.linear(la["final_proj"], d0) / d0.shape[-1] ** 0.25
        md1 = self.linear(la["final_proj"], d1) / d1.shape[-1] ** 0.25
        pair = act0[:, :, None] & act1[:, None, :]
        out = []
        for a in range(0, d0.shape[0], self.rows):
            s = slice(a, a + self.rows)
            sim = torch.where(pair[s], self.prec.mm(
                md0[s], md1[s].transpose(1, 2)), NEG)
            z0 = self.linear(la["matchability"], d0[s])
            z1 = self.linear(la["matchability"], d1[s])
            inner = (torch.log_softmax(sim, 2) + torch.log_softmax(sim, 1)
                     + F.logsigmoid(z0) + F.logsigmoid(z1).transpose(1, 2))
            inner = torch.where(pair[s], inner, NEG)
            sc = torch.full((inner.shape[0], inner.shape[1] + 1,
                             inner.shape[2] + 1), 0.0, device=d0.device)
            sc[:, :-1, :-1] = inner
            sc[:, :-1, -1] = F.logsigmoid(-z0[..., 0])
            sc[:, -1, :-1] = F.logsigmoid(-z1[..., 0])
            out.append(sc)
        return torch.cat(out)

    def filter(self, scores, act0, act1):
        """Mutual nearest neighbours above the threshold (published
        ``filter_matches``) -> (matches0, matching_scores0)."""
        inner = scores[:, :-1, :-1]
        max0, m0 = inner.max(2)
        m1 = inner.max(1).indices
        mutual0 = torch.arange(m0.shape[1], device=m0.device)[None] == \
            m1.gather(1, m0)
        ms0 = torch.where(mutual0 & act0, max0.exp(), 0.0)
        valid0 = mutual0 & (ms0 > self.conf["filter_threshold"]) & act0
        return torch.where(valid0, m0, -1), ms0

    # --- the forward ----------------------------------------------------
    def __call__(self, kpts0, kpts1, desc0, desc1, mask0, mask1, size0,
                 size1, layers: Optional[int] = None, tie: float = 0.0,
                 flips=()) -> Dict:
        """One padded batch. ``layers``: run exactly that many layers (the
        program's stop, which the judge holds against the published test,
        recorded at each layer); None: the published early exit. ``tie``:
        record every pruning test that a point cleared by less than that
        many logits; ``flips``: such tests, as ``ties`` lists them, whose
        decision this run takes the other way.

        Returns the final log assignment ``scores``, the active masks, the
        reference's own ``matches0`` / ``matching_scores0``, ``stop`` (the
        layers run), ``tests`` (per layer that had one: the stop test's
        token logits, active masks, point count and threshold) and
        ``pruned`` (per image a (B, N) margin, in logits, by which each
        point pruned was pruned; 0 where it was kept), ``kept`` (per image
        a (B, N) margin, in logits, by which each point kept cleared the
        pruning test at its closest layer; inf where no test ran) and
        ``active`` (B, layers run, 2): each image's active points entering
        each layer, and ``ties``: (margin, layer, side, pair, point) of each
        test cleared by less than ``tie``, nearest first."""
        c, p, prec = self.conf, self.p, self.prec
        L = c["n_layers"]

        def norm(k, size):
            size = size.float()
            return (k - size[:, None] / 2) / (size.max(-1).values[:, None, None]
                                              / 2)

        kn0, kn1 = norm(kpts0, size0), norm(kpts1, size1)
        d0, d1 = desc0.float(), desc1.float()
        if "input_proj" in p:
            d0, d1 = self.linear(p["input_proj"], d0), self.linear(
                p["input_proj"], d1)

        def enc(kn):
            proj = prec.mm(kn, p["posenc"]["Wr"]["w"])[:, None]
            return torch.cos(proj), torch.sin(proj)

        e0, e1 = enc(kn0), enc(kn1)
        act0, act1 = mask0.clone(), mask1.clone()
        points = float(mask0.sum() + mask1.sum())
        pruned = [torch.zeros(mask0.shape, device=d0.device),
                  torch.zeros(mask1.shape, device=d1.device)]
        kept = [torch.full(mask0.shape, math.inf, device=d0.device),
                torch.full(mask1.shape, math.inf, device=d1.device)]
        tests: List[Dict] = []
        active: List[torch.Tensor] = []
        ties: List[tuple] = []
        logit = lambda q: math.log(q / (1.0 - q))  # noqa: E731
        i = 0
        while True:
            active.append(torch.stack([act0.sum(1), act1.sum(1)], 1))
            lp = layer(p["transformers"], i)
            d0 = self.self_block(lp["self_attn"], d0, e0, act0)
            d1 = self.self_block(lp["self_attn"], d1, e1, act1)
            d0, d1 = self.cross_block(lp["cross_attn"], d0, d1, act0, act1)
            i += 1
            if i == L:
                break
            th = confidence_threshold(i - 1, L)
            tok = layer(p["token_confidence"], i - 1)["token"]
            t0 = self.linear(tok, d0)[..., 0]
            t1 = self.linear(tok, d1)[..., 0]
            if c["depth_confidence"] > 0:
                unconf = float((act0 & (torch.sigmoid(t0) < th)).sum()
                               + (act1 & (torch.sigmoid(t1) < th)).sum())
                ratio = np.float32(1.0) - np.float32(unconf) / np.float32(points)
                stop = bool(ratio > np.float32(c["depth_confidence"]))
                tests.append(dict(t=torch.cat([t0, t1], 1),
                                  act=torch.cat([act0, act1], 1),
                                  points=points, th=th,
                                  dc=c["depth_confidence"]))
                if (stop if layers is None else i == layers):
                    break
            elif layers is not None and i == layers:
                break
            if c["width_confidence"] > 0:
                la = layer(p["log_assignment"], i - 1)
                keep_z = logit(1.0 - c["width_confidence"])
                for side, (d, t) in enumerate(((d0, t0), (d1, t1))):
                    act = (act0, act1)[side]
                    z = self.linear(la["matchability"], d)[..., 0]
                    ran = act.sum(1, keepdim=True) > c["pruning_min_kpts"]
                    keep = torch.sigmoid(z) > 1.0 - c["width_confidence"]
                    margin = keep_z - z
                    if c["depth_confidence"] > 0:
                        keep = keep | (torch.sigmoid(t) <= th)
                        margin = torch.minimum(margin, t - logit(th))
                    tested = act & ran
                    if tie > 0:
                        near = tested & (margin.abs() < tie)
                        for b, n in near.nonzero().tolist():
                            ties.append((float(margin[b, n].abs()), i, side,
                                         b, n))
                    for li, ls, b, n in (f[1:] for f in flips):
                        if (li, ls) == (i, side):
                            keep[b, n] = ~keep[b, n]
                    drop = tested & ~keep
                    pruned[side] = torch.where(drop, margin.clamp(min=0),
                                               pruned[side])
                    kept[side] = torch.where(
                        act & ran & keep,
                        torch.minimum(kept[side], (-margin).clamp(min=0)),
                        kept[side])
                    if side == 0:
                        act0 = act0 & ~drop
                    else:
                        act1 = act1 & ~drop
        la = layer(p["log_assignment"], i - 1)
        scores = self.log_assignment(la, d0, d1, act0, act1)
        m0, ms0 = self.filter(scores, act0, act1)
        return dict(scores=scores, act0=act0, act1=act1, matches0=m0,
                    matching_scores0=ms0, stop=i, tests=tests, pruned=pruned,
                    kept=kept, active=torch.stack(active, 1),
                    ties=sorted(ties))
