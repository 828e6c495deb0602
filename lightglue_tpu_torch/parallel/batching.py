"""Batched, bucketed and data-parallel matching (counterpart of
lightglue_tpu/parallel/batching.py).

Pairs are padded on the host to a common keypoint bucket (the reference's
static lengths, lightglue.py:46-55, 437-454), stacked on a batch axis and
matched in one call; results are compacted back per pair in input order
(``pipeline.compact_matches``: the C++ host runtime, ``native.py``). On a
CUDA device that call replays CUDA graphs captured once per (bucket, batch,
input signature) (``parallel/graphs.py``), the counterpart of the JAX
package's one compiled program per shape; on the CPU it runs
``models.lightglue.forward`` eagerly. With a ``mesh`` (``parallel/mesh.py``,
the JAX package's ``mesh=``) the batch's rows shard over the mesh's slots
in equal blocks, the parameters are copied to each device, and the adaptive
stop pools over every slot, as the JAX program's global sum pools it.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .. import nn
from ..configs import LightGlueConfig
from ..models import lightglue as lg
from ..pipeline import compact_matches
from . import graphs
from . import mesh as mesh_lib

DEFAULT_BUCKETS = (256, 512, 768, 1024, 1280, 1536, 2048, 4096)


def next_bucket(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= n (reference static_lengths selection,
    lightglue.py:514-516)."""
    for b in buckets:
        if b >= n:
            return b
    return n


def pad_features_to_bucket(
    feats: List[Dict[str, np.ndarray]],
    bucket: Optional[int] = None,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
) -> Dict[str, np.ndarray]:
    """Stack per-pair feature dicts (unbatched arrays: keypoints (K_i, 2),
    descriptors (K_i, D), ...) into one batch padded to a common bucket.

    Returns dict with keypoints (B, K, 2), descriptors (B, K, D),
    valid (B, K), image_size (B, 2) [if present], scales/oris if present.
    Padded slots hold 1.0 (and valid False), as in the JAX package.
    """
    kmax = max(f["keypoints"].shape[0] for f in feats)
    k = bucket or next_bucket(kmax, buckets)
    out: Dict[str, List[np.ndarray]] = {}
    for f in feats:
        n = f["keypoints"].shape[0]
        pad = k - n
        valid = f.get("valid")
        if valid is None:
            valid = np.ones((n,), bool)
        out.setdefault("valid", []).append(
            np.pad(valid, (0, pad), constant_values=False)
        )
        for key in ("keypoints", "descriptors", "keypoint_scores", "scales", "oris"):
            if key in f:
                arr = f[key]
                widths = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
                out.setdefault(key, []).append(
                    np.pad(arr, widths, constant_values=1.0)
                )
        if "image_size" in f:
            out.setdefault("image_size", []).append(np.asarray(f["image_size"]))
    return {key: np.stack(v, 0) for key, v in out.items()}


def pack_pairs(sel) -> graphs.Fill:
    """A fill that writes pairs ``sel`` ((feats0, feats1) of unbatched
    arrays) padded to the arrays' bucket: the arrays that
    ``pad_features_to_bucket`` and ``batch_inputs`` give, without their
    intermediate copies (padded slots 1.0 and not valid)."""
    names = (("kpts", "keypoints", 1.0), ("desc", "descriptors", 1.0),
             ("size", "image_size", None), ("scales", "scales", 1.0),
             ("oris", "oris", 1.0))

    def fill(arrays: Dict[str, np.ndarray]) -> None:
        for side in (0, 1):
            mask = arrays[f"mask{side}"]
            for j, pair in enumerate(sel):
                f = pair[side]
                n = f["keypoints"].shape[0]
                valid = f.get("valid")
                mask[j, :n] = True if valid is None else valid
                mask[j, n:] = False
                for short, key, pad in names:
                    dst = arrays.get(f"{short}{side}")
                    if dst is None:
                        continue
                    if pad is None:
                        dst[j] = f[key]
                    elif short == "desc":  # the bulk: torch's threaded copy
                        row = torch.from_numpy(dst[j])
                        row[:n].copy_(torch.from_numpy(np.asarray(f[key])))
                        row[n:] = pad
                    else:
                        dst[j, :n] = f[key]
                        dst[j, n:] = pad
    return fill


def _with_size(sel) -> bool:
    """Whether a chunk's pairs carry image_size (all of them, both images:
    one signature; none: the other)."""
    given = {"image_size" in f for pair in sel for f in pair}
    if len(given) > 1:
        raise ValueError("give image_size for every image of a chunk or "
                         "for none")
    return given.pop()


def batch_inputs(conf: LightGlueConfig, feats0: Dict[str, np.ndarray],
                 feats1: Dict[str, np.ndarray]) -> Dict[str, Optional[np.ndarray]]:
    """Two padded feature batches as ``models.lightglue.forward``'s keyword
    arguments, in numpy (scales and orientations where the configuration
    reads them)."""
    def g(f, k, dtype=np.float32):
        v = f.get(k)
        return None if v is None else np.asarray(v, dtype)

    kw = dict(kpts0=g(feats0, "keypoints"), kpts1=g(feats1, "keypoints"),
              desc0=g(feats0, "descriptors"), desc1=g(feats1, "descriptors"),
              mask0=g(feats0, "valid", bool), mask1=g(feats1, "valid", bool),
              size0=g(feats0, "image_size"), size1=g(feats1, "image_size"))
    if conf.add_scale_ori:
        kw.update(scales0=g(feats0, "scales"), oris0=g(feats0, "oris"),
                  scales1=g(feats1, "scales"), oris1=g(feats1, "oris"))
    return kw


def _shard(sig: graphs.Signature, slots: int) -> graphs.Signature:
    """One slot's share of ``sig`` (equal blocks; raises if uneven)."""
    mesh_lib.row_bounds(sig.batch, slots)
    return sig._replace(batch=sig.batch // slots)


def _fills(inputs: Dict[str, Optional[np.ndarray]], slots: int) -> List[graphs.Fill]:
    """Fills that copy each slot's block of ``inputs``' rows."""
    bounds = mesh_lib.row_bounds(graphs.signature_of(inputs).batch, slots)
    return [graphs.copy_inputs({k: None if v is None else v[a:b]
                                for k, v in inputs.items()}) for a, b in bounds]


class EagerMatcher:
    """Padded batches -> ``models.lightglue.MatchOutput`` of numpy arrays
    through ``models.lightglue.forward_slots``, eagerly (the CPU's runner):
    the batch's rows split over ``devices`` (one slot: ``forward``), slot k
    on ``trees[k]``, the adaptive stop pooled over every slot. ``launches``
    holds each slot's kernel launches."""

    def __init__(self, conf: LightGlueConfig, trees: List[nn.Params],
                 devices: List[torch.device]):
        self.conf, self.trees, self.devices = conf, trees, devices
        self.launches: List[Dict[str, int]] = [{} for _ in devices]

    def warm(self, sig: graphs.Signature) -> None:
        """Run ``sig`` once on seeded inputs."""
        self(graphs.example_inputs(sig, self.conf.input_dim))

    def __call__(self, inputs: Dict[str, Optional[np.ndarray]]) -> lg.MatchOutput:
        return self.run(graphs.signature_of(inputs),
                        _fills(inputs, len(self.devices)))

    @torch.inference_mode()
    def run(self, sig: graphs.Signature,
            fills: List[graphs.Fill]) -> lg.MatchOutput:
        """The forward on a batch of signature ``sig`` whose rows of slot k
        ``fills[k]`` writes (``mesh.row_bounds``' equal blocks)."""
        shard = _shard(sig, len(self.devices))
        kws = []
        for fill, dev in zip(fills, self.devices):
            arrays = graphs.host_arrays(shard, self.conf.input_dim)
            fill(arrays)
            kws.append({k: torch.from_numpy(v).to(dev)
                        for k, v in arrays.items()})
        outs = lg.forward_slots(self.trees, self.conf, kws,
                                tallies=self.launches)
        return mesh_lib.gather([lg.MatchOutput(*(
            f if isinstance(f, int) else f.cpu().numpy() for f in out))
            for out in outs])


class MeshGraphMatcher:
    """Padded batches over the CUDA slots of a mesh, each slot a
    ``graphs.GraphMatcher`` on its own device, stream and pool with its
    copy of the parameters, the stop pooled over the slots
    (``graphs.run_slots``). ``launches`` holds each slot's kernel
    launches."""

    def __init__(self, conf: LightGlueConfig, trees: List[nn.Params],
                 devices: List[torch.device]):
        self.conf = conf
        self.slots = [graphs.GraphMatcher(conf, t, d)
                      for t, d in zip(trees, devices)]

    @property
    def launches(self) -> List[Dict[str, int]]:
        return [slot.launches for slot in self.slots]

    def warm(self, sig: graphs.Signature) -> None:
        """Capture every slot's graph set of its share of ``sig``."""
        for slot in self.slots:
            slot.warm(_shard(sig, len(self.slots)))

    def __call__(self, inputs: Dict[str, Optional[np.ndarray]]) -> lg.MatchOutput:
        return self.run(graphs.signature_of(inputs),
                        _fills(inputs, len(self.slots)))

    def run(self, sig: graphs.Signature,
            fills: List[graphs.Fill]) -> lg.MatchOutput:
        """Replay on every slot, slot k on the rows ``fills[k]`` writes into
        its pinned staging arrays."""
        return mesh_lib.gather(graphs.run_slots(
            self.slots, _shard(sig, len(self.slots)), fills))


def make_batched_matcher(conf: LightGlueConfig, params: nn.Params,
                         device: Union[str, torch.device] = "cuda",
                         mesh: Optional[mesh_lib.Mesh] = None):
    """A runner of padded batches on ``device`` (``params`` must lie
    there): ``runner(batch_inputs(...)) -> MatchOutput`` of numpy arrays,
    ``runner.run(signature, fills)`` on the inputs that its fills write
    into its input arrays (one fill a slot, each its block of the rows),
    ``runner.warm(signature)``. On a CUDA device it captures one CUDA graph
    set per input signature on its first sight and replays it
    (``graphs.GraphMatcher``), keeping ``params``, whose addresses the
    graphs hold; on the CPU it runs the forward eagerly.

    With a ``mesh`` of more than one slot (``parallel/mesh.py``; ``device``
    is not read), the batch's rows shard over the slots in equal blocks,
    the parameters are copied to each device (``mesh.replicate``) and the
    adaptive stop pools over every slot: CUDA graphs on every slot of an
    all-CUDA mesh, the eager forward on an all-CPU one. A one-slot mesh is
    the runner on its device."""
    if mesh is not None and mesh.size == 1:
        device, mesh = mesh.slots[0], None
    if mesh is None:
        device = torch.device(device)
        if device.type == "cuda":
            return graphs.GraphMatcher(conf, params, device)
        return EagerMatcher(conf, [params], [device])
    kinds = {d.type for d in mesh.slots}
    if len(kinds) > 1:
        raise ValueError(f"a mesh of CPU and CUDA slots: {mesh}")
    replicas = mesh_lib.replicate(mesh, params)
    trees = [replicas[dev] for dev in mesh.slots]
    runner = MeshGraphMatcher if kinds == {"cuda"} else EagerMatcher
    return runner(conf, trees, list(mesh.slots))


class _Tree:
    """A parameter tree as a cache key: hashed and compared by identity,
    and held, so that its id cannot pass to another tree while cached."""

    def __init__(self, tree: nn.Params):
        self.tree = tree

    def __hash__(self) -> int:
        return id(self.tree)

    def __eq__(self, other) -> bool:
        return isinstance(other, _Tree) and other.tree is self.tree


@functools.lru_cache(maxsize=8)
def _shared_matcher(conf: LightGlueConfig, tree: _Tree, device: torch.device,
                    mesh: Optional[mesh_lib.Mesh]):
    return make_batched_matcher(conf, tree.tree, device, mesh)


def match_feature_batch(
    params: nn.Params,
    conf: LightGlueConfig,
    feats0: Dict[str, np.ndarray],
    feats1: Dict[str, np.ndarray],
    device: Union[str, torch.device] = "cuda",
    mesh: Optional[mesh_lib.Mesh] = None,
) -> lg.MatchOutput:
    """Match two stacked+padded feature batches (from
    ``pad_features_to_bucket``), on ``device`` or sharded over the slots
    of ``mesh`` (``make_batched_matcher``; the batch must divide over
    them). The runner is cached per (conf, parameter tree, device, mesh)
    for the 8 most recent."""
    matcher = _shared_matcher(conf, _Tree(params), torch.device(device), mesh)
    return matcher(batch_inputs(conf, feats0, feats1))


class BatchMatcher:
    """Serving runtime: match many ragged feature pairs with a bounded set
    of programs.

    Pairs are grouped by keypoint bucket, each group is packed into padded
    batches of at most ``max_batch`` pairs, batch sizes are rounded up to
    powers of two (copies of the chunk's first pair padded in) so that few
    programs serve all traffic, and results are compacted back per pair in
    input order. On a CUDA device every (bucket, batch, input signature)
    is one CUDA graph set, captured on its first use or by ``warmup``, and
    every graph of the matcher shares one memory pool; ``device="cpu"``
    runs the forward eagerly.

    With a ``mesh`` (``parallel/mesh.py``; ``device`` is not read) each
    batch shards over its slots (``make_batched_matcher``): batches are
    rounded up to a multiple of the slot count, the dummy pairs count in
    the pooled adaptive stop, as in the JAX package; ``params`` is the
    first slot's copy.
    """

    def __init__(
        self,
        conf: LightGlueConfig,
        params: nn.Params,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        max_batch: int = 16,
        device: Union[str, torch.device] = "cuda",
        mesh: Optional[mesh_lib.Mesh] = None,
    ):
        if mesh is not None and mesh.size == 1:  # the runner on its device
            device, mesh = mesh.slots[0], None
        self.conf = conf
        self.mesh = mesh
        self.device = torch.device(device) if mesh is None else mesh.slots[0]
        self.params = nn.params_to(params, self.device)
        self.buckets = tuple(buckets)
        self.max_batch = max_batch
        self._matcher = make_batched_matcher(conf, self.params, self.device,
                                             mesh)

    def warmup(self, batches: Optional[Sequence[int]] = None) -> int:
        """Build every (bucket, batch) program this matcher can dispatch,
        with and without ``image_size``, before any traffic arrives: on a
        CUDA device each is captured as a CUDA graph set (after one eager
        run; a bucket above ``compaction_bucket`` as the two-stage set), on
        the CPU each runs once. Graphs live in this process: no
        cache carries them across processes, as JAX's persistent
        compilation cache carries compiled programs.

        Returns the number of programs built."""
        if batches is None:
            batches = [self.max_batch]
        sizes = sorted({self._round_batch(b, self.max_batch) for b in batches})
        n = 0
        for bucket in self.buckets:
            for b in sizes:
                # traffic may or may not carry image_size: two programs
                for with_size in (True, False):
                    self._matcher.warm(graphs.Signature(
                        b, bucket, bucket, with_size, self.conf.add_scale_ori))
                    n += 1
        return n

    def _round_batch(self, n: int, max_batch: int) -> int:
        b = 1
        while b < n and b < max_batch:
            b *= 2
        if self.mesh is not None:
            # equal blocks a slot: round up (dummy pairs fill the slack)
            nd = self.mesh.size
            b = ((b + nd - 1) // nd) * nd
        return b

    def _chunks(self, pairs):
        """(bucket, indices of a chunk's pairs, the chunk's pairs with
        copies of its first appended up to the rounded batch size)."""
        groups: Dict[int, List[int]] = {}
        for i, (f0, f1) in enumerate(pairs):
            n = max(f0["keypoints"].shape[0], f1["keypoints"].shape[0])
            groups.setdefault(next_bucket(n, self.buckets), []).append(i)
        for bucket, idxs in groups.items():
            for start in range(0, len(idxs), self.max_batch):
                chunk = idxs[start : start + self.max_batch]
                b = self._round_batch(len(chunk), self.max_batch)
                sel = [pairs[i] for i in chunk]
                # pad with a dummy pair to the rounded batch size
                while len(sel) < b:
                    sel.append(sel[0])
                yield bucket, chunk, sel

    def padded_batches(self, pairs):
        """The batches ``match_pairs`` runs: (indices of the chunk's pairs,
        feats0, feats1), each padded to its bucket and rounded batch."""
        for bucket, chunk, sel in self._chunks(pairs):
            yield (chunk, pad_features_to_bucket([p[0] for p in sel], bucket),
                   pad_features_to_bucket([p[1] for p in sel], bucket))

    def match_batch(self, feats0: Dict[str, np.ndarray],
                    feats1: Dict[str, np.ndarray]) -> lg.MatchOutput:
        """One padded batch through this matcher's programs."""
        return self._matcher(batch_inputs(self.conf, feats0, feats1))

    def match_pairs(self, pairs):
        """pairs: list of (feats0, feats1) dicts with unbatched arrays
        (keypoints (K_i, 2), descriptors, optional valid/image_size/
        scales/oris). Returns a list of result dicts with matches (K, 2),
        scores, matches0/1, matching_scores0/1, stop."""
        results = [None] * len(pairs)
        for bucket, chunk, sel in self._chunks(pairs):
            # each chunk written straight into the runner's input arrays (on
            # the card its pinned staging buffers), a block of rows a slot
            sig = graphs.Signature(len(sel), bucket, bucket, _with_size(sel),
                                   self.conf.add_scale_ori)
            out = self._matcher.run(sig, [
                pack_pairs(sel[a:b]) for a, b in mesh_lib.row_bounds(
                    len(sel), 1 if self.mesh is None else self.mesh.size)])
            cm, cs = compact_matches(out.matches0, out.matching_scores0)
            for j, i in enumerate(chunk):
                n0 = pairs[i][0]["keypoints"].shape[0]
                n1 = pairs[i][1]["keypoints"].shape[0]
                results[i] = {
                    "matches": cm[j],
                    "scores": cs[j],
                    "matches0": out.matches0[j, :n0],
                    "matches1": out.matches1[j, :n1],
                    "matching_scores0": out.matching_scores0[j, :n0],
                    "matching_scores1": out.matching_scores1[j, :n1],
                    "stop": int(out.stop),
                }
        return results
