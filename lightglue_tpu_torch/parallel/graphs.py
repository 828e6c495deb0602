"""CUDA graphs of the batched matcher: one graph set per input signature.

Counterpart of the compiled programs behind
lightglue_tpu/parallel/batching.py (``make_batched_matcher`` :73-121,
``BatchMatcher.warmup`` :181-231): jax.jit traces one program per (bucket,
batch, input signature) on its first call and runs it after. A
``GraphMatcher`` captures one set of CUDA graphs per ``Signature`` the first
time it sees it (or in ``warm``) and replays that set after, so a call
launches a few graphs instead of the eager matcher's 250-310 kernels.

- **Fixed forward:** one graph over ``models.lightglue.forward_fixed``.
- **Adaptive forward:** JAX runs its loop as one ``lax.while_loop``.
  PyTorch's graph API has no conditional nodes, so the loop is cut into
  segments: one graph per layer (segment 0 also holds ``adaptive_start``;
  each ``adaptive_layer``: the layer, token confidence, the stop counts and
  pruning as if the loop goes on), with the counts read on the host from a
  pinned pair between segments, as the eager loop reads them, and one
  graph of ``adaptive_finish`` per layer the loop may exit after (each
  reads its own ``log_assignment`` layer and the masks from before its
  layer's pruning). The stop decision pools over the whole batch, dummy
  pairs included, as the JAX loop's does.
- **Slots** (``run_slots``; a mesh's, ``batching.MeshGraphMatcher``): each
  ``GraphMatcher`` has its own device, stream, pool and pinned counts.
  Every slot replays layer i, the host reads every slot's counts and pools
  them (``models.lightglue.pooled_stop``), then every slot replays the
  next layer or the exit. One slot is the runner alone.
- **Two-stage compaction** (``models.lightglue.twostage`` true for the
  signature): the prefix layers' graphs at the full bucket; one graph of
  ``compact`` after the last prefix layer, replayed before its stop counts
  are read; the suffix layers' and their exit graphs at the compaction
  bucket, each exit with ``scatter_back`` to the original numbering. An
  exit after a prefix layer holds its own compaction of that layer's
  state before pruning (the JAX path compacts even when the prefix
  stopped).
- **Static buffers:** a signature's inputs are packed in one pinned host
  buffer and one device buffer (``Staging``): numpy arrays are copied into
  the pinned one and sent in one copy. The outputs come back the same way,
  with one synchronize, and are copied out before the next replay.
- **Memory:** all graphs of one ``GraphMatcher`` capture into one memory
  pool: they never replay at once. Each segment's state stays allocated,
  since the next segment and the exit graphs read it.
- **Before the first capture** of a signature, every step it will hold runs
  once eagerly: that sets the kernels' shared-memory attributes and fills
  the prepared weights and the cached launch plans outside the capture.
- **Parameters:** the graphs bake in their addresses, so a ``GraphMatcher``
  keeps the tree it was built with.
- **Launch counts:** ``_build.count`` runs on the host, at capture only.
  Each graph keeps the counts its capture added, and every replay adds
  them again (``_build.add_launches``).

A failed capture or replay raises: there is no path back to the eager
forward. Graphs live in their process; nothing persists across processes.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _build, nn
from ..configs import LightGlueConfig
from ..models import lightglue as lg

# bytes: each packed tensor starts on this boundary (the kernels' 16-byte
# loads need 16; 256 is the allocator's own alignment)
ALIGN = 256
OUTPUTS = ("matches0", "matches1", "matching_scores0", "matching_scores1",
           "prune0", "prune1")
Specs = Dict[str, Tuple[Tuple[int, ...], torch.dtype]]
# writes a batch's inputs into numpy arrays of its signature's shapes
Fill = Callable[[Dict[str, np.ndarray]], None]


class Signature(NamedTuple):
    """What selects a graph set, as shapes and optional inputs select a
    jitted program: batch, keypoints of each image, whether ``image_size``
    is given (else keypoints are normalized by their bounding box), and
    whether scales and orientations are."""

    batch: int
    m: int
    n: int
    with_size: bool
    with_scale_ori: bool


def signature_of(inputs: Dict[str, Optional[np.ndarray]]) -> Signature:
    """The signature of matcher inputs (``models.lightglue.forward``'s
    keyword names)."""
    b, m = inputs["kpts0"].shape[:2]
    sizes = {inputs.get(f"size{s}") is not None for s in "01"}
    if len(sizes) > 1:
        raise ValueError("give image_size for both images or for neither")
    return Signature(b, m, inputs["kpts1"].shape[1], sizes.pop(),
                     inputs.get("scales0") is not None)


def input_specs(sig: Signature, dim: int) -> Specs:
    specs: Specs = {}
    for side, k in (("0", sig.m), ("1", sig.n)):
        specs[f"kpts{side}"] = ((sig.batch, k, 2), torch.float32)
        specs[f"desc{side}"] = ((sig.batch, k, dim), torch.float32)
        specs[f"mask{side}"] = ((sig.batch, k), torch.bool)
        if sig.with_size:
            specs[f"size{side}"] = ((sig.batch, 2), torch.float32)
        if sig.with_scale_ori:
            specs[f"scales{side}"] = ((sig.batch, k), torch.float32)
            specs[f"oris{side}"] = ((sig.batch, k), torch.float32)
    return specs


def output_specs(sig: Signature) -> Specs:
    """The matcher's outputs (``OUTPUTS``) for ``sig``."""
    specs: Specs = {}
    for f in OUTPUTS:
        k = sig.n if f.endswith("1") else sig.m
        dtype = torch.float32 if f.startswith("matching") else torch.int32
        specs[f] = ((sig.batch, k), dtype)
    return specs


def example_inputs(sig: Signature, dim: int) -> Dict[str, np.ndarray]:
    """Seeded inputs of signature ``sig``, for a warm-up before traffic."""
    rng = np.random.default_rng(0)
    out = {}
    for name, (shape, dtype) in input_specs(sig, dim).items():
        if dtype == torch.bool:
            out[name] = np.ones(shape, bool)
        elif name.startswith("kpts"):
            out[name] = rng.uniform(0, 512, shape).astype(np.float32)
        elif name.startswith("size"):
            out[name] = np.full(shape, 512, np.float32)
        elif name.startswith("oris"):
            out[name] = rng.uniform(-np.pi, np.pi, shape).astype(np.float32)
        else:
            out[name] = rng.standard_normal(shape).astype(np.float32)
    return out


def host_arrays(sig: Signature, dim: int) -> Dict[str, np.ndarray]:
    """Empty numpy arrays of ``sig``'s inputs."""
    return {name: np.empty(shape, np.bool_ if dtype == torch.bool else np.float32)
            for name, (shape, dtype) in input_specs(sig, dim).items()}


def copy_inputs(inputs: Dict[str, Optional[np.ndarray]]) -> Fill:
    """A fill that copies numpy inputs (a mask not given: all valid)."""
    def fill(arrays: Dict[str, np.ndarray]) -> None:
        for name, dst in arrays.items():
            src = inputs.get(name)
            if src is None and dst.dtype == np.bool_:
                src = True
            np.copyto(dst, src, casting="same_kind")
    return fill


class Staging:
    """Named tensors packed into one host buffer (pinned for a CUDA
    device) and one device buffer, each starting on an ALIGN-byte
    boundary: ``to_device`` and ``to_host`` move all of them in one copy on
    the current stream."""

    def __init__(self, specs: Specs, device: torch.device):
        places, total = {}, 0
        for name, (shape, dtype) in specs.items():
            nbytes = int(np.prod(shape)) * dtype.itemsize
            places[name] = (total, nbytes, shape, dtype)
            total += -(-nbytes // ALIGN) * ALIGN
        self.host = torch.empty(total, dtype=torch.uint8,
                                pin_memory=device.type == "cuda")
        self.dev = torch.empty(total, dtype=torch.uint8, device=device)
        self.host_np = {n: self._view(self.host, *p).numpy()
                        for n, p in places.items()}
        self.tensors = {n: self._view(self.dev, *p) for n, p in places.items()}

    @staticmethod
    def _view(buf, offset, nbytes, shape, dtype):
        return buf[offset:offset + nbytes].view(dtype).view(shape)

    def to_device(self) -> None:
        self.dev.copy_(self.host, non_blocking=True)

    def to_host(self) -> None:
        self.host.copy_(self.dev, non_blocking=True)


class Captured(NamedTuple):
    """One CUDA graph and the kernel launches its capture counted."""

    graph: torch.cuda.CUDAGraph
    counts: Dict[str, int]

    def replay(self) -> None:
        self.graph.replay()
        _build.add_launches(self.counts)


class GraphSet(NamedTuple):
    """The graphs of one signature. Fixed: ``segments`` holds the whole
    forward. Adaptive: ``segments[i]`` runs layer i (segment 0 from the
    inputs) into ``states[i]`` (pruned, for the next layer) and ``held[i]``
    (the masks from before the layer, for an exit after it), ``stops[i]``
    is its stop counts (None where no layer reads one), ``exits[i]`` the
    assignment after i + 1 layers; the last graph of a call writes
    ``outputs``. Two-stage: ``prefix`` layers at full size, then
    ``compaction`` (one graph) into ``compacted`` (the state and the
    original indices); 0 and empty otherwise. ``states``, ``held``,
    ``stops`` and ``compacted`` are tensors of the pool that later graphs
    read: they stay referenced here, or a later capture would reuse their
    memory."""

    inputs: Staging
    outputs: Staging
    segments: List[Captured]
    exits: List[Captured]
    states: List[lg.AdaptiveState]
    held: List[lg.AdaptiveState]
    stops: List[Optional[torch.Tensor]]
    prefix: int
    compaction: List[Captured]
    compacted: list


class GraphMatcher:
    """Padded batches -> ``models.lightglue.MatchOutput`` of numpy arrays,
    on one CUDA device, through one graph set per input signature. Its
    graphs replay on its own stream; ``launches`` sums the kernel launches
    its replays added. ``run_slots`` drives several of them as the slots of
    a mesh."""

    def __init__(self, conf: LightGlueConfig, params: nn.Params,
                 device: torch.device):
        self.conf, self.params = conf, params
        self.device = torch.device(device)
        self.adaptive = conf.depth_confidence > 0 or conf.width_confidence > 0
        self.sets: Dict[Signature, GraphSet] = {}
        self.launches: Dict[str, int] = {}
        with torch.cuda.device(self.device):
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.device)
            # each layer's (unconfident, valid) stop counts
            self._counts = torch.zeros((conf.n_layers, 2), dtype=torch.float32,
                                       pin_memory=self.device.type == "cuda")

    def warm(self, sig: Signature) -> None:
        """Capture ``sig``'s graph set unless it is captured already."""
        if sig not in self.sets:
            with torch.cuda.device(self.device):
                self._capture(sig)

    def __call__(self, inputs: Dict[str, Optional[np.ndarray]]) -> lg.MatchOutput:
        """``inputs``: numpy arrays under ``models.lightglue.forward``'s
        keyword names (a mask not given: all valid)."""
        return self.run(signature_of(inputs), [copy_inputs(inputs)])

    def run(self, sig: Signature, fills: Sequence[Fill]) -> lg.MatchOutput:
        """Replay ``sig``'s graph set (captured on first sight) on the
        inputs that ``fills``' one fill (the runners' one fill a slot)
        writes straight into its pinned staging arrays."""
        (fill,) = fills
        return run_slots([self], sig, [fill])[0]

    def _begin(self, sig: Signature, fill: Fill) -> GraphSet:
        """``sig``'s graph set with ``fill``'s inputs sent to the device."""
        with torch.cuda.device(self.device):
            gs = self.sets.get(sig) or self._capture(sig)
            with torch.cuda.stream(self.stream):
                fill(gs.inputs.host_np)
                gs.inputs.to_device()
        return gs

    def _replay(self, graph: Captured) -> None:
        graph.replay()
        for k, n in graph.counts.items():
            self.launches[k] = self.launches.get(k, 0) + n

    def _segment(self, gs: GraphSet, i: int) -> None:
        """Replay layer i (and the compaction after the prefix's last
        layer), then queue the copy of its stop counts to the host."""
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            self._replay(gs.segments[i])
            if i + 1 == gs.prefix:
                self._replay(gs.compaction[0])
            if gs.stops[i] is not None:
                self._counts[i].copy_(gs.stops[i], non_blocking=True)

    def _read_counts(self, i: int) -> List[float]:
        """Layer i's stop counts, once the stream has passed them."""
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            torch.cuda.current_stream(self.device).synchronize()
        return self._counts[i].tolist()

    def _finish(self, gs: GraphSet, graph: Captured) -> None:
        """Replay the graph that writes the outputs, queue their copy."""
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            self._replay(graph)
            gs.outputs.to_host()

    def _collect(self, gs: GraphSet, layers: int) -> lg.MatchOutput:
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            torch.cuda.current_stream(self.device).synchronize()
        out = {f: a.copy() for f, a in gs.outputs.host_np.items()}
        return lg.MatchOutput(out["matches0"], out["matches1"],
                              out["matching_scores0"], out["matching_scores1"],
                              layers, out["prune0"], out["prune1"])

    def _kwargs(self, tensors: Dict[str, torch.Tensor]) -> dict:
        return {name: tensors.get(name) for name in (
            "kpts0", "kpts1", "desc0", "desc1", "size0", "size1", "mask0",
            "mask1", "scales0", "oris0", "scales1", "oris1")}

    def _graph(self, fn: Callable[[], object]) -> Tuple[Captured, object]:
        """Capture ``fn`` into the matcher's pool; returns the graph and
        fn's result (tensors of the pool, rewritten by every replay)."""
        before = _build.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            result = fn()
        after = _build.launch_counts()
        counts = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        return Captured(graph, counts), result

    def _capture(self, sig: Signature) -> GraphSet:
        """Stage seeded inputs, run every step once eagerly, then capture
        them."""
        staged = Staging(input_specs(sig, self.conf.input_dim), self.device)
        copy_inputs(example_inputs(sig, self.conf.input_dim))(staged.host_np)
        staged.to_device()
        outputs = Staging(output_specs(sig), self.device)
        # every step once eagerly, outside the capture
        self._steps(sig, staged, outputs, lambda fn: (None, fn()))
        torch.cuda.synchronize(self.device)
        gs = self.sets[sig] = self._steps(sig, staged, outputs, self._graph)
        return gs

    def _steps(self, sig: Signature, staged: Staging, outputs: Staging,
               run: Callable[[Callable[[], object]], Tuple[object, object]]
               ) -> GraphSet:
        """Every step of ``sig``'s forward on the staged inputs, each
        through ``run(fn) -> (graph, fn's result)``: ``_graph`` captures,
        an eager run calls."""
        conf, params = self.conf, self.params
        kw = self._kwargs(staged.tensors)
        fused = lg._block_weights(params, conf)

        def write(out: lg.MatchOutput) -> None:
            for f in OUTPUTS:
                outputs.tensors[f].copy_(getattr(out, f))

        prefix = (conf.compaction_prefix if lg.twostage(conf, sig.m, sig.n)
                  else 0)
        gs = GraphSet(staged, outputs, [], [], [], [], [], prefix, [], [])
        if not self.adaptive:
            gs.segments.append(run(
                lambda: write(lg.forward_fixed(params, conf, **kw)))[0])
            return gs

        def compact(s):
            return lg.compact(params, conf, s, prefix, conf.compaction_bucket)

        def finish(i, s, full=None, ind=None):
            out = lg.adaptive_finish(params, conf, i + 1, s)
            if full is not None:
                out = lg.scatter_back(out, full.prune0, full.prune1, *ind)
            write(out)

        state = full = ind = None
        for i in range(conf.n_layers):
            def segment(i=i, prev=state):
                s = lg.adaptive_start(params, conf, **kw) if i == 0 else prev
                return lg.adaptive_layer(params, conf, i, s, fused)
            seg, (state, held, counts) = run(segment)
            gs.segments.append(seg)
            gs.states.append(state)
            gs.held.append(held)
            gs.stops.append(counts)
            if i + 1 <= prefix:  # a stop in the prefix compacts, then exits
                def exit_(i=i, s=held):
                    small, *idx = compact(s)
                    finish(i, small, s, idx)
                if i + 1 == prefix:
                    graph, (small, *ind) = run(lambda s=state: compact(s))
                    gs.compaction.append(graph)
                    gs.compacted.append((small, *ind))
                    full, state = state, small
            else:
                exit_ = functools.partial(finish, i, held, full, ind)
            gs.exits.append(run(exit_)[0])
        return gs


def run_slots(slots: Sequence[GraphMatcher], sig: Signature,
              fills: Sequence[Fill]) -> List[lg.MatchOutput]:
    """Replay ``sig``'s graph set on every slot (the batch's rows of slot k
    written by ``fills[k]``), each on its own device and stream. Adaptive:
    every slot replays layer i, then the host reads each slot's stop counts
    and pools them over the slots (``models.lightglue.pooled_stop``), and
    every slot replays the next layer or the exit, as the JAX loop pools its
    stop over a sharded batch. Returns each slot's outputs."""
    sets = [slot._begin(sig, fill) for slot, fill in zip(slots, fills)]
    first = slots[0]
    if not first.adaptive:
        i = first.conf.n_layers - 1
        graphs = [gs.segments[0] for gs in sets]
    else:
        for i in range(first.conf.n_layers):
            for slot, gs in zip(slots, sets):
                slot._segment(gs, i)
            if sets[0].stops[i] is not None and lg.pooled_stop(
                    first.conf, [slot._read_counts(i) for slot in slots]):
                break
        graphs = [gs.exits[i] for gs in sets]
    for slot, gs, graph in zip(slots, sets, graphs):
        slot._finish(gs, graph)
    return [slot._collect(gs, i + 1) for slot, gs in zip(slots, sets)]
