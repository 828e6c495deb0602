"""Synthetic-supervision training for the matcher (counterpart of
lightglue_tpu/train.py).

The release checkpoints cannot be fetched, and the adaptive machinery (the
early exit on token confidence, the pruning on matchability) only means
something with trained confidence and matchability heads. This module
trains them on generated correspondence problems: each pair plants matches
among distractors and confusers (``synthetic_batch``), and the loss
supervises every layer's log assignment (the LightGlue NLL) and every
confidence head with the self-distillation target "does this layer's
assignment already agree with the last layer's?" (``matcher_loss``).

The hand-written kernels are forward-only, so training runs the plain
PyTorch ops (``conf.flash`` off) with autograd, in fp32 with TF32 off, as
the JAX trainer runs XLA in fp32. The optimizer is the JAX trainer's optax
chain written to the same numbers (``OptaxAdamW``): clip by global norm,
AdamW with optax's weight decay of 1e-4 on every leaf, and the
warmup-cosine schedule evaluated at the update's own count from 0.

    params, conf, history = train_synthetic(steps=1500, device="cuda")

``scripts/train_synthetic.py`` saves the result as a flat npz that
``weights.load_params`` reads. ``make_feed_train_step(..., mesh=)`` shards
each batch over the slots of a mesh (``parallel/mesh.py``), the loss still
the whole batch's.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from . import nn
from .configs import LightGlueConfig, lightglue_config
from .models import lightglue as lg
from .ops import assignment as asg
from .parallel.mesh import Mesh, shard_rows

# ---------------------------------------------------------------------------
# Synthetic correspondence problems
# ---------------------------------------------------------------------------


class SyntheticBatch(NamedTuple):
    kpts0: torch.Tensor  # (B, M, 2)
    kpts1: torch.Tensor  # (B, N, 2)
    desc0: torch.Tensor  # (B, M, D)
    desc1: torch.Tensor  # (B, N, D)
    size0: torch.Tensor  # (B, 2)
    size1: torch.Tensor  # (B, 2)
    gt_matches0: torch.Tensor  # (B, M) int32: index into image 1 or -1
    # SIFT-family extras (add_scale_ori presets); None otherwise
    scales0: Optional[torch.Tensor] = None  # (B, M)
    oris0: Optional[torch.Tensor] = None  # (B, M)
    scales1: Optional[torch.Tensor] = None  # (B, N)
    oris1: Optional[torch.Tensor] = None  # (B, N)

    def to(self, device) -> "SyntheticBatch":
        return SyntheticBatch(*(None if t is None else t.to(device)
                                for t in self))


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def synthetic_batch(
    generator: torch.Generator,
    batch: int,
    m: int,
    desc_dim: int = 256,
    image_size: Tuple[float, float] = (1024, 768),
    p_match: float = 0.5,
    desc_noise: float = 0.35,
    kpt_noise: float = 1.0,
    p_confuse: float = 0.6,
    difficulty_jitter: bool = True,
    with_scale_ori: bool = False,
    device=None,
) -> SyntheticBatch:
    """A batch of planted correspondence problems, drawn from ``generator``
    on ``device`` (default: the generator's), with the distributions of the
    JAX ``synthetic_batch`` (train.py:67-210; not its random stream).

    Matched point i of image 0 lands at slot ``perm[i]`` of image 1 with
    descriptor ``normalize(d0 + dn * unit noise)`` and keypoint ``T(k0) +
    jitter`` under a random similarity T per pair; a point whose image
    leaves the frame is unmatched. Unmatched slots hold distractors, a
    ``p_confuse`` share of them confusers (a noisy copy of another image-0
    descriptor at a random place), which only geometry can reject.
    ``difficulty_jitter`` draws p_match and desc_noise per pair.
    ``with_scale_ori`` adds scales and orientations, consistent with T for
    matched points and independent for the rest.

    ``synthetic.planted_pairs`` draws the same problems in numpy, so that
    the JAX package, the CPU port and the card see one seeded stream; this
    one draws on the card, where the training loop needs a batch a step
    without a host draw and copy, and adds the SIFT presets' scales and
    orientations."""
    g = generator
    dev = torch.device(device) if device is not None else g.device
    w, h = float(image_size[0]), float(image_size[1])
    wh = torch.tensor([w, h], device=dev)

    def uniform(*shape, lo=0.0, hi=1.0):
        return torch.rand(*shape, generator=g, device=dev) * (hi - lo) + lo

    def normal(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    kpts0 = uniform(batch, m, 2) * wh
    # per-pair similarity: rotation [-0.8, 0.8] rad, scale exp([-0.3, 0.26])
    theta = uniform(batch, 1, lo=-0.8, hi=0.8)
    scale = torch.exp(uniform(batch, 1, lo=-0.3, hi=0.26))
    t = (uniform(batch, 1, 2) - 0.5) * wh * 0.2
    c, s = torch.cos(theta) * scale, torch.sin(theta) * scale  # (B, 1)
    center = wh / 2
    x = kpts0 - center
    rx = c * x[..., 0] - s * x[..., 1]
    ry = s * x[..., 0] + c * x[..., 1]
    kpts1_geo = torch.stack([rx, ry], -1) + center + t
    kpts1_geo = kpts1_geo + kpt_noise * normal(batch, m, 2)

    if difficulty_jitter:
        p = uniform(batch, 1, lo=p_match * 0.4, hi=min(0.95, p_match * 1.6))
        dn = desc_noise * torch.exp(uniform(batch, 1, 1, lo=-0.8, hi=0.7))
    else:
        p = torch.full((batch, 1), p_match, device=dev)
        dn = torch.full((batch, 1, 1), desc_noise, device=dev)

    inside = ((kpts1_geo >= 0) & (kpts1_geo < wh)).all(-1)
    matched = (uniform(batch, m) < p) & inside
    perm = uniform(batch, m).argsort(-1)  # a random permutation a pair

    d0 = _unit(normal(batch, m, desc_dim))
    # unit noise directions: dn is the relative perturbation
    d1_matched = _unit(d0 + dn * _unit(normal(batch, m, desc_dim)))
    d1_distract = _unit(normal(batch, m, desc_dim))
    src = torch.randint(0, m, (batch, m), generator=g, device=dev)
    rows = torch.arange(batch, device=dev)[:, None]
    d_conf = _unit(d0[rows, src] + dn * _unit(normal(batch, m, desc_dim)))
    confuse = uniform(batch, m) < p_confuse
    d1_distract = torch.where(confuse[..., None], d_conf, d1_distract)
    kpts1_distract = uniform(batch, m, 2) * wh

    # scatter into image 1's slot order
    src1 = torch.where(matched[..., None], d1_matched, d1_distract)
    k1 = torch.where(matched[..., None],
                     torch.minimum(kpts1_geo.clamp(min=0), wh - 1),
                     kpts1_distract)
    desc1 = torch.zeros_like(d0)
    desc1[rows, perm] = src1
    kpts1 = torch.zeros_like(kpts0)
    kpts1[rows, perm] = k1
    gt = torch.where(matched, perm, -1).int()

    size = wh[None].repeat(batch, 1)
    extras = {}
    if with_scale_ori:
        lo, hi = math.log(1.6), math.log(32.0)
        s0 = torch.exp(uniform(batch, m, lo=lo, hi=hi))
        o0 = uniform(batch, m, lo=-math.pi, hi=math.pi)
        s1_m = s0 * scale * torch.exp(0.05 * normal(batch, m))
        o1_m = o0 + theta + 0.05 * normal(batch, m)
        o1_m = torch.remainder(o1_m + math.pi, 2 * math.pi) - math.pi
        s1_d = torch.exp(uniform(batch, m, lo=lo, hi=hi))
        o1_d = uniform(batch, m, lo=-math.pi, hi=math.pi)
        scales1, oris1 = torch.zeros_like(s0), torch.zeros_like(o0)
        scales1[rows, perm] = torch.where(matched, s1_m, s1_d)
        oris1[rows, perm] = torch.where(matched, o1_m, o1_d)
        extras = dict(scales0=s0, oris0=o0, scales1=scales1, oris1=oris1)
    return SyntheticBatch(kpts0, kpts1, d0, desc1, size, size.clone(), gt,
                          **extras)


# ---------------------------------------------------------------------------
# Deep-supervised loss
# ---------------------------------------------------------------------------


def forward_all_layers(params: nn.Params, conf: LightGlueConfig,
                       batch: SyntheticBatch):
    """Every layer's descriptors, stacked: ((L, B, M, D), (L, B, N, D)).
    The kernels have no backward: ``conf.flash`` must be off."""
    if conf.flash:
        raise ValueError("training runs the plain ops (the kernels are "
                         "forward-only): pass a conf with flash=False")
    desc0, desc1, enc0, enc1, _, _ = lg._prepare(
        params, conf, batch.kpts0, batch.kpts1, batch.desc0, batch.desc1,
        batch.size0, batch.size1, None, None,
        batch.scales0, batch.oris0, batch.scales1, batch.oris1)
    all0, all1 = [], []
    for i in range(conf.n_layers):
        desc0, desc1 = lg.transformer_layer(
            nn.index_params(params["transformers"], i), desc0, desc1, enc0,
            enc1, conf)
        all0.append(desc0)
        all1.append(desc1)
    return torch.stack(all0), torch.stack(all1)


class LossCounts(NamedTuple):
    """The whole batch's denominators of ``matcher_loss``, from its ground
    truth: matched points, unmatched points of image 0 and of image 1 (each
    at least 1), and the points of each image (the confidence BCE's
    means). A slot that computes its rows' numerators over these counts
    gives its share of the whole batch's loss."""

    matched: torch.Tensor
    un0: torch.Tensor
    un1: torch.Tensor
    points0: int
    points1: int

    def to(self, device) -> "LossCounts":
        return LossCounts(self.matched.to(device), self.un0.to(device),
                          self.un1.to(device), self.points0, self.points1)


def _unmatched1(gt_matches0: torch.Tensor, safe: torch.Tensor,
                n: int) -> torch.Tensor:
    """Image 1's unmatched columns: a column is unmatched iff no row maps
    to it (a scatter-add of the matched indicator counts duplicates, where
    a set would not)."""
    hit = torch.zeros(gt_matches0.shape[0], n, dtype=torch.int32,
                      device=gt_matches0.device)
    return ~(hit.scatter_add_(1, safe, (gt_matches0 >= 0).int()) > 0)


def _counts(matched: torch.Tensor, un1: torch.Tensor) -> LossCounts:
    return LossCounts(matched.sum().clamp(min=1),
                      (~matched).sum().clamp(min=1), un1.sum().clamp(min=1),
                      matched.numel(), un1.numel())


def loss_counts(batch: SyntheticBatch) -> LossCounts:
    """``batch``'s ``LossCounts`` (JAX train.py:264-280's sums)."""
    gt = batch.gt_matches0
    n = batch.kpts1.shape[1]
    return _counts(gt >= 0, _unmatched1(gt, gt.long().clamp(0, n - 1), n))


def assignment_nll(scores: torch.Tensor, gt_matches0: torch.Tensor,
                   counts: Optional[LossCounts] = None) -> torch.Tensor:
    """LightGlue's assignment loss for one layer. scores: (B, M+1, N+1) log
    assignment; gt_matches0: (B, M), -1 for unmatched. The matched pairs'
    mean NLL plus half the sum of the dustbin terms' means: unmatched rows
    to the dustbin column, and columns no match hits to the dustbin row.
    ``counts``: the means' denominators of a larger batch that these rows
    are a block of (default: these rows')."""
    b, mp1, np1 = scores.shape
    m, n = mp1 - 1, np1 - 1
    matched = gt_matches0 >= 0
    safe = gt_matches0.long().clamp(0, n - 1)
    un0 = ~matched
    un1 = _unmatched1(gt_matches0, safe, n)
    counts = counts or _counts(matched, un1)
    pos = torch.gather(scores[:, :m, :n], 2, safe[..., None])[..., 0]
    pos_loss = -torch.where(matched, pos, 0.0).sum() / counts.matched
    dust0 = scores[:, :m, -1]
    neg0 = -torch.where(un0, dust0, 0.0).sum() / counts.un0
    dust1 = scores[:, -1, :n]
    neg1 = -torch.where(un1, dust1, 0.0).sum() / counts.un1
    return pos_loss + 0.5 * (neg0 + neg1)


def matcher_loss(params: nn.Params, conf: LightGlueConfig,
                 batch: SyntheticBatch, confidence_weight: float = 1.0,
                 counts: Optional[LossCounts] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The mean over layers of the assignment NLL, plus the confidence
    heads' binary cross-entropy: the target of layer i's head is whether
    layer i's assignment (best column or dustbin) of a point is already the
    last layer's. The heads read detached descriptors (reference
    lightglue.py:547). Returns (loss, {"nll", "confidence_bce"}).

    ``counts``: the ``loss_counts`` of a larger batch that ``batch`` is a
    block of rows of; every term is then this block's share of that
    batch's loss (its sums over the whole batch's counts), so that the
    blocks' losses and gradients add up to the whole batch's."""
    all0, all1 = forward_all_layers(params, conf, batch)
    n_layers = conf.n_layers
    scores = [
        asg.match_assignment(nn.index_params(params["log_assignment"], i),
                             all0[i], all1[i])[0]
        for i in range(n_layers)]
    nll = torch.stack([assignment_nll(s, batch.gt_matches0, counts)
                       for s in scores]).mean()

    # the dustbin takes part in the argmax: otherwise an unmatchable
    # point's target is noise and its head cannot become confident
    final0 = scores[-1][:, :-1, :].argmax(2)
    final1 = scores[-1][:, :, :-1].argmax(1)
    eps = 1e-6
    bce_terms = []
    for i in range(n_layers - 1):
        tok = nn.index_params(params["token_confidence"], i)
        c0, c1 = lg.token_confidence(tok, all0[i].detach(), all1[i].detach())
        # bool targets until the product: ~t of a float is not 1 - t
        t0 = scores[i][:, :-1, :].argmax(2) == final0
        t1 = scores[i][:, :, :-1].argmax(1) == final1
        bce0 = -(t0 * torch.log(c0 + eps) + (~t0) * torch.log(1 - c0 + eps))
        bce1 = -(t1 * torch.log(c1 + eps) + (~t1) * torch.log(1 - c1 + eps))
        if counts is None:
            bce_terms.append(bce0.mean() + bce1.mean())
        else:
            bce_terms.append(bce0.sum() / counts.points0
                             + bce1.sum() / counts.points1)
    conf_loss = (torch.stack(bce_terms).mean() if bce_terms
                 else nll.new_zeros(()))
    total = nll + confidence_weight * conf_loss
    return total, {"nll": nll, "confidence_bce": conf_loss}


# ---------------------------------------------------------------------------
# The optimizer: optax.chain(clip_by_global_norm, adamw(schedule))
# ---------------------------------------------------------------------------


def warmup_cosine_schedule(lr: float, steps: int) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0.0, lr, min(100, steps // 10 +
    1), steps) as the JAX trainer builds it: linear from 0 over the warmup,
    then a cosine to 0 at ``steps``. Called with the update's count from 0,
    so the first update's rate is 0."""
    warmup = min(100, steps // 10 + 1)
    decay = steps - warmup
    if decay <= 0:
        raise ValueError(f"{steps} steps leave no decay after {warmup} "
                         "warmup steps (optax's cosine_decay_schedule "
                         "requires positive decay_steps)")

    def schedule(count: int) -> float:
        if count < warmup:
            return lr * count / warmup
        t = min(count - warmup, decay)
        return lr * 0.5 * (1 + math.cos(math.pi * t / decay))

    return schedule


def leaves(params: nn.Params) -> List[torch.Tensor]:
    """The tree's tensors in key order."""
    if isinstance(params, dict):
        return [t for v in params.values() for t in leaves(v)]
    return [params]


# the JAX trainer's optax numbers: clip_by_global_norm(1.0), adamw's b1, b2,
# eps (eps_root 0) and its default weight decay
MAX_NORM, B1, B2, EPS, WEIGHT_DECAY = 1.0, 0.9, 0.999, 1e-8, 1e-4


class OptaxAdamW:
    """The JAX trainer's ``optax.chain(clip_by_global_norm(1.0),
    adamw(schedule))`` over the tensors of ``params``, updated in place.

    Clipping is optax's: the gradients scale by 1 / norm only when the
    global norm is at least 1 (``clip_grad_norm_`` divides by norm + 1e-6
    always). AdamW is ``torch.optim.AdamW`` with optax's numbers: b1 0.9,
    b2 0.999, eps 1e-8 outside the root, and weight decay 1e-4 (optax's
    default; torch's is 1e-2) on every leaf, biases and
    LayerNorms included; p(1 - lr wd) - lr adam equals optax's p - lr (adam
    + wd p). The rate is ``schedule(count)`` for the update's count from 0,
    and Adam's moments take every update's gradient, the first one's too
    (whose rate is 0). A leaf without a gradient takes zeros, as a leaf the
    loss does not reach does in JAX."""

    def __init__(self, params: nn.Params, schedule: Callable[[int], float]):
        self.params = params
        self.leaves = leaves(params)
        for t in self.leaves:
            t.requires_grad_(True)
        self.schedule = schedule
        self.adamw = torch.optim.AdamW(self.leaves, lr=0.0, betas=(B1, B2),
                                       eps=EPS, weight_decay=WEIGHT_DECAY)
        self.count = 0

    def zero_grad(self) -> None:
        for t in self.leaves:
            t.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Clip the gradients, update the tensors; returns the global norm
        before clipping (a device scalar: no host sync)."""
        for t in self.leaves:
            if t.grad is None:
                t.grad = torch.zeros_like(t)
        grads = [t.grad for t in self.leaves]
        g_norm = torch.sqrt(sum((g * g).sum() for g in grads))
        keep = g_norm < MAX_NORM
        for g in grads:
            g.copy_(torch.where(keep, g, g / g_norm * MAX_NORM))
        self.adamw.param_groups[0]["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.count += 1
        return g_norm


def make_optimizer(params: nn.Params, lr: float = 2e-4,
                   steps: int = 1500) -> OptaxAdamW:
    """The JAX trainer's optimizer (train.py:417-424) over ``params``."""
    return OptaxAdamW(params, warmup_cosine_schedule(lr, steps))


# ---------------------------------------------------------------------------
# Training loop
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fp32_math():
    """Full fp32 products inside the block (TF32 off for matmuls and
    cuDNN), as the JAX trainer runs fp32."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def make_feed_train_step(conf: LightGlueConfig, optimizer: OptaxAdamW,
                         mesh: Optional[Mesh] = None):
    """step(data) -> {"loss", "nll", "confidence_bce"} (detached device
    scalars) on a caller's batch: the deep-supervised loss on
    ``optimizer.params``, backward, clip, update in place (JAX
    make_feed_train_step, train.py:364).

    With a ``mesh`` of several slots (``parallel/mesh.py``) the batch's rows
    shard over the slots in equal blocks, as the JAX step's jit over
    sharded data: each slot takes the loss of its rows over the whole
    batch's counts (``loss_counts``) on its device's copy of the
    parameters, so that the slots' losses and gradients add up to the whole
    batch's; the gradients are summed into the optimizer's tensors
    (``torch.cuda.comm.reduce_add`` across cards, plain accumulation where
    slots share a device), the optimizer steps once, and the other copies
    take the new values. A one-slot mesh is the step without one."""
    if mesh is not None and mesh.size > 1:
        return _mesh_feed_step(conf, optimizer, mesh)

    def step(data: SyntheticBatch) -> Dict[str, torch.Tensor]:
        with fp32_math():
            optimizer.zero_grad()
            loss, aux = matcher_loss(optimizer.params, conf, data)
            loss.backward()
            optimizer.step()
        return {"loss": loss.detach(),
                **{k: v.detach() for k, v in aux.items()}}

    return step


def mesh_backward(replicas: Dict[torch.device, nn.Params],
                  conf: LightGlueConfig, data: SyntheticBatch, mesh: Mesh
                  ) -> Dict[str, torch.Tensor]:
    """The whole batch's ``matcher_loss`` backward over the slots of
    ``mesh``: slot k's rows of ``data`` on ``replicas[its device]`` (whose
    tensors require gradients), each slot's share over the whole batch's
    counts, so that every copy's ``.grad`` accumulates the gradients of the
    slots on its device. Returns {"loss", "nll", "confidence_bce"}: the
    sums of the slots' shares (the whole batch's values), detached, on the
    first slot's device."""
    counts = loss_counts(data)
    total: Dict[str, torch.Tensor] = {}
    for dev, part in zip(mesh.slots, shard_rows(mesh, data)):
        loss, aux = matcher_loss(replicas[dev], conf, part,
                                 counts=counts.to(dev))
        loss.backward()
        for k, v in {"loss": loss, **aux}.items():
            v = v.detach().to(mesh.slots[0])
            total[k] = v if k not in total else total[k] + v
    return total


def _mesh_feed_step(conf: LightGlueConfig, optimizer: OptaxAdamW,
                    mesh: Mesh):
    home = optimizer.leaves[0].device
    replicas = {dev: optimizer.params if dev == home else nn.map_params(
        optimizer.params, lambda t: t.detach().to(dev).requires_grad_(True))
        for dev in mesh.distinct}
    others = [leaves(replicas[dev]) for dev in replicas if dev != home]
    cards = all(dev.type == "cuda" for dev in replicas) and home in replicas

    def step(data: SyntheticBatch) -> Dict[str, torch.Tensor]:
        with fp32_math():
            optimizer.zero_grad()
            for copy in others:
                for t in copy:
                    t.grad = None
            aux = mesh_backward(replicas, conf, data, mesh)
            for i, t in enumerate(optimizer.leaves):
                grads = [g for g in [t.grad] + [c[i].grad for c in others]
                         if g is not None]
                if len(grads) > 1 and cards:
                    t.grad = torch.cuda.comm.reduce_add(
                        grads, destination=home.index)
                elif grads:
                    t.grad = grads[0].to(home)
                    for g in grads[1:]:
                        t.grad += g.to(home)
            optimizer.step()
            with torch.no_grad():
                for copy in others:
                    for t, src in zip(copy, optimizer.leaves):
                        t.copy_(src)
        return {k: v.to(home) for k, v in aux.items()}

    return step


def make_train_step(conf: LightGlueConfig, optimizer: OptaxAdamW,
                    batch: int = 16, m: int = 512,
                    generator: Optional[torch.Generator] = None,
                    mesh: Optional[Mesh] = None):
    """step(data=None): as ``make_feed_train_step``'s (over ``mesh`` if
    given), on a synthetic batch of ``batch`` pairs of ``m`` points drawn
    from ``generator`` unless the caller gives one (JAX make_train_step,
    train.py:341)."""
    feed = make_feed_train_step(conf, optimizer, mesh)

    def step(data: Optional[SyntheticBatch] = None):
        if data is None:
            data = synthetic_batch(generator, batch, m,
                                   desc_dim=conf.input_dim,
                                   with_scale_ori=conf.add_scale_ori)
        return feed(data)

    return step


def train_synthetic(
    conf: Optional[LightGlueConfig] = None,
    steps: int = 1500,
    batch: int = 16,
    m: int = 512,
    lr: float = 2e-4,
    seed: int = 0,
    log_every: int = 100,
    params: Optional[nn.Params] = None,
    verbose: bool = True,
    device="cuda",
    step_ms: Optional[list] = None,
    mesh: Optional[Mesh] = None,
):
    """Train the matcher on synthetic correspondences on ``device`` (the
    card unless the caller asks for the CPU). Returns (params, the training
    conf, history: {"step", "loss", "nll", "confidence_bce"} at every
    ``log_every``-th step and the last).

    ``conf`` is made differentiable as the JAX trainer makes it (flash off,
    fp32, no adaptivity, no compaction). Without ``params`` the tree is
    ``models.lightglue.init_params`` from a generator seeded with ``seed``;
    batches come from a generator on ``device`` seeded with ``seed + 1``.
    The returned tree is new and detached (``prepared_blocks`` keys its
    weights by tensor identity and does not see edits in place); a given
    ``params`` is copied, never changed. ``step_ms``: a list that receives
    each step's milliseconds by CUDA events. ``mesh``: shard each batch
    over its slots (``make_feed_train_step``); the tree and the batches
    stay on ``device``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_synthetic runs on the card unless asked "
                           "(device='cpu'), and no CUDA device is available")
    conf = conf or lightglue_config("superpoint")
    train_conf = conf.replace(
        flash=False, mp=False, depth_confidence=-1.0, width_confidence=-1.0,
        compaction_bucket=0)
    if params is None:
        params = lg.init_params(train_conf, torch.Generator().manual_seed(seed))
    params = nn.map_params(params, lambda t: t.detach().to(
        device, torch.float32, copy=True))
    optimizer = make_optimizer(params, lr, steps)
    gen = torch.Generator(device).manual_seed(seed + 1)
    step = make_train_step(train_conf, optimizer, batch, m, gen, mesh)
    timed = step_ms is not None and device.type == "cuda"
    events = []
    history = []
    for i in range(steps):
        if timed:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        aux = step()
        if timed:
            ev[1].record()
            events.append(ev)
        if i % log_every == 0 or i == steps - 1:
            aux = {k: float(v) for k, v in aux.items()}
            history.append({"step": i, **aux})
            if verbose:
                print(f"step {i:5d}  loss {aux['loss']:.4f}  "
                      f"nll {aux['nll']:.4f}  conf {aux['confidence_bce']:.4f}",
                      flush=True)
    if timed:
        torch.cuda.synchronize(device)
        step_ms.extend(a.elapsed_time(b) for a, b in events)
    trained = nn.map_params(optimizer.params, lambda t: t.detach().clone())
    return trained, train_conf, history
