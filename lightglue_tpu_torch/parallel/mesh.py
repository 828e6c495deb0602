"""Device meshes of slots (counterpart of lightglue_tpu/parallel/mesh.py).

The JAX package scales out by data parallelism over a ``jax.sharding.Mesh``:
pairs are sharded on the batch axis over every mesh axis, parameters are
replicated, and one program runs on every device. Here one process drives a
``Mesh`` of *slots*, each a ``torch.device``: ``shard_rows`` splits a batch
into one contiguous block a slot in row-major order (``P(tuple(
mesh.axis_names))``), ``replicate`` gives the parameters one copy a distinct
device, and ``gather`` brings the slots' results back in input order. Each
slot runs its own shard, also where one device fills several slots (the
CPU's tests; two slots on one card). What the JAX program computes over the
whole batch (the adaptive stop, the training loss's counts) is pooled on the
host by the callers (``models.lightglue.pooled_stop``, ``train``).

A mesh that names a card which is not there raises: nothing folds onto
another device. There is no multi-process form, as the JAX package has no
``jax.distributed`` code.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import nn

DeviceLike = Union[str, torch.device]


def _device(d: DeviceLike) -> torch.device:
    """``d`` as a device that exists in this process (``cuda`` without an
    index: the current card)."""
    dev = torch.device(d)
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.type != "cuda":
        raise ValueError(f"a mesh slot is a CPU or CUDA device, not {dev}")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    index = dev.index if dev.index is not None else (
        torch.cuda.current_device() if count else 0)
    if index >= count:
        raise ValueError(f"mesh slot {dev}: this process sees {count} CUDA "
                         f"device(s)")
    return torch.device("cuda", index)


class Mesh:
    """A grid of device slots with axis names (``jax.sharding.Mesh``'s
    ``devices`` and ``axis_names``). ``slots`` lists the devices in
    row-major order, the order ``shard_rows`` fills; a device may fill
    several slots. Hashable, so that runners can be cached per mesh."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim} mesh axes, names {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.slots: Tuple[torch.device, ...] = tuple(devices.reshape(-1))

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return len(self.slots)

    @property
    def distinct(self) -> List[torch.device]:
        """The mesh's devices, each once, in slot order."""
        return list(dict.fromkeys(self.slots))

    def _key(self):
        return self.slots, self.devices.shape, self.axis_names

    def __hash__(self) -> int:
        return hash(self._key())

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and other._key() == self._key()

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.slots]})"


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("data",),
              devices: Optional[Sequence[DeviceLike]] = None,
              shape: Optional[Sequence[int]] = None) -> Mesh:
    """Data-parallel mesh over the first ``n_devices`` of ``devices``
    (default: every visible card). A 2-axis mesh (``axis_names=("dcn",
    "data")``, the JAX package's hosts x chips layout) needs an explicit
    ``shape``; batches shard over every axis. ``devices`` may repeat a
    device. A device that is not there, or more devices than there are,
    raises."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not count:
            raise ValueError("no CUDA device is visible: give the mesh its "
                             "devices (devices=['cpu', ...] on the CPU)")
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = [_device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"{n_devices} devices asked, {len(devices)} there")
        devices = devices[:n_devices]
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    if shape is not None:
        if int(np.prod(shape)) != len(devices):
            raise ValueError(f"mesh shape {tuple(shape)} for {len(devices)} "
                             "devices")
        arr = arr.reshape(tuple(shape))
    elif len(axis_names) > 1:
        raise ValueError("multi-axis mesh needs an explicit shape")
    return Mesh(arr, axis_names)


def row_bounds(n: int, slots: int, even: bool = True) -> List[Tuple[int, int]]:
    """The [start, stop) rows of each slot's block of ``n`` rows: equal
    blocks (``even``: ``n`` must divide, as a sharded batch axis must), or
    blocks that differ by at most one row, the larger first."""
    if even and n % slots:
        raise ValueError(f"a batch of {n} does not divide over {slots} slots")
    base, extra = divmod(n, slots)
    bounds, start = [], 0
    for k in range(slots):
        stop = start + base + (k < extra)
        bounds.append((start, stop))
        start = stop
    return bounds


def shard_rows(mesh: Mesh, x) -> list:
    """One equal block of ``x``'s rows a slot (``row_bounds``), on the
    slot's device for tensors. ``x``: a tensor, a numpy array, None, or a
    dict, tuple or NamedTuple of them, split leaf by leaf."""
    return [_take(x, a, b, dev)
            for (a, b), dev in zip(row_bounds(_rows(x), mesh.size), mesh.slots)]


def _rows(x) -> int:
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        sizes = {_rows(v) for v in x if v is not None}
        sizes.discard(None)
        if len(sizes) != 1:
            raise ValueError(f"leaves of {len(sizes)} row counts")
        return sizes.pop()
    return None if x is None else x.shape[0]


def _take(x, a: int, b: int, dev: torch.device):
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _take(v, a, b, dev) for k, v in x.items()}
    if isinstance(x, tuple):
        parts = [_take(v, a, b, dev) for v in x]
        return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
    if isinstance(x, torch.Tensor):
        return x[a:b].to(dev)
    return x[a:b]


def replicate(mesh: Mesh, params: nn.Params) -> Dict[torch.device, nn.Params]:
    """``params`` on each distinct device of the mesh, in their own dtypes
    (each tensor itself where it lies there already; a leaf that is not a
    tensor, or no tree at all, as it is)."""
    return {dev: nn.map_params(params, lambda t: t.to(dev) if isinstance(
        t, torch.Tensor) else t) for dev in mesh.distinct}


def params_mesh(params: nn.Params) -> Mesh:
    """The one-slot mesh on the device that ``params`` lies on (the first
    tensor's)."""
    todo = [params]
    while todo:
        t = todo.pop(0)
        if isinstance(t, torch.Tensor):
            return make_mesh(devices=[t.device])
        if isinstance(t, dict):
            todo.extend(t.values())
    raise ValueError("a parameter tree without tensors has no device")


def gather(parts: list, device: Optional[DeviceLike] = None):
    """The slots' results concatenated on their rows, in slot order:
    tensors on ``device`` (default: the first part's), numpy arrays as
    numpy; dicts, tuples and NamedTuples leaf by leaf; a leaf that is not
    an array (an int such as ``stop``) must be the same in every part. One
    part comes back as it is (its tensors moved to ``device``)."""
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: gather([p[k] for p in parts], device) for k in first}
    if isinstance(first, tuple):
        leaves = [gather([p[i] for p in parts], device)
                  for i in range(len(first))]
        return type(first)(*leaves) if hasattr(first, "_fields") else tuple(leaves)
    if isinstance(first, torch.Tensor):
        dev = first.device if device is None else torch.device(device)
        if len(parts) == 1:
            return first.to(dev)
        return torch.cat([p.to(dev) for p in parts])
    if isinstance(first, np.ndarray):
        return first if len(parts) == 1 else np.concatenate(parts)
    if any(p != first for p in parts):
        raise ValueError(f"slots disagree on a scalar: {parts}")
    return first
