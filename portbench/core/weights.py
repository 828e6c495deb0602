"""Extractor weights drawn from the run's seed on the card.

Every leaf comes from one uniform draw of one ``torch.Generator`` on the
device, sliced in order, so the program's tree and the reference's own
copy of it are the same numbers, made in a few milliseconds. Conv weights
and biases follow torch's Conv2d default, U(-1/sqrt(fan_in),
1/sqrt(fan_in)), the weights times a gain.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# (path in the tree, shape, bound): U(-bound, bound)
Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], float]

# SuperPoint (published lightglue/superpoint.py): name -> (in, out, kernel)
SUPERPOINT = {
    "conv1a": (1, 64, 3), "conv1b": (64, 64, 3),
    "conv2a": (64, 64, 3), "conv2b": (64, 64, 3),
    "conv3a": (64, 128, 3), "conv3b": (128, 128, 3),
    "conv4a": (128, 128, 3), "conv4b": (128, 128, 3),
    "convPa": (128, 256, 3), "convPb": (256, 65, 1),
    "convDa": (128, 256, 3), "convDb": (256, None, 1),
}


def _conv(path, cin, cout, k, gain) -> List[Leaf]:
    """A conv's OIHW weight, U(+-gain / sqrt(fan_in)), and its bias,
    U(+-1 / sqrt(fan_in)) (a gain scales the weight only)."""
    bound = 1.0 / math.sqrt(cin * k * k)
    return [(path + ("w",), (cout, cin, k, k), gain * bound),
            (path + ("b",), (cout,), bound)]


def superpoint_leaves(conf: Dict) -> List[Leaf]:
    gain = conf.get("weight_scale", 1.0)
    out = []
    for name, (cin, cout, k) in SUPERPOINT.items():
        cout = conf["descriptor_dim"] if cout is None else cout
        out += _conv((name,), cin, cout, k, gain)
    return out


def tree(leaves: List[Leaf], seed: int, device) -> Dict:
    """The nested dict of float32 device tensors that ``leaves`` names."""
    g = torch.Generator(device=device)
    g.manual_seed((seed * 7919 + 17) % (1 << 63))
    u = torch.rand(sum(math.prod(s) for _, s, _ in leaves), generator=g,
                   device=device)
    out: Dict = {}
    i = 0
    for path, shape, bound in leaves:
        size = math.prod(shape)
        v = (u[i:i + size] * 2 - 1) * bound
        i += size
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v.reshape(shape).contiguous()
    return out
