"""The work SuperPoint's forward needs, counted from the image's shape.

The convolutions' products, as ``chip_smoke.py::kernel_bounds`` (lines
4399-4441) counts the stem's (``fused_stem``: conv1a and conv1b at full
resolution; ``fused_block2``: conv2a and conv2b at 1/2), extended to the
rest of the published encoder and both heads: conv3a/b at 1/4, conv4a/b,
convPa, convPb, convDa and convDb at 1/8. Softmax, NMS, top-k and the
descriptor sampling are left out. Bytes: the image read once (fp32), the
keypoints, scores and descriptors written once, the weights read once.
"""

from __future__ import annotations

from typing import Dict

LAYERS = (  # (name, in, out, kernel, stride of the map it runs on)
    ("conv1a", 1, 64, 3, 1), ("conv1b", 64, 64, 3, 1),
    ("conv2a", 64, 64, 3, 2), ("conv2b", 64, 64, 3, 2),
    ("conv3a", 64, 128, 3, 4), ("conv3b", 128, 128, 3, 4),
    ("conv4a", 128, 128, 3, 8), ("conv4b", 128, 128, 3, 8),
    ("convPa", 128, 256, 3, 8), ("convPb", 256, 65, 1, 8),
    ("convDa", 128, 256, 3, 8), ("convDb", 256, None, 1, 8),
)


def flops(conf: Dict, h: int, w: int) -> float:
    """FLOPs of one (h, w) image."""
    total = 0.0
    for _, cin, cout, k, s in LAYERS:
        cout = conf["descriptor_dim"] if cout is None else cout
        total += 2.0 * (h // s) * (w // s) * cin * cout * k * k
    return total


def io_bytes(conf: Dict, h: int, w: int) -> float:
    """One image in, its keypoints out, and the weights once (fp32)."""
    k, d = conf["max_num_keypoints"], conf["descriptor_dim"]
    weights = sum(cin * (d if cout is None else cout) * kk * kk
                  + (d if cout is None else cout)
                  for _, cin, cout, kk, _ in LAYERS)
    return 4.0 * (h * w + k * (2 + 1 + d) + weights)
