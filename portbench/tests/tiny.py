"""Cells cut to a size the CPU tests can run (the tests' rehearsal)."""

import copy

from portbench.core import layout


def cell(name: str, **traffic):
    """``name``'s cell with its traffic and keypoints cut down."""
    c = layout.Cell(name)
    c.config = copy.deepcopy(c.config)
    if c.traffic["kind"] == "planted_pairs":
        c.traffic = dict(c.traffic, keypoints=[200, 300], requests=2,
                         pairs_per_request=min(
                             c.traffic["pairs_per_request"], 5))
        c.config["matcher"]["pruning_min_kpts"] = 100
    else:
        c.traffic = dict(c.traffic, height=64, width=96, pairs_per_request=2,
                         requests=2)
        c.config["extractor"]["max_num_keypoints"] = 64
    c.traffic.update(traffic)
    return c
