"""The work counters against hand counts."""

import pytest

from portbench.work import lightglue, superpoint

CONF = {"input_dim": 256, "descriptor_dim": 256, "n_layers": 9,
        "num_heads": 4, "depth_confidence": -1.0, "width_confidence": -1.0}


def step_forward(d: int, layers: int, m: int) -> float:
    """The forward third of ``train_synthetic.py::step_flops`` (lines
    48-63), written out: ``m`` points in each image, every layer run."""
    n, rows = m, 2 * m
    ffn = 2 * (2 * d) * (2 * d) + 2 * (2 * d) * d
    self_block = 2 * (2 * n * d * 3 * d + 2 * 2 * n * n * d + 2 * n * d * d
                      + n * ffn)
    cross_block = 3 * 2 * rows * d * d + 3 * 2 * m * n * d + rows * ffn
    assign = 2 * rows * d * d + 2 * m * n * d
    return layers * (self_block + cross_block + assign)


@pytest.mark.parametrize("m", [512, 2048])
def test_fixed_matcher_is_step_flops_forward(m):
    # step_flops counts an assignment head in every layer; the forward
    # runs the last one only
    d, L = 256, 9
    extra_heads = (L - 1) * (2 * 2 * m * d * d + 2 * m * m * d)
    got = lightglue.flops(CONF, [(m, m)] * L)
    assert got == step_forward(d, L, m) - extra_heads


def test_adaptive_counts_tests_and_pruning():
    conf = dict(CONF, depth_confidence=0.95, width_confidence=0.99)
    act = [(1000, 900), (800, 700), (600, 500)]
    d = 256
    fixed = lightglue.flops(CONF, act)
    # three stop tests (token confidence) and two pruning passes
    extra = sum(2 * d * (a + b) for a, b in act) + sum(
        2 * d * (a + b) for a, b in act[:2])
    assert lightglue.flops(conf, act) == fixed + extra


def test_superpoint_stem_is_kernel_bounds():
    # chip_smoke.py::kernel_bounds: fused_stem img * 2 * 9 * (64 + 64 * 64)
    # and fused_block2 img / 4 * 2 * 9 * (2 * 64 * 64) at img = H W
    h, w = 768, 1024
    img = h * w
    stem = img * 2 * 9 * (64 + 64 * 64) + img // 4 * 2 * 9 * (2 * 64 * 64)
    conf = {"descriptor_dim": 256}
    total = superpoint.flops(conf, h, w)
    heads = 2 * img / 64 * (9 * 128 * 256 * 2 + 256 * 65 + 256 * 256)
    mid = 2 * img / 16 * 9 * (64 * 128 + 128 * 128) + \
        2 * img / 64 * 9 * 2 * 128 * 128
    assert total == pytest.approx(stem + mid + heads, rel=1e-12)
