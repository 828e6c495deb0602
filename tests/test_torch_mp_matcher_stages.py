"""The matcher at mp stage by stage: the port's CPU path against the JAX
package at mp, each stage of each layer fed the same bf16 input.

The two-head matcher (``LightGlue("superpoint", mp=True, num_heads=2)``,
the trained layers regrouped by ``two_head_params``) lies farther from the
JAX matcher at mp than the four-head one (tests/test_torch_mp_head128.py).
This file asks where: it walks the port's own fixed forward layer by layer
on planted pairs, and at every stage hands the stage's bf16 input (the
port's output of the stage before) to both packages:

    self       B5 on each image (JAX: fused_self_block's Pallas kernel in
               interpret mode; the port: its bf16 plain version)
    proj       the cross block's to_qk and to_v (nn.linear in bf16, both)
    attn       the cross attention: B1' at two heads of 128, the same pair
               of walks at four heads of 64 (flash_cross_pair, Pallas in
               interpret mode against the plain version), valid rows
    out_proj   to_out on the merged heads (nn.linear in bf16, both)
    ffn        B4 on each image (Pallas fused_ffn_residual in interpret
               mode against the plain version)
    assign     the final assignment on the last layer's descriptors
               (fused_filter_matches, Pallas in interpret mode; the
               matching scores of image 0's valid points)

and reports the share of outputs more than one bf16 step (of JAX's value)
apart. A stage whose share is over 1e-3 at two heads and under it at four
would be a rounding point where the two-head path departs from the TPU
kernels; the test holds that no stage does so, and each stage under the
share it found. Tier 1 runs a cut of the matcher (B 1, 256 keypoints, one
layer); ``python tests/test_torch_mp_matcher_stages.py`` prints the table
at the matcher test's size (B 2, 512 keypoints, nine layers).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]
from test_torch_head128 import two_head_params  # noqa: E402
from test_torch_mp import _inputs  # noqa: E402

from lightglue_tpu import nn as jnn  # noqa: E402
from lightglue_tpu import weights as jweights  # noqa: E402
from lightglue_tpu.ops import assignment_fused as jfasg  # noqa: E402
from lightglue_tpu.ops import ffn as jffn  # noqa: E402
from lightglue_tpu.ops import flash as jflash  # noqa: E402
from lightglue_tpu.ops import flash_self as jflash_self  # noqa: E402
from lightglue_tpu_torch import configs, nn, weights  # noqa: E402
from lightglue_tpu_torch.models import lightglue as lg  # noqa: E402
from lightglue_tpu_torch.ops import assignment_fused, ffn, flash  # noqa: E402
from lightglue_tpu_torch.ops import flash_self  # noqa: E402
from lightglue_tpu_torch.ops.block_tc import merge_heads  # noqa: E402
from lightglue_tpu_torch.synthetic import planted_pairs  # noqa: E402

torch.set_num_threads(1)

NPZ = os.path.join(os.path.dirname(HERE), "weights",
                   "synthetic_superpoint_lightglue.npz")
STAGES = ("self", "proj", "attn", "out_proj", "ffn", "assign")
FAULT = 1e-3  # a share above this where the other head count is below


def bf16_step(x: np.ndarray) -> np.ndarray:
    """One bf16 step (unit in the last place) at |x|."""
    a = np.maximum(np.abs(x).astype(np.float32), np.float32(2.0 ** -126))
    return np.ldexp(np.float32(1.0), np.floor(np.log2(a)).astype(np.int32) - 7)


def share(got, want, rows=None) -> float:
    """The share of ``got``'s values more than one bf16 step of ``want``
    from it (rows: a boolean mask of the leading axes to compare)."""
    g = (got.float().numpy() if isinstance(got, torch.Tensor)
         else np.asarray(got, np.float32))
    w = np.asarray(want, np.float32)
    if rows is not None:
        g, w = g[rows], w[rows]
    return float((np.abs(g - w) > bf16_step(w)).mean())


def _j(t: torch.Tensor):
    """A port tensor as the same values in JAX (bf16 stays bf16)."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _jtree(p):
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), p)


def stage_shares(heads: int, b: int, n: int, layers: int, seed: int = 74):
    """{stage: largest share over the layers (and images)} of the port
    against JAX, each stage fed the port's own bf16 input, over ``layers``
    layers of the trained matcher at ``heads`` heads (two: regrouped) on
    ``b`` planted pairs of ``n`` keypoints, fixed, exact."""
    params = weights.load_params(NPZ)
    jparams = jweights.load_params(NPZ, dtype=np.float32)
    if heads == 2:
        params = two_head_params(params, torch.cat)
    conf = configs.lightglue_config(
        "superpoint", mp=True, num_heads=heads, depth_confidence=-1.0,
        width_confidence=-1.0)
    args = {k: torch.as_tensor(v) for k, v in _inputs(
        planted_pairs(np.random.default_rng(seed), b, n)).items()}
    tree = lg.compute_params(params, conf)
    x0, x1, enc0, enc1, _, _ = lg._prepare(tree, conf, **args)
    mask0, mask1 = args["mask0"], args["mask1"]
    fused = lg.prepared_blocks(params, conf)
    out = dict.fromkeys(STAGES, 0.0)

    def note(stage, value):
        out[stage] = max(out[stage], value)

    for i in range(layers):
        lp = nn.index_params(tree["transformers"], i)
        jp = _jtree(nn.index_params(params["transformers"], i))
        xs = []
        for x, enc, mask in ((x0, enc0, mask0), (x1, enc1, mask1)):
            got = flash_self.fused_self_block(fused[i][0], x, enc, mask)
            want = jflash_self.fused_self_block(
                jp["self_attn"], _j(x), _j(enc), heads, _j(mask),
                interpret=True)
            note("self", share(got, want))
            xs.append(got)
        x0, x1 = xs
        ca, jca = lp["cross_attn"], jp["cross_attn"]
        qv = []
        for x in (x0, x1):
            for name in ("to_qk", "to_v"):
                got = nn.linear(ca[name], x)
                note("proj", share(got, jnn.linear(jca[name], _j(x))))
                qv.append(lg._split_heads(got, heads))
        qk0, v0, qk1, v1 = qv
        m0, m1 = flash.flash_cross_pair(qk0, qk1, v0, v1, mask0, mask1)
        w0, w1 = jflash.flash_cross_pair(
            _j(qk0), _j(qk1), _j(v0), _j(v1), _j(mask0), _j(mask1),
            block_q=128, interpret=True)
        note("attn", share(m0, w0, mask0.numpy()[:, None].repeat(heads, 1)))
        note("attn", share(m1, w1, mask1.numpy()[:, None].repeat(heads, 1)))
        xs = []
        for x, m in ((x0, m0), (x1, m1)):
            merged = merge_heads(m)
            msg = nn.linear(ca["to_out"], merged)
            note("out_proj", share(msg, jnn.linear(jca["to_out"], _j(merged))))
            got = ffn.fused_ffn_residual(x, msg, ca["ffn"])
            want = jffn.fused_ffn_residual(_j(x), _j(msg), jca["ffn"],
                                           interpret=True)
            note("ffn", share(got, want))
            xs.append(got)
        x0, x1 = xs

    la = nn.index_params(params["log_assignment"], conf.n_layers - 1)
    d0, d1 = x0.float(), x1.float()
    inv = d0.shape[-1] ** -0.25
    md0 = nn.linear(la["final_proj"], d0) * inv
    md1 = nn.linear(la["final_proj"], d1) * inv
    z0 = nn.linear(la["matchability"], d0)[..., 0]
    z1 = nn.linear(la["matchability"], d1)[..., 0]
    got = assignment_fused.fused_filter_matches(
        md0, md1, z0, z1, conf.filter_threshold, mask0, mask1)
    want = jfasg.fused_filter_matches(
        _j(md0), _j(md1), _j(z0), _j(z1), conf.filter_threshold, _j(mask0),
        _j(mask1), interpret=True)
    # the matching scores of every valid point of image 0 (0 where a point
    # has no match in either package)
    note("assign", share(got[2], want[2], mask0.numpy()))
    return out


@pytest.fixture(scope="module")
def shares():
    return {h: stage_shares(h, b=1, n=256, layers=1) for h in (2, 4)}


# Each stage's share at the cut size (B 1, 256 keypoints, one layer), as
# found, with room for another CPU's BLAS: self 7.8e-3 at two heads and
# 1.25e-2 at four (B5's output is x + FFN, rounded once: where the two
# cancel, one step of the message is many steps of the output); proj,
# out_proj, attn and ffn 0 to 1.1e-4; assign 0. At the matcher test's size
# (B 2, 512 keypoints, nine layers) two heads and four show self 3.1e-3
# and 1.9e-3, proj 1.9e-5 and 2.3e-5, attn 1.8e-4 and 6.9e-5, out_proj
# 1.1e-5 and 1.5e-5, ffn 2.0e-4 and 1.2e-4, assign 0 and 0.
FOUND = dict(self=2e-2, proj=1e-4, attn=1e-3, out_proj=1e-4, ffn=1e-3,
             assign=1e-3)


@pytest.mark.parametrize("stage", STAGES)
def test_no_stage_departs_at_two_heads(shares, stage):
    """No stage is over FAULT at two heads where it is under it at four,
    and each stays under the share it showed."""
    two, four = shares[2][stage], shares[4][stage]
    print(f"{stage}: two heads {two:.2e}, four heads {four:.2e}")
    assert not (two > FAULT and four <= FAULT), (
        f"{stage}: {two:.2e} at two heads, {four:.2e} at four")
    assert two <= FOUND[stage] and four <= FOUND[stage], (two, four)


if __name__ == "__main__":
    for h in (2, 4):
        row = stage_shares(h, b=2, n=512, layers=9)
        print(f"{h} heads: " + ", ".join(f"{k} {v:.2e}" for k, v in
                                         row.items()), flush=True)
