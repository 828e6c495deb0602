"""lightglue_tpu_torch/scripts/compaction_accuracy.py against the JAX
package's scripts/compaction_accuracy.py on the CPU.

The helpers (``agreement``, ``gt_scores``) on the cases of
tests/test_compaction_accuracy.py and on random rows, equal to the JAX
script's; then one row (the trained matcher cut to 3 layers, 256
keypoints, bucket 128, prefix 1, B 2) on one JAX-drawn batch fed to both
scripts, the JAX script through its own ``main`` (its batch source and
config patched to that batch and depth, its matches read where it scores
them): in fp32 both paths' matches0 equal and the row equal number for
number.
"""

import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from lightglue_tpu import configs as jconfigs
from lightglue_tpu import train as jtrain
from lightglue_tpu_torch import configs
from lightglue_tpu_torch import train as T
from lightglue_tpu_torch import weights
from lightglue_tpu_torch.scripts import compaction_accuracy as ca

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "weights", "synthetic_superpoint_lightglue.npz")
_spec = importlib.util.spec_from_file_location(
    "jax_compaction_accuracy", os.path.join(ROOT, "scripts",
                                            "compaction_accuracy.py"))
jca = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jca)

LAYERS, M, BUCKET, PREFIX, B = 3, 256, 128, 1, 2


@pytest.mark.parametrize("test, ref", [
    ([[0, 1, -1, 3], [2, -1, -1, 0]], [[0, 1, -1, 3], [2, -1, -1, 0]]),
    ([[0, 1, -1, 2]], [[0, 1, 2, 3]]),
    ([[-1, -1]], [[-1, -1]]),
    ([[-1, 4]], [[3, -1]]),
])
def test_agreement_equals_jax(test, ref):
    test, ref = np.asarray(test), np.asarray(ref)
    assert ca.agreement(test, ref) == jca.agreement(test, ref)


def test_helpers_equal_jax_on_random_rows():
    rng = np.random.default_rng(0)
    for _ in range(20):
        gt = np.where(rng.uniform(size=(3, 40)) < 0.5, rng.integers(0, 40, (3, 40)), -1)
        m0 = np.where(rng.uniform(size=(3, 40)) < 0.3, rng.integers(0, 40, (3, 40)), gt)
        assert ca.gt_scores(m0, gt) == jca.gt_scores(m0, gt)
        assert ca.agreement(m0, gt) == jca.agreement(m0, gt)
    gt = np.asarray([[5, -1, 2, 3]])
    m0 = np.asarray([[5, 0, 2, -1]])
    assert ca.gt_scores(m0, gt) == jca.gt_scores(m0, gt) == {
        "gt_precision": round(2 / 3, 4), "gt_recall": round(2 / 3, 4)}


def _cut_npz(path) -> None:
    """The trained matcher's first LAYERS layers as a float32 npz."""
    with np.load(NPZ) as f:
        flat = {k: f[k].astype(np.float32) for k in f.files}
    for k, v in flat.items():
        if k.startswith(("transformers/", "log_assignment/")):
            flat[k] = v[:LAYERS]
        elif k.startswith("token_confidence/"):
            flat[k] = v[:LAYERS - 1]
    np.savez(path, **flat)


def test_one_row_equals_jax(tmp_path, monkeypatch, capsys):
    wpath = tmp_path / "cut.npz"
    _cut_npz(wpath)
    jbatch = jtrain.synthetic_batch(jax.random.key(1000), B, M)
    batch = T.SyntheticBatch(*(None if a is None else torch.from_numpy(
        np.array(a)) for a in jbatch))

    # the JAX script's main on that batch at LAYERS layers; its matches
    # (two-stage, then masked, a batch each) recorded as it scores them
    seen = []
    real_gt_scores, real_config = jca.gt_scores, jconfigs.lightglue_config
    monkeypatch.setattr(jca, "gt_scores",
                        lambda m0, gt: seen.append(np.array(m0)) or real_gt_scores(m0, gt))
    monkeypatch.setattr(jtrain, "synthetic_batch", lambda key, b, m: jbatch)
    monkeypatch.setattr(jconfigs, "lightglue_config",
                        lambda f, **kw: real_config(f, n_layers=LAYERS, **kw))
    out = tmp_path / "jax.json"
    monkeypatch.setattr(sys, "argv", [
        "compaction_accuracy.py", "--weights", str(wpath), "--kpts", str(M),
        "--buckets", str(BUCKET), "--prefix", str(PREFIX), "--batch", str(B),
        "--seeds", "1", "--out", str(out)])
    jca.main()
    (want,) = json.loads(out.read_text())["rows"]
    jtwo, jmasked = seen

    conf = configs.lightglue_config("superpoint", n_layers=LAYERS)
    params = weights.load_params(str(wpath), conf)
    (masked,) = ca.masked_matches(params, conf, [batch])
    (two,) = ca.twostage_matches(params, conf, [batch], PREFIX, BUCKET)
    np.testing.assert_array_equal(masked, jmasked)
    np.testing.assert_array_equal(two, jtwo)
    rows = ca.grid(params, conf, {M: [batch]}, [PREFIX], [BUCKET], log=print)
    assert rows == [want]
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == want
    assert want["overflow_frac"] > 0 and want["agreement"]["recall"] < 1


def test_refuses_benchmarks_dir():
    """The JSON goes only where --out says, never into benchmarks/ (the JAX
    script's rows); the check runs before anything touches the card."""
    with pytest.raises(SystemExit, match="benchmarks/"):
        ca.main(["--out", os.path.join(ROOT, "benchmarks", "rows.json")])
