"""lightglue_tpu_torch.weights: JAX checkpoints into the port's parameters,
every key used and every shape checked; the reference LightGlue state
dicts (the layouts of tests/fixtures/*_lightglue.json) against the JAX
package's convert_lightglue."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from lightglue_tpu import configs as jconfigs
from lightglue_tpu import weights as jweights
from lightglue_tpu.models import lightglue as jlg
from lightglue_tpu_torch import configs, weights
from lightglue_tpu_torch.models import lightglue as lg

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "weights", "synthetic_superpoint_lightglue.npz")
SMALL = dict(n_layers=3, input_dim=128, descriptor_dim=128, num_heads=2)


@pytest.mark.parametrize("features", ["superpoint", "sift"])
def test_jax_init_params_convert_key_for_key(features):
    jconf = jconfigs.lightglue_config(features, **SMALL, fused_self=False,
                                      fused_cross=False)
    conf = configs.lightglue_config(features, **SMALL)
    flat = jweights.flatten_tree(jlg.init_params(jax.random.key(0), jconf))
    params = weights.from_jax_params(flat, conf)
    back = weights.flatten_params(params)
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], v)
    assert set(weights.expected_shapes(conf)) == set(flat)


def test_port_init_params_fit_the_expected_keys():
    conf = configs.lightglue_config("disk", **SMALL)
    params = lg.init_params(conf, torch.Generator().manual_seed(0))
    flat = weights.flatten_params(params)
    want = weights.expected_shapes(conf)
    assert {k: v.shape for k, v in flat.items()} == want


def test_missing_extra_and_misshapen_keys_raise():
    conf = configs.lightglue_config("superpoint", **SMALL)
    flat = weights.flatten_params(
        lg.init_params(conf, torch.Generator().manual_seed(1)))
    missing = dict(flat)
    missing.pop("posenc/Wr/w")
    with pytest.raises(KeyError, match="posenc/Wr/w"):
        weights.from_jax_params(missing, conf)
    with pytest.raises(KeyError, match="unexpected"):
        weights.from_jax_params({**flat, "extra/w": np.zeros(1)}, conf)
    bad = dict(flat)
    bad["log_assignment/final_proj/w"] = bad["log_assignment/final_proj/w"][:, :5]
    with pytest.raises(ValueError, match="final_proj"):
        weights.from_jax_params(bad, conf)


def test_in_repo_npz_loads_at_full_width():
    params = weights.load_params(NPZ)
    flat = weights.flatten_params(params)
    with np.load(NPZ) as f:
        assert set(f.files) == set(flat)
        for k in f.files:
            assert f[k].dtype == np.float16
            np.testing.assert_array_equal(flat[k], f[k].astype(np.float32))
    assert params["transformers"]["self_attn"]["Wqkv"]["w"].shape == (9, 256, 768)
    assert params["transformers"]["self_attn"]["Wqkv"]["w"].dtype == torch.float32


# --- the reference state dict (lightglue_tpu/weights.py:74-130) ---------------

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def _reference_dict(features, seed=0):
    """A seeded state dict with the keys and shapes of the reference
    LightGlue(features) (tests/fixtures/<features>_lightglue.json)."""
    with open(os.path.join(FIXTURES, f"{features}_lightglue.json")) as f:
        keys = json.load(f)["keys"]
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in keys.items()}


@pytest.mark.parametrize("features", ["superpoint", "aliked", "disk", "sift",
                                      "doghardnet"])
def test_from_state_dict_equals_convert_lightglue(features):
    """Each reference layout through JAX convert_lightglue + flatten_tree
    and through the port's from_state_dict: the same keys, equal to the
    bit (confidence_thresholds ignored by both); to_state_dict gives the
    dict back without it."""
    sd = _reference_dict(features)
    jconf = jconfigs.lightglue_config(features)
    want = jweights.flatten_tree(jweights.convert_lightglue(sd, jconf))
    conf = configs.lightglue_config(features)
    got = weights.flatten_params(weights.from_state_dict(sd, conf))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    back = weights.to_state_dict(weights.from_state_dict(sd, conf), conf)
    assert set(back) == set(sd) - {"confidence_thresholds"}
    for k, v in back.items():
        np.testing.assert_array_equal(v, sd[k], err_msg=k)


def test_legacy_keys_and_state_dict_params():
    """Legacy ``self_attn.{i}`` / ``cross_attn.{i}`` names renamed as JAX
    upgrade_legacy_keys renames them, and converted to the same tree as the
    current names; torch tensors accepted; a state dict passed to
    pipeline.LightGlue as params converts through from_state_dict; missing
    and unexpected keys raise."""
    from lightglue_tpu_torch import LightGlue

    conf = configs.lightglue_config("sift")
    sd = _reference_dict("sift", seed=1)
    legacy = {}
    for k, v in sd.items():
        for block in ("self_attn", "cross_attn"):
            pre = "transformers."
            if k.startswith(pre) and f".{block}." in k:
                i = k[len(pre):].split(".")[0]
                k = k.replace(f"transformers.{i}.{block}", f"{block}.{i}")
        legacy[k] = v
    assert legacy.keys() != sd.keys()
    mine = weights.upgrade_legacy_keys(legacy, conf.n_layers)
    theirs = jweights.upgrade_legacy_keys(legacy, conf.n_layers)
    assert list(mine) == list(theirs) and set(mine) == set(sd)
    assert all(mine[k] is theirs[k] for k in mine)
    want = weights.flatten_params(weights.from_state_dict(sd, conf))
    for src in (legacy, {k: torch.from_numpy(v) for k, v in sd.items()}):
        got = weights.flatten_params(weights.from_state_dict(src, conf))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    m = LightGlue("sift", params=sd, device="cpu")
    got = weights.flatten_params(m.params)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    missing = dict(sd)
    missing.pop("input_proj.weight")
    with pytest.raises(KeyError, match="input_proj.weight"):
        weights.from_state_dict(missing, conf)
    with pytest.raises(KeyError, match="unexpected"):
        weights.from_state_dict({**sd, "extra.weight": np.zeros(1)}, conf)
    with pytest.raises(KeyError, match="unexpected"):  # no input_proj at 256
        weights.from_state_dict(sd, configs.lightglue_config("superpoint"))
