"""lightglue_tpu_torch.weights: JAX checkpoints into the port's parameters,
every key used and every shape checked."""

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
