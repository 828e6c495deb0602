"""lightglue_tpu_torch.utils.viz2d against the JAX package's module (Agg
backend): the colormaps equal to the bit on the same inputs, given as
numpy arrays and as tensors; the plots from tensors, as
tests/test_viz2d.py draws them from arrays; and the package imported with
matplotlib hidden, which the card's machine lacks."""

import os
import subprocess
import sys

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from lightglue_tpu.utils import viz2d as jviz  # noqa: E402
from lightglue_tpu_torch.utils import viz2d  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_RNG = np.random.default_rng(0)
# (colormap, input) pairs: in range, out of range, ties and empty
_CMAPS = (
    ("cm_RdGn", np.linspace(-0.5, 1.5, 41).astype(np.float32)),
    ("cm_RdGn", _RNG.uniform(0, 1, (7, 5))),
    ("cm_BlRdGn", np.linspace(-1.5, 1.5, 61)),
    ("cm_BlRdGn", _RNG.uniform(-1, 1, 33).astype(np.float32)),
    ("cm_prune", np.array([1, 5, 9, 10, 10, 3, 0], np.int32)),
    ("cm_prune", _RNG.integers(1, 10, 50)),
    ("cm_grad2d", _RNG.uniform(-0.5, 1.5, (40, 2))),
    ("cm_grad2d", np.array([[0.0, 0], [1, 0], [0, 1], [1, 1]], np.float32)),
    ("cm_grad2d", np.array([0.5, 0.5])),
    ("cm_ranking", _RNG.uniform(0, 1, 5000)),
    ("cm_ranking", np.zeros(0)),
)


@pytest.mark.parametrize("name, x", _CMAPS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(_CMAPS)])
def test_colormaps_equal_jax(name, x):
    want = getattr(jviz, name)(x)
    for arg in (x, torch.from_numpy(np.array(x))):
        got = getattr(viz2d, name)(arg)
        if name == "cm_ranking":
            assert got == want
        else:
            assert got.dtype == want.dtype and got.shape == want.shape
            assert got.tobytes() == want.tobytes()


def test_plots_take_tensors(tmp_path):
    """tests/test_viz2d.py's figure from tensors: the same artists as the
    JAX module draws from the arrays, and a file saved."""
    rng = np.random.default_rng(0)
    im0, im1 = rng.uniform(0, 1, (48, 64, 3)), rng.uniform(0, 1, (48, 64))
    k0, k1 = rng.uniform(0, 48, (20, 2)), rng.uniform(0, 48, (20, 2))
    figs = []
    for mod, t in ((jviz, np.asarray), (viz2d, torch.from_numpy)):
        fig, axs = mod.plot_images([t(im0), t(im1)], titles=["a", "b"])
        mod.plot_keypoints([t(k0), t(k1)], colors=["lime", "red"])
        mod.plot_matches(t(k0[:10]), t(k1[:10]))  # cm_grad2d colours
        mod.add_text(0, "stop after 9 layers")
        figs.append((fig, axs))
    (jfig, jaxs), (fig, axs) = figs
    assert len(fig.artists) == len(jfig.artists) == 10
    for a, b in zip(fig.artists, jfig.artists):
        assert a.get_edgecolor() == b.get_edgecolor()
    for ax, jax_ax in zip(axs, jaxs):
        np.testing.assert_array_equal(ax.images[0].get_array(),
                                      jax_ax.images[0].get_array())
        assert ax.get_xlim() == jax_ax.get_xlim()
        assert not ax.get_autoscale_on()
        for c, jc in zip(ax.collections, jax_ax.collections):
            np.testing.assert_array_equal(c.get_offsets(), jc.get_offsets())
            np.testing.assert_array_equal(c.get_facecolor(), jc.get_facecolor())
    out = tmp_path / "viz.png"
    plt.figure(fig.number)
    viz2d.save_plot(str(out))
    assert out.exists() and out.stat().st_size > 1000
    plt.close("all")


def test_package_imports_without_matplotlib():
    """With matplotlib unimportable, the package and every module but
    viz2d import (chip_smoke.py's imports among them), and none pulls in
    viz2d or matplotlib."""
    code = """
import importlib, pkgutil, sys
sys.modules["matplotlib"] = None
import lightglue_tpu_torch
names = [m.name for m in pkgutil.walk_packages(lightglue_tpu_torch.__path__,
                                               "lightglue_tpu_torch.")]
for name in names:
    if name != "lightglue_tpu_torch.utils.viz2d":
        importlib.import_module(name)
assert "lightglue_tpu_torch.utils.viz2d" not in sys.modules
assert not [m for m in sys.modules if m.startswith("matplotlib.")]
assert not [m for m in sys.modules if m == "jax" or m.startswith("lightglue_tpu.")]
try:
    import lightglue_tpu_torch.utils.viz2d
except ImportError:
    print("viz2d needs matplotlib", len(names))
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "viz2d needs matplotlib" in out.stdout
