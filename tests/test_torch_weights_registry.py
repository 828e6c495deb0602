"""The released-checkpoint registry of lightglue_tpu_torch (``weights.fetch``,
the shared npz cache, ``pretrained=True`` on every wrapper) against the JAX
package's, offline.

For each of the twelve registry entries a seeded state dict in the layout
``tests/fixtures/{name}.json`` pins (every value drawn, so that a
transposed axis shows; float32, as the release files are), wrapped as the
entry's ``unwrap`` expects, is saved as ``{name}.pth`` in two caches and
resolved by each package's ``fetch``: the two npz files are equal key for
key, in dtype and to the bit, and each package reads the other's npz into
its own direct conversion to the bit. The download branch runs against a
patched ``urllib.request.urlopen`` or ``_download``; no test reaches the
network. ``map_tensor`` and ``batch_to_device`` as
tests/test_weights_io.py:44 holds the JAX ones.
"""

import dataclasses
import importlib.util
import json
import urllib.error
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from lightglue_tpu import weights as jweights
from lightglue_tpu_torch import (ALIKED, DISK, DoGHardNet, DoGHardNetDevice,
                                 LightGlue, SuperPoint, batch_to_device,
                                 map_tensor, pipeline, weights)
from lightglue_tpu_torch.configs import FEATURES, ALIKEDConfig
from lightglue_tpu_torch.scripts import convert_weights

FIX = Path(__file__).parent / "fixtures"


def _seeded(name: str) -> dict:
    """A state dict in the fixture's layout, every value seeded (variances
    positive), as torch tensors."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    keys = json.loads((FIX / f"{name}.json").read_text())["keys"]
    sd = {}
    for k, shape in keys.items():
        a = rng.standard_normal(shape).astype(np.float32)
        sd[k] = torch.from_numpy(np.abs(a) + 0.5 if "running_var" in k else a)
    return sd


def _wrapped(name: str, sd: dict):
    """The checkpoint as the release file holds it: inside the first of
    the entry's unwrap keys (DISK's "extractor", HardNet's "state_dict")."""
    unwrap = weights.REGISTRY[name].unwrap
    return {unwrap[0]: sd, "epoch": 1} if unwrap else sd


def _offline(monkeypatch):
    def no_net(url, dest, retries=2, timeout=30.0):
        raise AssertionError(f"download of {url} attempted")

    monkeypatch.setattr(weights, "_download", no_net)
    monkeypatch.setattr(jweights, "_download", no_net)


def _npz(path: Path) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _assert_flat_bits(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


def _assert_tree_bits(got, want):
    """Port trees equal to the bit, every leaf of ``got`` a C-contiguous
    float32 tensor (the card's kernels refuse strided weights)."""
    _assert_flat_bits(weights.flatten_params(got), weights.flatten_params(want))
    stack = [got]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        else:
            assert node.dtype == torch.float32 and node.is_contiguous()


def test_registry_equals_jax():
    assert list(weights.REGISTRY) == list(jweights.REGISTRY)
    for name, spec in jweights.REGISTRY.items():
        assert dataclasses.asdict(weights.REGISTRY[name]) == dataclasses.asdict(
            spec), name
        assert spec.converter in weights._CONVERTERS
        assert (FIX / f"{name}.json").exists()
    for feats in FEATURES:
        assert f"{feats}_lightglue" in weights.REGISTRY
    assert weights.default_cache_dir() == Path(
        jweights.default_cache_dir()).resolve()


@pytest.mark.parametrize("name", list(jweights.REGISTRY))
def test_fetch_matches_jax(name, tmp_path, monkeypatch):
    """Each entry through both packages' fetch: the npz files equal to the
    bit, each package reading the other's npz into its direct conversion."""
    _offline(monkeypatch)
    ckpt = _wrapped(name, _seeded(name))
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    for d in (port_dir, jax_dir):
        d.mkdir()
        torch.save(ckpt, d / f"{name}.pth")
    got = weights.fetch(name, cache_dir=port_dir)
    want = jweights.fetch(name, cache_dir=jax_dir)
    port_npz, jax_npz = port_dir / f"{name}.npz", jax_dir / f"{name}.npz"
    _assert_flat_bits(_npz(port_npz), _npz(jax_npz))

    from_sd = weights._CONVERTERS[weights.REGISTRY[name].converter][0]
    direct = from_sd(weights._unwrap_state_dict(ckpt, weights.REGISTRY[name].unwrap),
                     weights._entry_conf(name))
    _assert_tree_bits(got, direct)
    for d in (port_dir, jax_dir):  # from here on only the npz files resolve
        (d / f"{name}.pth").unlink()
    _assert_tree_bits(weights.fetch(name, cache_dir=jax_dir), direct)
    _assert_tree_bits(weights.fetch(name, cache_dir=port_dir), direct)
    _assert_flat_bits(jweights.flatten_tree(jweights.fetch(name, cache_dir=port_dir)),
                      jweights.flatten_tree(want))
    for f in (port_npz, jax_npz):
        f.unlink()


def test_to_jax_params_inverts_every_reader():
    """``to_jax_params`` writes what each ``*_from_jax_params`` reads, and
    the conv weights HWIO as the JAX converters write them."""
    sd = _seeded("superpoint_v1")
    tree = weights.superpoint_from_state_dict(sd)
    flat = weights.to_jax_params(tree)
    np.testing.assert_array_equal(flat["conv1a/w"],
                                  sd["conv1a.weight"].numpy().transpose(2, 3, 1, 0))
    _assert_tree_bits(weights.superpoint_from_jax_params(flat), tree)
    for name, reader, conf in (
            ("aliked-t16", weights.aliked_from_jax_params,
             ALIKEDConfig(model_name="aliked-t16")),
            ("disk_depth", weights.disk_from_jax_params, None),
            ("hardnet_liberty_aug", weights.hardnet_from_jax_params, None),
            ("sift_lightglue", weights.from_jax_params,
             weights._entry_conf("sift_lightglue"))):
        from_sd = weights._CONVERTERS[weights.REGISTRY[name].converter][0]
        tree = from_sd(_seeded(name), conf)
        _assert_tree_bits(reader(weights.to_jax_params(tree), conf), tree)


def test_fetch_unknown_name_and_unreadable_checkpoint(tmp_path, monkeypatch):
    _offline(monkeypatch)
    with pytest.raises(KeyError, match="unknown weights"):
        weights.fetch("nonexistent_weights", cache_dir=tmp_path)
    torch.save({"epoch": 3}, tmp_path / "superpoint_v1.pth")
    with pytest.raises(weights.WeightsUnavailableError, match="not understood"):
        weights.fetch("superpoint_v1", cache_dir=tmp_path)
    assert not (tmp_path / "superpoint_v1.npz").exists()


def test_unwrap_state_dict():
    """Wrapper keys, a pickled module and DataParallel prefixes, as the JAX
    package's ``_unwrap_state_dict``."""
    module = torch.nn.Linear(3, 2)
    sd = {f"module.{k}": v for k, v in module.state_dict().items()}
    for obj, unwrap in ((sd, ()), ({"model": sd, "step": 5}, ("extractor", "model")),
                        (module, ())):
        got = weights._unwrap_state_dict(obj, unwrap)
        want = jweights._unwrap_state_dict(obj, unwrap)
        _assert_flat_bits(got, want)
        assert sorted(got) == ["bias", "weight"]


def test_download_through_urlopen(tmp_path, monkeypatch):
    """The download branch: the release URL read into ``{name}.pth`` (no
    ``.part`` left), converted and cached; a failing urlopen is retried,
    leaves no ``.part`` file and raises naming the cache path."""
    import io

    buf = io.BytesIO()
    torch.save(_seeded("superpoint_v1"), buf)
    asked = []

    def urlopen(url, timeout=None):
        asked.append(url)
        return io.BytesIO(buf.getvalue())

    monkeypatch.setattr(weights.urllib.request, "urlopen", urlopen)
    params = weights.fetch("superpoint_v1", cache_dir=tmp_path)
    assert asked == [weights.REGISTRY["superpoint_v1"].url]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "superpoint_v1.npz", "superpoint_v1.pth"]
    _assert_tree_bits(params, weights.superpoint_from_state_dict(
        _seeded("superpoint_v1")))

    class Broken(io.BytesIO):
        def read(self, *a):
            raise urllib.error.URLError("connection reset")

    calls = []

    def failing(url, timeout=None):
        calls.append(url)
        return Broken()

    monkeypatch.setattr(weights.urllib.request, "urlopen", failing)
    with pytest.raises(weights.WeightsUnavailableError, match="disk_depth.pth"):
        weights.fetch("disk_depth", cache_dir=tmp_path, retries=3)
    assert len(calls) == 3
    assert not list(tmp_path.glob("*.part"))
    assert not (tmp_path / "disk_depth.pth").exists()


# every wrapper's pretrained=True and the JAX package's name for it
_WRAPPERS = (
    [(lambda: SuperPoint(pretrained=True, device="cpu"), "superpoint_v1")]
    + [(lambda n=n: ALIKED(pretrained=True, model_name=n, device="cpu"), n)
       for n in ("aliked-t16", "aliked-n16", "aliked-n16rot", "aliked-n32")]
    + [(lambda: DISK(pretrained=True, device="cpu"), "disk_depth"),
       (lambda: DoGHardNet(pretrained=True, device="cpu"), "hardnet_liberty_aug"),
       (lambda: DoGHardNetDevice(pretrained=True, device="cpu"),
        "hardnet_liberty_aug")]
    + [(lambda f=f: LightGlue(f, pretrained=True, device="cpu"), f"{f}_lightglue")
       for f in sorted(FEATURES)])


@pytest.mark.parametrize("make, name", _WRAPPERS,
                         ids=[f"{n}-{i}" for i, (_, n) in enumerate(_WRAPPERS)])
def test_pretrained_resolves_through_fetch(make, name, tmp_path, monkeypatch):
    """pretrained=True asks ``weights.fetch`` for the JAX package's name
    (lightglue_tpu/pipeline.py:211, 237, 263, 369, 432, 460) and takes the
    tree it returns; offline the error propagates and no random weights
    are drawn."""
    asked = []
    real = weights.fetch

    def recorded(n, cache_dir=None, retries=2):
        asked.append(n)
        return real(n, cache_dir=tmp_path)

    ckpt = _wrapped(name, _seeded(name))
    torch.save(ckpt, tmp_path / f"{name}.pth")
    monkeypatch.setattr(weights, "fetch", recorded)
    _offline(monkeypatch)
    wrapper = make()
    assert asked == [name]
    params = (wrapper._hardnet.params if isinstance(wrapper, DoGHardNet)
              else wrapper.params)
    _assert_tree_bits(params, real(name, cache_dir=tmp_path))

    def offline(n, cache_dir=None, retries=2):
        raise weights.WeightsUnavailableError("offline")

    monkeypatch.setattr(weights, "fetch", offline)
    drawn = []
    monkeypatch.setattr(torch, "Generator", lambda *a, **k: drawn.append(1))
    with pytest.raises(weights.WeightsUnavailableError):
        make()
    assert not drawn


def test_pretrained_offline_names_the_cache(tmp_path, monkeypatch):
    """Through the real fetch with an empty cache and urlopen failing: the
    error names where to put the file."""
    def refused(url, timeout=None):
        raise urllib.error.URLError("no network")

    monkeypatch.setattr(weights.urllib.request, "urlopen", refused)
    monkeypatch.setattr(weights, "default_cache_dir", lambda: tmp_path)
    with pytest.raises(weights.WeightsUnavailableError,
                       match="superpoint_lightglue.pth"):
        LightGlue("superpoint", pretrained=True, device="cpu")
    assert not list(tmp_path.iterdir())


def test_map_tensor_and_batch_to_device():
    data = {"a": np.ones((2, 3)), "b": [np.zeros((1,)), "keep"], "c": 5,
            "d": (torch.arange(3),)}
    doubled = map_tensor(data, lambda t: t * 2)
    np.testing.assert_array_equal(doubled["a"], 2 * np.ones((2, 3)))
    assert doubled["b"][1] == "keep" and doubled["c"] == 5
    assert isinstance(doubled["d"], tuple)
    assert torch.equal(doubled["d"][0], torch.arange(3) * 2)
    dev = batch_to_device(data, device="cpu")
    assert isinstance(dev["a"], torch.Tensor) and dev["a"].device.type == "cpu"
    np.testing.assert_array_equal(dev["a"].numpy(), data["a"])
    assert dev["b"][1] == "keep" and dev["c"] == 5
    assert pipeline.batch_to_device is batch_to_device
    if torch.cuda.is_available():
        assert batch_to_device(data)["a"].device.type == "cuda"
    else:  # the default is the card
        with pytest.raises((AssertionError, RuntimeError)):
            batch_to_device(data)


def _script(path: Path):
    spec = importlib.util.spec_from_file_location("jax_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("model, name, features", [
    ("lightglue", "sift_lightglue", "sift"),
    ("superpoint", "superpoint_v1", "superpoint"),
    ("aliked", "aliked-t16", "superpoint"),
    ("aliked", "aliked-n32", "superpoint"),
    ("disk", "disk_depth", "superpoint"),
    ("hardnet", "hardnet_liberty_aug", "superpoint"),
])
def test_convert_weights_script_equals_jax(model, name, features, tmp_path,
                                           monkeypatch):
    """The port's convert_weights CLI on a seeded checkpoint as the release
    file wraps it writes the npz the JAX package's script writes from the
    bare state dict (which it needs: it unwraps nothing), to the bit."""
    sd = _seeded(name)
    torch.save(sd, tmp_path / "bare.pth")
    torch.save(_wrapped(name, sd), tmp_path / "release.pth")
    monkeypatch.setattr("sys.argv", [
        "convert_weights.py", model, str(tmp_path / "bare.pth"),
        str(tmp_path / "jax.npz"), "--features", features])
    _script(FIX.parent.parent / "scripts" / "convert_weights.py").main()
    convert_weights.main(
        [model, str(tmp_path / "release.pth"), str(tmp_path / "port.npz"),
         "--features", features])
    _assert_flat_bits(_npz(tmp_path / "port.npz"), _npz(tmp_path / "jax.npz"))
