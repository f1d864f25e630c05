"""The port's Inception Score (``fmri_tpu_torch/metrics/inception.py``,
``inception_v3.py``, ``quality.inception_score_from_probs``) against the
JAX package's on the CPU, inputs from a numpy seed.

Tolerances: the proxy's probabilities 1e-6 absolute and the IS 1e-5
relative (fp32 convolutions in two libraries); the IS formula 1e-12 on the
same probabilities (the same numpy arithmetic); Inception-v3 logits 1e-4,
as ``tests/test_inception_v3.py`` holds the JAX forward to its torch oracle.
One JAX Inception-v3 forward serves this file (the ``v3`` fixture)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from make_torch_proxy_weights import proxy_state
from test_inception_v3 import make_state_dict
from torch_port_helpers import one_torch_thread  # noqa: F401

from fmri_tpu.metrics import inception as jax_inception
from fmri_tpu.metrics import inception_v3 as jax_v3_mod
from fmri_tpu.metrics.quality import inception_score_from_probs as jax_from_probs
from fmri_tpu_torch.metrics import inception, inception_v3
from fmri_tpu_torch.metrics.quality import inception_score_from_probs

V3_SIZE = 75  # torchvision's smallest input, every block still runs

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_committed_proxy_weights_are_the_jax_init():
    """``proxy_classifier.npz`` is bit for bit the JAX proxy's flax init from
    ``jax.random.key(1234)``, in the port's layout, and loads strictly."""
    want = proxy_state()
    with np.load(inception.PROXY_WEIGHTS) as got:
        assert sorted(got.files) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype == np.float32, k
            assert got[k].shape == want[k].shape and got[k].tobytes() == want[k].tobytes(), k
    assert sum(v.size for v in want.values()) == 222_248
    model = inception.ProxyClassifier()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in want.items()}, strict=True)


@pytest.mark.parametrize("size", [16, 64, 75, 100])
def test_same_pad_is_xla_same(size):
    """'SAME' at stride 2: 0 before and 1 after at an even size, 1 and 1 at
    75; ``nn.Conv2d(padding=1)`` would shift the taps at the even sizes."""
    x = torch.zeros(1, 3, size, size)
    pads = inception.same_pad(x, 3, 2).shape[-1] - size
    lo, hi = jax.lax.padtype_to_pads((size, size), (3, 3), (2, 2), "SAME")[0]
    assert pads == lo + hi and (lo, hi) == ((1, 1) if size % 2 else (0, 1))
    padded = inception.same_pad(torch.ones(1, 1, size, size), 3, 2)
    assert float(padded[0, 0, lo, lo]) == 1.0 and float(padded[0, 0, -1, -1]) == 0.0


@pytest.mark.parametrize("size", [16, 64, 75, 100])
def test_proxy_matches_jax(size):
    rng = np.random.default_rng(size)
    x = rng.uniform(0.0, 1.0, (10, size, size, 3)).astype(np.float32)
    want = jax_inception.classify(x)
    got = inception.classify(torch.from_numpy(x))
    assert got.dtype == want.dtype == np.float32 and got.shape == (10, 1000)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for splits in (1, 2):
        mean, std, proxy = inception.inception_score(torch.from_numpy(x), splits=splits)
        jmean, jstd, jproxy = jax_inception.inception_score(x, splits=splits)
        assert proxy is jproxy is True
        assert mean == pytest.approx(jmean, rel=1e-5)
        assert std == pytest.approx(jstd, rel=1e-5, abs=1e-12)
    assert inception.is_proxy() and jax_inception.is_proxy()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("splits", [1, 2])
def test_inception_score_from_probs_matches_jax(dtype, splits):
    logits = np.random.default_rng(5).normal(0.0, 3.0, (12, 40))
    probs = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(dtype)
    got, want = inception_score_from_probs(probs, splits), jax_from_probs(probs, splits)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert got[0] > 1.0


@pytest.fixture(scope="module")
def v3(tmp_path_factory):
    """Random torchvision-layout weights (``make_state_dict``: randomized BN
    statistics and affines, an ``AuxLogits`` head, ``num_batches_tracked``),
    3 images at 16 px, and the JAX forward once: the logits of the images
    upsampled to 75 px by ``jax.image.resize``."""
    path = str(tmp_path_factory.mktemp("v3") / "inception_v3.npz")
    np.savez(path, **make_state_dict(np.random.default_rng(0)))
    images = np.random.default_rng(1).uniform(-1, 1, (3, 16, 16, 3)).astype(np.float32)
    x75 = jax.image.resize(jnp.asarray(images), (3, V3_SIZE, V3_SIZE, 3), "bilinear")
    logits = jax.jit(jax_v3_mod.inception_v3_logits)(jax_v3_mod._load_params(path), x75)
    return path, images, np.asarray(x75), np.asarray(logits)


def test_inception_v3_logits_match_jax(v3):
    path, _, x75, want = v3
    model = inception_v3.load_model(path, torch.device("cpu"))
    with torch.no_grad():
        got = model(torch.from_numpy(x75).permute(0, 3, 1, 2)).numpy()
    assert np.max(np.abs(got - want)) < 1e-4, np.max(np.abs(got - want))


def test_classify_with_weights_matches_jax(v3, monkeypatch):
    """At a 75 px resize (as ``tests/test_inception_v3.py`` shrinks the JAX
    one): the port's chunks (2 + 1, the last one not padded) give the JAX
    probabilities; through ``FMRI_TPU_INCEPTION_NPZ`` the IS is Inception-v3's
    and not a proxy."""
    path, images, _, logits = v3
    monkeypatch.setattr(inception_v3, "INPUT_SIZE", V3_SIZE)
    want = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    got = inception_v3.classify_with_weights(path, torch.from_numpy(images), batch_size=2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    monkeypatch.setenv("FMRI_TPU_INCEPTION_NPZ", path)
    mean, std, proxy = inception.inception_score(torch.from_numpy(images), splits=1)
    assert proxy is False and not inception.is_proxy()
    assert mean == pytest.approx(jax_from_probs(want, 1)[0], rel=1e-5)
    monkeypatch.setenv("FMRI_TPU_INCEPTION_NPZ", path + ".missing")
    assert inception.is_proxy() and jax_inception.is_proxy()


def test_strict_loading(v3, tmp_path):
    """``AuxLogits.*`` and ``num_batches_tracked`` are skipped; a missing or
    an unknown tensor is refused."""
    path = v3[0]
    sd = inception_v3.state_from_npz(path)
    assert not any(k.startswith("AuxLogits") or k.endswith("num_batches_tracked")
                   for k in sd)
    assert set(sd) == set(inception_v3.InceptionV3().state_dict())
    with np.load(path) as raw:
        full = {k: raw[k] for k in raw.files}
    assert any(k.startswith("AuxLogits") for k in full)
    for name, edit in (("missing", lambda d: d.pop("fc.bias")),
                       ("unknown", lambda d: d.update({"Mixed_8a.conv.weight": d["fc.bias"]}))):
        bad = dict(full)
        edit(bad)
        bad_path = str(tmp_path / f"{name}.npz")
        np.savez(bad_path, **bad)
        with pytest.raises(RuntimeError, match="Missing key|Unexpected key"):
            inception_v3.load_model(bad_path, torch.device("cpu"))


def test_random_weights_load_strictly_and_stay_unit_scale(tmp_path):
    """The seeded weights the card's smoke scores with: torchvision's keys and
    shapes, positive running variances, logits of O(1) (no saturated
    softmax), the same draw for one seed."""
    sd = inception_v3.random_weights(seed=2)
    shapes = {k: tuple(v.shape) for k, v in inception_v3.InceptionV3().state_dict().items()}
    assert {k: v.shape for k, v in sd.items()} == shapes
    assert all((v > 0).all() for k, v in sd.items() if k.endswith("running_var"))
    path = str(tmp_path / "w.npz")
    np.savez(path, **sd)
    model = inception_v3.load_model(path, torch.device("cpu"))
    x = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (2, 3, V3_SIZE, V3_SIZE))
                         .astype(np.float32))
    with torch.no_grad():
        logits = model(x)
    assert bool(torch.isfinite(logits).all()) and 0.05 < float(logits.std()) < 10.0
    assert float(torch.softmax(logits, -1).max()) < 0.5
    again = inception_v3.random_weights(seed=2)
    assert all(np.array_equal(sd[k], again[k]) for k in sd)
