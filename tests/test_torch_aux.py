"""The auxiliary losses (``fmri_tpu_torch/losses/aux_losses.py``) and the
generic supervised loops (``fmri_tpu_torch/train/supervised.py``) against
the JAX package's, on the CPU.

Losses: the same seeded numpy inputs through both packages' functions,
NHWC images; the feature losses over the proxy extractor (numpy draws its
weights the same way in both packages) and over VGG19 from one seeded npz
that ``FMRI_TPU_VGG19_NPZ`` names for both. Values within 1e-5 relative
(atol 1e-6), and the port's gradient of each image loss against
``jax.grad`` (rtol 1e-4 on the largest element).

Loops: for each ``MODE_ROUTES`` mode a module of both packages over the same
seeded groups (the converter's kinds; ``cogenc``/``decoder`` a
VoxelDecoder, fmri -> image; ``encoder`` a VisualEncoder, image -> the fMRI
vector's first ``latent`` entries; ``vae``/``autoencoder`` a
CognitiveEncoder, fmri -> its own first entries), two epochs of
``run_epoch`` over 16 examples at batch 8 with RMSprop moments at ones, then
``run_validation``: the epoch losses within 1e-5 relative, every parameter
within 1e-3 of the JAX step's movement (L2), the BatchNorm statistics within
1e-5, the validation loss within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmri_tpu.configs import presets as jax_presets
from fmri_tpu.data.pipeline import Batches as JaxBatches
from fmri_tpu.losses import aux_losses as jax_aux
from fmri_tpu.models import nets as jax_nets
from fmri_tpu.train import supervised as jax_sup
from fmri_tpu.train.optim import RmsProp as JaxRmsProp
from fmri_tpu.train.optim import RmsState
from fmri_tpu.train.state import TrainState as JaxTrainState
from fmri_tpu_torch.checkpoints import convert
from fmri_tpu_torch.configs import presets
from fmri_tpu_torch.data.pipeline import Batches, device_iterator
from fmri_tpu_torch.losses import aux_losses, vgg19
from fmri_tpu_torch.models import nets
from fmri_tpu_torch.train import supervised
from fmri_tpu_torch.train.optim import RmsProp
from torch_port_helpers import one_torch_thread  # noqa: F401

JCFG, CFG = jax_presets.get_config("tiny"), presets.get_config("tiny")

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _close(got, ref, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(ref), rtol=rtol, atol=1e-6)


def _images(seed, b=4, s=32):
    return np.random.default_rng(seed).uniform(-1, 1, (b, s, s, 3)).astype(np.float32)


@pytest.fixture
def vgg_env(tmp_path, monkeypatch):
    path = str(tmp_path / "vgg19_features.npz")
    np.savez(path, **vgg19.random_weights(1))
    monkeypatch.setenv("FMRI_TPU_VGG19_NPZ", path)
    return path


def test_pixel_and_voxel_losses_match_jax(monkeypatch):
    monkeypatch.delenv("FMRI_TPU_VGG19_NPZ", raising=False)
    rng = np.random.default_rng(0)
    v_pred, v_true = (rng.normal(size=(5, 40)).astype(np.float32) for _ in range(2))
    _close(aux_losses.voxel_loss(torch.from_numpy(v_pred), torch.from_numpy(v_true)),
           jax_aux.voxel_loss(v_pred, v_true))
    a, b = _images(1), _images(2)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    _close(aux_losses.norm_image_prediction(ta), jax_aux.norm_image_prediction(a))
    _close(aux_losses.image_loss(ta, tb), jax_aux.image_loss(a, b))
    for name in ("total_variation_loss", "total_variation_l1", "total_variation_l2"):
        _close(getattr(aux_losses, name)(ta), getattr(jax_aux, name)(a))
    # a row of zeros: the cosine divides by max(|a| |b|, eps), no NaN
    zero = np.zeros((2, 40), np.float32)
    _close(aux_losses.voxel_loss(torch.from_numpy(zero), torch.from_numpy(v_true[:2])),
           jax_aux.voxel_loss(zero, v_true[:2]))


@pytest.mark.parametrize("extractor", ["proxy", "vgg19"])
def test_feature_losses_match_jax(extractor, request, monkeypatch):
    """feature_loss at depths 1 and 2, feature_cosine_loss over the five
    depths, and the proxy at every depth, through the default extractor."""
    if extractor == "vgg19":
        request.getfixturevalue("vgg_env")
    else:
        monkeypatch.delenv("FMRI_TPU_VGG19_NPZ", raising=False)
        for depth in range(1, 6):
            x = _images(3)
            _close(aux_losses.proxy_feature_fn(torch.from_numpy(x), depth),
                   jax_aux.proxy_feature_fn(x, depth), rtol=1e-4)
    a, b = _images(4), _images(5)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for depth in (1, 2):
        _close(aux_losses.feature_loss(ta, tb, depth=depth),
               jax_aux.feature_loss(a, b, depth=depth))
    _close(aux_losses.feature_cosine_loss(ta, tb), jax_aux.feature_cosine_loss(a, b))

    # the gradient each loss gives the prediction
    ta.requires_grad_(True)
    for port_fn, jax_fn in ((lambda p: aux_losses.feature_loss(p, tb),
                             lambda p: jax_aux.feature_loss(p, b)),
                            (lambda p: aux_losses.feature_cosine_loss(p, tb),
                             lambda p: jax_aux.feature_cosine_loss(p, b))):
        got, = torch.autograd.grad(port_fn(ta), ta)
        ref = np.asarray(jax.grad(jax_fn)(jnp.asarray(a)))
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-4 * np.abs(ref).max())


# ------------------------------------------------------------ supervised


def _mse(out, gt):
    return (out - gt) ** 2


MODES = {  # mode: (JAX module, port module, converter kind, group, prefix, loss)
    "cogenc": (jax_nets.VoxelDecoder, nets.VoxelDecoder, "exp-decoder", "decoder",
               lambda out, gt: _mse(out, gt).mean()),
    "decoder": (jax_nets.VoxelDecoder, nets.VoxelDecoder, "exp-decoder", "decoder",
                lambda out, gt: _mse(out, gt).mean()),
    "encoder": (jax_nets.VisualEncoder, nets.VisualEncoder, "vae-gan", "encoder",
                lambda out, gt: _mse(out[0], gt[:, :out[0].shape[1]]).mean()),
    "vae": (jax_nets.CognitiveEncoder, nets.CognitiveEncoder, "vae-gan-cognitive-eval",
            "encoder", lambda out, gt: _mse(out[0], gt[:, :out[0].shape[1]]).mean()
            + 0.1 * (out[1] ** 2).mean()),
}
MODES["autoencoder"] = MODES["vae"]


def _groups_to_port(kind, group_name, group):
    """One group of ``kind`` as its module's own state dict."""
    sd = convert.from_jax_groups({g: group if g == group_name else v for g, v in
                                  convert.random_groups(CFG, 0, kind).items()}, CFG, kind)
    prefix = group_name + "."
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


@pytest.mark.parametrize("mode", sorted(supervised.MODE_ROUTES))
def test_supervised_loops_match_jax(mode):
    jmod_cls, mod_cls, kind, group_name, loss = MODES[mode]
    group = convert.random_groups(CFG, 3, kind)[group_name]
    rng = np.random.default_rng(4)
    data = {"fmri": rng.normal(size=(16, CFG.model.num_voxels)).astype(np.float32),
            "image": rng.uniform(-1, 1, (16, 16, 16, 3)).astype(np.float32)}
    if supervised.MODE_ROUTES[mode][0] is None:
        data = data["fmri"]  # the batch is the input and the target
    lr = 1e-2

    jmod = jmod_cls(JCFG.model)
    jstate = JaxTrainState(
        params={"model": group["params"]}, batch_stats={"model": group["batch_stats"]},
        opt_state={"model": RmsState(jax.tree_util.tree_map(np.ones_like, group["params"]))},
        step=jnp.zeros((), jnp.int32))
    jtrain, jeval = jax_sup.make_supervised_step(
        jmod, JaxRmsProp(0.9, 1e-8), loss, mode, lr_schedule=lambda s: jnp.float32(lr))

    mod = mod_cls(CFG.model)
    mod.load_state_dict(_groups_to_port(kind, group_name, group), strict=True)
    state = supervised.make_supervised_state(mod, RmsProp(0.9, 1e-8))
    for v in state.opt_state["model"].values():
        v.fill_(1.0)
    start = {k: v.clone() for k, v in mod.state_dict().items()}
    train, evaluate = supervised.make_supervised_step(
        mod, RmsProp(0.9, 1e-8), loss, mode,
        lr_schedule=lambda s: torch.tensor(lr, device=s.device))

    cpu = torch.device("cpu")
    for _ in range(2):
        jstate, jm = jax_sup.run_epoch(jtrain, jstate, iter(JaxBatches(data, 8)))
        state, m = supervised.run_epoch(train, state, device_iterator(
            iter(Batches(data, 8)), cpu))
        assert sorted(m) == sorted(jm) == ["loss", "lr"]
        assert m["loss"] == pytest.approx(jm["loss"], rel=1e-5)
    assert int(state.step) == int(jstate.step) == 4
    jv = jax_sup.run_validation(jeval, jstate, iter(JaxBatches(data, 8)))
    v = supervised.run_validation(evaluate, state, device_iterator(iter(Batches(data, 8)), cpu))
    assert v["loss"] == pytest.approx(jv["loss"], rel=1e-5)

    ref = _groups_to_port(kind, group_name, {"params": jstate.params["model"],
                                             "batch_stats": jstate.batch_stats["model"]})
    got = mod.state_dict()
    for k, r in ref.items():
        if k.endswith("num_batches_tracked"):
            continue
        scale = r if "running" in k else r - start[k]
        gap = float((got[k].double() - r.double()).norm() / max(float(scale.double().norm()),
                                                                1e-30))
        assert gap <= (1e-5 if "running" in k else 1e-3), k


def test_mode_routing():
    batch = {"fmri": np.ones(3), "image": np.zeros(3)}
    assert supervised.route_batch("encoder", batch) == (batch["image"], batch["fmri"])
    assert supervised.route_batch("cogenc", batch) == (batch["fmri"], batch["image"])
    x = np.ones(4)
    i, t = supervised.route_batch("vae", x)
    assert i is x and t is x
    with pytest.raises(ValueError, match="wrong mode"):
        supervised.route_batch("nope", batch)
    with pytest.raises(ValueError, match="wrong mode"):
        supervised.make_supervised_step(None, None, None, "nope")
