"""The port's ``Trainer`` (``fmri_tpu_torch/train/trainer.py``) against the JAX
package's on the CPU, ``tiny`` preset.

The stage-I fit: 16 training images and 8 validation images at batch 8
(2 steps per epoch), 2 epochs, the JAX builder's weights and its RMSprop
moments warmed to ones (``tests/ref_oracle.py:110``; from zero moments an
update is about 3.16 lr sign(g) and flips on rounding), the JAX trainer's
own draws replayed (``JaxDraws``), a grid every epoch, torch on one CPU
thread. Tolerances, each four to ten times the gap measured here (fp32
rounding of two frameworks):
  * ``results.csv``: the same columns in the same order; losses within
    1e-6 relative (measured 2.5e-7); the PCC/SSIM/MSE columns within 1e-4
    absolute (measured 1.3e-5 on train_PCC, whose value is 0.11);
  * the final parameters within 1% of how far the JAX run moved each
    tensor (L2; measured 0.21%), BN running statistics within 1e-5 of the
    JAX value (measured 1.1e-6), RMSprop moments within 1% of how far they
    moved from the warm start (measured 0.25%).
Resume and the device-resident epoch are held to the port's own plain run
bit for bit."""

import csv
import dataclasses
import math
import types

import numpy as np
import pytest
import torch

from fmri_tpu.configs import presets as jax_presets
from fmri_tpu.train import stages as jax_stages
from fmri_tpu.train.trainer import EarlyStopping as JaxEarlyStopping
from fmri_tpu.train.trainer import GameSchedules as JaxGameSchedules
from fmri_tpu.train.trainer import Trainer as JaxTrainer
from fmri_tpu_torch.checkpoints import store
from fmri_tpu_torch.checkpoints.convert import from_jax_groups, moments_from_jax
from fmri_tpu_torch.configs import presets
from fmri_tpu_torch.data.synthetic import synthetic_images
from fmri_tpu_torch.train import stages
from fmri_tpu_torch.train.state import VaeGan
from fmri_tpu_torch.train.steps_vgan import StepFns
from fmri_tpu_torch.train.trainer import EarlyStopping, GameSchedules, Trainer
from torch_port_helpers import (  # noqa: F401
    JaxDraws, one_torch_thread, port_state_from_jax, warm_jax_moments,
)

LOSS_RTOL, METRIC_ATOL = 1e-6, 1e-4
PARAM_TOL, STATS_TOL, MOMENT_TOL = 1e-2, 1e-5, 1e-2

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _decays(cfg, margin, eq, mse):
    return cfg.replace(train=dataclasses.replace(
        cfg.train, decay_margin=margin, decay_equilibrium=eq, decay_mse=mse))


@pytest.mark.parametrize("decays", [(1.0, 1.0, 1.0), (0.97, 0.9, 1.3), (1.01, 0.95, 0.9)])
def test_game_schedules_match_jax(decays):
    """50 epochs of decay, the margin overtaking the equilibrium and the
    lambda_mse cap: the same Python floats, and the same float32 on the
    device."""
    ours = GameSchedules(_decays(presets.get_config("tiny"), *decays))
    ref = JaxGameSchedules(_decays(jax_presets.get_config("tiny"), *decays))
    for _ in range(50):
        assert (ours.margin, ours.equilibrium, ours.lambda_mse) == (
            ref.margin, ref.equilibrium, ref.lambda_mse)
        for got, want in zip(ours.args(torch.device("cpu")), ref.args()):
            assert got.dtype == torch.float32 and float(got) == float(want)
        ours.epoch_end()
        ref.epoch_end()


@pytest.mark.parametrize("patience,mode,values", [
    (0, "max", [0.1, 0.05, 0.0, -1.0]),
    (2, "max", [0.1, 0.2, 0.15, 0.19, 0.18, 0.3, 0.1]),
    (1, "min", [1.0, 0.5, 0.6, 0.7]),
    (3, "max", [0.1, float("nan")])])
def test_early_stopping_matches_jax(patience, mode, values):
    ours, ref = EarlyStopping(patience, mode), JaxEarlyStopping(patience, mode)
    for v in values:
        assert ours.update(v) == ref.update(v)
        assert ours.best == ref.best and ours.bad_epochs == ref.bad_epochs


def _data():
    imgs, _ = synthetic_images(24, 16, seed=0)
    return imgs[8:], imgs[:8]


@pytest.fixture(scope="module")
def fits(tmp_path_factory, one_torch_thread):
    """The JAX and the port's stage-I fits from the same weights and draws."""
    jcfg, cfg = jax_presets.get_config("tiny"), presets.get_config("tiny")
    train, valid = _data()
    jstate, jsteps, jkw = jax_stages.vgan_stage1(jcfg, steps_per_epoch=2, seed=8)
    jstate = warm_jax_moments(jstate)
    # converted before the JAX fit, whose step donates the state's buffers
    pstate = port_state_from_jax(jstate, cfg, "vae-gan", VaeGan(cfg))
    start = {k: v.clone() for k, v in pstate.nets.state_dict().items()}
    _, psteps, pkw = stages.vgan_stage1(cfg, steps_per_epoch=2, seed=8, device="cpu")
    jdir, pdir = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    jfinal = JaxTrainer(jcfg, jsteps, str(jdir), **jkw).fit(jstate, train, valid,
                                                           grid_every=1)
    pfinal = Trainer(cfg, psteps, str(pdir), draws=JaxDraws(8), **pkw).fit(
        pstate, train, valid, grid_every=1)
    return dict(cfg=cfg, jdir=jdir, pdir=pdir, jfinal=jfinal, pfinal=pfinal, start=start)


def _rows(path):
    with open(path / "results.csv") as f:
        reader = csv.DictReader(f)
        return reader.fieldnames, list(reader)


def test_fit_writes_the_jax_results(fits):
    jcols, jrows = _rows(fits["jdir"])
    pcols, prows = _rows(fits["pdir"])
    assert pcols == jcols and len(prows) == len(jrows) == 2
    assert {"valid_PCC", "valid_SSIM", "valid_MSE", "train_PCC", "train_SSIM",
            "train_MSE"} <= set(pcols)
    for got, want in zip(prows, jrows):
        for k in pcols:
            g, w = float(got[k]), float(want[k])
            if k.startswith(("valid_", "train_PCC", "train_SSIM", "train_MSE")):
                assert abs(g - w) <= METRIC_ATOL, (k, g, w)
            else:
                assert abs(g - w) <= LOSS_RTOL * max(abs(w), 1e-12), (k, g, w)
    for name in ("epoch_0000.png", "epoch_0000_original.png", "epoch_0000_generated.png",
                 "epoch_0001.png"):
        assert (fits["pdir"] / "images" / "valid" / name).exists()
    assert sorted(store.list_checkpoints(str(fits["pdir"] / "checkpoints"))) == [0, 1]


def test_fit_reaches_the_jax_state(fits):
    cfg, jfinal, start = fits["cfg"], fits["jfinal"], fits["start"]
    groups = {g: {"params": jfinal.params[g], "batch_stats": jfinal.batch_stats[g]}
              for g in jfinal.params}
    want = from_jax_groups(groups, cfg, "vae-gan")
    got = fits["pfinal"].nets.state_dict()
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        if "running" in k:
            assert float((got[k] - v).norm() / v.norm()) <= STATS_TOL, k
        else:
            moved = float((v - start[k]).norm())
            assert moved > 0, k
            assert float((got[k] - v).norm()) <= PARAM_TOL * moved, k
    moments = moments_from_jax(dict(jfinal.opt_state), cfg, "vae-gan")
    for g, m in moments.items():
        for k, v in m.items():  # moved from the warm start at ones
            gap = float((fits["pfinal"].opt_state[g][k] - v).norm())
            assert gap <= MOMENT_TOL * float((v - 1.0).norm()), (g, k)
    assert int(fits["pfinal"].step) == int(np.asarray(jfinal.step)) == 4


def _stage1(cfg):
    return stages.vgan_stage1(cfg, steps_per_epoch=2, seed=8, device="cpu")


def _dir(path):
    path.mkdir(parents=True, exist_ok=True)
    return str(path)


def _same_state(a, b):
    sa, sb = a.nets.state_dict(), b.nets.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    for g in a.opt_state:
        for k in a.opt_state[g]:
            assert torch.equal(a.opt_state[g][k], b.opt_state[g][k]), (g, k)
    assert torch.equal(a.step, b.step)


def test_resume_is_bitwise(tmp_path):
    """Epoch 0, its checkpoint restored into a fresh state, then epoch 1,
    equals the uninterrupted two epochs bit for bit, results included (the
    default draws are seeded per epoch, the schedules fast-forwarded)."""
    cfg = presets.get_config("tiny")
    train, valid = _data()
    state, steps, kw = _stage1(cfg)
    whole = Trainer(cfg, steps, _dir(tmp_path / "a"), tensorboard=False, **kw).fit(
        state, train, valid, n_epochs=2)
    state, steps, kw = _stage1(cfg)
    Trainer(cfg, steps, _dir(tmp_path / "b"), tensorboard=False, **kw).fit(
        state, train, valid, n_epochs=1)
    fresh, steps, kw = _stage1(cfg)
    trainer = Trainer(cfg, steps, _dir(tmp_path / "b"), tensorboard=False, **kw)
    fresh, start = trainer.resume(fresh, epoch=0)
    assert start == 1
    resumed = trainer.fit(fresh, train, valid, n_epochs=2, start_epoch=start)
    _same_state(resumed, whole)
    assert _rows(tmp_path / "a") == _rows(tmp_path / "b")


def test_on_device_epochs_are_bitwise(tmp_path):
    cfg = presets.get_config("tiny")
    train, valid = _data()
    runs = []
    for on_device in (False, True):
        state, steps, kw = _stage1(cfg)
        d = tmp_path / str(on_device)
        runs.append(Trainer(cfg, steps, _dir(d), tensorboard=False, debug=True, **kw).fit(
            state, train, valid, n_epochs=2, on_device=on_device))
    _same_state(*runs)
    assert _rows(tmp_path / "False") == _rows(tmp_path / "True")


def test_nan_guard_stops_the_run(tmp_path):
    cfg = presets.get_config("tiny")
    train, valid = _data()
    state, steps, kw = _stage1(cfg)
    calls = []

    def poisoned(s, batch, noise, *gate):
        s, m = steps.train_step(s, batch, noise, *gate)
        calls.append(1)
        return s, dict(m, loss_encoder=m["loss_encoder"] * float("nan"))

    trainer = Trainer(cfg, StepFns(poisoned, steps.eval_step, steps.generate_step),
                      str(tmp_path), tensorboard=False, **kw)
    trainer.fit(state, train, valid, n_epochs=5)
    rows = _rows(tmp_path)[1]
    assert len(rows) == 1 and len(calls) == 2 and math.isnan(float(rows[0]["loss_encoder"]))
    # the final checkpoint is the cadence's epoch 0, not written twice
    assert sorted(store.list_checkpoints(str(tmp_path / "checkpoints"))) == [0]


def test_patience_stops_on_valid_pcc(tmp_path):
    cfg = presets.get_config("tiny")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, patience=1, ckpt_every=0))
    train, valid = _data()
    state, steps, kw = _stage1(cfg)
    pcc = iter([0.5, 0.4, 0.3, 0.9])

    def row_pcc(epoch, s, row):
        row["valid_PCC"] = next(pcc)

    trainer = Trainer(cfg, steps, str(tmp_path), tensorboard=False, **kw)
    trainer.fit(state, train, valid, n_epochs=4, epoch_callback=row_pcc)
    assert len(_rows(tmp_path)[1]) == 3  # best at 0, bad at 1 and 2 > patience 1
    assert sorted(store.list_checkpoints(str(tmp_path / "checkpoints"))) == [2]


def test_trainer_batch_must_split_over_the_mesh_data_axis(tmp_path):
    """The JAX trainer's check (fmri_tpu/train/trainer.py:133-139), before
    any rank trains: only the mesh's data axis is read."""
    cfg = presets.get_config("tiny")
    _, steps, kw = _stage1(cfg)
    with pytest.raises(ValueError, match="batch_size=8 is not divisible by the mesh data "
                                         r"axis \(3 devices\)"):
        Trainer(cfg, steps, str(tmp_path), mesh=types.SimpleNamespace(data=3, model=1), **kw)
