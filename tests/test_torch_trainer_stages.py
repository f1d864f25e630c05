"""The port's stage builders (``fmri_tpu_torch/train/stages.py``) and the
stage-II fit through its ``Trainer``, against the JAX package's, on the
CPU (``tiny``).

The stage-II fit starts from a stage-I checkpoint written by each package
from the same weights: the port's builder grafts the decoder, the
discriminator and the teacher encoder from its checkpoint and must equal
what the JAX builder grafted, bit for bit; then the fresh cognitive encoder
and the moments (warmed to ones) come from the JAX builder too, and one
epoch of 16 pairs (shift augmentation, the teacher distilling) runs in both
with the JAX draws replayed, torch on one CPU thread. Tolerances as in
``test_torch_trainer.py`` (measured here: losses 2.5e-7 relative, metrics
2.4e-7 absolute, parameters 1.4e-5 of their movement, stats 9.2e-7,
moments 1.2e-5 of their movement; a moment whose parameter got no
gradient must not move)."""

import csv

import jax
import numpy as np
import pytest
import torch

from fmri_tpu.checkpoints import store as jax_store
from fmri_tpu.configs import presets as jax_presets
from fmri_tpu.train import stages as jax_stages
from fmri_tpu.train.trainer import Trainer as JaxTrainer
from fmri_tpu_torch.checkpoints import store
from fmri_tpu_torch.checkpoints.convert import from_jax_groups, moments_from_jax
from fmri_tpu_torch.configs import presets
from fmri_tpu_torch.data.synthetic import synthetic_pairs
from fmri_tpu_torch.train import stages
from fmri_tpu_torch.train.optim import AdamState
from fmri_tpu_torch.train.state import VaeGan, VaeGanCognitiveTrain
from fmri_tpu_torch.train.trainer import Trainer
from torch_port_helpers import (  # noqa: F401
    JaxDraws, one_torch_thread, port_state_from_jax, warm_jax_moments,
)

LOSS_RTOL, METRIC_ATOL = 1e-6, 1e-4
PARAM_TOL, STATS_TOL, MOMENT_TOL = 1e-2, 1e-5, 1e-2
JCFG, CFG = jax_presets.get_config("tiny"), presets.get_config("tiny")

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _groups(state):
    return {g: {"params": state.params[g], "batch_stats": state.batch_stats.get(g, {})}
            for g in state.params}


@pytest.fixture(scope="module")
def stage1(tmp_path_factory, one_torch_thread):
    """One stage-I state, saved by the JAX store and (converted) by the port's."""
    root = tmp_path_factory.mktemp("stage1")
    js1 = jax_stages.vgan_stage1(JCFG, steps_per_epoch=2, seed=8)[0]
    jax_store.save_checkpoint(str(root / "jax"), 0, js1)
    store.save_checkpoint(str(root / "port"), 0,
                          port_state_from_jax(js1, CFG, "vae-gan", VaeGan(CFG)))
    return root


def _rows(path):
    with open(path / "results.csv") as f:
        reader = csv.DictReader(f)
        return reader.fieldnames, list(reader)


def test_stage2_fit_matches_jax(stage1, tmp_path):
    data = synthetic_pairs(24, 16, CFG.model.num_voxels, seed=0)
    train = {k: v[8:] for k, v in data.items()}
    valid = {k: v[:8] for k, v in data.items()}
    js2, jsteps, jkw = jax_stages.vgan_stage2(JCFG, str(stage1 / "jax"),
                                              steps_per_epoch=2, seed=8)
    ps2, psteps, pkw = stages.vgan_stage2(CFG, str(stage1 / "port"), steps_per_epoch=2,
                                          seed=8, device="cpu")
    # the port's handoff grafted exactly what the JAX builder grafted
    want = from_jax_groups(_groups(js2), CFG, "vae-gan-cognitive")
    got = ps2.nets.state_dict()
    grafted = [k for k in want if k.startswith(("decoder.", "discriminator.", "teacher_net."))]
    assert len(grafted) > 30
    for k in grafted:
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], want[k]), k
    assert sorted(ps2.opt_state) == sorted(js2.opt_state) == ["discriminator", "encoder"]
    assert pkw["augment"] == jkw["augment"] == {"flip": False, "max_shift": 5}

    js2 = warm_jax_moments(js2)
    ps2 = port_state_from_jax(js2, CFG, "vae-gan-cognitive", VaeGanCognitiveTrain(CFG))
    start = {k: v.clone() for k, v in ps2.nets.state_dict().items()}
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jfinal = JaxTrainer(JCFG, jsteps, str(tmp_path / "jax"), **jkw).fit(
        js2, train, valid, n_epochs=1)
    pfinal = Trainer(CFG, psteps, str(tmp_path / "port"), draws=JaxDraws(8), **pkw).fit(
        ps2, train, valid, n_epochs=1)

    jcols, jrows = _rows(tmp_path / "jax")
    pcols, prows = _rows(tmp_path / "port")
    assert pcols == jcols and len(prows) == 1
    for k in pcols:
        g, w = float(prows[0][k]), float(jrows[0][k])
        if k.startswith(("valid_", "train_PCC", "train_SSIM", "train_MSE")):
            assert abs(g - w) <= METRIC_ATOL, (k, g, w)
        else:
            assert abs(g - w) <= LOSS_RTOL * max(abs(w), 1e-12), (k, g, w)

    want = from_jax_groups(_groups(jfinal), CFG, "vae-gan-cognitive")
    got = pfinal.nets.state_dict()
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        if "running" in k:
            assert float((got[k] - v).norm() / v.norm()) <= STATS_TOL, k
        elif k.startswith(("encoder.", "discriminator.", "teacher_net.discriminator.")):
            assert float((got[k] - v).norm()) <= PARAM_TOL * float((v - start[k]).norm()), k
        else:  # frozen: the decoder and the teacher's encoder
            assert torch.equal(got[k], start[k]) and torch.equal(v, start[k]), k
    for g, m in moments_from_jax(dict(jfinal.opt_state), CFG, "vae-gan-cognitive").items():
        for k, v in m.items():
            gap = float((pfinal.opt_state[g][k] - v).norm())
            assert gap <= MOMENT_TOL * float((v - 1.0).norm()), (g, k)


@pytest.fixture(scope="module")
def chain(stage1, tmp_path_factory):
    """Each package's own stage-I, stage-II and WAE stage-I/II checkpoints,
    from its own builders, for the builders' handoff arguments."""
    root = tmp_path_factory.mktemp("chain")
    jdirs = {"vgan_stage1": str(stage1 / "jax"), "vgan_stage2": str(root / "j_vgan2"),
             "wae_stage1": str(root / "j_wae1"), "wae_stage2": str(root / "j_wae2")}
    pdirs = {"vgan_stage1": str(stage1 / "port"), "vgan_stage2": str(root / "p_vgan2"),
             "wae_stage1": str(root / "p_wae1"), "wae_stage2": str(root / "p_wae2")}
    kw = dict(steps_per_epoch=2, seed=8)
    jax_store.save_checkpoint(jdirs["vgan_stage2"], 0, jax_stages.vgan_stage2(
        JCFG, jdirs["vgan_stage1"], **kw)[0])
    jax_store.save_checkpoint(jdirs["wae_stage1"], 0, jax_stages.wae_stage1(JCFG, **kw)[0])
    jax_store.save_checkpoint(jdirs["wae_stage2"], 0, jax_stages.wae_stage2(
        JCFG, jdirs["wae_stage1"], **kw)[0])
    pkw = dict(kw, device="cpu")
    store.save_checkpoint(pdirs["vgan_stage2"], 0, stages.vgan_stage2(
        CFG, pdirs["vgan_stage1"], **pkw)[0])
    store.save_checkpoint(pdirs["wae_stage1"], 0, stages.wae_stage1(CFG, **pkw)[0])
    store.save_checkpoint(pdirs["wae_stage2"], 0, stages.wae_stage2(
        CFG, pdirs["wae_stage1"], **pkw)[0])
    return jdirs, pdirs


HANDOFF = {"vgan_stage2": ("vgan_stage1",), "vgan_stage3": ("vgan_stage2",),
           "wae_stage2": ("wae_stage1",), "wae_stage3": ("wae_stage2", "wae_stage1")}
SPE = 3


@pytest.mark.parametrize("name", ["vgan_stage1", "vgan_stage2", "vgan_stage3", "wae_stage1",
                                  "wae_stage2", "wae_stage3", "wae_vgan_stage1"])
def test_builders_match_jax(chain, monkeypatch, name):
    """The same trained groups, optimizer kinds, lr schedules (values at
    steps 0, one epoch and 30 epochs in, in creation order) and trainer
    keywords as the JAX builder; every group of the JAX state is one of the
    port module's."""
    jdirs, pdirs = chain
    created = {"jax": [], "port": []}
    for side, mod in (("jax", jax_stages), ("port", stages)):
        for fn in ("exponential_lr", "step_lr"):
            def spy(*args, _real=getattr(mod, fn), _side=side):
                sched = _real(*args)
                created[_side].append(sched)
                return sched

            monkeypatch.setattr(mod, fn, spy)
    handoff = [jdirs[d] for d in HANDOFF.get(name, ())]
    jstate, _, jkw = jax_stages.BUILDERS[name](JCFG, *handoff, steps_per_epoch=SPE, seed=8)
    handoff = [pdirs[d] for d in HANDOFF.get(name, ())]
    pstate, psteps, pkw = stages.BUILDERS[name](CFG, *handoff, steps_per_epoch=SPE, seed=8,
                                                device="cpu")
    assert set(jstate.params) == set(pstate.nets.PREFIXES)
    assert sorted(pstate.opt_state) == sorted(jstate.opt_state)
    for g, m in jstate.opt_state.items():
        assert isinstance(pstate.opt_state[g], AdamState) == hasattr(m, "mu"), g
    assert len(created["port"]) == len(created["jax"]) > 0
    for ours, ref in zip(created["port"], created["jax"]):
        for step in (0, SPE, 30 * SPE, 31 * SPE):
            assert float(ours(torch.tensor(step))) == pytest.approx(
                float(ref(jax.numpy.int32(step))), rel=1e-6), step
    noise = pkw.pop("noise")
    assert pkw == jkw
    assert all(s > 0 for _, s in noise)
    assert psteps.generate_step is not None


@pytest.mark.parametrize("name", ["exp_decoder", "exp_vae", "exp_vgan", "exp_dcgan_stage1",
                                  "exp_dcgan_stage2"])
def test_ablation_builders_name_their_slice(name, tmp_path):
    """The ablation builders are in the port (``tests/test_torch_exp_cli.py``
    holds them against the JAX builders): each builds its state on the CPU,
    DCGAN stage 2 from a DCGAN stage-1 checkpoint dir."""
    args = []
    if name == "exp_dcgan_stage2":
        store.save_checkpoint(str(tmp_path), 0, stages.exp_dcgan_stage1(
            CFG, steps_per_epoch=2, device="cpu")[0])
        args = [str(tmp_path)]
    state, steps, kw = stages.BUILDERS[name](CFG, *args, steps_per_epoch=2, device="cpu")
    assert state.opt_state and steps.train_step is not None and kw["data_kind"] in (
        "image", "pair")


def test_a_reference_pth_hands_off_like_a_checkpoint(stage1, tmp_path):
    """Stage II from a reference-layout stage-I ``.pth`` grafts the same
    groups as from the port's checkpoint dir."""
    s1, _ = store.restore_checkpoint(str(stage1 / "port"), stages.vgan_stage1(
        CFG, steps_per_epoch=2, device="cpu")[0])
    pth = str(tmp_path / "stage1.pth")
    torch.save(s1.nets.state_dict(), pth)
    a = stages.vgan_stage2(CFG, pth, steps_per_epoch=2, device="cpu")[0].nets.state_dict()
    b = stages.vgan_stage2(CFG, str(stage1 / "port"), steps_per_epoch=2,
                           device="cpu")[0].nets.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not np.array_equal(a["teacher_net.encoder.fc.0.weight"].numpy(),
                              a["encoder.fc1.0.weight"].numpy()[:1])
