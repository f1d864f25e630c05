"""The ablation experiments through the port's entry points, on the CPU at
``tiny``: the five ``exp_*`` builders (``fmri_tpu_torch/train/stages.py``)
against the JAX builders, ``python -m fmri_tpu_torch.train.run --family exp``
for each experiment (``dcgan-stage2`` from ``dcgan-stage1``'s run dir), and
the kernel wrappers' calls per step with both kernel flags on, the launches
each path makes on the card (``chip_smoke.py`` phase 16 holds its launches
to ``EXP_LAUNCHES``)."""

import glob
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from fmri_tpu.checkpoints import store as jax_store
from fmri_tpu.configs import presets as jax_presets
from fmri_tpu.train import stages as jax_stages
from fmri_tpu.train import state as jax_state_mod
from fmri_tpu_torch.checkpoints import convert, store
from fmri_tpu_torch.configs import presets
from fmri_tpu_torch.train import run, stages
from fmri_tpu_torch.train.optim import AdamState
from test_torch_wae import configs, count_kernel_calls, images
from torch_port_helpers import EXP_LAUNCHES, one_torch_thread  # noqa: F401

JCFG, CFG = jax_presets.get_config("tiny"), presets.get_config("tiny")
SPE = 3
EXPS = ("decoder", "vae", "vgan", "dcgan-stage1", "dcgan-stage2")
BASE = ["--preset", "tiny", "--dataset", "synthetic", "--device", "cpu", "--epochs", "1"]

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def seeded_jax_init():
    """The JAX builders' Flax inits replaced by seeded numpy groups in the
    same layout (``random_groups``): what a builder assembles around its
    groups is what these tests hold, and a first Flax init costs ~20 s."""
    def raw(kind, seed=0):
        groups = convert.random_groups(CFG, seed, kind)
        return {"params": {g: v["params"] for g, v in groups.items()},
                "batch_stats": {g: v["batch_stats"] for g, v in groups.items()}}

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_stages, "init_vaegan", lambda key, cfg: raw("vae-gan"))
    mp.setattr(jax_stages, "init_cognitive",
               lambda key, cfg: convert.random_groups(CFG, 1)["encoder"])
    mp.setattr(jax_state_mod, "init_voxel_decoder",
               lambda key, cfg: convert.random_groups(CFG, 2, "exp-decoder")["decoder"])
    yield
    mp.undo()


@pytest.fixture(scope="module")
def dcgan1(tmp_path_factory, one_torch_thread, seeded_jax_init):
    """A DCGAN stage-1 checkpoint dir of each package, from its own builder."""
    root = tmp_path_factory.mktemp("dcgan1")
    jdir, pdir = str(root / "jax"), str(root / "port")
    jax_store.save_checkpoint(jdir, 0, jax_stages.exp_dcgan_stage1(
        JCFG, steps_per_epoch=2, seed=8)[0])
    store.save_checkpoint(pdir, 0, stages.exp_dcgan_stage1(
        CFG, steps_per_epoch=2, seed=8, device="cpu")[0])
    return jdir, pdir


@pytest.mark.parametrize("name", ["exp_decoder", "exp_vae", "exp_vgan", "exp_dcgan_stage1",
                                  "exp_dcgan_stage2"])
def test_builders_match_jax(dcgan1, monkeypatch, name):
    """The JAX builder's groups, trained groups and optimizer kinds, lr
    schedules (values at steps 0, one epoch and 30 epochs in) and trainer
    keywords; the noise the step takes, by name, in the JAX step's split
    order; DCGAN stage 2's decoder and discriminator those of stage 1."""
    created = {"jax": [], "port": []}
    for side, mod in (("jax", jax_stages), ("port", stages)):
        def spy(*args, _real=mod.exponential_lr, _side=side):
            created[_side].append(_real(*args))
            return created[_side][-1]

        monkeypatch.setattr(mod, "exponential_lr", spy)
    jdir, pdir = dcgan1
    jstate, jsteps, jkw = jax_stages.BUILDERS[name](
        JCFG, *([jdir] if name == "exp_dcgan_stage2" else []), steps_per_epoch=SPE, seed=8)
    pstate, psteps, pkw = stages.BUILDERS[name](
        CFG, *([pdir] if name == "exp_dcgan_stage2" else []), steps_per_epoch=SPE, seed=8,
        device="cpu")
    assert set(jstate.params) == set(pstate.nets.PREFIXES)
    assert sorted(pstate.opt_state) == sorted(jstate.opt_state)
    for g, m in jstate.opt_state.items():
        assert isinstance(pstate.opt_state[g], AdamState) == hasattr(m, "mu"), g
    assert len(created["port"]) == len(created["jax"]) == 1
    for step in (0, SPE, 30 * SPE):
        assert float(created["port"][0](torch.tensor(step))) == pytest.approx(
            float(created["jax"][0](jax.numpy.int32(step))), rel=1e-6), step
    noise = pkw.pop("noise")
    assert pkw == jkw
    assert [n for n, _ in noise] == {"exp_decoder": [], "exp_dcgan_stage1": ["z_p"]}.get(
        name, ["eps", "z_p"])
    assert (psteps.generate_step is None) == (jsteps.generate_step is None)
    if name == "exp_dcgan_stage2":
        s1 = store.load_eval_state(pdir)[0]
        for g in ("decoder", "discriminator"):
            for k, v in s1[g].items():
                assert torch.equal(pstate.nets.module(g).state_dict()[k], v), (g, k)


def _train(out, *args):
    assert run.main([*BASE, "-o", str(out), *args]) == 0
    return sorted(glob.glob(os.path.join(str(out), "*", "*")))[-1]  # the newest run dir


def test_every_experiment_through_the_cli(tmp_path):
    """``--family exp --exp <each>`` one epoch on synthetic data;
    ``dcgan-stage2`` from ``dcgan-stage1``'s checkpoints; each run dir's
    checkpoint restores into its builder's state."""
    dirs = {}
    for exp in EXPS:
        extra = (["--prev-ckpt", os.path.join(dirs["dcgan-stage1"], "checkpoints")]
                 if exp == "dcgan-stage2" else [])
        dirs[exp] = _train(tmp_path / exp, "--family", "exp", "--exp", exp, *extra)
    for exp, run_dir in dirs.items():
        name = "exp_" + exp.replace("-", "_")
        assert os.path.basename(os.path.dirname(run_dir)) == name
        args = [os.path.join(dirs["dcgan-stage1"], "checkpoints")] \
            if exp == "dcgan-stage2" else []
        state = stages.BUILDERS[name](CFG, *args, steps_per_epoch=SPE, device="cpu")[0]
        state, meta = store.restore_checkpoint(os.path.join(run_dir, "checkpoints"), state)
        assert meta["epoch"] == 0 and int(state.step) > 0
        assert np.isfinite(meta["metrics"]["valid_SSIM"]), exp


def test_exp_arguments_are_checked(tmp_path):
    with pytest.raises(SystemExit, match="needs --exp"):
        run.main([*BASE, "-o", str(tmp_path), "--family", "exp"])
    with pytest.raises(SystemExit, match="--prev-ckpt"):
        run.main([*BASE, "-o", str(tmp_path), "--family", "exp", "--exp", "dcgan-stage2"])


def test_exp_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        run.main(["--family", "exp", "--exp", "vae", "--preset", "tiny", "-o", str(tmp_path)])


@pytest.mark.parametrize("name", sorted(EXP_LAUNCHES))
def test_kernel_calls_per_step(monkeypatch, dcgan1, name):
    """Calls of the BN-backward and weight-grad wrappers in one step of each
    path through its builder's adapter, both kernel flags on (on the card,
    one launch each)."""
    _, cfg = configs(True, True)
    counts = count_kernel_calls(monkeypatch)
    args = [dcgan1[1]] if name == "exp_dcgan_stage2" else []
    state, steps, kw = stages.BUILDERS[name](cfg, *args, steps_per_epoch=SPE, device="cpu")
    x = torch.from_numpy(images(cfg, 4, 0))
    rng = np.random.default_rng(1)
    batch = x if kw["data_kind"] == "image" else {
        "fmri": torch.from_numpy(rng.normal(size=(4, cfg.model.num_voxels)).astype(
            np.float32)), "image": x}
    noise = {n: torch.from_numpy(rng.normal(size=(4, cfg.model.latent_dim)).astype(np.float32))
             for n, _ in kw["noise"]}
    gate = (0.35, 0.68, 1e-6) if kw["uses_gate"] else ()
    counts.reset()
    steps.train_step(state, batch, noise, *gate)
    assert counts.read() == EXP_LAUNCHES[name]


def test_chip_smoke_checks_the_counted_launches():
    """``chip_smoke.py`` phase 16 holds each ablation step's launches on the
    card to the counts this file pins on the CPU."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    kernels = ("bn_bwd_reduce", "bn_bwd_apply", "tap_matmul")
    assert {name: tuple(n[k] for k in kernels) for name, n in smoke.EXP_LAUNCHES.items()
            } == EXP_LAUNCHES
