"""The port's WAE/GAN stage-I step as the trainer builds it
(``fmri_tpu_torch/train/stages.py::wae_stage1``) against the benchmark's
plain float32 reference of the thesis's step (``portbench/reference/wae.py``:
the encoder run twice a batch, so its BatchNorm ticks twice; the latent
discriminator's Adam step at half the lr before phase 2; ``torch.optim.Adam``;
StepLR), on the CPU at ``tiny`` with batch 8: the same weights, images,
flips and z_fake, three steps.

Tolerances, over the three steps: each head loss within 1e-6 of the
reference's, relative; per tensor, the L2 norm of the port's difference from
the reference relative to how far the reference moved the parameter (2e-3),
to the reference's Adam moment (2e-3), or to the reference's running
statistic (1e-5). That is fp32 rounding: the port pulls the reconstruction's
and the penalty's cotangents back through one encoder backward from their
sum at mu, and replays the second BatchNorm tick from the first, where the
reference runs the encoder again; the worst gaps measured are 2.2e-7 (a
later step's loss), 4.2e-4 and 4.3e-4 (``encoder.l_mu.bias`` and its
moments: its move is small) and 6.1e-7 (a running statistic). Taking phase
2's penalty against the discriminator as it was before phase 1 moves the
step-1 penalty by 3e-5 and the parameters by up to 0.12 of their move:
refused on both.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fmri_tpu_torch.configs.presets import get_config
from fmri_tpu_torch.data.transforms import train_augment
from fmri_tpu_torch.train import stages
from torch_port_helpers import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import datagen  # noqa: E402
from portbench.reference import wae as ref  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, STEPS, SPE = 8, 3, 4
TOL = {"loss": 1e-6, "param": 2e-3, "moment": 2e-3, "running": 1e-5}
RUNNING = ("running_mean", "running_var")


def _model(cfg) -> dict:
    """The reference's model dict of the program's ``ModelConfig``."""
    return {k: list(v) if isinstance(v, tuple) else v
            for k, v in dataclasses.asdict(cfg.model).items()}


@pytest.fixture(scope="module")
def case():
    """(cfg, w0, each step's inputs, the port's state, metrics, and a fresh
    state and step to run again)."""
    cfg = get_config("tiny")
    m = _model(cfg)
    w0 = datagen.weights(ref.specs(m), 5, "cpu")
    gen = torch.Generator().manual_seed(1)
    imgs = torch.from_numpy(datagen.images(STEPS * B, m["image_size"], 3, "cpu"))
    steps = [{"x": imgs[i * B:(i + 1) * B], "flip": torch.rand(B, generator=gen) < 0.5,
              "z_fake": cfg.train.wae_sigma * torch.randn(B, m["latent_dim"], generator=gen)}
             for i in range(STEPS)]
    init, fns, _ = stages.wae_stage1(cfg, steps_per_epoch=SPE, seed=0, device="cpu")
    init.nets.load_state_dict(w0, strict=True)

    def run(state, n=STEPS):
        metrics = []
        for s in steps[:n]:
            x = train_augment(s["x"], s["flip"], None)
            metrics.append(fns.train_step(state, x, {"z_fake": s["z_fake"]})[1])
        return state, metrics

    state, metrics = run(copy.deepcopy(init))
    return dict(cfg=cfg, m=m, w0=w0, steps=steps, state=state, metrics=metrics, init=init,
                run=run)


def _gaps(case, expected) -> dict:
    """The worst relative gap of each kind (see the module's tolerances)."""
    state, w0 = case["state"], case["w0"]
    losses = max(abs(float(pm["loss_" + h]) - v) / abs(v)
                 for pm, rl in zip(case["metrics"], expected["losses"]) for h, v in rl.items())
    sd, params, running = state.nets.state_dict(), {}, {}
    for k, v in expected["weights"].items():
        if k.endswith(RUNNING):
            running[k] = float((sd[k] - v).norm() / v.norm())
        elif not k.endswith("num_batches_tracked"):
            params[k] = float((sd[k] - v).norm() / max(float((v - w0[k]).norm()), 1e-30))
    moments = {}
    for g, st in state.opt_state.items():
        pre = state.nets.PREFIXES[g]
        for k in st.mu:
            em, ev = expected["moments"][pre + k]
            for name, got, want in (("mu", st.mu[k], em), ("nu", st.nu[k], ev)):
                moments[f"{pre}{k}.{name}"] = float((got - want).norm()
                                                    / max(float(want.norm()), 1e-30))
    return {"loss": losses, "param": max(params.values()), "moment": max(moments.values()),
            "running": max(running.values()), "n_running": len(running),
            "n_moments": len(moments)}


def _reference(case, fault=""):
    t = dataclasses.asdict(case["cfg"].train)
    return ref.train_steps(case["w0"], case["steps"], case["m"], t, ref.Precision(),
                           steps_per_epoch=SPE, fault=fault)


def test_the_port_matches_the_plain_reference_for_three_steps(case):
    gaps = _gaps(case, _reference(case))
    # every running statistic of the encoder and the decoder (4 + 4 BNs),
    # both moments of all 40 trained tensors
    assert gaps.pop("n_running") == 16 and gaps.pop("n_moments") == 80
    for kind, gap in gaps.items():
        assert gap <= TOL[kind], (kind, gap)
    assert int(case["state"].step) == STEPS


def test_the_comparison_refuses_phase_2_against_the_stale_discriminator(case):
    gaps = _gaps(case, _reference(case, fault="stale_disc"))
    assert gaps["loss"] > 10 * TOL["loss"] and gaps["param"] > 10 * TOL["param"]


def test_the_step_records_its_spans_and_stays_bitwise_under_the_profiler(case, tmp_path):
    off, off_metrics = case["run"](copy.deepcopy(case["init"]), 1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on, on_metrics = case["run"](copy.deepcopy(case["init"]), 1)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = {e["name"]: e for e in json.load(f)["traceEvents"]
                  if str(e.get("name", "")).startswith("fmri.")}
    assert {"fmri.train.step", "fmri.train.forward", "fmri.train.backward",
            "fmri.train.latent_disc", "fmri.train.optimizer",
            "fmri.train.optimizer.latent_disc", "fmri.train.optimizer.encoder",
            "fmri.train.optimizer.decoder"} <= set(events)
    # the latent discriminator's update runs inside phase 1
    outer, inner = events["fmri.train.latent_disc"], events["fmri.train.optimizer.latent_disc"]
    assert outer["ts"] <= inner["ts"] and (inner["ts"] + inner["dur"]
                                           <= outer["ts"] + outer["dur"])
    for k, v in off_metrics[0].items():
        assert torch.equal(v, on_metrics[0][k]), k
    on_sd = on.nets.state_dict()
    for k, v in off.nets.state_dict().items():
        assert torch.equal(v, on_sd[k]), k
    for g, st in off.opt_state.items():
        for k in st.mu:
            assert torch.equal(st.mu[k], on.opt_state[g].mu[k]), (g, k)
            assert torch.equal(st.nu[k], on.opt_state[g].nu[k]), (g, k)
        assert torch.equal(st.count, on.opt_state[g].count), g
