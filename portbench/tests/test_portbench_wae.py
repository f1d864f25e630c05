"""The WAE/GAN cell's own pieces at the tiny widths on the CPU: its counts
against a hand count, a whole run of the cell against the program in
float32, a broken step or a missing BatchNorm tick refused, the reference's
float8 control and faults refused by the cell's limits, the two readers of
``train.latent_disc``, and a reference that imports nothing of the
program."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import BENCH, ROOT, TINY_MODEL, last_result, run_cell, tiny_bench
from portbench import counts_wae, harness
from test_portbench_spans import _ctx

CELL = "train_wae1_res64_b1024"
NEW = ("latent_disc_host_ms.train", "latent_disc_launches_per_step.train")


def wae_bench(tmp_path, compute_dtype=None, batch: int = 8) -> str:
    """``tiny_bench`` of the WAE cell, its traffic at ``batch`` rows."""
    bench = tiny_bench(tmp_path, CELL, compute_dtype=compute_dtype)
    path = os.path.join(bench, "traffic", "train_wae1_b1024.json")
    with open(path) as f:
        traffic = json.load(f)
    with open(path, "w") as f:
        json.dump({k: traffic[k] for k in ("kind", "warmup_steps", "checked_steps", "prefetch")}
                  | {"batch": batch}, f)
    return bench


def test_counts_by_hand():
    m, b = TINY_MODEL, 8
    # encoder: convs 3->8->16->16 (16 px -> 8 -> 4 -> 2), fc 64 -> 32, l_mu 32 -> 16
    conv0 = 8 * 8 * 8 * 3 * 25
    enc = conv0 + 4 * 4 * 16 * 8 * 25 + 2 * 2 * 16 * 16 * 25 + 64 * 32 + 32 * 16
    # decoder: fc 16 -> 2*2*16, deconvs 16->16 (2 px), 16->8 (4), 8->8 (8), out 8->3 at 16 px
    dec = (16 * 64 + 2 * 2 * 16 * 16 * 25 + 4 * 4 * 16 * 8 * 25 + 8 * 8 * 8 * 8 * 25
           + 16 * 16 * 3 * 8 * 25)
    # latent D: 16 -> 32, 3 x 32 -> 32, 32 -> 1
    ld0, ld = 16 * 32, 16 * 32 + 3 * 32 * 32 + 32
    macs = (b * (3 * enc - conv0) + 3 * b * dec
            + 2 * b * (3 * ld - ld0) + 2 * b * ld)
    totals = counts_wae.step_totals(m, b)
    assert totals["flops"] == pytest.approx(2 * macs)
    names = [o.name for o in counts_wae.step_ops(m, b)]
    assert "enc.conv0.dgrad" not in names and not any("l_var" in n for n in names)
    assert "p1.ld.fc0.dgrad" not in names and "p2.ld.fc0.dgrad" in names
    assert "p2.ld.fc0.wgrad" not in names and "dec.fc.dgrad" in names


def test_the_cell_matches_the_program_in_float32(tmp_path, capsys):
    bench = wae_bench(tmp_path)
    assert run_cell(bench, CELL) == 0
    out = last_result(capsys.readouterr().out)
    assert out["correct"] is True and set(out["checks"]) == {
        "grad_gap", "grad_gap_median", "change_gap", "change_gap_median", "running_gap"}
    for name, check in out["checks"].items():
        assert check["value"] < 1e-3, (name, check)  # fp32 rounding


def _unchanged(monkeypatch):
    from fmri_tpu_torch.train import optim

    monkeypatch.setattr(optim.Adam, "update", lambda self, *a, **k: None)


def _one_tick(monkeypatch):
    from fmri_tpu_torch.train import steps_wae

    monkeypatch.setattr(steps_wae, "bn_extra_ticks", lambda *a, **k: None)


def _altered_gradient(monkeypatch):
    from fmri_tpu_torch.train import optim

    update = optim.Adam.update

    def altered(self, grads, state, params, lr, gate=1.0):
        grads = dict(grads)
        k = next(iter(grads))
        grads[k] = grads[k] * 1.5
        return update(self, grads, state, params, lr, gate)

    monkeypatch.setattr(optim.Adam, "update", altered)


def _disc_at_lr(monkeypatch):
    """The latent D stepped at the full lr: its first gradient is as the
    reference's, only its leaves' change tells."""
    from fmri_tpu_torch.train import steps_wae

    latent_d_step = steps_wae._latent_d_step

    def at_lr(state, opt, d_real_in, d_fake_in, lam, lr, mesh=None):
        return latent_d_step(state, opt, d_real_in, d_fake_in, lam, 2 * lr, mesh)

    monkeypatch.setattr(steps_wae, "_latent_d_step", at_lr)


@pytest.mark.parametrize("fault", [_unchanged, _one_tick, _altered_gradient, _disc_at_lr])
def test_a_broken_wae_step_is_not_correct(tmp_path, capsys, monkeypatch, fault):
    bench = wae_bench(tmp_path)
    fault(monkeypatch)
    assert run_cell(bench, CELL) == 0
    assert last_result(capsys.readouterr().out)["correct"] is False


def test_the_control_and_the_faults_are_not_correct(tmp_path):
    """The reference in the program's place in float8, on half the rows,
    ticking the encoder's statistics once or stepping the latent D at the
    full lr fails the cell's limits."""
    from portbench import control_wae as control

    bench = wae_bench(tmp_path, compute_dtype="bfloat16")
    c, config, traffic = harness.load_cell(CELL, bench)
    kind = harness.traffic_kind(traffic["kind"], bench)
    got = control.control_numbers(config, traffic, 2**31 + 7, torch.device("cpu"),
                                  control.FAULTS)
    assert set(got) == set(control.FAULTS)
    for fault, numbers in got.items():
        assert not harness.judge(numbers, kind.limits_of(c)), (fault, numbers)
    assert got["one_tick"]["grad_gap"] == 0.0 and got["one_tick"]["running_gap"] > 1.0
    # a faster D moves the first gradient through the penalty alone
    assert got["disc_lr"]["grad_gap"] < 1e-3 and got["disc_lr"]["change_gap"] > 0.5


def test_the_reconstruction_does_not_reach_the_shift_of_mu(tmp_path):
    """The decoder's fc has no bias and its BatchNorm takes each column's
    batch mean away: the reference's reconstruction part of l_mu.bias's
    first gradient is rounding alone, and that leaf alone is left out of the
    change's comparison."""
    from portbench.reference import vaegan
    from portbench.reference import wae as ref

    bench = wae_bench(tmp_path)
    _, config, traffic = harness.load_cell(CELL, bench)
    kind = harness.traffic_kind(traffic["kind"], bench)
    cpu = torch.device("cpu")
    imgs, w0 = kind.inputs(config, 5, cpu)
    steps = kind.reference_steps([kind.drawer(config, traffic, 5, cpu)()], imgs, 5, 8, cpu)
    got = ref.train_steps(w0, steps, config["model"], config["train"],
                          vaegan.Precision("float32"))
    assert kind.penalty_only(got) == ["encoder.l_mu.bias"]
    share = {k: r / got["grad1"][k] for k, r in got["grad1_rec"].items() if got["grad1"][k]}
    assert share.pop("encoder.l_mu.bias") < 1e-3
    assert min(share.values()) > 0.5, sorted(share.items(), key=lambda kv: kv[1])


def test_the_latent_disc_readers(tmp_path, readers):
    ctx = _ctx(tmp_path)  # a trace of the program's spans without train.latent_disc
    for name in NEW:
        assert readers[name].read(ctx) is None, name
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    for s in (0.0, 1000.0):  # phase 1 of each step, inside its forward's time
        events.append({"ph": "X", "cat": "user_annotation", "name": "fmri.train.latent_disc",
                       "tid": 101, "ts": s + 30, "dur": 40})
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": events}))
    from portbench.trace import Trace

    ctx.trace = Trace(str(tmp_path / "trace.json"))
    assert readers["latent_disc_host_ms.train"].read(ctx) == pytest.approx(0.04)
    # one launch a step at 35 us, inside the span
    assert readers["latent_disc_launches_per_step.train"].read(ctx) == pytest.approx(1.0)
    assert readers["latent_disc_host_ms.train"].read(harness.Context("train")) is None


@pytest.fixture(scope="module")
def readers():
    return harness.readers()


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import portbench.reference.wae; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax') or m.split('.')[0].startswith('fmri_tpu')))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout
    assert out.strip() == "[]"
    with open(os.path.join(BENCH, "reference", "wae.py")) as f:
        assert "fmri_tpu" not in f.read()
