"""WAE/GAN stage-I training traffic: ``stages.wae_stage1``'s step driven as
``Trainer.fit`` drives it, through its own feed, for a fixed time.

Mix parameters: ``batch``, ``warmup_steps`` (the first ``checked_steps`` of
them are compared with the reference) and ``prefetch``
(``device_iterator``'s read-ahead). The set is the configuration's
``train_images`` made from the seed, kept on the host as uint8, shuffled
each epoch by ``Batches`` and staged by ``device_iterator``'s producer
thread; each step's flips and then its z_fake = ``wae_sigma`` * N(0, 1) per
row are drawn on the device from the seed, in the trainer's order, and
``train_augment`` flips, dequantizes and normalizes. Epochs turn over
inside the window, under cuDNN's deterministic algorithms as the trainer
sets them.

End-to-end metrics, the result line and the counters the per-layer readers
read are ``train_loop.py``'s. The comparison: the set-up's checked steps,
the window's own steps 1..k, against ``reference/wae.py`` run from the same
weights and inputs after the window. Compared (``harness.train_numbers``):
the four step-1 losses; each leaf's first gradient as Adam took it
(sqrt(sum nu / (1 - b2)) after one step from zero moments); each leaf's
change after the checked steps, the worst and the median, over the leaves
the reconstruction reaches (:func:`penalty_only`); and ``running_gap``,
this kind's own: the worst of the encoder's BatchNorm running statistics
after each checked step against the reference's, a mean's gap over the norm
of the reference's running standard deviation, a variance's over the
reference's variance. Its limit is the cell's ``own_limits``, beside
``limits``. There are no gates.
"""

from __future__ import annotations

import gc
import os
import sys
import tempfile
import time

import torch

from portbench import datagen, harness
from portbench.counts_wae import step_totals
from portbench.reference import wae as ref

train_loop = harness.traffic_kind("train_loop", os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

RUNNING = ("running_mean", "running_var")
RECON_REACH = 1e-2  # a leaf's reconstruction part of its first gradient, over the whole


def inputs(config: dict, seed: int, device):
    """(uint8 images on the host, the weights on the device), from the seed."""
    m = config["model"]
    imgs = datagen.images(config["train_images"], m["image_size"], seed, device)
    return imgs, datagen.weights(ref.specs(m), seed, device)


def drawer(config: dict, traffic: dict, seed: int, device):
    """``draws() -> {"flip", "z_fake"}`` of each step in turn, on the device
    from the seed, in the trainer's order."""
    b, latent = traffic["batch"], config["model"]["latent_dim"]
    sigma = config["train"]["wae_sigma"]
    gen = datagen.generator(seed, datagen.STEPS, device)

    def draws():
        flip = torch.rand(b, generator=gen, device=device) < 0.5
        return {"flip": flip,
                "z_fake": sigma * torch.randn((b, latent), generator=gen, device=device)}

    return draws


def reference_steps(checked, imgs, seed: int, b: int, device):
    """The reference's inputs of the checked steps."""
    return train_loop.reference_steps(checked, imgs, imgs, seed, b, device)


def encoder_running(sd) -> dict:
    """A copy of the encoder's running statistics in a state dict."""
    return {k: v.detach().clone() for k, v in sd.items()
            if k.startswith("encoder.") and k.endswith(RUNNING)}


def running_gaps(prog, ref_running) -> dict:
    """Each of the encoder's running statistics' gap after each checked
    step, ``step<i>.<key>`` (see the module)."""
    gaps = {}
    for i, (p, r) in enumerate(zip(prog, ref_running)):
        for k, want in r.items():
            got, want = p[k].to(want.device).double(), want.double()
            if k.endswith("running_mean"):
                scale = torch.linalg.vector_norm(torch.sqrt(r[k[:-4] + "var"].double()))
            else:
                scale = torch.linalg.vector_norm(want)
            gaps[f"step{i + 1}.{k}"] = float(torch.linalg.vector_norm(got - want) / scale)
    return gaps


def _readings_grad1(state, b2: float) -> dict:
    """Each trained leaf's first gradient as Adam took it: from zero moments
    one step leaves nu = (1 - b2) g^2."""
    out = {}
    for g, st in state.opt_state.items():
        pre = state.nets.PREFIXES[g]
        for k, nu in st.nu.items():
            out[pre + k] = float(torch.sqrt(nu.double().sum() / (1.0 - b2)))
    return out


def _losses(metrics: dict) -> dict:
    return {h: float(metrics["loss_" + h]) for h in
            ("reconstruction", "penalty", "discriminator_fake", "discriminator_real")}


def penalty_only(expected: dict) -> list:
    """The leaves whose first gradient in the reference the reconstruction
    does not reach: its part under ``RECON_REACH`` of the whole. In the
    thesis's nets that is ``encoder.l_mu.bias``: the decoder's fc has no
    bias and its BatchNorm takes each column's batch mean away, so a shift
    of mu common to every row leaves the reconstruction as it was. The
    program's gradient there is the penalty's plus what rounding leaves of
    the reconstruction's row terms, which cancel in exact arithmetic and
    are far larger than the penalty's; Adam's first steps move each weight
    by about lr x sign(g), so that leaf's change is rounding's. Its first
    gradient's norm is still compared."""
    return sorted(k for k, r in expected["grad1_rec"].items()
                  if r < RECON_REACH * expected["grad1"][k])


def compare(readings: dict, expected: dict) -> dict:
    """The compared numbers of the judged side's ``readings`` against the
    reference's ``expected`` (both: losses, grad1, change, running)."""
    numbers = harness.train_numbers(dict(readings, gates=[]),
                                    dict(expected, gates=[], means=[]))
    del numbers["gate_gap"]
    out = penalty_only(expected)
    print(f"the change of the leaves the reconstruction reaches (not {out}):", file=sys.stderr)
    reached = {h: {k: v for k, v in expected[h].items() if k not in out}
               for h in ("grad1", "change")}
    part = harness.train_numbers(dict(readings, gates=[]),
                                 dict(expected, gates=[], means=[], **reached))
    numbers.update(change_gap=part["change_gap"], change_gap_median=part["change_gap_median"])
    gaps = running_gaps(readings["running"], expected["running"])
    worst = max(gaps, key=gaps.get)
    print(f"worst running gap: {worst} {gaps[worst]!r}", file=sys.stderr)
    numbers["running_gap"] = gaps[worst]
    return numbers


def limits_of(cell: dict) -> dict:
    return dict(cell["limits"], **cell.get("own_limits", {}))


def program(config: dict, traffic: dict, imgs, w0: dict, seed: int, device, spans=None):
    """``stages.wae_stage1``'s state from the weights ``w0`` and ``step() ->
    (metrics, draws, x)``: the feed's next batch (``Batches`` shuffled from
    the seed, ``device_iterator``'s producer thread, epoch after epoch), its
    draws, ``train_augment`` and one train step. Also the feed, to close."""
    from fmri_tpu_torch.data.pipeline import Batches, device_iterator
    from fmri_tpu_torch.data.transforms import train_augment
    from fmri_tpu_torch.train import stages

    b = traffic["batch"]
    draws = drawer(config, traffic, seed, device)
    mean, std = tuple(config["data"]["mean"]), tuple(config["data"]["std"])
    state, steps_fns, _ = stages.wae_stage1(harness.program_config(config, b),
                                            steps_per_epoch=config["train_images"] // b,
                                            seed=seed, device=str(device))
    state.nets.load_state_dict(w0, strict=True)
    train_step = steps_fns.train_step
    batches = Batches(imgs, b, shuffle=True, seed=seed)

    def epochs():
        while True:
            yield from device_iterator(iter(batches), device, prefetch=traffic["prefetch"])

    feed = epochs()

    def step():
        with harness.Span(spans, "input_wait"):
            batch = next(feed)
        d = draws()
        x = train_augment(batch, d["flip"], None, mean, std)
        with harness.Span(spans, "step"):
            return train_step(state, x, {"z_fake": d["z_fake"]})[1], d, x

    return state, step, feed


def run(cell, config, traffic, *, seed: int, seconds: float, trace: bool, device,
        bench: str = harness.BENCH) -> int:
    from fmri_tpu_torch.device import deterministic_cudnn, resolve_device

    cuda = device.type == "cuda"
    resolve_device(device)  # TF32 off, as every entry point of the program sets it
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    b = traffic["batch"]
    m, t = config["model"], config["train"]
    spe = config["train_images"] // b

    imgs, w0 = inputs(config, seed, device)
    ctx = harness.Context("train")
    spans = ctx if trace else None
    state, program_step, feed = program(config, traffic, imgs, w0, seed, device, spans)
    checked, readings = [], {"losses": [], "running": []}

    def step():
        metrics, d, _ = program_step()
        if len(checked) < traffic["checked_steps"]:
            checked.append(d)
        return metrics

    with deterministic_cudnn():
        for i in range(traffic["warmup_steps"]):
            metrics = step()
            if i < traffic["checked_steps"]:
                readings["losses"].append(_losses(metrics))
                readings["running"].append(encoder_running(state.nets.state_dict()))
            if i == 0:
                readings["grad1"] = _readings_grad1(state, t["adam_b2"])
            if i + 1 == traffic["checked_steps"]:
                readings["change"] = train_loop._readings_change(state, w0)
        w0 = {k: v.cpu() for k, v in w0.items()}
        if trace:
            harness.warm_profiler(cuda)
        ctx.spans.clear()
        sync()
        gc_clock = harness.GcClock()
        setup_s = harness.process_age_s()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        prof, traced_steps = None, 0
        profile_from = seconds - min(2.0, seconds / 2)
        t0 = time.perf_counter()
        steps = 0
        while True:
            if trace and prof is None and time.perf_counter() - t0 >= profile_from:
                sync()
                prof = harness.profiler(cuda)
                prof.start()
                first_traced = steps
            step()
            steps += 1
            if time.perf_counter() - t0 >= seconds and (prof is not None or not trace):
                break
        sync()
        window_s = time.perf_counter() - t0
        gc_clock.stop()
        if prof is not None:
            prof.stop()
            traced_steps = steps - first_traced
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: loaded {found}", file=sys.stderr)
        return 3
    peak = torch.cuda.max_memory_allocated() if cuda else 0  # the window's
    feed.close()
    del state, step, program_step, feed
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the reference over the checked steps, from the same weights and inputs
    w_ref = {k: v.to(device) for k, v in w0.items()}
    expected = ref.train_steps(w_ref, reference_steps(checked, imgs, seed, b, device), m, t,
                               ref.Precision("float32"), steps_per_epoch=spe)
    print(gc_clock.summary(), file=sys.stderr)
    numbers = compare(readings, expected)
    limits = limits_of(cell)
    correct = harness.judge(numbers, limits)

    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    attempted = traffic["warmup_steps"] + steps
    if not trace:
        metrics_out = {"train_images_per_s": {"value": steps * b / window_s, "unit": "images/s"},
                       "setup_s": {"value": setup_s, "unit": "s"}}
        result = {"correct": correct, "attempted": attempted, "failed": 0,
                  "metrics": metrics_out, "device": dev_info}
    else:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            from portbench.trace import Trace

            ctx.trace = Trace(path)
        totals = step_totals(m, b)
        ctx.counters.update(steps=steps, traced_steps=traced_steps, window_s=window_s,
                            model_flops=totals["flops"], least_s=totals["least_s"],
                            peak_window_bytes=peak, gc_s=gc_clock.seconds())
        result = {"correct": correct, "attempted": attempted, "failed": 0,
                  "metrics": harness.per_layer(ctx, ["train_images_per_s"], bench),
                  "device": dict(dev_info, **harness.trace_device(ctx)),
                  "breakdown": harness.breakdown(ctx)}
    harness.emit(result, numbers, limits)
    return 0
