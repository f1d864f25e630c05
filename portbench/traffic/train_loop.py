"""Training traffic: the stage's train step driven as ``Trainer.fit`` drives
it, through its own feed, for a fixed time.

Mix parameters: ``stage`` (1: stage-I VAE/GAN on images; 2: stage-II
cognitive VAE/GAN on fMRI-image pairs), ``batch``, ``warmup_steps`` (the
first ``checked_steps`` of them are compared with the reference) and
``prefetch`` (``device_iterator``'s read-ahead). The set is the
configuration's ``train_images`` (stage I) or ``train_pairs`` (stage II)
made from the seed, kept on the host as uint8, shuffled each epoch by
``Batches`` and staged by ``device_iterator``'s producer thread; each step's
flips or shifts and noise are drawn on the device from the seed, and
``train_augment`` flips or shifts, dequantizes and normalizes. Epochs turn
over inside the window, as in a run of the trainer, under cuDNN's
deterministic algorithms as the trainer sets them.

End-to-end: ``train_images_per_s`` (every image trained in the window over
the window's time, which ends at the device's last kernel) and
``setup_s``. The comparison: the set-up's checked steps, which are the
window's own steps 1..k of the same state and feed, against the reference
run from the same weights and inputs after the window, training its groups
as the program's gates did. Python's collections in the window are timed
(``gc.callbacks``) and printed.
"""

from __future__ import annotations

import gc
import os
import sys
import tempfile
import time

import torch

from portbench import datagen, harness
from portbench.counts import step_totals
from portbench.reference import vaegan as ref


def _specs(m: dict, stage: int):
    if stage == 1:
        return (ref.visual_encoder_spec(m) + ref.decoder_spec(m) + ref.discriminator_spec(m))
    return (ref.cognitive_encoder_spec(m) + ref.decoder_spec(m) + ref.discriminator_spec(m)
            + ref.visual_encoder_spec(m, "teacher_net.encoder."))


def inputs(config: dict, stage: int, seed: int, device):
    """(uint8 images on the host, the set Batches reads, the tensors' specs,
    the weights on the device), from the seed."""
    m = config["model"]
    imgs = datagen.images(set_size(config, stage), m["image_size"], seed, device)
    data = imgs if stage == 1 else {"fmri": datagen.scans_of(imgs, m["num_voxels"], seed, device),
                                    "image": imgs}
    specs = _specs(m, stage)
    return imgs, data, specs, datagen.weights(specs, seed, device)


def set_size(config: dict, stage: int) -> int:
    """Rows of the stage's training set: COCO's images (stage I) or
    BOLD5000's fMRI-image pairs (stage II)."""
    return config["train_images"] if stage == 1 else config["train_pairs"]


def drawer(config: dict, traffic: dict, seed: int, device):
    """``draws() -> (flip or None, shifts or None, {noise})`` of each step in
    turn, on the device from the seed, in the trainer's order."""
    stage, b, latent = traffic["stage"], traffic["batch"], config["model"]["latent_dim"]
    gen = datagen.generator(seed, datagen.STEPS, device)
    names = ("eps", "z_p") if stage == 1 else ("eps", "eps_t", "z_p")

    def draws():
        flip = shifts = None
        if stage == 1:
            flip = torch.rand(b, generator=gen, device=device) < 0.5
        else:
            s = config["data"]["max_shift"]
            shifts = torch.randint(-s, s + 1, (b, 2), generator=gen, device=device)
        return flip, shifts, {k: torch.randn((b, latent), generator=gen, device=device)
                              for k in names}

    return draws


def reference_steps(checked, imgs, data, seed: int, b: int, device):
    """The reference's inputs of the checked steps: each step's rows of the
    first epoch and its draws."""
    order = harness.epoch_order(seed, 0, len(imgs))
    out = []
    for i, d in enumerate(checked):
        rows = order[i * b:(i + 1) * b]
        s = dict(d, x=torch.from_numpy(imgs[rows]).to(device))
        if isinstance(data, dict):
            s["fmri"] = torch.from_numpy(data["fmri"][rows]).to(device)
        out.append(s)
    return out


def _program(cfg, stage: int, steps_per_epoch: int, seed: int, w0: dict, device):
    """(state, train_step(state, batch, noise, *gate)) as the trainer's stage
    builder makes them, with the weights ``w0``. Stage II reads its
    stage-I groups (the teacher's encoder, the decoder and the
    discriminator) from a thesis-layout ``.pth`` written from ``w0``."""
    from fmri_tpu_torch.train import stages

    if stage == 1:
        state, steps, _ = stages.vgan_stage1(cfg, steps_per_epoch=steps_per_epoch, seed=seed,
                                             device=str(device))
        state.nets.load_state_dict(w0, strict=True)
        return state, steps.train_step
    teacher = "teacher_net.encoder."
    stage1 = {("encoder." + k[len(teacher):] if k.startswith(teacher) else k): v.cpu()
              for k, v in w0.items() if k.startswith((teacher, "decoder.", "discriminator."))}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "stage1.pth")
        torch.save(stage1, path)
        state, steps, _ = stages.vgan_stage2(cfg, path, steps_per_epoch=steps_per_epoch,
                                             seed=seed, device=str(device))
    # the teacher shares the decoder and the discriminator (train_vgan_stage2.py:229-232)
    shared = {f"teacher_net.{k}": v for k, v in w0.items()
              if k.startswith(("decoder.", "discriminator."))}
    state.nets.load_state_dict(dict(w0, **shared), strict=True)
    return state, steps.train_step


def _prefixes(state) -> dict:
    return {g: state.nets.PREFIXES[g] for g in state.opt_state}


def _readings_grad1(state, decay: float) -> dict:
    """Each trained leaf's first gradient as RMSprop took it: from zero
    moments one step leaves sq = (1 - decay) g^2."""
    out = {}
    for g, pre in _prefixes(state).items():
        for k, sq in state.opt_state[g].items():
            out[pre + k] = float(torch.sqrt(sq.double().sum() / (1.0 - decay)))
    return out


def _readings_change(state, w0: dict) -> dict:
    out = {}
    for g, pre in _prefixes(state).items():
        for k, p in state.nets.group(g).items():
            out[pre + k] = float(torch.linalg.vector_norm(p.detach() - w0[pre + k]))
    return out


def _losses(metrics: dict) -> dict:
    return {"encoder": float(metrics["loss_encoder"]), "decoder": float(metrics["loss_decoder"]),
            "discriminator": float(metrics["loss_discriminator"]),
            "reconstruction": float(metrics["loss_reconstruction"])}


def run(cell, config, traffic, *, seed: int, seconds: float, trace: bool, device,
        bench: str = harness.BENCH) -> int:
    from fmri_tpu_torch.data.pipeline import Batches, device_iterator
    from fmri_tpu_torch.data.transforms import train_augment
    from fmri_tpu_torch.device import deterministic_cudnn, resolve_device

    cuda = device.type == "cuda"
    resolve_device(device)  # TF32 off, as every entry point of the program sets it
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    stage, b = traffic["stage"], traffic["batch"]
    m, t = config["model"], config["train"]
    cfg = harness.program_config(config, b)
    spe = set_size(config, stage) // b

    imgs, data, specs, w0 = inputs(config, stage, seed, device)
    draws = drawer(config, traffic, seed, device)

    mean, std = tuple(config["data"]["mean"]), tuple(config["data"]["std"])
    ctx = harness.Context("train")
    spans = ctx if trace else None

    state, train_step = _program(cfg, stage, spe, seed, w0, device)
    gate = tuple(torch.tensor(v, dtype=torch.float32, device=device)
                 for v in (t["margin"], t["equilibrium"], t["lambda_mse"]))
    batches = Batches(data, b, shuffle=True, seed=seed)

    def epochs():
        while True:
            yield from device_iterator(iter(batches), device, prefetch=traffic["prefetch"])

    feed = epochs()
    checked, readings = [], {"losses": []}

    def step():
        with harness.Span(spans, "input_wait"):
            batch = next(feed)
        flip, shifts, noise = draws()
        if stage == 1:
            x = train_augment(batch, flip, shifts, mean, std)
        else:
            x = dict(batch, image=train_augment(batch["image"], flip, shifts, mean, std))
        if len(checked) < traffic["checked_steps"]:
            checked.append({"flip": flip, "shifts": shifts, **noise})
        with harness.Span(spans, "step"):
            return train_step(state, x, noise, *gate)[1]

    with deterministic_cudnn():
        for i in range(traffic["warmup_steps"]):
            metrics = step()
            if i < traffic["checked_steps"]:
                readings["losses"].append(_losses(metrics))
                readings.setdefault("gates", []).append(
                    (bool(metrics["train_dec"]), bool(metrics["train_dis"])))
            if i == 0:
                readings["grad1"] = _readings_grad1(state, t["rms_decay"])
            if i + 1 == traffic["checked_steps"]:
                readings["change"] = _readings_change(state, w0)
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
    del state, train_step, feed, batches
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the reference over the checked steps, from the same weights and inputs
    w_ref = {k: v.to(device) for k, v in w0.items()}
    expected = ref.train_steps(stage, w_ref, specs, reference_steps(checked, imgs, data, seed, b,
                                                                    device),
                               m, t, ref.Precision("float32"), follow=readings["gates"])
    print(gc_clock.summary(), file=sys.stderr)
    numbers = harness.train_numbers(readings, expected, harness.gate_thresholds(t))
    limits = cell["limits"]
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
        totals = step_totals(m, stage, b)
        ctx.counters.update(steps=steps, traced_steps=traced_steps, window_s=window_s,
                            model_flops=totals["flops"], least_s=totals["least_s"],
                            peak_window_bytes=peak, gc_s=gc_clock.seconds())
        result = {"correct": correct, "attempted": attempted, "failed": 0,
                  "metrics": harness.per_layer(ctx, ["train_images_per_s"], bench),
                  "device": dict(dev_info, **harness.trace_device(ctx)),
                  "breakdown": harness.breakdown(ctx)}
    harness.emit(result, numbers, limits)
    return 0

