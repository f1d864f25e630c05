"""Serving traffic: independent users sending one fMRI scan each, on an open
loop at a fixed rate, to the stage-III cognitive model (scan -> image)
behind ``ServingModel`` (CUDA graphs per bucket) and ``BatchingServer``.

Mix parameters: ``rate_per_s``; ``max_batch``, ``max_wait_ms`` and
``output`` of the server; ``pool`` (distinct scans made from the seed;
requests draw from them); ``warm_seconds`` of the same traffic before the
window, counted in set-up; ``sample`` (requests whose images are checked)
and ``calibration_rows`` (scans whose BatchNorm statistics become the
running ones, so the images stay unsaturated).

Arrivals: the same ``rate_per_s * seconds`` gaps in every run, the
quantiles of an exponential distribution, in an order drawn from the seed,
so every seed offers the same load. A request is timed from when it was
due to its Future's result; a request shed or failed counts as slower than
any limit. End-to-end: ``serve_p95_ms`` over every request due in the
window, and ``setup_s``. The comparison: a sample of the window's requests,
drawn from the seed, each image as the batcher returned it against the
reference's.
"""

from __future__ import annotations

import functools
import gc
import os
import sys
import tempfile
import time

import numpy as np
import torch

from portbench import datagen, harness
from portbench.reference import vaegan as ref

# requests resolved more than this long after the window closed never came
LATE_S = 60.0


def _specs(m: dict):
    return ref.cognitive_encoder_spec(m) + ref.decoder_spec(m)


def inputs(config: dict, traffic: dict, seed: int, device):
    """(scans [pool, V] on the host, the weights and running statistics on
    the device), from the seed."""
    m = config["model"]
    scans = datagen.scans(traffic["pool"], m["num_voxels"], seed, device)
    w = datagen.weights(_specs(m), seed, device)
    ref.calibrate(w, torch.from_numpy(scans[:traffic["calibration_rows"]]).to(device), m)
    return scans, w


def sample_rows(traffic: dict, seed: int) -> np.ndarray:
    """A sample of pool rows drawn from the seed (the control's inputs)."""
    rng = np.random.default_rng(datagen.word(seed, datagen.SAMPLE))
    return rng.choice(traffic["pool"], traffic["sample"], replace=False)


def reference_images(w: dict, scans: np.ndarray, config: dict, device,
                     precision: ref.Precision, block: int = 256) -> np.ndarray:
    out = []
    for lo in range(0, len(scans), block):
        v = torch.from_numpy(np.ascontiguousarray(scans[lo:lo + block])).to(device)
        out.append(ref.serve_images(w, v, config["model"], precision).cpu().numpy())
    return np.concatenate(out)


def arrivals(rate: float, seconds: float, seed: int, stream: int) -> np.ndarray:
    """Due times (s from the start) of ``rate * seconds`` requests."""
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    np.random.default_rng(datagen.word(seed, stream)).shuffle(gaps)
    return np.cumsum(gaps)


class _Load:
    """One open loop: submits request i at ``start + due[i]`` from this
    thread and records, from the Future's callback, when it resolved."""

    def __init__(self, server, scans, due, which, sample=(), profile_at=None, cuda=False):
        self.server, self.scans, self.due, self.which = server, scans, due, which
        n = len(due)
        self.sent = np.full(n, np.nan)
        self.done = np.full(n, np.nan)
        self.failed = np.zeros(n, bool)
        self.sample = set(int(i) for i in sample)
        self.images = {}
        self.resolved = 0
        self.profile_at, self.prof, self.cuda = profile_at, None, cuda

    def _finish(self, i, fut):
        self.done[i] = time.perf_counter()
        if fut.exception() is not None:
            self.failed[i] = True
        elif i in self.sample:
            self.images[i] = fut.result()
        self.resolved += 1

    def run(self):
        from fmri_tpu_torch.eval.serve import ServerOverloaded

        self.start = time.perf_counter() + 0.002
        submitted = 0
        for i, due in enumerate(self.due):
            target = self.start + due
            now = time.perf_counter()
            if target > now:
                time.sleep(target - now)
                now = time.perf_counter()
            if self.profile_at is not None and self.prof is None and due >= self.profile_at:
                self.prof = harness.profiler(self.cuda)
                self.prof.start()
            self.sent[i] = now
            try:
                fut = self.server.submit(self.scans[self.which[i]])
            except ServerOverloaded:
                self.failed[i] = True
                continue
            submitted += 1
            fut.add_done_callback(functools.partial(self._finish, i))
        close = self.start + self.due[-1]
        while self.resolved < submitted and time.perf_counter() < close + LATE_S:
            time.sleep(0.002)
        if self.prof is not None:
            if self.cuda:
                torch.cuda.synchronize()
            self.prof.stop()
        late = np.isnan(self.done) & ~self.failed
        self.failed |= late
        return self

    def latencies_s(self) -> np.ndarray:
        lat = self.done - (self.start + self.due)
        lat[self.failed] = np.inf
        return lat

    def lag_s(self) -> np.ndarray:
        lag = self.sent - (self.start + self.due)
        return lag[~np.isnan(lag)]


def _p95(a: np.ndarray) -> float:
    return float(np.percentile(a, 95)) if len(a) else float("nan")


def run(cell, config, traffic, *, seed: int, seconds: float, trace: bool, device,
        bench: str = harness.BENCH) -> int:
    from fmri_tpu_torch.eval.serve import BatchingServer, ServingModel
    from fmri_tpu_torch.eval.steps import VaeGanCognitive

    cuda = device.type == "cuda"
    cfg = harness.program_config(config, traffic["max_batch"])
    scans, w = inputs(config, traffic, seed, device)
    rng = np.random.default_rng(datagen.word(seed, datagen.ARRIVALS))
    rate = traffic["rate_per_s"]

    model = VaeGanCognitive(cfg.model).to(device)
    model.load_state_dict(w, strict=True)
    w = {k: v.cpu() for k, v in w.items()}
    served = ServingModel(cfg, model, family="vgan", stage=3, max_batch=traffic["max_batch"],
                          output=traffic["output"], device=device)
    served.warmup(generate=False)
    ctx = harness.Context("serve")
    if trace:
        call = served.reconstruct

        def reconstruct(x):
            with harness.Span(ctx, "reconstruct"):
                return call(x)

        served.reconstruct = reconstruct
    server = BatchingServer(served, max_wait_ms=traffic["max_wait_ms"])
    try:
        warm_due = arrivals(rate, traffic["warm_seconds"], seed, datagen.ARRIVALS + 100)
        _Load(server, scans, warm_due, rng.integers(0, len(scans), len(warm_due))).run()
        due = arrivals(rate, seconds, seed, datagen.ARRIVALS)
        which = rng.integers(0, len(scans), len(due))
        sample = np.random.default_rng(datagen.word(seed, datagen.SAMPLE)).choice(
            len(due), min(traffic["sample"], len(due)), replace=False)
        if trace:
            harness.warm_profiler(cuda)
        ctx.spans.clear()
        before = server.stats()
        setup_s = harness.process_age_s()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        load = _Load(server, scans, due, which, sample,
                     profile_at=seconds - min(2.0, seconds / 2) if trace else None,
                     cuda=cuda).run()
        after = server.stats()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
    finally:
        server.close()
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: loaded {found}", file=sys.stderr)
        return 3
    del server, served, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    got = [i for i in sorted(load.sample) if i in load.images]
    w_dev = {k: v.to(device) for k, v in w.items()}
    expected = reference_images(w_dev, scans[which[got]], config, device,
                                ref.Precision("float32"))
    numbers = harness.serve_numbers(np.stack([load.images[i] for i in got]), expected)
    out_std = float(expected.astype(np.float64).std())
    saturated = float(np.mean((expected == 0) | (expected == 255)))
    print(f"reference images: std {out_std!r} levels, {saturated!r} of values at 0 or 255",
          file=sys.stderr)
    limits = cell["limits"]
    # a sampled request that never came is wrong here; one that failed is counted in `failed`
    correct = harness.judge(numbers, limits) and len(got) == len(
        [i for i in load.sample if not load.failed[i]])
    failed = int(load.failed.sum())
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    lat = load.latencies_s()
    p95 = _p95(lat)
    fifth = max(len(lat) // 5, 1)
    print(f"requests {len(due)} failed {failed} p50 {1e3 * float(np.percentile(lat, 50))!r} ms "
          f"p95 {1e3 * p95!r} ms p99 {1e3 * float(np.percentile(lat, 99))!r} ms (p95 of the "
          f"first fifth {1e3 * _p95(lat[:fifth])!r}, of the last {1e3 * _p95(lat[-fifth:])!r}), "
          f"batches {after['batches'] - before['batches']}, generator lag p95 "
          f"{1e3 * _p95(load.lag_s())!r} ms", file=sys.stderr)
    if not trace:
        metrics = {"serve_p95_ms": {"value": 1e3 * p95 if np.isfinite(p95) else 3.6e6,
                                    "unit": "ms"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
        result = {"correct": correct, "attempted": len(due), "failed": failed,
                  "metrics": metrics, "device": dev_info}
    else:
        ctx.counters.update(requests=after["requests"] - before["requests"],
                            batches=after["batches"] - before["batches"],
                            lag_p95_s=_p95(load.lag_s()))
        if load.prof is not None:
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                load.prof.export_chrome_trace(path)
                from portbench.trace import Trace

                ctx.trace = Trace(path)
        result = {"correct": correct, "attempted": len(due), "failed": failed,
                  "metrics": harness.per_layer(ctx, ["serve_p95_ms"], bench),
                  "device": dict(dev_info, **harness.trace_device(ctx)),
                  "breakdown": harness.breakdown(ctx)}
    harness.emit(result, numbers, limits)
    return 0
