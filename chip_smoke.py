#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``fmri_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, on a machine with a card

Phases, each of which fails the run (exit code 1) on a failed check:
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: every kernel under fmri_tpu_torch/ops/csrc, one nvcc each;
  3. ssim: the CUDA SSIM kernel against its plain PyTorch version at
     [64,64,64,3], [8,100,100,3], [4,16,16,3], [4,8,8,3], both reductions,
     atol 1e-5 on the means; identical images give 1.0 within 1e-5;
  4. inference: res64 (3,620 voxels -> 1,024 -> latent 128 -> 64 px),
     random weights made from a seed in the JAX layout and converted with
     ``from_jax_groups``; 1,024 synthetic pairs at batch 64 through
     ``reconstruct_dataset``, ``quality_metrics`` and ``objective_scores``
     (2/5/10-way). The SSIM kernel's launches are counted over this phase
     alone and must be above 0; the metrics must agree with the same run on
     the plain SSIM (SSIM within 1e-5, n-way fractions within 1/N), and a
     small batch must agree with the same model on the CPU (atol 1e-4: cuDNN
     may pick FFT or Winograd convolutions, which round differently);
  5. serving: ``ServingModel`` (max_batch 64, uint8 output) answers requests
     of 1, 5, 64 and 130 rows and ``generate(4)``; a request reconstructed
     alone equals it reconstructed inside a padded batch (float output
     within 1e-5; uint8 within 1 LSB, as cuDNN may pick another algorithm
     per batch size);
  6. kernels: one JSON line per the port's kernels with launches on the
     main path, error against the plain version, warm times from CUDA
     events, and the bound computed from this run's shapes.

The last line of standard output is ``{"ok": true, "device": {...}}``. Without
a CUDA device, or outside a checkout of the repository, it exits non-zero and
prints no result. Imports nothing of JAX and nothing of ``fmri_tpu``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# NVIDIA H100 SXM, dense fp32 outside the tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
TOL = 1e-5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def cuda_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ssim_bound(shape, window: int = 11):
    """(bound ms, bound_by) of one SSIM over NHWC fp32 ``shape``: the larger
    of its FLOP over the fp32 peak and its bytes (both inputs read once, one
    sum per plane written) over the memory rate. FLOP the function needs, per
    plane: the separable blur, 5 moments x 2 FLOP per tap, counting only the
    taps that land on the image (horizontal pass over the H real rows,
    vertical pass over the H' output rows; taps on the zero padding add
    nothing), 3 products per input pixel, and 18 per output pixel for the
    formula and the sum."""
    from fmri_tpu_torch.ops.ssim import geometry

    b, h, w, c = shape
    k, pad, ho, wo = geometry(h, w, window)

    def taps(n_in, n_out):
        """Taps of a 1-D blur of n_out outputs that land on the n_in samples."""
        return sum(max(0, min(n_in, j - pad + k) - max(0, j - pad))
                   for j in range(n_out))

    per_plane = (10 * h * taps(w, wo) + 10 * wo * taps(h, ho)
                 + 3 * h * w + 18 * ho * wo)
    flops = per_plane * b * c
    nbytes = 2 * b * h * w * c * 4 + b * c * 4
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA GPU")
    try:
        from fmri_tpu_torch.checkpoints.convert import from_jax_groups, random_groups
        from fmri_tpu_torch.configs import get_config
        from fmri_tpu_torch.data.synthetic import synthetic_pairs
        from fmri_tpu_torch.device import resolve_device
        from fmri_tpu_torch.eval.evaluate import (
            objective_scores, quality_metrics, reconstruct_dataset,
        )
        from fmri_tpu_torch.eval.serve import ServingModel
        from fmri_tpu_torch.eval.steps import VaeGanCognitive
        from fmri_tpu_torch.metrics.quality import distractor_indices
        from fmri_tpu_torch.ops import build
        from fmri_tpu_torch.ops.ssim import ssim, ssim_plain, ssim_plane_sums
    except ImportError as e:
        fail(f"run from the root of a checkout of the repository ({e})")

    # 1. device
    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    print(f"[device] {smi} | torch {torch.__version__} | cuda {torch.version.cuda}"
          f" | {torch.cuda.get_device_name(0)}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    build.build()
    print(f"[build] {build.kernel_names()} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # 3. ssim kernel vs plain
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = 0.0
    for shape in [(64, 64, 64, 3), (8, 100, 100, 3), (4, 16, 16, 3), (4, 8, 8, 3)]:
        a = torch.rand(shape, generator=gen, device=dev)
        b = (a + 0.1 * torch.randn(shape, generator=gen, device=dev)).clamp(0, 1)
        for mode in (True, False):
            err = float((ssim(a, b, size_average=mode)
                         - ssim_plain(a, b, size_average=mode)).abs().max())
            check(err <= TOL, f"ssim {shape} size_average={mode}: |kernel - plain| "
                              f"= {err} > {TOL}")
            max_err = max(max_err, err)
        one = float(ssim(a, a))
        check(abs(one - 1.0) <= TOL, f"ssim {shape} of identical images = {one}")
        print(f"[ssim] {list(shape)} ok (max |kernel - plain| so far {max_err:.3g})",
              flush=True)

    # 4. inference on the main path
    cfg = get_config("res64")
    n, bs = 1024, 64
    data = synthetic_pairs(n, cfg.data.image_size, cfg.model.num_voxels, seed=0)
    state = from_jax_groups(random_groups(cfg, seed=0), cfg)
    model = VaeGanCognitive(cfg.model)
    model.load_state_dict(state, strict=True)
    model.to(dev)
    batches = [{k: v[lo:lo + bs] for k, v in data.items()} for lo in range(0, n, bs)]

    def main_path():
        """(recons, targets, metrics, scores, host seconds per stage)."""
        seconds = {}

        def stage(name, fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t
            return out

        r, t = stage("reconstruct", lambda: reconstruct_dataset(
            model, batches, mean=cfg.data.mean, std=cfg.data.std))
        m = stage("quality_metrics", lambda: quality_metrics(r, t))
        s = stage("objective_scores", lambda: objective_scores(r, t, tops=(2, 5, 10)))
        return r, t, m, s, seconds

    ssim_plane_sums.launches = 0
    recons, targets, metrics, scores, cold = main_path()
    launches = {"ssim": ssim_plane_sums.launches}
    warm = main_path()[-1]
    print(f"[inference] {n} images; metrics {metrics}; objective {scores}; "
          f"launches {launches}", flush=True)
    print(f"[inference] host seconds by stage, first run {cold}, warm run {warm}",
          flush=True)
    t0 = time.perf_counter()
    for top in (2, 5, 10):
        distractor_indices(n, top)
    print(f"[inference] of which drawing the 2/5/10-way distractor indices on the "
          f"host: {time.perf_counter() - t0:.4f} s", flush=True)
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the main path")
    check(tuple(recons.shape) == (n, 64, 64, 3), f"recons shape {tuple(recons.shape)}")
    check(bool(torch.isfinite(recons).all()), "non-finite reconstructions")
    check(0.0 <= float(recons.min()) and float(recons.max()) <= 1.0,
          "reconstructions outside [0, 1]")

    plain_metrics = quality_metrics(recons, targets, ssim_fn=ssim_plain)
    plain_scores = objective_scores(recons, targets, tops=(2, 5, 10),
                                    ssim_fn=ssim_plain)
    err = abs(metrics["ssim"] - plain_metrics["ssim"])
    max_err = max(max_err, err)
    check(err <= TOL, f"quality ssim {metrics['ssim']} vs plain {plain_metrics['ssim']}")
    check(metrics["pcc"] == plain_metrics["pcc"] and metrics["mse"] == plain_metrics["mse"],
          "pcc/mse differ between two runs of the same arrays")
    for key in ("pcc", "ssim"):
        for got, ref in zip(scores[key], plain_scores[key]):
            check(abs(got - ref) <= 1.0 / n,
                  f"objective {key}: {scores[key]} vs plain {plain_scores[key]}")

    cpu_model = VaeGanCognitive(cfg.model)
    cpu_model.load_state_dict(state, strict=True)
    small = torch.from_numpy(data["fmri"][:8])
    err = float((model.reconstruct(small.to(dev)).cpu()
                 - cpu_model.reconstruct(small)).abs().max())
    check(err <= 1e-4, f"card vs CPU reconstruction differ by {err}")
    print(f"[inference] agrees with the plain SSIM and with the CPU (|card - cpu| "
          f"= {err:.3g})", flush=True)

    # 5. serving
    served = ServingModel(cfg, model, max_batch=64, output="uint8", device=dev)
    served.warmup()
    fmri = data["fmri"]
    lo = 0
    for size in (1, 5, 64, 130):
        t0 = time.perf_counter()
        out = served.reconstruct(fmri[lo:lo + size])
        ms = 1e3 * (time.perf_counter() - t0)
        check(out.shape == (size, 64, 64, 3) and out.dtype.name == "uint8",
              f"serving request of {size}: {out.shape} {out.dtype}")
        print(f"[serving] request of {size} rows: {ms:.2f} ms", flush=True)
        lo += size
    gen_out = served.generate(4)
    check(gen_out.shape == (4, 64, 64, 3) and gen_out.dtype.name == "uint8",
          f"generate(4): {gen_out.shape} {gen_out.dtype}")
    x5 = fmri[:5]
    batched = served.reconstruct(x5).astype(int)
    lsb = max(int(abs(batched[i] - served.reconstruct(x5[i]).astype(int)).max())
              for i in range(5))
    check(lsb <= 1, f"uint8 request alone vs in a padded batch: {lsb} LSB")
    floats = ServingModel(cfg, model, max_batch=64, output="float", device=dev)
    fb = floats.reconstruct(x5)
    ferr = max(float(abs(fb[i] - floats.reconstruct(x5[i])).max()) for i in range(5))
    check(ferr <= TOL, f"float request alone vs in a padded batch: {ferr}")
    print(f"[serving] padded batch vs alone: float {ferr:.3g}, uint8 {lsb} LSB",
          flush=True)

    # 6. kernels line, at the main path's quality_metrics shape
    a, b = recons, targets
    ms = cuda_ms(lambda: ssim_plane_sums(a, b))
    entry_ms = cuda_ms(lambda: ssim(a, b))
    plain_ms = cuda_ms(lambda: ssim_plain(a, b), iters=10)
    bound_ms, bound_by = ssim_bound(tuple(a.shape))
    print(f"[kernels] ssim {list(a.shape)}: kernel alone {ms:.4f} ms, ssim() with "
          f"the wrapper's float64 mean {entry_ms:.4f} ms, plain {plain_ms:.4f} ms",
          flush=True)
    kernels = [{
        "name": "ssim",
        "route": "cuda",
        "source": "fmri_tpu_torch/ops/csrc/ssim.cu",
        "replaces": "fmri_tpu/ops/pallas_ssim.py:79",
        "launches": launches["ssim"],
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "shape": list(a.shape),
    }]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
