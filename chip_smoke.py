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
     alone and must be above 0, and each is recorded with its shape (1,024
     images for ``quality_metrics``, 2,048, 5,120 and 10,240 for the n-way
     tests); the metrics must agree with the same run on
     the plain SSIM (SSIM within 1e-5, n-way fractions within 1/N), and a
     small batch must agree with the same model on the CPU (atol 1e-4: cuDNN
     may pick FFT or Winograd convolutions, which round differently);
  5. serving: ``ServingModel`` (max_batch 64, uint8 output) answers requests
     of 1, 5, 64 and 130 rows and ``generate(4)``; a request reconstructed
     alone equals it reconstructed inside a padded batch (float output
     within 1e-5; uint8 within 1 LSB, as cuDNN may pick another algorithm
     per batch size);
  6. train: the stage-I VAE/GAN step at res64 (full published widths,
     batch 64, fp32) with ``pallas_bn`` and ``pallas_backward`` on, so the
     BatchNorm backward and the conv/deconv weight grads run through the
     CUDA kernels ``bn_bwd_reduce``, ``bn_bwd_apply`` and ``tap_matmul``.
     Random weights from a seed in the JAX layout through
     ``from_jax_groups``, RMSprop moments started at ones, 64 synthetic
     images in [-1, 1]. Checks: one step against the same step with both
     flags off (the library backward) on the card, and one step at batch 8
     against the same step on the CPU, under the printed tolerances (losses
     1e-5 relative; parameter updates 2% and 3% in L2 per tensor, moments
     2%, BN statistics 1e-4); 5 timed
     steps with finite metrics, gates in {0, 1} and moved parameters; every
     kernel launched on the step, ``tap_matmul`` exactly 15 times (one per
     conv/deconv weight use: encoder 3, decoder 4 x 2 passes,
     discriminator 4); every kernel against its plain version at every
     shape the step gave it, with fp32 and with bf16 operands (BN 1e-5;
     dW 2e-5 with fp32 operands, which run as 3xTF32, and 1e-4 with bf16
     operands, whose products are exact in fp32; relative to the largest
     magnitude of the plain result), and the same bits twice; the weight
     grad's time per shape beside the library's;
  7. kernels: SSIM at every shape phase 4 recorded, against its plain
     version (the mean within 1e-5), per image against the plain version
     in float64 (``SSIM_IMAGE_TOL``), and the same bits twice; then one JSON line
     per the port's kernels with launches on the main path, error against
     the plain version, warm times summed over the main path's calls, and
     the bound computed from this run's shapes: FLOP at the rate of the
     unit the kernel uses (``tap_matmul``: 3xTF32 on the tensor cores, with
     the fp32 CUDA-core bound beside it as ``bound_ms_fp32_cuda_cores``),
     or bytes at the memory rate. ``ms`` times back-to-back wrapper calls
     with CUDA events (what the path feels, the host's cost included);
     ``device_ms`` replays a CUDA graph of the same calls (the card's time
     alone; ``device_ms_source`` says if the profiler stood in). Each
     entry's ``shapes`` gives both per shape; SSIM's ``ms_b1024`` is its
     time at [1024, 64, 64, 3] alone.

The last line of standard output is ``{"ok": true, "device": {...}}``. Without
a CUDA device, or outside a checkout of the repository, it exits non-zero and
prints no result. Imports nothing of JAX and nothing of ``fmri_tpu``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# NVIDIA H100 SXM (data sheet, dense): fp32 outside the tensor cores, TF32
# and bf16 on the tensor cores, HBM3 bandwidth. 3xTF32 makes three TF32
# passes for one fp32 product, so its rate is a third of TF32's.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 494.7e12
PEAK_3XTF32_FLOPS = PEAK_TF32_FLOPS / 3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
DW_LAUNCHES_PER_STEP = 15  # encoder 3, decoder 4 x 2 passes, discriminator 4
TOL = 1e-5
# The weight grad against its plain version, relative to the largest plain
# value. fp32 operands (3xTF32) read 3e-6 to 4e-6 on an H100; letting the
# tensor core accumulate a split's stages read 7.4e-5, single-pass TF32 more.
DW_TOL, DW_TOL_BF16 = 2e-5, 1e-4
# SSIM per image against float64 (the n-way tests compare per-image scores):
# fp32 cancellation in flat regions moves an image's mean by up to ~1e-4
# (the kernel and ssim_plain alike), so this bound catches a wrong window,
# tap or band, not rounding
SSIM_IMAGE_TOL = 1e-3


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


def device_ms(fn, calls: int = 20, replays: int = 5):
    """(ms, source): the card's time for one call of ``fn`` without the
    host's cost. A CUDA graph captures ``calls`` back-to-back calls and is
    replayed ``replays`` times between two events (source "cuda_graph").
    Where capture refuses a call, the device time of the kernels that
    ``torch.profiler`` sees over ``calls`` calls (source "profiler")."""
    import torch

    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()  # warm on the stream that captures
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        del graph
        return start.elapsed_time(end) / (replays * calls), "cuda_graph"
    except RuntimeError:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages())
        return us / 1e3 / calls, "profiler"


def ssim_bound(shape, window: int = 11):
    """(bound ms, bound_by) of one SSIM over NHWC fp32 ``shape``: the larger
    of its FLOP over the fp32 peak and its bytes over the memory rate."""
    return bound(*ssim_cost(shape, window))


def ssim_cost(shape, window: int = 11):
    """(FLOP, bytes) of one SSIM over NHWC fp32 ``shape``: both inputs read
    once, one sum per plane written. FLOP the function needs, per
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
    return flops, nbytes


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS):
    """(ms, bound_by): the larger of the FLOP at ``peak`` (default the fp32
    CUDA-core rate) and the bytes at the memory rate."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def bn_cost(x, kind: str):
    """(FLOP, bytes) of one BatchNorm backward pass over x [B, C, ...]: x
    and dy read once; the reduce writes [2, C] (5 FLOP per element: xhat,
    dy * xhat, two sums), the apply writes fp32 dx (10 FLOP per element);
    the per-channel vectors are counted too."""
    n, c, esz = x.numel(), x.shape[1], x.element_size()
    if kind == "reduce":
        return 5 * n, 2 * n * esz + 4 * c * 4
    return 10 * n, 2 * n * esz + 4 * n + 8 * c * 4


def taps_inside(n_in: int, n_out: int, k: int, stride: int, pad: int) -> int:
    """Sum over the k tap offsets of the output positions whose input index
    p * stride - pad + tap lies inside [0, n_in)."""
    return sum(0 <= p * stride - pad + t < n_in for t in range(k) for p in range(n_out))


def dw_cost(shifted, direct, k: int, stride: int, pad: int):
    """(FLOP, bytes) of one weight grad: 2 FLOP per product over the (tap,
    position) pairs that land inside the shifted operand (the zero padding
    needs none), both operands read once, the fp32 [Cu, Cs, k, k] written."""
    b, cs, hs, ws = shifted.shape
    _, cu, ph, pw = direct.shape
    pairs = taps_inside(hs, ph, k, stride, pad) * taps_inside(ws, pw, k, stride, pad)
    nbytes = (shifted.numel() + direct.numel()) * shifted.element_size() + cu * cs * k * k * 4
    return 2 * b * cs * cu * pairs, nbytes


def rel_err(got, ref) -> float:
    """max |got - ref| over max |ref|."""
    ref = ref.float()
    return float((got.float() - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


class Recorder:
    """Stands in for a kernel wrapper ``module.name`` while one step runs:
    each distinct call signature keeps a copy of its first arguments and a
    count, and the call goes on to the wrapper. ``launches`` reads and writes
    the wrapper's own count, which the wrapper bumps by its module-level
    name, so the launches still land on the wrapper."""

    def __init__(self, module, name: str, calls: dict):
        self.module, self.name, self.calls = module, name, calls
        self.orig = getattr(module, name)
        setattr(module, name, self)

    @property
    def launches(self) -> int:
        return self.orig.launches

    @launches.setter
    def launches(self, value: int) -> None:
        self.orig.launches = value

    def __call__(self, *args):
        import torch

        key = tuple((tuple(a.shape), str(a.dtype)) if torch.is_tensor(a) else a
                    for a in args)
        if key not in self.calls:
            self.calls[key] = [tuple(a.detach().clone() if torch.is_tensor(a) else a
                                     for a in args), 0]
        self.calls[key][1] += 1
        return self.orig(*args)

    def restore(self) -> None:
        setattr(self.module, self.name, self.orig)


def compare_steps(a, ma, b, mb, start) -> dict:
    """Worst relative differences of train state ``a`` (metrics ``ma``)
    from ``b``: losses; per tensor, the L2 norm of the difference over how
    far ``b`` moved the parameter from ``start`` (``param``) or over b's
    norm (BN running statistics, RMSprop moments); gate flags equal."""
    def rel(x, y, scale):
        return float((x.cpu().double() - y.cpu().double()).norm()
                     / max(float(scale.cpu().double().norm()), 1e-30))

    out = {"loss": max(abs(float(ma[k]) - float(mb[k])) / max(abs(float(mb[k])), 1e-12)
                       for k in ma if k.startswith("loss")),
           "gates_equal": all(float(ma[k]) == float(mb[k])
                              for k in ("train_dec", "train_dis")),
           "param": 0.0, "stats": 0.0, "sq": 0.0}
    sa, sb = a.nets.state_dict(), b.nets.state_dict()
    for k, v in sb.items():
        if k.endswith("num_batches_tracked"):
            continue
        if "running" in k:
            out["stats"] = max(out["stats"], rel(sa[k], v, v))
        else:
            out["param"] = max(out["param"], rel(sa[k], v, v.cpu() - start[k]))
    for g, moments in b.opt_state.items():
        for k, v in moments.items():
            out["sq"] = max(out["sq"], rel(a.opt_state[g][k], v, v))
    return out


def train_phase(dev, cfg):
    """Phase 6; returns the kernels-line entries of the three train kernels."""
    import dataclasses

    import numpy as np
    import torch

    from fmri_tpu_torch.checkpoints.convert import from_jax_groups, random_groups
    from fmri_tpu_torch.data.synthetic import synthetic_images
    from fmri_tpu_torch.ops import bn, dw
    from fmri_tpu_torch.train.optim import RmsProp
    from fmri_tpu_torch.train.state import GROUPS, VaeGan, make_state
    from fmri_tpu_torch.train.steps_vgan import make_vgan_stage1_step

    t = cfg.train
    cfg_on = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, pallas_bn=True, pallas_backward=True))
    weights = from_jax_groups(random_groups(cfg, seed=0, kind="vae-gan"), cfg, "vae-gan")

    def new_state(c, device):
        nets = VaeGan(c)
        nets.load_state_dict(weights, strict=True)
        state = make_state(nets.to(device), {g: RmsProp(t.rms_decay, t.rms_eps, t.grad_clip)
                                             for g in GROUPS})
        for moments in state.opt_state.values():  # warm, as tests/ref_oracle.py:110
            for v in moments.values():
                v.fill_(1.0)
        return state

    b, latent = t.batch_size, cfg.model.latent_dim
    x = torch.from_numpy(2.0 * synthetic_images(b, cfg.model.image_size, seed=0)[0]
                         - 1.0).to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    eps, z_p = (torch.randn((b, latent), generator=gen, device=dev) for _ in range(2))
    hyper = (t.margin, t.equilibrium, t.lambda_mse)
    step_on, step_off = make_vgan_stage1_step(cfg_on), make_vgan_stage1_step(cfg)
    kernels = {"bn_bwd_reduce": bn.bn_bwd_reduce, "bn_bwd_apply": bn.bn_bwd_apply,
               "tap_matmul": dw.tap_matmul}

    # the main path: one step with both flags on, every call recorded
    on = new_state(cfg_on, dev)
    calls = {n: {} for n in ("bn_bwd_reduce", "bn_bwd_apply", "conv2d_dw",
                             "conv2d_transpose_dw")}
    recorders = [Recorder(mod, n, calls[n]) for mod, n in (
        (bn, "bn_bwd_reduce"), (bn, "bn_bwd_apply"), (dw, "conv2d_dw"),
        (dw, "conv2d_transpose_dw"))]
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on, m_on = step_on.train_step(on, x, eps, z_p, *hyper)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in kernels.items()}
    for r in recorders:
        r.restore()
    print(f"[train] {cfg.model.image_size} px stage-I step, batch {b}, both kernel flags on: first step "
          f"{cold:.3f} s; launches per step {launches}; metrics "
          f"{ {k: round(float(v), 6) for k, v in m_on.items()} }", flush=True)
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the train step")
    check(launches["tap_matmul"] == DW_LAUNCHES_PER_STEP,
          f"tap_matmul: {launches['tap_matmul']} launches per step, want "
          f"{DW_LAUNCHES_PER_STEP} (one per conv/deconv weight use)")

    # 1. against the library backward (both flags off) on the card
    off, m_off = step_off.train_step(new_state(cfg, dev), x, eps, z_p, *hyper)
    d = compare_steps(on, m_on, off, m_off, weights)
    tol = {"loss": 1e-5, "param": 2e-2, "stats": 1e-4, "sq": 2e-2}
    print(f"[train] kernels vs library backward on the card: {d} (bounds {tol})",
          flush=True)
    check(d["gates_equal"] and all(d[k] <= v for k, v in tol.items()),
          f"flags on vs off: {d} outside {tol}")

    # 2. card against the CPU, batch 8
    small = (x[:8], eps[:8], z_p[:8])
    card, m_card = step_on.train_step(new_state(cfg_on, dev), *small, *hyper)
    cpu, m_cpu = step_on.train_step(new_state(cfg_on, "cpu"),
                                    *(a.cpu() for a in small), *hyper)
    d = compare_steps(card, m_card, cpu, m_cpu, weights)
    # batch 8 is ill-conditioned at res64 (BatchNorm over 8 images, KL terms
    # near 900 per image): fp32 runs differ from float64 by up to 3% of an
    # update on the decoder's FC BatchNorm (tests/test_torch_train.py)
    tol = {"loss": 1e-5, "param": 3e-2, "stats": 1e-4, "sq": 2e-2}
    print(f"[train] card vs CPU at batch 8: {d} (bounds {tol})", flush=True)
    check(d["gates_equal"] and all(d[k] <= v for k, v in tol.items()),
          f"card vs CPU: {d} outside {tol}")

    # 3. five timed steps (host clock, one synchronize at the end)
    before = {k: v.clone() for k, v in on.nets.state_dict().items()}
    for fn in kernels.values():
        fn.launches = 0
    n_steps = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    history = []
    for _ in range(n_steps):
        e, z = (torch.randn((b, latent), generator=gen, device=dev) for _ in range(2))
        on, m = step_on.train_step(on, x, e, z, *hyper)
        history.append(m)
    torch.cuda.synchronize()
    seconds = (time.perf_counter() - t0) / n_steps
    print(f"[train] {n_steps} steps: {seconds:.4f} s per step, {b / seconds:.1f} "
          f"images/s (host clock, warm)", flush=True)
    for m in history:
        check(all(np.isfinite(float(v)) for v in m.values()), f"non-finite metrics {m}")
        check(all(float(m[k]) in (0.0, 1.0) for k in ("train_dec", "train_dis")),
              f"gates not in {{0, 1}}: {m}")
    moved = [k for k, v in on.nets.state_dict().items()
             if k.endswith("weight") and not torch.equal(v, before[k])]
    check(any(k.startswith("encoder.") for k in moved), "the timed steps moved no weight")
    for n, fn in kernels.items():
        check(fn.launches == n_steps * launches[n],
              f"{n}: {fn.launches} launches over {n_steps} steps, {launches[n]} per step")

    # 4. every kernel against its plain version at every shape of the step
    def bn_reduce_lib(x_, dy, mu, inv):
        return torch.ops.aten.batch_norm_backward_reduce(dy, x_, mu, inv, None,
                                                         True, False, False)

    def bn_apply_lib(x_, dy, mu, inv, gamma, sums, a0, a1):
        count = torch.tensor([x_.numel() // x_.shape[1]], dtype=torch.int32,
                             device=x_.device)
        return torch.ops.aten.batch_norm_backward_elemt(dy, x_, mu, inv, gamma,
                                                        sums[0], sums[1], count)

    def conv_lib(x_, dy, stride, pad, k):
        w = torch.zeros((dy.shape[1], x_.shape[1], k, k), dtype=x_.dtype, device=x_.device)
        return torch.ops.aten.convolution_backward(
            dy, x_, w, None, [stride] * 2, [pad] * 2, [1, 1], False, [0, 0], 1,
            [False, True, False])[1]

    def deconv_lib(x_, dy, stride, pad, output_padding, k):
        w = torch.zeros((x_.shape[1], dy.shape[1], k, k), dtype=x_.dtype, device=x_.device)
        return torch.ops.aten.convolution_backward(
            dy, x_, w, None, [stride] * 2, [pad] * 2, [1, 1], True,
            [output_padding] * 2, 1, [False, True, False])[1]

    def bn_rows_err(got, ref):
        return max(rel_err(g, r) for g, r in zip(got, ref))

    specs = [  # (kernel name, recorded entry, kernel, plain, library, error,
        #          (fp32 tol, bf16 tol), cost)
        ("bn_bwd_reduce", "bn_bwd_reduce", bn.bn_bwd_reduce, bn.bn_bwd_reduce_plain,
         bn_reduce_lib, bn_rows_err, (TOL, TOL), lambda a: bn_cost(a[0], "reduce")),
        ("bn_bwd_apply", "bn_bwd_apply", bn.bn_bwd_apply, bn.bn_bwd_apply_plain,
         bn_apply_lib, rel_err, (TOL, TOL), lambda a: bn_cost(a[0], "apply")),
        ("tap_matmul", "conv2d_dw", dw.conv2d_dw, dw.conv2d_dw_plain, conv_lib,
         rel_err, (DW_TOL, DW_TOL_BF16), lambda a: dw_cost(a[0], a[1], a[4], a[2], a[3])),
        ("tap_matmul", "conv2d_transpose_dw", dw.conv2d_transpose_dw,
         dw.conv2d_transpose_dw_plain, deconv_lib, rel_err, (DW_TOL, DW_TOL_BF16),
         lambda a: dw_cost(a[1], a[0], a[5], a[2], a[3])),
    ]
    totals = {n: {"ms": 0.0, "device_ms": 0.0, "device_ms_source": set(),
                  "plain_ms": 0.0, "library_ms": 0.0, "flops": 0,
                  "bytes": 0, "max_abs_err": 0.0, "max_rel_err": 0.0,
                  "max_rel_err_bf16": 0.0, "shapes": []}
              for n in kernels}
    for name, entry, kern, plain, lib, err_fn, (tol, tol_bf16), cost in specs:
        tot = totals[name]
        for args, count in calls[entry].values():
            got, ref = kern(*args), plain(*args)
            torch.cuda.synchronize()
            err = err_fn(got, ref)
            check(err <= tol, f"{entry} {[tuple(a.shape) for a in args[:2]]}: "
                              f"relative error {err} > {tol}")
            tot["max_rel_err"] = max(tot["max_rel_err"], err)
            tot["max_abs_err"] = max(tot["max_abs_err"], float((got - ref).abs().max()))
            check(torch.equal(got, kern(*args)), f"{entry}: two runs differ")
            # bf16 activations (the -bf16 presets' operands): products are
            # exact in fp32 and sums fp32 on both sides
            half = tuple(a.bfloat16() if torch.is_tensor(a) and a.dim() == 4 else a
                         for a in args)
            err = err_fn(kern(*half), plain(*half))
            check(err <= tol_bf16, f"{entry} bf16 {[tuple(a.shape) for a in args[:2]]}: "
                                   f"relative error {err} > {tol_bf16}")
            tot["max_rel_err_bf16"] = max(tot["max_rel_err_bf16"], err)
            ms = cuda_ms(lambda: kern(*args), iters=20)
            dev_ms, source = device_ms(lambda: kern(*args))
            lib_ms = cuda_ms(lambda: lib(*args), iters=20)
            tot["ms"] += count * ms
            tot["device_ms"] += count * dev_ms
            tot["device_ms_source"].add(source)
            tot["plain_ms"] += count * cuda_ms(lambda: plain(*args), iters=5, warmup=1)
            tot["library_ms"] += count * lib_ms
            flops, nbytes = cost(args)
            tot["flops"] += count * flops
            tot["bytes"] += count * nbytes
            shape = {"call": entry, "count": count, "ms": ms, "device_ms": dev_ms,
                     "library_ms": lib_ms, "gflop": flops / 1e9, "args": [
                         list(a.shape) if torch.is_tensor(a) else a for a in args]}
            if name == "tap_matmul":
                print(f"[train] tap_matmul {entry} {shape['args'][:2]} x{count}: "
                      f"{ms:.4f} ms per call ({flops / ms / 1e9:.1f} TFLOP/s), device "
                      f"{dev_ms:.4f} ms, library {lib_ms:.4f} ms", flush=True)
            elif name == "bn_bwd_apply":
                shape["bound_ms"] = bound(flops, nbytes)[0]
                print(f"[train] bn_bwd_apply {shape['args'][0]} {args[0].dtype} x{count}: "
                      f"{ms:.4f} ms per call, device {dev_ms:.4f} ms, library "
                      f"{lib_ms:.4f} ms, bound {shape['bound_ms']:.4f} ms (bytes)",
                      flush=True)
            tot["shapes"].append(shape)
    entries = []
    for name, tot in totals.items():
        bound_ms, bound_by = bound(tot["flops"], tot["bytes"])
        extra = {}
        if name == "tap_matmul":  # on the tensor cores: fp32 as 3xTF32, bf16 as bf16
            fp32 = any(str(torch.float32) in str(key) for key in calls["conv2d_dw"])
            peak, rate = ((PEAK_3XTF32_FLOPS, "3xTF32") if fp32
                          else (PEAK_BF16_FLOPS, "bf16"))
            extra = {"bound_rate": f"{rate} tensor cores, {peak / 1e12:.1f} TFLOP/s",
                     "bound_ms_fp32_cuda_cores": bound_ms, "gflop": tot["flops"] / 1e9}
            bound_ms, bound_by = bound(tot["flops"], tot["bytes"], peak)
        print(f"[train] {name}: {launches[name]} launches per step over "
              f"{len(tot['shapes'])} shapes; kernel {tot['ms']:.4f} ms (device "
              f"{tot['device_ms']:.4f} ms), plain "
              f"{tot['plain_ms']:.4f} ms, library {tot['library_ms']:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}{', ' + extra['bound_rate'] if extra else ''}"
              f"{'; fp32 CUDA cores %.4f ms' % extra['bound_ms_fp32_cuda_cores'] if extra else ''})"
              f"; max |kernel - plain| "
              f"{tot['max_abs_err']:.3g} ({tot['max_rel_err']:.3g} of the largest "
              f"plain value; {tot['max_rel_err_bf16']:.3g} with bf16 operands)",
              flush=True)
        entries.append({
            "name": name, "route": "cuda",
            "source": "fmri_tpu_torch/ops/csrc/" + ("dw.cu" if name == "tap_matmul"
                                                    else "bn.cu"),
            "replaces": {"bn_bwd_reduce": "fmri_tpu/ops/pallas_bn.py:63",
                         "bn_bwd_apply": "fmri_tpu/ops/pallas_bn.py:97",
                         "tap_matmul": "fmri_tpu/ops/pallas_dw.py:71"}[name],
            "launches": launches[name], "max_abs_err": tot["max_abs_err"],
            "ms": tot["ms"], "device_ms": tot["device_ms"],
            "device_ms_source": "+".join(sorted(tot["device_ms_source"])),
            "plain_ms": tot["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": tot["library_ms"], **extra,
            "shapes": tot["shapes"]})
    return entries


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
        from fmri_tpu_torch.ops import ssim as ssim_ops
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

    # the main path's run: every SSIM launch recorded with its shape
    ssim_calls = {}
    recorder = Recorder(ssim_ops, "ssim_plane_sums", ssim_calls)
    ssim_plane_sums.launches = 0
    recons, targets, metrics, scores, cold = main_path()
    launches = {"ssim": ssim_plane_sums.launches}
    recorder.restore()
    recorded = sum(count for _, count in ssim_calls.values())
    check(recorded == launches["ssim"],
          f"ssim: {launches['ssim']} launches but {recorded} recorded calls")
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

    # 6. train
    train_kernels = train_phase(dev, cfg)

    # 7. kernels line; ssim at every shape the inference run gave it, each
    #    held against the plain version, times summed over the run's launches
    ssim_tot = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "flops": 0.0,
                "bytes": 0.0, "sources": set(), "shapes": []}
    ms_b1024 = None
    for (a, b, *rest), count in ssim_calls.values():
        err = abs(float(ssim(a, b, *rest)) - float(ssim_plain(a, b, *rest)))
        check(err <= TOL, f"ssim {list(a.shape)}: |kernel - plain| = {err} > {TOL}")
        check(torch.equal(ssim_plane_sums(a, b, *rest), ssim_plane_sums(a, b, *rest)),
              f"ssim {list(a.shape)}: two runs differ")
        # per image, both fp32 versions against float64: in flat regions the
        # variances E[x^2] - mu^2 cancel down to C2 = 9e-4, where fp32
        # rounding moves a pixel's score by about 1e-4
        exact = ssim_plain(a.double(), b.double(), *rest, size_average=False)
        img_err = float((ssim(a, b, *rest, size_average=False) - exact).abs().max())
        img_err_plain = float((ssim_plain(a, b, *rest, size_average=False)
                               - exact).abs().max())
        check(img_err <= SSIM_IMAGE_TOL,
              f"ssim {list(a.shape)}: per image {img_err} from float64 > {SSIM_IMAGE_TOL}")
        max_err = max(max_err, err)
        ms = cuda_ms(lambda: ssim_plane_sums(a, b, *rest), iters=20)
        dev_ms, source = device_ms(lambda: ssim_plane_sums(a, b, *rest))
        plain_ms = cuda_ms(lambda: ssim_plain(a, b, *rest, size_average=False),
                           iters=3, warmup=1)
        bound_ms, bound_by = ssim_bound(tuple(a.shape))
        flops, nbytes = ssim_cost(tuple(a.shape))
        if tuple(a.shape) == (1024, 64, 64, 3):
            ms_b1024 = ms
        for key, v in (("ms", ms), ("device_ms", dev_ms), ("plain_ms", plain_ms),
                       ("flops", flops), ("bytes", nbytes)):
            ssim_tot[key] += count * v
        ssim_tot["sources"].add(source)
        ssim_tot["shapes"].append({"shape": list(a.shape), "count": count, "ms": ms,
                                   "device_ms": dev_ms, "plain_ms": plain_ms,
                                   "bound_ms": bound_ms, "bound_by": bound_by})
        print(f"[kernels] ssim {list(a.shape)} x{count}: {ms:.4f} ms per call, device "
              f"{dev_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}; {100 * bound_ms / dev_ms:.1f}% of it on the device), "
              f"|kernel - plain| {err:.3g}; per image from float64: kernel "
              f"{img_err:.3g}, plain {img_err_plain:.3g}", flush=True)
    bound_ms, bound_by = bound(ssim_tot["flops"], ssim_tot["bytes"])
    print(f"[kernels] ssim per inference run: {launches['ssim']} launches, "
          f"{ssim_tot['ms']:.4f} ms (device {ssim_tot['device_ms']:.4f} ms), plain "
          f"{ssim_tot['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})",
          flush=True)
    kernels = [{
        "name": "ssim",
        "route": "cuda",
        "source": "fmri_tpu_torch/ops/csrc/ssim.cu",
        "replaces": "fmri_tpu/ops/pallas_ssim.py:79",
        "launches": launches["ssim"],
        "max_abs_err": max_err,
        "ms": ssim_tot["ms"],
        "device_ms": ssim_tot["device_ms"],
        "device_ms_source": "+".join(sorted(ssim_tot["sources"])),
        "plain_ms": ssim_tot["plain_ms"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "ms_b1024": ms_b1024,
        "shapes": ssim_tot["shapes"],
    }] + train_kernels
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
