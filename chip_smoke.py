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
     alone and must be exactly 4, and each is recorded with its shape (1,024
     images for ``quality_metrics``, 2,048, 5,120 and 10,240 for the n-way
     tests); the metrics must agree with the same run on
     the plain SSIM (SSIM within 1e-5, n-way fractions within 1/N), and a
     small batch must agree with the same model on the CPU (atol 1e-4: cuDNN
     may pick FFT or Winograd convolutions, which round differently). Then
     the stage-I inference path (``--stage 1``: image -> image through a
     stage-I ``VaeGanVisual`` over the same 1,024 images), its SSIM launches
     counted alone (exactly 4) and each call recorded and held against the
     plain version as phase 8 holds phase 4's, its metrics against the
     plain SSIM and 8 images against the CPU; then (4c) the WAE inference
     path (``--family wae --stage 3``: ``WaeCognitive``, the mean latent,
     ``sample=True`` ignored) over the same 1,024 pairs with the same
     checks and its own 4 SSIM launches;
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
  7. cognitive train: the stage-II step (mode 'vae-gan', distilling
     through the frozen stage-I teacher) and the stage-III step at res64
     (3,620 voxels -> 1,024 -> latent 128; the stage-I decoder and
     discriminator; batch 64, fp32), random weights of the
     ``"vae-gan-cognitive"`` kind, moments at ones, 64 synthetic pairs,
     both kernel flags on. For each stage, the same checks as phase 6
     (flags off on the card, the CPU at batch 8, 5 timed steps, every
     kernel call of the step against its plain version) and: launches per
     step exactly ``COGNITIVE_LAUNCHES``; the frozen groups' parameters
     bitwise unchanged; every BatchNorm's statistics ticked (stage III:
     all but the unused teacher's), the decoder's 3 times in stage II.
     Then stage III with ``fused_decoder_batch`` (``pallas_bn`` off:
     vsplit forbids it; ``pallas_backward`` on): ``tap_matmul`` exactly 8
     times, held against the unfused step on the card;
  8. kernels: SSIM at every shape phase 4 recorded, against its plain
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
     time at [1024, 64, 64, 3] alone. The times are stage I's (the
     train kernels) and one inference run's (SSIM); ``launches_by_path``
     gives each kernel's launches on every path the run drove. A line
     before it gives every train path's seconds per step;
  9. alt: the res64 stage-I step with ``alt_backward`` (both kernel flags
     off, so ``ops/conv_alt.py``'s rewrites run) against the stock step
     (``STEP_TOL``); every rewrite call of the step against the library's
     grad of the same operands in float64 (1e-5; cuDNN's fp32 grad printed
     beside it) and timed beside cuDNN's; 5 timed and one profiled step of
     each, with cuDNN's dgrad kernels' device ms; then with
     ``pallas_backward`` on too: 15 ``tap_matmul`` launches, no rewrite;
  10. WAE train: WAE stage I, the cognitive WAE stages II and III and
     WAE/Dual-GAN ('vae-gan') at res64, batch 64, both kernel flags on,
     Adam's second moments (RMSprop's moments) at ones: launches per step
     exactly ``WAE_LAUNCHES``, BatchNorm ticks ``WAE_TICKS``, frozen groups
     bitwise unchanged; per tensor against the library backward and against
     the CPU at batch 8, each within its bound or above its own rounding
     noise (``check_tensors``: the reference on the reversed batch); 5
     timed and one profiled step; every kernel call against its plain
     version; then WAE/Dual-GAN with the fused decoder batch (``tap_matmul``
     11 per step) against the unfused step;
  11. trainer: the training driver at res64, batch 64, on 640 synthetic
     examples (576 train: 9 steps per epoch; 64 validation), both kernel
     flags on, each path 3 epochs of ``Trainer.fit`` (0 warms up, 1 is
     profiled: ``torch.profiler`` -> ``utils/profile_report.py``, 2 is
     clean): (a) ``vgan_stage1``: launches per epoch exactly 9 x 17/17/15
     and 2 SSIM (the validation pass and the train-batch metrics), the
     checkpoint restored bitwise, the same step over epoch 0's batches
     staged beforehand, ``results.csv`` and the grids, checkpoint write
     seconds (sync, async); then, with cuDNN's deterministic algorithms, a
     recorded run (every kernel call against its plain version), its epoch
     0 against a hand loop of the same step over the same batches and
     draws, and the run resumed after epoch 0 against its epoch 1 (both
     ``STEP_TOL``); (b) ``vgan_stage2`` from (a)'s
     checkpoint dir and ``vgan_stage3`` from stage II's (9 x 8/8/4 and
     9 x 11/11/12, frozen groups bitwise); (c) ``wae_stage1`` (9 x 6/6/7);
     (d) ``python -m fmri_tpu_torch.train.run`` (res64 preset: kernel
     flags off, 2 SSIM launches) and the inference CLI on its checkpoint
     dir (exactly 4 SSIM launches, each held against plain). Each path
     prints its seconds per step through the trainer beside the bare
     step's, epoch wall seconds, images per second and the profiled
     epoch's device busy share. In the ``kernels`` line the ``trainer_*``
     paths count one epoch's launches.

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
# SSIM launches per inference run: quality_metrics 1, objective_scores 3
# (the 2/5/10-way tests)
SSIM_LAUNCHES_PER_RUN = 4


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


def hold_ssim_call(a, b, rest):
    """One recorded SSIM call against its plain version: the mean within
    ``TOL``, the same bits twice, and per image against the plain version
    in float64 within ``SSIM_IMAGE_TOL``. Returns (|kernel - plain| of the
    mean, per-image error of the kernel and of the plain version)."""
    import torch

    from fmri_tpu_torch.ops.ssim import ssim, ssim_plain, ssim_plane_sums

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
    return err, img_err, img_err_plain


def tensor_gaps(a, b, start) -> dict:
    """{tensor: (kind, gap)} over the tensors of train state ``b``: the L2
    norm of ``a``'s difference over how far ``b`` moved the parameter from
    ``start`` (kind ``param``) or over b's norm (``stats``: BN running
    statistics; ``sq``: RMSprop moments, Adam's two moments)."""
    from fmri_tpu_torch.train.optim import AdamState

    def rel(x, y, scale):
        return float((x.cpu().double() - y.cpu().double()).norm()
                     / max(float(scale.cpu().double().norm()), 1e-30))

    out = {}
    sa, sb = a.nets.state_dict(), b.nets.state_dict()
    for k, v in sb.items():
        if k.endswith("num_batches_tracked"):
            continue
        out[k] = (("stats", rel(sa[k], v, v)) if "running" in k
                  else ("param", rel(sa[k], v, v.cpu() - start[k])))
    for g, moments in b.opt_state.items():
        pairs = [("sq", a.opt_state[g], moments)]
        if isinstance(moments, AdamState):
            pairs = [("mu", a.opt_state[g].mu, moments.mu), ("nu", a.opt_state[g].nu, moments.nu)]
        for name, got, ref in pairs:
            for k, v in ref.items():
                out[f"{g}.{name}.{k}"] = ("sq", rel(got[k], v, v))
    return out


def compare_steps(a, ma, b, mb, start) -> dict:
    """Worst relative differences of train state ``a`` (metrics ``ma``)
    from ``b``: losses, and per kind the worst of ``tensor_gaps``; gate
    flags, where the step has them, and Adam counts equal."""
    from fmri_tpu_torch.train.optim import AdamState

    out = {"loss": max(abs(float(ma[k]) - float(mb[k])) / max(abs(float(mb[k])), 1e-12)
                       for k in ma if k.startswith("loss")),
           "gates_equal": all(float(ma[k]) == float(mb[k])
                              for k in ("train_dec", "train_dis") if k in mb),
           "param": 0.0, "stats": 0.0, "sq": 0.0}
    for kind, gap in tensor_gaps(a, b, start).values():
        out[kind] = max(out[kind], gap)
    for g, moments in b.opt_state.items():
        if isinstance(moments, AdamState):
            out["gates_equal"] &= int(a.opt_state[g].count) == int(moments.count)
    return out


TRAIN_KERNELS = ("bn_bwd_reduce", "bn_bwd_apply", "tap_matmul")
# launches per res64 step with both kernel flags on (tests/test_torch_cognitive.py
# counts the wrappers' calls on the CPU): stage II, the discriminator's C basis
# (3 BN, 4 dW), its B basis to x_tilde (2 BN), the decoder back to z (3 BN, no
# dW); stage III, C basis 3 BN + 4 dW, B basis 2 BN, the decoder's two passes
# 3 BN + 4 dW each
COGNITIVE_LAUNCHES = {2: {"bn_bwd_reduce": 8, "bn_bwd_apply": 8, "tap_matmul": 4},
                      3: {"bn_bwd_reduce": 11, "bn_bwd_apply": 11, "tap_matmul": 12}}
FUSED_DW_LAUNCHES = 8  # stage III, fused decoder batch: discriminator 4, decoder 4
STEP_TOL = {"loss": 1e-5, "param": 2e-2, "stats": 1e-4, "sq": 2e-2}
# batch 8 is ill-conditioned at res64 (BatchNorm over 8 images, KL terms near
# 900 per image): fp32 runs differ from float64 by up to 3% of an update on
# the decoder's FC BatchNorm (tests/test_torch_train.py)
CPU_TOL = {"loss": 1e-5, "param": 3e-2, "stats": 1e-4, "sq": 2e-2}


def record_step(run, record: bool = True):
    """(run()'s result, launches per train kernel, recorded calls, seconds):
    every launch count set to 0 just before ``run`` and read just after;
    with ``record``, each distinct call of the BN-backward and weight-grad
    wrappers recorded with its arguments (not while steps are timed)."""
    import torch

    from fmri_tpu_torch.ops import bn, dw

    kernels = {"bn_bwd_reduce": bn.bn_bwd_reduce, "bn_bwd_apply": bn.bn_bwd_apply,
               "tap_matmul": dw.tap_matmul}
    calls = {n: {} for n in ("bn_bwd_reduce", "bn_bwd_apply", "conv2d_dw",
                             "conv2d_transpose_dw")}
    recorders = [Recorder(mod, n, calls[n]) for mod, n in (
        (bn, "bn_bwd_reduce"), (bn, "bn_bwd_apply"), (dw, "conv2d_dw"),
        (dw, "conv2d_transpose_dw"))] if record else []
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in kernels.items()}
    for r in recorders:
        r.restore()
    return out, launches, calls, seconds


def check_step(name, a, ma, b, mb, start, tol) -> None:
    d = compare_steps(a, ma, b, mb, start)
    print(f"[train] {name}: {d} (bounds {tol})", flush=True)
    check(d["gates_equal"] and all(d[k] <= v for k, v in tol.items()),
          f"{name}: {d} outside {tol}")


# Two fp32 steps of the same math that round differently each sit about one
# unit of their own rounding from the exact step. Where that unit is large,
# a tensor is held to a multiple of it, measured by the reference's step on
# the batch in reverse order: the WAE encoder's l_mu bias takes an update
# that is a near-cancelling sum (the decoder's FC BatchNorm cancels the batch
# sum of its cotangent down to the penalty's small part), and a weight whose
# update is below its fp32 spacing (the decoder's first FC in WAE stage III)
# moves by rounding alone.
FLOOR_FACTOR = 3


def check_tensors(name, a, ma, b, mb, start, tol, floor) -> None:
    """``check_step`` per tensor: the gap of each tensor of ``a`` from the
    reference ``b`` within its kind's bound in ``tol``, or within
    ``FLOOR_FACTOR`` times that tensor's own rounding noise where larger;
    ``floor`` is ``tensor_gaps`` of ``b``'s step on the batch in reverse
    order, the same math summed in another order."""
    d = compare_steps(a, ma, b, mb, start)
    gaps = tensor_gaps(a, b, start)
    ratio, worst = max((gap / max(tol[kind], FLOOR_FACTOR * floor[k][1]), k)
                       for k, (kind, gap) in gaps.items())
    print(f"[train] {name}: {d} (bounds {tol}); per tensor at most {ratio:.3f} of its "
          f"bound ({worst}: gap {gaps[worst][1]:.3g}, noise {floor[worst][1]:.3g})",
          flush=True)
    check(d["gates_equal"] and d["loss"] <= tol["loss"] and ratio <= 1.0,
          f"{name}: {worst} over its bound ({ratio:.3f})")


def timed_steps(step, state, n_steps, draw):
    """(state, seconds per step, metrics): ``n_steps`` steps on fresh noise
    from ``draw()``, host clock, one synchronize at the end; checks finite
    metrics and gates, where the step has them, in {0, 1}."""
    import numpy as np
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    history = []
    for _ in range(n_steps):
        state, m = step(state, *draw())
        history.append(m)
    torch.cuda.synchronize()
    seconds = (time.perf_counter() - t0) / n_steps
    for m in history:
        check(all(np.isfinite(float(v)) for v in m.values()), f"non-finite metrics {m}")
        check(all(float(m[k]) in (0.0, 1.0) for k in ("train_dec", "train_dis") if k in m),
              f"gates not in {{0, 1}}: {m}")
    return state, seconds, history


def profile_step(run, path: str, step_s: float) -> dict:
    """The device time of one more warm step, by kernel (``torch.profiler``,
    CUDA activity), beside ``step_s``, the unprofiled step's host time: the
    device's busy share of the step and its largest kernels. Prints and
    returns ``{"device_ms", "kernels", "busy_share", "top", "by_kernel"}``, the
    last the device ms of every kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    out = {"device_ms": busy_ms, "kernels": sum(e.count for e in kernels),
           "busy_share": busy_ms / (1e3 * step_s),
           "top": [(e.key[:70], e.count, e.self_device_time_total / 1e3) for e in top],
           "by_kernel": {e.key: e.self_device_time_total / 1e3 for e in kernels}}
    print(f"[{path}] profiled step: device busy {busy_ms:.2f} ms in {out['kernels']} "
          f"kernels, {100 * out['busy_share']:.1f}% of the {1e3 * step_s:.2f} ms step; "
          f"largest: " + "; ".join(f"{name} x{n} {ms:.2f} ms" for name, n, ms in out["top"]),
          flush=True)
    return out


def hold_against_plain(calls, path: str, timed: bool):
    """Every recorded call of the train kernels against its plain version,
    with its own operands and with bf16 activations, and the same bits
    twice. With ``timed``, also the warm times of the kernel, its plain
    version and its library call, summed over the calls (the kernels-line
    entries). Returns ``{kernel: totals}``."""
    import torch

    from fmri_tpu_torch.ops import bn, dw

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
              for n in TRAIN_KERNELS}
    for name, entry, kern, plain, lib, err_fn, (tol, tol_bf16), cost in specs:
        tot = totals[name]
        for args, count in calls[entry].values():
            got, ref = kern(*args), plain(*args)
            torch.cuda.synchronize()
            err = err_fn(got, ref)
            check(err <= tol, f"{path} {entry} {[tuple(a.shape) for a in args[:2]]}: "
                              f"relative error {err} > {tol}")
            tot["max_rel_err"] = max(tot["max_rel_err"], err)
            tot["max_abs_err"] = max(tot["max_abs_err"], float((got - ref).abs().max()))
            check(torch.equal(got, kern(*args)), f"{path} {entry}: two runs differ")
            # bf16 activations (the -bf16 presets' operands): products are
            # exact in fp32 and sums fp32 on both sides
            half = tuple(a.bfloat16() if torch.is_tensor(a) and a.dim() == 4 else a
                         for a in args)
            err = err_fn(kern(*half), plain(*half))
            check(err <= tol_bf16, f"{path} {entry} bf16 "
                                   f"{[tuple(a.shape) for a in args[:2]]}: "
                                   f"relative error {err} > {tol_bf16}")
            tot["max_rel_err_bf16"] = max(tot["max_rel_err_bf16"], err)
            shape = {"call": entry, "count": count, "args": [
                list(a.shape) if torch.is_tensor(a) else a for a in args]}
            tot["shapes"].append(shape)
            if not timed:
                continue
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
            shape.update({"ms": ms, "device_ms": dev_ms, "library_ms": lib_ms,
                          "gflop": flops / 1e9})
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
    for name, tot in totals.items():
        print(f"[{path}] {name}: {len(tot['shapes'])} shapes held against the plain "
              f"version; max |kernel - plain| {tot['max_abs_err']:.3g} "
              f"({tot['max_rel_err']:.3g} of the largest plain value; "
              f"{tot['max_rel_err_bf16']:.3g} with bf16 operands)", flush=True)
    return totals


def kernel_entries(totals, launches, fp32_dw: bool):
    """The kernels-line entries of the train kernels from one timed run."""
    entries = []
    for name, tot in totals.items():
        bound_ms, bound_by = bound(tot["flops"], tot["bytes"])
        extra = {}
        if name == "tap_matmul":  # on the tensor cores: fp32 as 3xTF32, bf16 as bf16
            peak, rate = ((PEAK_3XTF32_FLOPS, "3xTF32") if fp32_dw
                          else (PEAK_BF16_FLOPS, "bf16"))
            extra = {"bound_rate": f"{rate} tensor cores, {peak / 1e12:.1f} TFLOP/s",
                     "bound_ms_fp32_cuda_cores": bound_ms, "gflop": tot["flops"] / 1e9}
            bound_ms, bound_by = bound(tot["flops"], tot["bytes"], peak)
        print(f"[train] {name}: {launches[name]} launches per step over "
              f"{len(tot['shapes'])} shapes; kernel {tot['ms']:.4f} ms (device "
              f"{tot['device_ms']:.4f} ms), plain "
              f"{tot['plain_ms']:.4f} ms, library {tot['library_ms']:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}{', ' + extra['bound_rate'] if extra else ''}"
              f"{'; fp32 CUDA cores %.4f ms' % extra['bound_ms_fp32_cuda_cores'] if extra else ''})",
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


def with_flags(cfg, **flags):
    import dataclasses

    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **flags))


def reversed_batch(a):
    """A tensor with its batch (leading) axis reversed; anything else as it is."""
    import torch

    return a.flip(0) if torch.is_tensor(a) else a


def warm_moments(state):
    """RMSprop moments started at ones, as tests/ref_oracle.py:110 warms them;
    Adam's second moments at ones (first moments and count at zero), so its
    first update is linear in the gradient (tests/test_torch_wae.py)."""
    from fmri_tpu_torch.train.optim import AdamState

    for moments in state.opt_state.values():
        for v in (moments.nu if isinstance(moments, AdamState) else moments).values():
            v.fill_(1.0)
    return state


def train_phase(dev, cfg):
    """Phase 6, stage I; returns (kernels-line entries of the three train
    kernels, launches per step, seconds per step)."""
    import torch

    from fmri_tpu_torch.checkpoints.convert import from_jax_groups, random_groups
    from fmri_tpu_torch.data.synthetic import synthetic_images
    from fmri_tpu_torch.train.optim import RmsProp
    from fmri_tpu_torch.train.state import GROUPS, VaeGan, make_state
    from fmri_tpu_torch.train.steps_vgan import make_vgan_stage1_step

    t = cfg.train
    cfg_on = with_flags(cfg, pallas_bn=True, pallas_backward=True)
    weights = from_jax_groups(random_groups(cfg, seed=0, kind="vae-gan"), cfg, "vae-gan")

    def new_state(c, device):
        nets = VaeGan(c)
        nets.load_state_dict(weights, strict=True)
        return warm_moments(make_state(nets.to(device), {
            g: RmsProp(t.rms_decay, t.rms_eps, t.grad_clip) for g in GROUPS}))

    b, latent = t.batch_size, cfg.model.latent_dim
    x = torch.from_numpy(2.0 * synthetic_images(b, cfg.model.image_size, seed=0)[0]
                         - 1.0).to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    eps, z_p = (torch.randn((b, latent), generator=gen, device=dev) for _ in range(2))
    hyper = (t.margin, t.equilibrium, t.lambda_mse)
    step_on, step_off = make_vgan_stage1_step(cfg_on), make_vgan_stage1_step(cfg)

    # the main path: one step with both flags on, every call recorded
    on = new_state(cfg_on, dev)
    (on, m_on), launches, calls, cold = record_step(
        lambda: step_on.train_step(on, x, eps, z_p, *hyper))
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
    check_step("kernels vs library backward on the card", on, m_on, off, m_off,
               weights, STEP_TOL)

    # 2. card against the CPU, batch 8
    small = (x[:8], eps[:8], z_p[:8])
    card, m_card = step_on.train_step(new_state(cfg_on, dev), *small, *hyper)
    cpu, m_cpu = step_on.train_step(new_state(cfg_on, "cpu"),
                                    *(a.cpu() for a in small), *hyper)
    check_step("card vs CPU at batch 8", card, m_card, cpu, m_cpu, weights, CPU_TOL)

    # 3. five timed steps
    before = {k: v.clone() for k, v in on.nets.state_dict().items()}
    n_steps = 5
    (on, seconds, _), counted, _, _ = record_step(lambda: timed_steps(
        step_on.train_step, on, n_steps,
        lambda: (x, *(torch.randn((b, latent), generator=gen, device=dev)
                      for _ in range(2)), *hyper)), record=False)
    print(f"[train] {n_steps} steps: {seconds:.4f} s per step, {b / seconds:.1f} "
          f"images/s (host clock, warm)", flush=True)
    profile_step(lambda: step_on.train_step(
        on, x, *(torch.randn((b, latent), generator=gen, device=dev) for _ in range(2)),
        *hyper), "train", seconds)
    moved = [k for k, v in on.nets.state_dict().items()
             if k.endswith("weight") and not torch.equal(v, before[k])]
    check(any(k.startswith("encoder.") for k in moved), "the timed steps moved no weight")
    for n, count in counted.items():
        check(count == n_steps * launches[n],
              f"{n}: {count} launches over {n_steps} steps, {launches[n]} per step")

    # 4. every kernel against its plain version at every shape of the step
    totals = hold_against_plain(calls, "train", timed=True)
    fp32 = any(str(torch.float32) in str(key) for key in calls["conv2d_dw"])
    return kernel_entries(totals, launches, fp32), launches, seconds


def cognitive_phase(dev, cfg):
    """Phase 7: the stage-II (with the teacher) and stage-III steps, then
    stage III with the fused decoder batch. Returns ({path: launches per
    step}, {path: seconds per step})."""
    import torch

    from fmri_tpu_torch.checkpoints.convert import from_jax_groups, random_groups
    from fmri_tpu_torch.data.synthetic import synthetic_pairs
    from fmri_tpu_torch.train.state import VaeGanCognitiveTrain, make_cognitive_state
    from fmri_tpu_torch.train.steps_vgan import make_vgan_cognitive_step

    t, c = cfg.train, cfg.model
    kind = "vae-gan-cognitive"
    weights = from_jax_groups(random_groups(cfg, seed=0, kind=kind), cfg, kind)

    def new_state(cfg_, device, stage):
        nets = VaeGanCognitiveTrain(cfg_)
        nets.load_state_dict(weights, strict=True)
        return warm_moments(make_cognitive_state(nets.to(device), cfg_, stage))

    b = t.batch_size
    data = synthetic_pairs(b, c.image_size, c.num_voxels, seed=0)
    fmri = torch.from_numpy(data["fmri"]).to(dev)
    image = torch.from_numpy(2.0 * data["image"] - 1.0).to(dev)
    gen = torch.Generator(device=dev).manual_seed(2)

    def draw():
        return (fmri, image, *(torch.randn((b, c.latent_dim), generator=gen, device=dev)
                                for _ in range(3)), t.margin, t.equilibrium, t.lambda_mse)

    cfg_on = with_flags(cfg, pallas_bn=True, pallas_backward=True)
    # the frozen groups (teacher_net.decoder and .discriminator are the
    # student's own modules); every BatchNorm ticks but the unused teacher's
    frozen = {2: ("decoder.", "teacher_net.encoder.", "teacher_net.decoder."),
              3: ("encoder.", "teacher_net.encoder.")}
    still = {2: (), 3: ("teacher_net.encoder.",)}
    launches_by_path, seconds = {}, {}
    for stage in (2, 3):
        path = f"stage{stage}"
        step_on = make_vgan_cognitive_step(cfg_on, stage)
        args = draw()

        # the main path: one step with both flags on, every call recorded
        on = new_state(cfg_on, dev, stage)
        (on, m_on), launches, calls, cold = record_step(lambda: step_on.train_step(on, *args))
        print(f"[{path}] {c.image_size} px stage-{'II' if stage == 2 else 'III'} step, "
              f"batch {b}, both kernel flags on: first step {cold:.3f} s; launches per "
              f"step {launches}; metrics { {k: round(float(v), 6) for k, v in m_on.items()} }",
              flush=True)
        check(launches == COGNITIVE_LAUNCHES[stage],
              f"{path}: launches per step {launches}, want {COGNITIVE_LAUNCHES[stage]}")
        launches_by_path[path] = launches
        sd = on.nets.state_dict()
        for k, v in sd.items():
            if k.startswith(frozen[stage]) and "running" not in k and "num_batches" not in k:
                check(torch.equal(v.cpu(), weights[k]), f"{path}: frozen {k} moved")
            if "running_mean" in k:
                check(torch.equal(v.cpu(), weights[k]) == k.startswith(still[stage]),
                      f"{path}: BatchNorm statistics {k} "
                      f"{'ticked' if k.startswith(still[stage]) else 'did not tick'}")
        check(int(sd["decoder.fc.1.num_batches_tracked"]) == (3 if stage == 2 else 2),
              f"{path}: decoder ticks {int(sd['decoder.fc.1.num_batches_tracked'])}")
        print(f"[{path}] frozen groups {frozen[stage]} bitwise unchanged; every "
              f"BatchNorm ticked but {still[stage] or 'none'}; the decoder "
              f"{int(sd['decoder.fc.1.num_batches_tracked'])} times", flush=True)

        # 1. against the library backward (both flags off) on the card
        off, m_off = make_vgan_cognitive_step(cfg, stage).train_step(
            new_state(cfg, dev, stage), *args)
        check_step(f"{path} kernels vs library backward on the card", on, m_on, off,
                   m_off, weights, STEP_TOL)

        # 2. card against the CPU, batch 8
        small = [a[:8] if torch.is_tensor(a) else a for a in args]
        card, m_card = step_on.train_step(new_state(cfg_on, dev, stage), *small)
        cpu, m_cpu = step_on.train_step(
            new_state(cfg_on, "cpu", stage),
            *(a.cpu() if torch.is_tensor(a) else a for a in small))
        check_step(f"{path} card vs CPU at batch 8", card, m_card, cpu, m_cpu, weights,
                   CPU_TOL)

        # 3. five timed steps
        n_steps = 5
        (on, seconds[path], _), counted, _, _ = record_step(
            lambda: timed_steps(step_on.train_step, on, n_steps, draw), record=False)
        print(f"[{path}] {n_steps} steps: {seconds[path]:.4f} s per step, "
              f"{b / seconds[path]:.1f} pairs/s (host clock, warm)", flush=True)
        for n, count in counted.items():
            check(count == n_steps * launches[n],
                  f"{path} {n}: {count} launches over {n_steps} steps, {launches[n]} per step")
        profile_step(lambda: step_on.train_step(on, *draw()), path, seconds[path])

        # 4. every kernel call of the step against its plain version
        hold_against_plain(calls, path, timed=False)

    # stage III with the fused decoder batch: pallas_bn off (vsplit forbids
    # it), the weight-grad kernel on; held against the unfused step
    cfg_fused = with_flags(cfg, pallas_backward=True, fused_decoder_batch=True)
    cfg_seq = with_flags(cfg, pallas_backward=True)
    args = draw()
    (fused, m_fused), launches, calls, _ = record_step(
        lambda: make_vgan_cognitive_step(cfg_fused, 3).train_step(
            new_state(cfg_fused, dev, 3), *args))
    print(f"[stage3_fused] launches per step {launches}", flush=True)
    check(launches == {"bn_bwd_reduce": 0, "bn_bwd_apply": 0,
                       "tap_matmul": FUSED_DW_LAUNCHES},
          f"stage3_fused: launches per step {launches}")
    launches_by_path["stage3_fused"] = launches
    seq, m_seq = make_vgan_cognitive_step(cfg_seq, 3).train_step(
        new_state(cfg_seq, dev, 3), *args)
    check_step("stage3 fused vs unfused decoder batch on the card", fused, m_fused, seq,
               m_seq, weights, STEP_TOL)
    hold_against_plain(calls, "stage3_fused", timed=False)
    fused_step = make_vgan_cognitive_step(cfg_fused, 3).train_step
    (fused, seconds["stage3_fused"], _), _, _, _ = record_step(
        lambda: timed_steps(fused_step, fused, 5, draw), record=False)
    print(f"[stage3_fused] 5 steps: {seconds['stage3_fused']:.4f} s per step "
          f"(host clock, warm)", flush=True)
    profile_step(lambda: fused_step(fused, *draw()), "stage3_fused", seconds["stage3_fused"])
    return launches_by_path, seconds


# the stage-I step with alt_backward and pallas_backward both on: the kernel
# wins every conv the rewrites would take, so the weight grads stay at 15
ALT_DW_LAUNCHES = DW_LAUNCHES_PER_STEP


def alt_phase(dev, cfg):
    """Phase 9: the res64 stage-I step with ``alt_backward`` on (both kernel
    flags off, so the rewrites of ``ops/conv_alt.py`` run) against the stock
    step; each rewrite call of the step against cuDNN's input grad or
    ``convolution_backward``'s weight grad; 5 timed steps and one profiled
    step of each, with cuDNN's dgrad kernels' device ms; then the step with
    ``pallas_backward`` (and ``pallas_bn``) on too. Returns ({path: launches
    per step}, {path: seconds per step}, {path: dgrad ms})."""
    import torch

    from fmri_tpu_torch.checkpoints.convert import from_jax_groups, random_groups
    from fmri_tpu_torch.data.synthetic import synthetic_images
    from fmri_tpu_torch.ops import conv_alt
    from fmri_tpu_torch.train.optim import RmsProp
    from fmri_tpu_torch.train.state import GROUPS, VaeGan, make_state
    from fmri_tpu_torch.train.steps_vgan import make_vgan_stage1_step

    t = cfg.train
    weights = from_jax_groups(random_groups(cfg, seed=0, kind="vae-gan"), cfg, "vae-gan")

    def new_state(c, device):
        nets = VaeGan(c)
        nets.load_state_dict(weights, strict=True)
        return warm_moments(make_state(nets.to(device), {
            g: RmsProp(t.rms_decay, t.rms_eps, t.grad_clip) for g in GROUPS}))

    b, latent = t.batch_size, cfg.model.latent_dim
    x = torch.from_numpy(2.0 * synthetic_images(b, cfg.model.image_size, seed=0)[0]
                         - 1.0).to(dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    hyper = (t.margin, t.equilibrium, t.lambda_mse)

    def draw():
        return (x, *(torch.randn((b, latent), generator=gen, device=dev) for _ in range(2)),
                *hyper)

    cfg_alt = with_flags(cfg, alt_backward=True)
    step_alt, step_stock = make_vgan_stage1_step(cfg_alt), make_vgan_stage1_step(cfg)
    names = ("conv2d_dx_phases", "conv2d_dw_patches")

    def rewrites(run):
        """(run()'s result, calls of each rewrite with their arguments)."""
        calls = {n: {} for n in names}
        recorders = [Recorder(conv_alt, n, calls[n]) for n in names]
        try:
            out = run()
            torch.cuda.synchronize()
        finally:
            for r in recorders:
                r.restore()
        return out, calls

    args = draw()
    ((alt, m_alt), launches, _, cold), calls = rewrites(lambda: record_step(
        lambda: step_alt.train_step(new_state(cfg_alt, dev), *args), record=False))
    counts = {n: sum(c for _, c in v.values()) for n, v in calls.items()}
    print(f"[alt] {cfg.model.image_size} px stage-I step, batch {b}, alt_backward on, "
          f"kernel flags off: first step {cold:.3f} s; rewrite calls per step {counts}; "
          f"kernel launches {launches}", flush=True)
    check(all(n > 0 for n in counts.values()), f"alt: a rewrite never ran: {counts}")
    check(all(n == 0 for n in launches.values()), f"alt: kernels launched {launches}")
    stock, m_stock = step_stock.train_step(new_state(cfg, dev), *args)
    check_step("alt_backward vs the stock backward on the card", alt, m_alt, stock,
               m_stock, weights, STEP_TOL)

    # each rewrite call against the library's grad of the same operands in
    # float64 (cuDNN's fp32 weight grad of the 64 -> 3 out conv is itself
    # ~1.6% of its largest value off float64, the rewrite ~1e-6: both printed)
    def library(name, args, dtype=torch.float32):
        """The rewrite's result from ``convolution_backward`` in ``dtype``."""
        if name == "conv2d_dx_phases":
            dy, w, x_hw, pad = args
            xa, stride, which = torch.zeros((dy.shape[0], w.shape[1], *x_hw), device=dev), 2, 0
        else:
            xa, dy, pad, k = args
            w, stride, which = torch.zeros((dy.shape[1], xa.shape[1], k, k), device=dev), 1, 1
        return torch.ops.aten.convolution_backward(
            dy.to(dtype), xa.to(dtype), w.to(dtype), None, [stride] * 2, [pad] * 2,
            [1, 1], False, [0, 0], 1, [which == 0, which == 1, False])[which]

    rewrite_ms = {}
    for name in names:
        fn = getattr(conv_alt, name)
        for args, n in calls[name].values():
            exact = library(name, args, torch.float64)
            err = rel_err(fn(*args), exact)
            lib_err = rel_err(library(name, args), exact)
            shapes = [list(a.shape) for a in args[:2]]
            check(err <= TOL, f"alt {name} {shapes}: {err} from float64 > {TOL}")
            ms = cuda_ms(lambda: fn(*args), iters=20)
            lib_ms = cuda_ms(lambda: library(name, args), iters=20)
            rewrite_ms[name] = rewrite_ms.get(name, 0.0) + n * ms
            print(f"[alt] {name} {shapes} x{n}: {ms:.4f} ms per call, cuDNN {lib_ms:.4f} "
                  f"ms; from float64: rewrite {err:.3g}, cuDNN fp32 {lib_err:.3g}",
                  flush=True)
    print(f"[alt] the rewrites' ms per stage-I step (wrapper calls): {rewrite_ms}",
          flush=True)

    # timed and profiled steps, alt and stock
    seconds, dgrad, launches_by_path = {}, {}, {"stage1_alt": launches}
    for path, step, state in (("stage1_alt", step_alt, alt),
                              ("stage1_stock", step_stock, stock)):
        state, seconds[path], _ = timed_steps(step.train_step, state, 5, draw)
        prof = profile_step(lambda: step.train_step(state, *draw()), path, seconds[path])
        dgrad[path] = sum(ms for k, ms in prof["by_kernel"].items() if "dgrad" in k)
        print(f"[{path}] 5 steps: {seconds[path]:.4f} s per step (host clock, warm); "
              f"cuDNN dgrad kernels {dgrad[path]:.4f} ms of device time per step",
              flush=True)
    print(f"[alt] dgrad_engine ms per stage-I step: alt_backward {dgrad['stage1_alt']:.4f}, "
          f"stock {dgrad['stage1_stock']:.4f}", flush=True)

    # with pallas_backward on too the kernel takes every weight grad
    cfg_both = with_flags(cfg, pallas_bn=True, pallas_backward=True, alt_backward=True)
    (_, launches, _, _), calls = rewrites(lambda: record_step(
        lambda: make_vgan_stage1_step(cfg_both).train_step(new_state(cfg_both, dev),
                                                           *draw()), record=False))
    counts = {n: sum(c for _, c in v.values()) for n, v in calls.items()}
    print(f"[stage1_alt_pallas] launches per step {launches}; rewrite calls {counts}",
          flush=True)
    check(launches["tap_matmul"] == ALT_DW_LAUNCHES and counts["conv2d_dw_patches"] == 0,
          f"alt + pallas_backward: {launches}, rewrites {counts}")
    launches_by_path["stage1_alt_pallas"] = launches
    return launches_by_path, seconds, dgrad


# launches per res64 step with both kernel flags on, counted on the CPU
# (tests/test_torch_wae*.py): stage I, one encoder (3 BN, 3 dW) and one
# decoder backward (3 BN, 4 dW); stage II, the frozen decoder back to mu
# (3 BN, no dW); stage III, the decoder back to its weights (3 BN, 4 dW);
# WAE/Dual-GAN, the stage-I VAE/GAN step's, the penalty folded into its one
# encoder backward
WAE_LAUNCHES = {
    "wae_stage1": {"bn_bwd_reduce": 6, "bn_bwd_apply": 6, "tap_matmul": 7},
    "wae_stage2": {"bn_bwd_reduce": 3, "bn_bwd_apply": 3, "tap_matmul": 0},
    "wae_stage3": {"bn_bwd_reduce": 3, "bn_bwd_apply": 3, "tap_matmul": 4},
    "wae_vgan": {"bn_bwd_reduce": 17, "bn_bwd_apply": 17, "tap_matmul": 15}}
WAE_FUSED_DW_LAUNCHES = 11  # WAE/Dual-GAN, fused decoder batch: 3 + 4 + 4
# BatchNorm ticks per step: the encoder's (one forward, the rest replayed)
# and the decoder's
WAE_TICKS = {"wae_stage1": (2, 1), "wae_stage2": (2, 2), "wae_stage3": (2, 1),
             "wae_vgan": (3, 3)}


def wae_phase(dev, cfg):
    """Phase 10: the WAE train paths at res64, batch 64, both kernel flags
    on: stage I, the cognitive stages II and III, and WAE/Dual-GAN
    ('vae-gan'), each with the checks of phase 7; then WAE/Dual-GAN with
    the fused decoder batch against the unfused step. Returns ({path:
    launches per step}, {path: seconds per step})."""
    import torch

    from fmri_tpu_torch.checkpoints.convert import from_jax_groups, random_groups
    from fmri_tpu_torch.data.synthetic import synthetic_pairs
    from fmri_tpu_torch.train import state as st
    from fmri_tpu_torch.train.steps_wae import (
        make_wae_cognitive_step, make_wae_stage1_step, make_wae_vgan_step,
    )

    t, c = cfg.train, cfg.model
    b = t.batch_size
    data = synthetic_pairs(b, c.image_size, c.num_voxels, seed=0)
    fmri = torch.from_numpy(data["fmri"]).to(dev)
    image = torch.from_numpy(2.0 * data["image"] - 1.0).to(dev)
    gen = torch.Generator(device=dev).manual_seed(5)

    def noise(scale=1.0):
        return scale * torch.randn((b, c.latent_dim), generator=gen, device=dev)

    paths = {  # (kind, module, state, step factory, draw, frozen prefixes)
        "wae_stage1": ("wae-gan", st.WaeGan, st.make_wae_state,
                       lambda c_: make_wae_stage1_step(c_),
                       lambda: (image, noise(t.wae_sigma)), ()),
        "wae_stage2": ("wae-gan-cognitive", st.WaeGanCognitiveTrain,
                       lambda n, c_: st.make_wae_cognitive_state(n, c_, 2),
                       lambda c_: make_wae_cognitive_step(c_, 2),
                       lambda: (fmri, image), ("decoder.", "teacher_encoder.")),
        "wae_stage3": ("wae-gan-cognitive", st.WaeGanCognitiveTrain,
                       lambda n, c_: st.make_wae_cognitive_state(n, c_, 3),
                       lambda c_: make_wae_cognitive_step(c_, 3),
                       lambda: (fmri, image), ("encoder.", "teacher_encoder.")),
        "wae_vgan": ("wae-vgan", st.WaeDualGan, st.make_wae_dual_gan_state,
                     lambda c_: make_wae_vgan_step(c_),
                     lambda: (image, noise(), noise(), noise(t.wae_sigma), t.margin,
                              t.equilibrium, t.lambda_mse), ()),
    }
    cfg_on = with_flags(cfg, pallas_bn=True, pallas_backward=True)
    launches_by_path, seconds = {}, {}
    for path, (kind, module, make, factory, draw, frozen) in paths.items():
        weights = from_jax_groups(random_groups(cfg, seed=0, kind=kind), cfg, kind)

        def new_state(cfg_, device, module=module, make=make, weights=weights):
            nets = module(cfg_)
            nets.load_state_dict(weights, strict=True)
            return warm_moments(make(nets.to(device), cfg_))

        step_on = factory(cfg_on).train_step
        args = draw()

        # the main path: one step with both flags on, every call recorded
        on = new_state(cfg_on, dev)
        (on, m_on), launches, calls, cold = record_step(lambda: step_on(on, *args))
        print(f"[{path}] {c.image_size} px step, batch {b}, both kernel flags on: first "
              f"step {cold:.3f} s; launches per step {launches}; metrics "
              f"{ {k: round(float(v), 6) for k, v in m_on.items()} }", flush=True)
        check(launches == WAE_LAUNCHES[path],
              f"{path}: launches per step {launches}, want {WAE_LAUNCHES[path]}")
        launches_by_path[path] = launches
        sd = on.nets.state_dict()
        for k, v in sd.items():
            if k.startswith(frozen) and "running" not in k and "num_batches" not in k:
                check(torch.equal(v.cpu(), weights[k]), f"{path}: frozen {k} moved")
        enc_ticks, dec_ticks = WAE_TICKS[path]
        got_ticks = {p: {int(v) for k, v in sd.items()
                         if k.startswith(p) and k.endswith("num_batches_tracked")}
                     for p in ("encoder.", "decoder.")}
        check(got_ticks == {"encoder.": {enc_ticks}, "decoder.": {dec_ticks}},
              f"{path}: BatchNorm ticks {got_ticks}, want {WAE_TICKS[path]}")
        print(f"[{path}] frozen groups {frozen or 'none'} bitwise unchanged; BatchNorm "
              f"ticks per step: encoder {enc_ticks}, decoder {dec_ticks}", flush=True)

        # 1. against the library backward (both flags off) on the card, and
        # 2. card against the CPU at batch 8; each tensor above its own
        #    rounding noise (the reference's step on the reversed batch)
        off_step = factory(cfg).train_step
        off, m_off = off_step(new_state(cfg, dev), *args)
        rev, _ = off_step(new_state(cfg, dev), *map(reversed_batch, args))
        check_tensors(f"{path} kernels vs library backward on the card", on, m_on, off,
                      m_off, weights, STEP_TOL, tensor_gaps(rev, off, weights))
        small = [a[:8] if torch.is_tensor(a) else a for a in args]
        card, m_card = step_on(new_state(cfg_on, dev), *small)
        cpu_args = [a.cpu() if torch.is_tensor(a) else a for a in small]
        cpu, m_cpu = step_on(new_state(cfg_on, "cpu"), *cpu_args)
        rev, _ = step_on(new_state(cfg_on, "cpu"), *map(reversed_batch, cpu_args))
        check_tensors(f"{path} card vs CPU at batch 8", card, m_card, cpu, m_cpu, weights,
                      CPU_TOL, tensor_gaps(rev, cpu, weights))

        # 3. five timed steps and a profiled one
        n_steps = 5
        (on, seconds[path], _), counted, _, _ = record_step(
            lambda: timed_steps(step_on, on, n_steps, draw), record=False)
        print(f"[{path}] {n_steps} steps: {seconds[path]:.4f} s per step, "
              f"{b / seconds[path]:.1f} examples/s (host clock, warm)", flush=True)
        for n, count in counted.items():
            check(count == n_steps * launches[n],
                  f"{path} {n}: {count} launches over {n_steps} steps, {launches[n]} per step")
        profile_step(lambda: step_on(on, *draw()), path, seconds[path])

        # 4. every kernel call of the step against its plain version
        hold_against_plain(calls, path, timed=False)

    # WAE/Dual-GAN with the fused decoder batch: pallas_bn off (vsplit forbids
    # it), the weight-grad kernel on; held against the unfused step
    kind = "wae-vgan"
    weights = from_jax_groups(random_groups(cfg, seed=0, kind=kind), cfg, kind)

    def dual_state(cfg_):
        nets = st.WaeDualGan(cfg_)
        nets.load_state_dict(weights, strict=True)
        return warm_moments(st.make_wae_dual_gan_state(nets.to(dev), cfg_))

    cfg_fused = with_flags(cfg, pallas_backward=True, fused_decoder_batch=True)
    cfg_seq = with_flags(cfg, pallas_backward=True)
    draw = paths["wae_vgan"][4]
    args = draw()
    fused_step = make_wae_vgan_step(cfg_fused).train_step
    (fused, m_fused), launches, calls, _ = record_step(
        lambda: fused_step(dual_state(cfg_fused), *args))
    print(f"[wae_vgan_fused] launches per step {launches}", flush=True)
    check(launches == {"bn_bwd_reduce": 0, "bn_bwd_apply": 0,
                       "tap_matmul": WAE_FUSED_DW_LAUNCHES},
          f"wae_vgan_fused: launches per step {launches}")
    launches_by_path["wae_vgan_fused"] = launches
    seq, m_seq = make_wae_vgan_step(cfg_seq).train_step(dual_state(cfg_seq), *args)
    check_step("wae_vgan fused vs unfused decoder batch on the card", fused, m_fused, seq,
               m_seq, weights, STEP_TOL)
    hold_against_plain(calls, "wae_vgan_fused", timed=False)
    (fused, seconds["wae_vgan_fused"], _), _, _, _ = record_step(
        lambda: timed_steps(fused_step, fused, 5, draw), record=False)
    print(f"[wae_vgan_fused] 5 steps: {seconds['wae_vgan_fused']:.4f} s per step "
          f"(host clock, warm)", flush=True)
    profile_step(lambda: fused_step(fused, *draw()), "wae_vgan_fused",
                 seconds["wae_vgan_fused"])
    return launches_by_path, seconds


def wae_inference_phase(dev, cfg, batches, data):
    """Phase 4c: the WAE inference path (``--family wae --stage 3``: fMRI ->
    image through the mean latent), the third entry point to the SSIM
    kernel, over the phase-4 batches with ``sample=True`` (the WAE eval
    ignores it). Its SSIM launches counted alone (exactly 4), each call
    held against the plain version; its metrics against the plain SSIM; 8
    pairs against the CPU. Returns (SSIM launches, the largest |kernel -
    plain| of the SSIM mean)."""
    import torch

    from fmri_tpu_torch.checkpoints.convert import (
        UNUSED_PREFIXES, from_jax_groups, random_groups,
    )
    from fmri_tpu_torch.data.transforms import denormalize
    from fmri_tpu_torch.eval.evaluate import (
        objective_scores, quality_metrics, reconstruct_dataset,
    )
    from fmri_tpu_torch.eval.steps import WaeCognitive
    from fmri_tpu_torch.ops import ssim as ssim_ops
    from fmri_tpu_torch.ops.ssim import ssim_plain, ssim_plane_sums

    n, bs = len(data["fmri"]), len(batches[0]["fmri"])
    wae_sd = {k: v for k, v in from_jax_groups(
        random_groups(cfg, seed=0, kind="wae-gan-cognitive"), cfg,
        "wae-gan-cognitive").items() if not k.startswith(UNUSED_PREFIXES)}
    wae = WaeCognitive(cfg.model)
    wae.load_state_dict(wae_sd, strict=True)
    wae.to(dev)
    calls = {}
    recorder = Recorder(ssim_ops, "ssim_plane_sums", calls)
    ssim_plane_sums.launches = 0
    rw, tw = reconstruct_dataset(wae, batches, mean=cfg.data.mean, std=cfg.data.std,
                                 sample=True)
    mw = quality_metrics(rw, tw)
    sw = objective_scores(rw, tw, tops=(2, 5, 10))
    launches = ssim_plane_sums.launches
    recorder.restore()
    recorded = sum(count for _, count in calls.values())
    check(recorded == launches == SSIM_LAUNCHES_PER_RUN,
          f"ssim on the WAE inference path: {launches} launches and {recorded} "
          f"recorded calls, want {SSIM_LAUNCHES_PER_RUN}")
    max_err = 0.0
    for (a, b, *rest), count in calls.values():
        err, img_err, _ = hold_ssim_call(a, b, rest)
        max_err = max(max_err, err)
        print(f"[inference] WAE: ssim {list(a.shape)} x{count} |kernel - plain| "
              f"{err:.3g}, per image from float64 {img_err:.3g}", flush=True)
    size = cfg.model.image_size
    check(tuple(rw.shape) == (n, size, size, 3) and bool(torch.isfinite(rw).all()),
          f"WAE recons {tuple(rw.shape)}, finite {bool(torch.isfinite(rw).all())}")
    errw = abs(mw["ssim"] - quality_metrics(rw, tw, ssim_fn=ssim_plain)["ssim"])
    check(errw <= TOL, f"WAE quality ssim differs from plain by {errw}")
    cpu_wae = WaeCognitive(cfg.model)
    cpu_wae.load_state_dict(wae_sd, strict=True)
    small = torch.from_numpy(data["fmri"][:8])
    err = float((wae.reconstruct(small.to(dev)).cpu() - cpu_wae.reconstruct(small)).abs().max())
    check(err <= 1e-4, f"WAE card vs CPU reconstruction differ by {err}")
    mean_latent = denormalize(wae.reconstruct(torch.from_numpy(data["fmri"][:bs]).to(dev)),
                              cfg.data.mean, cfg.data.std)
    gap = float((rw[:bs] - mean_latent).abs().max())
    check(gap <= TOL, f"the WAE eval sampled ({gap} from the mean latent's images)")
    print(f"[inference] WAE stage III (fMRI -> image, mean latent; sample ignored) over "
          f"the same {n} pairs: metrics {mw}; objective {sw}; ssim launches {launches}; "
          f"|kernel - plain| {errw:.3g}; |card - cpu| {err:.3g}", flush=True)
    return launches, max(max_err, errw)


# launches per res64 step on the trainer paths, both kernel flags on: the
# bare steps' (phases 6, 7 and 10); each epoch runs TRAINER_STEPS steps and
# two SSIM launches (the validation pass and the train-batch metrics)
TRAINER_LAUNCHES = {
    "trainer_stage1": {"bn_bwd_reduce": 17, "bn_bwd_apply": 17,
                       "tap_matmul": DW_LAUNCHES_PER_STEP},
    "trainer_stage2": COGNITIVE_LAUNCHES[2], "trainer_stage3": COGNITIVE_LAUNCHES[3],
    "trainer_wae1": WAE_LAUNCHES["wae_stage1"]}
TRAINER_EXAMPLES, TRAINER_VALID = 640, 64  # 576 train examples: 9 steps of 64
TRAINER_STEPS = (TRAINER_EXAMPLES - TRAINER_VALID) // 64
# epochs of each timed trainer path: 0 warms up, 1 is profiled, 2 is clean
TRAINER_EPOCHS = 3
SSIM_LAUNCHES_PER_EPOCH = 2


class EpochClock:
    """Wraps a trainer's steps to time each epoch's train loop on the host
    clock: the first ``train_step`` of an epoch synchronizes and starts the
    clock, the first ``eval_step`` after it synchronizes and stops it (the
    evaluation follows the loop). ``loops`` holds (seconds, steps)."""

    def __init__(self, steps):
        from fmri_tpu_torch.train.steps_vgan import StepFns

        self.inner, self.t0, self.n, self.loops = steps, None, 0, []
        self.steps = StepFns(self.train_step, self.eval_step, steps.generate_step)

    def train_step(self, *args):
        import torch

        if self.t0 is None:
            torch.cuda.synchronize()
            self.t0, self.n = time.perf_counter(), 0
        self.n += 1
        return self.inner.train_step(*args)

    def eval_step(self, *args):
        import torch

        if self.t0 is not None:
            torch.cuda.synchronize()
            self.loops.append((time.perf_counter() - self.t0, self.n))
            self.t0 = None
        return self.inner.eval_step(*args)


def set_launches(value: int = 0) -> dict:
    """Every kernel's launch count, read, then set to ``value``."""
    from fmri_tpu_torch.ops import bn, dw
    from fmri_tpu_torch.ops import ssim as ssim_ops

    fns = {"bn_bwd_reduce": bn.bn_bwd_reduce, "bn_bwd_apply": bn.bn_bwd_apply,
           "tap_matmul": dw.tap_matmul, "ssim": ssim_ops.ssim_plane_sums}
    out = {name: fn.launches for name, fn in fns.items()}
    for fn in fns.values():
        fn.launches = value
    return out


def fit_path(path, cfg, built, data, run_dir, n_epochs, bare_s, *, record=True,
             profile=True, checkpoints=True, snapshot_epoch0=False):
    """One trainer path: ``Trainer.fit`` of ``built`` (a builder's result)
    over ``data`` (train, valid) for ``n_epochs``, with ``profile`` the
    second epoch traced (``--profile``), with ``record`` every BN/dW/SSIM
    call recorded and held against its plain version afterwards. Checks
    each epoch's launches (``TRAINER_LAUNCHES[path]`` times the steps, 2
    SSIM). Prints the seconds per step of each epoch's train loop through
    the trainer beside the bare step's (``bare_s``), the epochs' wall
    seconds and images per second, and the profiled epoch's device busy
    share. Returns (final state, launches in the first epoch, {numbers},
    {"state", "row"} of epoch 0 where ``snapshot_epoch0``); without
    ``checkpoints`` the run writes none."""
    import copy
    import os

    import torch

    from fmri_tpu_torch.ops import bn, dw
    from fmri_tpu_torch.ops import ssim as ssim_ops
    from fmri_tpu_torch.train.trainer import Trainer
    from fmri_tpu_torch.utils import profile_report

    state, steps, kw = built
    clock = EpochClock(steps)
    os.makedirs(run_dir, exist_ok=True)
    trainer = Trainer(cfg, clock.steps, run_dir, profile=profile, tensorboard=False,
                      debug=not checkpoints, **kw)
    calls = {n: {} for n in ("bn_bwd_reduce", "bn_bwd_apply", "conv2d_dw",
                             "conv2d_transpose_dw", "ssim_plane_sums")}
    recorders = [Recorder(mod, n, calls[n]) for mod, n in (
        (bn, "bn_bwd_reduce"), (bn, "bn_bwd_apply"), (dw, "conv2d_dw"),
        (dw, "conv2d_transpose_dw"), (ssim_ops, "ssim_plane_sums"))] if record else []
    per_epoch, walls, snapshot = [], [], {}
    mark = [time.perf_counter()]

    def at_epoch_end(epoch, st, row):
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - mark[0])
        per_epoch.append(set_launches(0))
        if epoch == 0 and snapshot_epoch0:
            snapshot["state"], snapshot["row"] = copy.deepcopy(st), dict(row)
        mark[0] = time.perf_counter()

    set_launches(0)
    try:
        state = trainer.fit(state, *data, n_epochs=n_epochs, eval_batches=1, grid_every=1,
                            epoch_callback=at_epoch_end)
    finally:
        for r in recorders:
            r.restore()
    want = {k: TRAINER_STEPS * v for k, v in TRAINER_LAUNCHES[path].items()}
    want["ssim"] = SSIM_LAUNCHES_PER_EPOCH
    for epoch, got in enumerate(per_epoch):
        check(got == want, f"{path} epoch {epoch}: launches {got}, want {want}")
    if record:
        hold_against_plain(calls, path, timed=False)
        for (a, b, *rest), _ in calls["ssim_plane_sums"].values():
            hold_ssim_call(a, b, rest)
    n_img = TRAINER_STEPS * cfg.train.batch_size
    numbers = {"s_per_step": [s / n for s, n in clock.loops], "bare_s_per_step": bare_s,
               "epoch_wall_s": walls,
               "train_images_per_s": [n_img / s for s, _ in clock.loops]}
    print(f"[{path}] {n_epochs} epochs of {TRAINER_STEPS} steps at batch "
          f"{cfg.train.batch_size}{' (recorded)' if record else ''}: launches per epoch "
          f"{per_epoch[0]} (want {want}); s per step through the Trainer "
          f"{['%.4f' % s for s in numbers['s_per_step']]}"
          f"{' (epoch 1 profiled)' if profile else ''} vs the bare step {bare_s:.4f}; "
          f"epoch wall s {['%.3f' % w for w in walls]} (evaluation, grids and checkpoints "
          f"included); train images/s {['%.1f' % r for r in numbers['train_images_per_s']]}",
          flush=True)
    if profile:
        prof = profile_report.summarize(os.path.join(run_dir, "profile", "trace.json"))
        check(prof["kernels"] > 0 and prof["idle_share"] is not None,
              f"{path}: the profiled epoch traced no device kernel")
        numbers.update(profiled_busy_share=1 - prof["idle_share"],
                       profiled_busy_ms=prof["busy_ms"], profiled_window_ms=prof["window_ms"])
        print(f"[{path}] profiled epoch (torch.profiler -> utils/profile_report.py): "
              + profile_report.format_report(prof, top=6).replace("\n", " | "), flush=True)
    return state, per_epoch[0], numbers, snapshot


def bare_loop(steps, state, batches, n_steps=TRAINER_STEPS):
    """Seconds per step of ``n_steps`` calls of the adapter's
    ``train_step`` over ``batches`` [(batch, noise, gate)] already on the
    device and augmented: the trainer's loop without the trainer."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch, noise, gate in batches[:n_steps]:
        state, _ = steps.train_step(state, batch, noise, *gate)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n_steps


def checkpoint_seconds(path, state, work) -> dict:
    """Seconds to write ``state`` as a checkpoint under ``work``: sync, and
    through the async writer (the caller's part, the host copy; and until
    written). Prints and returns them; the files are removed."""
    import os
    import shutil

    import torch

    from fmri_tpu_torch.checkpoints import store

    ckpt_dir = os.path.join(work, "ckpt_timing")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    store.save_checkpoint(ckpt_dir, 0, state)
    sync_s = time.perf_counter() - t0
    writer = store.AsyncCheckpointWriter()
    t0 = time.perf_counter()
    writer.save(ckpt_dir, 1, state)
    caller_s = time.perf_counter() - t0
    writer.wait()
    total_s = time.perf_counter() - t0
    mib = os.path.getsize(os.path.join(ckpt_dir, "ckpt_00001", "state.pt")) / 2**20
    shutil.rmtree(ckpt_dir)
    print(f"[{path}] checkpoint of {mib:.1f} MiB: sync write {sync_s:.3f} s; async: "
          f"{caller_s:.3f} s on the caller (the host copy), {total_s:.3f} s until written",
          flush=True)
    return {"ckpt_mib": mib, "ckpt_sync_s": sync_s, "ckpt_async_caller_s": caller_s,
            "ckpt_async_total_s": total_s}


def state_gaps(name, a, b, start, tol) -> None:
    """``tensor_gaps`` of train state ``a`` from ``b``, the worst per kind
    within ``tol``; says whether the two are bitwise equal."""
    import torch

    worst = {"param": 0.0, "stats": 0.0, "sq": 0.0}
    for kind, gap in tensor_gaps(a, b, start).values():
        worst[kind] = max(worst[kind], gap)
    sa, sb = a.nets.state_dict(), b.nets.state_dict()
    same = all(torch.equal(sa[k], sb[k]) for k in sb) and torch.equal(a.step, b.step)
    print(f"[trainer] {name}: worst {worst} (bounds {tol}); bitwise equal: {same}",
          flush=True)
    check(all(worst[k] <= tol[k] for k in worst), f"{name}: {worst} outside {tol}")


def trainer_phase(dev, cfg, preset, bare_seconds):
    """Phase 11: the training driver, both kernel flags on. (a)
    ``vgan_stage1`` through ``Trainer.fit``, then its exactness checks; (b)
    ``vgan_stage2`` from (a)'s checkpoint dir, then ``vgan_stage3`` from
    stage II's; (c) ``wae_stage1``; (d) the train and inference CLIs as
    users call them. Returns ({path: launches in one epoch}, {path:
    numbers})."""
    import csv
    import dataclasses
    import os
    import shutil

    import torch

    from fmri_tpu_torch.checkpoints import store
    from fmri_tpu_torch.data.pipeline import Batches, to_device
    from fmri_tpu_torch.data.synthetic import synthetic_images, synthetic_pairs
    from fmri_tpu_torch.data.transforms import train_augment
    from fmri_tpu_torch.eval import inference
    from fmri_tpu_torch.ops import ssim as ssim_ops
    from fmri_tpu_torch.train import run
    from fmri_tpu_torch.train.stages import BUILDERS
    from fmri_tpu_torch.train.trainer import Draws, DrawSpec, GameSchedules, Trainer

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_smoke_runs")
    shutil.rmtree(work, ignore_errors=True)
    t = cfg.train
    # the kernels on, checkpoints only at epoch 0 and the final epoch
    cfg = dataclasses.replace(with_flags(cfg, pallas_bn=True, pallas_backward=True),
                              train=dataclasses.replace(t, ckpt_every=100, batch_size=64))
    t, size = cfg.train, cfg.model.image_size
    imgs = synthetic_images(TRAINER_EXAMPLES, size, seed=0)[0]
    images = (imgs[TRAINER_VALID:], imgs[:TRAINER_VALID])
    pairs = synthetic_pairs(TRAINER_EXAMPLES, size, cfg.model.num_voxels, seed=0)
    pairs = ({k: v[TRAINER_VALID:] for k, v in pairs.items()},
             {k: v[:TRAINER_VALID] for k, v in pairs.items()})
    spe = TRAINER_STEPS
    launches, numbers = {}, {}
    try:
        # (a) stage I: the timed and profiled epochs, the checkpoint restored,
        # the bare step over epoch 0's batches
        run_a = os.path.join(work, "stage1")
        build = lambda: BUILDERS["vgan_stage1"](cfg, steps_per_epoch=spe, seed=t.seed,  # noqa: E731
                                                device=dev)
        start = {k: v.cpu().clone() for k, v in build()[0].nets.state_dict().items()}
        final, launches["trainer_stage1"], numbers["trainer_stage1"], snap = fit_path(
            "trainer_stage1", cfg, build(), images, run_a, TRAINER_EPOCHS,
            bare_seconds["stage1"], record=False, snapshot_epoch0=True)
        restored, meta = store.restore_checkpoint(os.path.join(run_a, "checkpoints"),
                                                  build()[0])
        sa, sb = restored.nets.state_dict(), final.nets.state_dict()
        check(meta["epoch"] == TRAINER_EPOCHS - 1
              and all(torch.equal(sa[k], sb[k]) for k in sb)
              and torch.equal(restored.step, final.step)
              and all(torch.equal(restored.opt_state[g][k], final.opt_state[g][k])
                      for g in final.opt_state for k in final.opt_state[g]),
              "trainer_stage1: the restored checkpoint differs from the live state")

        def epoch0_batches(kw):
            """Epoch 0's batches as the trainer draws them: order, draws,
            augmentation and game scalars, staged on the device."""
            batches = Batches(images[0], t.batch_size, shuffle=True, seed=t.seed)
            draws = Draws(t.seed)
            spec = DrawSpec(t.batch_size, cfg.model.latent_dim, kw["augment"]["flip"],
                            kw["augment"]["max_shift"], kw["noise"], dev)
            gate = GameSchedules(cfg).args(dev)
            out = []
            for i, batch in enumerate(batches):
                flip, shifts, noise = draws.train(0, i, spec)
                out.append((train_augment(to_device(batch, dev), flip, shifts,
                                          cfg.data.mean, cfg.data.std), noise, gate))
            return out

        state, steps, kw = build()
        staged = epoch0_batches(kw)
        bare_loop(steps, state, staged)  # warm
        loop_s = bare_loop(steps, state, staged)
        numbers["trainer_stage1"]["bare_loop_s_per_step"] = loop_s
        print(f"[trainer_stage1] the same step over epoch 0's batches staged on the "
              f"device beforehand: {loop_s:.4f} s per step (the Trainer's clean epoch: "
              f"{numbers['trainer_stage1']['s_per_step'][-1]:.4f})", flush=True)

        # exactness, with cuDNN's deterministic algorithms (its default dgrad
        # may sum in any order, and from zero moments the equilibrium gate
        # and RMSprop's first updates turn rounding into different runs):
        # epoch 0 through the Trainer (every kernel call recorded) against a
        # hand loop of the step over the same batches and draws, and the run
        # resumed after epoch 0 against the uninterrupted epoch 1
        torch.backends.cudnn.deterministic = True
        try:
            run_d = os.path.join(work, "stage1_deterministic")
            final_d, _, _, snap_d = fit_path(
                "trainer_stage1", cfg, build(), images, run_d, 2, bare_seconds["stage1"],
                profile=False, snapshot_epoch0=True)
            hand, steps, kw = build()
            for batch, noise, gate in epoch0_batches(kw):
                hand, _ = steps.train_step(hand, batch, noise, *gate)
            state_gaps("trainer_stage1 epoch 0 vs a hand loop of the step", snap_d["state"],
                       hand, start, STEP_TOL)
            resumed, meta = store.restore_checkpoint(os.path.join(run_d, "checkpoints"),
                                                     build()[0], epoch=0)
            run_b = os.path.join(work, "stage1_resumed")
            os.makedirs(run_b)
            resumed = Trainer(cfg, build()[1], run_b, tensorboard=False, **kw).fit(
                resumed, *images, start_epoch=meta["epoch"] + 1, n_epochs=2, grid_every=1)
            state_gaps("trainer_stage1 resumed after epoch 0 vs the uninterrupted epoch 1",
                       resumed, final_d, start, STEP_TOL)
        finally:
            torch.backends.cudnn.deterministic = False

        with open(os.path.join(run_a, "results.csv")) as f:
            reader = csv.DictReader(f)
            columns, rows = reader.fieldnames, list(reader)
        eval_cols = [f"{p}_{m}" for p in ("valid", "train") for m in ("MSE", "PCC", "SSIM")]
        want_cols = ["epoch"] + sorted(k for k in snap["row"]
                                       if k != "epoch" and k not in eval_cols) + eval_cols
        check(len(rows) == TRAINER_EPOCHS and columns == want_cols,
              f"trainer_stage1 results.csv: {len(rows)} rows, columns {columns}")
        check(all(float(v) == float(v) for r in rows for v in r.values()),
              "trainer_stage1 results.csv holds a NaN")
        for name in ("epoch_0000.png", "epoch_0000_original.png",
                     "epoch_0000_generated.png", "epoch_0002.png"):
            check(os.path.getsize(os.path.join(run_a, "images", "valid", name)) > 0,
                  f"trainer_stage1: no grid {name}")

        numbers["trainer_stage1"].update(checkpoint_seconds("trainer_stage1", final, work))
        print("[trainer_stage1] resume, restore, hand loop, results.csv and grids checked",
              flush=True)

        # (b) the handoff: stage II from (a)'s checkpoints, stage III from II's
        prev = os.path.join(run_a, "checkpoints")
        frozen = {"trainer_stage2": ("decoder.", "teacher_net.encoder."),
                  "trainer_stage3": ("encoder.", "teacher_net.encoder.")}
        for stage, path in ((2, "trainer_stage2"), (3, "trainer_stage3")):
            key = "stage1_ckpt" if stage == 2 else "stage2_ckpt"
            built = BUILDERS[f"vgan_stage{stage}"](cfg, **{key: prev}, steps_per_epoch=spe,
                                                   seed=t.seed, device=dev)
            before = {k: v.clone() for k, v in built[0].nets.state_dict().items()}
            run_dir = os.path.join(work, path)
            state, launches[path], numbers[path], _ = fit_path(
                path, cfg, built, pairs, run_dir, TRAINER_EPOCHS,
                bare_seconds[f"stage{stage}"],
                checkpoints=stage == 2)
            sd = state.nets.state_dict()
            moved = [k for k, v in sd.items() if k.startswith(frozen[path])
                     and "running" not in k and "num_batches" not in k
                     and not torch.equal(v, before[k])]
            check(not moved, f"{path}: frozen tensors moved: {moved[:3]}")
            print(f"[{path}] frozen groups {frozen[path]} bitwise unchanged", flush=True)
            numbers[path].update(checkpoint_seconds(path, state, work))
            prev = os.path.join(run_dir, "checkpoints")

        # (c) WAE stage I
        state, launches["trainer_wae1"], numbers["trainer_wae1"], _ = fit_path(
            "trainer_wae1", cfg, BUILDERS["wae_stage1"](cfg, steps_per_epoch=spe,
                                                        seed=t.seed, device=dev),
            images, os.path.join(work, "wae1"), TRAINER_EPOCHS, bare_seconds["wae_stage1"],
            checkpoints=False)
        numbers["trainer_wae1"].update(checkpoint_seconds("trainer_wae1", state, work))

        # (d) the CLIs as users call them, on the default device (the card)
        set_launches(0)
        t0 = time.perf_counter()
        check(run.main(["--family", "vgan", "--stage", "1", "--preset", preset,
                        "--dataset", "synthetic", "--synthetic-n", str(TRAINER_EXAMPLES),
                        "--epochs", "1", "-o", os.path.join(work, "cli")]) == 0,
              "the train CLI failed")
        cli_s = time.perf_counter() - t0
        cli_launches = set_launches(0)
        # the presets keep both kernel flags off, as the JAX package's do
        check(cli_launches == {"bn_bwd_reduce": 0, "bn_bwd_apply": 0, "tap_matmul": 0,
                               "ssim": SSIM_LAUNCHES_PER_EPOCH},
              f"train CLI: {cli_launches}, want {SSIM_LAUNCHES_PER_EPOCH} SSIM launches only")
        cli_run, = (os.path.join(work, "cli", "vgan_stage1", d)
                    for d in os.listdir(os.path.join(work, "cli", "vgan_stage1")))
        calls = {}
        recorder = Recorder(ssim_ops, "ssim_plane_sums", calls)
        try:
            check(inference.main(["--family", "vgan", "--stage", "1", "--preset", preset,
                                  "--dataset", "synthetic", "--synthetic-n",
                                  str(TRAINER_EXAMPLES), "--ckpt",
                                  os.path.join(cli_run, "checkpoints"),
                                  "-o", os.path.join(work, "inference")]) == 0,
                  "the inference CLI failed on the trained run")
        finally:
            recorder.restore()
        inf_launches = set_launches(0)
        check(inf_launches["ssim"] == SSIM_LAUNCHES_PER_RUN,
              f"inference from the trained run: {inf_launches['ssim']} SSIM launches, "
              f"want {SSIM_LAUNCHES_PER_RUN}")
        for (a, b, *rest), _ in calls.values():
            hold_ssim_call(a, b, rest)
        with open(os.path.join(work, "inference", "summary.json")) as f:
            summary = json.load(f)
        check(summary["checkpoint_epoch"] == 0 and summary["num_images"] == TRAINER_VALID
              and 0.0 < summary["ssim"] <= 1.0,
              f"inference from the trained run: {summary}")
        launches["train_cli"] = cli_launches
        launches["inference_trained_run"] = inf_launches
        print(f"[trainer_cli] python -m fmri_tpu_torch.train.run --preset {preset}, 1 epoch: "
              f"{cli_s:.2f} s wall (imports excluded), launches {cli_launches}; inference "
              f"from its checkpoint dir: launches {inf_launches}, ssim {summary['ssim']:.4f}",
              flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches, numbers


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
        from fmri_tpu_torch.eval.steps import VaeGanCognitive, VaeGanVisual
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
    check(recorded == launches["ssim"] == SSIM_LAUNCHES_PER_RUN,
          f"ssim: {launches['ssim']} launches and {recorded} recorded calls, want "
          f"{SSIM_LAUNCHES_PER_RUN}")
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

    # 4b. the stage-I inference path (image -> image, --stage 1), the second
    #     entry point to the SSIM kernel: the same images, a stage-I model
    stage1 = {k: v for k, v in from_jax_groups(
        random_groups(cfg, seed=0, kind="vae-gan"), cfg, "vae-gan").items()
        if not k.startswith("discriminator.")}
    visual = VaeGanVisual(cfg.model)
    visual.load_state_dict(stage1, strict=True)
    visual.to(dev)
    images = [{"image": batch["image"]} for batch in batches]
    ssim_calls1 = {}
    recorder = Recorder(ssim_ops, "ssim_plane_sums", ssim_calls1)
    ssim_plane_sums.launches = 0
    r1, t1 = reconstruct_dataset(visual, images, mean=cfg.data.mean, std=cfg.data.std)
    m1 = quality_metrics(r1, t1)
    s1 = objective_scores(r1, t1, tops=(2, 5, 10))
    launches["ssim_stage1"] = ssim_plane_sums.launches
    recorder.restore()
    recorded = sum(count for _, count in ssim_calls1.values())
    check(recorded == launches["ssim_stage1"] == SSIM_LAUNCHES_PER_RUN,
          f"ssim on the stage-I inference path: {launches['ssim_stage1']} launches and "
          f"{recorded} recorded calls, want {SSIM_LAUNCHES_PER_RUN}")
    # every call of this path against the plain version on its own inputs
    for (a, b, *rest), count in ssim_calls1.values():
        err, img_err, _ = hold_ssim_call(a, b, rest)
        max_err = max(max_err, err)
        print(f"[inference] stage I: ssim {list(a.shape)} x{count} |kernel - plain| "
              f"{err:.3g}, per image from float64 {img_err:.3g}", flush=True)
    check(tuple(r1.shape) == (n, 64, 64, 3) and bool(torch.isfinite(r1).all()),
          f"stage-I recons {tuple(r1.shape)}, finite {bool(torch.isfinite(r1).all())}")
    err1 = abs(m1["ssim"] - quality_metrics(r1, t1, ssim_fn=ssim_plain)["ssim"])
    check(err1 <= TOL, f"stage-I quality ssim differs from plain by {err1}")
    cpu_visual = VaeGanVisual(cfg.model)
    cpu_visual.load_state_dict(stage1, strict=True)
    x8 = torch.from_numpy(2.0 * data["image"][:8] - 1.0)
    err = float((visual.reconstruct(x8.to(dev)).cpu() - cpu_visual.reconstruct(x8)).abs().max())
    check(err <= 1e-4, f"stage-I card vs CPU reconstruction differ by {err}")
    print(f"[inference] stage I (image -> image) over the same {n} images: metrics {m1}; "
          f"objective {s1}; ssim launches {launches['ssim_stage1']}; |kernel - plain| "
          f"{err1:.3g}; |card - cpu| {err:.3g}", flush=True)

    # 4c. the WAE inference path
    launches["ssim_wae"], err = wae_inference_phase(dev, cfg, batches, data)
    max_err = max(max_err, err)

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

    # 6. train, stage I
    train_kernels, stage1_launches, stage1_seconds = train_phase(dev, cfg)

    # 7. train, stages II and III
    launches_by_path, seconds = cognitive_phase(dev, cfg)
    launches_by_path = {"stage1": stage1_launches, **launches_by_path}
    seconds = {"stage1": stage1_seconds, **seconds}

    # 9. the stage-I step with alt_backward; 10. the WAE train paths
    alt_launches, alt_seconds, dgrad = alt_phase(dev, cfg)
    wae_launches, wae_seconds = wae_phase(dev, cfg)
    launches_by_path.update(alt_launches)
    launches_by_path.update(wae_launches)
    seconds.update(alt_seconds)
    seconds.update(wae_seconds)

    # 11. the training driver: whole epochs through the Trainer, the CLIs
    trainer_launches, trainer_numbers = trainer_phase(dev, cfg, "res64", seconds)
    for entry in train_kernels:
        entry["launches_by_path"] = {path: counts[entry["name"]]
                                     for path, counts in launches_by_path.items()}
        entry["launches_by_path"].update(
            {path: counts[entry["name"]] for path, counts in trainer_launches.items()
             if path.startswith("trainer_")})

    # 8. kernels line; ssim at every shape the inference run gave it, each
    #    held against the plain version, times summed over the run's launches
    ssim_tot = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "flops": 0.0,
                "bytes": 0.0, "sources": set(), "shapes": []}
    ms_b1024 = None
    for (a, b, *rest), count in ssim_calls.values():
        err, img_err, img_err_plain = hold_ssim_call(a, b, rest)
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
        "launches_by_path": {"inference": launches["ssim"],
                             "inference_stage1": launches["ssim_stage1"],
                             "inference_wae": launches["ssim_wae"],
                             "trainer_validation": trainer_launches["trainer_stage1"]["ssim"],
                             "train_cli": trainer_launches["train_cli"]["ssim"],
                             "inference_trained_run":
                                 trainer_launches["inference_trained_run"]["ssim"]},
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
    print(f"[train] seconds per step at batch {cfg.train.batch_size}, both kernel flags "
          f"on (stage3_fused, wae_vgan_fused: pallas_backward only; stage1_alt: "
          f"alt_backward only; stage1_stock: no flag), host clock, warm: "
          f"{json.dumps(seconds)}", flush=True)
    print(f"[alt] cuDNN dgrad device ms per stage-I step: {json.dumps(dgrad)}", flush=True)
    print(f"[trainer] per path (host clock; epoch 1 profiled): "
          f"{json.dumps(trainer_numbers)}", flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
