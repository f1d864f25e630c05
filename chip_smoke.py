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
     the plain SSIM (SSIM within 1e-5, n-way fractions within 1/N); the
     Inception Score (the proxy) is its own stage, its probabilities held
     against the same proxy on the CPU (``PROXY_PROB_TOL``, ``IS_REL_TOL``),
     ``quality_metrics`` timed without it as before; and a
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
  5. serving: ``ServingModel`` (max_batch 64, uint8 output; on the card it
     replays one CUDA graph per bucket) answers requests of 1, 5, 64 and
     130 rows and ``generate(4)``; a request reconstructed alone equals it
     reconstructed inside a padded batch (float output within 1e-5; uint8
     within 1 LSB, as cuDNN may pick another algorithm per batch size);
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
     version evaluated in float64 on the same inputs (the mean within 1e-5,
     per image within ``SSIM_IMAGE_TOL``; ``hold_ssim_call`` says why not
     the fp32 plain version), and the same bits twice; then one JSON line
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
     seconds (sync, async); then, with the ``Trainer``'s own defaults
     (it runs cuDNN's deterministic algorithms; the smoke sets no flag), a
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
     epoch's device busy share. Each of (a), (b) and (c) runs again with
     cuDNN's default algorithms in each train step (``DefaultCudnn`` sets
     the flag off by hand around the step) and prints the cost of
     determinism per step (``[determinism]`` lines). In the ``kernels`` line
     the ``trainer_*`` paths count one epoch's launches;
  12. serve: serving from phase 11's res64 checkpoint dirs, max_batch 64
     (``serve_phase``). (a) ``vgan_stage3`` with float and with uint8
     output: warmup captures 14 CUDA graphs (7 buckets x reconstruct and
     generate), captured with cuDNN's deterministic algorithms; every
     bucket's graph against the same server with eager programs under
     those algorithms (float 1e-6, uint8 1 LSB), both timed per bucket
     beside eager programs with cuDNN's defaults (50 warm calls, each
     ending in the host pull); the same 64 rows twice, the graph's bitwise
     (the defaults' gap printed); requests of 1, 5, 64 and 130
     rows, each row alone vs in the batch (1e-5, 1 LSB); ``generate(4)``
     against the decoder on the same generator draws (1e-6); (b)
     ``vgan_stage1`` and ``wae_stage1`` serve 1 and 64 images in [0, 1],
     each against the eager preprocess, reconstruct, denormalize and clip
     (1e-5); (c) a ``vgan_stage2`` server reloads ``vgan_stage3``: no graph
     captured again, outputs bitwise a fresh stage-III server's; a stage-I
     dir refused with the outputs bitwise kept; (d) ``BatchingServer``: 512
     one-row requests from 32 threads (max_wait_ms 5), each within 1 LSB of
     ``reconstruct``; requests/s, batches, occupancy and latency
     percentiles; (e) ``python -m fmri_tpu_torch.eval.serve`` as users
     start it (no ``--device``: the card) through the port's
     ``ServeClient`` (pool 8): ping, 256 rows within 1 LSB of (d)'s,
     ``generate(4)``, ``generate(8 x 64 + 1)`` refused, reload of the
     stage-II dir, stats; a second server with ``--max-queue 6`` takes a
     burst of 8 clients x 4 requests, each reply an image or ``"shed":
     true``, the server's shed count equal to the replies'; both stopped
     with SIGINT, exit code 0. No BN, dW or SSIM kernel may launch over the
     phase (``serve: 0`` in each kernel's ``launches_by_path``);
  13. data: the host data path (``data_phase``). (a) the port's native
     loader (``fmri_tpu_torch/native/loader.cc``) builds with g++ (else the
     run fails, printing ``why_unavailable()``); on a memory-mapped packed
     pair dir of 20,000 res64 pairs (3,620 fp32 voxels and a 64x64x3 uint8
     image each, 535 MB, written by ``write_packed`` and removed after),
     ``gather``, ``gather_dequant`` and ``prefetch`` of 4,096 shuffled rows
     bitwise numpy's; (b) ``Batches`` (shuffled, batch 64, 312 batches)
     through the native gather bitwise numpy's gather, then seconds per epoch
     of each, warm (numpy, native, native, numpy) and cold (``fsync`` and
     ``POSIX_FADV_DONTNEED`` on each array file, mapped again), and the
     thread count; (c) ``python -m fmri_tpu_torch.train.run --family vgan
     --stage 1 --preset res64`` for one epoch on a 1,280-pair packed dir (18
     steps): its ``Batches`` on the native gather, exactly 2 SSIM launches
     (``data`` in each kernel's ``launches_by_path``), each held against
     plain, BN and dW 0; (d) raw data (Pillow, scipy): 640 COCO-style
     stimuli of 400-480 px (JPEG and PNG, every 7th greyscale, every 11th
     RGBA) trained one epoch at res64 with ``--cache-dir``; the same run
     again from the cache with the decoder raising; ``CSI1..CSI4`` ROI dirs
     (100 records of 3,620 voxels each) through ``--dataset bold --stage 2
     --prev-ckpt`` the stage-I run; the inference CLI on its 20% split
     (exactly 4 SSIM launches, ``data_inference``, each held against
     plain); ``--dataset mnist69`` from a ``scipy.io.savemat`` file. Each
     run prints its seconds per step and wall seconds.
  14. prepare: the offline ETL (``prepare_phase``). A BOLD5000-layout tree
     (``write_bold5000``: 320 COCO-named stimuli of 400-480 px, a
     ``ds001499`` session tree of 4 subjects x 2 runs of 50 trials, one
     run without an ``ImgType`` column, empty cells, a file outside the run
     pattern; ``stim_lists`` with ``rep_`` entries) through ``python -m
     fmri_tpu_torch.data.prepare`` in subprocesses: ``parse-sessions``,
     ``stimuli-paths``, ``split-stimuli``, ``pack`` and ``pack-stream``
     over an ``.npz`` cache, a record pickle and the stimulus dir, each
     timed and its summary line checked (``extract-roi`` is not run: it
     needs h5py; the phase writes the ROI arrays itself); the cache and the
     pickle stream to the same bytes; then the train CLI one epoch on the
     streamed stimuli (2 SSIM launches) and the inference CLI on the pack
     output through ``--cache-dir`` with the decoder raising (4). No kernel
     launch in this process over the subcommands (``prepare: 0``);
  15. is_parity (``is_parity_phase``): (a) Inception-v3 at full width,
     seeded weights in torchvision's layout through
     ``FMRI_TPU_INCEPTION_NPZ``, over phase 4's 1,024 reconstructions at
     299 px, timed, 8 images' probabilities against the CPU
     (``V3_PROB_TOL``); (b) ``python -m fmri_tpu_torch.eval.parity`` at
     ``res100`` (latent 512) stage 3 on 2,560 synthetic pairs with the IS
     on: a ``.pth`` of random weights and a checkpoint dir of the same
     weights agree, ``parity.json`` has the JAX CLI's keys, exactly 8 SSIM
     launches (4 per row), each recorded 100 px call held against the
     plain version in float64 and timed beside its bound; the res100
     reconstruction's seconds and images per second, seconds by stage.
  16. exp (``exp_phase``): the ablation experiments at res64 (3,620 voxels,
     latent 128, 64 px, batch 64, fp32). (a) each ``exp_*`` step
     (``exp_decoder``, ``exp_vae``, ``exp_vgan``, ``exp_dcgan_stage1``,
     ``exp_dcgan_stage2`` from a DCGAN stage-1 checkpoint dir), states from
     the builders with moments warmed, both kernel flags on: launches per
     step exactly ``EXP_LAUNCHES``, finite metrics and parameters, the
     quirks (``exp_vae``'s discriminator bitwise with its moments at one
     while its BatchNorm ticks; ``exp_dcgan_stage2``'s frozen encoder
     bitwise, its BatchNorm ticked), against flags off per tensor
     (``check_tensors``), 5 timed steps and a profiled one, every kernel
     call against its plain version; (b) ``python -m
     fmri_tpu_torch.train.run --family exp --exp <each>`` (res64 preset:
     flags off) one epoch on synthetic data, exactly 2 SSIM launches each
     (``exp_cli_<exp>``), each held against plain, each run's checkpoint
     restored into its builder's state; (c) ``VoxelDecoder``,
     ``WaeDecoder`` (its 1024 -> 512 deconv's weight grad and 512-channel
     BatchNorm on the kernels) and ``ResNetEncoder`` forward and backward at
     batch 64, flags on against off (``BACKBONE_GRAD_TOL``), launches
     ``BACKBONE_LAUNCHES``, every recorded call against plain; VGG19's five
     taps and the full ResNet-152 trunk over seeded torchvision-layout npz
     weights and every aux loss, card against CPU (``CARD_CPU_TOL``), and
     the two trunks' images/s at 64 px. An ``[exp] numbers`` JSON line.
  17. mesh (``mesh_phase``): training across ranks (``parallel/mesh.py``).
     (a) ``python -m fmri_tpu_torch.train.run --mesh data=1`` (res64, stage
     I, 3 steps on 256 synthetic images): the NCCL group forms (a world of
     one), and its checkpoint is bitwise the run's without ``--mesh``;
     (b) ranks sharing the card over gloo (``make_mesh(..., devices=[cuda:0]
     * k, backend="gloo")``), res64 full width, global batch 64, both kernel
     flags on, moments warm: stage I at data=2, stage II at data=2 x model=2
     (fc1 split by voxels), stage III at data=2 x model=2 with the decoder's
     projection split too, WAE I at data=2. Each: rank 0's gathered state
     against the single-process step on the card (``check_tensors``:
     ``STEP_TOL``, or 3x a tensor's own rounding noise), every rank's state
     bitwise rank 0's, each rank's launches the single-process step's
     (``MESH_LAUNCHES``), every recorded BatchNorm backward against the plain
     version with the data group's all-reduce between its passes and every
     recorded kernel call against its plain version, ``MESH_STEPS`` timed
     steps (s per step beside the single-process step's) and the bytes each
     rank all-reduces per step; (c) ``Trainer.fit`` at data=2 over gloo on
     the card, 2 epochs of 4 steps with a checkpoint per epoch, each rank's
     validation SSIM over its 32 rows held against plain, the run resumed from
     its epoch-0 checkpoint bitwise the uninterrupted one, the checkpoint in
     the single-card inference CLI (4 SSIM); (d) ``dryrun_multichip(4)`` on
     the card over gloo. ``[mesh]`` lines and a ``[mesh] numbers`` JSON line;
     gloo's times are of host copies on one card, never NCCL or several
     cards' times; the ``kernels`` line's ``launches_by_path`` gains each
     ``mesh_*`` path; (d) now ends with the dry run's serving part;
  18. serve_mesh (``serve_mesh_phase``): serving over ranks. (a) ranks
     sharing the card over gloo, uint8 images, max_batch 64: res64 stage III
     at data=2, at data=2 x model=2 (``voxel_tp``, sampling) and the
     ``fullbrain`` stage II (98,304 voxels) at data=2 x model=2, random
     weights from a seed; each against the single-process server's graphs
     on the card with the same buckets and seed (1 LSB) over requests of
     1, 5, 64 and 130 rows and ``generate(70)``, ``reload`` in place on
     every rank (each rank's weights are its columns of the checkpoint), a
     refused reload that keeps them, every program a graph on every rank,
     no kernel launched; (b) ms per call at buckets 2, 8 and 64 beside the
     single-process graph's, MiB broadcast and all-reduced per call,
     graphs per rank, requests/s of 256 one-row requests through rank 0's
     ``BatchingServer``, all labelled as ranks sharing one card over gloo;
     (c) the serve CLI at ``--mesh data=1`` (NCCL) bitwise the CLI without
     it; (e) (in phase 12's callback) phase 11's stage-I and stage-III
     checkpoints through the checkpoint CLI's ``--export`` and import,
     groups and served images bitwise; ``launches_by_path`` gains
     ``serve_mesh`` (0).

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
# the IS proxy on the card against the CPU, on the same reconstructions: its
# probabilities (about 1e-3 each over 1,000 classes) and the IS's mean
PROXY_PROB_TOL, IS_REL_TOL = 1e-6, 1e-5


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
    ``TOL`` of the plain version evaluated in float64 on the same inputs,
    the same bits twice, and per image within ``SSIM_IMAGE_TOL`` of it.
    The plain version in fp32 is no reference for the mean: in flat regions
    the variances E[x^2] - mu^2 cancel down to C2 = 9e-4, where the
    rounding of its 121-term 2-D window sums takes one sign over a whole
    flat stimulus, so over phase 13's raw stimuli its mean lies further
    than ``TOL`` from float64's while the kernel's separable FMA blur stays
    well inside it. Returns (|kernel - float64| of the mean, per-image
    error from float64 of the kernel and of the fp32 plain version); the
    fp32 plain version's gaps are printed with a failure, and by phase 13
    for each of its calls."""
    import torch

    from fmri_tpu_torch.ops.ssim import ssim, ssim_plain, ssim_plane_sums

    exact = ssim_plain(a.double(), b.double(), *rest, size_average=False)
    kernel, plain = float(ssim(a, b, *rest)), float(ssim_plain(a, b, *rest))
    err = abs(kernel - float(exact.mean()))
    img_err = float((ssim(a, b, *rest, size_average=False) - exact).abs().max())
    img_err_plain = float((ssim_plain(a, b, *rest, size_average=False)
                           - exact).abs().max())
    check(err <= TOL, f"ssim {list(a.shape)}: |kernel - plain in float64| = {err} > {TOL} "
                      f"(fp32 plain: {abs(plain - float(exact.mean()))} from float64, "
                      f"{abs(kernel - plain)} from the kernel; per image at most: kernel "
                      f"{img_err}, fp32 plain {img_err_plain})")
    check(torch.equal(ssim_plane_sums(a, b, *rest), ssim_plane_sums(a, b, *rest)),
          f"ssim {list(a.shape)}: two runs differ")
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
        print(f"[inference] WAE: ssim {list(a.shape)} x{count} |kernel - plain in float64| "
              f"{err:.3g}, per image {img_err:.3g}", flush=True)
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
             profile=True, checkpoints=True, snapshot_epoch0=False, note=""):
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
    ``checkpoints`` the run writes none; ``note`` follows the path's name in
    the printed line."""
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
    print(f"[{path}]{note} {n_epochs} epochs of {TRAINER_STEPS} steps at batch "
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


class DefaultCudnn:
    """Wraps a trainer's steps so that each train step runs with cuDNN's
    default algorithms: the flag is set off by hand for the step and back on
    after it (the ``Trainer`` runs with cuDNN's deterministic algorithms and
    has no option to turn them off). Only the comparison run of
    ``determinism_cost`` uses it."""

    def __init__(self, steps):
        from fmri_tpu_torch.train.steps_vgan import StepFns

        self.inner = steps
        self.steps = StepFns(self.train_step, steps.eval_step, steps.generate_step)

    def train_step(self, *args):
        import torch

        torch.backends.cudnn.deterministic = False
        try:
            return self.inner.train_step(*args)
        finally:
            torch.backends.cudnn.deterministic = True


def determinism_cost(path, cfg, built, data, run_dir, numbers) -> None:
    """The cost of the trainer's deterministic cuDNN per step: ``built``
    (a fresh builder result of ``path``) through the same ``Trainer.fit``
    as the timed run, with cuDNN's default algorithms in each train step.
    Prints the clean epoch's seconds per step of both (epoch 2; the timed
    run profiled epoch 1) and adds them to ``numbers``."""
    state, steps, kw = built
    _, _, plain, _ = fit_path(path, cfg, (state, DefaultCudnn(steps).steps, kw), data,
                              run_dir, TRAINER_EPOCHS, numbers["bare_s_per_step"],
                              record=False, profile=False, checkpoints=False,
                              note=" (cuDNN's default algorithms in each step)")
    det, dflt = numbers["s_per_step"][-1], plain["s_per_step"][-1]
    numbers["defaults_s_per_step"] = plain["s_per_step"]
    numbers["determinism_cost_s_per_step"] = det - dflt
    print(f"[determinism] {path}: s per step through the Trainer, clean epoch: "
          f"{det:.4f} with cuDNN's deterministic algorithms (the Trainer's), {dflt:.4f} "
          f"with cuDNN's defaults: {1e3 * (det - dflt):+.2f} ms "
          f"({100 * (det - dflt) / dflt:+.1f}%)", flush=True)


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


def trainer_phase(dev, cfg, preset, bare_seconds, then=None):
    """Phase 11: the training driver, both kernel flags on. (a)
    ``vgan_stage1`` through ``Trainer.fit``, then its exactness checks; (b)
    ``vgan_stage2`` from (a)'s checkpoint dir, then ``vgan_stage3`` from
    stage II's; (c) ``wae_stage1``; (d) the train and inference CLIs as
    users call them. Then, before the run dirs are deleted, ``then(dirs,
    work)`` with the checkpoint dirs of (a), (b) and (c) (the final states
    of ``vgan_stage3`` and ``wae_stage1``, which train without checkpoints,
    are written for it). Returns ({path: launches in one epoch}, {path:
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
    from fmri_tpu_torch.device import deterministic_cudnn
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
        determinism_cost("trainer_stage1", cfg, build(), images,
                         os.path.join(work, "stage1_defaults"), numbers["trainer_stage1"])
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

        # exactness with the Trainer's defaults (cuDNN's deterministic
        # algorithms, which it sets itself): epoch 0 through the Trainer (every
        # kernel call recorded) against a hand loop of the step over the same
        # batches and draws under the same algorithms, and the run resumed
        # after epoch 0 against the uninterrupted epoch 1
        check(not torch.backends.cudnn.deterministic,
              "the smoke itself left cudnn.deterministic set")
        run_d = os.path.join(work, "stage1_deterministic")
        final_d, _, _, snap_d = fit_path(
            "trainer_stage1", cfg, build(), images, run_d, 2, bare_seconds["stage1"],
            profile=False, snapshot_epoch0=True)
        hand, steps, kw = build()
        with deterministic_cudnn():
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
        check(not torch.backends.cudnn.deterministic,
              "the Trainer did not restore the caller's cudnn.deterministic")

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
            build_n = lambda: BUILDERS[f"vgan_stage{stage}"](  # noqa: E731
                cfg, **{key: prev}, steps_per_epoch=spe, seed=t.seed, device=dev)
            built = build_n()
            before = {k: v.clone() for k, v in built[0].nets.state_dict().items()}
            run_dir = os.path.join(work, path)
            state, launches[path], numbers[path], _ = fit_path(
                path, cfg, built, pairs, run_dir, TRAINER_EPOCHS,
                bare_seconds[f"stage{stage}"],
                checkpoints=stage == 2)
            determinism_cost(path, cfg, build_n(), pairs, run_dir + "_defaults",
                             numbers[path])
            sd = state.nets.state_dict()
            moved = [k for k, v in sd.items() if k.startswith(frozen[path])
                     and "running" not in k and "num_batches" not in k
                     and not torch.equal(v, before[k])]
            check(not moved, f"{path}: frozen tensors moved: {moved[:3]}")
            print(f"[{path}] frozen groups {frozen[path]} bitwise unchanged", flush=True)
            numbers[path].update(checkpoint_seconds(path, state, work))
            prev = os.path.join(run_dir, "checkpoints")
        stage3_state = state

        # (c) WAE stage I
        build_w = lambda: BUILDERS["wae_stage1"](cfg, steps_per_epoch=spe,  # noqa: E731
                                                 seed=t.seed, device=dev)
        state, launches["trainer_wae1"], numbers["trainer_wae1"], _ = fit_path(
            "trainer_wae1", cfg, build_w(), images, os.path.join(work, "wae1"),
            TRAINER_EPOCHS, bare_seconds["wae_stage1"], checkpoints=False)
        determinism_cost("trainer_wae1", cfg, build_w(), images,
                         os.path.join(work, "wae1_defaults"), numbers["trainer_wae1"])
        numbers["trainer_wae1"].update(checkpoint_seconds("trainer_wae1", state, work))
        wae1_state = state

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
        if then is not None:
            dirs = {"vgan_stage1": os.path.join(run_a, "checkpoints"),
                    "vgan_stage2": os.path.join(work, "trainer_stage2", "checkpoints"),
                    "vgan_stage3": os.path.join(work, "trainer_stage3", "checkpoints"),
                    "wae_stage1": os.path.join(work, "wae1", "checkpoints")}
            store.save_checkpoint(dirs["vgan_stage3"], TRAINER_EPOCHS - 1, stage3_state)
            store.save_checkpoint(dirs["wae_stage1"], TRAINER_EPOCHS - 1, wae1_state)
            then(dirs, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches, numbers


SERVE_MAX_BATCH = 64
SERVE_SIZES = (1, 5, 64, 130)
SERVE_TIMED_CALLS = 50
# in-process BatchingServer load: one-row requests from threads, each with
# one request in flight; the socket load: rows through ServeClient's pool
SERVE_REQUESTS, SERVE_THREADS, SOCKET_ROWS, SOCKET_POOL = 512, 32, 256, 8


def _spawn_server(args, cwd):
    """Start ``python -m fmri_tpu_torch.eval.serve`` with ``args``; returns
    (process, its stdout lines as a queue, filled by a reader thread)."""
    import queue
    import threading

    proc = subprocess.Popen([sys.executable, "-m", "fmri_tpu_torch.eval.serve", *args],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            cwd=cwd)
    lines = queue.Queue()

    def read():
        for line in proc.stdout:
            lines.put(line.rstrip("\n"))
        lines.put(None)

    threading.Thread(target=read, daemon=True).start()
    return proc, lines


def _wait_serving(name, lines, timeout=240.0):
    """The server's lines up to its ``serving ...`` line."""
    import queue

    seen, deadline = [], time.monotonic() + timeout
    while True:
        try:
            line = lines.get(timeout=max(0.0, deadline - time.monotonic()))
        except queue.Empty:
            fail(f"{name} did not start serving within {timeout} s: {seen}")
        if line is None:
            fail(f"{name} exited before serving: {seen}")
        seen.append(line)
        if line.startswith("serving "):
            return seen


def _socket_burst(path, clients, per_client, row):
    """``clients`` connections at once, each sending ``per_client`` one-row
    requests in turn over the raw NDJSON protocol; returns every reply."""
    import socket
    import threading

    replies, lock = [], threading.Lock()

    def client(k):
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as c:
            c.connect(path)
            r, w = c.makefile("rb"), c.makefile("wb")
            for i in range(per_client):
                w.write((json.dumps({"id": 100 * k + i, "fmri": row}) + "\n").encode())
                w.flush()
                resp = json.loads(r.readline())
                with lock:
                    replies.append(resp)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    return replies


def _percentiles(ms):
    import numpy as np

    return {f"p{q}": float(np.percentile(ms, q)) for q in (50, 95, 99)}


def serve_phase(dev, dirs, work, preset="res64", cli_args=()):
    """Phase 12: serving at ``preset`` from phase 11's checkpoint dirs
    (``dirs``: ``vgan_stage1``, ``vgan_stage2``, ``vgan_stage3``,
    ``wae_stage1``), the CLI's sockets in ``work``. (a) the CUDA graphs of a stage-III server, float and
    uint8 output, against the same server run eagerly, and timed beside it;
    (b) image serving of stage-I VAE/GAN and WAE; (c) ``reload``; (d) the
    in-process ``BatchingServer``; (e) the CLI as users start it, through
    the client, and a burst past ``--max-queue``. ``cli_args`` go to the
    CLI (none on the card). No train kernel may launch. Returns (launches,
    numbers)."""
    import os
    import shutil
    import signal
    import tempfile
    import threading

    import numpy as np
    import torch

    from fmri_tpu_torch.configs import get_config
    from fmri_tpu_torch.data.synthetic import synthetic_pairs
    from fmri_tpu_torch.data.transforms import denormalize, eval_preprocess
    from fmri_tpu_torch.eval.client import ServeClient, ServeError
    from fmri_tpu_torch.eval.serve import (
        BatchingServer, ServingModel, batch_buckets, deterministic_cudnn,
    )

    cfg = get_config(preset)
    mean, std = cfg.data.mean, cfg.data.std
    pairs = synthetic_pairs(SERVE_REQUESTS, cfg.data.image_size, cfg.model.num_voxels,
                            seed=1)
    fmri, images = pairs["fmri"], pairs["image"]
    graphs_per_model = 2 * len(batch_buckets(SERVE_MAX_BATCH)) if dev.type == "cuda" else 0
    numbers = {}
    set_launches(0)

    def load(path, family, stage, **kw):
        return ServingModel.from_checkpoint(dirs[path], family, stage, preset,
                                            max_batch=SERVE_MAX_BATCH, device=dev, **kw)

    def gap(a, b):
        return float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max())

    def eager(m):
        """``m`` running its programs eagerly, with the cuDNN algorithms its
        graphs would capture."""
        def call(kind, b):
            with deterministic_cudnn():
                return m._program(kind, b)

        m._call = call
        return m

    # (a) one graph per (bucket, reconstruct | generate), against the same
    # server with eager programs and timed beside it, and beside eager
    # programs with cuDNN's default algorithms: 50 warm calls per bucket,
    # each ending in the host pull
    stage3 = {}
    per_bucket = {}
    for output, bound in (("float", 1e-6), ("uint8", 1)):
        served = load("vgan_stage3", "vgan", 3, output=output)
        eager_served = eager(load("vgan_stage3", "vgan", 3, output=output))
        default = load("vgan_stage3", "vgan", 3, output=output)
        default._call = default._program
        t0 = time.perf_counter()
        served.warmup()
        warm_s = time.perf_counter() - t0
        check(served.graphs == graphs_per_model,
              f"[serve] {output}: {served.graphs} graphs, want {graphs_per_model}")
        worst = 0.0
        for b in served.buckets:
            x = fmri[:b]
            worst = max(worst, gap(served.reconstruct(x), eager_served.reconstruct(x)))
            worst = max(worst, gap(served.generate(b), eager_served.generate(b)))
            times = {}
            for name, m in (("graph", served), ("eager", eager_served),
                            ("eager_default", default)):
                m.reconstruct(x)
                t0 = time.perf_counter()
                for _ in range(SERVE_TIMED_CALLS):
                    m.reconstruct(x)
                times[name] = 1e3 * (time.perf_counter() - t0) / SERVE_TIMED_CALLS
            per_bucket.setdefault(output, {})[b] = times
        check(worst <= bound, f"[serve] {output}: graph vs eager {worst} > {bound}")
        check(served.graphs == graphs_per_model, f"[serve] {output}: captured again")
        # the same 64 rows twice: the graphs give the same bits, cuDNN's
        # default algorithms need not (printed, not checked)
        x = fmri[:SERVE_MAX_BATCH]
        repeat = {"graph": gap(served.reconstruct(x), served.reconstruct(x)),
                  "eager_default": gap(default.reconstruct(x), default.reconstruct(x))}
        check(repeat["graph"] == 0, f"[serve] {output}: a graph replay changed its bits")
        numbers[f"repeat_gap_{output}"] = repeat
        for size in SERVE_SIZES:
            x = fmri[:size]
            out = served.reconstruct(x)
            check(out.shape == (size, cfg.data.image_size, cfg.data.image_size, 3)
                  and out.dtype.name == ("uint8" if output == "uint8" else "float32"),
                  f"[serve] request of {size}: {out.shape} {out.dtype}")
            alone = max(gap(out[i], served.reconstruct(x[i])) for i in range(size))
            check(alone <= (1e-5 if output == "float" else 1),
                  f"[serve] {output}: a row alone vs inside {size} rows: {alone}")
        stage3[output] = served
        print(f"[serve] vgan stage 3, {output}: warmup {served.graphs} graphs in "
              f"{warm_s:.2f} s; graph vs eager per bucket, reconstruct and generate: "
              f"largest gap {worst:.3g} (bound {bound}); the same 64 rows twice: graph "
              f"{repeat['graph']:.3g}, eager with cuDNN's defaults "
              f"{repeat['eager_default']:.3g}; requests of {list(SERVE_SIZES)} "
              f"rows alone vs batched ok; ms per call (graph, eager; eager with "
              f"cuDNN's default algorithms): "
              + ", ".join(f"{b}: {t['graph']:.3f} / {t['eager']:.3f}; "
                          f"{t['eager_default']:.3f}"
                          for b, t in per_bucket[output].items()), flush=True)
        numbers[f"warmup_s_{output}"] = warm_s
    numbers["ms_per_call"] = per_bucket

    fresh = load("vgan_stage3", "vgan", 3)
    out = fresh.generate(4)
    g = torch.Generator(device=dev).manual_seed(0x5EED)
    z = torch.randn((4, cfg.model.latent_dim), generator=g, device=dev)
    with deterministic_cudnn():
        want = denormalize(fresh.model.generate(z), mean, std).clamp(0, 1).cpu().numpy()
    err = gap(out, want)
    check(err <= 1e-6, f"[serve] generate(4) vs the decoder on the same draws: {err}")

    # (b) image -> image: stage-I VAE/GAN and WAE
    for path, family in (("vgan_stage1", "vgan"), ("wae_stage1", "wae")):
        m = load(path, family, 1)
        m.warmup()
        for n in (1, 64):
            x = images[:n]
            xt = torch.from_numpy(x).to(dev)
            want = denormalize(m.model.reconstruct(eval_preprocess(xt, mean, std)),
                               mean, std).clamp(0, 1).cpu().numpy()
            err = gap(m.reconstruct(x), want)
            check(err <= 1e-5, f"[serve] {path}: {n} images vs eager: {err}")
        print(f"[serve] {path} ({family} stage 1, image -> image): requests of 1 and 64 "
              f"images equal the eager reconstruct, preprocess and clip (1e-5)", flush=True)

    # (c) reload: a stage-II server takes stage III's weights in place
    x = fmri[:130]
    m = load("vgan_stage2", "vgan", 2)
    m.warmup()
    before = m.reconstruct(x)
    t0 = time.perf_counter()
    info = m.reload(dirs["vgan_stage3"])
    reload_s = time.perf_counter() - t0
    after = m.reconstruct(x)
    check(m.graphs == graphs_per_model, f"[serve] reload re-captured: {m.graphs} graphs")
    check(np.array_equal(after, stage3["float"].reconstruct(x)),
          "[serve] after reload the outputs differ from a fresh stage-III server")
    check(gap(after, before) > 0, "[serve] reload did not move the outputs")
    try:
        m.reload(dirs["vgan_stage1"])
        fail("[serve] reload of a stage-I dir into a stage-II server was accepted")
    except ValueError as e:
        refused = str(e)
    check(np.array_equal(m.reconstruct(x), after), "[serve] a refused reload moved outputs")
    numbers["reload_s"] = reload_s
    print(f"[serve] reload {info} in {reload_s:.3f} s: outputs equal a fresh stage-III "
          f"server bitwise, {m.graphs} graphs (none captured again); stage-I dir refused: "
          f"{refused[:100]}...", flush=True)

    # (d) the in-process BatchingServer: one-row requests, 32 threads
    u8 = stage3["uint8"]
    want = u8.reconstruct(fmri)
    batcher = BatchingServer(u8, max_wait_ms=5.0)
    got = [None] * SERVE_REQUESTS

    def client(k):
        for i in range(k, SERVE_REQUESTS, SERVE_THREADS):
            got[i] = batcher.submit(fmri[i]).result(timeout=60)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(SERVE_THREADS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    wall = time.perf_counter() - t0
    st = batcher.stats()
    batcher.close()
    check(all(r is not None for r in got), "[serve] BatchingServer: a request unanswered")
    err = gap(np.stack(got), want)
    check(err <= 1 and st["requests"] == SERVE_REQUESTS and st["shed"] == 0,
          f"[serve] BatchingServer: {err} LSB from reconstruct; stats {st}")
    numbers["in_process"] = {"requests_per_s": SERVE_REQUESTS / wall,
                             "batches": st["batches"], "occupancy": st["occupancy"],
                             **{k: st["latency_ms"][k] for k in ("p50", "p95", "p99")}}
    print(f"[serve] BatchingServer, {SERVE_REQUESTS} one-row requests from {SERVE_THREADS} "
          f"threads, max_wait_ms 5: {SERVE_REQUESTS / wall:.1f} requests/s, "
          f"{st['batches']} batches, occupancy {st['occupancy']:.3f}, latency ms "
          f"{json.dumps(st['latency_ms'])}; within {err:.0f} LSB of reconstruct", flush=True)

    # (e) the CLI as users start it, two servers at once: the second with a
    # queue of 6 for the burst
    root = os.path.dirname(os.path.abspath(__file__))
    sock_dir = (work if len(os.path.join(work, "s0.sock")) <= 100  # a socket path's limit
                else tempfile.mkdtemp(prefix="fmri-serve-"))
    paths = [os.path.join(sock_dir, f"s{i}.sock") for i in (0, 1)]
    base = ["--family", "vgan", "--stage", "3", "--preset", preset,
            "--ckpt", dirs["vgan_stage3"], *cli_args]
    procs = []
    try:
        t0 = time.perf_counter()
        for path, extra in zip(paths, ([], ["--max-queue", "6"])):
            procs.append(_spawn_server(base + ["--unix-socket", path] + extra, root))
        for i, (_, lines) in enumerate(procs):
            seen = _wait_serving(f"serve CLI {i}", lines)
            print(f"[serve] CLI {i}: " + " | ".join(seen), flush=True)
        start_s = time.perf_counter() - t0
        with ServeClient(unix_path=paths[0], pool=SOCKET_POOL) as c:
            check(c.ping(), "[serve] CLI ping")
            lat, rpc = [], c._rpc

            def timed(i, obj):
                t = time.perf_counter()
                out = rpc(i, obj)
                lat.append(1e3 * (time.perf_counter() - t))
                return out

            c._rpc = timed
            t0 = time.perf_counter()
            imgs = c.reconstruct(fmri[:SOCKET_ROWS])
            wall = time.perf_counter() - t0
            c._rpc = rpc
            err = gap(imgs, np.stack(got[:SOCKET_ROWS]))
            check(imgs.shape == want[:SOCKET_ROWS].shape and err <= 1,
                  f"[serve] CLI images {imgs.shape}, {err} LSB from in-process")
            check(c.generate(4).shape == (4, *want.shape[1:]), "[serve] CLI generate(4)")
            try:
                c.generate(8 * SERVE_MAX_BATCH + 1)
                fail("[serve] CLI accepted generate past its cap")
            except ServeError as e:
                check("cap" in str(e), f"[serve] CLI generate cap: {e}")
            info = c.reload(dirs["vgan_stage2"])
            check(info["reloaded"] == dirs["vgan_stage2"], f"[serve] CLI reload {info}")
            cli_stats = c.stats()
        numbers["socket"] = {"requests_per_s": SOCKET_ROWS / wall, **_percentiles(lat),
                             "server_latency_ms": cli_stats["latency_ms"],
                             "start_s": start_s}
        print(f"[serve] CLI through ServeClient (pool {SOCKET_POOL}): {SOCKET_ROWS} rows "
              f"in {wall:.3f} s, {SOCKET_ROWS / wall:.1f} requests/s, round trip ms "
              f"{json.dumps(_percentiles(lat))}; within {err:.0f} LSB of in-process; "
              f"generate cap refused; reload {info}; stats {json.dumps(cli_stats)}",
              flush=True)

        replies = _socket_burst(paths[1], 8, 4, fmri[0].tolist())
        shape = [cfg.data.image_size, cfg.data.image_size, 3]
        shed = sum(1 for r in replies if r.get("shed") is True)
        ok = sum(1 for r in replies if r.get("shape") == shape and "data" in r)
        with ServeClient(unix_path=paths[1], pool=1) as c:
            burst = c.stats()
        check(len(replies) == 32 and ok + shed == 32,
              f"[serve] burst: {len(replies)} replies, {ok} images, {shed} shed")
        check(burst["shed"] == shed and burst["queue_depth"] <= burst["max_queue"] == 6,
              f"[serve] burst stats {burst} vs {shed} shed")
        numbers["burst"] = {"images": ok, "shed": shed}
        print(f"[serve] burst of 8 clients x 4 requests at --max-queue 6: {ok} images, "
              f"{shed} shed (timing-dependent, not checked)", flush=True)
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.send_signal(signal.SIGINT)
        codes = []
        for proc, _ in procs:
            try:
                codes.append(proc.wait(timeout=60))
            except subprocess.TimeoutExpired:
                proc.kill()
                codes.append(proc.wait())
        if sock_dir != work:
            shutil.rmtree(sock_dir, ignore_errors=True)
    check(codes == [0, 0], f"[serve] CLI exit codes after SIGINT: {codes}")

    launches = set_launches(0)
    check(not any(launches.values()), f"[serve] train or SSIM kernels launched: {launches}")
    print(f"[serve] kernel launches over the phase: {launches}", flush=True)
    return launches, numbers


# phase 13, the host data path: a memory-mapped packed pair dir at res64 width
# (3,620 fp32 voxels and a 64x64x3 uint8 image per pair, 535 MB at 20,000
# pairs), epochs of 312 batches of 64; the train CLI on a 1,280-pair packed
# dir (18 steps); raw datasets: 640 COCO-style stimuli above the 375 px crop,
# 4 x 100 CSI* ROI records over them, 400 MNIST69 rows
DATA_PAIRS, DATA_BATCH = 20_000, 64
DATA_CLI_PAIRS = 1_280
RAW_IMAGES, RAW_RECORDS, MNIST_ROWS = 640, 100, 400


def write_packed(path, n, voxels, size, seed, chunk=2048):
    """A packed pair dir in the format ``fmri-tpu-prepare`` writes
    (``meta.json``, ``fmri.npy`` float32, ``image.npy`` uint8), filled from
    ``seed`` chunk by chunk through memory maps."""
    import os

    import numpy as np

    os.makedirs(path)
    rng = np.random.default_rng(seed)
    fmt = np.lib.format
    image = fmt.open_memmap(os.path.join(path, "image.npy"), mode="w+", dtype=np.uint8,
                            shape=(n, size, size, 3))
    fmri = fmt.open_memmap(os.path.join(path, "fmri.npy"), mode="w+", dtype=np.float32,
                           shape=(n, voxels))
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        image[lo:hi] = rng.integers(0, 256, (hi - lo, size, size, 3), dtype=np.uint8)
        fmri[lo:hi] = rng.standard_normal((hi - lo, voxels), dtype=np.float32)
    image.flush()
    fmri.flush()
    del image, fmri
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"keys": ["fmri", "image"], "quantized": ["image"], "num_examples": n}, f)


def drop_page_cache(path) -> None:
    """Write back and evict a packed dir's array files from the page cache
    (``fsync``, then ``POSIX_FADV_DONTNEED``), so the next mapping reads
    from the disk. Pages still mapped by this process stay: close the
    memmaps first."""
    import os

    for name in os.listdir(path):
        if name.endswith(".npy"):
            fd = os.open(os.path.join(path, name), os.O_RDONLY)
            try:
                os.fsync(fd)
                os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
            finally:
                os.close(fd)


class NumpyGather:
    """The port's loader with its library off inside the block, as on a host
    without a compiler: every gather takes numpy's fancy indexing."""

    def __enter__(self):
        from fmri_tpu_torch import native

        self.saved = native._lib, native._lib_err
        native._lib, native._lib_err = None, "off for the numpy comparison"

    def __exit__(self, *exc):
        from fmri_tpu_torch import native

        native._lib, native._lib_err = self.saved


class Counted:
    """Stands in for ``module.name``, counting its calls."""

    def __init__(self, module, name):
        self.module, self.name, self.orig, self.calls = module, name, getattr(module, name), 0
        setattr(module, name, self)

    def __call__(self, *args, **kw):
        self.calls += 1
        return self.orig(*args, **kw)

    def restore(self):
        setattr(self.module, self.name, self.orig)


def epoch_seconds(packed, numpy=False, cold=False, in_ram=False) -> float:
    """Host seconds of one shuffled epoch of ``Batches`` (batch 64) over the
    packed dir ``packed``, mapped afresh: through the native gather, or with
    ``numpy`` numpy's; with ``cold`` the dir's pages are evicted first; with
    ``in_ram`` the arrays are copied into memory first (not timed)."""
    import contextlib
    import gc

    import numpy as np

    from fmri_tpu_torch.data.packed import open_packed
    from fmri_tpu_torch.data.pipeline import Batches

    if cold:
        gc.collect()  # no mapping of the files may be left to pin their pages
        drop_page_cache(packed)
    data = open_packed(packed)
    if in_ram:
        data = {k: np.array(v) for k, v in data.items()}
    batches = Batches(data, DATA_BATCH, shuffle=True, seed=0)
    batches.epoch = 1
    with NumpyGather() if numpy else contextlib.nullcontext():
        t0 = time.perf_counter()
        for _ in batches:
            pass
        return time.perf_counter() - t0


def cli_run(main, argv, want_ssim, name, tag="data"):
    """``main(argv)`` of a port CLI (the train CLI, or the inference CLI),
    with the launch counts set to 0 just before and read just after: BN and
    dW 0, SSIM exactly ``want_ssim``, each SSIM call held against its plain
    version. The train CLI's ``Trainer`` is timed per epoch (``EpochClock``).
    Returns (launches, seconds per step of its epochs, wall seconds)."""
    from fmri_tpu_torch.ops import ssim as ssim_ops
    from fmri_tpu_torch.train import trainer as trainer_mod

    clocks = []
    real = trainer_mod.Trainer

    class Clocked(real):
        def __init__(self, cfg, steps, *a, **kw):
            clocks.append(EpochClock(steps))
            super().__init__(cfg, clocks[-1].steps, *a, **kw)

    calls = {}
    trainer_mod.Trainer = Clocked
    recorder = Recorder(ssim_ops, "ssim_plane_sums", calls)
    set_launches(0)
    t0 = time.perf_counter()
    try:
        check(main(argv) == 0, f"{name}: the CLI failed")
    finally:
        wall = time.perf_counter() - t0
        launches = set_launches(0)
        recorder.restore()
        trainer_mod.Trainer = real
    check(launches == {"bn_bwd_reduce": 0, "bn_bwd_apply": 0, "tap_matmul": 0,
                       "ssim": want_ssim},
          f"{name}: launches {launches}, want {want_ssim} SSIM launches only")
    from fmri_tpu_torch.ops.ssim import ssim_plain

    for (a, b, *rest), _ in calls.values():
        err, img_err, img_err_plain = hold_ssim_call(a, b, rest)
        plain_err = abs(float(ssim_plain(a, b, *rest))
                        - float(ssim_plain(a.double(), b.double(), *rest)))
        print(f"[{tag}] {name}: ssim {list(a.shape)} from the plain version in float64: "
              f"mean, kernel {err:.3g}, fp32 plain {plain_err:.3g}; per image at most, "
              f"kernel {img_err:.3g}, fp32 plain {img_err_plain:.3g}", flush=True)
    per_step = [s / n for c in clocks for s, n in c.loops]
    return launches, per_step, wall


def draw_stimulus(rng, size_range):
    """An RGB uint8 stimulus, its sides drawn from ``size_range``: two
    colour gradients and a flat rectangle (smooth, as photographs are, with
    flat regions)."""
    import numpy as np

    h, w = (int(v) for v in rng.integers(*size_range, 2))
    y, x = np.mgrid[0:h, 0:w]
    c0, c1, rc = rng.uniform(0, 255, (3, 3))
    img = (y[..., None] / h * c0 + x[..., None] / w * c1).astype(np.float32)
    y0, x0 = int(rng.integers(0, h // 2)), int(rng.integers(0, w // 2))
    img[y0:y0 + h // 3, x0:x0 + w // 3] = rc
    return img.clip(0, 255).astype(np.uint8)


def write_raw(root, size_range, voxels, seed):
    """Raw data as users keep it: ``coco/`` (``RAW_IMAGES`` stimuli, JPEG
    and PNG, RGB with every 7th greyscale and every 11th RGBA, sides drawn
    from ``size_range``), ``bold/CSI1..CSI4`` (``<sub>_roi_pad.npz`` of
    ``voxels`` and ``<sub>_stimuli_paths.pickle`` naming those stimuli) and
    ``mnist69.mat`` (``MNIST_ROWS`` rows of 784 pixels and ``voxels``)."""
    import os
    import pickle

    import numpy as np
    import scipy.io
    from PIL import Image

    rng = np.random.default_rng(seed)
    coco = os.path.join(root, "coco")
    os.makedirs(coco)
    paths = []
    for i in range(RAW_IMAGES):
        img = draw_stimulus(rng, size_range)
        h, w = img.shape[:2]
        if i % 7 == 3:
            mode, ext = "L", "png"
            img = img[..., 0]
        elif i % 11 == 5:
            mode, ext = "RGBA", "png"
            img = np.concatenate([img, np.full((h, w, 1), 200, np.uint8)], axis=2)
        else:
            mode, ext = "RGB", ("jpg" if i % 2 else "png")
        path = os.path.join(coco, f"{i:012d}.{ext}")
        Image.fromarray(img).save(path, **({"compress_level": 1} if ext == "png" else {}))
        check(Image.open(path).mode == mode, f"stimulus {path} is not {mode}")
        paths.append(path)
    for s, sub in enumerate(("CSI1", "CSI2", "CSI3", "CSI4")):
        d = os.path.join(root, "bold", sub)
        os.makedirs(d)
        np.savez(os.path.join(d, f"{sub}_roi_pad.npz"),
                 roi=rng.normal(0.5 * s, 1.0 + s, (RAW_RECORDS, voxels)))
        with open(os.path.join(d, f"{sub}_stimuli_paths.pickle"), "wb") as f:
            pickle.dump([paths[(7 * i + s) % RAW_IMAGES] for i in range(RAW_RECORDS)], f)
    rows = np.concatenate([rng.integers(0, 256, (MNIST_ROWS, 784)).astype(np.float64),
                           rng.normal(size=(MNIST_ROWS, voxels))], axis=1)
    scipy.io.savemat(os.path.join(root, "mnist69.mat"), {"D": rows})


def data_phase(preset="res64", pairs=DATA_PAIRS, cli_pairs=DATA_CLI_PAIRS,
               size_range=(400, 481), cli_args=()):
    """Phase 13: the host data path. (a) the port's native loader builds
    with g++, and ``gather``, ``gather_dequant`` and ``prefetch`` on a
    memory-mapped packed pair dir of ``pairs`` pairs at ``preset`` width
    equal numpy's bitwise; (b) shuffled ``Batches`` epochs (batch 64)
    through it against numpy's gather, bitwise, each timed warm and cold;
    (c) the train CLI, stage I, one epoch on a ``cli_pairs`` packed dir
    (its ``Batches`` on the native gather, 2 SSIM launches held against
    plain); (d) raw data: COCO stimuli for stage I with ``--cache-dir``,
    again from the cache alone, ``--dataset bold`` stage II from that
    run, the inference CLI on the BOLD split (4 SSIM launches),
    ``--dataset mnist69`` stage II. Returns ({path: launches}, {numbers})."""
    import contextlib
    import os
    import shutil

    import numpy as np

    from fmri_tpu_torch import native
    from fmri_tpu_torch.configs import get_config
    from fmri_tpu_torch.data import datasets
    from fmri_tpu_torch.data.packed import open_packed
    from fmri_tpu_torch.data.pipeline import Batches
    from fmri_tpu_torch.eval import inference
    from fmri_tpu_torch.native import build as native_build
    from fmri_tpu_torch.train import run

    cfg = get_config(preset)
    voxels, size = cfg.model.num_voxels, cfg.model.image_size
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_smoke_runs")
    shutil.rmtree(work, ignore_errors=True)
    numbers, launches = {}, {}
    try:
        # (a) build (again: the trainer phase's Batches loaded it) and parity
        t0 = time.perf_counter()
        try:
            native_build.build_library(force=True)
        except (OSError, RuntimeError) as e:
            fail(f"the native loader did not build: {e}")
        numbers["native_build_s"] = time.perf_counter() - t0
        if not native.available():
            fail(f"the native loader did not load: {native.why_unavailable()}")
        threads = native._threads_default()
        packed = os.path.join(work, "packed")
        t0 = time.perf_counter()
        write_packed(packed, pairs, voxels, size, seed=0)
        mib = sum(os.path.getsize(os.path.join(packed, f))
                  for f in os.listdir(packed)) / 2**20
        print(f"[data] native loader built with g++ in {numbers['native_build_s']:.2f} s "
              f"({os.path.relpath(native_build.library_path())}), {threads} threads; "
              f"packed dir of {pairs} pairs ({voxels} fp32 voxels, {size}x{size}x3 uint8), "
              f"{mib:.1f} MiB, written in {time.perf_counter() - t0:.1f} s", flush=True)
        data = open_packed(packed)
        rng = np.random.default_rng(1)
        idx = rng.permutation(pairs)[:4096]
        for key, arr in data.items():
            check(isinstance(arr, np.memmap), f"{key} is not memory-mapped")
            check(native.prefetch(arr, idx), f"prefetch of {key} was not issued natively")
            got = native.gather(arr, idx)
            check(got.dtype == arr.dtype and got.tobytes() == arr[idx].tobytes(),
                  f"native gather of {key} differs from numpy's")
        u8 = data["image"]
        check(native.gather_dequant(u8, idx).tobytes()
              == (u8[idx].astype(np.float32) * np.float32(1.0 / 255.0)).tobytes(),
              "native gather_dequant differs from numpy's")
        print(f"[data] gather (fmri, image), gather_dequant and prefetch of {len(idx)} "
              f"shuffled rows: bitwise numpy's", flush=True)

        # (b) epochs of Batches, native against numpy's gather
        batches = Batches(data, DATA_BATCH, shuffle=True, seed=0)
        n_batches = len(batches)
        order = np.random.default_rng((0, 0)).permutation(pairs)
        gathers = Counted(native, "gather")
        try:
            for b, batch in enumerate(batches):
                rows = order[b * DATA_BATCH:(b + 1) * DATA_BATCH]
                for key, arr in data.items():
                    check(batch[key].tobytes() == arr[rows].tobytes(),
                          f"Batches {key} batch {b} differs from numpy's gather")
        finally:
            gathers.restore()
        check(gathers.calls == 2 * n_batches,
              f"Batches made {gathers.calls} native gathers, want {2 * n_batches}")
        del data, batches, batch, arr, u8, got
        warm = {"numpy": [], "native": []}
        for side in ("numpy", "native", "native", "numpy"):
            warm[side].append(epoch_seconds(packed, numpy=side == "numpy"))
        cold = {side: epoch_seconds(packed, numpy=side == "numpy", cold=True)
                for side in ("native", "numpy")}
        # what the native time is made of: one thread (no fork-join), and the
        # arrays copied into RAM (no page faults through the mapping)
        os.environ["FMRI_TPU_NATIVE_THREADS"] = "1"
        try:
            one_thread = epoch_seconds(packed)
        finally:
            del os.environ["FMRI_TPU_NATIVE_THREADS"]
        in_ram = {side: epoch_seconds(packed, numpy=side == "numpy", in_ram=True)
                  for side in ("native", "numpy", "native", "numpy")}
        numbers.update(threads=threads, epoch_batches=n_batches, packed_mib=mib,
                       warm_epoch_s=warm, cold_epoch_s=cold,
                       native_one_thread_epoch_s=one_thread, in_ram_epoch_s=in_ram)
        print(f"[data] Batches over the mapped dir, {n_batches} shuffled batches of "
              f"{DATA_BATCH}: bitwise numpy's gather; seconds per epoch (host gather "
              f"alone), warm: native {warm['native']}, numpy {warm['numpy']}; cold "
              f"(fsync + POSIX_FADV_DONTNEED, mapped again): native {cold['native']:.3f}, "
              f"numpy {cold['numpy']:.3f}; {threads} threads; native on one thread "
              f"{one_thread:.3f}; arrays in RAM: native {in_ram['native']:.3f}, numpy "
              f"{in_ram['numpy']:.3f} (the second of two runs each)", flush=True)

        # (c) the train CLI on a packed dir, its Batches on the native gather
        cli_dir = os.path.join(work, "packed_cli")
        write_packed(cli_dir, cli_pairs, voxels, size, seed=2)
        gathers = Counted(native, "gather")
        try:
            launches["data"], per_step, wall = cli_run(run.main, [
                "--family", "vgan", "--stage", "1", "--preset", preset, "--input", cli_dir,
                "--epochs", "1", "-o", os.path.join(work, "cli"), *cli_args], 2,
                "train CLI on a packed dir")
        finally:
            gathers.restore()
        check(gathers.calls > 0, "the train CLI's Batches did not take the native gather")
        # what the native loader moves end to end: the same run with numpy's
        # gather, then with the native one again
        again = {}
        for side in ("numpy", "native"):
            with NumpyGather() if side == "numpy" else contextlib.nullcontext():
                _, again[f"{side}_s_per_step"], again[f"{side}_wall_s"] = cli_run(
                    run.main, ["--family", "vgan", "--stage", "1", "--preset", preset,
                               "--input", cli_dir, "--epochs", "1", "-o",
                               os.path.join(work, f"cli_{side}"), *cli_args], 2,
                    f"train CLI on a packed dir again ({side} gather)")
        numbers["train_cli_packed"] = {"s_per_step": per_step, "wall_s": wall,
                                       "native_gathers": gathers.calls, "then": again}
        print(f"[data] python -m fmri_tpu_torch.train.run --preset {preset} --input "
              f"<{cli_pairs}-pair packed dir>, 1 epoch: {wall:.2f} s wall, s per step "
              f"{['%.4f' % s for s in per_step]}, {gathers.calls} native gathers, launches "
              f"{launches['data']}; then with numpy's gather {again['numpy_wall_s']:.2f} "
              f"s wall, s per step {['%.4f' % s for s in again['numpy_s_per_step']]}, "
              f"and native again {again['native_wall_s']:.2f} s wall, s per step "
              f"{['%.4f' % s for s in again['native_s_per_step']]}", flush=True)

        # (d) raw data through the train and inference CLIs
        raw = os.path.join(work, "raw")
        t0 = time.perf_counter()
        write_raw(raw, size_range, voxels, seed=3)
        import PIL
        import scipy

        print(f"[data] raw data written in {time.perf_counter() - t0:.1f} s: {RAW_IMAGES} "
              f"stimuli, 4 x {RAW_RECORDS} CSI* records, {MNIST_ROWS} MNIST69 rows "
              f"(Pillow {PIL.__version__}, scipy {scipy.__version__})", flush=True)
        cache = os.path.join(work, "cache")
        raw_runs = {}

        def train(name, *argv):
            out = os.path.join(work, name)
            _, per_step, wall = cli_run(run.main, [*argv, "--preset", preset, "--epochs",
                                                   "1", "-o", out, *cli_args], 2, name)
            raw_runs[name] = {"s_per_step": per_step, "wall_s": wall}
            run_dir, = (os.path.join(out, d, r) for d in os.listdir(out)
                        for r in os.listdir(os.path.join(out, d)))
            return os.path.join(run_dir, "checkpoints")

        coco = ["--family", "vgan", "--stage", "1", "--dataset", "coco", "-i",
                os.path.join(raw, "coco"), "--cache-dir", cache]
        stage1 = train("coco", *coco)
        check(os.listdir(cache) == ["coco_train.npz"], f"coco cache: {os.listdir(cache)}")

        def no_decoding(*a, **k):
            raise AssertionError("a stimulus was decoded though the cache holds it")

        real_load = datasets.load_stimulus
        datasets.load_stimulus = no_decoding
        try:
            train("coco_cached", *coco)
        finally:
            datasets.load_stimulus = real_load
        bold = ["--dataset", "bold", "-i", os.path.join(raw, "bold"), "--cache-dir", cache]
        stage2 = train("bold", "--family", "vgan", "--stage", "2", *bold,
                       "--prev-ckpt", stage1)
        launches["data_inference"], _, wall = cli_run(inference.main, [
            "--family", "vgan", "--stage", "2", *bold, "--ckpt", stage2, "--preset", preset,
            "-o", os.path.join(work, "inference"), *cli_args], SSIM_LAUNCHES_PER_RUN,
            "inference CLI on raw BOLD")
        with open(os.path.join(work, "inference", "summary.json")) as f:
            summary = json.load(f)
        n_valid = -(-4 * RAW_RECORDS // 5)  # split_dataset's ceil(0.2 * n)
        check(summary["num_images"] == n_valid and 0.0 < summary["ssim"] <= 1.0,
              f"inference on raw BOLD: {summary}")
        train("mnist69", "--family", "vgan", "--stage", "2", "--dataset", "mnist69", "-i",
              os.path.join(raw, "mnist69.mat"), "--prev-ckpt", stage1)
        numbers["raw"] = raw_runs
        numbers["inference_raw_bold_wall_s"] = wall
        print(f"[data] raw CLIs (one epoch each; s per step, wall s): "
              + "; ".join(f"{k} {['%.4f' % s for s in v['s_per_step']]}, {v['wall_s']:.2f}"
                          for k, v in raw_runs.items())
              + f"; inference on the BOLD split ({summary['num_images']} pairs) "
              f"{wall:.2f} s, launches {launches['data_inference']}, ssim "
              f"{summary['ssim']:.4f}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches, numbers


# phase 14, the offline ETL: a BOLD5000-layout tree (4 subjects x 2 runs of
# 50 trials over 320 stimuli of 400-480 px) through the prepare CLI's
# subcommands as subprocesses, then the train CLI on a pack-stream dir and the
# inference CLI on the pack output
PREP_SUBJECTS, PREP_TRIALS, PREP_STIMULI = 4, 100, 320


def write_bold5000(root, size_range, seed):
    """A BOLD5000 release as users download it: ``stimuli/COCO`` (JPEG
    stimuli named as COCO's), ``ds001499/sub-CSI<s>/ses-01/func`` with two
    runs per subject (a ``*_bold.nii.gz`` and its ``events.tsv``; run 2 has
    no ``ImgType`` column; run 1 has a row with an empty ``ImgName`` and one
    with an empty ``ImgType``; a file outside the run pattern) and
    ``stim_lists/CSI0<s>_stim_lists.txt`` (every third entry ``rep_``).
    Returns {subject: the stimulus names its runs show}."""
    import csv
    import os

    import numpy as np
    from PIL import Image

    from fmri_tpu_torch.data import nifti

    rng = np.random.default_rng(seed)
    names = [f"COCO_train2014_{i:012d}.jpg" for i in range(PREP_STIMULI)]
    coco = os.path.join(root, "stimuli", "COCO")
    os.makedirs(coco)
    for name in names:
        Image.fromarray(draw_stimulus(rng, size_range)).save(os.path.join(coco, name))
    shown, lists = {}, os.path.join(root, "stim_lists")
    os.makedirs(lists)
    half = PREP_TRIALS // 2
    for s in range(1, PREP_SUBJECTS + 1):
        sub = f"CSI{s}"
        shown[sub] = [names[(7 * i + s) % PREP_STIMULI] for i in range(PREP_TRIALS)]
        func = os.path.join(root, "ds001499", f"sub-{sub}", "ses-01", "func")
        os.makedirs(func)
        for run, rows in ((1, shown[sub][:half]), (2, shown[sub][half:])):
            stem = f"sub-{sub}_ses-01_task-5000scenes_run-{run:02d}"
            nifti.save(os.path.join(func, f"{stem}_bold.nii.gz"),
                       np.zeros((2, 2, 2, 4), np.int16))
            with open(os.path.join(func, f"{stem}_events.tsv"), "w", newline="") as f:
                w = csv.writer(f, delimiter="\t")
                if run == 1:
                    w.writerow(["onset", "duration", "ImgName", "ImgType"])
                    w.writerows([10.0 * i, 1.0, n, "rep_coco" if i % 3 == 1 else "coco"]
                                for i, n in enumerate(rows))
                    w.writerow([10.0 * half, 1.0, "", "coco"])
                    w.writerow([10.0 * half + 10, 1.0, "beach_1.jpg", ""])
                else:
                    w.writerow(["onset", "duration", "ImgName"])
                    w.writerows([10.0 * i, 1.0, n] for i, n in enumerate(rows))
        nifti.save(os.path.join(func, f"sub-{sub}_ses-01_task-5000scenes_acq-x_bold.nii.gz"),
                   np.zeros((2, 2, 2, 4), np.int16))
        with open(os.path.join(lists, f"CSI0{s}_stim_lists.txt"), "w") as f:
            f.write("\n".join(("rep_" if i % 3 == 2 else "") + n
                              for i, n in enumerate(shown[sub])) + "\n")
    return shown


def prepare_phase(preset="res64", size_range=(400, 481), cli_args=()):
    """Phase 14: the offline ETL. On a BOLD5000-layout tree
    (``write_bold5000``), ``python -m fmri_tpu_torch.data.prepare`` in
    subprocesses: ``parse-sessions``, ``stimuli-paths``, ``split-stimuli``,
    then ``pack`` (the ROI arrays written as ``extract-roi`` would, which
    needs h5py), ``pack-stream`` over an ``.npz`` cache, a record pickle and
    the stimulus dir; each summary line checked, the two pair dirs equal
    byte for byte, the streamed images the in-process decode's. Then the
    train CLI one epoch on the streamed stimulus dir (2 SSIM launches) and
    the inference CLI on the ``pack`` output through ``--cache-dir`` with
    the decoder raising (4 SSIM launches). Returns ({path: launches},
    {numbers})."""
    import importlib.util
    import math
    import os
    import shutil

    import numpy as np
    import torch

    from fmri_tpu_torch.checkpoints.convert import from_jax_groups, random_groups
    from fmri_tpu_torch.configs import get_config
    from fmri_tpu_torch.data import datasets
    from fmri_tpu_torch.data.packed import _quantize_u8
    from fmri_tpu_torch.data.transforms import load_stimulus
    from fmri_tpu_torch.eval import inference
    from fmri_tpu_torch.eval.steps import VaeGanCognitive
    from fmri_tpu_torch.train import run

    cfg = get_config(preset)
    size, voxels = cfg.data.image_size, cfg.model.num_voxels
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_smoke_runs", "prepare")
    shutil.rmtree(work, ignore_errors=True)
    launches, numbers = {}, {}
    try:
        t0 = time.perf_counter()
        shown = write_bold5000(work, size_range, seed=4)
        print(f"[prepare] BOLD5000 tree written in {time.perf_counter() - t0:.1f} s: "
              f"{PREP_STIMULI} stimuli, {PREP_SUBJECTS} subjects x 2 runs of "
              f"{PREP_TRIALS // 2} trials", flush=True)
        out = os.path.join(work, "out")
        roi = os.path.join(out, "bold_roi")
        packed = os.path.join(out, "packed")
        coco = os.path.join(work, "stimuli", "COCO")

        set_launches(0)

        def prepare(name, *flags):
            """``name``'s subcommand (its first word) in a subprocess, timed;
            returns its summary line."""
            t = time.perf_counter()
            r = subprocess.run([sys.executable, "-m", "fmri_tpu_torch.data.prepare",
                                name.split()[0], *flags],
                               capture_output=True, text=True, timeout=300,
                               cwd=os.path.dirname(os.path.abspath(__file__)))
            numbers[name] = time.perf_counter() - t
            check(r.returncode == 0, f"prepare {name}: exit {r.returncode}\n{r.stderr}")
            return json.loads(r.stdout.strip().splitlines()[-1])

        n_trials = PREP_SUBJECTS * (PREP_TRIALS + 1)  # the empty ImgName is kept
        got = prepare("parse-sessions", "-i", os.path.join(work, "ds001499"),
                      "--stimuli", os.path.join(work, "stimuli"), "-o",
                      os.path.join(out, "bold5000.pickle"))
        check(got["trials"] == n_trials, f"parse-sessions: {got}, want {n_trials} trials")
        got = prepare("stimuli-paths", "-i", os.path.join(work, "stim_lists"),
                      "--bold-index", os.path.join(out, "bold5000.pickle"), "-o", roi)
        check(got == {s: PREP_TRIALS for s in shown}, f"stimuli-paths: {got}")
        got = prepare("split-stimuli", "-i",
                      os.path.join(work, "stim_lists", "CSI01_stim_lists.txt"), "-o", roi)
        unique = len(set(shown["CSI1"]))
        n_test = math.ceil(0.1 * unique)  # the default --ratio
        check(got == {"train": unique - n_test, "valid": n_test},
              f"split-stimuli: {got} of {unique} stimuli")
        h5py = importlib.util.find_spec("h5py") is not None
        print(f"[prepare] extract-roi not run here: it reads the figshare ROI .h5 files "
              f"with h5py ({'installed' if h5py else 'not installed on this machine'}), "
              f"and the CPU tests hold it against the JAX package's; the phase writes "
              f"<sub>_roi_pad.npz itself", flush=True)
        rng = np.random.default_rng(5)
        for s, sub in enumerate(shown):
            np.savez(os.path.join(roi, sub, f"{sub}_roi_pad.npz"),
                     roi=rng.normal(0.5 * s, 1.0 + s, (PREP_TRIALS, voxels)))
        n = PREP_SUBJECTS * PREP_TRIALS
        n_valid = -(-n // 5)  # split_dataset's ceil(0.2 * n)
        shape_flags = ("--crop", str(cfg.data.image_crop), "--size", str(size))
        got = prepare("pack", "-i", roi, "-o", packed, *shape_flags)
        pairs = {tag: {"fmri": [m, voxels], "image": [m, size, size, 3]}
                 for tag, m in (("train", n - n_valid), ("valid", n_valid))}
        check(got == pairs, f"pack: {got}")
        streams = {}
        for kind, source in (("npz", os.path.join(packed, "bold_train.npz")),
                             ("pickle", os.path.join(packed, "bold_train.pickle")),
                             ("images", coco)):
            streams[kind] = os.path.join(out, f"stream_{kind}")
            got = prepare(f"pack-stream {kind}", "-i", source,
                          "-o", streams[kind], *shape_flags)
            want = ({"image": [PREP_STIMULI, size, size, 3]} if kind == "images"
                    else pairs["train"])
            check(got == want, f"pack-stream {kind}: {got}, want {want}")
        launches["prepare"] = set_launches(0)
        check(set(launches["prepare"].values()) == {0},
              f"prepare: launches {launches['prepare']} in this process")
        for name in ("fmri.npy", "image.npy", "meta.json"):
            with open(os.path.join(streams["npz"], name), "rb") as f, \
                    open(os.path.join(streams["pickle"], name), "rb") as g:
                check(f.read() == g.read(),
                      f"pack-stream: {name} of the .npz cache and of its records differ")
        streamed = np.load(os.path.join(streams["images"], "image.npy"), mmap_mode="r")
        paths = sorted(os.listdir(coco))
        for i in (0, PREP_STIMULI // 2, PREP_STIMULI - 1):
            want = _quantize_u8(load_stimulus(os.path.join(coco, paths[i]),
                                              cfg.data.image_crop, size))
            check(np.array_equal(streamed[i], want),
                  f"pack-stream images: image {i} differs from the in-process decode")
        print(f"[prepare] subcommands (python -m fmri_tpu_torch.data.prepare, wall s each, "
              f"process start included): "
              + ", ".join(f"{k} {v:.2f}" for k, v in numbers.items())
              + f"; the .npz cache and the record pickle stream to the same bytes; "
              f"launches in this process {launches['prepare']}", flush=True)

        launches["prepare_train_cli"], per_step, wall = cli_run(run.main, [
            "--family", "vgan", "--stage", "1", "--preset", preset, "--input",
            streams["images"], "--epochs", "1", "-o", os.path.join(work, "train"),
            *cli_args], 2, "train CLI on a pack-stream dir", tag="prepare")
        numbers["train_cli_wall"] = wall
        numbers["train_cli_s_per_step"] = per_step
        model = VaeGanCognitive(cfg.model)
        model.load_state_dict(from_jax_groups(random_groups(cfg, seed=6), cfg), strict=True)
        pth = os.path.join(work, "stage3.pth")
        torch.save(model.state_dict(), pth)

        def no_decoding(*a, **k):
            raise AssertionError("a stimulus was decoded though the pack output holds it")

        real_load = datasets.load_stimulus
        datasets.load_stimulus = no_decoding
        try:
            launches["prepare_inference"], _, wall = cli_run(inference.main, [
                "--family", "vgan", "--stage", "3", "--dataset", "bold", "-i", roi,
                "--cache-dir", packed, "--ckpt", pth, "--preset", preset, "-o",
                os.path.join(work, "inference"), *cli_args], SSIM_LAUNCHES_PER_RUN,
                "inference CLI on the pack output", tag="prepare")
        finally:
            datasets.load_stimulus = real_load
        numbers["inference_wall"] = wall
        with open(os.path.join(work, "inference", "summary.json")) as f:
            summary = json.load(f)
        check(summary["num_images"] == n_valid and 0.0 < summary["ssim"] <= 1.0
              and summary["is_proxy"] == 1.0 and summary["is_mean"] > 0.999,
              f"inference on the pack output: {summary}")
        print(f"[prepare] python -m fmri_tpu_torch.train.run --input <pack-stream dir of "
              f"{PREP_STIMULI} stimuli>, 1 epoch: {numbers['train_cli_wall']:.2f} s wall, s "
              f"per step {['%.4f' % s for s in per_step]}, launches "
              f"{launches['prepare_train_cli']}; the inference CLI on the pack output "
              f"({n_valid} pairs from bold_valid.npz, nothing decoded): {wall:.2f} s, "
              f"launches {launches['prepare_inference']}, ssim {summary['ssim']:.4f}, "
              f"is_mean {summary['is_mean']:.6f}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches, numbers


class Timed:
    """Stands in for ``module.name``, keeping the seconds of each call
    (synchronized before and after on the card)."""

    def __init__(self, module, name):
        self.module, self.name, self.orig = module, name, getattr(module, name)
        self.seconds = []
        setattr(module, name, self)

    def __call__(self, *args, **kw):
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.orig(*args, **kw)
        torch.cuda.synchronize()
        self.seconds.append(time.perf_counter() - t0)
        return out

    def restore(self):
        setattr(self.module, self.name, self.orig)


# phase 15: Inception-v3 (random weights in torchvision's layout) over phase
# 4's 1,024 res64 reconstructions at 299 px; the parity CLI at res100
# (latent 512), stage 3, on 2,560 synthetic pairs (its 256-pair validation
# split, batch 100)
# card vs CPU Inception-v3 (fp32 both, TF32 off): the probabilities, and the
# logits relative to their largest magnitude (cuDNN's algorithms against the
# CPU's over 94 convs)
V3_PROB_TOL, V3_LOGIT_TOL = 1e-5, 1e-3
PARITY_SYNTHETIC = 2_560
PARITY_ROW_KEYS = ["checkpoint", "num_images", "pcc", "ssim", "mse", "is_mean", "is_std",
                   "is_proxy", "pcc_2way", "ssim_2way", "pcc_5way", "ssim_5way",
                   "pcc_10way", "ssim_10way"]


def is_parity_phase(dev, recons, preset="res100", synthetic=PARITY_SYNTHETIC, cli_args=()):
    """Phase 15. (a) Inception-v3 at full width: seeded weights in
    torchvision's layout (``inception_v3.random_weights``) written to an
    ``.npz`` that ``FMRI_TPU_INCEPTION_NPZ`` names, ``inception_score`` over
    ``recons`` (each upsampled to 299 px), timed warm; 8 images'
    probabilities on the card against the same module on the CPU. (b) the
    parity CLI at ``res100`` stage 3 with the IS (the proxy) on: ``--ref-ckpt``
    a ``.pth`` of random weights (``torch.save`` of the eval module's
    ``state_dict``, read back by ``load_pth``), ``--ckpt`` a port checkpoint
    dir of the same weights in a stage-3 ``TrainState``; both rows agree,
    ``parity.json`` has the JAX CLI's keys, SSIM launches 4 per row, each
    recorded 100 px call held against the plain version in float64 and
    timed beside its bound. ``preset``, ``synthetic`` and ``cli_args`` let a
    rehearsal on the CPU run it small. Returns (launches, {numbers}, [SSIM
    shapes])."""
    import os
    import shutil

    import numpy as np
    import torch

    from fmri_tpu_torch.checkpoints.convert import from_jax_groups, load_pth, random_groups
    from fmri_tpu_torch.checkpoints.store import save_checkpoint
    from fmri_tpu_torch.configs import get_config
    from fmri_tpu_torch.data.transforms import resize_batch
    from fmri_tpu_torch.eval import evaluate, parity
    from fmri_tpu_torch.eval.steps import VaeGanCognitive
    from fmri_tpu_torch.metrics import inception, inception_v3
    from fmri_tpu_torch.ops import ssim as ssim_ops
    from fmri_tpu_torch.ops.ssim import ssim_plain, ssim_plane_sums
    from fmri_tpu_torch.train.state import VaeGanCognitiveTrain, make_cognitive_state

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_smoke_runs", "is_parity")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    numbers = {}
    try:
        # (a) Inception-v3 over the res64 reconstructions
        npz = os.path.join(work, "inception_v3.npz")
        np.savez(npz, **inception_v3.random_weights(seed=0))
        os.environ["FMRI_TPU_INCEPTION_NPZ"] = npz
        try:
            check(not inception.is_proxy(), "FMRI_TPU_INCEPTION_NPZ set, yet the proxy scores")
            inception.classify(recons[:64])  # loads the weights, warms cuDNN
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mean, std, proxy = inception.inception_score(recons)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            card = inception_v3.classify_with_weights(npz, recons[:8])
            cpu = inception_v3.classify_with_weights(npz, recons[:8].cpu())
        finally:
            del os.environ["FMRI_TPU_INCEPTION_NPZ"]
        x8 = resize_batch(recons[:8], inception_v3.INPUT_SIZE).permute(0, 3, 1, 2).contiguous()
        with torch.no_grad():
            logits = inception_v3.load_model(npz, x8.device)(x8).cpu()
            logits_cpu = inception_v3.load_model(npz, torch.device("cpu"))(x8.cpu())
        err = float(np.abs(card - cpu).max())
        logit_err = float((logits - logits_cpu).abs().max() / logits_cpu.abs().max())
        check(np.isfinite(mean) and mean > 0.999 and not proxy,
              f"Inception-v3 IS {mean} +- {std}, is_proxy {proxy}")
        check(err <= V3_PROB_TOL and logit_err <= V3_LOGIT_TOL,
              f"Inception-v3 card vs CPU: probabilities {err} (bound {V3_PROB_TOL}), logits "
              f"{logit_err} of the largest (bound {V3_LOGIT_TOL})")
        numbers["inception_v3"] = {"images": len(recons), "seconds": secs,
                                   "images_per_s": len(recons) / secs, "is_mean": mean,
                                   "is_std": std, "is_proxy": float(proxy),
                                   "card_vs_cpu_prob": err, "card_vs_cpu_logit_rel": logit_err,
                                   "logit_std": float(logits_cpu.std())}
        print(f"[is_parity] Inception-v3 (random weights, torchvision layout) over "
              f"{len(recons)} reconstructions of {recons.shape[1]} px, each upsampled to "
              f"{inception_v3.INPUT_SIZE} px: {secs:.3f} s, "
              f"{len(recons) / secs:.1f} images/s; is_mean {mean:.6f}, is_std {std:.3g}, "
              f"is_proxy {float(proxy):.0f}; 8 images card vs CPU: probabilities {err:.3g} "
              f"(bound {V3_PROB_TOL}), logits {logit_err:.3g} of the largest (bound "
              f"{V3_LOGIT_TOL}; logits' std {float(logits_cpu.std()):.3g})", flush=True)

        # (b) the parity CLI at res100
        cfg = get_config(preset)
        size = cfg.data.image_size
        model = VaeGanCognitive(cfg.model)
        model.load_state_dict(from_jax_groups(random_groups(cfg, seed=1), cfg), strict=True)
        pth = os.path.join(work, "vaegan_cog_3st.pth")
        torch.save(model.state_dict(), pth)
        back = load_pth(pth)
        check(back.keys() == model.state_dict().keys()
              and all(torch.equal(back[k], v) for k, v in model.state_dict().items()),
              "load_pth does not read back the saved state dict")
        nets = VaeGanCognitiveTrain(cfg)
        nets.load_state_dict(from_jax_groups(random_groups(cfg, seed=1, kind="vae-gan-cognitive"),
                                             cfg, "vae-gan-cognitive"), strict=True)
        ckpt = os.path.join(work, "checkpoints")
        save_checkpoint(ckpt, 0, make_cognitive_state(nets.to(dev), cfg, 3))
        del nets
        calls = {}
        recorder = Recorder(ssim_ops, "ssim_plane_sums", calls)
        timers = {name: Timed(evaluate, name) for name in (
            "reconstruct_dataset", "quality_metrics", "inception_score", "objective_scores")}
        out = os.path.join(work, "parity")
        set_launches(0)
        t0 = time.perf_counter()
        try:
            check(parity.main(["--family", "vgan", "--stage", "3", "--preset", preset,
                               "--ref-ckpt", pth, "--ckpt", ckpt, "--dataset", "synthetic",
                               "--synthetic-n", str(synthetic), "-o", out,
                               *cli_args]) == 0, "the parity CLI failed")
        finally:
            wall = time.perf_counter() - t0
            launches = set_launches(0)
            recorder.restore()
            for t in timers.values():
                t.restore()
        check(launches == {"bn_bwd_reduce": 0, "bn_bwd_apply": 0, "tap_matmul": 0,
                           "ssim": 2 * SSIM_LAUNCHES_PER_RUN},
              f"parity CLI: launches {launches}, want {2 * SSIM_LAUNCHES_PER_RUN} SSIM")
        with open(os.path.join(out, "parity.json")) as f:
            report = json.load(f)
        check(list(report) == ["preset", "family", "stage", "dataset", "rows"]
              and [list(r) for r in report["rows"]] == [PARITY_ROW_KEYS] * 2,
              f"parity.json keys: {list(report)}, rows {[list(r) for r in report['rows']]}")
        ref, fw = report["rows"]
        n = ref["num_images"]
        gaps = {k: abs(ref[k] - fw[k]) for k in PARITY_ROW_KEYS[1:]}
        check(n == fw["num_images"] == max(synthetic // 10, cfg.train.batch_size)
              and all(gaps[k] <= 1e-6 for k in ("pcc", "ssim", "mse", "is_std"))
              and gaps["is_mean"] <= 1e-6 * ref["is_mean"] and ref["is_proxy"] == 1.0
              and all(gaps[k] <= 1.0 / n for k in PARITY_ROW_KEYS if k.endswith("way")),
              f"the parity rows disagree: {ref} vs {fw}")
        with open(os.path.join(out, "parity.md")) as f:
            header = f.readline().strip()
        check(header == "| checkpoint | pcc | ssim | mse | pcc_2way | pcc_5way | pcc_10way | "
                        "ssim_2way | ssim_5way | ssim_10way |", f"parity.md header {header}")
        shapes = []
        for (a, b, *rest), count in calls.values():
            check(tuple(a.shape[1:]) == (size, size, 3), f"ssim call at {list(a.shape)}")
            err, img_err, img_err_plain = hold_ssim_call(a, b, rest)
            ms = cuda_ms(lambda: ssim_plane_sums(a, b, *rest), iters=10)
            dev_ms, source = device_ms(lambda: ssim_plane_sums(a, b, *rest))
            plain_ms = cuda_ms(lambda: ssim_plain(a, b, *rest, size_average=False),
                               iters=3, warmup=1)
            bound_ms, bound_by = ssim_bound(tuple(a.shape))
            shapes.append({"shape": list(a.shape), "count": count, "ms": ms,
                           "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                           "bound_by": bound_by, "max_abs_err": err})
            print(f"[is_parity] ssim {list(a.shape)} x{count}: {ms:.4f} ms per call, device "
                  f"{dev_ms:.4f} ms ({source}), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} "
                  f"ms ({bound_by}; {100 * bound_ms / dev_ms:.1f}% of it on the device), "
                  f"|kernel - plain in float64| {err:.3g}; per image from float64: kernel "
                  f"{img_err:.3g}, fp32 plain {img_err_plain:.3g}", flush=True)
        stages = {name: t.seconds for name, t in timers.items()}
        rec = stages["reconstruct_dataset"]
        numbers["parity_res100"] = {"wall_s": wall, "images_per_row": n,
                                    "seconds_by_stage": stages,
                                    "reconstruct_images_per_s": [n / s for s in rec],
                                    "row": {k: ref[k] for k in PARITY_ROW_KEYS[1:]},
                                    "row_gaps": gaps}
        print(f"[is_parity] python -m fmri_tpu_torch.eval.parity --preset {preset} --stage 3 "
              f"(a .pth and a checkpoint dir of the same weights, {n} synthetic pairs each, "
              f"IS on): {wall:.2f} s wall; launches {launches}; reconstruction "
              f"{['%.4f' % s for s in rec]} s ({['%.1f' % (n / s) for s in rec]} images/s); "
              f"seconds by stage (each row) "
              + "; ".join(f"{k} {['%.4f' % s for s in v]}" for k, v in stages.items())
              + f"; reference row {json.dumps({k: ref[k] for k in PARITY_ROW_KEYS[1:]})}; "
              f"largest row gap {max(gaps.values()):.3g}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches, numbers, shapes


# launches per step of each ablation path with both kernel flags on
# (tests/test_torch_exp_cli.py counts the wrappers' calls on the CPU and
# holds this table to its count): one backward per trained head through the
# decoder (3 BN, 4 dW a pass) and the discriminator (3 BN and 4 dW; 2 BN
# from the feature tap)
EXP_LAUNCHES = {
    "exp_decoder": {"bn_bwd_reduce": 3, "bn_bwd_apply": 3, "tap_matmul": 4},
    "exp_vae": {"bn_bwd_reduce": 6, "bn_bwd_apply": 6, "tap_matmul": 4},
    "exp_vgan": {"bn_bwd_reduce": 17, "bn_bwd_apply": 17, "tap_matmul": 12},
    "exp_dcgan_stage1": {"bn_bwd_reduce": 9, "bn_bwd_apply": 9, "tap_matmul": 8},
    "exp_dcgan_stage2": {"bn_bwd_reduce": 12, "bn_bwd_apply": 12, "tap_matmul": 12}}
# a train-mode forward and backward of the backbones, both flags on
BACKBONE_LAUNCHES = {
    "voxel_decoder": {"bn_bwd_reduce": 3, "bn_bwd_apply": 3, "tap_matmul": 4},
    "wae_decoder": {"bn_bwd_reduce": 3, "bn_bwd_apply": 3, "tap_matmul": 4},
    "resnet_encoder": {"bn_bwd_reduce": 0, "bn_bwd_apply": 0, "tap_matmul": 0}}
EXP_CLI = ("decoder", "vae", "vgan", "dcgan-stage1", "dcgan-stage2")
# the backbones' gradients, flags on against off (L2 per tensor, relative);
# the trunks and aux losses on the card against the CPU (largest |gap| over
# the largest |CPU value|)
BACKBONE_GRAD_TOL, CARD_CPU_TOL = 1e-3, 1e-4


def exp_phase(dev, cfg, preset="res64", cli_args=(), backbone_batch=64, timed_batch=64):
    """Phase 16: the ablation experiments and their backbones. (a) each
    ``exp_*`` step at ``cfg`` with both kernel flags on, against flags off
    (``check_tensors``), launches per step ``EXP_LAUNCHES``, 5 timed steps
    and a profiled one, every kernel call against its plain version; (b)
    ``--family exp --exp <each>`` through the train CLI one epoch on
    synthetic data (2 SSIM launches each), each checkpoint restored; (c)
    VoxelDecoder, WaeDecoder and ResNetEncoder forward and backward, flags
    on against off; VGG19 and the ResNet-152 trunk over seeded npz weights
    and the aux losses, card against CPU, and the trunks' images/s.
    Returns ({path: launches}, numbers)."""
    import os
    import shutil

    import numpy as np
    import torch

    from fmri_tpu_torch.checkpoints import store
    from fmri_tpu_torch.data.synthetic import synthetic_pairs
    from fmri_tpu_torch.train import run
    from fmri_tpu_torch.train import steps_exp as se
    from fmri_tpu_torch.train.stages import BUILDERS

    t, c = cfg.train, cfg.model
    b = t.batch_size
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_smoke_runs", "exp")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cfg_on = with_flags(cfg, pallas_bn=True, pallas_backward=True)
    launches_by_path, numbers = {}, {"s_per_step": {}, "busy_share": {}}
    try:
        # (a) the bare steps, states from the builders
        dcgan1 = os.path.join(work, "dcgan1")
        store.save_checkpoint(dcgan1, 0, BUILDERS["exp_dcgan_stage1"](
            cfg, steps_per_epoch=1, device="cpu")[0])
        data = synthetic_pairs(b, c.image_size, c.num_voxels, seed=0)
        fmri = torch.from_numpy(data["fmri"]).to(dev)
        image = torch.from_numpy(2.0 * data["image"] - 1.0).to(dev)
        gen = torch.Generator(device=dev).manual_seed(16)
        hyper = (t.margin, t.equilibrium, t.lambda_mse)

        def noise():
            return torch.randn((b, c.latent_dim), generator=gen, device=dev)

        paths = {  # (step maker, draw, frozen prefixes)
            "exp_decoder": (se.make_supervised_decoder_step, lambda: (fmri, image), ()),
            "exp_vae": (lambda c_: se.make_cognitive_scratch_step(c_, "vae"),
                        lambda: (fmri, image, noise(), noise(), *hyper), ()),
            "exp_vgan": (lambda c_: se.make_cognitive_scratch_step(c_, "vae-gan"),
                         lambda: (fmri, image, noise(), noise(), *hyper), ()),
            "exp_dcgan_stage1": (se.make_dcgan_stage1_step,
                                 lambda: (image, noise(), *hyper), ()),
            "exp_dcgan_stage2": (se.make_dcgan_stage2_step,
                                 lambda: (fmri, image, noise(), noise(), *hyper),
                                 ("encoder.",)),
        }
        for path, (factory, draw, frozen) in paths.items():
            def new_state(cfg_, device, path=path):
                args = [dcgan1] if path == "exp_dcgan_stage2" else []
                return warm_moments(BUILDERS[path](cfg_, *args, steps_per_epoch=1,
                                                   device=str(device))[0])

            weights = {k: v.cpu().clone() for k, v in new_state(cfg, "cpu").nets.state_dict()
                       .items()}
            step_on = factory(cfg_on).train_step
            args = draw()

            # the main path: one step with both flags on, every call recorded
            on = new_state(cfg_on, dev)
            (on, m_on), launches, calls, cold = record_step(lambda: step_on(on, *args))
            print(f"[{path}] {c.image_size} px step, batch {b}, both kernel flags on: first "
                  f"step {cold:.3f} s; launches per step {launches}; metrics "
                  f"{ {k: round(float(v), 6) for k, v in m_on.items()} }", flush=True)
            check(launches == EXP_LAUNCHES[path],
                  f"{path}: launches per step {launches}, want {EXP_LAUNCHES[path]}")
            launches_by_path[path] = launches
            check(all(np.isfinite(float(v)) for v in m_on.values()), f"{path}: metrics {m_on}")
            sd = on.nets.state_dict()
            check(all(bool(torch.isfinite(v).all()) for v in sd.values()),
                  f"{path}: non-finite parameters")
            for k, v in sd.items():
                if k.startswith(frozen) and "running" not in k and "num_batches" not in k:
                    check(torch.equal(v.cpu(), weights[k]), f"{path}: frozen {k} moved")
            if path == "exp_vae":  # the discriminator never trains; its BN ticks
                for k, v in sd.items():
                    if k.startswith("discriminator.") and "num_batches" not in k:
                        check(torch.equal(v.cpu(), weights[k]) != ("running" in k),
                              f"exp_vae: discriminator {k}")
                check(all(bool((v == 1.0).all())
                          for v in on.opt_state["discriminator"].values()),
                      "exp_vae: the discriminator's moments moved")
            if path == "exp_dcgan_stage2":  # the frozen encoder's BatchNorm ticks
                check(not torch.equal(sd["encoder.fc1.1.running_mean"].cpu(),
                                      weights["encoder.fc1.1.running_mean"]),
                      "exp_dcgan_stage2: the encoder's BatchNorm did not tick")
                check("encoder" not in on.opt_state, "exp_dcgan_stage2: encoder moments")

            # 1. against the library backward (both flags off) on the card, each
            #    tensor above its own rounding noise (the reversed batch)
            off_step = factory(cfg).train_step
            off, m_off = off_step(new_state(cfg, dev), *args)
            rev, _ = off_step(new_state(cfg, dev), *map(reversed_batch, args))
            check_tensors(f"{path} kernels vs library backward on the card", on, m_on, off,
                          m_off, weights, STEP_TOL, tensor_gaps(rev, off, weights))

            # 2. five timed steps and a profiled one
            n_steps = 5
            (on, secs, _), counted, _, _ = record_step(
                lambda: timed_steps(step_on, on, n_steps, draw), record=False)
            numbers["s_per_step"][path] = secs
            print(f"[{path}] {n_steps} steps: {secs:.4f} s per step, {b / secs:.1f} "
                  f"examples/s (host clock, warm)", flush=True)
            for n, count in counted.items():
                check(count == n_steps * launches[n],
                      f"{path} {n}: {count} launches over {n_steps} steps")
            numbers["busy_share"][path] = profile_step(
                lambda: step_on(on, *draw()), path, secs)["busy_share"]

            # 3. every kernel call of the step against its plain version
            hold_against_plain(calls, path, timed=False)

        # (b) the train CLI, as users start it; dcgan-stage2 from dcgan-stage1's run
        cli = {}
        for exp in EXP_CLI:
            extra = (["--prev-ckpt", os.path.join(cli["dcgan-stage1"], "checkpoints")]
                     if exp == "dcgan-stage2" else [])
            out = os.path.join(work, "cli_" + exp)
            got, per_step, wall = cli_run(run.main, [
                "--family", "exp", "--exp", exp, "--preset", preset, "--dataset",
                "synthetic", "--epochs", "1", "-o", out, *extra, *cli_args],
                SSIM_LAUNCHES_PER_EPOCH, f"--exp {exp}", tag="exp")
            cli[exp] = next(os.path.join(root, d) for root, dirs, _ in os.walk(out)
                            for d in dirs if os.path.isfile(os.path.join(
                                root, d, "config.json")))
            name = "exp_" + exp.replace("-", "_")
            builder_args = ([os.path.join(cli["dcgan-stage1"], "checkpoints")]
                            if exp == "dcgan-stage2" else [])
            state = BUILDERS[name](cfg, *builder_args, steps_per_epoch=1,
                                   device=str(dev))[0]
            state, meta = store.restore_checkpoint(os.path.join(cli[exp], "checkpoints"),
                                                   state)
            check(int(state.step) > 0 and np.isfinite(meta["metrics"]["valid_SSIM"]),
                  f"--exp {exp}: checkpoint step {int(state.step)}, metrics {meta}")
            launches_by_path[f"exp_cli_{exp}"] = got
            numbers[f"cli_{exp}"] = {"wall_s": wall, "s_per_step": per_step,
                                     "valid_SSIM": meta["metrics"]["valid_SSIM"]}
            print(f"[exp] python -m fmri_tpu_torch.train.run --family exp --exp {exp}: "
                  f"{wall:.2f} s wall, s per step {per_step}, launches {got}; checkpoint "
                  f"epoch {meta['epoch']} restored", flush=True)

        # (c) the backbones
        numbers.update(backbone_checks(dev, cfg, work, backbone_batch, timed_batch,
                                       launches_by_path))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"[exp] numbers (host clock): {json.dumps(numbers)}", flush=True)
    return launches_by_path, numbers


def backbone_checks(dev, cfg, work, b, timed_b, launches_by_path):
    """Phase 16(c): VoxelDecoder, WaeDecoder and ResNetEncoder train-mode
    forward and backward at batch ``b``, both flags on against off (each
    recorded kernel call against its plain version); VGG19's five taps and
    the full ResNet-152 trunk over seeded npz weights, card against CPU on 4
    images, and their images/s at batch ``timed_b``; every aux loss, card
    against CPU. Returns the numbers."""
    import os

    import numpy as np
    import torch

    from fmri_tpu_torch.losses import aux_losses, vgg19
    from fmri_tpu_torch.models import nets, resnet152

    c, s = cfg.model, cfg.model.image_size
    gen = torch.Generator().manual_seed(17)
    inputs = {"voxel_decoder": torch.randn((b, c.num_voxels), generator=gen),
              "wae_decoder": torch.randn((b, c.latent_dim), generator=gen),
              "resnet_encoder": torch.rand((b, s, s, 3), generator=gen) * 2 - 1}
    modules = {"voxel_decoder": nets.VoxelDecoder, "wae_decoder": nets.WaeDecoder,
               "resnet_encoder": nets.ResNetEncoder}
    numbers = {}
    for name, module in modules.items():
        torch.manual_seed(0)
        ref_module = module(c)
        x = inputs[name].to(dev)
        grads = {}
        for flags in (False, True):
            m = module(with_flags(cfg, pallas_bn=flags, pallas_backward=flags).model)
            m.load_state_dict(ref_module.state_dict())
            m.to(dev).train()

            def run(m=m):
                out = m(x)
                outs = out if isinstance(out, tuple) else (out,)
                loss = sum((o * o).sum() for o in outs)
                return torch.autograd.grad(loss, list(m.parameters()))

            grads[flags], launches, calls, secs = record_step(run, record=flags)
            if flags:
                check(launches == BACKBONE_LAUNCHES[name],
                      f"{name}: launches {launches}, want {BACKBONE_LAUNCHES[name]}")
                launches_by_path[name] = launches
                hold_against_plain(calls, name, timed=False)
        gap = max(float((a - r).norm() / r.norm().clamp_min(1e-30))
                  for a, r in zip(grads[True], grads[False]))
        check(gap <= BACKBONE_GRAD_TOL, f"{name}: flags on vs off gradients {gap}")
        numbers[name] = {"grad_gap_flags": gap}
        print(f"[exp] {name} batch {b}: forward + backward, flags on vs off: gradients "
              f"within {gap:.3g} (bound {BACKBONE_GRAD_TOL}); launches "
              f"{launches_by_path[name]}", flush=True)

    def gap_cpu(card, cpu):
        return float((card.cpu() - cpu).abs().max() / cpu.abs().max().clamp_min(1e-30))

    x4 = torch.rand((4, 64, 64, 3), generator=gen)
    xb = torch.rand((timed_b, 64, 64, 3), generator=gen).to(dev)

    def images_per_s(fn):
        with torch.no_grad():
            for _ in range(3):
                fn(xb)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                fn(xb)
            torch.cuda.synchronize()
        return 10 * timed_b / (time.perf_counter() - t0)

    vgg_npz = os.path.join(work, "vgg19_features.npz")
    np.savez(vgg_npz, **vgg19.random_weights(0))
    gaps = {}
    for depth in vgg19.TAPS:
        with torch.no_grad():
            card = vgg19.vgg19_tap_fn(depth, vgg_npz)(x4.to(dev))
            gaps[depth] = gap_cpu(card, vgg19.vgg19_tap_fn(depth, vgg_npz)(x4))
    check(max(gaps.values()) <= CARD_CPU_TOL, f"vgg19 card vs CPU per tap {gaps}")
    deepest = vgg19.vgg19_tap_fn(5, vgg_npz)
    numbers["vgg19"] = {"card_vs_cpu": gaps, "images_per_s_tap5": images_per_s(deepest)}

    r_npz = os.path.join(work, "resnet152.npz")
    np.savez(r_npz, **resnet152.random_weights(0))
    trunk_cpu = resnet152.resnet152_trunk_fn(r_npz)
    trunk = resnet152.resnet152_trunk_fn(r_npz).to(dev)
    with torch.no_grad():
        r_gap = gap_cpu(trunk(x4.to(dev)), trunk_cpu(x4))
    check(r_gap <= CARD_CPU_TOL, f"resnet152 trunk card vs CPU {r_gap}")
    numbers["resnet152"] = {"card_vs_cpu": r_gap, "images_per_s": images_per_s(trunk)}

    a, t_ = torch.rand((8, 64, 64, 3), generator=gen) * 2 - 1, torch.rand((8, 64, 64, 3),
                                                                         generator=gen)
    v1, v2 = torch.randn((8, c.num_voxels), generator=gen), torch.randn((8, c.num_voxels),
                                                                       generator=gen)
    losses = {
        "voxel_loss": lambda d: aux_losses.voxel_loss(v1.to(d), v2.to(d)),
        "image_loss": lambda d: aux_losses.image_loss(a.to(d), t_.to(d)),
        "feature_loss_proxy": lambda d: aux_losses.feature_loss(a.to(d), t_.to(d)),
        "feature_cosine_loss_proxy": lambda d: aux_losses.feature_cosine_loss(a.to(d),
                                                                              t_.to(d)),
        "feature_loss_vgg19": lambda d: aux_losses.feature_loss(
            a.to(d), t_.to(d), feature_fn=vgg19.vgg19_tap_fn(2, vgg_npz)),
        "feature_cosine_loss_vgg19": lambda d: sum(
            aux_losses.feature_cosine_loss(a.to(d), t_.to(d),
                                           feature_fn=vgg19.vgg19_tap_fn(k, vgg_npz),
                                           depths=(k,)) for k in vgg19.TAPS),
        "total_variation_loss": lambda d: aux_losses.total_variation_loss(a.to(d)),
        "total_variation_l1": lambda d: aux_losses.total_variation_l1(a.to(d)),
        "total_variation_l2": lambda d: aux_losses.total_variation_l2(a.to(d)),
    }
    loss_gaps = {}
    with torch.no_grad():
        for name, fn in losses.items():
            card, cpu = float(fn(dev)), float(fn(torch.device("cpu")))
            loss_gaps[name] = abs(card - cpu) / max(abs(cpu), 1e-30)
    check(max(loss_gaps.values()) <= CARD_CPU_TOL, f"aux losses card vs CPU {loss_gaps}")
    numbers["aux_losses_card_vs_cpu"] = loss_gaps
    print(f"[exp] VGG19 (seeded npz) card vs CPU per tap {gaps}, "
          f"{numbers['vgg19']['images_per_s_tap5']:.1f} images/s to tap 5 at 64 px, batch "
          f"{timed_b}; ResNet-152 trunk card vs CPU {r_gap:.3g}, "
          f"{numbers['resnet152']['images_per_s']:.1f} images/s at 64 px; aux losses card vs "
          f"CPU at most {max(loss_gaps.values()):.3g} (bound {CARD_CPU_TOL})", flush=True)
    return numbers


# phase 17, training across ranks (parallel/mesh.py): (a) the train CLI at
# --mesh data=1 over NCCL against the run without --mesh; (b) ranks sharing
# the card over gloo, each path's step against the single-process step;
# (c) Trainer.fit over gloo at data=2 with a checkpoint and a resume; (d) the
# dry run over four ranks. gloo copies every collective through the host, so
# its times show that the paths run and are not NCCL's or several cards'
MESH_PATHS = {  # path: (kind, (data, model), tensor-parallel flags)
    "mesh_stage1": ("stage1", (2, 1), {}),
    "mesh_stage2": ("stage2", (2, 2), {"voxel_tp": True}),
    "mesh_stage3": ("stage3", (2, 2), {"voxel_tp": True, "decoder_tp": True}),
    "mesh_wae_stage1": ("wae_stage1", (2, 1), {}),
}
# each rank launches the single-process step's kernels: the same BatchNorms
# and convs run over its rows
MESH_LAUNCHES = {"stage1": TRAINER_LAUNCHES["trainer_stage1"], "stage2": COGNITIVE_LAUNCHES[2],
                 "stage3": COGNITIVE_LAUNCHES[3], "wae_stage1": WAE_LAUNCHES["wae_stage1"]}
MESH_KINDS = {"stage1": "vae-gan", "stage2": "vae-gan-cognitive",
              "stage3": "vae-gan-cognitive", "wae_stage1": "wae-gan"}
MESH_STEPS = 3  # timed steps of each (b) path
MESH_CLI_EXAMPLES = 256  # (a): 192 train examples (3 steps of 64), 64 held out
MESH_FIT_EXAMPLES, MESH_FIT_EPOCHS = 320, 2  # (c): 4 steps per epoch


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def mesh_state(kind, cfg, weights, dev):
    """A fresh state of a (b) path on ``dev``, moments warm."""
    from fmri_tpu_torch.train import state as st
    from fmri_tpu_torch.train.optim import RmsProp

    t = cfg.train
    module = {"stage1": st.VaeGan, "stage2": st.VaeGanCognitiveTrain,
              "stage3": st.VaeGanCognitiveTrain, "wae_stage1": st.WaeGan}[kind]
    nets = module(cfg)
    nets.load_state_dict(weights, strict=True)
    nets = nets.to(dev)
    if kind == "stage1":
        state = st.make_state(nets, {g: RmsProp(t.rms_decay, t.rms_eps, t.grad_clip)
                                     for g in st.GROUPS})
    elif kind == "wae_stage1":
        state = st.make_wae_state(nets, cfg)
    else:
        state = st.make_cognitive_state(nets, cfg, int(kind[-1]))
    return warm_moments(state)


def mesh_step(kind, cfg, mesh=None):
    from fmri_tpu_torch.train.steps_vgan import make_vgan_cognitive_step, make_vgan_stage1_step
    from fmri_tpu_torch.train.steps_wae import make_wae_stage1_step

    if kind == "stage1":
        return make_vgan_stage1_step(cfg, mesh=mesh).train_step
    if kind == "wae_stage1":
        return make_wae_stage1_step(cfg, mesh=mesh).train_step
    return make_vgan_cognitive_step(cfg, int(kind[-1]), mesh=mesh).train_step


def mesh_draw(kind, cfg, dev, gen, data):
    """One global batch's step arguments (the same on every rank: the
    generator is seeded alike)."""
    import torch

    t, c = cfg.train, cfg.model
    b = t.batch_size

    def noise(scale=1.0):
        return scale * torch.randn((b, c.latent_dim), generator=gen, device=dev)

    gate = (t.margin, t.equilibrium, t.lambda_mse)
    if kind == "stage1":
        return (data["image"], noise(), noise(), *gate)
    if kind == "wae_stage1":
        return (data["image"], noise(t.wae_sigma))
    return (data["fmri"], data["image"], noise(), noise(), noise(), *gate)


def state_from_tree(state, tree):
    """``state`` (single-process) holding a host tree's values."""
    from fmri_tpu_torch.train.optim import AdamState

    for g, sd in tree["groups"].items():
        state.nets.module(g).load_state_dict(sd, strict=True)
    for g, m in state.opt_state.items():
        saved = tree["opt_state"][g]
        pairs = ([(m.mu, saved["mu"]), (m.nu, saved["nu"])] if isinstance(m, AdamState)
                 else [(m, saved["sq_avg"])])
        for dst, src in pairs:
            for k, v in dst.items():
                v.copy_(src[k])
        if isinstance(m, AdamState):
            m.count.copy_(saved["count"])
    state.step.copy_(tree["step"])
    return state


def tree_leaves(tree, prefix=""):
    """[(path, tensor)] of a checkpoint tree (``store.host_tree``), in key
    order."""
    import torch

    if torch.is_tensor(tree):
        return [(prefix, tree)]
    return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k], f"{prefix}/{k}")]


def trees_equal_across_ranks(tree, mesh) -> bool:
    """Every tensor of this rank's gathered state bitwise rank 0's, on
    every rank (each tensor broadcast from rank 0)."""
    import torch

    bad = 0
    for _, v in tree_leaves(tree):
        ref = mesh.broadcast(v.clone())
        bad += int(not torch.equal(ref, v))
    flag = torch.tensor([float(bad)])
    torch.distributed.all_reduce(flag)
    return float(flag.item()) == 0.0


def hold_bn_with_allreduce(calls, mesh, path) -> float:
    """Each recorded BatchNorm backward against the plain version with the
    data group's all-reduce between its two passes: the plain reduce pass on
    this rank's rows, summed over the data group, against the sums the
    kernel's apply pass took, and the plain apply pass on those against the
    kernel's dx (``TOL`` of the largest plain value). A collective per
    call: every rank holds its calls in the same order."""
    from fmri_tpu_torch.ops import bn

    applies = {key[:4]: args for key, (args, _) in calls["bn_bwd_apply"].items()}
    worst = 0.0
    for key, (args, _) in calls["bn_bwd_reduce"].items():
        x, dy, mu, inv = args
        sums = mesh.data_sum(bn.bn_bwd_reduce_plain(x, dy, mu, inv))
        a = applies[key]
        check(len(a) == 9 and a[8] == x.numel() // x.shape[1] * mesh.data,
              f"{path}: bn_bwd_apply {list(x.shape)} took count {a[8:]}, want the global "
              f"{x.numel() // x.shape[1] * mesh.data}")
        err_sums = rel_err(a[5], sums)
        err_dx = rel_err(bn.bn_bwd_apply(*a), bn.bn_bwd_apply_plain(*a[:5], sums, *a[6:]))
        check(err_sums <= TOL and err_dx <= TOL,
              f"{path}: BatchNorm backward {list(x.shape)} with the all-reduce: sums "
              f"{err_sums}, dx {err_dx} (bound {TOL})")
        worst = max(worst, err_sums, err_dx)
    return worst


def mesh_rank(rank, world, port, device, preset, paths, out) -> None:
    """One rank of (b): each path in ``paths`` on a mesh of ranks sharing
    ``device`` over gloo. Rank 0 also runs the single-process step on the
    global batch and holds its replica against it."""
    import torch

    from fmri_tpu_torch.checkpoints.convert import from_jax_groups, random_groups
    from fmri_tpu_torch.checkpoints.store import host_tree
    from fmri_tpu_torch.configs import get_config
    from fmri_tpu_torch.data.synthetic import synthetic_pairs
    from fmri_tpu_torch.device import deterministic_cudnn, resolve_device
    from fmri_tpu_torch.parallel.mesh import initialize_multihost, make_mesh, shard_state

    dev = resolve_device(device)
    if dev.type == "cpu":  # a rehearsal off the card
        torch.cuda.synchronize = lambda *a, **k: None
    initialize_multihost(f"localhost:{port}", world, rank, backend="gloo")
    cfg = with_flags(get_config(preset), pallas_bn=True, pallas_backward=True)
    c = cfg.model
    raw = synthetic_pairs(cfg.train.batch_size, c.image_size, c.num_voxels, seed=0)
    data = {"fmri": torch.from_numpy(raw["fmri"]).to(dev),
            "image": torch.from_numpy(2.0 * raw["image"] - 1.0).to(dev)}
    results = {}
    with deterministic_cudnn():
        for path, (kind, shape, tp) in paths.items():
            mesh = make_mesh(*shape, devices=[dev] * world, backend="gloo")
            weights = from_jax_groups(random_groups(cfg, seed=0, kind=MESH_KINDS[kind]), cfg,
                                      MESH_KINDS[kind])
            gen = torch.Generator(device=dev).manual_seed(17)
            args = mesh_draw(kind, cfg, dev, gen, data)
            res = {}
            if rank == 0:  # the single-process step on the same card
                single = mesh_step(kind, cfg)
                ref = mesh_state(kind, cfg, weights, dev)
                (ref, m_ref), single_launches, _, _ = record_step(
                    lambda: single(ref, *args), record=False)
                rev, _ = single(mesh_state(kind, cfg, weights, dev),
                                *(reversed_batch(a) for a in args))
                state1 = mesh_state(kind, cfg, weights, dev)
                _sync(dev)
                t0 = time.perf_counter()
                for _ in range(MESH_STEPS):
                    state1, _ = single(state1, *mesh_draw(kind, cfg, dev, gen, data))
                _sync(dev)
                res["single_s_per_step"] = (time.perf_counter() - t0) / MESH_STEPS
                del state1
                gen.manual_seed(17)
                args = mesh_draw(kind, cfg, dev, gen, data)
            step = mesh_step(kind, cfg, mesh)
            state = shard_state(mesh_state(kind, cfg, weights, dev), mesh, **tp)
            local = [mesh.rows(a) if torch.is_tensor(a) else a for a in args]
            before = mesh.reduced_bytes
            (state, m), launches, calls, cold = record_step(lambda: step(state, *local))
            res["reduced_bytes_per_step"] = mesh.reduced_bytes - before
            res["launches"] = launches
            if dev.type == "cuda":
                check(launches == MESH_LAUNCHES[kind],
                      f"{path} rank {rank}: launches per step {launches}, want "
                      f"{MESH_LAUNCHES[kind]}, the single-process step's")
            tree = host_tree(state)
            res["replicas_bitwise_equal"] = trees_equal_across_ranks(tree, mesh)
            check(res["replicas_bitwise_equal"], f"{path}: the ranks' states differ")
            if rank == 0:
                if dev.type == "cuda":
                    check(single_launches == launches,
                          f"{path}: single-process launches {single_launches}, rank 0's "
                          f"{launches}")
                full = state_from_tree(mesh_state(kind, cfg, weights, dev), tree)
                check_tensors(f"{path} data={shape[0]} model={shape[1]} vs the single-process "
                              f"step", full, m, ref, m_ref, weights, STEP_TOL,
                              tensor_gaps(rev, ref, weights))
                del full, ref, rev
            res["bn_allreduce_err"] = hold_bn_with_allreduce(calls, mesh, path)
            hold_against_plain(calls, f"{path} rank {rank}", timed=False)
            del calls
            _sync(dev)
            t0 = time.perf_counter()
            before = mesh.reduced_bytes
            for _ in range(MESH_STEPS):
                state, m = step(state, *(mesh.rows(a) if torch.is_tensor(a) else a
                                         for a in mesh_draw(kind, cfg, dev, gen, data)))
            _sync(dev)
            res["s_per_step"] = (time.perf_counter() - t0) / MESH_STEPS
            res["timed_reduced_bytes_per_step"] = (mesh.reduced_bytes - before) / MESH_STEPS
            res["first_step_s"] = cold
            check(all(torch.isfinite(v).all() for v in m.values()),
                  f"{path}: non-finite metrics {m}")
            results[path] = res
            del state
            if rank == 0:
                print(f"[mesh] (b) {path} data={shape[0]} model={shape[1]} {tp or ''} over "
                      f"gloo, {world} ranks sharing {dev}: {res['s_per_step']:.4f} s per step "
                      f"(single-process {res['single_s_per_step']:.4f} s), "
                      f"{res['reduced_bytes_per_step'] / 2**20:.2f} MiB all-reduced per step "
                      f"and rank, launches {launches}, replicas bitwise equal, BatchNorm "
                      f"backward with the all-reduce vs plain {res['bn_allreduce_err']:.3g}",
                      flush=True)
    out.put((rank, results))
    mesh.close()


def mesh_fit_rank(rank, world, port, device, preset, work, out) -> None:
    """One rank of (c): ``Trainer.fit`` at data=2 over gloo, then the same
    run resumed from its epoch-0 checkpoint."""
    import dataclasses
    import os
    import shutil

    import torch

    from fmri_tpu_torch.checkpoints.store import host_tree
    from fmri_tpu_torch.configs import get_config
    from fmri_tpu_torch.data.synthetic import synthetic_images
    from fmri_tpu_torch.device import resolve_device
    from fmri_tpu_torch.ops import ssim as ssim_ops
    from fmri_tpu_torch.parallel.mesh import initialize_multihost, make_mesh
    from fmri_tpu_torch.train.stages import BUILDERS
    from fmri_tpu_torch.train.trainer import Trainer

    dev = resolve_device(device)
    if dev.type == "cpu":
        torch.cuda.synchronize = lambda *a, **k: None
    initialize_multihost(f"localhost:{port}", world, rank, backend="gloo")
    mesh = make_mesh(world, 1, devices=[dev] * world, backend="gloo")
    cfg = with_flags(get_config(preset), pallas_bn=True, pallas_backward=True)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, ckpt_every=1))
    b = cfg.train.batch_size
    imgs = synthetic_images(MESH_FIT_EXAMPLES, cfg.model.image_size, seed=0)[0]
    train, valid = imgs[b:], imgs[:b]
    spe = len(train) // b

    def trainer(run_dir):
        os.makedirs(run_dir, exist_ok=True)
        state, steps, kw = BUILDERS["vgan_stage1"](cfg, steps_per_epoch=spe, device=dev,
                                                   mesh=mesh)
        return state, Trainer(cfg, steps, run_dir, mesh=mesh, tensorboard=False, **kw)

    res = {}
    state, tr = trainer(os.path.join(work, "fit"))
    calls = {}
    recorder = Recorder(ssim_ops, "ssim_plane_sums", calls)
    set_launches(0)
    _sync(dev)
    t0 = time.perf_counter()
    state = tr.fit(state, train, valid, n_epochs=MESH_FIT_EPOCHS)
    _sync(dev)
    res["fit_s"] = time.perf_counter() - t0
    res["launches"] = set_launches(0)
    recorder.restore()
    for (a, b_, *rest), _ in calls.values():
        check(a.shape[0] == b // world, f"(c) rank {rank}: SSIM over {a.shape[0]} images, "
                                        f"want its {b // world} validation rows")
        hold_ssim_call(a, b_, rest)
    full = host_tree(state)
    resumed_dir = os.path.join(work, "fit_resumed")
    if rank == 0:
        shutil.copytree(os.path.join(work, "fit", "checkpoints", "ckpt_00000"),
                        os.path.join(resumed_dir, "checkpoints", "ckpt_00000"))
    mesh.barrier()
    state, tr = trainer(resumed_dir)
    state, start = tr.resume(state)
    check(start == 1, f"(c) resumed at epoch {start}")
    state = tr.fit(state, train, valid, n_epochs=MESH_FIT_EPOCHS, start_epoch=start)
    again = host_tree(state)
    res["resume_bitwise"] = all(torch.equal(u, v) for (_, u), (_, v) in zip(
        tree_leaves(full), tree_leaves(again)))
    check(res["resume_bitwise"], f"(c) rank {rank}: the resumed epoch differs from the "
                                 f"uninterrupted run's")
    res["replicas_bitwise_equal"] = trees_equal_across_ranks(full, mesh)
    check(res["replicas_bitwise_equal"], "(c) the ranks' states differ")
    out.put((rank, res))
    mesh.close()


def spawn_ranks(fn, world, *args) -> dict:
    """``fn(rank, world, port, *args, out)`` on ``world`` spawned processes;
    {rank: what it put}. A rank that fails fails the run."""
    import torch.multiprocessing as mp

    from fmri_tpu_torch.parallel.mesh import free_port

    out = mp.get_context("spawn").SimpleQueue()
    try:
        mp.spawn(fn, args=(world, free_port(), *args, out), nprocs=world, join=True)
    except Exception as e:  # the rank printed its own FAIL line
        fail(f"{fn.__name__} over {world} ranks: {e}")
    return dict(out.get() for _ in range(world))


def mesh_phase(dev, cfg, preset="res64", cli_args=()):
    """Phase 17. Returns ({path: launches per rank and step (per epoch for
    the trainer)}, numbers)."""
    import os
    import shutil

    import torch

    from fmri_tpu_torch.eval import inference
    from fmri_tpu_torch.parallel import dryrun
    from fmri_tpu_torch.parallel import mesh as mesh_mod
    from fmri_tpu_torch.train import run

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_smoke_runs", "mesh")
    shutil.rmtree(work, ignore_errors=True)
    numbers, launches_by_path, wall = {}, {}, {}

    # (a) the train CLI at --mesh data=1: the NCCL group forms, and the run
    # equals the run without --mesh
    t0 = time.perf_counter()
    made = []
    real = mesh_mod.make_mesh

    def spy(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]

    argv = ["--family", "vgan", "--stage", "1", "--preset", preset, "--dataset", "synthetic",
            "--synthetic-n", str(MESH_CLI_EXAMPLES), "--epochs", "1", *cli_args]
    states = {}
    for name, extra in (("plain", []), ("mesh", ["--mesh", "data=1"])):
        set_launches(0)
        mesh_mod.make_mesh = spy
        try:
            check(run.main([*argv, "-o", os.path.join(work, name), *extra]) == 0,
                  f"(a) the train CLI {extra} failed")
        finally:
            mesh_mod.make_mesh = real
        launches_by_path[f"mesh_cli_{name}"] = set_launches(0)
        (run_dir,) = [os.path.join(work, name, "vgan_stage1", d)
                      for d in os.listdir(os.path.join(work, name, "vgan_stage1"))]
        states[name] = torch.load(os.path.join(run_dir, "checkpoints", "ckpt_00000",
                                                "state.pt"), weights_only=True)
    want_backend = "nccl" if dev.type == "cuda" else "gloo"
    check(len(made) == 1 and made[0].backend == want_backend and made[0].world == 1,
          f"(a) --mesh data=1 made {made}, want one {want_backend} mesh of one rank")
    check(launches_by_path["mesh_cli_mesh"] == launches_by_path["mesh_cli_plain"],
          f"(a) launches {launches_by_path['mesh_cli_mesh']} vs without --mesh "
          f"{launches_by_path['mesh_cli_plain']}")

    pairs = list(zip(tree_leaves(states["mesh"]), tree_leaves(states["plain"])))
    check([k for (k, _), _ in pairs] == [k for _, (k, _) in pairs], "(a) checkpoint keys differ")
    bitwise = all(torch.equal(u, v) for (_, u), (_, v) in pairs)
    worst = max(float((u.double() - v.double()).abs().max()) if u.numel() else 0.0
                for (_, u), (_, v) in pairs)
    check(bitwise, f"(a) --mesh data=1 differs from the run without it by {worst}")
    wall["a"] = time.perf_counter() - t0
    numbers["a"] = {"backend": made[0].backend, "bitwise_equal": bitwise, "max_abs_gap": worst}
    print(f"[mesh] (a) train CLI --mesh data=1 over {made[0].backend} (world 1): its "
          f"checkpoint bitwise the run's without --mesh ({bitwise}); launches "
          f"{launches_by_path['mesh_cli_mesh']}; {wall['a']:.1f} s for both runs", flush=True)
    del states, made

    # (b) ranks sharing the card over gloo
    t0 = time.perf_counter()
    numbers["b"] = {}
    for world, names in ((2, ("mesh_stage1", "mesh_wae_stage1")),
                         (4, ("mesh_stage2", "mesh_stage3"))):
        print(f"[mesh] (b) {world} ranks on {dev} over gloo (a shared card, asked for by "
              f"name): {names}", flush=True)
        got = spawn_ranks(mesh_rank, world, str(dev), preset,
                          {n: MESH_PATHS[n] for n in names})
        for name in names:
            per_rank = [got[r][name] for r in range(world)]
            check(all(r["launches"] == per_rank[0]["launches"] for r in per_rank),
                  f"{name}: ranks launched {[r['launches'] for r in per_rank]}")
            launches_by_path[name] = per_rank[0]["launches"]
            numbers["b"][name] = {k: per_rank[0][k] for k in (
                "s_per_step", "single_s_per_step", "reduced_bytes_per_step",
                "timed_reduced_bytes_per_step", "first_step_s", "bn_allreduce_err")}
            numbers["b"][name]["mesh"] = list(MESH_PATHS[name][1])
    wall["b"] = time.perf_counter() - t0

    # (c) Trainer.fit at data=2, a checkpoint and a resume; the checkpoint in
    # the single-card inference CLI
    t0 = time.perf_counter()
    got = spawn_ranks(mesh_fit_rank, 2, str(dev), preset, work)
    check(got[0]["launches"] == got[1]["launches"], f"(c) ranks launched {got}")
    per_epoch = {k: v // MESH_FIT_EPOCHS for k, v in got[0]["launches"].items()}
    launches_by_path["mesh_trainer"] = per_epoch
    if dev.type == "cuda":
        steps = (MESH_FIT_EXAMPLES - cfg.train.batch_size) // cfg.train.batch_size
        want = {k: steps * v for k, v in TRAINER_LAUNCHES["trainer_stage1"].items()}
        want["ssim"] = SSIM_LAUNCHES_PER_EPOCH
        check(per_epoch == want, f"(c) launches per rank and epoch {per_epoch}, want {want}")
    set_launches(0)
    check(inference.main(["--family", "vgan", "--stage", "1", "--preset", preset,
                          "--dataset", "synthetic", "--synthetic-n", str(MESH_FIT_EXAMPLES),
                          "--no-is", "--ckpt", os.path.join(work, "fit", "checkpoints"),
                          "-o", os.path.join(work, "inference"), *cli_args]) == 0,
          "(c) the inference CLI failed on the mesh run's checkpoint")
    launches_by_path["mesh_inference"] = set_launches(0)
    if dev.type == "cuda":
        check(launches_by_path["mesh_inference"]["ssim"] == SSIM_LAUNCHES_PER_RUN,
              f"(c) inference: {launches_by_path['mesh_inference']}")
    wall["c"] = time.perf_counter() - t0
    numbers["c"] = {"fit_s": got[0]["fit_s"], "epochs": MESH_FIT_EPOCHS,
                    "resume_bitwise": got[0]["resume_bitwise"] and got[1]["resume_bitwise"]}
    print(f"[mesh] (c) Trainer.fit at data=2 over gloo on {dev}: {MESH_FIT_EPOCHS} epochs in "
          f"{got[0]['fit_s']:.2f} s; launches per rank and epoch {per_epoch}; the run resumed "
          f"from epoch 0 bitwise the uninterrupted one; its checkpoint in the single-card "
          f"inference CLI ({launches_by_path['mesh_inference']['ssim']} SSIM)", flush=True)

    # (d) the dry run over four ranks
    t0 = time.perf_counter()
    dev_kind = "cuda" if dev.type == "cuda" else "cpu"
    dry = dryrun.dryrun_multichip(4, device=dev_kind, share_card=dev_kind == "cuda")
    wall["d"] = time.perf_counter() - t0
    numbers["d"] = {p: r["loss"] for p, r in dry.items() if "loss" in r}
    numbers["d"]["fullbrain"] = dry["fullbrain"]
    numbers["d"]["serving"] = dry["serving"]
    print(f"[mesh] (d) dryrun_multichip(4) on {dev} over gloo: {len(numbers['d']) - 2} paths, "
          f"fullbrain fc1 {dry['fullbrain']}, serving {dry['serving']}; {wall['d']:.1f} s",
          flush=True)
    numbers["wall_s"] = wall
    shutil.rmtree(work, ignore_errors=True)
    return launches_by_path, numbers


# ------------------------------------------------------------------ phase 18

# (a)/(b): {world: [(server, preset, stage, (data, model), sample)]}: ranks
# sharing the card over gloo
SERVE_MESH_WORLDS = {
    2: [("res64_d2", "res64", 3, (2, 1), False)],
    4: [("res64_d2m2", "res64", 3, (2, 2), True),
        ("fullbrain_d2m2", "fullbrain", 2, (2, 2), False)],
}
SERVE_MESH_SIZES = (1, 5, 64, 130)
SERVE_MESH_TIMED, SERVE_MESH_CALLS = (2, 8, 64), 20  # buckets timed, calls each
SERVE_MESH_REQUESTS, SERVE_MESH_THREADS = 256, 16
SERVE_MESH_LABEL = "ranks sharing one card over gloo (host copies), not NCCL across cards"


def _lsb(a, b) -> int:
    import numpy as np

    check(a.shape == b.shape and a.dtype == b.dtype == np.uint8,
          f"uint8 images {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
    return int(np.abs(a.astype(int) - b.astype(int)).max())


def serve_mesh_rank(rank, world, port, device, work, servers, out) -> None:
    """One rank of phase 18 (a) and (b): each server of ``servers`` over
    ranks sharing ``device`` over gloo. Rank 0 calls it, holds every answer
    against a single-process server on the same card (its graphs, the same
    buckets and seed) and times both; the other ranks follow. Every rank
    then holds its weights against its columns of the reloaded checkpoint."""
    import os
    import threading

    import numpy as np
    import torch

    from fmri_tpu_torch.checkpoints.convert import from_jax_groups, random_groups
    from fmri_tpu_torch.configs import get_config
    from fmri_tpu_torch.device import resolve_device
    from fmri_tpu_torch.eval.serve import BatchingServer, ServingModel
    from fmri_tpu_torch.eval.steps import eval_module
    from fmri_tpu_torch.parallel.mesh import initialize_multihost, make_mesh

    dev = resolve_device(device)
    if dev.type == "cpu":  # a rehearsal off the card: the ranks share the host's cores
        torch.cuda.synchronize = lambda *a, **k: None
        torch.set_num_threads(1)
    initialize_multihost(f"localhost:{port}", world, rank, backend="gloo")
    set_launches(0)
    kind, results = "vae-gan-cognitive-eval", {}
    for name, preset, stage, (data, model), sample in servers:
        cfg = get_config(preset)
        v = cfg.model.num_voxels

        def weights(seed, k=kind):
            return from_jax_groups(random_groups(cfg, seed=seed, kind=k), cfg, k)

        def build(sd, mesh=None):
            m = eval_module("vgan", stage)[0](cfg.model)
            m.load_state_dict(sd, strict=True)
            return ServingModel(cfg, m, family="vgan", stage=stage, max_batch=SERVE_MAX_BATCH,
                                min_bucket=data, sample=sample, seed=3, output="uint8",
                                device=dev, mesh=mesh, voxel_tp=mesh is not None and model > 1)

        mesh = make_mesh(data, model, devices=[dev] * world, backend="gloo")
        other = os.path.join(work, f"{name}_other.pth")
        wrong = os.path.join(work, f"{name}_wrong.pth")
        first = weights(0)
        served, res = build(first, mesh), {}
        if rank != 0:
            del first
            served.follow()
        else:
            single = build(first)
            del first
            torch.save(weights(1), other)
            torch.save(weights(2, "vae-gan"), wrong)  # a stage-I file: other keys
            t0 = time.perf_counter()
            served.warmup()
            res["warmup_s"] = time.perf_counter() - t0
            single.warmup()
            rng = np.random.default_rng(7)
            lsb = max(_lsb(served.reconstruct(x), single.reconstruct(x)) for x in (
                rng.standard_normal((n, v), dtype=np.float32) for n in SERVE_MESH_SIZES))
            lsb = max(lsb, _lsb(served.generate(70), single.generate(70)))
            res["timed"] = {}
            for b in SERVE_MESH_TIMED:
                x = rng.standard_normal((b, v), dtype=np.float32)
                row = {}
                for who, m in (("mesh", served), ("single", single)):
                    m.reconstruct(x)
                    before = mesh.reduced_bytes
                    t0 = time.perf_counter()
                    for _ in range(SERVE_MESH_CALLS):
                        m.reconstruct(x)
                    row[f"{who}_ms"] = 1e3 * (time.perf_counter() - t0) / SERVE_MESH_CALLS
                    if who == "mesh":
                        row["mib_per_call"] = ((mesh.reduced_bytes - before) / SERVE_MESH_CALLS
                                               / 2**20)
                res["timed"][b] = row
            batcher = BatchingServer(served, max_wait_ms=2.0)
            rows = rng.standard_normal((SERVE_MESH_REQUESTS, v), dtype=np.float32)
            per = SERVE_MESH_REQUESTS // SERVE_MESH_THREADS

            def client(k):
                for i in range(k * per, (k + 1) * per):
                    batcher.submit(rows[i]).result(timeout=120)

            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(SERVE_MESH_THREADS)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            res["requests_per_s"] = SERVE_MESH_REQUESTS / (time.perf_counter() - t0)
            res["batches"] = batcher.stats()["batches"]
            batcher.close()
            x5 = rng.standard_normal((5, v), dtype=np.float32)
            check(served.reload(other)["reloaded"] == other, f"(a) {name}: reload")
            single.reload(other)
            lsb = max(lsb, _lsb(served.reconstruct(x5), single.reconstruct(x5)))
            try:
                served.reload(wrong)
                res["refused"] = False
            except ValueError:
                res["refused"] = True
            lsb = max(lsb, _lsb(served.reconstruct(x5), single.reconstruct(x5)))
            res["lsb"] = lsb
            served.stop()
            del single
        accepted = torch.load(other, map_location="cpu", weights_only=True)
        lo, hi = mesh.model_slice(v)
        res["weights_ok"] = all(torch.equal(t.cpu(), accepted[k][:, lo:hi] if (
            model > 1 and k == "encoder.fc1.0.weight") else accepted[k])
            for k, t in served.model.state_dict().items())
        res.update(graphs=served.graphs, buckets=served.buckets,
                   shard=list(served.model.encoder.fc1[0].weight.shape))
        results[name] = res
        del served, accepted
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    results["launches"] = set_launches(0)
    out.put((rank, results))
    mesh.close()


def serve_mesh_phase(dev, preset="res64", cli_args=()):
    """Phase 18. (a) servers over ranks sharing the card over gloo against
    the single-process server's graphs, ``reload`` in place on every rank
    and a refused one; (b) their ms per call per bucket beside the
    single-process graph's, MiB broadcast and all-reduced per call, graphs
    per rank and requests/s through rank 0's ``BatchingServer``; (c) the
    serve CLI at ``--mesh data=1`` (NCCL on the card) bitwise the CLI
    without it. (d), the dry run's serving part, runs in phase 17 (d); (e),
    the checkpoint CLI's round trip, in phase 12's callback
    (:func:`ckpt_cli_phase`). Returns (launches per kernel over the phase,
    numbers)."""
    import os
    import shutil
    import signal

    import numpy as np
    import torch

    from fmri_tpu_torch.checkpoints.convert import from_jax_groups, random_groups
    from fmri_tpu_torch.configs import get_config
    from fmri_tpu_torch.eval.client import ServeClient

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "_smoke_runs", "serve_mesh")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    numbers = {"label": SERVE_MESH_LABEL}
    launches = {k: 0 for k in set_launches(0)}  # this process's and every rank's

    # (a), (b)
    for world, servers in SERVE_MESH_WORLDS.items():
        t0 = time.perf_counter()
        if preset != "res64":  # a rehearsal: the same servers at the preset given
            servers = [(n, preset, s, shape, sample) for n, _, s, shape, sample in servers]
        got = spawn_ranks(serve_mesh_rank, world, str(dev), work, servers)
        for r in range(world):
            for k, c in got[r].pop("launches").items():
                launches[k] += c
        for name, _, _, (data, model), _ in servers:
            per_rank = [got[r][name] for r in range(world)]
            res = per_rank[0]
            want_graphs = 2 * len(res["buckets"]) if dev.type == "cuda" else 0
            check(all(r["weights_ok"] for r in per_rank),
                  f"(a) {name}: a rank's weights are not its columns of the reloaded checkpoint")
            check(all(r["graphs"] == want_graphs for r in per_rank),
                  f"(a) {name}: graphs per rank {[r['graphs'] for r in per_rank]}, want "
                  f"{want_graphs}")
            check(res["lsb"] <= 1 and res["refused"],
                  f"(a) {name}: {res['lsb']} LSB from the single-process server, refused "
                  f"reload {res['refused']}")
            numbers[name] = {k: res[k] for k in ("lsb", "timed", "requests_per_s", "batches",
                                                 "warmup_s")}
            numbers[name].update(mesh=[data, model], graphs_per_rank=res["graphs"],
                                 shard=[r["shard"] for r in per_rank])
            for b, row in res["timed"].items():
                print(f"[serve_mesh] (b) {name} data={data} model={model}, bucket {b}: "
                      f"{row['mesh_ms']:.3f} ms per call (single-process graph "
                      f"{row['single_ms']:.3f} ms), {row['mib_per_call']:.3f} MiB broadcast "
                      f"and all-reduced per call on rank 0; {SERVE_MESH_LABEL}", flush=True)
            print(f"[serve_mesh] (a) {name}: within {res['lsb']} LSB of the single-process "
                  f"server over {SERVE_MESH_SIZES} rows and generate(70); reload in place on "
                  f"every rank, a refused one kept the weights; {res['graphs']} graphs per "
                  f"rank; fc1 per rank {numbers[name]['shard'][0]}; BatchingServer "
                  f"{res['requests_per_s']:.1f} requests/s ({SERVE_MESH_REQUESTS} one-row "
                  f"requests, {SERVE_MESH_THREADS} threads)", flush=True)
        numbers[f"world{world}_s"] = time.perf_counter() - t0

    # (c) the serve CLI at --mesh data=1: its NCCL group forms, and its answers
    # are the plain CLI's bit for bit (one-row requests in turn: bucket 1 each)
    t0 = time.perf_counter()
    cfg = get_config(preset)
    kind = "vae-gan-cognitive-eval"
    pth = os.path.join(work, "cli.pth")
    torch.save(from_jax_groups(random_groups(cfg, seed=4, kind=kind), cfg, kind), pth)
    procs, answers = {}, {}
    try:
        for name, extra in (("plain", []), ("mesh", ["--mesh", "data=1"])):
            procs[name] = _spawn_server(
                ["--family", "vgan", "--stage", "3", "--preset", preset, "--ckpt", pth,
                 "--unix-socket", os.path.join(work, f"{name}.sock"), *cli_args, *extra], root)
        for name, (_, lines) in procs.items():
            seen = _wait_serving(f"(c) serve CLI {name}", lines)
            mesh_line = "over a mesh data=1,model=1" in seen[-1]
            check(mesh_line == (name == "mesh"), f"(c) {name}: {seen[-1]}")
        rows = np.random.default_rng(9).standard_normal((8, cfg.model.num_voxels),
                                                        dtype=np.float32)
        for name in procs:
            with ServeClient(unix_path=os.path.join(work, f"{name}.sock"), pool=1) as c:
                answers[name] = (np.stack([c.reconstruct(r) for r in rows]), c.generate(5))
        for name, (proc, _) in procs.items():
            proc.send_signal(signal.SIGINT)
            check(proc.wait(timeout=120) == 0, f"(c) serve CLI {name} exit {proc.returncode}")
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
    bitwise = all(np.array_equal(a, b) for a, b in zip(answers["mesh"], answers["plain"]))
    check(bitwise, "(c) the serve CLI at --mesh data=1 differs from the CLI without it")
    numbers["cli_data1"] = {"bitwise_equal": bitwise, "s": time.perf_counter() - t0}
    print(f"[serve_mesh] (c) serve CLI --mesh data=1 ({'NCCL' if dev.type == 'cuda' else 'gloo'}"
          f", world 1): 8 one-row requests and generate(5) bitwise the CLI without it; "
          f"{numbers['cli_data1']['s']:.1f} s for both", flush=True)
    for k, c in set_launches(0).items():
        launches[k] += c
    check(not any(launches.values()), f"serving over a mesh launched kernels: {launches}")
    shutil.rmtree(work, ignore_errors=True)
    return launches, numbers


def ckpt_cli_phase(dev, dirs, work, preset="res64"):
    """Phase 18 (e), in phase 12's callback while phase 11's dirs exist: the
    stage-I and stage-III checkpoints through the checkpoint CLI's
    ``--export`` and back through its import; the groups come back bitwise,
    and the imported dir serves bitwise like the original."""
    import os

    import numpy as np
    import torch

    from fmri_tpu_torch.checkpoints import store, torch_import
    from fmri_tpu_torch.eval.serve import ServingModel

    t0 = time.perf_counter()
    out = {}
    for path, kind, stage in (("vgan_stage1", "vae-gan", 1),
                              ("vgan_stage3", "vae-gan-cognitive", 3)):
        pth, back = (os.path.join(work, f"{path}{ext}") for ext in (".pth", "_imported"))
        common = ["--kind", kind, "--preset", preset]
        check(torch_import.main(["--export", "-i", dirs[path], "-o", pth, *common]) == 0 and
              torch_import.main(["-i", pth, "-o", back, *common]) == 0,
              f"(e) {path}: the checkpoint CLI failed")
        a, b = store.load_eval_state(dirs[path])[0], store.load_eval_state(back)[0]
        groups_equal = a.keys() == b.keys() and all(
            torch.equal(a[g][k], v) for g in b for k, v in b[g].items())
        served = [ServingModel.from_checkpoint(d, "vgan", stage, preset, output="uint8",
                                               device=dev) for d in (dirs[path], back)]
        rng = np.random.default_rng(stage)
        shape = (64, *served[0].sample_shape())
        x = (rng.uniform(size=shape) if stage == 1 else rng.standard_normal(shape)).astype(
            np.float32)
        same = np.array_equal(served[0].reconstruct(x), served[1].reconstruct(x))
        check(groups_equal and same, f"(e) {path}: groups bitwise {groups_equal}, served "
                                     f"bitwise {same}")
        out[path] = {"groups_bitwise": groups_equal, "served_bitwise": same,
                     "pth_mib": os.path.getsize(pth) / 2**20}
    out["s"] = time.perf_counter() - t0
    print(f"[serve_mesh] (e) phase 11's stage-I and stage-III checkpoints through the "
          f"checkpoint CLI's --export and import: groups and 64 served images bitwise "
          f"({json.dumps(out)})", flush=True)
    return out


def main() -> None:
    import os

    import numpy as np
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
        from fmri_tpu_torch.metrics.inception import classify, inception_score
        from fmri_tpu_torch.metrics.quality import distractor_indices
        from fmri_tpu_torch.ops import build
        from fmri_tpu_torch.ops import ssim as ssim_ops
        from fmri_tpu_torch.ops.ssim import ssim, ssim_plain, ssim_plane_sums
    except ImportError as e:
        fail(f"run from the root of a checkout of the repository ({e})")
    # which classifier scores the IS is the smoke's choice: the proxy, and
    # Inception-v3 on phase 15's weights
    os.environ.pop("FMRI_TPU_INCEPTION_NPZ", None)

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
        m = stage("quality_metrics", lambda: quality_metrics(r, t, with_is=False))
        is_mean, is_std, proxy = stage("inception_score", lambda: inception_score(r))
        m.update(is_mean=is_mean, is_std=is_std, is_proxy=float(proxy))
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

    # the IS proxy on the card against the same proxy on the CPU, same recons
    probs, probs_cpu = classify(recons), classify(recons.cpu())
    prob_err = float(np.abs(probs - probs_cpu).max())
    is_cpu = inception_score(recons.cpu())[0]
    is_err = abs(metrics["is_mean"] - is_cpu) / is_cpu
    check(metrics["is_proxy"] == 1.0 and prob_err <= PROXY_PROB_TOL and is_err <= IS_REL_TOL,
          f"IS proxy card vs CPU: probabilities {prob_err} (bound {PROXY_PROB_TOL}), "
          f"is_mean {metrics['is_mean']} vs {is_cpu} ({is_err} relative, bound "
          f"{IS_REL_TOL}), is_proxy {metrics['is_proxy']}")
    print(f"[inference] inception score (proxy, {n} recons at 64 px, on the card): "
          f"{warm['inception_score']:.4f} s warm ({cold['inception_score']:.4f} s first); "
          f"is_mean {metrics['is_mean']:.8f}, is_std {metrics['is_std']:.3g}; card vs CPU: "
          f"probabilities {prob_err:.3g} (bound {PROXY_PROB_TOL}), is_mean {is_err:.3g} "
          f"relative (bound {IS_REL_TOL})", flush=True)

    plain_metrics = quality_metrics(recons, targets, with_is=False, ssim_fn=ssim_plain)
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
        print(f"[inference] stage I: ssim {list(a.shape)} x{count} |kernel - plain in "
              f"float64| {err:.3g}, per image {img_err:.3g}", flush=True)
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

    # 11. the training driver: whole epochs through the Trainer, the CLIs;
    # 12. serving from its checkpoint dirs, before they are deleted
    served = {}
    trainer_launches, trainer_numbers = trainer_phase(
        dev, cfg, "res64", seconds,
        then=lambda dirs, work: (
            served.update(zip(("launches", "numbers"), serve_phase(dev, dirs, work))),
            served.update(ckpt_cli=ckpt_cli_phase(dev, dirs, work))))
    for entry in train_kernels:
        entry["launches_by_path"] = {path: counts[entry["name"]]
                                     for path, counts in launches_by_path.items()}
        entry["launches_by_path"].update(
            {path: counts[entry["name"]] for path, counts in trainer_launches.items()
             if path.startswith("trainer_")})
        entry["launches_by_path"]["serve"] = served["launches"][entry["name"]]

    # 13. the host data path: the native loader, the CLIs on packed and raw data
    data_launches, data_numbers = data_phase()
    # 14. the offline ETL: the prepare CLI, then the train and inference CLIs
    #     on what it wrote; 15. Inception-v3 and the parity CLI at res100
    t0 = time.perf_counter()
    prep_launches, prep_numbers = prepare_phase()
    prep_numbers["phase_s"] = time.perf_counter() - t0
    data_launches.update(prep_launches)
    t0 = time.perf_counter()
    data_launches["is_parity"], is_numbers, ssim_res100 = is_parity_phase(dev, recons)
    is_numbers["phase_s"] = time.perf_counter() - t0
    max_err = max([max_err] + [call["max_abs_err"] for call in ssim_res100])
    # 16. the ablation experiments: bare steps, the --family exp CLI, backbones
    t0 = time.perf_counter()
    exp_launches, exp_numbers = exp_phase(dev, cfg)
    exp_numbers["phase_s"] = time.perf_counter() - t0
    data_launches.update({path: counts for path, counts in exp_launches.items()
                          if path.startswith("exp_cli_")})
    for entry in train_kernels:
        entry["launches_by_path"].update(
            {path: counts[entry["name"]] for path, counts in data_launches.items()})
        entry["launches_by_path"].update(
            {path: counts[entry["name"]] for path, counts in exp_launches.items()
             if not path.startswith("exp_cli_")})

    # 17. training across ranks: the CLI over NCCL at data=1, ranks sharing the
    #     card over gloo, Trainer.fit with a resume, the dry run
    t0 = time.perf_counter()
    mesh_launches, mesh_numbers = mesh_phase(dev, cfg)
    mesh_numbers["phase_s"] = time.perf_counter() - t0
    for entry in train_kernels:
        entry["launches_by_path"].update(
            {path: counts[entry["name"]] for path, counts in mesh_launches.items()})

    # 18. serving over ranks: ranks sharing the card over gloo against the
    #     single-process server, the CLI at --mesh data=1 over NCCL
    t0 = time.perf_counter()
    serve_mesh_launches, serve_mesh_numbers = serve_mesh_phase(dev)
    serve_mesh_numbers["ckpt_cli"] = served["ckpt_cli"]
    serve_mesh_numbers["dryrun_serving"] = mesh_numbers["d"]["serving"]
    serve_mesh_numbers["phase_s"] = time.perf_counter() - t0
    for entry in train_kernels:
        entry["launches_by_path"]["serve_mesh"] = serve_mesh_launches[entry["name"]]

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
              f"|kernel - plain in float64| {err:.3g}; per image from float64: kernel "
              f"{img_err:.3g}, fp32 plain {img_err_plain:.3g}", flush=True)
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
                                 trainer_launches["inference_trained_run"]["ssim"],
                             "serve": served["launches"]["ssim"],
                             **{path: counts["ssim"]
                                for path, counts in data_launches.items()},
                             **{path: counts["ssim"] for path, counts in mesh_launches.items()
                                if "ssim" in counts},
                             "serve_mesh": serve_mesh_launches["ssim"]},
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
        "shapes_res100": ssim_res100,
    }] + train_kernels
    print(f"[train] seconds per step at batch {cfg.train.batch_size}, both kernel flags "
          f"on (stage3_fused, wae_vgan_fused: pallas_backward only; stage1_alt: "
          f"alt_backward only; stage1_stock: no flag), host clock, warm: "
          f"{json.dumps(seconds)}", flush=True)
    print(f"[alt] cuDNN dgrad device ms per stage-I step: {json.dumps(dgrad)}", flush=True)
    print(f"[trainer] per path (host clock; epoch 1 profiled): "
          f"{json.dumps(trainer_numbers)}", flush=True)
    print(f"[serve] numbers (host clock): {json.dumps(served['numbers'])}", flush=True)
    print(f"[data] numbers (host clock): {json.dumps(data_numbers)}", flush=True)
    print(f"[prepare] numbers (host clock): {json.dumps(prep_numbers)}", flush=True)
    print(f"[is_parity] numbers (host clock): {json.dumps(is_numbers)}", flush=True)
    print(f"[exp] phase 16: {exp_numbers['phase_s']:.1f} s; seconds per step at batch "
          f"{cfg.train.batch_size}, both kernel flags on (host clock, warm): "
          f"{json.dumps(exp_numbers['s_per_step'])}; device busy share of a profiled step: "
          f"{json.dumps(exp_numbers['busy_share'])}", flush=True)
    print(f"[mesh] phase 17: {mesh_numbers['phase_s']:.1f} s. (b)'s times are of ranks "
          f"sharing one card over gloo, whose collectives go through the host: they show "
          f"the paths run and are not NCCL or several-card times", flush=True)
    print(f"[mesh] numbers (host clock; gloo, one shared card): {json.dumps(mesh_numbers)}",
          flush=True)
    print(f"[serve_mesh] phase 18: {serve_mesh_numbers['phase_s']:.1f} s. Numbers (host "
          f"clock; {SERVE_MESH_LABEL}): {json.dumps(serve_mesh_numbers)}", flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
