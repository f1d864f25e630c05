"""The port on the card (``cuda`` marker; each test skips without one): the
SSIM, BatchNorm-backward and weight-grad kernels against their plain
versions, the wrappers' checks, the inference, serving and stage-I train
paths on the card against the same paths on the CPU, serving's CUDA graphs
against its eager programs (with ``reload`` under them, and a failed
capture raising), the stage-II/III and
WAE train steps with the kernels against the library backward, with their
launches per step, ``alt_backward``'s rewrites against cuDNN's grads, the
``Trainer``'s epochs bitwise reproducible with its defaults, the native
``Batches`` gather bitwise numpy's on the card's host, and the Inception
Score's classifiers (the proxy, Inception-v3) on the card against the CPU,
and training across ranks: a mesh of one rank over NCCL bitwise the step
without a mesh, ranks sharing the card over gloo against the single-process
step on the card (``tests/test_torch_mesh.py``'s workers and checks), and
the train CLI refusing more ranks than cards; and serving over ranks
sharing the card against the single-process server's graphs, with no
collective inside a captured graph.

Imports only torch, numpy and the port, so it runs where the JAX package's
dependencies are not installed:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Tolerances: SSIM kernel vs plain 1e-5 on the means (fp32 both sides,
different summation orders); card vs CPU images 1e-4 (cuDNN may pick FFT or
Winograd convolutions, whose fp32 rounding differs from the CPU's direct
convolution by a few 1e-6 on these weights); n-way fractions within 1/N."""

import json
import os

import numpy as np
import pytest
import torch
from torch_port_helpers import (  # noqa: F401
    EXP_LAUNCHES, cuda_device, port_model, uniform_pair)

from fmri_tpu_torch.checkpoints.convert import random_groups
from fmri_tpu_torch.configs import get_config
from fmri_tpu_torch.data.synthetic import synthetic_pairs
from fmri_tpu_torch.eval import evaluate
from fmri_tpu_torch.eval.serve import ServingModel
from fmri_tpu_torch.ops import bn as port_bn
from fmri_tpu_torch.ops import dw as port_dw
from fmri_tpu_torch.ops import ssim as port

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("batch,size", [(4, 8), (4, 16), (4, 64), (4, 100),
                                        (1024, 64), (10240, 64), (256, 100)])
def test_kernel_matches_plain(cuda_device, batch, size):
    """Small images (the generic k < 11 instance at 8 px), res100's 15
    bands, the inference run's 1,024 and 10,240 images at 64 px, and a
    res100 validation split of 256 images."""
    a, b = uniform_pair((batch, size, size, 3), seed=size + batch)
    ta, tb = torch.from_numpy(a).to(cuda_device), torch.from_numpy(b).to(cuda_device)
    before = port.ssim_plane_sums.launches
    for mode in (True, False):
        got = port.ssim(ta, tb, size_average=mode)
        ref = port.ssim_plain(ta, tb, size_average=mode)
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), atol=1e-5)
    assert float(port.ssim(ta, ta)) == pytest.approx(1.0, abs=1e-5)
    assert port.ssim_plane_sums.launches == before + 3
    # deterministic: fixed-order reductions inside the block
    assert torch.equal(port.ssim_plane_sums(ta, tb), port.ssim_plane_sums(ta, tb))


def test_kernel_wrapper_checks(cuda_device):
    a = torch.rand((2, 16, 16, 3), device=cuda_device)
    with pytest.raises(TypeError):
        port.ssim_plane_sums(a.double(), a.double())
    with pytest.raises(ValueError, match="contiguous"):
        port.ssim_plane_sums(a.transpose(1, 2), a.transpose(1, 2))
    with pytest.raises(ValueError, match="differ"):
        port.ssim_plane_sums(a, a[:1])
    with pytest.raises(ValueError, match="CUDA"):
        port.ssim_plane_sums(a, a.cpu())


@pytest.fixture(scope="module")
def tiny():
    cfg = get_config("tiny")
    data = synthetic_pairs(32, cfg.data.image_size, cfg.model.num_voxels, seed=0)
    return cfg, random_groups(cfg, seed=3), data


def test_evaluation_on_the_card_matches_the_cpu(cuda_device, tiny):
    cfg, groups, data = tiny
    batches = [{k: v[lo:lo + 8] for k, v in data.items()} for lo in range(0, 32, 8)]
    results = {}
    for dev in (cuda_device, torch.device("cpu")):
        before = port.ssim_plane_sums.launches
        r, t = evaluate.reconstruct_dataset(port_model(groups, cfg, dev), batches)
        results[dev.type] = (r.cpu(), evaluate.quality_metrics(r, t),
                             evaluate.objective_scores(r, t),
                             port.ssim_plane_sums.launches - before)
    card, cpu = results["cuda"], results["cpu"]
    np.testing.assert_allclose(card[0].numpy(), cpu[0].numpy(), atol=1e-4)
    for k in ("pcc", "ssim", "mse"):
        assert card[1][k] == pytest.approx(cpu[1][k], abs=1e-5), k
    assert card[1]["is_mean"] == pytest.approx(cpu[1]["is_mean"], rel=1e-5)
    for k in ("pcc", "ssim"):
        np.testing.assert_allclose(card[2][k], cpu[2][k], atol=1.0 / 32 + 1e-12)
    assert (card[3], cpu[3]) == (4, 0)  # one launch per SSIM call, none on the CPU


def test_serving_on_the_card_matches_the_cpu(cuda_device, tiny):
    cfg, groups, data = tiny
    x = data["fmri"][:11]
    card = ServingModel(cfg, port_model(groups, cfg), max_batch=8, device=cuda_device)
    cpu = ServingModel(cfg, port_model(groups, cfg), max_batch=8, device="cpu")
    np.testing.assert_allclose(card.reconstruct(x), cpu.reconstruct(x), atol=1e-4)
    assert card.generate(3).shape == (3, 16, 16, 3)


# ------------------------------------------------ the train kernels and step

# the 9 shapes of the res64 step's BatchNorm backward, a ragged S (21 and
# 25: heads and tails around the 16-byte vectors) and [N, C] (S = 1)
BN_SHAPES = [(192, 128, 32, 32), (64, 64, 64, 64), (192, 256, 16, 16),
             (64, 128, 32, 32), (64, 256, 16, 16), (64, 128, 16, 16),
             (64, 64, 32, 32), (64, 256, 8, 8), (192, 256, 8, 8),
             (5, 3, 7, 3), (3, 5, 5, 5), (64, 1024), (7, 5)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BN_SHAPES)
def test_bn_kernels_match_plain(cuda_device, shape, dtype):
    """BN reduce and apply at the res64 step's shapes and the edge cases
    above, fp32 and bf16: within 1e-5 of the plain
    version's largest magnitude (fp32 sums in another order), and the same
    bits from run to run."""
    g = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    x = (torch.randn(shape, generator=g, device=cuda_device) * 2 + 0.5).to(dtype)
    dy = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    dims = [0] + list(range(2, len(shape)))
    mu = x.float().mean(dims)
    inv = torch.rsqrt(x.float().var(dims, unbiased=False) + 1e-5)
    gamma, a0, a1 = torch.randn((3, shape[1]), generator=g, device=cuda_device).unbind(0)
    before = (port_bn.bn_bwd_reduce.launches, port_bn.bn_bwd_apply.launches)
    sums = port_bn.bn_bwd_reduce(x, dy, mu, inv)
    ref = port_bn.bn_bwd_reduce_plain(x, dy, mu, inv)
    for got_row, ref_row in zip(sums, ref):
        assert float((got_row - ref_row).abs().max()) <= 1e-5 * float(ref_row.abs().max())
    assert torch.equal(sums, port_bn.bn_bwd_reduce(x, dy, mu, inv))
    a0, a1 = a0.contiguous(), a1.contiguous()
    dx = port_bn.bn_bwd_apply(x, dy, mu, inv, gamma, sums, a0, a1)
    ref_dx = port_bn.bn_bwd_apply_plain(x, dy, mu, inv, gamma, sums, a0, a1)
    assert float((dx - ref_dx).abs().max()) <= 1e-5 * float(ref_dx.abs().max())
    assert torch.equal(dx, port_bn.bn_bwd_apply(x, dy, mu, inv, gamma, sums, a0, a1))
    assert (port_bn.bn_bwd_reduce.launches, port_bn.bn_bwd_apply.launches) == (
        before[0] + 2, before[1] + 2)


DW_CASES = [("conv", 192, 3, 64, 32, 1), ("conv", 64, 64, 32, 128, 2),
            ("conv", 64, 64, 64, 3, 1), ("deconv", 64, 256, 8, 256, 2),
            ("deconv", 64, 128, 32, 64, 2), ("conv", 3, 5, 9, 7, 2),
            ("conv", 192, 128, 32, 256, 2), ("conv", 192, 256, 16, 256, 2)]


# |kernel - plain| over the plain result's largest magnitude. fp32: 3xTF32
# reads 3e-6 to 4e-6 at the res64 step's shapes on an H100, and a kernel that lets
# the tensor core accumulate a split's stages read 7.4e-5, so 2e-5 tells them
# apart; single-pass TF32 is further off. bf16: exact products, fp32 sums.
DW_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-4}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,b,ci,h,co,stride", DW_CASES)
def test_dw_kernel_matches_plain(cuda_device, kind, b, ci, h, co, stride, dtype):
    """The weight-grad kernel at res64 step shapes (the last two: the
    discriminator's 128->256 and 256->256 stride-2 convs at batch 192) and
    one ragged shape (PH*PW = 25: no TMA box, the plain-load path): within
    ``DW_TOL`` of the plain version's largest magnitude (fp32 operands as
    3xTF32, bf16 operands exact in fp32, sums in fp32), and the same bits
    from run to run."""
    g = torch.Generator(device=cuda_device).manual_seed(b + ci + h + co)
    x = torch.randn((b, ci, h, h), generator=g, device=cuda_device).to(dtype)
    if kind == "conv":
        oh = (h + 4 - 5) // stride + 1
        dy = torch.randn((b, co, oh, oh), generator=g, device=cuda_device).to(dtype)
        got, ref = port_dw.conv2d_dw(x, dy, stride, 2, 5), port_dw.conv2d_dw_plain(x, dy, stride, 2, 5)
        again = port_dw.conv2d_dw(x, dy, stride, 2, 5)
    else:
        dy = torch.randn((b, co, 2 * h, 2 * h), generator=g, device=cuda_device).to(dtype)
        got = port_dw.conv2d_transpose_dw(x, dy, 2, 2, 1, 5)
        ref = port_dw.conv2d_transpose_dw_plain(x, dy, 2, 2, 1, 5)
        again = port_dw.conv2d_transpose_dw(x, dy, 2, 2, 1, 5)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert float((got - ref).abs().max()) <= DW_TOL[dtype] * float(ref.abs().max())
    assert torch.equal(got, again)


# (S, U, stride) of the res100 step's weight grads at its batch of 100: the
# encoder, the decoder's deconvs (S = dy, U = x) and out conv, and the
# discriminator's two narrowest convs (batch 300). U rows of 625 or 169
# positions, or S rows of 25 or 13 columns, are not whole 16-byte units, so
# these take the plain-load path (all of them with bf16 operands).
RES100_DW = [((100, 3, 100, 100), (100, 64, 50, 50), 2),
             ((100, 64, 50, 50), (100, 128, 25, 25), 2),
             ((100, 128, 25, 25), (100, 256, 13, 13), 2),
             ((100, 256, 25, 25), (100, 256, 13, 13), 2),
             ((100, 128, 50, 50), (100, 256, 25, 25), 2),
             ((100, 64, 100, 100), (100, 128, 50, 50), 2),
             ((100, 64, 100, 100), (100, 3, 100, 100), 1),
             ((300, 128, 25, 25), (300, 256, 13, 13), 2),
             ((300, 256, 13, 13), (300, 256, 7, 7), 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s_shape,u_shape,stride", RES100_DW)
def test_dw_kernel_res100_shapes_are_reproducible(cuda_device, s_shape, u_shape, stride,
                                                  dtype):
    """The weight-grad kernel at the res100 step's shapes, most of them on
    the plain-load path: within ``DW_TOL`` of the plain version, and the same
    bits in four runs."""
    g = torch.Generator(device=cuda_device).manual_seed(sum(s_shape) + sum(u_shape))
    s = torch.randn(s_shape, generator=g, device=cuda_device).to(dtype)
    u = torch.randn(u_shape, generator=g, device=cuda_device).to(dtype)
    runs = [port_dw.tap_matmul(s, u, 5, stride, 2) for _ in range(4)]
    ref = port_dw.tap_matmul_plain(s, u, 5, stride, 2)
    assert runs[0].shape == ref.shape == (u_shape[1], s_shape[1], 5, 5)
    assert float((runs[0] - ref).abs().max()) <= DW_TOL[dtype] * float(ref.abs().max())
    assert all(torch.equal(runs[0], r) for r in runs[1:])


def test_train_wrappers_check_their_operands(cuda_device):
    x = torch.randn((4, 3, 8, 8), device=cuda_device)
    v = torch.ones(3, device=cuda_device)
    with pytest.raises(ValueError, match="devices"):
        port_bn.bn_bwd_reduce(x, x.cpu(), v, v)
    with pytest.raises(TypeError):
        port_bn.bn_bwd_reduce(x.double(), x.double(), v, v)
    with pytest.raises(TypeError):
        port_bn.bn_bwd_apply(x, x.bfloat16(), v, v, v, torch.ones((2, 3), device=cuda_device), v, v)
    with pytest.raises(ValueError, match="contiguous"):
        port_bn.bn_bwd_reduce(x.transpose(2, 3), x.transpose(2, 3), v, v)
    dy = torch.randn((4, 5, 8, 8), device=cuda_device)
    with pytest.raises(ValueError, match="operands on"):
        port_dw.conv2d_dw(x, dy.cpu(), 1, 2, 5)
    with pytest.raises(TypeError):
        port_dw.conv2d_dw(x.half(), dy.half(), 1, 2, 5)
    with pytest.raises(ValueError, match="contiguous"):
        port_dw.conv2d_dw(x.transpose(2, 3), dy, 1, 2, 5)


def test_train_step_on_the_card_matches_the_cpu(cuda_device):
    """The stage-I step at tiny with both kernel flags on, on the card
    (kernels) and on the CPU (plain versions), from the same state and
    noise: losses within 1e-5 relative, parameters, moments and BN running
    statistics within 1e-3 relative in L2 per tensor (parameters: of how far
    the CPU step moved them); every kernel launched."""
    import dataclasses

    from fmri_tpu_torch.checkpoints.convert import from_jax_groups
    from fmri_tpu_torch.train.optim import RmsProp
    from fmri_tpu_torch.train.state import GROUPS, VaeGan, make_state
    from fmri_tpu_torch.train.steps_vgan import make_vgan_stage1_step

    cfg = get_config("tiny")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, pallas_bn=True, pallas_backward=True))
    weights = from_jax_groups(random_groups(cfg, 0, "vae-gan"), cfg, "vae-gan")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(-1, 1, (8, 16, 16, 3)).astype(np.float32))
    eps, z_p = (torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32))
                for _ in range(2))
    fns = make_vgan_stage1_step(cfg)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        nets = VaeGan(cfg)
        nets.load_state_dict(weights, strict=True)
        state = make_state(nets.to(dev), {g: RmsProp() for g in GROUPS})
        for moments in state.opt_state.values():
            for v in moments.values():
                v.fill_(1.0)
        before = (port_bn.bn_bwd_reduce.launches, port_bn.bn_bwd_apply.launches,
                  port_dw.tap_matmul.launches)
        state, m = fns.train_step(state, x.to(dev), eps.to(dev), z_p.to(dev),
                                  0.35, 0.68, 1e-6)
        after = (port_bn.bn_bwd_reduce.launches, port_bn.bn_bwd_apply.launches,
                 port_dw.tap_matmul.launches)
        out[dev.type] = (state, m, [a - b for a, b in zip(after, before)])
    (card, m_card, n_card), (cpu, m_cpu, n_cpu) = out["cuda"], out["cpu"]
    assert all(n > 0 for n in n_card) and n_cpu == [0, 0, 0]
    for k in m_cpu:
        assert float(m_card[k]) == pytest.approx(float(m_cpu[k]), rel=1e-5, abs=1e-7), k
    sd_card, sd_cpu = card.nets.state_dict(), cpu.nets.state_dict()
    for k, ref in sd_cpu.items():
        got = sd_card[k].cpu()
        if k.endswith("num_batches_tracked"):
            assert torch.equal(got, ref)
            continue
        scale = ref if "running" in k else ref - weights[k]
        assert float((got - ref).norm()) <= 1e-3 * max(float(scale.norm()), 1e-12), k
    for g in GROUPS:
        for k, ref in cpu.opt_state[g].items():
            got = card.opt_state[g][k].cpu()
            assert float((got - ref).norm()) <= 1e-3 * float(ref.norm()), (g, k)


def test_res64_step_launches_the_weight_grad_15_times(cuda_device):
    """One res64 stage-I step with both kernel flags on launches
    ``tap_matmul`` once per conv/deconv weight use the step updates:
    encoder 3, decoder 4 in each of its two passes, discriminator 4. The
    pullbacks to x_tilde, x_p and z alone launch none. Batch 8: the count
    does not depend on it."""
    import dataclasses

    from fmri_tpu_torch.checkpoints.convert import from_jax_groups
    from fmri_tpu_torch.train.optim import RmsProp
    from fmri_tpu_torch.train.state import GROUPS, VaeGan, make_state
    from fmri_tpu_torch.train.steps_vgan import make_vgan_stage1_step

    cfg = get_config("res64")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, pallas_bn=True, pallas_backward=True))
    nets = VaeGan(cfg)
    nets.load_state_dict(from_jax_groups(random_groups(cfg, 0, "vae-gan"), cfg,
                                         "vae-gan"), strict=True)
    state = make_state(nets.to(cuda_device), {g: RmsProp() for g in GROUPS})
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.rand((8, 64, 64, 3), generator=g, device=cuda_device) * 2 - 1
    eps, z_p = (torch.randn((8, cfg.model.latent_dim), generator=g, device=cuda_device)
                for _ in range(2))
    before = port_dw.tap_matmul.launches
    make_vgan_stage1_step(cfg).train_step(state, x, eps, z_p, 0.35, 0.68, 1e-6)
    torch.cuda.synchronize()
    assert port_dw.tap_matmul.launches - before == 15


# ------------------------------------------------ the cognitive steps

COGNITIVE_LAUNCHES = {2: (8, 8, 4), 3: (11, 11, 12)}


def _cognitive_state(cfg, stage, device):
    from fmri_tpu_torch.checkpoints.convert import from_jax_groups
    from fmri_tpu_torch.train.state import VaeGanCognitiveTrain, make_cognitive_state

    weights = from_jax_groups(random_groups(cfg, 0, "vae-gan-cognitive"), cfg,
                              "vae-gan-cognitive")
    nets = VaeGanCognitiveTrain(cfg)
    nets.load_state_dict(weights, strict=True)
    state = make_cognitive_state(nets.to(device), cfg, stage)
    for moments in state.opt_state.values():
        for v in moments.values():
            v.fill_(1.0)
    return state, weights


def _cognitive_inputs(cfg, b, device):
    rng = np.random.default_rng(0)
    c = cfg.model
    fmri = rng.normal(size=(b, c.num_voxels)).astype(np.float32)
    image = rng.uniform(-1, 1, (b, c.image_size, c.image_size, 3)).astype(np.float32)
    noise = [rng.normal(size=(b, c.latent_dim)).astype(np.float32) for _ in range(3)]
    return [torch.from_numpy(a).to(device) for a in (fmri, image, *noise)]


def _launches():
    return (port_bn.bn_bwd_reduce.launches, port_bn.bn_bwd_apply.launches,
            port_dw.tap_matmul.launches)


@pytest.mark.parametrize("stage", [2, 3])
def test_cognitive_step_kernels_match_the_library_on_the_card(cuda_device, stage):
    """The stage-II (with the teacher) and stage-III steps at tiny with both
    kernel flags on against the same step with both off, on the card, from
    the same state and noise: losses within 1e-5 relative, parameters,
    moments and BN running statistics within 1e-3 relative in L2 per tensor
    (parameters: of how far the flags-off step moved them); the kernels
    launched exactly as counted on the CPU (``tests/test_torch_cognitive.py``)."""
    import dataclasses

    from fmri_tpu_torch.train.steps_vgan import make_vgan_cognitive_step

    cfg = get_config("tiny")
    out = {}
    for flags in (True, False):
        c = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, pallas_bn=flags, pallas_backward=flags))
        state, weights = _cognitive_state(c, stage, cuda_device)
        before = _launches()
        state, m = make_vgan_cognitive_step(c, stage).train_step(
            state, *_cognitive_inputs(c, 8, cuda_device), 0.35, 0.68, 1e-6)
        torch.cuda.synchronize()
        out[flags] = (state, m, tuple(a - b for a, b in zip(_launches(), before)))
    (on, m_on, n_on), (off, m_off, n_off) = out[True], out[False]
    assert n_on == COGNITIVE_LAUNCHES[stage] and n_off == (0, 0, 0)
    for k in m_off:
        assert float(m_on[k]) == pytest.approx(float(m_off[k]), rel=1e-5, abs=1e-7), k
    sd_on, sd_off = on.nets.state_dict(), off.nets.state_dict()
    for k, ref in sd_off.items():
        got, ref = sd_on[k].cpu(), ref.cpu()
        if k.endswith("num_batches_tracked"):
            assert torch.equal(got, ref)
            continue
        scale = ref if "running" in k else ref - weights[k]
        assert float((got - ref).norm()) <= 1e-3 * max(float(scale.norm()), 1e-12), k
    for g, moments in off.opt_state.items():
        for k, ref in moments.items():
            got = on.opt_state[g][k].cpu()
            assert float((got - ref.cpu()).norm()) <= 1e-3 * float(ref.norm()), (g, k)


@pytest.mark.parametrize("stage,fused", [(2, False), (3, False), (3, True)])
def test_res64_cognitive_step_launches(cuda_device, stage, fused):
    """One res64 cognitive step at batch 8 launches each kernel as counted on
    the CPU: stage II 8/8/4, stage III 11/11/12; stage III with the fused
    decoder batch (``pallas_bn`` off) launches ``tap_matmul`` 8 times."""
    import dataclasses

    from fmri_tpu_torch.train.steps_vgan import make_vgan_cognitive_step

    cfg = get_config("res64")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, pallas_bn=not fused, pallas_backward=True, fused_decoder_batch=fused))
    state, _ = _cognitive_state(cfg, stage, cuda_device)
    before = _launches()
    make_vgan_cognitive_step(cfg, stage).train_step(
        state, *_cognitive_inputs(cfg, 8, cuda_device), 0.35, 0.68, 1e-6)
    torch.cuda.synchronize()
    got = tuple(a - b for a, b in zip(_launches(), before))
    assert got == ((0, 0, 8) if fused else COGNITIVE_LAUNCHES[stage])


# ------------------------------------------------ alt_backward's rewrites

# (batch, in channels, spatial, out channels) of the k5/p2/s2 convs whose dx
# the phases take: res64's encoder and discriminator blocks, res100's even
# encoder layers
ALT_DX = [(8, 64, 32, 128), (8, 128, 16, 256), (8, 32, 64, 128), (8, 256, 16, 256),
          (8, 3, 100, 64), (8, 64, 50, 128)]


def _library_grad(dy, x, w, stride, which):
    """``convolution_backward``'s input (0) or weight (1) grad, padding 2,
    in the operands' dtype."""
    return torch.ops.aten.convolution_backward(
        dy, x, w, None, [stride] * 2, [2, 2], [1, 1], False, [0, 0], 1,
        [which == 0, which == 1, False])[which]


@pytest.mark.parametrize("b,ci,h,co", ALT_DX)
def test_dx_phases_match_the_library(cuda_device, b, ci, h, co):
    """The phase input grad against cuDNN's (``convolution_backward``) on
    the same operands in float64: 1e-5 relative to the largest value; and
    within the same bound of cuDNN's fp32 input grad (TF32 off)."""
    from fmri_tpu_torch.ops import conv_alt

    g = torch.Generator(device=cuda_device).manual_seed(h + ci)
    w = 0.05 * torch.randn((co, ci, 5, 5), generator=g, device=cuda_device)
    dy = torch.randn((b, co, h // 2, h // 2), generator=g, device=cuda_device)
    x = torch.zeros((b, ci, h, h), device=cuda_device)
    got = conv_alt.conv2d_dx_phases(dy, w, (h, h))
    for ref in (_library_grad(dy.double(), x.double(), w.double(), 2, 0),
                _library_grad(dy, x, w, 2, 0)):
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("h", [64, 100])
def test_dw_patches_match_the_library_in_float64(cuda_device, h):
    """The decoder's 64 -> 3 out conv at res64 and res100: the patches
    weight grad against cuDNN's in float64, 1e-5 relative to the largest
    value. (cuDNN's own fp32 weight grad of this conv, TF32 off, sits
    0.3-1.6% of the largest value from float64 on an H100; it is not a
    reference here.)"""
    from fmri_tpu_torch.ops import conv_alt

    g = torch.Generator(device=cuda_device).manual_seed(h)
    x = torch.rand((8, 64, h, h), generator=g, device=cuda_device)
    dy = 0.01 * torch.randn((8, 3, h, h), generator=g, device=cuda_device)
    ref = _library_grad(dy.double(), x.double(),
                        torch.zeros((3, 64, 5, 5), device=cuda_device).double(), 1, 1)
    got = conv_alt.conv2d_dw_patches(x, dy, 2, 5)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_alt_backward_odd_layer_falls_back(cuda_device, monkeypatch):
    """res100's 25 px layer cannot split into phases: the phases never run
    there and the routed conv's grads are the stock ones (1e-5 relative:
    cuDNN's input grad of this shape is not bitwise the same twice); the
    50 px layer before it takes them (1e-5 relative)."""
    from fmri_tpu_torch.ops import conv, conv_alt

    calls = []
    orig = conv_alt.conv2d_dx_phases
    monkeypatch.setattr(conv_alt, "conv2d_dx_phases",
                        lambda *a: calls.append(a[0].shape) or orig(*a))
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for h, ci, co in ((25, 128, 256), (50, 64, 128)):
        x = torch.randn((4, ci, h, h), generator=g, device=cuda_device, requires_grad=True)
        w = (0.05 * torch.randn((co, ci, 5, 5), generator=g, device=cuda_device)
             ).requires_grad_()
        grads = [torch.autograd.grad(conv.conv2d(x, w, 2, 2, alt_backward=alt).square().sum(),
                                     [x, w]) for alt in (True, False)]
        for got, ref in zip(*grads):
            assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert [s[-1] for s in calls] == [25]  # dy of the 50 px layer only


# ------------------------------------------------ the WAE steps

# launches per step with both kernel flags on (tests/test_torch_wae*.py)
WAE_LAUNCHES = {"wae_stage1": (6, 6, 7), "wae_stage2": (3, 3, 0), "wae_stage3": (3, 3, 4),
                "wae_vgan": (17, 17, 15)}


def _wae_run(cfg, path, device, b, flags, fused=False):
    """One step of a WAE path from seeded weights, warmed moments and seeded
    inputs: (state, metrics, launches, start weights)."""
    import dataclasses

    from fmri_tpu_torch.checkpoints.convert import from_jax_groups
    from fmri_tpu_torch.train import state as st
    from fmri_tpu_torch.train.optim import AdamState
    from fmri_tpu_torch.train.steps_wae import (
        make_wae_cognitive_step, make_wae_stage1_step, make_wae_vgan_step,
    )

    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, pallas_bn=flags and not fused, pallas_backward=flags,
        fused_decoder_batch=fused))
    kind, module, make, step = {
        "wae_stage1": ("wae-gan", st.WaeGan, st.make_wae_state, make_wae_stage1_step(cfg)),
        "wae_stage2": ("wae-gan-cognitive", st.WaeGanCognitiveTrain,
                       lambda n, c: st.make_wae_cognitive_state(n, c, 2),
                       make_wae_cognitive_step(cfg, 2)),
        "wae_stage3": ("wae-gan-cognitive", st.WaeGanCognitiveTrain,
                       lambda n, c: st.make_wae_cognitive_state(n, c, 3),
                       make_wae_cognitive_step(cfg, 3)),
        "wae_vgan": ("wae-vgan", st.WaeDualGan, st.make_wae_dual_gan_state,
                     make_wae_vgan_step(cfg))}[path]
    weights = from_jax_groups(random_groups(cfg, 0, kind), cfg, kind)
    nets = module(cfg)
    nets.load_state_dict(weights, strict=True)
    state = make(nets.to(device), cfg)
    for m in state.opt_state.values():
        for v in (m.nu if isinstance(m, AdamState) else m).values():
            v.fill_(1.0)
    fmri, image, *noise = _cognitive_inputs(cfg, b, device)
    args = {"wae_stage1": (image, 0.5 * noise[0]), "wae_stage2": (fmri, image),
            "wae_stage3": (fmri, image),
            "wae_vgan": (image, noise[0], noise[1], 0.5 * noise[2], 0.35, 0.68, 1e-6)}[path]
    before = _launches()
    state, m = step.train_step(state, *args)
    torch.cuda.synchronize()
    return state, m, tuple(a - b for a, b in zip(_launches(), before)), weights


@pytest.mark.parametrize("path", sorted(WAE_LAUNCHES))
def test_wae_step_kernels_match_the_library_on_the_card(cuda_device, path):
    """Each WAE step at tiny with both kernel flags on against the same step
    with both off, on the card, from the same state and inputs: losses
    within 1e-5 relative; parameters, moments and BN running statistics
    within 1e-3 relative in L2 per tensor (parameters: of how far the
    flags-off step moved them); the kernels launched as counted on the CPU."""
    from fmri_tpu_torch.train.optim import AdamState

    cfg = get_config("tiny")
    on, m_on, n_on, weights = _wae_run(cfg, path, cuda_device, 8, True)
    off, m_off, n_off, _ = _wae_run(cfg, path, cuda_device, 8, False)
    assert n_on == WAE_LAUNCHES[path] and n_off == (0, 0, 0)
    for k in m_off:
        assert float(m_on[k]) == pytest.approx(float(m_off[k]), rel=1e-5, abs=1e-7), k
    sd_on = on.nets.state_dict()
    for k, ref in off.nets.state_dict().items():
        got, ref = sd_on[k].cpu(), ref.cpu()
        if k.endswith("num_batches_tracked"):
            assert torch.equal(got, ref)
            continue
        scale = ref if "running" in k else ref - weights[k]
        assert float((got - ref).norm()) <= 1e-3 * max(float(scale.norm()), 1e-12), k
    for g, moments in off.opt_state.items():
        pairs = ([(on.opt_state[g].mu, moments.mu), (on.opt_state[g].nu, moments.nu)]
                 if isinstance(moments, AdamState) else [(on.opt_state[g], moments)])
        for got_m, ref_m in pairs:
            for k, ref in ref_m.items():
                got = got_m[k].cpu()
                assert float((got - ref.cpu()).norm()) <= 1e-3 * max(
                    float(ref.norm()), 1e-12), (g, k)


@pytest.mark.parametrize("path", sorted(WAE_LAUNCHES) + ["wae_vgan_fused"])
def test_res64_wae_step_launches(cuda_device, path):
    """One res64 WAE step at batch 8 launches each kernel as counted on the
    CPU; WAE/Dual-GAN with the fused decoder batch (``pallas_bn`` off)
    launches ``tap_matmul`` 11 times."""
    fused = path == "wae_vgan_fused"
    _, _, got, _ = _wae_run(get_config("res64"), "wae_vgan" if fused else path,
                            cuda_device, 8, True, fused)
    assert got == ((0, 0, 11) if fused else WAE_LAUNCHES[path])


class _HostDraws:
    """The trainer's default draws taken on the CPU and moved to the
    device, so a run on the card and one on the CPU draw the same numbers
    (the card's generators are another algorithm)."""

    def __init__(self, seed):
        from fmri_tpu_torch.train.trainer import Draws

        self.draws = Draws(seed)

    def train(self, epoch, index, spec):
        flip, shifts, noise = self.draws.train(epoch, index,
                                               spec._replace(device=torch.device("cpu")))
        put = (lambda t: None if t is None else t.to(spec.device))  # noqa: E731
        return put(flip), put(shifts), {k: put(v) for k, v in noise.items()}

    def eval(self, epoch, stream, device):
        draws = self.draws.eval(epoch, stream, torch.device("cpu"))

        class Moved:
            def eps(self, n, latent):
                return draws.eps(n, latent).to(device)

            def z_p(self, n, latent):
                return draws.z_p(n, latent).to(device)

        return Moved()


def test_trainer_epoch_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """One ``tiny`` stage-I epoch through the ``Trainer`` with both kernel
    flags on, on the card and on the CPU, from the same weights and draws:
    the same ``results.csv`` columns, losses within 1e-5 relative and
    metrics within 1e-4; parameters within 1e-3 of how far the CPU epoch
    moved them (L2 per tensor); the kernels launched on the card only, two
    SSIM launches (the valid and train-metric passes)."""
    import csv
    import dataclasses

    from fmri_tpu_torch.data.synthetic import synthetic_images
    from fmri_tpu_torch.train import stages
    from fmri_tpu_torch.train.trainer import Trainer

    cfg = get_config("tiny")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, pallas_bn=True, pallas_backward=True))
    imgs, _ = synthetic_images(40, 16, seed=0)
    runs = {}
    for dev in (cuda_device, torch.device("cpu")):
        state, steps, kw = stages.vgan_stage1(cfg, steps_per_epoch=4, seed=8, device=dev)
        start = {k: v.detach().cpu().clone() for k, v in state.nets.state_dict().items()}
        run_dir = tmp_path / dev.type
        run_dir.mkdir()
        before = (port_bn.bn_bwd_reduce.launches, port_dw.tap_matmul.launches,
                  port.ssim_plane_sums.launches)
        state = Trainer(cfg, steps, str(run_dir), draws=_HostDraws(8), tensorboard=False,
                        **kw).fit(state, imgs[8:], imgs[:8], n_epochs=1)
        after = (port_bn.bn_bwd_reduce.launches, port_dw.tap_matmul.launches,
                 port.ssim_plane_sums.launches)
        with open(run_dir / "results.csv") as f:
            runs[dev.type] = (state, list(csv.DictReader(f))[0], start,
                              [a - b for a, b in zip(after, before)])
    card, row_card, start, n_card = runs["cuda"]
    cpu, row_cpu, _, n_cpu = runs["cpu"]
    assert n_card[0] > 0 and n_card[1] == 4 * 15 and n_card[2] == 2 and n_cpu == [0, 0, 0]
    assert list(row_card) == list(row_cpu)
    for k in row_cpu:
        g, w = float(row_card[k]), float(row_cpu[k])
        tol = 1e-4 if k.startswith(("valid_", "train_P", "train_S", "train_M")) else 1e-5 * abs(w)
        assert abs(g - w) <= max(tol, 1e-7), (k, g, w)
    sd_cpu = cpu.nets.state_dict()
    for k, v in card.nets.state_dict().items():
        if v.is_floating_point() and "running" not in k:
            ref = sd_cpu[k]
            assert float((v.cpu() - ref).norm()) <= 1e-3 * float((ref - start[k]).norm()), k


def test_store_round_trip_of_a_state_on_the_card(cuda_device, tmp_path):
    """A CUDA train state saved (host copies) and restored onto the card,
    bit for bit."""
    from fmri_tpu_torch.checkpoints import store
    from fmri_tpu_torch.train.state import init_wae, make_wae_state

    cfg = get_config("tiny")
    live = make_wae_state(init_wae(cfg, 0).to(cuda_device), cfg)
    with torch.no_grad():
        for m in (live.opt_state["encoder"].mu, live.opt_state["decoder"].nu):
            for v in m.values():
                v.uniform_()
    live.step.fill_(5)
    writer = store.AsyncCheckpointWriter()
    writer.save(str(tmp_path), 0, live)
    writer.wait()
    fresh = make_wae_state(init_wae(cfg, 1).to(cuda_device), cfg)
    restored, meta = store.restore_checkpoint(str(tmp_path), fresh)
    assert meta["epoch"] == 0 and restored.step.device.type == "cuda"
    for k, v in live.nets.state_dict().items():
        got = restored.nets.state_dict()[k]
        assert got.device.type == "cuda" and torch.equal(got, v), k
    for g in live.opt_state:
        for a, b in ((live.opt_state[g].mu, restored.opt_state[g].mu),
                     (live.opt_state[g].nu, restored.opt_state[g].nu)):
            for k in a:
                assert torch.equal(a[k], b[k]), (g, k)


def test_device_iterator_delivers_pinned_batches_in_order(cuda_device):
    from fmri_tpu_torch.data.pipeline import Batches, device_iterator

    data = {"fmri": np.arange(64 * 5, dtype=np.float32).reshape(64, 5),
            "image": np.random.default_rng(0).uniform(size=(64, 8, 8, 3)).astype(np.float32)}
    got = list(device_iterator(iter(Batches(data, 8, shuffle=True, seed=2)), cuda_device))
    want = list(Batches(data, 8, shuffle=True, seed=2))
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g["fmri"].device.type == "cuda"
        np.testing.assert_array_equal(g["fmri"].cpu().numpy(), w["fmri"])
        np.testing.assert_array_equal(g["image"].cpu().numpy(), w["image"])


def test_native_batches_of_a_mapped_dir_are_numpys_on_the_card(cuda_device, tmp_path,
                                                               monkeypatch):
    """On the card's host: the port's ``Batches`` over a memory-mapped
    pair dir (the g++-built gather and read-ahead) bitwise equal to numpy's
    gather, also after the pinned copy to the card."""
    from fmri_tpu_torch import native
    from fmri_tpu_torch.data.packed import open_packed
    from fmri_tpu_torch.data.pipeline import Batches, device_iterator

    assert native.available(), native.why_unavailable()
    rng = np.random.default_rng(3)
    os.makedirs(tmp_path / "packed")
    for key, arr in (("image", rng.integers(0, 256, (300, 64, 64, 3), dtype=np.uint8)),
                     ("fmri", rng.normal(size=(300, 3620)).astype(np.float32))):
        np.save(tmp_path / "packed" / f"{key}.npy", arr)
    with open(tmp_path / "packed" / "meta.json", "w") as f:
        json.dump({"keys": ["image", "fmri"]}, f)
    data = open_packed(str(tmp_path / "packed"))
    plain = {k: np.array(v) for k, v in data.items()}
    batches = Batches(data, 64, shuffle=True, seed=5)
    for epoch in range(2):
        order = np.random.default_rng((5, epoch)).permutation(300)
        got = list(device_iterator(iter(batches), cuda_device))
        assert len(got) == 4
        for b, g in enumerate(got):
            idx = order[b * 64:(b + 1) * 64]
            for k in plain:
                assert g[k].device.type == "cuda"
                assert g[k].cpu().numpy().tobytes() == plain[k][idx].tobytes(), (epoch, b, k)


def test_trainer_fit_is_bitwise_reproducible_with_its_defaults(cuda_device, tmp_path):
    """res64 stage I through ``Trainer.fit`` with the trainer's defaults
    (no flag set by the caller): the same two epochs twice are bitwise
    equal, and a run resumed after epoch 0 equals the uninterrupted epoch 1
    (cuDNN's default dgrad sums in no fixed order; the trainer runs its
    deterministic algorithms)."""
    import dataclasses

    from fmri_tpu_torch.checkpoints import store
    from fmri_tpu_torch.data.synthetic import synthetic_images
    from fmri_tpu_torch.train.stages import BUILDERS
    from fmri_tpu_torch.train.trainer import Trainer

    cfg = get_config("res64")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=64, ckpt_every=1))
    imgs, _ = synthetic_images(256, 64, seed=0)
    assert torch.backends.cudnn.deterministic is False

    def fit(name, n_epochs=2, resume=False):
        state, steps, kw = BUILDERS["vgan_stage1"](cfg, steps_per_epoch=3, seed=8,
                                                   device=cuda_device)
        run_dir = tmp_path / name
        run_dir.mkdir()
        trainer = Trainer(cfg, steps, str(run_dir), tensorboard=False, **kw)
        start = 0
        if resume:
            state, meta = store.restore_checkpoint(str(tmp_path / "a" / "checkpoints"),
                                                   state, epoch=0)
            start = meta["epoch"] + 1
        state = trainer.fit(state, imgs[64:], imgs[:64], n_epochs=n_epochs,
                            start_epoch=start)
        assert torch.backends.cudnn.deterministic is False
        return state

    a, b, resumed = fit("a"), fit("b"), fit("c", resume=True)
    for other in (b, resumed):
        sa, so = a.nets.state_dict(), other.nets.state_dict()
        assert all(torch.equal(sa[k], so[k]) for k in sa)
        for g in a.opt_state:
            for k, v in a.opt_state[g].items():
                assert torch.equal(v, other.opt_state[g][k]), (g, k)


# ------------------------------------------------------ serving's CUDA graphs


@pytest.mark.parametrize("output", ["float", "uint8"])
def test_serving_graph_per_bucket_matches_eager(cuda_device, tiny, output):
    """warmup captures one graph per (bucket, reconstruct | generate); each
    replay equals the same program run eagerly on the same static buffers
    with cuDNN's deterministic algorithms, as the graphs were captured:
    float within 1e-6, uint8 within 1 LSB (the same kernels; the bound
    leaves room for another algorithm only); a replay gives the same bits
    twice."""
    from fmri_tpu_torch.eval.serve import deterministic_cudnn

    cfg, groups, data = tiny
    served = ServingModel(cfg, port_model(groups, cfg), max_batch=8, output=output,
                          device=cuda_device)
    served.warmup()
    assert served.graphs == 2 * len(served.buckets) == 8
    for b in served.buckets:
        x = data["fmri"][:b]
        got = served.reconstruct(x)
        assert np.array_equal(served.reconstruct(x), got)
        gen = served.generate(b)
        with deterministic_cudnn():
            eager = served._program("reconstruct", b)[:b].cpu().numpy()
            gen_eager = served._program("generate", b)[:b].cpu().numpy()
        for a, e in ((got, eager), (gen, gen_eager)):
            gap = np.abs(a.astype(np.float64) - e.astype(np.float64)).max()
            assert gap <= (1e-6 if output == "float" else 1), (b, gap)
    assert served.graphs == 8                       # nothing captured again


def test_serving_reload_under_graphs(cuda_device, tmp_path):
    """A reload copies into the captured tensors: the outputs move to a
    fresh server's, bit for bit, and nothing is captured again."""
    from fmri_tpu_torch.checkpoints import store
    from fmri_tpu_torch.train.stages import BUILDERS

    cfg = get_config("tiny")
    d1, d2 = str(tmp_path / "s1"), str(tmp_path / "s2")
    store.save_checkpoint(d1, 0, BUILDERS["vgan_stage1"](cfg, steps_per_epoch=1,
                                                         device="cpu")[0])
    state = BUILDERS["vgan_stage2"](cfg, d1, steps_per_epoch=1, device="cpu")[0]
    store.save_checkpoint(d2, 0, state)
    with torch.no_grad():
        for p in state.nets.module("decoder").parameters():
            p.add_(0.1)
    store.save_checkpoint(d2, 1, state)
    served = ServingModel.from_checkpoint(d2, "vgan", 2, "tiny", epoch=0, max_batch=4,
                                          device=cuda_device)
    served.warmup()
    x = np.random.default_rng(0).normal(size=(3, cfg.model.num_voxels)).astype(np.float32)
    before = served.reconstruct(x)
    assert served.reload(d2, epoch=1)["epoch"] == 1
    after = served.reconstruct(x)
    assert served.graphs == 6 and np.abs(after - before).max() > 1e-3
    fresh = ServingModel.from_checkpoint(d2, "vgan", 2, "tiny", epoch=1, max_batch=4,
                                         device=cuda_device)
    np.testing.assert_array_equal(after, fresh.reconstruct(x))
    with pytest.raises(ValueError, match="reload refused"):
        served.reload(d1)
    np.testing.assert_array_equal(served.reconstruct(x), after)


def test_serving_capture_failure_raises(cuda_device, tiny):
    """A program that cannot be captured (its forward syncs with the host)
    raises; it never falls back to eager. The card serves on afterwards."""
    from fmri_tpu_torch.eval.steps import VaeGanCognitive

    class Syncing(VaeGanCognitive):
        @torch.no_grad()
        def reconstruct(self, x, eps=None):
            out = super().reconstruct(x, eps)
            return out * (1.0 + 0.0 * float(out.sum()))   # a host sync

    cfg, groups, data = tiny
    model = Syncing(cfg.model)
    model.load_state_dict(port_model(groups, cfg).state_dict(), strict=True)
    served = ServingModel(cfg, model, max_batch=4, device=cuda_device)
    with pytest.raises(RuntimeError, match="as a CUDA graph failed"):
        served.reconstruct(data["fmri"][:3])
    assert served.graphs == 0
    fine = ServingModel(cfg, port_model(groups, cfg), max_batch=4, device=cuda_device)
    cpu = ServingModel(cfg, port_model(groups, cfg), max_batch=4, device="cpu")
    np.testing.assert_allclose(fine.reconstruct(data["fmri"][:3]),
                               cpu.reconstruct(data["fmri"][:3]), atol=1e-4)
    assert fine.graphs == 1


@pytest.mark.parametrize("size", [64, 100])
def test_inception_proxy_on_the_card_matches_the_cpu(cuda_device, size, monkeypatch):
    """The proxy runs on the images' device; its probabilities within 1e-6
    of the CPU's and its IS within 1e-5 relative ('SAME' padding on both)."""
    from fmri_tpu_torch.metrics import inception

    monkeypatch.delenv("FMRI_TPU_INCEPTION_NPZ", raising=False)
    x = torch.from_numpy(np.random.default_rng(size).uniform(
        0, 1, (256, size, size, 3)).astype(np.float32))
    card, cpu = inception.classify(x.to(cuda_device)), inception.classify(x)
    np.testing.assert_allclose(card, cpu, rtol=0, atol=1e-6)
    got, want = inception.inception_score(x.to(cuda_device)), inception.inception_score(x)
    assert got[2] is want[2] is True
    assert got[0] == pytest.approx(want[0], rel=1e-5)


def test_inception_v3_on_the_card_matches_the_cpu(cuda_device, tmp_path, monkeypatch):
    """Seeded torchvision-layout weights through ``FMRI_TPU_INCEPTION_NPZ``:
    4 images upsampled to 299 px, probabilities within 1e-5 of the CPU's
    (fp32 both sides, TF32 off), the IS not a proxy."""
    from fmri_tpu_torch.metrics import inception, inception_v3

    path = str(tmp_path / "inception_v3.npz")
    np.savez(path, **inception_v3.random_weights(seed=1))
    monkeypatch.setenv("FMRI_TPU_INCEPTION_NPZ", path)
    x = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (4, 64, 64, 3))
                         .astype(np.float32))
    card = inception.classify(x.to(cuda_device))
    cpu = inception_v3.classify_with_weights(path, x, batch_size=3)
    assert card.shape == (4, 1000) and np.isfinite(card).all()
    np.testing.assert_allclose(card, cpu, rtol=0, atol=1e-5)
    assert inception.inception_score(x.to(cuda_device))[2] is False


def _exp_run(cfg, name, device, b, flags, ckpt):
    """One step of an ablation path through its builder (``ckpt``: a DCGAN
    stage-1 checkpoint dir for stage 2), moments at ones: (state, metrics,
    launches, start weights)."""
    import dataclasses

    from fmri_tpu_torch.train.optim import AdamState
    from fmri_tpu_torch.train.stages import BUILDERS

    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, pallas_bn=flags, pallas_backward=flags))
    state, steps, kw = BUILDERS[name](cfg, *([ckpt] if name == "exp_dcgan_stage2" else []),
                                      steps_per_epoch=4, device=str(device))
    for m in state.opt_state.values():
        for v in (m.nu if isinstance(m, AdamState) else m).values():
            v.fill_(1.0)
    weights = {k: v.cpu().clone() for k, v in state.nets.state_dict().items()}
    fmri, image, eps, z_p, _ = _cognitive_inputs(cfg, b, device)
    batch = image if kw["data_kind"] == "image" else {"fmri": fmri, "image": image}
    gate = (0.35, 0.68, 1e-6) if kw["uses_gate"] else ()
    before = _launches()
    state, m = steps.train_step(state, batch, {"eps": eps, "z_p": z_p}, *gate)
    torch.cuda.synchronize()
    return state, m, tuple(a - b for a, b in zip(_launches(), before)), weights


@pytest.fixture(scope="module")
def dcgan1_dirs(tmp_path_factory):
    """A DCGAN stage-1 checkpoint dir at tiny and at res64 (CPU states)."""
    from fmri_tpu_torch.checkpoints import store
    from fmri_tpu_torch.train.stages import exp_dcgan_stage1

    out = {}
    for preset in ("tiny", "res64"):
        d = str(tmp_path_factory.mktemp(f"dcgan1_{preset}"))
        store.save_checkpoint(d, 0, exp_dcgan_stage1(get_config(preset), steps_per_epoch=2,
                                                     device="cpu")[0])
        out[preset] = d
    return out


@pytest.mark.parametrize("name", sorted(EXP_LAUNCHES))
def test_exp_step_kernels_match_the_library_on_the_card(cuda_device, dcgan1_dirs, name):
    """Each ablation step at tiny with both kernel flags on against the same
    step with both off, on the card, from the same state and inputs, under
    the WAE steps' bounds (losses 1e-5 relative; parameters, moments and
    BN running statistics 1e-3 in L2 per tensor), a parameter whose update
    is below its fp32 spacing (``exp_vgan``'s FC BatchNorm scales, moved
    6e-5 in all at lr 1e-4, where flags on and off round one element one
    unit apart) within 4 units of its own norm; the kernels launched as
    counted on the CPU."""
    from fmri_tpu_torch.train.optim import AdamState

    cfg = get_config("tiny")
    on, m_on, n_on, weights = _exp_run(cfg, name, cuda_device, 8, True, dcgan1_dirs["tiny"])
    off, m_off, n_off, _ = _exp_run(cfg, name, cuda_device, 8, False, dcgan1_dirs["tiny"])
    assert n_on == EXP_LAUNCHES[name] and n_off == (0, 0, 0)
    for k in m_off:
        assert float(m_on[k]) == pytest.approx(float(m_off[k]), rel=1e-5, abs=1e-7), k
    sd_on = on.nets.state_dict()
    for k, ref in off.nets.state_dict().items():
        got, ref = sd_on[k].cpu(), ref.cpu()
        if k.endswith("num_batches_tracked"):
            assert torch.equal(got, ref)
            continue
        scale = ref if "running" in k else ref - weights[k]
        ulps = 4 * torch.finfo(torch.float32).eps * float(ref.norm())
        assert float((got - ref).norm()) <= max(1e-3 * float(scale.norm()), ulps, 1e-12), k
    for g, moments in off.opt_state.items():
        pairs = ([(on.opt_state[g].mu, moments.mu), (on.opt_state[g].nu, moments.nu)]
                 if isinstance(moments, AdamState) else [(on.opt_state[g], moments)])
        for got_m, ref_m in pairs:
            for k, ref in ref_m.items():
                assert float((got_m[k].cpu() - ref.cpu()).norm()) <= 1e-3 * max(
                    float(ref.norm()), 1e-12), (g, k)


@pytest.mark.parametrize("name", sorted(EXP_LAUNCHES))
def test_res64_exp_step_launches(cuda_device, dcgan1_dirs, name):
    """One res64 ablation step at batch 8 launches each kernel as counted on
    the CPU at tiny."""
    got = _exp_run(get_config("res64"), name, cuda_device, 8, True, dcgan1_dirs["res64"])[2]
    assert got == EXP_LAUNCHES[name]


def test_wae_decoder_kernels_match_plain(cuda_device):
    """WaeDecoder at res64 (batch 16, both flags on): its 1024 -> 512 deconv
    weight grad at 8 -> 16 px and its 512-channel BatchNorm backward, each
    recorded call against the plain version (weight grad within ``DW_TOL``
    of the plain result's largest magnitude, BN within 1e-5), and the
    gradients of the whole decoder within 1e-3 (L2 per tensor) of the
    library backward's."""
    import dataclasses

    from fmri_tpu_torch.models.nets import WaeDecoder

    cfg = get_config("res64")
    grads, calls = {}, {"dw": [], "bn": []}
    real_dw, real_bn = port_dw.conv2d_transpose_dw, port_bn.bn_bwd_reduce
    for flags in (False, True):
        c = dataclasses.replace(cfg.model, pallas_bn=flags, pallas_backward=flags)
        torch.manual_seed(0)
        dec = WaeDecoder(c).to(cuda_device)
        z = torch.randn((16, c.latent_dim), generator=torch.Generator().manual_seed(1)).to(
            cuda_device)
        if flags:  # recorders; the wrapper counts its launches by its module name
            def rec_dw(*a):
                calls["dw"].append(a)
                return real_dw(*a)

            def rec_bn(*a):
                calls["bn"].append(a)
                return real_bn(*a)

            rec_bn.launches = real_bn.launches
            port_dw.conv2d_transpose_dw, port_bn.bn_bwd_reduce = rec_dw, rec_bn
        try:
            out = dec(z)
            grads[flags] = torch.autograd.grad((out * out).sum(), list(dec.parameters()))
        finally:
            port_dw.conv2d_transpose_dw, port_bn.bn_bwd_reduce = real_dw, real_bn
    assert [tuple(a[0].shape) for a in calls["dw"]][-1] == (16, 1024, 8, 8)
    assert any(a[0].shape[1] == 512 for a in calls["bn"])
    for a in calls["dw"]:
        got, ref = real_dw(*a), port_dw.conv2d_transpose_dw_plain(*a)
        assert float((got - ref).abs().max()) <= DW_TOL[torch.float32] * float(ref.abs().max())
    for a in calls["bn"]:
        for got_row, ref_row in zip(real_bn(*a), port_bn.bn_bwd_reduce_plain(*a)):
            assert float((got_row - ref_row).abs().max()) <= 1e-5 * float(ref_row.abs().max())
    for got, ref in zip(grads[True], grads[False]):
        assert float((got - ref).norm()) <= 1e-3 * float(ref.norm())


# ------------------------------------------------------------ across ranks


def test_nccl_mesh_of_one_rank_is_the_step_without_a_mesh(cuda_device):
    """A world of one over NCCL on the card: the group forms, and the stage-I
    step on a state placed on it equals the step without a mesh bit for bit
    (with cuDNN's deterministic algorithms, as the ``Trainer`` runs)."""
    from test_torch_mesh import build_state, configs, make_step, stage1_case

    from fmri_tpu_torch.checkpoints.store import host_tree
    from fmri_tpu_torch.device import deterministic_cudnn
    from fmri_tpu_torch.parallel.mesh import make_mesh, shard_state

    case = stage1_case(3, 1)
    cfg = configs(**case["flags"])
    args = [a.to(cuda_device) if torch.is_tensor(a) else a for a in case["steps"][0]]
    mesh = make_mesh(1, 1)
    try:
        assert mesh.backend == "nccl" and mesh.device == torch.device("cuda", 0)
        with deterministic_cudnn():
            on = shard_state(build_state("vgan1", cfg, case["weights"], case["moments"]), mesh)
            on, m_on = make_step("vgan1", cfg, mesh)(on, *args)
            off = build_state("vgan1", cfg, case["weights"], case["moments"], cuda_device)
            off, m_off = make_step("vgan1", cfg)(off, *args)
        assert {k: float(v) for k, v in m_on.items()} == {k: float(v) for k, v in m_off.items()}
        a, b = host_tree(on), host_tree(off)
        for g in b["groups"]:
            for k, v in b["groups"][g].items():
                assert torch.equal(a["groups"][g][k], v), (g, k)
    finally:
        mesh.close()


@pytest.mark.parametrize("names", [("stage1_d2", "wae1_d2")])
def test_ranks_sharing_the_card_over_gloo_match_the_single_process_step(cuda_device, tmp_path,
                                                                        names):
    """Two ranks on one card over gloo (asked for by name): stage I and WAE
    stage I at data=2, both kernel flags on, against the single-process step
    on the card (``test_torch_mesh.check_against_single``), replicas bitwise
    equal."""
    import test_torch_mesh as tm

    cases = {"stage1_d2": tm.stage1_case(6, 2), "wae1_d2": tm.wae_case("wae1", 8, (2, 1), {})}
    cases = {n: cases[n] for n in names}
    procs = tm.start_workers(str(tmp_path), cases, [[((0, 1), tuple(names))]],
                             device=str(cuda_device), n=2)
    try:
        single = {n: tm.run_single(c, device=cuda_device) for n, c in cases.items()}
        noise = {n: tm.run_single(c, reverse=True, device=cuda_device)[1]
                 for n, c in cases.items()}
    finally:
        results = tm.join_workers(str(tmp_path), procs, timeout=300)
    runs = dict(cases=cases, results=results, single=single, noise=noise)
    for n in names:
        tm.check_against_single(n, runs)


def test_serving_mesh_sharing_the_card_matches_the_single_process_server(cuda_device,
                                                                         tmp_path):
    """Four ranks on the card over gloo (asked for by name), res64 stage III
    at data=2 x model=2 with ``voxel_tp``, sampling, uint8 images, against
    the single-process server's graphs with the same seed and buckets
    (``tests/test_torch_serve_mesh.py``'s workers): within 1 LSB, every
    program a graph on every rank, and no collective inside a capture."""
    import test_torch_serve_mesh as sm

    v = get_config("res64").model.num_voxels
    rng = np.random.default_rng(5)
    fmri = [rng.normal(size=(n, v)).astype(np.float32) for n in (5, 64, 70)]
    case = sm.make_case("vgan", 3, 6, (2, 2), voxel_tp=True, sample=True, output="uint8",
                        preset="res64", max_batch=64,
                        ops=[("reconstruct", x) for x in fmri] + [("generate", 70)])
    procs = sm.start_workers(str(tmp_path), {"tp": case}, [[((0, 1, 2, 3), ("tp",))]],
                             device=str(cuda_device))
    try:
        want = sm.run_ops(sm.server(case, min_bucket=2, device=cuda_device), case["ops"])
    finally:
        results = sm.join_workers(str(tmp_path), procs, timeout=600)
    got = results[0]["tp"]["answers"]
    for g, w in zip(got, want):
        assert g[0] == w[0] == "ok", (g, w)
        assert np.abs(g[1].astype(int) - w[1].astype(int)).max() <= 1
    for r in range(4):
        res = results[r]["tp"]
        assert res["graphs"] == 2 * len(res["buckets"]) and res["in_capture"] == 0, res


def test_train_cli_refuses_more_ranks_than_cards(cuda_device, tmp_path):
    from fmri_tpu_torch.train import run

    n = torch.cuda.device_count() + 1
    with pytest.raises(SystemExit, match=f"{n} ranks need {n} cards"):
        run.main(["--family", "vgan", "--preset", "tiny", "--dataset", "synthetic",
                  "--batch-size", str(4 * n), "--mesh", f"data={n}", "-o", str(tmp_path)])
    assert not os.listdir(tmp_path)
