"""The port on the card (``cuda`` marker; each test skips without one): the
SSIM, BatchNorm-backward and weight-grad kernels against their plain
versions, the wrappers' checks, and the inference, serving and stage-I
train paths on the card against the same paths on the CPU.

Imports only torch, numpy and the port, so it runs where the JAX package's
dependencies are not installed:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Tolerances: SSIM kernel vs plain 1e-5 on the means (fp32 both sides,
different summation orders); card vs CPU images 1e-4 (cuDNN may pick FFT or
Winograd convolutions, whose fp32 rounding differs from the CPU's direct
convolution by a few 1e-6 on these weights); n-way fractions within 1/N."""

import numpy as np
import pytest
import torch
from torch_port_helpers import cuda_device, port_model, uniform_pair  # noqa: F401

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
                                        (1024, 64), (10240, 64)])
def test_kernel_matches_plain(cuda_device, batch, size):
    """Small images (the generic k < 11 instance at 8 px), res100's 15
    bands, and the inference run's 1,024 and 10,240 images at 64 px."""
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
