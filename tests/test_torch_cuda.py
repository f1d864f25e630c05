"""The port on the card (``cuda`` marker; each test skips without one): the
SSIM kernel against its plain version, the wrapper's checks, and the
inference and serving path on the card against the same path on the CPU.

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
from fmri_tpu_torch.ops import ssim as port

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("size", [8, 16, 64, 100])
def test_kernel_matches_plain(cuda_device, size):
    a, b = uniform_pair((4, size, size, 3), seed=size)
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
