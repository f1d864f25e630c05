"""Shared pieces of the ``tests/test_torch_*.py`` files: the CUDA fixture and
the JAX-side state built from the same numpy weights the port loads."""

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    """The card, or a skip. Decided when the test runs, never at import:
    every xdist worker must collect the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    from fmri_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def jax_state(groups):
    """A JAX ``TrainState`` holding numpy ``encoder``/``decoder`` groups."""
    import jax.numpy as jnp

    from fmri_tpu.train.state import TrainState

    return TrainState(
        params={k: g["params"] for k, g in groups.items()},
        batch_stats={k: g["batch_stats"] for k, g in groups.items()},
        opt_state={}, step=jnp.zeros((), jnp.int32))


def port_model(groups, cfg, device="cpu"):
    """The port's ``VaeGanCognitive`` loaded strictly from JAX groups."""
    from fmri_tpu_torch.checkpoints.convert import from_jax_groups
    from fmri_tpu_torch.eval.steps import VaeGanCognitive

    model = VaeGanCognitive(cfg.model)
    model.load_state_dict(from_jax_groups(groups, cfg), strict=True)
    return model.to(device)


def uniform_pair(shape, seed):
    """Two correlated NHWC float32 images in [0, 1]."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0.0, 0.1, shape), 0.0, 1.0).astype(np.float32)
    return a, b
