"""The port's ``Adam`` and ``step_lr`` (``fmri_tpu_torch/train/optim.py``) and
``bn_extra_ticks`` (``fmri_tpu_torch/train/common.py``) against the JAX
package's (``fmri_tpu/train/optim.py``, ``fmri_tpu/train/common.py``) and
torch's own ``torch.optim.Adam`` / repeated BatchNorm forwards, on the CPU.

The optimizers see the same gradients on both sides, so the comparison has
no gradient rounding in it: parameters and moments within 1e-6 relative
(the two packages order a few fp32 operations differently), counts exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmri_tpu.train import Adam as JaxAdam
from fmri_tpu.train import step_lr as jax_step_lr
from fmri_tpu.train.common import bn_extra_ticks as jax_bn_extra_ticks
from fmri_tpu_torch.models.norm import BatchNorm1d, BatchNorm2d
from fmri_tpu_torch.train.common import bn_extra_ticks, bn_stats
from fmri_tpu_torch.train.optim import Adam, AdamState, step_lr


def _params(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(4, 3)).astype(np.float32),
            "b": rng.normal(size=(3,)).astype(np.float32)}


def _grads(seed):
    rng = np.random.default_rng(100 + seed)
    return {"w": rng.normal(size=(4, 3)).astype(np.float32),
            "b": (1e-3 * rng.normal(size=(3,))).astype(np.float32)}


GATES = (1.0, 0.0, 1.0, 1.0, 0.0)


@pytest.mark.parametrize("clip", [None, 0.5])
def test_adam_matches_jax(clip):
    """Five gated steps (gates 1, 0, 1, 1, 0) at lr 1e-2 from zero moments:
    parameters, mu, nu within 1e-6 relative of the JAX Adam, the count 3
    (it ticks on applied steps only, and a gated-off step leaves everything
    bitwise)."""
    p0 = _params(0)
    jopt, opt = JaxAdam(0.5, 0.999, clip=clip), Adam(0.5, 0.999, clip=clip)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = jopt.init(jp)
    params = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    state = opt.init(params)
    assert state.count.dtype == torch.int32
    for i, gate in enumerate(GATES):
        g = _grads(i)
        jp, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp,
                             jnp.float32(1e-2), gate)
        before = {k: v.clone() for k, v in params.items()}
        opt.update({k: torch.from_numpy(v) for k, v in g.items()}, state, params,
                   torch.tensor(1e-2), torch.tensor(gate))
        if gate == 0.0:
            assert all(torch.equal(params[k], before[k]) for k in params)
        for k in p0:
            for got, ref in ((params[k], jp[k]), (state.mu[k], js.mu[k]),
                             (state.nu[k], js.nu[k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                           atol=1e-9, err_msg=f"step {i} {k}")
        assert int(state.count) == int(js.count)
    assert int(state.count) == 3


def test_adam_matches_torch_optim():
    """Without a gate the update is ``torch.optim.Adam``'s (betas 0.5,
    0.999, eps 1e-8) over four steps, within an fp32 unit of the parameters
    (rtol 1e-6, atol 1e-7): torch folds the bias corrections into the step
    size and the denominator, in another order of operations."""
    p0 = _params(1)
    ref = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    topt = torch.optim.Adam(list(ref.values()), lr=1e-2, betas=(0.5, 0.999), eps=1e-8)
    params = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    opt = Adam(0.5, 0.999)
    state = opt.init(params)
    for i in range(4):
        g = _grads(i)
        for k, p in ref.items():
            p.grad = torch.from_numpy(g[k].copy())
        topt.step()
        opt.update({k: torch.from_numpy(v) for k, v in g.items()}, state, params,
                   torch.tensor(1e-2))
        for k in p0:
            np.testing.assert_allclose(params[k].numpy(), ref[k].detach().numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=f"step {i} {k}")
    assert isinstance(state, AdamState) and int(state.count) == 4


@pytest.mark.parametrize("steps_per_epoch,step_size,gamma", [(3, 2, 0.5), (1, 30, 0.5),
                                                             (4, 1, 0.9)])
def test_step_lr_matches_jax(steps_per_epoch, step_size, gamma):
    """``StepLR(step_size, gamma)`` per epoch, fp32, at steps 0..99."""
    jsched = jax_step_lr(1e-3, step_size, gamma, steps_per_epoch)
    sched = step_lr(1e-3, step_size, gamma, steps_per_epoch)
    for step in range(100):
        got = sched(torch.tensor(step))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(float(jsched(jnp.int32(step))), rel=1e-7), step


@pytest.mark.parametrize("extra", [1, 2])
def test_bn_extra_ticks_equals_repeated_forwards(extra):
    """One forward and ``extra`` replayed ticks give the running statistics
    of 1 + extra forwards on the same batch (atol 1e-6) and their
    ``num_batches_tracked``, for BatchNorm2d and BatchNorm1d; the JAX
    replay from the same start agrees (1e-6)."""
    rng = np.random.default_rng(extra)
    for bn_cls, shape in ((BatchNorm2d, (6, 3, 4, 4)), (BatchNorm1d, (6, 5))):
        x = torch.from_numpy(rng.normal(1.0, 2.0, shape).astype(np.float32))
        mods = [torch.nn.Sequential(bn_cls(shape[1])) for _ in range(2)]
        for m in mods:
            m[0].running_mean.uniform_(-0.5, 0.5)
            m[0].running_var.uniform_(0.5, 1.5)
        mods[1].load_state_dict(mods[0].state_dict())
        start = {k: v.clone() for k, v in mods[0].state_dict().items()}
        before = bn_stats(mods[0])
        mods[0](x)
        one_tick = {k: v.clone() for k, v in mods[0].state_dict().items()}
        bn_extra_ticks(mods[0], before, extra)
        for _ in range(1 + extra):
            mods[1](x)
        got, ref = mods[0].state_dict(), mods[1].state_dict()
        for k in ("0.running_mean", "0.running_var"):
            np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=0, atol=1e-6)
        assert int(got["0.num_batches_tracked"]) == 1 + extra
        jref = jax_bn_extra_ticks(
            {"mean": start["0.running_mean"].numpy(), "var": start["0.running_var"].numpy()},
            {"mean": one_tick["0.running_mean"].numpy(),
             "var": one_tick["0.running_var"].numpy()}, extra)
        np.testing.assert_allclose(got["0.running_mean"].numpy(), jref["mean"], atol=1e-6)
        np.testing.assert_allclose(got["0.running_var"].numpy(), jref["var"], atol=1e-6)
