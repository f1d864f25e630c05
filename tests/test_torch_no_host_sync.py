"""No tensor is made from host data inside a warmed train step or its
augmentation, on the CPU at ``tiny``; and the constants made once give the
bits of the expressions they replaced.

On CUDA a tensor of host data (``torch.tensor`` or ``torch.as_tensor`` of
Python numbers) is a pageable copy that waits for the device's queue to
drain, so one such tensor per step stalls the host once a step. Each
dispatches ``aten.lift_fresh``, on the CPU too, so counting that op during
a step's second call finds them here. The step's scalars (margin,
equilibrium, lambda_mse) come as device tensors, as the ``Trainer`` makes
them once per epoch."""

import traceback

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fmri_tpu_torch.configs.presets import get_config
from fmri_tpu_torch.data.transforms import (
    denormalize, eval_preprocess, normalize, train_augment,
)
from fmri_tpu_torch.train.optim import Adam, RmsProp, exponential_lr, step_lr
from fmri_tpu_torch.train.state import (
    GROUPS, init_cognitive, init_vaegan, init_wae, make_cognitive_state, make_state,
    make_wae_state,
)
from fmri_tpu_torch.train.steps_vgan import make_vgan_cognitive_step, make_vgan_stage1_step
from fmri_tpu_torch.train.steps_wae import make_wae_stage1_step


# a tensor of host data, and a tensor's value read on the host (``.item()``,
# ``float(t)``, ``tuple(t)`` into a new tensor): each waits for the device
HOST_OPS = (torch.ops.aten.lift_fresh.default, torch.ops.aten._local_scalar_dense.default)


class HostTensors(TorchDispatchMode):
    """Records where each of :data:`HOST_OPS` is called."""

    def __init__(self):
        super().__init__()
        self.sites = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in HOST_OPS:
            self.sites.append("".join(traceback.format_stack(limit=6)[:-1]))
        return func(*args, **(kwargs or {}))


def _vgan(stage: int, backward: str):
    """A warmed-up call of the stage's step at tiny, batch 8."""
    cfg = get_config("tiny")
    t, b, latent, s = cfg.train, cfg.train.batch_size, cfg.model.latent_dim, cfg.model.image_size
    gen = torch.Generator().manual_seed(stage)
    noise = [torch.randn(b, latent, generator=gen) for _ in range(3)]
    image = torch.rand(b, s, s, 3, generator=gen) * 2.0 - 1.0
    gate = tuple(torch.tensor(v, dtype=torch.float32) for v in (0.35, 0.68, 0.5))
    lr = exponential_lr(t.learning_rate, t.decay_lr, 4)
    if stage == 1:
        opt = RmsProp(decay=t.rms_decay, eps=t.rms_eps, clip=t.grad_clip)
        state = make_state(init_vaegan(cfg, seed=0), {g: opt for g in GROUPS})
        fn = make_vgan_stage1_step(cfg, lr_schedule=lr, backward=backward).train_step
        return lambda: fn(state, image, noise[0], noise[1], *gate)
    state = make_cognitive_state(init_cognitive(cfg, seed=0), cfg, stage)
    fn = make_vgan_cognitive_step(cfg, stage, use_teacher=stage == 2, lr_schedule=lr,
                                  backward=backward).train_step
    fmri = torch.randn(b, cfg.model.num_voxels, generator=gen)
    return lambda: fn(state, fmri, image, *noise, *gate)


def _wae():
    cfg = get_config("tiny")
    t, b = cfg.train, cfg.train.batch_size
    gen = torch.Generator().manual_seed(4)
    state = make_wae_state(init_wae(cfg, seed=0), cfg)
    fn = make_wae_stage1_step(cfg, lr_schedule=step_lr(t.learning_rate, t.step_size,
                                                       t.step_gamma, 4)).train_step
    x = torch.rand(b, cfg.model.image_size, cfg.model.image_size, 3, generator=gen) * 2 - 1
    z = torch.randn(b, cfg.model.latent_dim, generator=gen)
    return lambda: fn(state, x, z)


def _augment(kind: str):
    gen = torch.Generator().manual_seed(5)
    x = torch.randint(0, 256, (8, 16, 16, 3), dtype=torch.uint8, generator=gen)
    if kind == "eval_preprocess":
        return lambda: eval_preprocess(x)
    flip = torch.rand(8, generator=gen) < 0.5
    shifts = torch.randint(-2, 3, (8, 2), generator=gen)
    return lambda: train_augment(x, flip, shifts, (0.485, 0.456, 0.406), (0.229, 0.224, 0.225))


def _serve(kind: str):
    """A bucket's program of a stage-I ``ServingModel`` (image -> image: the
    preprocess, the model, the denormalize), which CUDA captures as a graph
    after warm calls: a host-to-device copy cannot be captured."""
    from fmri_tpu_torch.eval.serve import ServingModel
    from fmri_tpu_torch.eval.steps import VaeGanVisual

    cfg = get_config("tiny")
    model = VaeGanVisual(cfg.model)
    served = ServingModel(cfg, model, stage=1, max_batch=8, output="uint8", device="cpu")
    served._inputs[8].copy_(torch.rand(served._inputs[8].shape,
                                       generator=torch.Generator().manual_seed(6)))
    return lambda: served._program(kind, 8)


CASES = {
    "stage1-spliced": lambda: _vgan(1, "spliced"),
    "stage1-naive": lambda: _vgan(1, "naive"),
    "stage2-spliced": lambda: _vgan(2, "spliced"),
    "stage2-naive": lambda: _vgan(2, "naive"),
    "stage3": lambda: _vgan(3, "spliced"),
    "wae-stage1": _wae,
    "train_augment": lambda: _augment("train_augment"),
    "eval_preprocess": lambda: _augment("eval_preprocess"),
    "serve-reconstruct": lambda: _serve("reconstruct"),
    "serve-generate": lambda: _serve("generate"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_warmed_call_makes_no_host_tensor(case):
    """The second call of each step (and of each augmentation, and of a
    serving program) makes no tensor of host data and reads no tensor on the
    host: none of :data:`HOST_OPS`."""
    call = CASES[case]()
    call()
    with HostTensors() as mode:
        call()
    assert not mode.sites, (f"{len(mode.sites)} tensors of host data in a warmed "
                            f"{case} call, made at:\n" + "\n".join(mode.sites))


# ---- the same bits as the expressions the constants replaced ----


def _old_exponential_lr(base_lr, gamma, spe):
    def schedule(step):
        epoch = torch.div(step, spe, rounding_mode="floor")
        return base_lr * torch.pow(torch.tensor(gamma, device=step.device), epoch.float())
    return schedule


def _old_step_lr(base_lr, step_size, gamma, spe):
    def schedule(step):
        epoch = torch.div(step, spe, rounding_mode="floor")
        k = torch.div(epoch, step_size, rounding_mode="floor")
        return base_lr * torch.pow(torch.tensor(gamma, device=step.device), k.float())
    return schedule


def _old_normalize(x, mean, std):
    return ((x - torch.as_tensor(mean, dtype=x.dtype, device=x.device))
            / torch.as_tensor(std, dtype=x.dtype, device=x.device))


def _old_denormalize(x, mean, std):
    return (x * torch.as_tensor(std, dtype=x.dtype, device=x.device)
            + torch.as_tensor(mean, dtype=x.dtype, device=x.device))


def _old_rmsprop(opt, grads, sq_avg, params, lr, gate):
    on = torch.as_tensor(gate) != 0
    for k, p in params.items():
        g = grads[k] if opt.clip is None else grads[k].clamp(-opt.clip, opt.clip)
        s = sq_avg[k]
        new_s = opt.decay * s + (1.0 - opt.decay) * g * g
        new_p = p - lr * g / (torch.sqrt(new_s) + opt.eps)
        p.copy_(torch.where(on, new_p, p))
        s.copy_(torch.where(on, new_s, s))


def _old_adam(opt, grads, state, params, lr, gate):
    on = torch.as_tensor(gate) != 0
    count = state.count + on.to(torch.int32)
    t = count.clamp_min(1).float()
    bc1, bc2 = 1.0 - torch.pow(opt.b1, t), 1.0 - torch.pow(opt.b2, t)
    for k, p in params.items():
        g = grads[k] if opt.clip is None else grads[k].clamp(-opt.clip, opt.clip)
        m, v = state.mu[k], state.nu[k]
        new_m = opt.b1 * m + (1.0 - opt.b1) * g
        new_v = opt.b2 * v + (1.0 - opt.b2) * g * g
        new_p = p - lr * (new_m / bc1) / (torch.sqrt(new_v / bc2) + opt.eps)
        p.copy_(torch.where(on, new_p, p))
        m.copy_(torch.where(on, new_m, m))
        v.copy_(torch.where(on, new_v, v))
    state.count.copy_(torch.where(on, count, state.count))


def _bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def _check_schedules():
    cfg = get_config("tiny").train
    spe = 3
    pairs = []
    for gamma in (cfg.decay_lr, cfg.step_gamma, 0.98, 0.5):
        pairs.append((exponential_lr(2e-4, gamma, spe), _old_exponential_lr(2e-4, gamma, spe)))
        pairs.append((step_lr(1e-3, 30, gamma, spe), _old_step_lr(1e-3, 30, gamma, spe)))
    for step in range(0, 401 * spe, spe):
        s = torch.tensor(step, dtype=torch.int64)
        for new, old in pairs:
            assert _bits(new(s), old(s)), f"step {step}: {new(s)} vs {old(s)}"


def _check_normalize():
    gen = torch.Generator().manual_seed(0)
    x = torch.rand(4, 9, 9, 3, generator=gen)
    for mean, std in (((0.5,) * 3, (0.5,) * 3), ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
                      ([0.3, 0.3, 0.3], [0.7, 0.7, 0.7])):
        for dtype in (torch.float32, torch.float64, torch.bfloat16):
            xd = x.to(dtype)
            assert _bits(normalize(xd, mean, std), _old_normalize(xd, mean, std)), (mean, dtype)
            assert _bits(denormalize(xd, mean, std), _old_denormalize(xd, mean, std)), (mean,
                                                                                        dtype)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.normal(size=(5, 4)).astype(np.float32)),
            "b": torch.from_numpy((1e-3 * rng.normal(size=(4,))).astype(np.float32))}


def _check_optimizers():
    """Three copies of each optimizer's state: a number gate, the same gate
    as a tensor, and the old expressions with the number."""
    lr = torch.tensor(1e-2)
    for clip in (None, 0.5):
        rms, adam = RmsProp(clip=clip), Adam(0.5, 0.999, clip=clip)
        rp = [_tree(0) for _ in range(3)]
        rs = [rms.init(p) for p in rp]
        ap = [_tree(1) for _ in range(3)]
        ast = [adam.init(p) for p in ap]
        for i, gate in enumerate((1.0, 0.0, 1, 1.0, 0, 0.0, 1.0)):
            g = _tree(10 + i)
            for j, gj in enumerate((gate, torch.tensor(float(gate)))):
                rms.update(g, rs[j], rp[j], lr, gj)
                adam.update(g, ast[j], ap[j], lr, gj)
            _old_rmsprop(rms, g, rs[2], rp[2], lr, gate)
            _old_adam(adam, g, ast[2], ap[2], lr, gate)
            for j in (1, 2):
                for k in rp[0]:
                    assert _bits(rp[0][k], rp[j][k]) and _bits(rs[0][k], rs[j][k]), (clip, i, j)
                    assert _bits(ap[0][k], ap[j][k]), (clip, i, j, k)
                    assert _bits(ast[0].mu[k], ast[j].mu[k]), (clip, i, j, k)
                    assert _bits(ast[0].nu[k], ast[j].nu[k]), (clip, i, j, k)
                assert _bits(ast[0].count, ast[j].count), (clip, i, j)
        assert int(ast[0].count) == 4


@pytest.mark.parametrize("what", ["schedules", "normalize", "optimizers"])
def test_constants_keep_the_old_bits(what):
    """``exponential_lr`` and ``step_lr`` at epochs 0-400 (the thesis's
    gammas), ``normalize``/``denormalize`` for equal and unequal channels,
    and ``RmsProp``/``Adam`` with number gates 0 and 1 (parameters,
    moments, ``count``) equal, bit for bit, the expressions they replaced,
    written out here: one tensor of host data per call."""
    {"schedules": _check_schedules, "normalize": _check_normalize,
     "optimizers": _check_optimizers}[what]()
