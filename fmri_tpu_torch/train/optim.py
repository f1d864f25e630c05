"""RMSprop and Adam with a device-side gate, and the per-epoch exponential
and step schedules.

The port's copy of ``fmri_tpu/train/optim.py:32-127``. The reference skips
``optimizer.step()`` when the equilibrium gate turns a head off
(``train_vgan_stage1.py:396-432``); here the gate is a 0/1 tensor on the
device and ``torch.where`` keeps the parameters and the moments when it is
0, so a gated step needs no host sync and a skipped step leaves the moments
untouched, as torch's skipped ``step()`` does. A gate given as a number
(the groups that always train) is decided on the host: 1 applies the update
without ``torch.where``, 0 skips it, and neither makes a device tensor.

Numerics follow torch:
  * RMSprop (``train_vgan_stage1.py:275-283``): ``sq_avg = a * sq_avg +
    (1 - a) * g^2``; ``p -= lr * g / (sqrt(sq_avg) + eps)`` with eps
    outside the sqrt;
  * Adam (``train_wae_stage1.py:221-224``): bias-corrected moments, ``p -=
    lr * m_hat / (sqrt(v_hat) + eps)``; its ``count`` ticks only on applied
    steps and the correction uses ``max(count, 1)``;
  * either with an optional elementwise clamp of g to ``[-clip, clip]``
    before the moment update.

Parameters and moments are updated in place: the state owns them and the
step hands back the same objects, where the JAX package returns new trees.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional

import torch

from fmri_tpu_torch.device import constant

Moments = Dict[str, torch.Tensor]


def _on(gate, device: torch.device):
    """``gate != 0``: a device boolean for a tensor gate, a Python bool for
    a number (no host-to-device copy, which would wait for the device)."""
    if isinstance(gate, torch.Tensor):
        return torch.as_tensor(gate, device=device) != 0
    return bool(gate != 0)


def _put(dst: torch.Tensor, new: torch.Tensor, on) -> None:
    """``dst`` = ``new`` where ``on`` (see :func:`_on`), else kept."""
    dst.copy_(new if on is True else torch.where(on, new, dst))


class RmsProp(NamedTuple):
    decay: float = 0.9
    eps: float = 1e-8
    clip: Optional[float] = None

    def init(self, params: Mapping[str, torch.Tensor]) -> Moments:
        """Zero ``sq_avg`` per named parameter."""
        return {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], sq_avg: Moments,
               params: Mapping[str, torch.Tensor], lr: torch.Tensor,
               gate=1.0) -> None:
        """One gated step, in place on ``params`` and ``sq_avg``. ``lr`` and
        ``gate`` are scalars (tensors on the device, or numbers)."""
        on = _on(gate, next(iter(params.values())).device)
        if on is False:
            return
        for k, p in params.items():
            g = grads[k]
            if self.clip is not None:
                g = g.clamp(-self.clip, self.clip)
            s = sq_avg[k]
            new_s = self.decay * s + (1.0 - self.decay) * g * g
            new_p = p - lr * g / (torch.sqrt(new_s) + self.eps)
            _put(p, new_p, on)
            _put(s, new_s, on)


class AdamState(NamedTuple):
    mu: Moments           # first moments per named parameter
    nu: Moments           # second moments
    count: torch.Tensor   # int32 scalar on the device: applied steps


class Adam(NamedTuple):
    b1: float = 0.5
    b2: float = 0.999
    eps: float = 1e-8
    clip: Optional[float] = None

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamState:
        """Zero moments and count."""
        device = next(iter(params.values())).device
        return AdamState({k: torch.zeros_like(p) for k, p in params.items()},
                         {k: torch.zeros_like(p) for k, p in params.items()},
                         torch.zeros((), dtype=torch.int32, device=device))

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: AdamState,
               params: Mapping[str, torch.Tensor], lr: torch.Tensor,
               gate=1.0) -> None:
        """One gated step, in place on ``params`` and ``state``."""
        on = _on(gate, state.count.device)
        if on is False:
            return
        count = state.count + (1 if on is True else on.to(torch.int32))
        t = count.clamp_min(1).float()
        bc1 = 1.0 - torch.pow(self.b1, t)
        bc2 = 1.0 - torch.pow(self.b2, t)
        for k, p in params.items():
            g = grads[k]
            if self.clip is not None:
                g = g.clamp(-self.clip, self.clip)
            m, v = state.mu[k], state.nu[k]
            new_m = self.b1 * m + (1.0 - self.b1) * g
            new_v = self.b2 * v + (1.0 - self.b2) * g * g
            new_p = p - lr * (new_m / bc1) / (torch.sqrt(new_v / bc2) + self.eps)
            _put(p, new_p, on)
            _put(m, new_m, on)
            _put(v, new_v, on)
        _put(state.count, count, on)


def exponential_lr(base_lr: float, gamma: float, steps_per_epoch: int):
    """``ExponentialLR(gamma)`` stepped per epoch
    (``train_vgan_stage1.py:277,448``): step (int tensor) -> fp32 lr. gamma
    is an fp32 tensor made once per device."""

    def schedule(step: torch.Tensor) -> torch.Tensor:
        epoch = torch.div(step, steps_per_epoch, rounding_mode="floor")
        return base_lr * torch.pow(constant(gamma, torch.float32, step.device), epoch.float())

    return schedule


def step_lr(base_lr: float, step_size: int, gamma: float, steps_per_epoch: int):
    """``StepLR(step_size, gamma)`` stepped per epoch
    (``train_wae_stage1.py:226-228``): step (int tensor) -> fp32 lr."""

    def schedule(step: torch.Tensor) -> torch.Tensor:
        epoch = torch.div(step, steps_per_epoch, rounding_mode="floor")
        k = torch.div(epoch, step_size, rounding_mode="floor")
        return base_lr * torch.pow(constant(gamma, torch.float32, step.device), k.float())

    return schedule
