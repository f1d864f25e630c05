"""RMSprop and Adam with a device-side gate, and the per-epoch exponential
and step schedules.

The port's copy of ``fmri_tpu/train/optim.py:32-127``. The reference skips
``optimizer.step()`` when the equilibrium gate turns a head off
(``train_vgan_stage1.py:396-432``); here the gate is a 0/1 tensor on the
device and ``torch.where`` keeps the parameters and the moments when it is
0, so a gated step needs no host sync and a skipped step leaves the moments
untouched, as torch's skipped ``step()`` does.

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

Moments = Dict[str, torch.Tensor]


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
        on = torch.as_tensor(gate, device=next(iter(params.values())).device) != 0
        for k, p in params.items():
            g = grads[k]
            if self.clip is not None:
                g = g.clamp(-self.clip, self.clip)
            s = sq_avg[k]
            new_s = self.decay * s + (1.0 - self.decay) * g * g
            new_p = p - lr * g / (torch.sqrt(new_s) + self.eps)
            p.copy_(torch.where(on, new_p, p))
            s.copy_(torch.where(on, new_s, s))


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
        on = torch.as_tensor(gate, device=state.count.device) != 0
        count = state.count + on.to(torch.int32)
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
            p.copy_(torch.where(on, new_p, p))
            m.copy_(torch.where(on, new_m, m))
            v.copy_(torch.where(on, new_v, v))
        state.count.copy_(torch.where(on, count, state.count))


def exponential_lr(base_lr: float, gamma: float, steps_per_epoch: int):
    """``ExponentialLR(gamma)`` stepped per epoch
    (``train_vgan_stage1.py:277,448``): step (int tensor) -> fp32 lr."""

    def schedule(step: torch.Tensor) -> torch.Tensor:
        epoch = torch.div(step, steps_per_epoch, rounding_mode="floor")
        return base_lr * torch.pow(torch.tensor(gamma, device=step.device),
                                   epoch.float())

    return schedule


def step_lr(base_lr: float, step_size: int, gamma: float, steps_per_epoch: int):
    """``StepLR(step_size, gamma)`` stepped per epoch
    (``train_wae_stage1.py:226-228``): step (int tensor) -> fp32 lr."""

    def schedule(step: torch.Tensor) -> torch.Tensor:
        epoch = torch.div(step, steps_per_epoch, rounding_mode="floor")
        k = torch.div(epoch, step_size, rounding_mode="floor")
        return base_lr * torch.pow(torch.tensor(gamma, device=step.device), k.float())

    return schedule
