"""RMSprop with a device-side gate, and the per-epoch exponential schedule.

The port's copy of ``fmri_tpu/train/optim.py:32-66, 110-117``. The reference
skips ``optimizer.step()`` when the equilibrium gate turns a head off
(``train_vgan_stage1.py:396-432``); here the gate is a 0/1 tensor on the
device and ``torch.where`` keeps both the parameters and ``sq_avg`` when it
is 0, so a gated step needs no host sync and a skipped step leaves the
moments untouched, as torch's skipped ``step()`` does.

Numerics follow torch's RMSprop (``train_vgan_stage1.py:275-283``):
``sq_avg = a * sq_avg + (1 - a) * g^2``; ``p -= lr * g / (sqrt(sq_avg) +
eps)`` with eps outside the sqrt, and an optional elementwise clamp of g to
``[-clip, clip]`` before the moment update.

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


def exponential_lr(base_lr: float, gamma: float, steps_per_epoch: int):
    """``ExponentialLR(gamma)`` stepped per epoch
    (``train_vgan_stage1.py:277,448``): step (int tensor) -> fp32 lr."""

    def schedule(step: torch.Tensor) -> torch.Tensor:
        epoch = torch.div(step, steps_per_epoch, rounding_mode="floor")
        return base_lr * torch.pow(torch.tensor(gamma, device=step.device),
                                   epoch.float())

    return schedule
