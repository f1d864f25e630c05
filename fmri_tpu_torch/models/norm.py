"""BatchNorm2d with the optional hand-written backward of ``ops/bn.py``.

Counterpart of ``fmri_tpu/models/norm.py:33-128``. With ``pallas=False`` this
is ``torch.nn.BatchNorm2d``. With ``pallas=True`` train mode runs through
:func:`fmri_tpu_torch.ops.bn.batch_norm_train`, whose backward is the two
CUDA passes (reduce + apply); eval mode takes the running statistics either
way. The flag keeps the JAX config's name (``ModelConfig.pallas_bn``).

Both paths keep torch's semantics, which the JAX class reproduces:
momentum 0.9 as the weight of the new batch (``running = 0.1 * running +
0.9 * batch``), eps 1e-5, and the running variance ticked with the unbiased
variance ``var * n / (n - 1)`` over the n reduced elements, while the
output is normalised with the biased one.
"""

from __future__ import annotations

import torch
from torch import nn

from fmri_tpu_torch.ops.bn import batch_norm_train

BN_MOMENTUM = 0.9
BN_EPS = 1e-5


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d(c, eps=1e-5, momentum=0.9)``; ``pallas=True`` routes
    train mode through the hand-written backward. Same parameters, buffers
    and state-dict keys either way."""

    def __init__(self, num_features: int, pallas: bool = False):
        super().__init__(num_features, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.pallas = pallas

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.pallas and self.training):
            return super().forward(x)
        y, mu, var = batch_norm_train(x, self.weight, self.bias, self.eps)
        n = x.numel() // x.shape[1]
        unbias = n / (n - 1.0) if n > 1 else 1.0
        m = self.momentum
        with torch.no_grad():
            # new tensors, never views of the buffers: nothing autograd saved
            # aliases a running statistic
            self.running_mean.mul_(1.0 - m).add_(m * mu)
            self.running_var.mul_(1.0 - m).add_(m * unbias * var)
            self.num_batches_tracked.add_(1)
        return y
