"""BatchNorm with the optional hand-written backward of ``ops/bn.py`` and
the ``vsplit`` sub-batches of the fused decoder batch.

Counterpart of ``fmri_tpu/models/norm.py:33-168``. With ``pallas=False``
:class:`BatchNorm2d` is ``torch.nn.BatchNorm2d``. With ``pallas=True`` train
mode runs through :func:`fmri_tpu_torch.ops.bn.batch_norm_train`, whose
backward is the two CUDA passes (reduce + apply); eval mode takes the
running statistics either way. The flag keeps the JAX config's name
(``ModelConfig.pallas_bn``). :class:`BatchNorm1d` (the FC BatchNorms) is
``torch.nn.BatchNorm1d`` and has no kernel path, as in the JAX package.

Every path keeps torch's semantics, which the JAX class reproduces:
momentum 0.9 as the weight of the new batch (``running = 0.1 * running +
0.9 * batch``), eps 1e-5, and the running variance ticked with the unbiased
variance ``var * n / (n - 1)`` over the n reduced elements, while the
output is normalised with the biased one.

``forward(x, vsplit=k)`` in train mode treats the leading axis as k
back-to-back sub-batches (``fmri_tpu/models/norm.py:47-56,130-168``): each
is normalised with its own statistics and the running statistics tick k
times in order, so one fused k*B pass equals k sequential B passes. Its
statistics are the JAX class's ``mean`` and ``max(0, E[x^2] - mean^2)``,
not torch's two-pass variance: outputs and gradients agree with k
sequential calls to fp32 rounding (within 1e-5 on inputs of scale 1-2,
``tests/test_torch_modes.py``). ``vsplit > 1`` with ``pallas=True``
raises; eval mode ignores ``vsplit``.
"""

from __future__ import annotations

import torch
from torch import nn

from fmri_tpu_torch.ops.bn import batch_norm_train

BN_MOMENTUM = 0.9
BN_EPS = 1e-5


@torch.no_grad()
def _tick(bn: nn.modules.batchnorm._BatchNorm, mu: torch.Tensor,
          var: torch.Tensor, n: int) -> None:
    """One running-statistics tick from a batch's mean and biased variance
    over n elements per channel. It writes through ``.data``, as torch's
    own BatchNorm kernel writes the buffers, so the version counter stays:
    a graph in which torch's train-mode BatchNorm saved the statistics (it
    saves them and does not use them) can still be pulled back."""
    unbias = n / (n - 1.0) if n > 1 else 1.0
    m = bn.momentum
    bn.running_mean.data.mul_(1.0 - m).add_(m * mu)
    bn.running_var.data.mul_(1.0 - m).add_(m * unbias * var)
    bn.num_batches_tracked.data.add_(1)


def _vsplit_train(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
                  k: int) -> torch.Tensor:
    """Train-mode BatchNorm of x [k * B, C, ...] with per-sub-batch
    statistics, in the JAX class's order of operations."""
    if x.shape[0] % k:
        raise ValueError(f"BatchNorm(vsplit={k}): leading dim {x.shape[0]} "
                         "not divisible")
    c = x.shape[1]
    xs = x.reshape(k, x.shape[0] // k, *x.shape[1:]).float()
    dims = [1] + list(range(3, xs.dim()))
    mu = xs.mean(dims)                                          # [k, C]
    var = ((xs * xs).mean(dims) - mu * mu).clamp_min(0.0)      # biased
    shape = [k, 1, c] + [1] * (x.dim() - 2)
    mul = torch.rsqrt(var.view(shape) + bn.eps) * bn.weight.view(shape[1:])
    y = (xs - mu.view(shape)) * mul + bn.bias.view(shape[1:])
    n = x.numel() // (k * c)
    for i in range(k):  # sequential ticks, reference order
        _tick(bn, mu[i], var[i], n)
    return y.reshape(x.shape).to(x.dtype)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d(c, eps=1e-5, momentum=0.9)``; ``pallas=True`` routes
    train mode through the hand-written backward. Same parameters, buffers
    and state-dict keys either way."""

    def __init__(self, num_features: int, pallas: bool = False):
        super().__init__(num_features, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.pallas = pallas

    def forward(self, x: torch.Tensor, vsplit: int = 1) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if vsplit > 1:
            if self.pallas:
                raise ValueError("BatchNorm: vsplit>1 + pallas is unsupported")
            return _vsplit_train(self, x, vsplit)
        if not self.pallas:
            return super().forward(x)
        y, mu, var = batch_norm_train(x, self.weight, self.bias, self.eps)
        _tick(self, mu, var, x.numel() // x.shape[1])
        return y


class BatchNorm1d(nn.BatchNorm1d):
    """``nn.BatchNorm1d(c, eps=1e-5, momentum=0.9)`` over [N, C], with
    ``vsplit``."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor, vsplit: int = 1) -> torch.Tensor:
        if self.training and vsplit > 1:
            return _vsplit_train(self, x, vsplit)
        return super().forward(x)
