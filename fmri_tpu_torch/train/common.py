"""Shared pieces of the train steps (``fmri_tpu/train/common.py:26-49``)."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn


def gate_float(flag: torch.Tensor) -> torch.Tensor:
    """A device boolean as a float32 0/1 scalar."""
    return flag.to(torch.float32)


def _batch_norms(module: nn.Module):
    return [(name, m) for name, m in module.named_modules()
            if isinstance(m, nn.modules.batchnorm._BatchNorm)]


def bn_stats(module: nn.Module) -> Dict[str, tuple]:
    """A copy of every BatchNorm's running mean and variance in ``module``,
    the ``before`` of :func:`bn_extra_ticks`."""
    return {name: (m.running_mean.clone(), m.running_var.clone())
            for name, m in _batch_norms(module)}


@torch.no_grad()
def bn_extra_ticks(module: nn.Module, before: Dict[str, tuple], extra: int) -> None:
    """Advance every BatchNorm of ``module`` by ``extra`` more EMA ticks of
    the batch statistics its last tick took, in place.

    The reference runs the same forward on the same batch more than once
    per step (the WAE encoder, ``train_wae_stage1.py:275,296``), ticking the
    running statistics each time. With m = 1 - ``momentum`` (torch's
    momentum 0.9 is the new batch's weight; the JAX package's flax momentum
    0.1 is m itself, ``fmri_tpu/models/nets.py:33-36``), one tick gives new
    = m * old + (1 - m) * batch, and k = 1 + extra ticks give m^k * old +
    (1 - m^k) * batch, so batch is recovered from ``before`` and the
    current value. ``num_batches_tracked`` advances by ``extra``, as the
    repeated forwards advance it."""
    if extra <= 0:
        return
    for name, bn in _batch_norms(module):
        m = 1.0 - bn.momentum
        mk = m ** (1 + extra)
        for old, buf in zip(before[name], (bn.running_mean, bn.running_var)):
            batch = (buf - m * old) / (1.0 - m)
            buf.copy_(mk * old + (1.0 - mk) * batch)
        bn.num_batches_tracked.add_(extra)
