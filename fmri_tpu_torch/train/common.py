"""Shared pieces of the train steps (``fmri_tpu/train/common.py:48``)."""

from __future__ import annotations

import torch


def gate_float(flag: torch.Tensor) -> torch.Tensor:
    """A device boolean as a float32 0/1 scalar."""
    return flag.to(torch.float32)
