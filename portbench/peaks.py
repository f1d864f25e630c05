"""Published peaks of one NVIDIA H100 SXM and the least time of a piece of
work: a frozen copy of ``PEAK_*`` and ``bound()`` of ``chip_smoke.py``
(the data sheet's dense rates; fp32 outside the tensor cores, bf16 on
them; HBM3 bandwidth). They assume the full 700 W limit."""

from __future__ import annotations

PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

PEAK_BY_DTYPE = {"float32": PEAK_FP32_FLOPS, "bfloat16": PEAK_BF16_FLOPS}


def least_seconds(flops: float, nbytes: float, peak: float) -> float:
    """The larger of the operations at ``peak`` and the bytes at the memory
    rate: the least time the chip could take."""
    return max(flops / peak, nbytes / PEAK_BYTES_PER_S)
