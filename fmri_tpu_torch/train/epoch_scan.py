"""Device-resident epochs: the whole training set on the device, each batch
gathered there by the epoch's permutation.

Counterpart of ``fmri_tpu/train/epoch_scan.py``. The JAX package runs such
an epoch as one ``lax.scan`` program; PyTorch has no scan, so here the
trainer's Python loop stays and only the host gather and copy go: each
batch is an ``index_select`` of the device-resident arrays. The order is
the host loop's (``data/pipeline.py::Batches`` draws the same permutation),
and the trainer hands both loops the same draws, so an epoch gives exactly
the host loop's result. (The JAX scan splits its keys from the scan carry,
so its draws differ from its own host loop's.)
"""

from __future__ import annotations

from typing import Dict, Iterator, Union

import numpy as np
import torch

DeviceData = Union[torch.Tensor, Dict[str, torch.Tensor]]


def epoch_permutation(n: int, batch_size: int, seed: int, epoch: int) -> np.ndarray:
    """Deterministic drop-remainder permutation (mirrors
    ``fmri_tpu_torch.data.pipeline.Batches`` shuffling)."""
    rng = np.random.default_rng((seed, epoch))
    nb = n // batch_size
    return rng.permutation(n)[: nb * batch_size].astype(np.int32)


def device_epoch(data: DeviceData, perm: torch.Tensor, batch_size: int,
                 shard: tuple = (0, 1)) -> Iterator[DeviceData]:
    """The epoch's batches of the device-resident ``data``: rows
    ``perm[b * batch_size:(b + 1) * batch_size]`` of every array, gathered
    on the device; with ``shard=(d, D)`` data rank d's part of each (every
    rank keeps the whole set and the same permutation, as ``Batches``)."""
    idx = perm.long()
    d, count = shard
    lo, hi = d * batch_size // count, (d + 1) * batch_size // count
    for b in range(len(idx) // batch_size):
        rows = idx[b * batch_size:(b + 1) * batch_size][lo:hi]
        if isinstance(data, dict):
            yield {k: v.index_select(0, rows) for k, v in data.items()}
        else:
            yield data.index_select(0, rows)
