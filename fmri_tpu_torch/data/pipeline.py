"""Input pipeline: host arrays -> fixed-shape batches on the device.

Counterpart of ``fmri_tpu/data/pipeline.py:73-166``:

* :class:`Batches` shuffles each epoch from ``(seed, epoch)`` with
  ``np.random.default_rng((seed, epoch)).permutation(n)``, the order of the
  JAX ``Batches`` and of ``train/epoch_scan.py::epoch_permutation``, and
  drops the remainder by default, so every batch has one shape;
* rows are gathered by the port's native loader (``fmri_tpu_torch.native``)
  for memory-mapped arrays and on multi-core hosts, numpy fancy indexing
  otherwise (``fmri_tpu/data/pipeline.py:36-71``); the gather writes a
  fresh array, which :func:`to_device` pins, never a view of a memmap;
  the next batch's mapped rows get a ``madvise(WILLNEED)`` read-ahead;
* :func:`device_iterator` stages batches ahead on a producer thread; on
  CUDA each copy goes from pinned host memory with ``non_blocking=True``,
  so the transfer of batch N+1 overlaps the step on batch N;
* ``shard=(d, D)``: rank d of a mesh's data axis gathers only rows
  ``[d * b / D, (d + 1) * b / D)`` of each global batch, from the same
  epoch permutation on every rank.
"""

from __future__ import annotations

import threading
from queue import Queue
from typing import Dict, Iterable, Iterator, Union

import numpy as np
import torch

from fmri_tpu_torch import native
from fmri_tpu_torch.utils.spans import span

Batch = Union[np.ndarray, Dict[str, np.ndarray]]


def num_examples(data: Batch) -> int:
    if isinstance(data, dict):
        return len(next(iter(data.values())))
    return len(data)


def _gather(v: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Row gather through the native loader where it buys something: a
    mapped array (the call releases the GIL, so the producer thread's page
    faults overlap the main thread) or a multi-core host (a parallel row
    copy); numpy fancy indexing otherwise, where both are memcpy-bound."""
    if isinstance(v, np.ndarray) and (isinstance(v, np.memmap)
                                      or native._threads_default() > 1):
        return native.gather(v, idx)
    return v[idx]


def _index(data: Batch, idx: np.ndarray) -> Batch:
    if isinstance(data, dict):
        return {k: _gather(v, idx) for k, v in data.items()}
    return _gather(data, idx)


def _prefetch_rows(data: Batch, idx: np.ndarray) -> None:
    """``madvise(WILLNEED)`` the rows of the next batch in mapped arrays (a
    no-op without the native library): on datasets larger than the page
    cache the kernel reads ahead while the current batch computes."""
    for v in (data.values() if isinstance(data, dict) else (data,)):
        if isinstance(v, np.memmap):
            native.prefetch(v, idx)


class Batches:
    """Deterministic batcher over arrays (or dicts of arrays) on the host.

    ``shuffle=True`` reshuffles every epoch from ``seed`` and the epoch
    counter, which advances on each ``__iter__`` (set ``epoch`` to resume).
    ``transform`` is applied to each host batch after indexing. ``shard=(d,
    D)`` yields data rank d's rows of each batch of ``batch_size``."""

    def __init__(self, data: Batch, batch_size: int, *, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = True, transform=None,
                 shard: tuple = (0, 1)):
        if batch_size % shard[1]:
            raise ValueError(f"batch of {batch_size} does not split over {shard[1]} ranks")
        self.shard = shard
        self.data = data
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.transform = transform
        self.epoch = 0
        n = num_examples(data)
        self.num_batches = n // batch_size if drop_last else -(-n // batch_size)
        if self.num_batches == 0:
            raise ValueError(f"dataset of {n} examples yields no batches of {batch_size}")

    def __len__(self) -> int:
        return self.num_batches

    def __iter__(self) -> Iterator[Batch]:
        n = num_examples(self.data)
        if self.shuffle:
            order = np.random.default_rng((self.seed, self.epoch)).permutation(n)
        else:
            order = np.arange(n)
        self.epoch += 1
        bs = self.batch_size
        d, count = self.shard
        lo, hi = d * bs // count, (d + 1) * bs // count

        def rows(b: int) -> np.ndarray:
            return order[b * bs:(b + 1) * bs][lo:hi]

        for b in range(self.num_batches):
            batch = _index(self.data, rows(b))
            if b + 1 < self.num_batches:  # read ahead one batch
                _prefetch_rows(self.data, rows(b + 1))
            yield self.transform(batch) if self.transform is not None else batch


def to_device(batch: Batch, device: torch.device):
    """A host batch as tensors on ``device``. On CUDA the copy goes from
    pinned memory with ``non_blocking=True``; its stream orders it before
    the steps that read it."""

    def put(v: np.ndarray) -> torch.Tensor:
        a = np.ascontiguousarray(v)
        if not a.flags.writeable:  # a view of a read-only memmap
            a = a.copy()
        t = torch.from_numpy(a)
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    if isinstance(batch, dict):
        return {k: put(v) for k, v in batch.items()}
    return put(batch)


def device_iterator(batches: Iterable[Batch], device: torch.device,
                    prefetch: int = 2):
    """Yield the host ``batches`` as tensors on ``device``, ``prefetch``
    batches staged ahead by a producer thread (0: in the caller's thread).
    An exception in the producer is raised in the consumer, after the
    batches staged before it."""
    device = torch.device(device)
    if prefetch <= 0:
        for batch in batches:
            with span("input.stage"):
                staged = to_device(batch, device)
            yield staged
        return

    q: Queue = Queue(maxsize=prefetch)
    end, err = object(), object()
    stop = threading.Event()

    def producer():
        try:
            for batch in batches:
                if stop.is_set():
                    return
                with span("input.stage"):
                    staged = to_device(batch, device)
                q.put(staged)
        except BaseException as e:  # surfaced in the consumer, not swallowed
            q.put((err, e))
        else:
            q.put(end)

    thread = threading.Thread(target=producer, daemon=True, name="device-iterator")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                break
            if isinstance(item, tuple) and len(item) == 2 and item[0] is err:
                raise item[1]
            yield item
    finally:
        # a consumer that stops early leaves the producer blocked on put():
        # stop it and drain until it ends, so its thread and staged batches go
        stop.set()
        while thread.is_alive():
            while not q.empty():
                q.get_nowait()
            thread.join(timeout=0.01)
