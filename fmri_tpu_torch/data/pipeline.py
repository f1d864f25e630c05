"""Input pipeline: host arrays -> fixed-shape batches on the device.

Counterpart of ``fmri_tpu/data/pipeline.py:73-166``:

* :class:`Batches` shuffles each epoch from ``(seed, epoch)`` with
  ``np.random.default_rng((seed, epoch)).permutation(n)``, the order of the
  JAX ``Batches`` and of ``train/epoch_scan.py::epoch_permutation``, and
  drops the remainder by default, so every batch has one shape;
* :func:`device_iterator` stages batches ahead on a producer thread; on
  CUDA each copy goes from pinned host memory with ``non_blocking=True``,
  so the transfer of batch N+1 overlaps the step on batch N.

Rows are gathered with numpy fancy indexing. The JAX package's native C++
gather and its ``madvise`` read-ahead for memory-mapped arrays
(``fmri_tpu/native/loader.cc``, used at ``pipeline.py:36-71``) are not in
the port yet.
"""

from __future__ import annotations

import threading
from queue import Queue
from typing import Dict, Iterable, Iterator, Union

import numpy as np
import torch

Batch = Union[np.ndarray, Dict[str, np.ndarray]]


def num_examples(data: Batch) -> int:
    if isinstance(data, dict):
        return len(next(iter(data.values())))
    return len(data)


def _index(data: Batch, idx: np.ndarray) -> Batch:
    if isinstance(data, dict):
        return {k: v[idx] for k, v in data.items()}
    return data[idx]


class Batches:
    """Deterministic batcher over arrays (or dicts of arrays) on the host.

    ``shuffle=True`` reshuffles every epoch from ``seed`` and the epoch
    counter, which advances on each ``__iter__`` (set ``epoch`` to resume).
    ``transform`` is applied to each host batch after indexing."""

    def __init__(self, data: Batch, batch_size: int, *, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = True, transform=None):
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
        for b in range(self.num_batches):
            batch = _index(self.data, order[b * self.batch_size:(b + 1) * self.batch_size])
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
            yield to_device(batch, device)
        return

    q: Queue = Queue(maxsize=prefetch)
    end, err = object(), object()
    stop = threading.Event()

    def producer():
        try:
            for batch in batches:
                if stop.is_set():
                    return
                q.put(to_device(batch, device))
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
