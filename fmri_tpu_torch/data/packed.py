"""Packed dataset directories (numpy only): ``<dir>/meta.json`` plus one
``<key>.npy`` per array, float image arrays stored as uint8 (x * 255).

The writers are the port's copy of ``fmri_tpu/data/packed.py:32-80``
(``save_packed``, ``pack_images_streaming``: the same files, byte for
byte); the reader returns the arrays by key, memory-mapped, and leaves the
dequantization to the consumer. Each package's reader reads either
package's writer's output.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Sequence, Tuple, Union

import numpy as np

Arrays = Union[np.ndarray, Dict[str, np.ndarray]]

_META = "meta.json"


def _quantize_u8(v: np.ndarray) -> np.ndarray:
    """[0,1]-float -> uint8, clipped (out-of-range floats must not wrap)."""
    return (np.clip(v, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def pack_images_streaming(get_image: Callable[[int], np.ndarray], n: int,
                          shape: Tuple[int, ...], out_dir: str,
                          key: str = "image", chunk: int = 256) -> None:
    """Out-of-core packing: write ``<out_dir>/<key>.npy`` (uint8) one image at
    a time through a numpy memmap, so a dataset larger than host RAM is
    packed without the float array ever existing. ``get_image(i)`` returns
    one float [0,1] image of ``shape``."""
    os.makedirs(out_dir, exist_ok=True)
    out = np.lib.format.open_memmap(
        os.path.join(out_dir, f"{key}.npy"), mode="w+", dtype=np.uint8,
        shape=(n, *shape))
    for i in range(n):
        out[i] = _quantize_u8(np.asarray(get_image(i), np.float32))
        if chunk and (i + 1) % chunk == 0:
            out.flush()
    out.flush()
    del out
    with open(os.path.join(out_dir, _META), "w") as f:
        json.dump({"keys": [key], "quantized": [key], "num_examples": n}, f,
                  indent=2)


def save_packed(out_dir: str, arrays: Arrays, *,
                quantize: Sequence[str] = ("image", "images")) -> None:
    """Write arrays (or one array, stored under key 'image') as raw ``.npy``
    files. Arrays named in ``quantize`` are stored uint8: floats through
    :func:`_quantize_u8`, uint8 as they are. Every array must have the
    first one's length."""
    if not isinstance(arrays, dict):
        arrays = {"image": arrays}
    os.makedirs(out_dir, exist_ok=True)
    quantized = []
    n = None
    for k, v in arrays.items():
        v = np.asarray(v)
        n = len(v) if n is None else n
        if len(v) != n:
            raise ValueError(f"array '{k}' length {len(v)} != {n}")
        if k in quantize:
            if v.dtype != np.uint8:
                v = _quantize_u8(v)
            quantized.append(k)
        np.save(os.path.join(out_dir, f"{k}.npy"), v)
    with open(os.path.join(out_dir, _META), "w") as f:
        json.dump({"keys": sorted(arrays), "quantized": quantized,
                   "num_examples": n}, f, indent=2)


def is_packed_dir(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(os.path.join(path, _META))


def open_packed(path: str) -> Dict[str, np.ndarray]:
    """The packed arrays by key, memory-mapped read-only. Arrays the writer
    quantized come back as uint8; the eval path dequantizes images on the
    device (``eval.evaluate.reconstruct_dataset``)."""
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    return {k: np.load(os.path.join(path, f"{k}.npy"), mmap_mode="r")
            for k in meta["keys"]}
