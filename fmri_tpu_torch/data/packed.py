"""Reader for packed dataset directories (numpy only), the format that
``fmri_tpu.data.packed.save_packed`` and ``fmri-tpu-prepare`` write:
``<dir>/meta.json`` plus one ``<key>.npy`` per array, float image arrays
stored as uint8 (x * 255). Counterpart of ``fmri_tpu/data/packed.py:83-121``.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

_META = "meta.json"


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
