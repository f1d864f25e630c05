"""The part of the BOLD5000 ETL that the train and inference CLIs call:
the ROI constants, ``zscore``, ``concatenate_bold_data`` and
``split_dataset``. The port's copy of ``fmri_tpu/data/etl.py:27-35,
231-270`` (numpy only: the split needs no sklearn).
"""

from __future__ import annotations

import math
import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

SUBJECTS = ("CSI1", "CSI2", "CSI3", "CSI4")

# Cross-subject max voxels per ROI (reference ``data_config.py:62-71``); the
# concatenation of all ten zero-padded ROIs is the 3620-voxel input vector.
ROIS_MAX = {
    "LHEarlyVis": 522, "LHLOC": 455, "LHOPA": 279, "LHRSC": 86, "LHPPA": 172,
    "RHEarlyVis": 696, "RHLOC": 597, "RHOPA": 335, "RHRSC": 278, "RHPPA": 200,
}
NUM_VOXELS = 3620  # sum(ROIS_MAX.values()) (data_config.py:72)


def zscore(x: np.ndarray) -> np.ndarray:
    """Column-wise z-score as ``sklearn.preprocessing.scale``
    (``data_loader.py:286``): zero mean, unit population std; constant
    columns stay zero."""
    x = np.asarray(x, np.float64)
    mu = x.mean(axis=0)
    sd = x.std(axis=0)
    sd = np.where(sd == 0.0, 1.0, sd)
    return ((x - mu) / sd).astype(np.float32)


def concatenate_bold_data(data_dir: str,
                          subjects: Optional[Sequence[str]] = SUBJECTS) -> List[Dict]:
    """Per-subject padded ROI arrays (``<sub>/<sub>_roi_pad.pickle`` or
    ``.npz``), z-scored per subject, concatenated across subjects and zipped
    with the stimulus paths (``<sub>/<sub>_stimuli_paths.pickle``) into
    ``[{'fmri': vec, 'image': path}]`` (``data_loader.py:259-305``). The
    pickles are the user's own ETL output, trusted as the JAX loader trusts
    them."""
    records: List[Dict] = []
    for sub in (subjects or SUBJECTS):
        roi_file = os.path.join(data_dir, sub, f"{sub}_roi_pad.pickle")
        if os.path.exists(roi_file):
            with open(roi_file, "rb") as f:
                fmri = pickle.load(f)
        else:
            fmri = np.load(os.path.join(data_dir, sub, f"{sub}_roi_pad.npz"))["roi"]
        fmri = zscore(fmri)
        with open(os.path.join(data_dir, sub, f"{sub}_stimuli_paths.pickle"), "rb") as f:
            paths = pickle.load(f)
        records.extend({"fmri": v, "image": p} for v, p in zip(fmri, paths))
    return records


def split_dataset(records: Sequence, test_size: float = 0.2, seed: int = 12345):
    """The reference's final random split (``data_loader.py:495``),
    ``train_test_split(records, test_size=0.2, random_state=12345)``, in
    numpy: ``n_test = ceil(test_size * n)``, one
    ``RandomState(seed).permutation(n)``, test first. Returns (train, test)
    lists in sklearn's order."""
    records = list(records)
    n = len(records)
    n_test = math.ceil(test_size * n)
    if not 0 < n_test < n:
        raise ValueError(f"test_size={test_size} leaves an empty split of {n} records")
    perm = np.random.RandomState(seed).permutation(n)
    return ([records[i] for i in perm[n_test:]], [records[i] for i in perm[:n_test]])
