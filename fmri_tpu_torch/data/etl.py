"""Offline ETL: BOLD5000 session aggregation, ROI extraction, splits.

The port's copy of ``fmri_tpu/data/etl.py``: the stimulus path helpers,
the session index (the reference's absent ``bold_parser.py``, schema at
``data_preprocessing/readme.md:61-75``), ROI padding and concatenation, the
stimulus lists, the fixed stimulus split, ``zscore``,
``concatenate_bold_data``, ``split_dataset`` and the mask-based extraction.

It needs neither pandas nor sklearn: ``events.tsv`` files are read with the
``csv`` module, giving what ``pandas.read_csv(sep="\\t")`` gives these
functions (an empty or NA cell is NaN, so ``str`` of it is ``"nan"``; a
missing column takes the default; ``onset`` is a float), and both splits
are sklearn's ``train_test_split`` in numpy. h5py is imported inside the
two functions that read the figshare ``.h5`` ROI files, as in the JAX
package.
"""

from __future__ import annotations

import csv
import glob
import math
import os
import pickle
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

from fmri_tpu_torch.data import nifti

SUBJECTS = ("CSI1", "CSI2", "CSI3", "CSI4")

# Cross-subject max voxels per ROI (reference ``data_config.py:62-71``); the
# concatenation of all ten zero-padded ROIs is the 3620-voxel input vector.
ROIS_MAX = {
    "LHEarlyVis": 522, "LHLOC": 455, "LHOPA": 279, "LHRSC": 86, "LHPPA": 172,
    "RHEarlyVis": 696, "RHLOC": 597, "RHOPA": 335, "RHRSC": 278, "RHPPA": 200,
}
NUM_VOXELS = 3620  # sum(ROIS_MAX.values()) (data_config.py:72)

# the strings pandas.read_csv reads as NaN by default
_NA = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})


def _read_events(path: str) -> List[Dict[str, object]]:
    """The rows of a tab-separated events file as dicts: a cell pandas
    reads as NaN (empty, missing at the end of a row, or a default NA
    string) is ``float('nan')``, every other cell its string. Blank lines
    are skipped, as pandas skips them."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f, delimiter="\t"))
    return [{k: (math.nan if v is None or v in _NA else v) for k, v in row.items()}
            for row in rows]


# ----------------------- stimulus path helpers -----------------------
# Reference ``data_preprocessing/data_utils.py:10-43``.


def get_identifier(filename: str, source_dataset: str) -> str:
    """Filename -> stimulus identifier per source dataset
    (``data_utils.py:10-22``)."""
    ds = source_dataset.lower()
    if ds in ("coco", "rep_coco"):
        return filename[-16:-4].lstrip("0")
    if ds in ("imagenet", "rep_imagenet"):
        return filename[:-5]
    if ds in ("scenes", "rep_scenes", "scene", "sun"):
        return filename[:-4]
    raise ValueError(f"unknown source dataset: {source_dataset}")


def get_stimuli_path(filename: str, source_dataset: str,
                     bold_stimuli_path: str) -> str:
    """Stimulus filename -> path in the BOLD5000 stimuli layout
    (``data_utils.py:25-37``)."""
    ds = source_dataset.lower()
    sub = {"coco": "COCO", "rep_coco": "COCO",
           "imagenet": "ImageNet", "rep_imagenet": "ImageNet",
           "scenes": "Scene", "rep_scenes": "Scene"}.get(ds)
    if sub is None:
        raise ValueError(f"unknown source dataset: {source_dataset}")
    return os.path.join(bold_stimuli_path, sub, filename)


def get_fmri_path(subj: int, sess: int, run: int, bold_session_path: str) -> str:
    """BOLD run path template (``data_utils.py:40-43``)."""
    return os.path.join(
        bold_session_path,
        f"sub-CSI{subj}/ses-{sess:02d}/func/"
        f"sub-CSI{subj}_ses-{sess:02d}_task-5000scenes_run-{run:02d}_bold.nii.gz")


def snake_case(name: str) -> str:
    s1 = re.sub(r"(.)([A-Z][a-z]+)", r"\1_\2", name)
    return re.sub(r"([a-z0-9])([A-Z])", r"\1_\2", s1).lower()


# ----------------------- BOLD session aggregation -----------------------


def aggregate_bold_sessions(session_dir: str, stimuli_dir: str,
                            save_path: Optional[str] = None) -> Dict[str, list]:
    """Walk the ds001499 session layout, join each run's ``events.tsv``
    rows to the BOLD file and stimulus path, and emit the aggregated index
    ``{'img_name', 'stimuli_path', 'fmri_path', 'trial', 'subject',
    'session', 'run'}`` consumed by ``roi_extraction.py:186-188`` and
    ``data_loader.py:35-39``. Trials are numbered from 1 within a run,
    rows of an unknown stimulus type included; a missing ``ImgType``
    column means ``"coco"``."""
    out = {k: [] for k in ("img_name", "stimuli_path", "fmri_path", "trial",
                           "subject", "session", "run")}
    bold_files = sorted(glob.glob(os.path.join(
        session_dir, "sub-CSI*", "ses-*", "func", "*task-5000scenes*_bold.nii.gz")))
    for bold in bold_files:
        base = os.path.basename(bold)
        m = re.match(r"sub-CSI(\d+)_ses-(\d+)_task-5000scenes_run-(\d+)_bold", base)
        if not m:
            continue
        subj, sess, run = (int(g) for g in m.groups())
        events = bold.replace("_bold.nii.gz", "_events.tsv")
        if not os.path.exists(events):
            continue
        for trial, row in enumerate(_read_events(events), start=1):
            name = str(row.get("ImgName", row.get("img_name", "")))
            source = str(row.get("ImgType", row.get("img_type", "coco")))
            try:
                spath = get_stimuli_path(name, source, stimuli_dir)
            except ValueError:
                continue
            out["img_name"].append(name)
            out["stimuli_path"].append(spath)
            out["fmri_path"].append(bold)
            out["trial"].append(trial)
            out["subject"].append(subj)
            out["session"].append(sess)
            out["run"].append(run)
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        with open(save_path, "wb") as f:
            pickle.dump(out, f)
    return out


# ----------------------- ROI extraction (production path) -----------------------


def max_roi_length(roi_dir: str, subjects: Sequence[str] = SUBJECTS) -> Dict[str, int]:
    """Cross-subject max voxel count per ROI (``roi_extraction.py:145-169``).
    Needs h5py."""
    import h5py

    maxima: Dict[str, int] = {}
    for sub in subjects:
        path = os.path.join(roi_dir, sub, "h5", f"{sub}_ROIs_TR34.h5")
        with h5py.File(path, "r") as f:
            for region in f.keys():
                n = f[region].shape[1]
                if n > maxima.get(region, 0):
                    maxima[region] = n
    return maxima


def extract_roi(roi_dir: str, out_dir: Optional[str] = None,
                subjects: Sequence[str] = SUBJECTS,
                save: bool = False) -> Dict[str, np.ndarray]:
    """Zero-pad each subject's ROIs to the cross-subject max and
    concatenate -> [n_trials, 3620] per subject (``roi_extraction.py:107-142``;
    pad at ``:128``), in h5py's (alphabetical) group order. Returns
    {subject: array}; with ``save`` also writes the reference-compatible
    ``{sub}_roi_pad.pickle`` plus an ``.npz``. Needs h5py."""
    import h5py

    max_roi = max_roi_length(roi_dir, subjects)
    out: Dict[str, np.ndarray] = {}
    for sub in subjects:
        path = os.path.join(roi_dir, sub, "h5", f"{sub}_ROIs_TR34.h5")
        with h5py.File(path, "r") as f:
            parts = []
            for region in f.keys():
                item = np.asarray(f[region])
                pad = max_roi[region] - item.shape[1]
                parts.append(np.pad(item, ((0, 0), (0, pad))))
        arr = np.concatenate(parts, axis=1)
        out[sub] = arr
        if save and out_dir:
            sub_dir = os.path.join(out_dir, sub)
            os.makedirs(sub_dir, exist_ok=True)
            with open(os.path.join(sub_dir, f"{sub}_roi_pad.pickle"), "wb") as f:
                pickle.dump(arr, f)
            np.savez_compressed(os.path.join(sub_dir, f"{sub}_roi_pad.npz"), roi=arr)
    return out


def _stimulus_names(path: str) -> List[str]:
    """The stimulus names of a ``stim_lists`` file, ``rep_`` prefix removed."""
    names = []
    with open(path) as f:
        for line in f:
            name = line.strip()
            if name.startswith("rep_"):
                name = name[4:]
            names.append(name)
    return names


def find_stimuli_path(bold_index: Dict[str, list], stim_lists_dir: str,
                      out_dir: Optional[str] = None,
                      save: bool = False) -> Dict[str, List[str]]:
    """Match each subject's ``stim_lists/*.txt`` entries (stripping the
    ``rep_`` prefix) to stimulus paths from the aggregated bold index
    (``roi_extraction.py:172-215``). Returns {subject: [paths]}."""
    pairs = dict(zip(bold_index["img_name"], bold_index["stimuli_path"]))
    out: Dict[str, List[str]] = {}
    for txt in sorted(glob.glob(os.path.join(stim_lists_dir, "*.txt"))):
        paths = [pairs[name] for name in _stimulus_names(txt) if name in pairs]
        base = os.path.basename(txt)          # e.g. CSI01_stim_lists.txt
        sub = base[:3] + base[4]              # 'CSI' + '1' (roi_extraction.py:210)
        out[sub] = paths
        if save and out_dir:
            sub_dir = os.path.join(out_dir, sub)
            os.makedirs(sub_dir, exist_ok=True)
            with open(os.path.join(sub_dir, f"{sub}_stimuli_paths.pickle"), "wb") as f:
                pickle.dump(paths, f)
    return out


def train_test_stimuli_split(stim_list_file: str, out_dir: Optional[str] = None,
                             ratio: float = 0.1, seed: int = 12345,
                             save: bool = False):
    """Fixed 90/10 split of the unique stimulus IDs, ``random_state=12345``
    (``roi_extraction.py:218-245``; sklearn split at ``:239``), split as
    :func:`split_dataset` splits. The IDs are ``list(set(names))``, as in
    the JAX function: their order, and so the split, follows the string
    hash seed (``PYTHONHASHSEED``)."""
    unique = list(set(_stimulus_names(stim_list_file)))
    train, test = split_dataset(unique, test_size=ratio, seed=seed)
    if save and out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "stimuli_train.pickle"), "wb") as f:
            pickle.dump(train, f)
        with open(os.path.join(out_dir, "stimuli_valid.pickle"), "wb") as f:
            pickle.dump(test, f)
    return train, test


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


# ----------------------- mask-based extraction (full pipeline) -----------------------


def extract_roi_by_mask(preproc_dir: str, events_dir: str, mask_dir: str,
                        out_dir: Optional[str] = None, save: bool = False):
    """ROI extraction from fmriprep outputs: NIfTI mask -> voxels x TRs, 5-TR
    stimulus windows from events.tsv onsets (onset/2 = starting TR), plus
    trailing no-stimulus windows (``roi_extraction.py:16-104``).

    Returns {subject: (X, Y, meta)} where X is a list of [5, voxels] windows,
    Y the stimulus names ('none' for blanks; an empty name is NaN, as
    pandas reads it), meta a list of dicts."""
    results = {}
    mask_files = sorted(glob.glob(os.path.join(mask_dir, "*", "*.nii.gz")))
    for mask_file in mask_files:
        sub = os.path.basename(os.path.dirname(mask_file))
        X, Y, meta = [], [], []
        mask = nifti.load(mask_file).get_fdata().astype(bool)
        preproc_files = sorted(glob.glob(os.path.join(
            preproc_dir, sub, "*", "*", "*-5000scenes_*_preproc.nii.gz")))
        for preproc in preproc_files:
            items = os.path.basename(preproc).split("_")
            subname = items[0]
            ses = next((p for p in items if p.startswith("ses-")), "ses-01")
            run = next((p for p in items if p.startswith("run-")), "run-01")
            ev = glob.glob(os.path.join(events_dir, subname, ses, "func",
                                        f"*{run}_events.tsv"))
            if not ev:
                continue
            events = _read_events(ev[0])
            img = nifti.load(preproc).get_fdata()
            roi = img[mask]  # [voxels, TRs]
            end = 0
            for row in events:
                start = int(round(float(row["onset"])) / 2)
                end = start + 5
                X.append(roi[:, start:end].T)
                Y.append(row["ImgName"])
                meta.append({"Subject": subname, "Session": int(ses[-2:]),
                             "Run": int(run[-2:]), "ImgName": row["ImgName"]})
            if roi.shape[1] - end >= 5:
                X.append(roi[:, end : end + 5].T)
                Y.append("none")
                meta.append({"Subject": subname, "Session": int(ses[-2:]),
                             "Run": int(run[-2:]), "ImgName": "none"})
        results[sub] = (X, Y, meta)
        if save and out_dir:
            sub_dir = os.path.join(out_dir, sub)
            os.makedirs(sub_dir, exist_ok=True)
            with open(os.path.join(sub_dir, f"{sub}_fmri.pickle"), "wb") as f:
                pickle.dump(X, f)
            with open(os.path.join(sub_dir, f"{sub}_image_names.pickle"), "wb") as f:
                pickle.dump(Y, f)
    return results
