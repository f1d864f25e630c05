"""Datasets: fixed-shape packed-array views over the reference's data sources.

The port's copy of ``fmri_tpu/data/datasets.py``. The reference streams
variable-shape images through per-item Python transforms in DataLoader
workers (``data_preprocessing/data_loader.py``). Here the decode, crop and
resize happen **once** into packed float32 arrays, optionally cached as
uint8 ``.npz`` (keys ``images`` and ``fmri``, the JAX package's, so a cache
written by either package loads in the other); training then indexes
fixed-shape host arrays and ships whole batches to the card, where the
per-batch augmentations run (``fmri_tpu_torch.data.transforms``). PIL and
scipy are imported inside the functions that need them.

Covered sources (reference citations inline):
  * ``CocoImages``      — flat-dir JPEGs for Stage I (``data_loader.py:346-371``)
  * ``BoldRoiDataset``  — {'fmri', 'image'} ROI records (``data_loader.py:220-256``)
  * ``Mnist69``         — MNIST69 fMRI-digit .mat toy set (``data_loader.py:422-454``)
  * ``Bold5000Volumes`` — raw 4-D NIfTI peak-frame averaging (``data_loader.py:26-85``)
  * ``split_subject_data`` — fixed stimuli-ID filtering (``data_loader.py:403-419``)
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from fmri_tpu_torch.data import nifti
from fmri_tpu_torch.data.transforms import (
    decode_image, grey_to_color, load_stimulus, resize_image,
)


def _list_images(data_dir: str) -> List[str]:
    exts = (".jpg", ".jpeg", ".png", ".bmp")
    names = sorted(
        os.path.join(data_dir, f) for f in os.listdir(data_dir)
        if f.lower().endswith(exts))
    return names


class CocoImages:
    """Flat-directory image dataset for Stage I (reference ``CocoDataloader``,
    ``data_loader.py:346-371``).  Accepts a directory or an explicit path list
    (the reference's pickled path-list mode)."""

    def __init__(self, source, crop: int = 375, size: int = 64):
        if isinstance(source, str):
            self.paths = _list_images(source)
        else:
            self.paths = list(source)
        self.crop = crop
        self.size = size

    def __len__(self) -> int:
        return len(self.paths)

    def get(self, idx: int) -> np.ndarray:
        return load_stimulus(self.paths[idx], self.crop, self.size)

    def as_array(self, cache: Optional[str] = None) -> np.ndarray:
        """Pack every image into a float32 [N, size, size, 3] array; cached as
        uint8 ``.npz`` so repeat runs skip the decode entirely."""
        if cache and os.path.exists(cache):
            packed = np.load(cache)["images"]
            return packed.astype(np.float32) / 255.0
        out = np.empty((len(self), self.size, self.size, 3), np.float32)
        for i in range(len(self)):
            out[i] = self.get(i)
        if cache:
            os.makedirs(os.path.dirname(cache) or ".", exist_ok=True)
            np.savez_compressed(
                cache, images=(out * 255.0 + 0.5).astype(np.uint8))
        return out


def prepare_external_data(data_dir: str, pickle_path: Optional[str] = None,
                          save: bool = False) -> List[str]:
    """RGB-only image path list builder (reference ``prepare_external_data``,
    ``data_loader.py:319-343``, deprecated there per ``data_config.py:29-30``):
    filters out greyscale files so Stage-I batches are uniformly 3-channel."""
    keep: List[str] = []
    from PIL import Image

    for path in _list_images(data_dir):
        with Image.open(path) as im:
            bands = len(im.getbands())
        if bands > 2:
            keep.append(path)
    if save and pickle_path:
        os.makedirs(os.path.dirname(pickle_path) or ".", exist_ok=True)
        with open(pickle_path, "wb") as f:
            pickle.dump(keep, f)
    return keep


def _resolve_root(path: str, root_path: Optional[str]) -> str:
    """Pure-functional version of the reference's stimulus-path rebasing.

    ``BoldRoiDataloader.__getitem__`` *mutates the shared dataset list* when
    rewriting path prefixes onto ``root_path`` (``data_loader.py:245-247``) — a
    latent DataLoader-worker race SURVEY.md §5.2 flags; here the resolution is
    side-effect free."""
    if root_path is None or root_path in path:
        return path
    prefix = path.split("BOLD5000")[0]
    return path.replace(prefix, root_path, 1)


class BoldRoiDataset:
    """The main training dataset: fMRI ROI vectors + stimulus images
    (reference ``BoldRoiDataloader``, ``data_loader.py:220-256``).

    ``records``: list of {'fmri': (num_voxels,), 'image': path} — the output of
    ``fmri_tpu_torch.data.etl.concatenate_bold_data`` or a reference-format pickle.
    """

    def __init__(self, records: Sequence[Dict], root_path: Optional[str] = None,
                 crop: int = 375, size: int = 64):
        self.records = list(records)
        self.root_path = root_path
        self.crop = crop
        self.size = size

    @classmethod
    def from_pickle(cls, path: str, **kw) -> "BoldRoiDataset":
        with open(path, "rb") as f:
            return cls(pickle.load(f), **kw)

    def __len__(self) -> int:
        return len(self.records)

    def get(self, idx: int) -> Dict[str, np.ndarray]:
        rec = self.records[idx]
        img = load_stimulus(_resolve_root(rec["image"], self.root_path),
                            self.crop, self.size)
        return {"fmri": np.asarray(rec["fmri"], np.float32), "image": img}

    def as_arrays(self, cache: Optional[str] = None) -> Dict[str, np.ndarray]:
        """Pack into {'fmri': [N, V] float32, 'image': [N, S, S, 3] float32}."""
        if cache and os.path.exists(cache):
            z = np.load(cache)
            return {"fmri": z["fmri"].astype(np.float32),
                    "image": z["images"].astype(np.float32) / 255.0}
        n = len(self)
        fmri = np.stack([np.asarray(r["fmri"], np.float32) for r in self.records])
        images = np.empty((n, self.size, self.size, 3), np.float32)
        for i in range(n):
            images[i] = self.get(i)["image"]
        if cache:
            os.makedirs(os.path.dirname(cache) or ".", exist_ok=True)
            np.savez_compressed(cache, fmri=fmri,
                                images=(images * 255.0 + 0.5).astype(np.uint8))
        return {"fmri": fmri, "image": images}


def split_subject_data(records: Sequence[Dict], reference: str) -> List[Dict]:
    """Filter records to stimuli named in a split pickle (the user's own ETL
    output, trusted as the JAX package trusts it; reference
    ``split_subject_data``, ``data_loader.py:403-419``)."""
    with open(reference, "rb") as f:
        names = set(pickle.load(f))
    return [r for r in records if os.path.basename(r["image"]) in names]


class Mnist69:
    """MNIST69 fMRI-digit toy dataset from a ``.mat`` file (reference
    ``MnistDataloader``, ``data_loader.py:422-454``; loaded at
    ``train_vgan_stage2.py:184-204``).

    Each row = [784 image pixels | voxels]; images are rot90'd + h-flipped and
    replicated to 3 channels, exactly as the reference does.
    """

    def __init__(self, mat_path: str, key: str = "D", size: Optional[int] = None):
        import scipy.io as sio

        mat = sio.loadmat(mat_path)
        if key not in mat:
            key = next(k for k in mat if not k.startswith("__"))
        self.rows = np.asarray(mat[key])
        self.size = size

    def __len__(self) -> int:
        return self.rows.shape[0]

    @property
    def num_voxels(self) -> int:
        return self.rows.shape[1] - 28 * 28

    def get(self, idx: int) -> Dict[str, np.ndarray]:
        row = self.rows[idx]
        voxels = np.asarray(row[28 * 28 :], np.float32)
        img = row[: 28 * 28].reshape(28, 28, 1).astype(np.float32) / 255.0
        img = np.flip(np.rot90(img), 1)
        img = grey_to_color(np.ascontiguousarray(img))
        if self.size and self.size != 28:
            img = resize_image(img, self.size)
        return {"fmri": voxels, "image": np.asarray(img, np.float32)}

    def as_arrays(self) -> Dict[str, np.ndarray]:
        samples = [self.get(i) for i in range(len(self))]
        return {"fmri": np.stack([s["fmri"] for s in samples]),
                "image": np.stack([s["image"] for s in samples])}


class Bold5000Volumes:
    """Raw-session dataset: per trial, load the 4-D BOLD run and average the
    peak haemodynamic frames (4-8 s post-onset) — reference
    ``Bold5000Dataloader.__getitem__`` (``data_loader.py:26-85``; frame window
    ``trial*5+2 : trial*5+4`` at ``:75``)."""

    def __init__(self, fmri_paths: Sequence[str], stimuli_paths: Sequence[str],
                 trials: Sequence[int]):
        self.fmri_paths = list(fmri_paths)
        self.stimuli_paths = list(stimuli_paths)
        # trial numbering is 1-based in the bold index (data_loader.py:39).
        self.trials = [(t - 1) * 5 for t in trials]

    def __len__(self) -> int:
        return len(self.fmri_paths)

    def get(self, idx: int) -> Dict[str, np.ndarray]:
        vol = nifti.load(self.fmri_paths[idx]).get_fdata(np.float32)
        t0 = self.trials[idx]
        voxels = vol[..., t0 + 2 : t0 + 4].mean(axis=3)
        return {"fmri": np.transpose(voxels, (2, 0, 1)),
                "image": decode_image(self.stimuli_paths[idx])}
