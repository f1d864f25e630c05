"""The port's raw-data modules against the JAX package's, bitwise, on files
made here: NIfTI written by each package and read by the other (gz,
big-endian, integer types, scaling); the host image functions
(``center_crop``, ``resize_image``, ``grey_to_color``, ``decode_image``,
``load_stimulus``); every dataset class and helper, with the ``.npz``
caches loaded across packages both ways; and ``zscore``,
``concatenate_bold_data`` and ``split_dataset`` (numpy in the port,
sklearn in the JAX package)."""

import gzip
import math
import os
import pickle
import struct

import numpy as np
import pytest
from PIL import Image

from fmri_tpu.data import datasets as jax_datasets
from fmri_tpu.data import etl as jax_etl
from fmri_tpu.data import nifti as jax_nifti
from fmri_tpu.data import transforms as jax_transforms
from fmri_tpu_torch.data import datasets, etl, nifti, transforms


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _same_dict(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        _same(a[k], b[k])


# ----------------------------------------------------------------- fixtures


def _stimulus(path, mode, size, seed):
    rng = np.random.default_rng(seed)
    h, w = size
    if mode == "L":
        arr = rng.integers(0, 256, (h, w), dtype=np.uint8)
    elif mode == "I;16":
        arr = rng.integers(0, 65536, (h, w), dtype=np.uint16)
    else:
        arr = rng.integers(0, 256, (h, w, len(mode)), dtype=np.uint8)
    Image.fromarray(arr).save(path)  # uint16 -> I;16, 2-D uint8 -> L
    return path


STIMULI = [("RGB", "png"), ("RGB", "jpg"), ("L", "png"), ("RGBA", "png"), ("I;16", "png")]


@pytest.fixture
def image_dir(tmp_path):
    """Stimuli of every mode, some smaller than the crop."""
    d = tmp_path / "imgs"
    d.mkdir()
    for i, (mode, ext) in enumerate(STIMULI[:4] * 2):
        size = (30, 26) if i % 3 == 0 else (17, 23)
        _stimulus(str(d / f"img_{i:03d}.{ext}"), mode, size, seed=i)
    (d / "notes.txt").write_text("not an image")
    return str(d)


@pytest.fixture
def bold_dir(tmp_path, image_dir):
    """A CSI* ROI dir: CSI1 as .npz, CSI2 as a reference pickle, stimulus
    paths naming another machine's BOLD5000 tree, whose images are under
    ``tmp_path/data/BOLD5000`` (``root_path`` rebases them there)."""
    import shutil

    rng = np.random.default_rng(5)
    names = sorted(os.listdir(image_dir))[:-1]
    shutil.copytree(image_dir, tmp_path / "data" / "BOLD5000")
    for sub, n, fmt in (("CSI1", 7, "npz"), ("CSI2", 5, "pickle")):
        d = tmp_path / "bold" / sub
        d.mkdir(parents=True)
        roi = rng.normal(2.0, 3.0, (n, 11))
        roi[:, 3] = 1.5  # a constant column stays zero
        if fmt == "npz":
            np.savez(d / f"{sub}_roi_pad.npz", roi=roi)
        else:
            with open(d / f"{sub}_roi_pad.pickle", "wb") as f:
                pickle.dump(roi, f)
        paths = [f"/other/host/BOLD5000/{names[i % len(names)]}" for i in range(n)]
        with open(d / f"{sub}_stimuli_paths.pickle", "wb") as f:
            pickle.dump(paths, f)
    return str(tmp_path / "bold")


# -------------------------------------------------------------------- nifti


def _big_endian_nifti(path, data, slope, inter):
    """A NIfTI-1 file in big-endian byte order with scaling, written by hand
    (neither package's writer emits one)."""
    data = np.asarray(data, np.int16)
    hdr = bytearray(348)
    struct.pack_into(">i", hdr, 0, 348)
    dim = [data.ndim, *data.shape] + [1] * (7 - data.ndim)
    struct.pack_into(">8h", hdr, 40, *dim)
    struct.pack_into(">h", hdr, 70, 4)
    struct.pack_into(">h", hdr, 72, 16)
    struct.pack_into(">f", hdr, 108, 352.0)
    struct.pack_into(">2f", hdr, 112, slope, inter)
    hdr[344:348] = b"n+1\x00"
    payload = bytes(hdr) + bytes(4) + data.astype(">i2").tobytes(order="F")
    with (gzip.open if path.endswith(".gz") else open)(path, "wb") as f:
        f.write(payload)


@pytest.mark.parametrize("dtype", [np.int16, np.float32, np.float64])
@pytest.mark.parametrize("name", ["v.nii", "v.nii.gz"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_nifti_written_by_either_package_reads_in_both(tmp_path, writer, name, dtype):
    rng = np.random.default_rng(6)
    vol = (rng.normal(size=(3, 4, 5, 2)) * 50).astype(dtype)
    path = str(tmp_path / name)
    (nifti if writer == "port" else jax_nifti).save(path, vol)
    other = str(tmp_path / ("o" + name))
    (jax_nifti if writer == "port" else nifti).save(other, vol)
    with (gzip.open if name.endswith(".gz") else open)(path, "rb") as f, \
            (gzip.open if name.endswith(".gz") else open)(other, "rb") as g:
        assert f.read() == g.read()  # the two writers, byte for byte
    ours, theirs = nifti.load(path), jax_nifti.load(path)
    assert ours.shape == theirs.shape == vol.shape and ours.header == theirs.header
    _same(ours.get_fdata(), theirs.get_fdata())
    _same(ours.get_data(np.float32), theirs.get_fdata(np.float32))
    np.testing.assert_array_equal(ours.get_fdata(vol.dtype), vol)


@pytest.mark.parametrize("name", ["be.nii", "be.nii.gz"])
def test_nifti_big_endian_scaled(tmp_path, name):
    vol = np.arange(-12, 12, dtype=np.int16).reshape(2, 3, 4)
    path = str(tmp_path / name)
    _big_endian_nifti(path, vol, 0.5, 3.0)
    ours, theirs = nifti.load(path), jax_nifti.load(path)
    _same(ours.get_fdata(), theirs.get_fdata())
    np.testing.assert_array_equal(ours.get_fdata(), vol * 0.5 + 3.0)
    assert ours.header == theirs.header


def test_nifti_rejects_what_jax_rejects(tmp_path):
    path = str(tmp_path / "bad.nii")
    with open(path, "wb") as f:
        f.write(b"\x00" * 100)
    for mod in (nifti, jax_nifti):
        with pytest.raises(ValueError, match="truncated"):
            mod.load(path)


# --------------------------------------------------------------- transforms


@pytest.mark.parametrize("mode,ext", STIMULI, ids=lambda v: v.replace(";", ""))
def test_host_image_functions_are_jax_bitwise(tmp_path, mode, ext):
    path = _stimulus(str(tmp_path / f"s.{ext}"), mode, (41, 29), seed=7)
    _same(transforms.decode_image(path), jax_transforms.decode_image(path))
    for crop, size in ((20, 16), (64, 8), (29, 29)):
        _same(transforms.load_stimulus(path, crop, size),
              jax_transforms.load_stimulus(path, crop, size))
    img = transforms.decode_image(path)
    _same(transforms.center_crop(img, 17), jax_transforms.center_crop(img, 17))


@pytest.mark.parametrize("shape", [(9, 7), (9, 7, 1), (9, 7, 3), (9, 7, 4)])
def test_resize_and_grey_to_color_are_jax_bitwise(shape):
    img = np.random.default_rng(8).uniform(-0.2, 1.2, shape).astype(np.float32)
    _same(transforms.grey_to_color(img), jax_transforms.grey_to_color(img))
    if shape[-1] != 4:
        for size in (4, 16):
            _same(transforms.resize_image(img, size), jax_transforms.resize_image(img, size))


# ----------------------------------------------------------------- datasets


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_coco_images_and_their_cache_cross_load(tmp_path, image_dir, writer):
    ours = datasets.CocoImages(image_dir, crop=20, size=16)
    theirs = jax_datasets.CocoImages(image_dir, crop=20, size=16)
    assert ours.paths == theirs.paths and len(ours) == 8
    cache = str(tmp_path / "c" / "coco.npz")
    first = (ours if writer == "port" else theirs).as_array(cache)
    _same(first, (theirs if writer == "port" else ours).as_array())
    # the other package reads the cache it did not write
    _same((theirs if writer == "port" else ours).as_array(cache),
          (ours if writer == "port" else theirs).as_array(cache))
    assert sorted(np.load(cache)) == ["images"]
    _same(datasets.CocoImages(ours.paths[:3], 20, 16).as_array(), first[:3])


def test_prepare_external_data_keeps_rgb(tmp_path, image_dir):
    pk = str(tmp_path / "p" / "keep.pickle")
    keep = datasets.prepare_external_data(image_dir, pk, save=True)
    assert keep == jax_datasets.prepare_external_data(image_dir)
    assert len(keep) == 6  # greyscale dropped
    with open(pk, "rb") as f:
        assert pickle.load(f) == keep


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_bold_roi_dataset_and_its_cache_cross_load(tmp_path, bold_dir, writer):
    records = etl.concatenate_bold_data(bold_dir + "/", ("CSI1", "CSI2"))
    root = str(tmp_path / "data") + "/"
    for path in (records[0]["image"], root + "BOLD5000/x.png"):
        for r in (None, root):
            assert datasets._resolve_root(path, r) == jax_datasets._resolve_root(path, r)
    ours = datasets.BoldRoiDataset(records, root_path=root, crop=20, size=16)
    theirs = jax_datasets.BoldRoiDataset(records, root_path=root, crop=20, size=16)
    _same_dict(ours.get(3), theirs.get(3))
    assert records[3]["image"].startswith("/other/host/")  # rebased, not rewritten
    cache = str(tmp_path / "bold.npz")
    first = (ours if writer == "port" else theirs).as_arrays(cache)
    _same_dict(first, (theirs if writer == "port" else ours).as_arrays())
    _same_dict((theirs if writer == "port" else ours).as_arrays(cache),
               (ours if writer == "port" else theirs).as_arrays(cache))
    assert sorted(np.load(cache)) == ["fmri", "images"]
    pk = str(tmp_path / "records.pickle")
    with open(pk, "wb") as f:
        pickle.dump(records, f)
    _same_dict(datasets.BoldRoiDataset.from_pickle(pk, root_path=root, crop=20,
                                                   size=16).as_arrays(), first)


def test_split_subject_data(tmp_path, bold_dir):
    records = etl.concatenate_bold_data(bold_dir + "/", ("CSI1", "CSI2"))
    names = sorted({os.path.basename(r["image"]) for r in records})[::2]
    ref = str(tmp_path / "split.pickle")
    with open(ref, "wb") as f:
        pickle.dump(names, f)
    ours = datasets.split_subject_data(records, ref)
    theirs = jax_datasets.split_subject_data(records, ref)
    assert [r["image"] for r in ours] == [r["image"] for r in theirs] and ours
    assert all(os.path.basename(r["image"]) in names for r in ours)


@pytest.mark.parametrize("size", [None, 28, 16])
def test_mnist69(tmp_path, size):
    import scipy.io as sio

    rng = np.random.default_rng(9)
    rows = np.concatenate([rng.integers(0, 256, (6, 784)).astype(np.float64),
                           rng.normal(size=(6, 20))], axis=1)
    path = str(tmp_path / "digits.mat")
    sio.savemat(path, {"X": rows})  # not "D": the first data key is taken
    ours, theirs = datasets.Mnist69(path, size=size), jax_datasets.Mnist69(path, size=size)
    assert len(ours) == 6 and ours.num_voxels == theirs.num_voxels == 20
    _same_dict(ours.as_arrays(), theirs.as_arrays())
    assert ours.as_arrays()["image"].shape == (6, size or 28, size or 28, 3)


def test_bold5000_volumes(tmp_path, image_dir):
    rng = np.random.default_rng(10)
    vols, stims = [], sorted(os.path.join(image_dir, f) for f in os.listdir(image_dir))[:3]
    for i in range(3):
        p = str(tmp_path / f"run{i}.nii.gz")
        nifti.save(p, rng.normal(size=(4, 3, 2, 12)).astype(np.float32))
        vols.append(p)
    ours = datasets.Bold5000Volumes(vols, stims, [1, 2, 2])
    theirs = jax_datasets.Bold5000Volumes(vols, stims, [1, 2, 2])
    for i in range(3):
        _same_dict(ours.get(i), theirs.get(i))
    assert ours.get(0)["fmri"].shape == (2, 4, 3)


# ---------------------------------------------------------------------- etl


def test_etl_constants():
    assert etl.SUBJECTS == jax_etl.SUBJECTS and etl.ROIS_MAX == jax_etl.ROIS_MAX
    assert etl.NUM_VOXELS == jax_etl.NUM_VOXELS == sum(etl.ROIS_MAX.values())


def test_zscore_and_concatenate(bold_dir):
    x = np.random.default_rng(11).normal(1.0, 4.0, (13, 6))
    x[:, 2] = 7.0
    _same(etl.zscore(x), jax_etl.zscore(x))
    for subs in (("CSI1", "CSI2"), ("CSI2",), None):
        if subs is None:  # the default names all four subjects; two are here
            with pytest.raises(FileNotFoundError):
                etl.concatenate_bold_data(bold_dir + "/")
            continue
        ours = etl.concatenate_bold_data(bold_dir + "/", subs)
        theirs = jax_etl.concatenate_bold_data(bold_dir + "/", subs)
        assert [r["image"] for r in ours] == [r["image"] for r in theirs]
        _same(np.stack([r["fmri"] for r in ours]), np.stack([r["fmri"] for r in theirs]))


@pytest.mark.parametrize("test_size", [0.2, 0.25, 0.9])
@pytest.mark.parametrize("n", [2, 37, 100])
def test_split_dataset_is_sklearns(n, test_size):
    """The same records in the same order as ``train_test_split``; where it
    leaves no train record, both refuse."""
    records = [{"id": i} for i in range(n)]
    for seed in (12345, 0):
        if math.ceil(test_size * n) >= n:
            for fn in (etl.split_dataset, jax_etl.split_dataset):
                with pytest.raises(ValueError):
                    fn(records, test_size, seed)
            continue
        ours = etl.split_dataset(records, test_size, seed)
        theirs = jax_etl.split_dataset(records, test_size, seed)
        assert [[r["id"] for r in part] for part in ours] == \
            [[r["id"] for r in part] for part in theirs]


def test_split_dataset_refuses_an_empty_test_split():
    for fn in (etl.split_dataset, jax_etl.split_dataset):
        with pytest.raises(ValueError):
            fn([1, 2, 3], 0.0)


def test_no_port_module_imports_an_optional_library():
    """Pillow, scipy, sklearn, pandas and h5py are imported where a loader
    needs them, never when a module of the port is imported (a fresh
    interpreter imports every module)."""
    import subprocess
    import sys

    code = ("import importlib, pkgutil, sys, fmri_tpu_torch\n"
            "for m in pkgutil.walk_packages(fmri_tpu_torch.__path__, 'fmri_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "print(sorted(n for n in ('PIL', 'scipy', 'sklearn', 'pandas', 'h5py', 'jax')\n"
            "             if n in sys.modules))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert out.strip() == "[]"
