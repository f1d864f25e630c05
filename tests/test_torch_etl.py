"""The port's BOLD5000 ETL (``fmri_tpu_torch/data/etl.py``) against the JAX
package's on the same fixtures: the session index (``events.tsv`` read with
``csv`` against pandas: empty cells, a missing ``ImgType`` column, names that
do not match the run pattern), ROI padding (h5py), the stimulus lists, the
stimulus split (numpy against sklearn), the mask-based extraction (NIfTI),
and the path helpers. Everything is compared exactly: these are host
functions over the same files."""

import math
import os
import pickle
import sys

import numpy as np
import pytest
from torch_port_helpers import write_bold5000

import fmri_tpu.data.etl as jax_etl
from fmri_tpu_torch.data import etl, nifti


@pytest.fixture(scope="module")
def bold5000(tmp_path_factory):
    return write_bold5000(str(tmp_path_factory.mktemp("bold5000")), seed=0)


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def test_path_helpers_match_jax():
    for name, ds in (("COCO_train2014_000000123456.jpg", "coco"),
                     ("COCO_train2014_000000000042.jpg", "rep_coco"),
                     ("n01440764_10026.JPEG", "imagenet"), ("beach_1.jpg", "scenes"),
                     ("beach_1.jpg", "sun")):
        assert etl.get_identifier(name, ds) == jax_etl.get_identifier(name, ds)
    for ds in ("coco", "rep_coco", "imagenet", "rep_imagenet", "scenes", "rep_scenes"):
        assert (etl.get_stimuli_path("x.jpg", ds, "/s")
                == jax_etl.get_stimuli_path("x.jpg", ds, "/s"))
    for bad in ("nan", "mnist"):
        with pytest.raises(ValueError, match="unknown source dataset"):
            etl.get_stimuli_path("x.jpg", bad, "/s")
        with pytest.raises(ValueError, match="unknown source dataset"):
            etl.get_identifier("x.jpg", bad)
    assert etl.get_fmri_path(1, 2, 3, "/r") == jax_etl.get_fmri_path(1, 2, 3, "/r")
    for name in ("LHEarlyVis", "RHPPA", "ImgName", "img_type"):
        assert etl.snake_case(name) == jax_etl.snake_case(name)


def test_aggregate_bold_sessions_matches_pandas(bold5000, tmp_path):
    """Empty ImgName cells give "nan" names (kept), an empty ImgType skips the
    row (its trial number still counts), a run without ImgType is COCO, and
    a run without events or outside the run pattern is skipped."""
    ours, theirs = str(tmp_path / "port.pickle"), str(tmp_path / "jax.pickle")
    got = etl.aggregate_bold_sessions(bold5000["ds001499"], bold5000["stimuli"], ours)
    want = jax_etl.aggregate_bold_sessions(bold5000["ds001499"], bold5000["stimuli"],
                                           theirs)
    assert got == want
    assert _load(ours) == _load(theirs) == want
    assert "nan" in got["img_name"] and got["trial"][:4] == [1, 2, 3, 5]
    assert sorted(set(got["subject"])) == [1, 2] and set(got["run"]) == {1, 2}


def test_events_cells_read_as_pandas_reads_them(tmp_path):
    path = tmp_path / "events.tsv"
    path.write_text("onset\tImgName\tImgType\n1.5\t\tNA\n2\tn/a.jpg\tNone\n\n4.0\tb.jpg\n")
    rows = etl._read_events(str(path))
    assert len(rows) == 3 and rows[0]["onset"] == "1.5"
    assert all(math.isnan(rows[i][k]) for i, k in ((0, "ImgName"), (0, "ImgType"),
                                                    (1, "ImgType"), (2, "ImgType")))
    assert rows[1]["ImgName"] == "n/a.jpg"
    import pandas as pd

    df = pd.read_csv(str(path), sep="\t")
    for row, (_, ref) in zip(rows, df.iterrows()):
        for k in ("ImgName", "ImgType"):
            assert str(row[k]) == str(ref[k]), k


def test_max_roi_length_and_extract_roi_match_jax(bold5000, tmp_path):
    subs = ("CSI1", "CSI2")
    assert etl.max_roi_length(bold5000["rois"], subs) == jax_etl.max_roi_length(
        bold5000["rois"], subs)
    got = etl.extract_roi(bold5000["rois"], str(tmp_path / "port"), subs, save=True)
    want = jax_etl.extract_roi(bold5000["rois"], str(tmp_path / "jax"), subs, save=True)
    assert list(got) == list(want)
    for sub in subs:
        assert got[sub].dtype == want[sub].dtype
        np.testing.assert_array_equal(got[sub], want[sub])
        base = os.path.join("{}", sub, f"{sub}_roi_pad")
        np.testing.assert_array_equal(
            _load(base.format(tmp_path / "port") + ".pickle"),
            _load(base.format(tmp_path / "jax") + ".pickle"))
        with np.load(base.format(tmp_path / "port") + ".npz") as a, \
                np.load(base.format(tmp_path / "jax") + ".npz") as b:
            assert a.files == b.files
            np.testing.assert_array_equal(a["roi"], b["roi"])
    # h5py's alphabetical order: LHEarlyVis (9), LHLOC (6), RHPPA (5)
    np.testing.assert_array_equal(got["CSI1"][:, 7:9], 0.0)


def test_h5py_missing_raises_naming_it(bold5000, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    for fn in (etl.max_roi_length, etl.extract_roi):
        with pytest.raises(ImportError, match="h5py"):
            fn(bold5000["rois"], ("CSI1",))


def test_find_stimuli_path_matches_jax(bold5000, tmp_path):
    index = jax_etl.aggregate_bold_sessions(bold5000["ds001499"], bold5000["stimuli"])
    lists = os.path.join(bold5000["rois"], "stim_lists")
    got = etl.find_stimuli_path(index, lists, str(tmp_path / "port"), save=True)
    want = jax_etl.find_stimuli_path(index, lists, str(tmp_path / "jax"), save=True)
    assert got == want and set(got) == {"CSI1", "CSI2"}
    for sub in got:
        name = os.path.join(sub, f"{sub}_stimuli_paths.pickle")
        assert _load(tmp_path / "port" / name) == _load(tmp_path / "jax" / name)


@pytest.mark.parametrize("n, ratio", [(10, 0.1), (37, 0.1), (200, 0.1), (53, 0.25)])
def test_stimuli_split_matches_sklearn(tmp_path, n, ratio):
    """In one process (one string hash seed), the port's numpy split of
    ``list(set(names))`` is sklearn's, list for list."""
    rng = np.random.default_rng(n)
    names = [f"img_{int(i):04d}.jpg" for i in rng.integers(0, 2 * n, 3 * n)]
    names = [("rep_" + s if i % 4 == 0 else s) for i, s in enumerate(names)]
    path = tmp_path / "CSI01_stim_lists.txt"
    path.write_text("\n".join(names) + "\n")
    got = etl.train_test_stimuli_split(str(path), str(tmp_path / "port"), ratio=ratio,
                                       save=True)
    want = jax_etl.train_test_stimuli_split(str(path), str(tmp_path / "jax"),
                                            ratio=ratio, save=True)
    assert got == tuple(want)
    assert len(got[1]) == math.ceil(ratio * len(set(s.removeprefix("rep_") for s in names)))
    for name in ("stimuli_train.pickle", "stimuli_valid.pickle"):
        assert _load(tmp_path / "port" / name) == _load(tmp_path / "jax" / name)


def _nan_free(values):
    return ["<nan>" if isinstance(v, float) and math.isnan(v) else v for v in values]


def test_extract_roi_by_mask_matches_jax(tmp_path):
    """Two subjects' fmriprep-style runs: 5-TR windows from onsets (banker's
    rounding of onset, then halved and truncated), a trailing blank
    window, an empty ImgName (NaN, as pandas reads it), a run without
    events."""
    import csv

    rng = np.random.default_rng(12)
    for s, sub in enumerate(("CSI1", "CSI2")):
        mask = (rng.uniform(size=(3, 4, 2)) > 0.5).astype(np.float32)
        (tmp_path / "spm" / sub).mkdir(parents=True)
        nifti.save(str(tmp_path / "spm" / sub / "mask.nii.gz"), mask)
        for run in (1, 2, 3):
            pdir = tmp_path / "fmriprep" / sub / "ses-01" / "func"
            pdir.mkdir(parents=True, exist_ok=True)
            nifti.save(str(pdir / f"sub-{sub}_ses-01_task-5000scenes_run-0{run}_preproc"
                                  f".nii.gz"),
                       rng.normal(size=(3, 4, 2, 22 + 3 * s)).astype(np.float32))
            if run == 3:
                continue
            edir = tmp_path / "events" / f"sub-{sub}" / "ses-01" / "func"
            edir.mkdir(parents=True, exist_ok=True)
            with open(edir / f"sub-{sub}_ses-01_task-5000scenes_run-0{run}_events.tsv",
                      "w", newline="") as f:
                w = csv.writer(f, delimiter="\t")
                w.writerow(["onset", "ImgName"])
                for onset, name in ((4.5, "a.jpg"), (5.5, ""), (13.0, f"b{run}.jpg"),
                                    (20 + 2 * s, "c.jpg")):
                    w.writerow([onset, name])
    dirs = [str(tmp_path / d) for d in ("fmriprep", "events", "spm")]
    got = etl.extract_roi_by_mask(*dirs, out_dir=str(tmp_path / "port"), save=True)
    want = jax_etl.extract_roi_by_mask(*dirs, out_dir=str(tmp_path / "jax"), save=True)
    assert list(got) == list(want) == ["CSI1", "CSI2"]
    for sub in got:
        (gx, gy, gm), (wx, wy, wm) = got[sub], want[sub]
        assert len(gx) == len(wx) and len(gx) >= 8
        for a, b in zip(gx, wx):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert _nan_free(gy) == _nan_free(wy)
        assert [_nan_free(m.values()) for m in gm] == [_nan_free(m.values()) for m in wm]
        for name in (f"{sub}_fmri.pickle", f"{sub}_image_names.pickle"):
            a, b = (_load(tmp_path / side / sub / name) for side in ("port", "jax"))
            if name.endswith("names.pickle"):
                assert _nan_free(a) == _nan_free(b)
            else:
                for x, y in zip(a, b, strict=True):
                    np.testing.assert_array_equal(x, y)
