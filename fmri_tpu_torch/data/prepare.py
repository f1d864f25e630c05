"""Offline data-preparation CLI of the port: the reference's ETL entry points
in one tool, with the subcommands, flags and defaults of
``fmri_tpu/data/prepare.py``, writing the same files. Host code only
(numpy, Pillow for the stimuli; h5py for ``extract-roi``); it needs no
JAX, pandas or sklearn.

  parse-sessions   -> bold_parser.py (absent upstream; schema from
                      data_preprocessing/readme.md:61-75)
  extract-roi      -> roi_extraction.py extract_roi (+ max_roi_length); needs h5py
  stimuli-paths    -> roi_extraction.py find_stimuli_path
  split-stimuli    -> roi_extraction.py train_test_stimuli_split
  pack             -> data_loader.py __main__: concatenate_bold_data +
                      train_test_split(0.2, seed 12345) + packed .npz arrays
  pack-stream      -> a memory-mapped packed dir (meta.json + one .npy per
                      array) from an .npz cache, a record pickle, or an
                      image dir streamed one image at a time

Example end-to-end:

    python -m fmri_tpu_torch.data.prepare parse-sessions -i ds001499/ \\
        --stimuli BOLD5000_Stimuli/Presented_Stimuli -o out/bold5000.pickle
    python -m fmri_tpu_torch.data.prepare extract-roi -i figshare_ROIs/ -o out/bold_roi
    python -m fmri_tpu_torch.data.prepare stimuli-paths -i figshare_ROIs/stim_lists \\
        --bold-index out/bold5000.pickle -o out/bold_roi
    python -m fmri_tpu_torch.data.prepare split-stimuli \\
        -i figshare_ROIs/stim_lists/CSI01_stim_lists.txt -o out/bold_roi
    python -m fmri_tpu_torch.data.prepare pack -i out/bold_roi -o out/packed \\
        --crop 375 --size 64
    python -m fmri_tpu_torch.data.prepare pack-stream -i out/packed/bold_train.npz \\
        -o out/stream_train
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("parse-sessions", help="aggregate BOLD5000 sessions")
    sp.add_argument("--input", "-i", required=True, help="ds001499 root")
    sp.add_argument("--stimuli", required=True, help="Presented_Stimuli root")
    sp.add_argument("--output", "-o", required=True, help="output pickle path")

    sp = sub.add_parser("extract-roi", help="pad+concat figshare ROIs")
    sp.add_argument("--input", "-i", required=True, help="ROIs root (figshare)")
    sp.add_argument("--output", "-o", required=True, help="output dir")
    sp.add_argument("--subjects", nargs="*", default=None)

    sp = sub.add_parser("stimuli-paths", help="match stim lists to paths")
    sp.add_argument("--input", "-i", required=True, help="stim_lists dir")
    sp.add_argument("--bold-index", required=True, help="bold5000.pickle")
    sp.add_argument("--output", "-o", required=True, help="output dir")

    sp = sub.add_parser("split-stimuli", help="fixed 90/10 stimulus-ID split")
    sp.add_argument("--input", "-i", required=True, help="a stim list .txt")
    sp.add_argument("--output", "-o", required=True, help="output dir")
    sp.add_argument("--ratio", type=float, default=0.1)

    sp = sub.add_parser("pack", help="z-score, split, pack to npz")
    sp.add_argument("--input", "-i", required=True,
                    help="bold_roi dir (per-subject pickles)")
    sp.add_argument("--output", "-o", required=True, help="output dir")
    sp.add_argument("--subjects", nargs="*", default=None)
    sp.add_argument("--crop", type=int, default=375)
    sp.add_argument("--size", type=int, default=64)
    sp.add_argument("--root-path", default=None,
                    help="rebase stimulus paths onto this root")

    sp = sub.add_parser(
        "pack-stream",
        help="write a memory-mapped streaming dir (datasets > host RAM)")
    sp.add_argument("--input", "-i", required=True,
                    help="an .npz cache from 'pack' / CocoImages, an image "
                         "dir, or a bold record pickle")
    sp.add_argument("--output", "-o", required=True, help="packed dir")
    sp.add_argument("--crop", type=int, default=375)
    sp.add_argument("--size", type=int, default=64)
    return p


def _pack(args) -> dict:
    from fmri_tpu_torch.data import etl
    from fmri_tpu_torch.data.datasets import BoldRoiDataset

    subs = tuple(args.subjects) if args.subjects else etl.SUBJECTS
    records = etl.concatenate_bold_data(args.input.rstrip("/") + "/", subs)
    train_recs, valid_recs = etl.split_dataset(records)
    os.makedirs(args.output, exist_ok=True)
    summary = {}
    for tag, recs in (("train", train_recs), ("valid", valid_recs)):
        ds = BoldRoiDataset(recs, root_path=args.root_path,
                            crop=args.crop, size=args.size)
        arrays = ds.as_arrays(cache=os.path.join(args.output, f"bold_{tag}.npz"))
        summary[tag] = {k: list(v.shape) for k, v in arrays.items()}
        with open(os.path.join(args.output, f"bold_{tag}.pickle"), "wb") as f:
            pickle.dump(recs, f)  # reference-compatible record list
    return summary


def _pack_stream(args) -> dict:
    from fmri_tpu_torch.data.datasets import BoldRoiDataset, CocoImages
    from fmri_tpu_torch.data.packed import pack_images_streaming, save_packed

    if os.path.isfile(args.input) and args.input.endswith(".npz"):
        z = np.load(args.input)
        arrays = {("image" if k == "images" else k): z[k] for k in z.files}
    elif os.path.isfile(args.input):  # bold record pickle
        arrays = BoldRoiDataset.from_pickle(args.input, crop=args.crop,
                                            size=args.size).as_arrays()
    else:  # image directory: packed out-of-core, one image at a time
        ds = CocoImages(args.input, crop=args.crop, size=args.size)
        pack_images_streaming(ds.get, len(ds), (args.size, args.size, 3), args.output)
        return {"image": [len(ds), args.size, args.size, 3]}
    save_packed(args.output, arrays)
    return {k: list(np.shape(v)) for k, v in arrays.items()}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from fmri_tpu_torch.data import etl

    if args.cmd == "parse-sessions":
        idx = etl.aggregate_bold_sessions(args.input, args.stimuli,
                                          save_path=args.output)
        summary = {"trials": len(idx["img_name"]), "saved": args.output}
    elif args.cmd == "extract-roi":
        subs = tuple(args.subjects) if args.subjects else etl.SUBJECTS
        out = etl.extract_roi(args.input, args.output, subs, save=True)
        summary = {s: list(a.shape) for s, a in out.items()}
    elif args.cmd == "stimuli-paths":
        with open(args.bold_index, "rb") as f:
            idx = pickle.load(f)  # the user's own parse-sessions output
        out = etl.find_stimuli_path(idx, args.input, args.output, save=True)
        summary = {s: len(v) for s, v in out.items()}
    elif args.cmd == "split-stimuli":
        train, test = etl.train_test_stimuli_split(
            args.input, args.output, ratio=args.ratio, save=True)
        summary = {"train": len(train), "valid": len(test)}
    elif args.cmd == "pack":
        summary = _pack(args)
    else:
        summary = _pack_stream(args)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
