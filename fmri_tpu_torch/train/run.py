"""Training CLI of the port: one entry point for every family and stage.

    python -m fmri_tpu_torch.train.run --family vgan --stage 1 --preset res64 \\
        --dataset coco -i /data/coco/train2017 --cache-dir cache -o results
    python -m fmri_tpu_torch.train.run --family vgan --stage 2 --dataset bold \\
        -i /data/bold_roi --prev-ckpt results/vgan_stage1/<run>/checkpoints -o results
    python -m fmri_tpu_torch.train.run --family wae --stage 3 --input <packed dir> \\
        --prev-ckpt <stage-2 checkpoints> --stage1-ckpt <stage-1 checkpoints>

Counterpart of ``fmri_tpu/train/run.py`` with its flags. Families and
stages map to the reference scripts: ``vgan`` 1/2/3
(``train_vgan_stage{1,2,3}.py``), ``wae`` 1/2/3 (``train_wae_stage{1,2,3}.py``),
``wae-vgan`` 1 (``wae_vgan_stage1.py``). ``--prev-ckpt`` and
``--stage1-ckpt`` take a port run's ``checkpoints`` dir or a
reference-layout ``.pth``. Runs on ``cuda`` unless ``--device cpu``;
without a card the default raises.

Data, as the JAX CLI loads it (``fmri_tpu/train/run.py:182-266``):
* a packed ``--input`` dir (``fmri-tpu-torch-prepare pack-stream``, i.e.
  ``python -m fmri_tpu_torch.data.prepare``, writes them), memory-mapped;
* ``--dataset synthetic``: generated, no files;
* ``--dataset coco`` (stage I): a directory of images, decoded, center-cropped
  and resized once (Pillow); ``--valid-input`` names a second directory,
  else the leading max(n // 10, batch) images are held out;
* ``--dataset bold`` (stages II/III): a directory of ``CSI*`` subject dirs
  (``<sub>_roi_pad.npz|pickle`` and ``<sub>_stimuli_paths.pickle``; the
  subjects present are used) or a records pickle, split 80/20 by
  ``split_dataset``;
* ``--dataset mnist69`` (stages II/III): a ``.mat`` file, its last fifth
  (at least a batch) held out.
``--cache-dir D`` keeps the decoded arrays as uint8 ``.npz`` (D/coco_train,
coco_valid, bold_train, bold_valid), which later runs read instead of
decoding; the JAX CLI reads and writes the same files.

Not in the port yet, and refused with the slice that brings them:
``--mesh`` (slice 10), ``--family exp`` (slice 9).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--family", choices=["vgan", "wae", "wae-vgan", "exp"], required=True)
    p.add_argument("--stage", type=int, choices=[1, 2, 3], default=1)
    p.add_argument("--exp", default=None,
                   choices=["decoder", "vae", "vgan", "dcgan-stage1", "dcgan-stage2"],
                   help="ablation experiment (--family exp)")
    p.add_argument("--preset", default="res64", help="config preset: res64 | res100 | tiny")
    p.add_argument("--mode", default="vae-gan",
                   choices=["vae-gan", "vae", "beta-vae", "dcgan"],
                   help="loss algebra for the vgan family (train_vgan_stage1.py:359-387)")
    p.add_argument("--dataset", default="synthetic",
                   choices=["coco", "bold", "mnist69", "synthetic"])
    p.add_argument("--input", "-i", default=None,
                   help="data root: a packed dir, or the images dir for coco, the "
                        "CSI* ROI dir or a records pickle for bold, the .mat for mnist69")
    p.add_argument("--output", "-o", default="results")
    p.add_argument("--logs", "-l", default=None,
                   help="unused; kept for reference CLI parity (logs go to the run dir)")
    p.add_argument("--valid-input", default=None,
                   help="separate validation data root (default: split the train data)")
    p.add_argument("--prev-ckpt", default=None,
                   help="previous stage's checkpoint dir or .pth (stages 2/3)")
    p.add_argument("--stage1-ckpt", default=None,
                   help="stage-1 checkpoint dir or .pth (wae stage 3 teacher)")
    p.add_argument("--load-epoch", type=int, default=None,
                   help="epoch to load from --prev-ckpt or --resume-dir (default latest)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--num-voxels", type=int, default=None,
                   help="override the preset's fMRI voxel count")
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--lam", type=float, default=None,
                   help="WAE/Dual-GAN latent-D weight (wae_vgan_stage1.py:87; default 1.0)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--no-teacher", action="store_true",
                   help="vgan stage 2 without distillation (train_vgan_stage2.py:234-238)")
    p.add_argument("--eval-batches", type=int, default=1,
                   help="validation batches per epoch (reference uses 1)")
    p.add_argument("--evaluate", action="store_true",
                   help="metrics-only pass over the validation set")
    p.add_argument("--resume-dir", default=None,
                   help="existing run dir to resume (reads its checkpoints)")
    p.add_argument("--debug", action="store_true",
                   help="route artifacts to <output>/debug, skip checkpoints")
    p.add_argument("--profile", action="store_true",
                   help="torch.profiler trace of the run's second epoch")
    p.add_argument("--mesh", default=None,
                   help="'data=N[,model=M]' multi-card mesh (not in the port yet)")
    p.add_argument("--cache-dir", default=None,
                   help="where to cache the raw loaders' packed arrays (.npz)")
    p.add_argument("--synthetic-n", type=int, default=None,
                   help="synthetic dataset size (default max(4*batch, 64))")
    p.add_argument("--on-device-epochs", action="store_true",
                   help="keep the training set on the device and gather batches there")
    p.add_argument("--async-ckpt", action="store_true",
                   help="write checkpoints on a background thread")
    p.add_argument("--keep-last", type=int, default=0,
                   help="retain only the K most recent checkpoints (0 = all)")
    p.add_argument("--keep-best", type=int, default=0,
                   help="also retain the K checkpoints with the best valid_PCC")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def _refuse(args) -> None:
    if args.mesh:
        raise SystemExit("--mesh: multi-card training is not in the port yet "
                         "(slice 10, parallelism)")
    if args.family == "exp":
        raise SystemExit("--family exp: the ablation experiments are not in the port "
                         "yet (slice 9, experiments and auxiliaries)")


def _open_packed_split(args, cfg, keys):
    """A packed dir as (train, valid) dicts of the ``keys`` arrays, still
    memory-mapped (uint8 images are dequantized on the device): a second
    packed dir ``--valid-input``, or a leading max(n // 10, batch) held out
    (``fmri_tpu/train/run.py:142-180``)."""
    from fmri_tpu_torch.data.packed import is_packed_dir, open_packed

    def need(path):
        arrays = open_packed(path)
        missing = set(keys) - set(arrays)
        if missing:
            raise SystemExit(f"packed dir {path} lacks arrays {sorted(missing)}")
        return {k: arrays[k] for k in keys}

    train = need(args.input)
    if args.valid_input:
        if not is_packed_dir(args.valid_input):
            raise SystemExit("--valid-input must also be a packed dir when --input is one")
        return train, need(args.valid_input)
    n, bs = len(train[keys[0]]), cfg.train.batch_size
    k = max(n // 10, bs)
    if n - k < bs:
        raise SystemExit(
            f"packed dir {args.input} has {n} examples; after holding out {k} for "
            f"validation the train split is smaller than one batch ({bs}): provide "
            f"more data, a --valid-input dir, or a smaller --batch-size")
    return {key: v[k:] for key, v in train.items()}, {key: v[:k] for key, v in train.items()}


def _cache(args, name: str):
    return os.path.join(args.cache_dir, f"{name}.npz") if args.cache_dir else None


def _need_input(args) -> None:
    if not args.input:
        raise SystemExit(f"--dataset {args.dataset} needs --input (its data root)")


def _load_images(args, cfg):
    """Stage-I images: (train, valid) float32 [N, S, S, 3] in [0, 1] (uint8
    from a packed dir)."""
    from fmri_tpu_torch.data.packed import is_packed_dir

    c, bs = cfg.data, cfg.train.batch_size
    if args.input and is_packed_dir(args.input):
        train, valid = _open_packed_split(args, cfg, ("image",))
        return train["image"], valid["image"]
    if args.dataset == "synthetic":
        from fmri_tpu_torch.data.synthetic import synthetic_images

        n = args.synthetic_n or max(4 * bs, 64)
        imgs, _ = synthetic_images(n, c.image_size, seed=0)
        k = max(len(imgs) // 10, bs)
        return imgs[k:], imgs[:k]
    if args.dataset != "coco":
        raise SystemExit(f"stage 1 expects --dataset coco|synthetic, got {args.dataset}")
    _need_input(args)
    from fmri_tpu_torch.data.datasets import CocoImages

    train = CocoImages(args.input, crop=c.image_crop,
                       size=c.image_size).as_array(_cache(args, "coco_train"))
    if args.valid_input:
        valid = CocoImages(args.valid_input, crop=c.image_crop,
                           size=c.image_size).as_array(_cache(args, "coco_valid"))
        return train, valid
    k = max(len(train) // 10, bs)
    return train[k:], train[:k]


def _load_pairs(args, cfg):
    """Stage-II/III pairs: (train, valid) {'fmri', 'image'} dicts."""
    from fmri_tpu_torch.data.packed import is_packed_dir

    c, bs = cfg.data, cfg.train.batch_size
    if args.input and is_packed_dir(args.input):
        return _open_packed_split(args, cfg, ("fmri", "image"))
    if args.dataset == "synthetic":
        from fmri_tpu_torch.data.synthetic import synthetic_pairs

        n = args.synthetic_n or max(4 * bs, 64)
        data = synthetic_pairs(n, c.image_size, cfg.model.num_voxels, seed=0)
        k = max(n // 10, bs)
        return ({key: v[k:] for key, v in data.items()},
                {key: v[:k] for key, v in data.items()})
    if args.dataset not in ("bold", "mnist69"):
        raise SystemExit("stages 2/3 expect --dataset bold|mnist69|synthetic")
    _need_input(args)
    if args.dataset == "mnist69":
        from fmri_tpu_torch.data.datasets import Mnist69

        arrays = Mnist69(args.input, size=c.image_size).as_arrays()
        k = max(len(arrays["fmri"]) // 5, bs)  # 80/20 (train_vgan_stage2.py:196)
        return ({key: v[:-k] for key, v in arrays.items()},
                {key: v[-k:] for key, v in arrays.items()})
    from fmri_tpu_torch.data.datasets import BoldRoiDataset
    from fmri_tpu_torch.data.etl import concatenate_bold_data, split_dataset

    if os.path.isdir(args.input):
        # the CSI* subject dirs present (the reference hard-codes all four)
        subs = tuple(sorted(
            d for d in os.listdir(args.input)
            if d.startswith("CSI") and os.path.isdir(os.path.join(args.input, d))))
        records = concatenate_bold_data(args.input.rstrip("/") + "/", subjects=subs or None)
    else:  # a records pickle the user's own ETL wrote
        with open(args.input, "rb") as f:
            records = pickle.load(f)
    train_recs, valid_recs = split_dataset(records, c.data_split, c.split_seed)
    return tuple(BoldRoiDataset(recs, crop=c.image_crop, size=c.image_size)
                 .as_arrays(_cache(args, f"bold_{tag}"))
                 for recs, tag in ((train_recs, "train"), (valid_recs, "valid")))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _refuse(args)

    from fmri_tpu_torch.configs.presets import get_config, override_num_voxels
    from fmri_tpu_torch.data.pipeline import Batches, num_examples
    from fmri_tpu_torch.device import resolve_device
    from fmri_tpu_torch.train.stages import BUILDERS
    from fmri_tpu_torch.train.trainer import Draws, Trainer
    from fmri_tpu_torch.utils.runlog import create_run_dir

    device = resolve_device(args.device)
    cfg = get_config(args.preset)
    overrides = {}
    for flag, field in (("epochs", "n_epochs"), ("batch_size", "batch_size"),
                        ("lr", "learning_rate"), ("lam", "wae_vgan_lam"), ("seed", "seed")):
        if getattr(args, flag) is not None:
            overrides[field] = getattr(args, flag)
    if overrides:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, **overrides))
    if args.num_voxels is not None:
        cfg = override_num_voxels(cfg, args.num_voxels)

    if args.family == "wae-vgan" and args.stage != 1:
        raise SystemExit("wae-vgan has only stage 1 (wae_vgan_stage1.py)")
    family_key = {"vgan": "vgan", "wae": "wae", "wae-vgan": "wae_vgan"}[args.family]
    builder_name = f"{family_key}_stage{args.stage}"

    train_data, valid_data = (_load_images if args.stage == 1 else _load_pairs)(args, cfg)
    steps_per_epoch = max(num_examples(train_data) // cfg.train.batch_size, 1)

    bkw = dict(steps_per_epoch=steps_per_epoch, seed=cfg.train.seed, device=device)
    if args.family in ("vgan", "wae-vgan"):
        bkw["mode"] = args.mode
        if args.stage == 2:
            bkw["use_teacher"] = not args.no_teacher
    if args.stage >= 2:
        if not args.prev_ckpt:
            raise SystemExit("stages 2/3 need --prev-ckpt")
        bkw["stage1_ckpt" if args.stage == 2 else "stage2_ckpt"] = args.prev_ckpt
        bkw["epoch"] = args.load_epoch
        if builder_name == "wae_stage3":
            if not args.stage1_ckpt:
                raise SystemExit("wae stage 3 needs --stage1-ckpt (teacher)")
            bkw["stage1_ckpt"] = args.stage1_ckpt

    state, steps, tkw = BUILDERS[builder_name](cfg, **bkw)

    run_dir = args.resume_dir or create_run_dir(args.output, builder_name, debug=args.debug)
    retention = None
    if args.keep_last or args.keep_best:
        retention = dict(keep_last=args.keep_last, keep_best=args.keep_best)
    trainer = Trainer(cfg, steps, run_dir, debug=args.debug, profile=args.profile,
                      async_ckpt=args.async_ckpt, ckpt_retention=retention, **tkw)

    start_epoch = 0
    if args.resume_dir:
        state, start_epoch = trainer.resume(state, epoch=args.load_epoch)

    if args.evaluate:
        vm = trainer.evaluate_batches(
            state, iter(Batches(valid_data, cfg.train.batch_size)),
            Draws(cfg.train.seed).eval(0, 0, device), max_batches=0)
        print(json.dumps({f"valid_{k}": v for k, v in vm.items()}, indent=2))
        return 0

    trainer.fit(state, train_data, valid_data, start_epoch=start_epoch,
                eval_batches=args.eval_batches, on_device=args.on_device_epochs)
    print(f"run artifacts: {run_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
