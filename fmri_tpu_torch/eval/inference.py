"""Inference / evaluation CLI for the VAE/GAN and WAE families: image ->
image through a stage-I model (``--stage 1``, and ``--family wae-vgan``,
which ignores ``--stage`` as the JAX CLI does) or fMRI -> image through a
cognitive model (``--stage 2|3``); PCC/SSIM/MSE against the images, the
Inception Score of the reconstructions (``--no-is`` skips it), 2/5/10-way
objective assessment with CSV and bar chart, optional PNG dump.

    python -m fmri_tpu_torch.eval.inference --family vgan --stage 3 \\
        --preset res64 --ckpt model.pth --dataset synthetic -o out

Weights come from a port training run's checkpoint dir (``--ckpt
<run>/checkpoints``, the latest checkpoint unless ``--load-epoch``; its
``encoder`` and ``decoder`` groups), or from a reference-layout ``.pth``, as
written by
``python -m fmri_tpu.checkpoints.torch_import --export --kind K`` with K
``vae-gan`` (``vgan`` stage 1, or ``wae-vgan``), ``vae-gan-cognitive``
(``vgan`` stages 2 and 3), ``wae-gan`` (``wae`` stage 1) or
``wae-gan-cognitive`` (``wae`` stages 2 and 3), or by the port's
``from_jax_groups``. ``--family wae`` always decodes mu: ``--sample``
has no effect there, as the JAX WAE eval takes no sample. The data is
the validation split of the train CLI's loaders with the same flags
(``fmri_tpu_torch/train/run.py``, as ``fmri_tpu/eval/inference.py:126-130``
does): ``--dataset synthetic``, a packed ``--input`` directory, or raw
``--dataset coco|bold|mnist69`` with ``--cache-dir``; the image -> image
runs read images. Runs on ``cuda`` unless ``--device cpu``, with cuDNN's
deterministic algorithms. The IS classifier is the proxy, or Inception-v3
when ``FMRI_TPU_INCEPTION_NPZ`` names its weights
(``fmri_tpu_torch/metrics/inception.py``). Counterpart of
``fmri_tpu/eval/inference.py:40-154``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--family", choices=["vgan", "wae", "wae-vgan"], required=True)
    p.add_argument("--stage", type=int, choices=[1, 2, 3], default=1)
    p.add_argument("--preset", default="res64")
    p.add_argument("--ckpt", required=True,
                   help="a port training run's checkpoint dir, or a reference-layout "
                        ".pth state dict of the family and stage")
    p.add_argument("--load-epoch", type=int, default=None,
                   help="epoch to load from a checkpoint dir (default latest)")
    p.add_argument("--dataset", default="synthetic",
                   choices=["coco", "bold", "mnist69", "synthetic"])
    p.add_argument("--input", "-i", default=None,
                   help="data root, as the train CLI's --input")
    p.add_argument("--valid-input", default=None,
                   help="validation data root (default: the train CLI's split of --input)")
    p.add_argument("--cache-dir", default=None,
                   help="the raw loaders' packed-array cache, as the train CLI's")
    p.add_argument("--output", "-o", default="inference_out")
    p.add_argument("--logs", "-l", default=None, help="unused; CLI parity")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--num-voxels", type=int, default=None,
                   help="override the preset's fMRI voxel count (must match "
                        "the checkpoint's CognitiveEncoder)")
    p.add_argument("--max-batches", type=int, default=0, help="0 = all")
    p.add_argument("--no-evaluate", action="store_true",
                   help="skip metrics; just reconstruct + save images")
    p.add_argument("--no-is", action="store_true", help="skip Inception Score")
    p.add_argument("--sample", action="store_true",
                   help="reparameterize at eval")
    p.add_argument("--save-images", action="store_true")
    p.add_argument("--resize", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic-n", type=int, default=None,
                   help="synthetic dataset size (default 4*batch)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def image_only(args) -> bool:
    """Image -> image: stage 1 of either family, and WAE/Dual-GAN."""
    from fmri_tpu_torch.eval.steps import eval_module

    return eval_module(args.family, args.stage)[1] == "image"


def load_valid(args, cfg):
    """The validation arrays, {'fmri', 'image'} (image -> image: {'image'}):
    the train CLI's split of the same flags (``train/run.py::_load_images``,
    ``_load_pairs``)."""
    from fmri_tpu_torch.train import run

    if image_only(args):
        return {"image": run._load_images(args, cfg)[1]}
    return run._load_pairs(args, cfg)[1]


def load_weights(ckpt: str, epoch=None):
    """(the eval module's ``encoder.*``/``decoder.*`` state dict, summary
    entries naming the checkpoint): from a port checkpoint dir
    (``checkpoints/store.py::load_eval_state``; ``epoch``, default the
    latest) or a ``.pth``."""
    from fmri_tpu_torch.checkpoints.convert import load_pth
    from fmri_tpu_torch.checkpoints.store import load_eval_state

    if not os.path.isdir(ckpt):
        return load_pth(ckpt), {"checkpoint": ckpt}
    groups, meta = load_eval_state(ckpt, epoch=epoch)
    sd = {f"{g}.{k}": v for g in ("encoder", "decoder") for k, v in groups[g].items()}
    return sd, {"checkpoint": ckpt, "checkpoint_epoch": meta["epoch"]}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from fmri_tpu_torch.configs.presets import get_config, override_num_voxels
    from fmri_tpu_torch.device import deterministic_cudnn, resolve_device
    from fmri_tpu_torch.eval.evaluate import (
        objective_scores, quality_metrics, reconstruct_dataset,
        save_objective_bar_chart, save_objective_csv, save_reconstructions,
    )
    from fmri_tpu_torch.eval.steps import eval_module

    device = resolve_device(args.device)
    cfg = get_config(args.preset)
    if args.batch_size:
        cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, batch_size=args.batch_size))
    if args.num_voxels is not None:
        cfg = override_num_voxels(cfg, args.num_voxels)

    valid = load_valid(args, cfg)
    weights, source = load_weights(args.ckpt, args.load_epoch)
    model = eval_module(args.family, args.stage)[0](cfg.model)
    model.load_state_dict(weights, strict=True)
    model.to(device)

    n, bs = len(valid["image"]), cfg.train.batch_size
    batches = ({k: v[lo:lo + bs] for k, v in valid.items()}
               for lo in range(0, n, bs))
    with deterministic_cudnn():
        recons, targets = reconstruct_dataset(
            model, batches, mean=cfg.data.mean, std=cfg.data.std,
            sample=args.sample, seed=args.seed, max_batches=args.max_batches)

    os.makedirs(args.output, exist_ok=True)
    summary = {**source, "device": str(device), "num_images": int(len(recons))}
    if not args.no_evaluate:
        summary.update(quality_metrics(recons, targets, with_is=not args.no_is))
        scores = objective_scores(recons, targets, seed=args.seed)
        save_objective_csv(scores, os.path.join(args.output, "objective.csv"))
        save_objective_bar_chart(
            scores, os.path.join(args.output, "objective.png"))
        summary["objective"] = scores
    if args.save_images:
        save_reconstructions(recons, os.path.join(args.output, "images"),
                             resize_to=args.resize)
    with open(os.path.join(args.output, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
