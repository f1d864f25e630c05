"""One-command quality-parity harness of the port (BASELINE.md table 2), the
counterpart of ``fmri_tpu/eval/parity.py`` with its flags, defaults and
reports::

    python -m fmri_tpu_torch.eval.parity \\
        --family vgan --stage 3 --preset res100 \\
        --ref-ckpt /path/vaegan_cog_3st_20210928.pth \\
        --ckpt runs/vgan_stage3/<run>/checkpoints \\
        --dataset bold --input <packed_dir> --output parity_out

Each checkpoint goes through the port's inference CLI
(``fmri_tpu_torch.eval.inference``: the validation set reconstructed, mean
PCC / SSIM / MSE, the Inception Score unless ``--no-is``, and the 2/5/10-way
objective identification, as ``inference_gan.py:269-307`` scores them), one
row each: the reference ``.pth`` (``--ref-ckpt``) and a port checkpoint dir
(``--ckpt``). The report is ``parity.json`` plus a markdown table
(``parity.md``), with the JAX CLI's row keys and columns.

The JAX CLI first converts the ``.pth`` into a checkpoint dir of its own
(``converted_ref_ckpt/``). The port's inference CLI loads a reference-layout
``.pth`` directly (``checkpoints/convert.py::load_pth``, strict), so here the
``.pth`` passes straight through and no such dir is written. ``--ref-epoch``
only labels that row: it is written into ``ref/summary.json`` as
``checkpoint_epoch``, where the JAX CLI's converted checkpoint records it.
Runs on ``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--family", choices=["vgan", "wae"], default="vgan")
    p.add_argument("--stage", type=int, choices=[1, 2, 3], default=3)
    p.add_argument("--preset", default="res100",
                   help="res100 = the reference's checked-in config "
                        "(models_config.py:13-21)")
    p.add_argument("--ref-ckpt", default=None,
                   help="reference .pth (torch.save(model.state_dict())); "
                        "evaluated as the 'reference' row")
    p.add_argument("--ref-epoch", type=int, default=None,
                   help="epoch number recorded for the reference checkpoint")
    p.add_argument("--ckpt", default=None,
                   help="port checkpoint dir; evaluated as the 'framework' row")
    p.add_argument("--load-epoch", type=int, default=None)
    p.add_argument("--dataset", default="synthetic",
                   help="synthetic | bold5000/coco dirs (same values as "
                        "fmri_tpu_torch.eval.inference --dataset)")
    p.add_argument("--input", "-i", default=None)
    p.add_argument("--valid-input", default=None)
    p.add_argument("--cache-dir", default=None)
    p.add_argument("--num-voxels", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--max-batches", type=int, default=0)
    p.add_argument("--no-is", action="store_true",
                   help="skip the Inception Score column")
    p.add_argument("--synthetic-n", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", "-o", default="parity_out")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def _inference_args(args, ckpt: str, outdir: str) -> List[str]:
    argv = ["--family", args.family, "--stage", str(args.stage),
            "--preset", args.preset, "--ckpt", ckpt,
            "--dataset", args.dataset, "--output", outdir,
            "--seed", str(args.seed), "--max-batches", str(args.max_batches),
            "--device", args.device]
    for flag, val in (("--input", args.input),
                      ("--valid-input", args.valid_input),
                      ("--cache-dir", args.cache_dir),
                      ("--num-voxels", args.num_voxels),
                      ("--batch-size", args.batch_size),
                      ("--synthetic-n", args.synthetic_n),
                      ("--load-epoch", args.load_epoch)):
        if val is not None:
            argv += [flag, str(val)]
    if args.no_is:
        argv.append("--no-is")
    return argv


def _evaluate(args, ckpt: str, outdir: str, extra: Dict | None = None) -> Dict:
    from fmri_tpu_torch.eval import inference

    if inference.main(_inference_args(args, ckpt, outdir)) != 0:
        raise RuntimeError(f"inference failed for {ckpt}")
    path = os.path.join(outdir, "summary.json")
    with open(path) as f:
        summary = json.load(f)
    if extra:
        summary.update(extra)
        with open(path, "w") as f:
            json.dump(summary, f, indent=2)
    return summary


def _row(name: str, s: Dict) -> Dict:
    out = {"checkpoint": name, "num_images": s.get("num_images"),
           "pcc": s.get("pcc"), "ssim": s.get("ssim"), "mse": s.get("mse")}
    for k in ("is_mean", "is_std", "is_proxy"):
        if k in s:
            out[k] = s[k]
    obj = s.get("objective", {})
    for i, top in enumerate(obj.get("top", [])):
        out[f"pcc_{top}way"] = obj["pcc"][i]
        out[f"ssim_{top}way"] = obj["ssim"][i]
    return out


def _markdown(rows: List[Dict]) -> str:
    cols = ["checkpoint", "pcc", "ssim", "mse",
            "pcc_2way", "pcc_5way", "pcc_10way",
            "ssim_2way", "ssim_5way", "ssim_10way"]
    present = [c for c in cols if any(c in r for r in rows)]
    fmt = lambda v: f"{v:.4f}" if isinstance(v, float) else str(v)  # noqa: E731
    lines = ["| " + " | ".join(present) + " |",
             "|" + "---|" * len(present)]
    for r in rows:
        lines.append("| " + " | ".join(fmt(r.get(c, "")) for c in present) + " |")
    return "\n".join(lines)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.ref_ckpt and not args.ckpt:
        print("nothing to evaluate: pass --ref-ckpt and/or --ckpt", file=sys.stderr)
        return 2
    os.makedirs(args.output, exist_ok=True)
    rows: List[Dict] = []
    if args.ref_ckpt:
        extra = None if args.ref_epoch is None else {"checkpoint_epoch": args.ref_epoch}
        s = _evaluate(args, args.ref_ckpt, os.path.join(args.output, "ref"), extra)
        rows.append(_row(f"reference ({os.path.basename(args.ref_ckpt)})", s))
    if args.ckpt:
        s = _evaluate(args, args.ckpt, os.path.join(args.output, "framework"))
        rows.append(_row(f"framework ({args.ckpt})", s))

    report = {"preset": args.preset, "family": args.family,
              "stage": args.stage, "dataset": args.dataset, "rows": rows}
    with open(os.path.join(args.output, "parity.json"), "w") as f:
        json.dump(report, f, indent=2)
    md = _markdown(rows)
    with open(os.path.join(args.output, "parity.md"), "w") as f:
        f.write(md + "\n")
    print(md)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
