"""Reference ``.pth`` files into port checkpoint dirs, and back.

    python -m fmri_tpu_torch.checkpoints.torch_import -i vaegan_90.pth \\
        -o imported --kind vae-gan --preset res64 --epoch 90
    python -m fmri_tpu_torch.checkpoints.torch_import --export -i <run>/checkpoints \\
        -o model.pth --kind vae-gan-cognitive --preset res64

Counterpart of ``fmri_tpu/checkpoints/torch_import.py::main``, with its
flags and defaults. The port's modules hold the reference's torch layout
and names, so no tensor is converted: a ``.pth`` is split into the kind's
groups by their prefixes (``convert.KINDS``, ``convert.OPTIONAL``), each
held strictly (keys and shapes) against the kind's train module at the
preset (``train/state.py``), and written as ``ckpt_<epoch>`` with no
optimizer state (``{"groups", "opt_state": {}, "step": 0}``, meta
``imported_from``, ``kind``, ``preset``). The dir loads in the inference
and serve CLIs (``--ckpt``) and as ``--prev-ckpt`` / ``--stage1-ckpt``.

``--export`` writes a checkpoint dir's groups (``--epoch``, default the
latest) as a reference-layout ``.pth`` of the kind: the JAX CLI's keys, in
its order, and for ``vae-gan-cognitive`` with a ``teacher_encoder`` group
the ``teacher_net.*`` copies a strict reference load needs
(``fmri_tpu/checkpoints/torch_import.py:372-383``). Host code: no device.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Mapping

import torch

from fmri_tpu_torch.checkpoints import convert, store

# the JAX CLI's kinds (``torch_import.py:325``): {kind: train module name}
MODULES = {"vae-gan": "VaeGan", "vae-gan-cognitive": "VaeGanCognitiveTrain",
           "wae-gan": "WaeGan", "wae-gan-cognitive": "WaeGanCognitiveTrain",
           "dcgan": "DcGan"}
# the kind whose optional teacher a reference state dict carries
TEACHER_KIND = "vae-gan-cognitive"


def _prefixes(kind: str, optional: bool) -> Dict[str, str]:
    """{group: state-dict prefix} of the kind's required (and optional) groups."""
    out = {g: prefix for g, (_, prefix) in convert.KINDS[kind].items()}
    if optional:
        out.update({g: spec[1] for g, spec in convert.OPTIONAL.get(kind, {}).items()})
    return out


def _shared(kind: str) -> Dict[str, str]:
    """{copy's prefix: shared prefix}: the teacher's copies of shared modules."""
    out = {}
    for _, prefix, shared in convert.OPTIONAL.get(kind, {}).values():
        owner = prefix[:prefix.index(".") + 1]  # "teacher_net."
        out.update({owner + s: s for s in shared})
    return out


def check_groups(groups: Mapping[str, Mapping[str, torch.Tensor]], kind: str, cfg) -> None:
    """Each group's keys and shapes against the kind's train module at
    ``cfg`` (built on the meta device); raises ``ValueError``."""
    from fmri_tpu_torch.train import state

    with torch.device("meta"):
        nets = getattr(state, MODULES[kind])(cfg)
    for g, sd in groups.items():
        own = nets.module(g).state_dict()
        bad = sorted(set(own) ^ set(sd))
        if bad:
            raise ValueError(f"group {g!r} of kind {kind!r}: keys differ from the "
                             f"module's at {bad[:3]} (+{max(0, len(bad) - 3)} more)")
        # a 0-d tensor saved with shape (1,) loads, as torch's load_state_dict
        # takes it (the JAX export writes num_batches_tracked so)
        bad = [k for k in own if tuple(own[k].shape) != tuple(sd[k].shape)
               and not (own[k].dim() == 0 and tuple(sd[k].shape) == (1,))]
        if bad:
            raise ValueError(f"group {g!r} of kind {kind!r}: shapes differ from the "
                             f"module's at {bad[:3]} ({[tuple(sd[k].shape) for k in bad[:3]]} "
                             f"vs {[tuple(own[k].shape) for k in bad[:3]]}); check --preset "
                             f"and --num-voxels")


def split_groups(sd: Mapping[str, torch.Tensor], kind: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """A reference state dict of ``kind`` -> its groups. Every key belongs
    to a group, or is a teacher's copy of a shared module equal to it; a
    missing required group raises."""
    prefixes, copies = _prefixes(kind, optional=True), _shared(kind)
    groups: Dict[str, Dict[str, torch.Tensor]] = {}
    left = dict(sd)
    for g, prefix in prefixes.items():
        part = {k[len(prefix):]: left.pop(k) for k in list(left) if k.startswith(prefix)}
        if part:
            groups[g] = part
    for copy, shared in copies.items():
        for k in [k for k in left if k.startswith(copy)]:
            src = shared + k[len(copy):]
            if src not in sd or not torch.equal(sd[src], left.pop(k)):
                raise ValueError(f"{k} is not a copy of {src}: the reference shares the "
                                 f"module, so the two must be equal")
    if left:
        raise ValueError(f"keys outside the groups of kind {kind!r}: {sorted(left)[:3]} "
                         f"(+{max(0, len(left) - 3)} more)")
    missing = [g for g in convert.KINDS[kind] if g not in groups]
    if missing:
        raise ValueError(f"kind {kind!r} needs groups {missing}; the file has "
                         f"{sorted(groups)}")
    return groups


def export_state_dict(groups: Mapping[str, Mapping[str, torch.Tensor]],
                      kind: str) -> Dict[str, torch.Tensor]:
    """The kind's groups as a reference-layout state dict, in the JAX
    export's order: the required groups, then for ``vae-gan-cognitive`` the
    teacher's encoder and its copies of the shared modules."""
    out: Dict[str, torch.Tensor] = {}
    for g, prefix in _prefixes(kind, optional=False).items():
        if g not in groups:
            raise ValueError(f"kind {kind!r} needs group {g!r}; the checkpoint has "
                             f"{sorted(groups)}")
        out.update({prefix + k: v for k, v in groups[g].items()})
    if kind == TEACHER_KIND and "teacher_encoder" in groups:
        _, prefix, shared = convert.OPTIONAL[kind]["teacher_encoder"]
        out.update({prefix + k: v for k, v in groups["teacher_encoder"].items()})
        owner = prefix[:prefix.index(".") + 1]
        out.update({owner + k: v for k, v in list(out.items()) if k.startswith(shared)})
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--input", "-i", required=True,
                    help="reference .pth path (or, with --export, a port checkpoint dir)")
    ap.add_argument("--output", "-o", required=True,
                    help="checkpoint dir (or, with --export, a .pth path)")
    ap.add_argument("--kind", default="vae-gan", choices=sorted(MODULES))
    ap.add_argument("--preset", default="res64")
    ap.add_argument("--epoch", type=int, default=None,
                    help="epoch number to record/select (reference filenames carry it "
                         "as <name>_<epoch>.pth)")
    ap.add_argument("--export", action="store_true",
                    help="reverse direction: port checkpoint -> .pth")
    ap.add_argument("--num-voxels", type=int, default=None,
                    help="override the preset's fMRI voxel count (the reference sizes "
                         "the CognitiveEncoder from the data, train_vgan_stage2.py:182)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from fmri_tpu_torch.configs.presets import get_config, override_num_voxels

    cfg = get_config(args.preset)
    if args.num_voxels is not None:
        cfg = override_num_voxels(cfg, args.num_voxels)
    try:
        if args.export:
            groups, _ = store.load_eval_state(args.input, epoch=args.epoch)
            sd = export_state_dict(groups, args.kind)
            check_groups(split_groups(sd, args.kind), args.kind, cfg)
            torch.save({k: v.contiguous() for k, v in sd.items()}, args.output)
            print(args.output)
            return 0
        groups = split_groups(convert.load_train_pth(args.input), args.kind)
        check_groups(groups, args.kind, cfg)
    except (ValueError, KeyError) as exc:
        raise SystemExit(f"{args.input}: {exc}") from None
    path = store._write_checkpoint(
        args.output, args.epoch or 0,
        {"groups": groups, "opt_state": {}, "step": torch.zeros((), dtype=torch.int64)},
        {"imported_from": args.input, "kind": args.kind, "preset": args.preset})
    print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
