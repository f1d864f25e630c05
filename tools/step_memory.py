"""Peak device memory of one warm train step of a row of ``chip_smoke.py``'s
phase 19 (``SUITE_ROWS``), with both kernel flags off and on.

    python3 tools/step_memory.py [--root DIR] [--row ROW] [--warmup N]

``--root`` names the checkout whose ``fmri_tpu_torch`` and ``chip_smoke.py``
are imported (default: the one this file is in), so that two commits can be
compared in one process each on the same card. The row's data, weights and
step are the phase's own (``suite_data``, ``suite_weights``, ``train_path``).
After ``--warmup`` steps, the card's peak counter is reset and one more step
runs. Needs one CUDA device. Prints one JSON line: for each flag setting,
the MiB allocated before the step, the step's peak (``max_memory_allocated``)
and the peak above what was held before; and the card's name and power limit
as ``nvidia-smi`` gives them.
"""
import argparse
import gc
import json
import os
import subprocess
import sys


def main() -> None:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=here)
    ap.add_argument("--row", default="stage1_vgan_res100_bf16")
    ap.add_argument("--warmup", type=int, default=2)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        sys.exit("step_memory: torch.cuda.is_available() is False: needs an NVIDIA GPU")
    import chip_smoke as smoke
    from fmri_tpu_torch.configs import get_config
    from fmri_tpu_torch.device import resolve_device
    from fmri_tpu_torch.ops import build

    build.build()
    dev = resolve_device("cuda")  # TF32 off, as the smoke runs
    path, preset, b = smoke.SUITE_ROWS[args.row]  # a train row: train_path knows its path
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = {"root": root, "row": args.row, "batch": b, "card": smi.strip()}
    for key, flags in (("flags_off", {}), ("flags_on", {"pallas_bn": True,
                                                         "pallas_backward": True})):
        cfg = smoke.with_flags(get_config(preset), **flags)
        gen = torch.Generator(device=dev).manual_seed(19)
        draw = smoke.train_draw(path, cfg, b, dev, gen, *smoke.suite_data(cfg, b, dev, gen))
        step = smoke.train_path(path)[2](cfg)
        state = smoke.train_state(path, cfg, smoke.suite_weights(path, cfg), dev)
        for _ in range(args.warmup):
            state, _ = step(state, *draw())
        mark = smoke.memory_mark()
        state, _ = step(state, *draw())
        torch.cuda.synchronize()
        out[key] = {"held_mib": mark / 2**20,
                    "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
                    "above_mib": smoke.peak_mib(mark)}
        del state, step, draw
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
