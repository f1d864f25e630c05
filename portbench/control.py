"""The readings that a cell's limits are set from, in one process on the card:

    python3 portbench/control.py --workload <cell> --program-seeds 1,2,... \
        --control-seeds 7,8,9 [--fault half_batch] [--seconds 1]

For each program seed, one run of the cell as ``run.py`` makes it (a short
window; its result line carries the compared numbers of a sound run). For
each control seed, the same inputs with the reference put in the program's
place, computed one precision below the configuration's
(``reference.vaegan.control_precision``: bf16 operands -> float8 e4m3 with
a per-tensor scale), against the float32 reference: the numbers that the
comparison has to refuse. The benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _half(steps):
    """Each step's inputs cut to the first half of its rows."""
    return [{k: None if v is None else v[:len(v) // 2] for k, v in s.items()} for s in steps]


def control_numbers(cell, config, traffic, seed: int, device, fault: str = ""):
    """The compared numbers of the reference one precision below the
    configuration's in the program's place, for the inputs that ``seed``
    gives the cell; with ``fault="half_batch"`` the reference in the
    program's place (float32) computes each step on half of its rows and
    takes its means over them."""
    from portbench import harness
    from portbench.reference import vaegan as ref

    kind = harness.traffic_kind(traffic["kind"])
    low_p = ref.control_precision(config["model"])
    if traffic["kind"] == "train_loop":
        imgs, data, specs, w0 = kind.inputs(config, traffic["stage"], seed, device)
        draws = kind.drawer(config, traffic, seed, device)
        checked = []
        for _ in range(traffic["checked_steps"]):
            flip, shifts, noise = draws()
            checked.append({"flip": flip, "shifts": shifts, **noise})
        steps = kind.reference_steps(checked, imgs, data, seed, traffic["batch"], device)
        m, t = config["model"], config["train"]
        low = (ref.train_steps(traffic["stage"], w0, specs, _half(steps), m, t,
                               ref.Precision("float32")) if fault == "half_batch" else
               ref.train_steps(traffic["stage"], w0, specs, steps, m, t, low_p))
        exact = ref.train_steps(traffic["stage"], w0, specs, steps, m, t,
                                ref.Precision("float32"), follow=low["gates"])
        return harness.train_numbers(low, exact, harness.gate_thresholds(t))
    scans, w = kind.inputs(config, traffic, seed, device)
    sample = kind.sample_rows(traffic, seed)
    low = kind.reference_images(w, scans[sample], config, device, low_p)
    exact = kind.reference_images(w, scans[sample], config, device, ref.Precision("float32"))
    return harness.serve_numbers(low, exact)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", default="", choices=("", "half_batch"))
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness

    cell, config, traffic = harness.load_cell(args.workload)
    device = torch.device("cuda")
    kind = harness.traffic_kind(traffic["kind"])
    print(f"card: {harness.card_line()}", flush=True)
    for s in filter(None, args.program_seeds.split(",")):
        print(f"program seed {s}", flush=True)
        kind.run(cell, config, traffic, seed=int(s), seconds=args.seconds, trace=False,
                 device=device)
    for s in filter(None, args.control_seeds.split(",")):
        numbers = control_numbers(cell, config, traffic, int(s), device, args.fault)
        print("control " + json.dumps({"seed": int(s), "fault": args.fault,
                                       "numbers": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
