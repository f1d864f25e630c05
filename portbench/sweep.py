"""The serving knee, once, on the card: one server of a serving cell's
configuration and settings, then the open loop at each of ``--rates`` for
``--seconds``, in one process:

    python3 portbench/sweep.py --workload <serving cell> --rates 2000,4000,... \
        [--seconds 10] [--seed 1]

Per rate: requests, shed, p50 / p95 / p99 ms, and the p95 of the window's
first and last fifth (a backlog that grows shows as a later tail). The knee
is the highest rate with no shed request and no growth; the cell's rate is
set at about four fifths of it. The benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from portbench import datagen, harness

    cell, config, traffic = harness.load_cell(args.workload)
    kind = harness.traffic_kind(traffic["kind"])
    from fmri_tpu_torch.eval.serve import BatchingServer, ServingModel
    from fmri_tpu_torch.eval.steps import VaeGanCognitive

    device = torch.device(args.device)
    cfg = harness.program_config(config, traffic["max_batch"])
    scans, w = kind.inputs(config, traffic, args.seed, device)
    model = VaeGanCognitive(cfg.model).to(device)
    model.load_state_dict(w, strict=True)
    served = ServingModel(cfg, model, family="vgan", stage=3, max_batch=traffic["max_batch"],
                          output=traffic["output"], device=device)
    served.warmup(generate=False)
    if device.type == "cuda":
        print(f"card: {harness.card_line()}", flush=True)
    rng = np.random.default_rng(args.seed)
    for rate in (float(r) for r in args.rates.split(",")):
        server = BatchingServer(served, max_wait_ms=traffic["max_wait_ms"])
        try:
            due = kind.arrivals(rate, args.seconds, args.seed, datagen.ARRIVALS)
            load = kind._Load(server, scans, due, rng.integers(0, len(scans), len(due))).run()
            stats = server.stats()
        finally:
            server.close()
        lat = 1e3 * load.latencies_s()
        fifth = len(lat) // 5
        row = {"rate_per_s": rate, "requests": len(due), "failed": int(load.failed.sum()),
               "shed": stats["shed"], "rows_per_batch": stats["requests"] / max(stats["batches"], 1)}
        for q in (50, 95, 99):
            row[f"p{q}_ms"] = float(np.percentile(lat, q))
        row["p95_first_fifth_ms"] = float(np.percentile(lat[:fifth], 95))
        row["p95_last_fifth_ms"] = float(np.percentile(lat[-fifth:], 95))
        row["lag_p95_ms"] = 1e3 * float(np.percentile(load.lag_s(), 95))
        print("sweep " + json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
