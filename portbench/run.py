"""Run one cell of the benchmark of ``fmri_tpu_torch`` once, on the card:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Makes the cell's inputs and weights from ``--seed``, sets up the program,
measures for ``--seconds``, checks what the timed path produced against
the plain reference in ``portbench/reference/``, and prints one JSON line:
the end-to-end metrics with ``--trace 0``, the per-layer ones with
``--trace 1``. It exits non-zero and prints no result without a CUDA card,
when the program is missing, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout, so
    only the first run of a checkout builds."""
    cache = os.path.join(ROOT, ".portbench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a non-negative integer")
    _caches()
    sys.path.insert(0, ROOT)
    from portbench import harness

    cell, config, traffic = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} CUDA card(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"card: {harness.card_line()}", flush=True)
    kind = harness.traffic_kind(traffic["kind"])
    return kind.run(cell, config, traffic, seed=args.seed, seconds=args.seconds,
                    trace=bool(args.trace), device=torch.device("cuda"))


if __name__ == "__main__":
    sys.exit(main())
