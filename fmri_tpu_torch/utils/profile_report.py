"""Device time by kernel, and the device's idle share, of a ``torch.profiler``
trace. Counterpart of ``fmri_tpu/utils/profile_report.py`` (which reads
``jax.profiler``'s xplane files).

The trainer's ``--profile`` exports one Chrome trace (``trace.json``) of a
whole epoch. The device's work is the events of categories ``kernel``,
``gpu_memcpy`` and ``gpu_memset``; the traced window runs from the first
event of the trace to the end of the last. Busy time is the union of the
device intervals (work on several streams may overlap), so busy + idle =
the window.

CLI:  python -m fmri_tpu_torch.utils.profile_report <trace-dir-or-json> [--top N]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from collections import defaultdict
from typing import Dict, List

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def find_trace(path: str) -> str:
    """A trace file, or the newest ``*.json`` under a trace dir."""
    if os.path.isfile(path):
        return path
    hits = sorted(glob.glob(os.path.join(path, "**", "*.json"), recursive=True),
                  key=os.path.getmtime)
    if not hits:
        raise FileNotFoundError(f"no *.json trace under {path}")
    return hits[-1]


def _union_us(spans: List[tuple]) -> float:
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi <= end:
            continue
        busy += hi - max(lo, end)
        end = hi
    return busy


def summarize(path: str) -> Dict[str, object]:
    """``{"window_ms", "busy_ms", "idle_share", "kernels", "by_kernel":
    {name: (calls, device ms)}}`` of one Chrome trace; ``idle_share`` is
    None when the trace holds no device work (a CPU run)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    timed = [e for e in events if e.get("ph") == "X" and "dur" in e]
    if not timed:
        raise ValueError(f"{path} holds no timed events")
    lo = min(float(e["ts"]) for e in timed)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in timed)
    kernels = [e for e in timed if e.get("cat") in DEVICE_CATEGORIES]
    by_kernel: Dict[str, list] = defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_kernel[e["name"]][0] += 1
        by_kernel[e["name"]][1] += float(e["dur"]) / 1e3
    busy = _union_us([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in kernels])
    window = hi - lo
    return {"window_ms": window / 1e3, "busy_ms": busy / 1e3,
            "idle_share": (1.0 - busy / window) if kernels else None,
            "kernels": len(kernels),
            "by_kernel": {k: tuple(v) for k, v in by_kernel.items()}}


def format_report(s: Dict[str, object], top: int = 15) -> str:
    if s["idle_share"] is None:
        return (f"window {s['window_ms']:.2f} ms; no device kernels in the trace "
                "(a CPU run): no idle share")
    lines = [f"window {s['window_ms']:.2f} ms; device busy {s['busy_ms']:.2f} ms in "
             f"{s['kernels']} kernels; idle {100 * s['idle_share']:.1f}%",
             f"-- top kernels (calls, device ms, % of busy):"]
    for name, (n, ms) in sorted(s["by_kernel"].items(), key=lambda kv: -kv[1][1])[:top]:
        lines.append(f"  {n:6d} {ms:10.3f}  {100 * ms / s['busy_ms']:5.1f}%  {name[:100]}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="trace dir (<run>/profile) or a trace .json")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    path = find_trace(args.trace)
    print(f"trace: {path}")
    print(format_report(summarize(path), top=args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
