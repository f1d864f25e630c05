"""Device time by kernel, and the device's idle share, of a ``torch.profiler``
trace. Counterpart of ``fmri_tpu/utils/profile_report.py`` (which reads
``jax.profiler``'s xplane files).

The trainer's ``--profile`` exports one Chrome trace (``trace.json``) of a
whole epoch. The device's work is the events of categories ``kernel``,
``gpu_memcpy`` and ``gpu_memset``; the traced window runs from the first
event of the trace to the end of the last. Busy time is the union of the
device intervals (work on several streams may overlap), so busy + idle =
the window.

The table "by program span" reads the program's own spans
(``utils/spans.py``: ``fmri.train.step``, its phases, ``fmri.input.*``).
For each span name: its calls and host ms, the kernels launched inside it
and their device ms, the blocking CUDA calls made inside it, and the
device's idle ms whose gap midpoint falls inside it. A span's figures
include its children's. A launch belongs to the spans open around it on
its own thread; one that no span covers there (autograd's device thread
launches the backward's kernels) goes under the spans open at that moment
on the thread that records ``fmri.train.step``. Blocking calls count on
their own thread only.

CLI:  python -m fmri_tpu_torch.utils.profile_report <trace-dir-or-json> [--top N]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from collections import Counter, defaultdict
from typing import Dict, List

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "fmri."
# CUDA runtime calls that hold the host until the device is done
BLOCKING = ("cudaDeviceSynchronize", "cudaStreamSynchronize", "cudaEventSynchronize")


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


def _open_spans(spans: Dict[object, List[tuple]], queries: List[tuple]) -> List[List[str]]:
    """For each (thread, time) query, the names of that thread's spans open
    at that time, outermost first (one sweep per thread)."""
    out: List[List[str]] = [[] for _ in queries]
    per_tid: Dict[object, List[int]] = defaultdict(list)
    for i, (tid, _) in enumerate(queries):
        per_tid[tid].append(i)
    for tid, idx in per_tid.items():
        todo, j, stack = spans.get(tid, []), 0, []
        for i in sorted(idx, key=lambda i: queries[i][1]):
            t = queries[i][1]
            while j < len(todo) and todo[j][0] <= t:
                stack.append(todo[j])
                j += 1
            stack = [s for s in stack if s[1] >= t]
            out[i] = [s[2] for s in stack]
    return out


def by_span(timed: List[dict]) -> Dict[str, Dict[str, float]]:
    """``{span name: {"calls", "host_ms", "kernels", "device_ms", "syncs",
    "idle_ms"}}`` of the program's spans in a trace's timed events."""
    spans: Dict[object, List[tuple]] = defaultdict(list)
    out: Dict[str, Dict[str, float]] = {}
    for e in timed:
        if e.get("cat") == "user_annotation" and e["name"].startswith(SPAN_PREFIX):
            lo = float(e["ts"])
            spans[e["tid"]].append((lo, lo + float(e["dur"]), e["name"]))
            row = out.setdefault(e["name"], dict.fromkeys(
                ("calls", "host_ms", "kernels", "device_ms", "syncs", "idle_ms"), 0.0))
            row["calls"] += 1
            row["host_ms"] += float(e["dur"]) / 1e3
    for v in spans.values():
        v.sort(key=lambda s: (s[0], -s[1]))

    def add(queries, **columns):
        """Each column's ``i``-th value into that column of every span open
        at ``queries[i]`` = (thread, time); thread None: on any thread."""
        found = [set() for _ in queries]
        for tid in spans:
            idx = [i for i, (q, _) in enumerate(queries) if q in (tid, None)]
            for i, names in zip(idx, _open_spans(spans, [(tid, queries[i][1]) for i in idx])):
                found[i].update(names)
        for i, names in enumerate(found):
            for name in names:
                for key, values in columns.items():
                    out[name][key] += values[i]

    runtime = [e for e in timed if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    launches = {e["args"]["correlation"]: e for e in runtime if "correlation" in e.get("args", {})}
    kernels = [(k, launches.get(k.get("args", {}).get("correlation")))
               for k in timed if k.get("cat") == "kernel"]
    kernels = [(k, (l["tid"], float(l["ts"]))) for k, l in kernels if l is not None]
    steps = Counter(tid for tid, v in spans.items() for s in v
                    if s[2] == SPAN_PREFIX + "train.step")
    if steps:  # a launch no span covers on its own thread: the step thread's spans
        main = steps.most_common(1)[0][0]
        own = _open_spans(spans, [q for _, q in kernels])
        kernels = [(k, q if names else (main, q[1])) for (k, q), names in zip(kernels, own)]
    add([q for _, q in kernels], kernels=[1.0] * len(kernels),
        device_ms=[float(k["dur"]) / 1e3 for k, _ in kernels])
    calls = [(e["tid"], float(e["ts"])) for e in runtime if e["name"] in BLOCKING]
    add(calls, syncs=[1.0] * len(calls))
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in timed
                    if e.get("cat") in DEVICE_CATEGORIES)
    gaps, end = [], None
    for lo, hi in device:
        if end is not None and lo > end:
            gaps.append((lo - end, (None, (lo + end) / 2)))
        end = hi if end is None else max(end, hi)
    add([q for _, q in gaps], idle_ms=[g / 1e3 for g, _ in gaps])
    return out


def summarize(path: str) -> Dict[str, object]:
    """``{"window_ms", "busy_ms", "idle_share", "kernels", "by_kernel":
    {name: (calls, device ms)}, "by_span": by_span(...)}`` of one Chrome
    trace; ``idle_share`` is None when the trace holds no device work (a
    CPU run)."""
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
            "by_kernel": {k: tuple(v) for k, v in by_kernel.items()},
            "by_span": by_span(timed)}


def format_report(s: Dict[str, object], top: int = 15) -> str:
    if s["idle_share"] is None:
        lines = [f"window {s['window_ms']:.2f} ms; no device kernels in the trace "
                 "(a CPU run): no idle share"]
    else:
        lines = [f"window {s['window_ms']:.2f} ms; device busy {s['busy_ms']:.2f} ms in "
                 f"{s['kernels']} kernels; idle {100 * s['idle_share']:.1f}%",
                 f"-- top kernels (calls, device ms, % of busy):"]
        for name, (n, ms) in sorted(s["by_kernel"].items(), key=lambda kv: -kv[1][1])[:top]:
            lines.append(f"  {n:6d} {ms:10.3f}  {100 * ms / s['busy_ms']:5.1f}%  {name[:100]}")
    if s["by_span"]:
        lines.append("-- by program span (calls, host ms, kernels launched, their device ms, "
                     "blocking syncs, device idle ms):")
        for name, r in sorted(s["by_span"].items()):
            lines.append(f"  {r['calls']:6.0f} {r['host_ms']:10.3f} {r['kernels']:8.0f} "
                         f"{r['device_ms']:10.3f} {r['syncs']:6.0f} {r['idle_ms']:10.3f}  {name}")
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
