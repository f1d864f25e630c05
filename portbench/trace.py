"""Reading a ``torch.profiler`` Chrome trace: the device's busy time and idle
share, kernels by name, the device time of the kernels launched under given
host ops, and the idle gaps by what the host was doing.

``union_us`` and the busy/idle arithmetic are a frozen copy of
``fmri_tpu_torch/utils/profile_report.py`` (``_union_us``, ``summarize``):
the device's work is the events of categories ``kernel``, ``gpu_memcpy``
and ``gpu_memset``, busy time the union of their intervals, and the traced
window runs from the first timed event to the end of the last.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation")


def union_us(spans: Iterable[Tuple[float, float]]) -> float:
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi <= end:
            continue
        busy += hi - max(lo, end)
        end = hi
    return busy


def _busy_intervals(spans) -> List[Tuple[float, float]]:
    out: List[list] = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(a, b) for a, b in out]


class Trace:
    """The timed events of one Chrome trace, split into device work, kernel
    launches and host ops."""

    def __init__(self, path: str):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        self.timed = [e for e in events if e.get("ph") == "X" and "dur" in e]
        self.device = [e for e in self.timed if e.get("cat") in DEVICE_CATEGORIES]
        self.kernels = [e for e in self.device if e.get("cat") == "kernel"]
        self.launches = {e["args"]["correlation"]: e for e in self.timed
                         if e.get("cat") in ("cuda_runtime", "cuda_driver")
                         and "correlation" in e.get("args", {})}
        self.host: Dict[object, List[dict]] = defaultdict(list)
        for e in self.timed:
            if e.get("cat") in HOST_CATEGORIES:
                self.host[e["tid"]].append(e)
        for ops in self.host.values():
            ops.sort(key=lambda e: (float(e["ts"]), -float(e["dur"])))

    def window_us(self) -> float:
        lo = min(float(e["ts"]) for e in self.timed)
        hi = max(float(e["ts"]) + float(e["dur"]) for e in self.timed)
        return hi - lo

    def busy_us(self) -> float:
        return union_us((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in self.device)

    def by_kernel(self) -> Dict[str, float]:
        """Device seconds by kernel (and copy) name."""
        out: Dict[str, float] = defaultdict(float)
        for e in self.device:
            out[e["name"]] += float(e["dur"]) / 1e6
        return dict(out)

    def stacks(self, queries: List[Tuple[object, float]]) -> List[List[dict]]:
        """For each (thread, time) query, the host ops of that thread running
        at that time, outermost first (one sweep per thread)."""
        out: List[List[dict]] = [[] for _ in queries]
        per_tid: Dict[object, List[int]] = defaultdict(list)
        for i, (tid, _) in enumerate(queries):
            per_tid[tid].append(i)
        for tid, idx in per_tid.items():
            ops, j, stack = self.host.get(tid, []), 0, []
            for i in sorted(idx, key=lambda i: queries[i][1]):
                t = queries[i][1]
                while j < len(ops) and float(ops[j]["ts"]) <= t:
                    start = float(ops[j]["ts"])
                    while stack and float(stack[-1]["ts"]) + float(stack[-1]["dur"]) < start:
                        stack.pop()
                    stack.append(ops[j])
                    j += 1
                while stack and float(stack[-1]["ts"]) + float(stack[-1]["dur"]) < t:
                    stack.pop()
                out[i] = [e for e in stack if float(e["ts"]) + float(e["dur"]) >= t]
        return out

    def _launch(self, kernel: dict):
        return self.launches.get(kernel.get("args", {}).get("correlation"))

    def kernel_seconds_under(self, op_names) -> float:
        """Device seconds of the kernels launched while a host op named in
        ``op_names`` ran on the launching thread."""
        pairs = [(k, self._launch(k)) for k in self.kernels]
        pairs = [(k, l) for k, l in pairs if l is not None]
        stacks = self.stacks([(l["tid"], float(l["ts"])) for _, l in pairs])
        return sum(float(k["dur"]) / 1e6 for (k, _), st in zip(pairs, stacks)
                   if any(e["name"] in op_names for e in st))

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The device's idle gaps summed by what the host was doing: at each
        gap's middle, on the thread that launched the next kernel, the
        outermost benchmark span and the innermost op ("idle" where it ran
        nothing traced). The ``top`` names with the most idle seconds."""
        spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e) for e in self.device]
        spans.sort(key=lambda s: s[0])
        busy = _busy_intervals((a, b) for a, b, _ in spans)
        starts = [a for a, _, _ in spans]
        gaps = []
        for (_, end), (nxt, _) in zip(busy, busy[1:]):
            launch = self._launch(spans[bisect.bisect_left(starts, nxt)][2])
            gaps.append((nxt - end, None if launch is None else (launch["tid"], (end + nxt) / 2)))
        asked = [q for _, q in gaps if q is not None]
        found = iter(self.stacks(asked))
        out: Dict[str, float] = defaultdict(float)
        for gap, q in gaps:
            name = "idle"
            if q is not None:
                ops = next(found)
                parts = ([e["name"] for e in ops if e.get("cat") == "user_annotation"][:1]
                         + [e["name"] for e in ops if e.get("cat") == "cpu_op"][-1:])
                name = " > ".join(parts) if parts else "idle"
            out[name] += gap / 1e6
        return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])[:top]]
