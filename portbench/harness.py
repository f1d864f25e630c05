"""What every cell shares: finding a cell's files by name, the program's
configuration from a configuration file, the per-layer metric readers, the
comparisons that decide ``correct``, the trace reading, and the result line.

A cell is ``workloads/<name>.json``: its configuration, its traffic mix,
its chips, its why and the limits of its comparisons. A configuration is
``configs/<name>.json``; a traffic mix is ``traffic/<name>.json``, whose
``kind`` names the generator ``traffic/<kind>.py`` that reads it; a
per-layer metric is ``metrics/<name>.py``, whose ``read(ctx)`` returns the
number or None where it finds nothing to read. Adding any of them adds a
file; the harness finds it by name.
"""

from __future__ import annotations

import gc
import glob
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np

BENCH = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "fmri_tpu")


def load_json(bench: str, folder: str, name: str) -> dict:
    path = os.path.join(bench, folder, name + ".json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {folder[:-1] if folder.endswith('s') else folder} "
                                f"named {name!r}: {path} is missing")
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, bench: str = BENCH):
    """(cell, configuration, traffic mix) of the cell ``name``."""
    cell = load_json(bench, "workloads", name)
    return cell, load_json(bench, "configs", cell["config"]), load_json(bench, "traffic",
                                                                        cell["traffic"])


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def traffic_kind(kind: str, bench: str = BENCH):
    path = os.path.join(bench, "traffic", kind + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no traffic generator of kind {kind!r}: {path} is missing")
    return load_module(path, "portbench_traffic_" + kind)


def readers(bench: str = BENCH) -> Dict[str, object]:
    """Every per-layer metric's reader, by the metric's name (its file's)."""
    out = {}
    for path in sorted(glob.glob(os.path.join(bench, "metrics", "*.py"))):
        name = os.path.basename(path)[:-3]
        out[name] = load_module(path, "portbench_metric_" + name.replace(".", "_"))
    return out


def program_config(config: dict, batch: int):
    """The program's ``Config`` of a configuration file, at ``batch`` rows."""
    from fmri_tpu_torch.configs.presets import Config, DataConfig, ModelConfig, TrainConfig

    def fields(d):
        return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}

    return Config(model=ModelConfig(**fields(config["model"])),
                  data=DataConfig(**fields(config["data"])),
                  train=TrainConfig(**dict(fields(config["train"]), batch_size=batch)))


def epoch_order(seed: int, epoch: int, n: int) -> np.ndarray:
    """The rows of a shuffled epoch, in order: the thesis trainer's
    reshuffle as ``Batches`` documents it, a permutation from
    ``default_rng((seed, epoch))``."""
    return np.random.default_rng((seed, epoch)).permutation(n)


def process_age_s() -> float:
    """Seconds since this process started (its start time in /proc)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
        return out[0] if out else "nvidia-smi read nothing"
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


# ----------------------------- the comparisons -----------------------------


def _median(vals):
    return statistics.median(vals) if vals else 0.0


def train_numbers(prog: dict, ref: dict, thresholds=()) -> Dict[str, float]:
    """The training cells' numbers (a cell's limits pick those it compares):
    ``loss_gap``, the worst of the first step's head losses against the
    reference's, relative; ``grad_gap``, the worst leaf's first gradient
    norm as the optimizer took it, and ``grad_gap_median``, the median
    leaf's; ``change_gap``, the worst leaf's change after the checked steps,
    and ``change_gap_median``, the median leaf's. A leaf's gap is between
    the two norms, over the larger of the reference's norm of that leaf and
    of the median leaf. Leaves whose reference gradient is under a
    thousandth of the median leaf's (nought to rounding) move by round-off
    alone and are left out. The later steps' losses are printed, not
    compared: RMSprop's first steps move every weight by about
    lr / sqrt(1 - decay) whatever the gradient's size, so a sign that
    rounding flips moves the later losses further than rounding moves the
    first. The reference trains its groups as the judged side's gates say
    (``train_steps(follow=)``), so a gate that the later steps' drift
    flips moves no group once less on one side; ``gate_gap`` judges each
    such flip: where the judged side decided otherwise than the
    reference's own game (``ref["gates"]``), the reference's gate mean
    nearest to a threshold in ``thresholds``, its distance from it over
    the threshold; 0 where every decision agrees."""
    losses = [{h: abs(p[h] - r[h]) / max(abs(r[h]), 1e-30) for h in r}
              for p, r in zip(prog["losses"], ref["losses"])]
    g_med = _median(list(ref["grad1"].values()))
    keep = [k for k, g in ref["grad1"].items() if g >= 1e-3 * g_med]
    grads = {k: abs(prog["grad1"][k] - ref["grad1"][k]) / max(ref["grad1"][k], g_med)
             for k in keep}
    c_med = _median([ref["change"][k] for k in keep])
    changes = {k: abs(prog["change"][k] - ref["change"][k]) / max(ref["change"][k], c_med)
               for k in keep}
    flips = [min(abs(v - th) / th for v in means for th in thresholds)
             for p, r, means in zip(prog["gates"], ref["gates"], ref["means"]) if p != r]
    later = {f"step{i + 1}.{h}": v for i, d in enumerate(losses) for h, v in d.items()}
    print(f"gates (decoder, discriminator) of the checked steps: judged {prog['gates']}, "
          f"reference's own {ref['gates']} at gate means {ref['means']}", file=sys.stderr)
    for what, gaps in (("loss (every step, not compared)", later), ("step-1 loss", losses[0]),
                       ("grad", grads), ("change", changes)):
        worst = max(gaps, key=gaps.get)
        print(f"worst {what} gap: {worst} {gaps[worst]!r}", file=sys.stderr)
    return {"loss_gap": max(losses[0].values()), "grad_gap": max(grads.values()),
            "grad_gap_median": _median(list(grads.values())),
            "change_gap": max(changes.values()),
            "change_gap_median": _median(list(changes.values())),
            "gate_gap": max(flips, default=0.0)}


def gate_thresholds(t: dict) -> tuple:
    """The equilibrium game's two thresholds (train_vgan_stage1.py:396-404)."""
    return (t["equilibrium"] - t["margin"], t["equilibrium"] + t["margin"])


def serve_numbers(prog_images: np.ndarray, ref_images: np.ndarray) -> Dict[str, float]:
    """The serving cells' compared numbers over the sampled requests' uint8
    images: ``mean_lsb``, the mean absolute difference in levels, and
    ``max_lsb``, the largest."""
    d = np.abs(prog_images.astype(np.int32) - ref_images.astype(np.int32))
    return {"mean_lsb": float(d.mean()), "max_lsb": float(d.max())}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number that has a limit at or under it (a NaN fails)."""
    return all(not math.isnan(numbers[k]) and numbers[k] <= v for k, v in limits.items())


class GcClock:
    """Times Python's garbage collections from its construction to
    ``stop()``, by generation (``gc.callbacks``)."""

    def __init__(self):
        self.n, self.s, self._t0 = [0, 0, 0], [0.0, 0.0, 0.0], None
        gc.callbacks.append(self)

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            g = info["generation"]
            self.n[g] += 1
            self.s[g] += time.perf_counter() - self._t0
            self._t0 = None

    def stop(self) -> None:
        if self in gc.callbacks:
            gc.callbacks.remove(self)

    def seconds(self) -> float:
        return sum(self.s)

    def summary(self) -> str:
        return "collections in the window: " + ", ".join(
            f"generation {g} {self.n[g]} taking {self.s[g]!r} s" for g in range(3))


# ----------------------------- the result -----------------------------


class Context:
    """What a run hands the per-layer readers: its kind, spans (seconds per
    call, by name), counters, the traced window's trace and what the cell
    computed from shapes."""

    def __init__(self, kind: str):
        self.kind = kind
        self.spans: Dict[str, List[float]] = {}
        self.counters: Dict[str, float] = {}
        self.trace = None

    def span(self, name: str, seconds: float) -> None:
        self.spans.setdefault(name, []).append(seconds)


class Span:
    """Times a call into a layer into ``ctx``; under the profiler it also
    marks the call in the trace (``portbench.<name>``)."""

    def __init__(self, ctx: Optional[Context], name: str):
        self.ctx, self.name = ctx, name

    def __enter__(self):
        if self.ctx is not None:
            import torch

            self._rf = torch.profiler.record_function("portbench." + self.name)
            self._rf.__enter__()
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.ctx is not None:
            self.ctx.span(self.name, time.perf_counter() - self.t0)
            self._rf.__exit__(*exc)
        return False


def profiler(cuda: bool):
    """A ``torch.profiler`` of the host's ops and, on the card, its kernels."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU]
                   + ([ProfilerActivity.CUDA] if cuda else []))


def warm_profiler(cuda: bool) -> None:
    """Start and stop a profiler once, in set-up: its first start loads and
    initializes the tracing libraries, which would stall a window."""
    p = profiler(cuda)
    p.start()
    p.stop()


def per_layer(ctx: Context, moves: List[str], bench: str = BENCH) -> Dict[str, dict]:
    """The metrics whose readers find something in ``ctx`` and that move one
    of this cell's end-to-end metrics."""
    out = {}
    for name, r in readers(bench).items():
        if r.MOVES not in moves:
            continue
        v = r.read(ctx)
        if v is not None:
            out[name] = {"value": v, "unit": r.UNIT}
    return out


def trace_device(ctx: Context) -> dict:
    """``busy_s`` and ``window_s`` of the traced window."""
    t = ctx.trace
    return {"busy_s": t.busy_us() / 1e6, "window_s": t.window_us() / 1e6}


def breakdown(ctx: Context) -> dict:
    t = ctx.trace
    ops = sorted(t.by_kernel().items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": t.idle_gaps(10)}


def emit(result: dict, numbers: Dict[str, float], limits: Dict[str, float]) -> None:
    """The compared numbers (those the cell gives a limit) beside their
    limits as the last lines of standard error, and the result as the last
    line of standard output, with the same numbers under ``checks``, its
    last key. Numbers without a limit are printed before them."""
    result = dict(result, checks={k: {"value": numbers[k], "limit": v}
                                  for k, v in limits.items()})
    for k, v in numbers.items():
        if k not in limits:
            print(f"not compared: {k} {v!r}", file=sys.stderr, flush=True)
    for k, v in limits.items():
        print(f"check {k} {numbers[k]!r} limit {v!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
