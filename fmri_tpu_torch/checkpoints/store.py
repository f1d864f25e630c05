"""Checkpoint save/restore, retention and cross-stage handoff.

Counterpart of ``fmri_tpu/checkpoints/store.py``. A checkpoint is the full
train state, so a resumed run continues bit for bit (the reference saves
only the weights, ``train_vgan_stage1.py:596-598``)::

    <ckpt_dir>/ckpt_<epoch:05d>/
        state.pt     one torch.save of plain dicts of CPU tensors:
                     {"groups": {group: the group's state_dict()},
                      "opt_state": {group: {"sq_avg": {...}} (RMSprop) or
                                    {"mu": {...}, "nu": {...}, "count": t} (Adam)},
                      "step": int64 scalar}
        meta.json    {"epoch", "seed", "metrics": {...}}

A group's state dict is its submodule's (``nets.module(group)``): the
parameters, the BatchNorm running statistics and ``num_batches_tracked``,
under the submodule's own keys. Nothing but tensors, dicts and ints is
pickled, so ``torch.load(..., weights_only=True)`` reads the file.

The stage handoff goes by group name (``encoder``, ``decoder``,
``discriminator``, ``latent_disc``, ``teacher_encoder``):
:func:`load_groups` reads named groups from a port checkpoint dir or from
a reference-layout ``.pth`` (through ``convert.load_train_pth`` and the
source module's ``PREFIXES``), and :func:`graft_groups` loads them into a
train module, buffers included. The JAX package's orbax checkpoints are
not read here.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import TYPE_CHECKING, Any, Dict, Mapping, Optional, Sequence, Tuple

import torch

from fmri_tpu_torch.train.optim import AdamState

if TYPE_CHECKING:
    from torch import nn

    from fmri_tpu_torch.train.state import TrainState

_CKPT_RE = re.compile(r"^ckpt_(\d+)$")
STATE_FILE, META_FILE = "state.pt", "meta.json"


def _ckpt_path(ckpt_dir: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"ckpt_{epoch:05d}")


def list_checkpoints(ckpt_dir: str) -> Dict[int, str]:
    """Map epoch -> checkpoint path for every checkpoint under ``ckpt_dir``."""
    out: Dict[int, str] = {}
    if not os.path.isdir(ckpt_dir):
        return out
    for name in os.listdir(ckpt_dir):
        m = _CKPT_RE.match(name)
        if m and os.path.isdir(os.path.join(ckpt_dir, name)):
            out[int(m.group(1))] = os.path.join(os.path.abspath(ckpt_dir), name)
    return out


def latest_epoch(ckpt_dir: str) -> Optional[int]:
    cps = list_checkpoints(ckpt_dir)
    return max(cps) if cps else None


def _resolve(ckpt_dir: str, epoch: Optional[int]) -> Tuple[int, str]:
    if epoch is None:
        epoch = latest_epoch(ckpt_dir)
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = _ckpt_path(ckpt_dir, epoch)
    if not os.path.exists(os.path.join(path, STATE_FILE)):
        raise FileNotFoundError(f"no {STATE_FILE} in {path}")
    return epoch, path


def _host(t: torch.Tensor) -> torch.Tensor:
    # a synchronous copy: complete when it returns, so a step that updates
    # the live tensor in place afterwards cannot reach the snapshot
    return t.detach().to("cpu", copy=True)


def host_tree(state: "TrainState") -> Dict[str, Any]:
    """A complete host copy of ``state`` in the checkpoint layout."""
    nets = state.nets
    groups = {g: {k: _host(v) for k, v in nets.module(g).state_dict().items()}
              for g in nets.PREFIXES}
    opt: Dict[str, Any] = {}
    for g, m in state.opt_state.items():
        if isinstance(m, AdamState):
            opt[g] = {"mu": {k: _host(v) for k, v in m.mu.items()},
                      "nu": {k: _host(v) for k, v in m.nu.items()},
                      "count": _host(m.count)}
        else:
            opt[g] = {"sq_avg": {k: _host(v) for k, v in m.items()}}
    return {"groups": groups, "opt_state": opt, "step": _host(state.step)}


def _write_checkpoint(ckpt_dir: str, epoch: int, tree: Dict[str, Any],
                      meta: Mapping[str, Any]) -> str:
    """Write a host tree to ``ckpt_dir/ckpt_<epoch>``: into a temporary dir,
    renamed into place once complete (an existing checkpoint of the epoch
    is replaced)."""
    path = _ckpt_path(ckpt_dir, epoch)
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(tree, os.path.join(tmp, STATE_FILE))
    with open(os.path.join(tmp, META_FILE), "w") as f:
        json.dump({**meta, "epoch": epoch}, f, indent=2, default=str)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    return path


def save_checkpoint(ckpt_dir: str, epoch: int, state: "TrainState",
                    meta: Optional[Mapping[str, Any]] = None) -> str:
    """Write ``ckpt_dir/ckpt_<epoch>`` with the full train state and
    ``meta``; returns its path."""
    return _write_checkpoint(ckpt_dir, epoch, host_tree(state), dict(meta or {}))


def _read(ckpt_dir: str, epoch: Optional[int]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    epoch, path = _resolve(ckpt_dir, epoch)
    tree = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                      weights_only=True)
    meta = {"epoch": epoch, **checkpoint_meta(path)}
    return tree, meta


def _copy_into(dst: Mapping[str, torch.Tensor], src: Mapping[str, torch.Tensor],
               what: str) -> None:
    if set(dst) != set(src):
        raise KeyError(f"{what}: checkpoint keys differ from the state's "
                       f"({sorted(set(dst) ^ set(src))[:4]} ...)")
    for k, t in dst.items():
        t.copy_(src[k])


@torch.no_grad()
def restore_checkpoint(ckpt_dir: str, template: "TrainState",
                       epoch: Optional[int] = None
                       ) -> "Tuple[TrainState, Dict[str, Any]]":
    """Restore a checkpoint (the latest when ``epoch`` is None) into
    ``template``, a state of the same stage on any device: its modules,
    moments and step are overwritten in place, bitwise, and it is returned
    with the checkpoint's metadata."""
    tree, meta = _read(ckpt_dir, epoch)
    nets = template.nets
    if set(tree["groups"]) != set(nets.PREFIXES):
        raise KeyError(f"checkpoint groups {sorted(tree['groups'])} are not "
                       f"{type(nets).__name__}'s {sorted(nets.PREFIXES)}")
    for g, sd in tree["groups"].items():
        nets.module(g).load_state_dict(sd, strict=True)
    if set(tree["opt_state"]) != set(template.opt_state):
        raise KeyError(f"checkpoint trains {sorted(tree['opt_state'])}, the "
                       f"state {sorted(template.opt_state)}")
    for g, m in template.opt_state.items():
        saved = tree["opt_state"][g]
        if isinstance(m, AdamState):
            _copy_into(m.mu, saved["mu"], f"{g} mu")
            _copy_into(m.nu, saved["nu"], f"{g} nu")
            m.count.copy_(saved["count"])
        else:
            _copy_into(m, saved["sq_avg"], f"{g} sq_avg")
    template.step.copy_(tree["step"])
    return template, meta


def load_eval_state(ckpt_dir: str, epoch: Optional[int] = None
                    ) -> Tuple[Dict[str, Dict[str, torch.Tensor]], Dict[str, Any]]:
    """(groups, meta) of a checkpoint for inference: every group's state
    dict on the CPU, no optimizer state, read without the train module, so
    any stage's checkpoint loads."""
    tree, meta = _read(ckpt_dir, epoch)
    meta["step"] = int(tree["step"])
    return tree["groups"], meta


def load_groups(source: str, names: Sequence[str], epoch: Optional[int] = None, *,
                prefixes: Optional[Mapping[str, str]] = None
                ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The state dicts of the named groups: from a port checkpoint dir
    (``epoch``, default the latest), or from a reference-layout ``.pth``
    file, split by ``prefixes``, the source module's ``PREFIXES`` (e.g.
    ``VaeGan.PREFIXES`` for a stage-I file)."""
    if os.path.isdir(source):
        groups = _read(source, epoch)[0]["groups"]
    else:
        if prefixes is None:
            raise ValueError(f"{source} is a .pth: pass the prefixes of its module")
        from fmri_tpu_torch.checkpoints.convert import load_train_pth

        sd = load_train_pth(source)
        groups = {}
        for g, p in prefixes.items():
            part = {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}
            if part:
                groups[g] = part
    missing = [n for n in names if n not in groups]
    if missing:
        raise KeyError(f"groups {missing} not in {source}; available: {sorted(groups)}")
    return {n: groups[n] for n in names}


@torch.no_grad()
def graft_groups(nets: "nn.Module", source: Mapping[str, Mapping[str, torch.Tensor]],
                 mapping: Mapping[str, str]) -> "nn.Module":
    """Load source groups into ``nets`` under (possibly renamed) groups,
    strictly and in place, parameters and buffers (BatchNorm statistics,
    ``num_batches_tracked``): ``mapping`` maps target group -> source group,
    e.g. stage II's ``{"decoder": "decoder", "discriminator":
    "discriminator", "teacher_encoder": "encoder"}``."""
    for dst, src in mapping.items():
        nets.module(dst).load_state_dict(source[src], strict=True)
    return nets


def checkpoint_meta(path: str) -> Dict[str, Any]:
    """A checkpoint's ``meta.json`` ({} if absent)."""
    meta_path = os.path.join(path, META_FILE)
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def prune_checkpoints(ckpt_dir: str, *, keep_last: int = 0, keep_best: int = 0,
                      best_metric: str = "valid_PCC", best_mode: str = "max",
                      keep_every: int = 0) -> "list[int]":
    """Delete checkpoints outside the retention policy; return the deleted
    epochs. Kept: the union of the ``keep_last`` latest epochs, the
    ``keep_best`` best by ``best_metric`` in their ``meta.json``
    (``best_mode`` 'max'|'min'; checkpoints without it are never best) and
    every ``keep_every``-th epoch, and always the latest. All zeros keeps
    everything, as the reference does."""
    cps = list_checkpoints(ckpt_dir)
    if not cps or (not keep_last and not keep_best and not keep_every):
        return []
    epochs = sorted(cps)
    keep = {epochs[-1]}
    if keep_last:
        keep.update(epochs[-keep_last:])
    if keep_every:
        keep.update(e for e in epochs if e % keep_every == 0)
    if keep_best:
        scored = []
        for e in epochs:
            v = checkpoint_meta(cps[e]).get("metrics", {}).get(best_metric)
            if v is not None:
                scored.append((float(v), e))
        scored.sort(reverse=(best_mode == "max"))
        keep.update(e for _, e in scored[:keep_best])
    deleted = []
    for e in epochs:
        if e not in keep:
            shutil.rmtree(cps[e])
            deleted.append(e)
    return deleted


class AsyncCheckpointWriter:
    """Writes checkpoints on a background thread. ``save`` copies the whole
    state to host memory on the caller's thread and returns once the copy
    is complete, so the next step, which updates the state in place, cannot
    reach the snapshot; the file write (and the retention prune) overlaps
    the next epoch. One write in flight: a new ``save`` or :meth:`wait`
    joins the previous one and re-raises its error."""

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_path: Optional[str] = None

    def save(self, ckpt_dir: str, epoch: int, state: "TrainState",
             meta: Optional[Mapping[str, Any]] = None, *,
             prune: Optional[Mapping[str, Any]] = None) -> None:
        self.wait()
        tree, meta = host_tree(state), dict(meta or {})

        def work() -> None:
            try:
                self.last_path = _write_checkpoint(ckpt_dir, epoch, tree, meta)
                if prune:
                    prune_checkpoints(ckpt_dir, **prune)
            except BaseException as e:  # re-raised on the caller's thread
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True,
                                        name=f"ckpt-write-{epoch}")
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
