"""Online serving of a trained checkpoint: fMRI -> image (stages II and III)
or image -> image (stage I, and WAE/Dual-GAN).

    python -m fmri_tpu_torch.eval.serve --family vgan --stage 3 \\
        --preset res64 --ckpt <run>/checkpoints --unix-socket /tmp/serve.sock

Counterpart of ``fmri_tpu/eval/serve.py``, whose protocol it speaks byte
for byte (so the JAX package's client talks to this server, and this
package's ``fmri_tpu_torch.eval.client`` to either):

  * **Bucketed batches, one CUDA graph each.** A request batch is chunked at
    ``max_batch`` and each chunk zero-padded up to the nearest power-of-two
    bucket. On the card each (bucket, reconstruct | generate) program is
    captured once as a CUDA graph that reads static device buffers (the
    padded requests, the noise) and runs preprocess (image kinds), the
    forward, denormalize, clip and the optional uint8 quantization into a
    static output, so a request replays one graph instead of launching
    every op from the host. The graphs are captured with cuDNN's
    deterministic algorithms, so a request gives the same bits every time,
    as the JAX server's do. Padding is exact: eval-mode BatchNorm uses
    running statistics, so pad rows cannot perturb real rows. On the CPU
    the same programs run eagerly.
  * **Noise outside the graphs.** With ``sample`` the reparameterization
    noise is drawn from the server's own ``torch.Generator`` (seeded with
    ``seed``) into a static buffer the graph reads; ``generate`` draws its
    z from a second generator (``seed + 0x5EED``) the same way.
  * **Hot reload.** ``reload`` reads a checkpoint, checks its keys and
    shapes against the served model, and copies the weights into the
    existing parameters and buffers in place, between batches: the
    captured graphs keep reading the same addresses.
  * **Dynamic microbatching.** One batcher thread coalesces concurrent
    requests until the largest bucket fills or ``--max-wait-ms`` elapses
    after the first queued request.
  * **Transports.** In-process (``BatchingServer.submit`` -> ``Future``) and
    newline-delimited JSON over a Unix or TCP socket; images return as
    base64 raw uint8 + shape.

Protocol (one JSON object per line, both directions)::

    {"id": 7, "fmri": [ ... num_voxels floats ... ]}
      -> {"id": 7, "shape": [H, W, 3], "dtype": "uint8", "data": "<base64>"}
    {"cmd": "stats"}  -> {"requests": n, "batches": n, "occupancy": f,
                          "latency_ms": {"p50": f, "p95": f, "p99": f}, ...}
    {"cmd": "ping"}   -> {"ok": true}
    {"cmd": "reload", "ckpt": "<dir>", "epoch": n?}   # hot weight swap
                      -> {"reloaded": "<dir>", "epoch": n}
                      # key/shape-checked; refused (old weights kept) on
                      # mismatch, and refused on non-loopback TCP binds
                      # unless --allow-remote-reload
    {"cmd": "generate", "n": k}   # sample k images from the prior
                      -> {"shape": [k, H, W, 3], "dtype": "uint8", ...}
                      # k capped at 8 x max-batch per request

Overload: the pending queue is bounded (``--max-queue``, default 8 x
max-batch). Past it a request is shed at once ->
``{"id": ..., "error": "ServerOverloaded: ...", "shed": true}``. Shutdown
drains accepted requests before stopping. Stage-I servers take the request
key ``"image"``, a flat HWC float list in [0, 1].

``--ckpt`` is a port training run's checkpoint dir (``--load-epoch``,
default the latest) or a reference-layout ``.pth`` of the family and stage.
Runs on ``cuda`` unless ``--device cpu``.

Serving over a mesh of ranks (``parallel/mesh.py``), one process per card:
``--mesh data=N[,model=M]`` splits every bucket's rows over N ranks and,
with M > 1, the cognitive encoder's ``fc1`` by voxels over M (``voxel_tp``,
the training layout); ``--data-parallel`` is ``data=`` every local card.
Rank 0 is the front end: it alone runs the batcher and the socket, and for
each call it broadcasts a command, the padded bucket and the noise it drew
from its seeded generators, so the mesh answers as one card would, up to the
summation order of ``fc1``. The other ranks follow (:meth:`ServingModel.follow`):
they run the same programs in the same order on their rows, and the images
come back to rank 0 over the data group. No collective runs inside a CUDA
graph: under ``voxel_tp`` ``fc1``'s partial product and its all-reduce run
eagerly, and the graph starts at the summed activations. The CLI starts the
other ranks itself (NCCL, one card each; ``--device cpu`` over gloo) and
serves as rank 0, or runs as one rank under torchrun; a shutdown of rank 0
stops every rank.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import queue
import signal
import socketserver
import sys
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np
import torch

from fmri_tpu_torch.configs.presets import Config
from fmri_tpu_torch.data.transforms import denormalize, eval_preprocess
from fmri_tpu_torch.device import deterministic_cudnn, resolve_device
from fmri_tpu_torch.eval.steps import eval_module

# eager calls of a program on a side stream before its capture: cuDNN picks
# its algorithm and allocates its workspace there, not inside the graph
CAPTURE_WARM_CALLS = 2
# the commands rank 0 of a serving mesh broadcasts to the other ranks
STOP, RECONSTRUCT, GENERATE, WARMUP, RELOAD = range(5)


def batch_buckets(max_batch: int, min_bucket: int = 1) -> List[int]:
    """Power-of-two bucket ladder ending exactly at ``max_batch``."""
    if max_batch < 1:
        raise ValueError("max_batch must be >= 1")
    out, b = [], max(1, min_bucket)
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return sorted(set(out))


def check_mesh(data_kind: str, cfg: Config, max_batch: int, data: int, model: int,
               voxel_tp: bool) -> None:
    """The JAX server's checks of a serving mesh
    (``fmri_tpu/eval/serve.py:139-155``), each a ``ValueError``: ``voxel_tp``
    serves fMRI, over a model axis that splits the voxels; every bucket
    splits over the data axis."""
    if voxel_tp:
        if data_kind != "pair":
            raise ValueError("voxel_tp serves cognitive (fmri->image) checkpoints; this "
                             "family and stage take images")
        if cfg.model.num_voxels % model:
            raise ValueError(f"num_voxels={cfg.model.num_voxels} not divisible by the "
                             f"model axis ({model})")
    if max_batch % data:
        raise ValueError(f"max_batch={max_batch} not divisible by the mesh's data axis "
                         f"({data})")


class ServingModel:
    """A device-resident eval module behind bucketed batches.

    ``model`` is the eval module of ``family`` and ``stage``
    (``eval/steps.py::eval_module``). ``reconstruct`` takes any
    [N, *sample_shape()] request batch (or one sample) and returns
    [N, H, W, 3] images in [0, 1] (float32, or uint8 with
    ``output="uint8"``); ``generate`` decodes prior samples. On CUDA every
    (bucket, reconstruct | generate) program runs as a CUDA graph, captured
    by :meth:`warmup` or at the bucket's first use; ``graphs`` counts them.

    With ``mesh`` (``parallel.mesh.make_mesh``) every rank builds its own
    ServingModel from the same weights: each bucket is a multiple of the
    data axis and each rank computes its rows; with ``voxel_tp`` the
    module's ``fc1`` weight is replaced by this rank's voxel columns. Rank 0
    takes the calls and answers them; every other rank runs
    :meth:`follow` until rank 0's :meth:`stop`.
    """

    def __init__(self, cfg: Config, model: torch.nn.Module, *,
                 family: str = "vgan", stage: int = 3,
                 max_batch: int = 64, min_bucket: int = 1,
                 sample: bool = False, seed: int = 0, output: str = "float",
                 device: str | torch.device = "cuda", mesh=None, voxel_tp: bool = False):
        if output not in ("float", "uint8"):
            raise ValueError(f"output must be 'float' or 'uint8', got {output!r}")
        cls, self.data_kind = eval_module(family, stage)
        if not isinstance(model, cls):
            raise TypeError(f"family {family} stage {stage} serves a {cls.__name__}, "
                            f"got a {type(model).__name__}")
        if voxel_tp and mesh is None:
            raise ValueError("voxel_tp requires a mesh")
        data = 1 if mesh is None else mesh.data
        if mesh is not None:
            check_mesh(self.data_kind, cfg, int(max_batch), mesh.data, mesh.model, voxel_tp)
        self.cfg, self.output = cfg, output
        self.family, self.stage = family, stage
        self.mesh, self.voxel_tp = mesh, bool(voxel_tp)
        self.device = resolve_device(device if mesh is None else mesh.device)
        self.model = model.to(self.device).eval()
        if self.voxel_tp:
            from fmri_tpu_torch.parallel.mesh import TP_LAYERS, shard_layer

            group, key = TP_LAYERS["voxel_tp"]
            shard_layer(self.model.encoder, key, mesh)
            self._shard_key = f"{group}.{key}"
        self.max_batch = int(max_batch)
        self.buckets = [b * data for b in batch_buckets(self.max_batch // data,
                                                        max(1, min_bucket // data))]
        # the static buffers: what rank 0 fills (and broadcasts over a mesh),
        # the padded input, the reparameterization noise (sampling models
        # only) and the prior draws, whole; and what this rank's programs
        # read, its rows of them (the same tensors with one data rank)
        latent, dev = cfg.model.latent_dim, self.device
        sampling = sample and model.samples

        def buffers(shape, rows=1):
            return {b: torch.zeros((b // rows, *shape), device=dev) for b in self.buckets}

        self._req = buffers(self.sample_shape())
        self._req_eps = buffers((latent,)) if sampling else {}
        self._req_z = buffers((latent,))
        if data == 1:
            self._inputs, self._eps, self._z = self._req, self._req_eps, self._req_z
        else:
            self._inputs = buffers(self.sample_shape(), data)
            self._eps = buffers((latent,), data) if sampling else {}
            self._z = buffers((latent,), data)
        # under voxel_tp, fc1's product summed over the model group: where
        # the captured program starts
        self._h = buffers((cfg.model.cog_hidden,), data) if self.voxel_tp else {}
        # the normalization constants on the device: a host-to-device copy
        # cannot be captured
        self._mean, self._std = (torch.tensor(v, device=dev)
                                 for v in (cfg.data.mean, cfg.data.std))
        self._rng = torch.Generator(device=dev).manual_seed(seed) if sampling else None
        self._gen_rng = torch.Generator(device=dev).manual_seed(seed + 0x5EED)
        # {(kind, bucket): (graph, its static output)}, one memory pool for all
        self._graphs: Dict[tuple, tuple] = {}
        self._pool = torch.cuda.graph_pool_handle() if dev.type == "cuda" else None
        # buffers, graphs, generators, weights, and a mesh's collectives
        self._lock = threading.Lock()
        self._stopped = False

    @classmethod
    def from_checkpoint(cls, ckpt_dir: str, family: str, stage: int,
                        preset: str = "res64", *, epoch: Optional[int] = None,
                        num_voxels: Optional[int] = None, **kw) -> "ServingModel":
        """Serve a port checkpoint dir (``epoch``, default the latest) or a
        reference-layout ``.pth`` of the family and stage."""
        from fmri_tpu_torch.configs.presets import get_config, override_num_voxels
        from fmri_tpu_torch.eval.inference import load_weights

        cfg = get_config(preset)
        if num_voxels is not None:
            cfg = override_num_voxels(cfg, num_voxels)
        model = eval_module(family, stage)[0](cfg.model)
        model.load_state_dict(load_weights(ckpt_dir, epoch)[0], strict=True)
        return cls(cfg, model, family=family, stage=stage, **kw)

    @classmethod
    def from_pth(cls, path: str, preset: str = "res64", **kw) -> "ServingModel":
        """Serve a reference-layout ``VaeGanCognitive`` ``.pth``
        (:meth:`from_checkpoint` takes a ``.pth`` of any family and stage)."""
        return cls.from_checkpoint(path, "vgan", 3, preset, **kw)

    # -- shapes ------------------------------------------------------------

    def sample_shape(self) -> tuple:
        """Per-request input shape (no batch dim)."""
        if self.data_kind == "pair":
            return (self.cfg.model.num_voxels,)
        s = self.cfg.model.image_size
        return (s, s, 3)

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.max_batch

    @property
    def graphs(self) -> int:
        """CUDA graphs captured so far on this rank (0 on the CPU)."""
        return len(self._graphs)

    # -- programs ----------------------------------------------------------

    def _finish(self, out: torch.Tensor) -> torch.Tensor:
        """Model output in [-1, 1] -> images in [0, 1] (or uint8), on device."""
        out = denormalize(out, self._mean, self._std).clamp(0.0, 1.0)
        if self.output == "uint8":
            out = (out * 255.0 + 0.5).to(torch.uint8)
        return out

    @torch.no_grad()
    def _prologue(self, kind: str, b: int) -> None:
        """What runs eagerly before the (kind, bucket) program: under
        ``voxel_tp``, ``fc1``'s partial product of this rank's voxel columns,
        summed over the model group, into the buffer the program reads."""
        if kind == "reconstruct" and self.voxel_tp:
            from fmri_tpu_torch.parallel.mesh import row_parallel_linear

            enc = self.model.encoder
            self._h[b].copy_(row_parallel_linear(self._inputs[b], enc.fc1[0].weight,
                                                 self.mesh, enc.compute_dtype))

    @torch.no_grad()
    def _program(self, kind: str, b: int) -> torch.Tensor:
        """The (kind, bucket) program over the static buffers."""
        if kind == "generate":
            return self._finish(self.model.generate(self._z[b]))
        eps = self._eps.get(b)
        if self.voxel_tp:
            posterior = self.model.encoder.forward_from_fc1(self._h[b])
            return self._finish(self.model.decode_posterior(*posterior, eps))
        x = self._inputs[b]
        if self.data_kind == "image":
            x = eval_preprocess(x, self._mean, self._std)
        return self._finish(self.model.reconstruct(x, eps))

    def _capture(self, kind: str, b: int) -> tuple:
        """Capture the (kind, bucket) program as a CUDA graph into the pool
        all graphs share, after warm calls on a side stream, with cuDNN's
        deterministic algorithms: a request gives the same bits every time."""
        with torch.cuda.device(self.device), deterministic_cudnn():
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(CAPTURE_WARM_CALLS):
                    self._program(kind, b)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, pool=self._pool):
                    out = self._program(kind, b)
            except Exception as exc:
                raise RuntimeError(f"capturing the {kind} program of bucket {b} "
                                   f"as a CUDA graph failed: {exc}") from exc
        self._graphs[(kind, b)] = graph, out
        return graph, out

    def _call(self, kind: str, b: int) -> torch.Tensor:
        """Run the (kind, bucket) program after its prologue: replay its
        graph on CUDA (captured at first use), eagerly on the CPU. The
        output is overwritten by the next call; the caller holds ``_lock``
        until it has copied it out."""
        self._prologue(kind, b)
        if self.device.type != "cuda":
            return self._program(kind, b)
        graph, out = self._graphs.get((kind, b)) or self._capture(kind, b)
        graph.replay()
        return out

    def _warm(self, generate: bool) -> None:
        for b in self.buckets:
            self._call("reconstruct", b)
            if generate:
                self._call("generate", b)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self, generate: bool = True) -> None:
        """Capture (on the CPU: run) every bucket's reconstruct program and,
        by default, its generate program before traffic arrives, on every
        rank of a mesh. No noise is drawn, so the sampling streams stay
        where the seed put them."""
        with self._lock:
            self._command(WARMUP, int(generate))
            self._warm(generate)

    # -- a mesh's ranks ------------------------------------------------------

    def _command(self, op: Optional[int] = None, a: int = 0, b: int = 0) -> tuple:
        """Rank 0 sends ``(op, a, b)`` to the other ranks of the mesh, which
        call it with no arguments to receive it; without a mesh, nothing."""
        if self.mesh is None:
            return op, a, b
        if self._stopped:
            raise RuntimeError("the serving mesh was stopped")
        t = torch.tensor([-1 if op is None else op, a, b], dtype=torch.int64,
                         device=self.device)
        return tuple(int(v) for v in self.mesh.broadcast(t).tolist())

    def _step(self, kind: str, b: int, n: int) -> torch.Tensor:
        """Every rank's part of one (kind, bucket) call whose whole buffers
        rank 0 has filled: their broadcast, this rank's rows, the program,
        and the images over the data group in data order; the first ``n``
        rows are rank 0's answer."""
        mesh = self.mesh
        if mesh is not None:
            if kind == "generate":
                whole, mine = [self._req_z[b]], [self._z[b]]
            else:
                whole, mine = [self._req[b]], [self._inputs[b]]
                if b in self._req_eps:
                    whole.append(self._req_eps[b])
                    mine.append(self._eps[b])
            for src, dst in zip(whole, mine):
                mesh.broadcast(src)
                if dst is not src:
                    dst.copy_(mesh.rows(src))
        out = self._call(kind, b)
        if mesh is not None and mesh.model_index == 0:  # one copy of each data rank's rows
            out = mesh.gather_data(out)
        return out[:n]

    def follow(self) -> None:
        """The loop of every rank but 0 of a mesh: run rank 0's commands,
        in its order, until its :meth:`stop`. A reload the ranks refused
        together is no error here; any other error ends the loop, and rank
        0 sees it as the failure of its next collective."""
        if self.mesh is None or self.mesh.rank == 0:
            raise RuntimeError("follow() runs on the ranks other than 0 of a serving mesh")
        while True:
            op, a, b = self._command()
            with self._lock:
                if op == STOP:
                    self._stopped = True
                    return
                if op in (RECONSTRUCT, GENERATE):
                    self._step("reconstruct" if op == RECONSTRUCT else "generate", a, b)
                elif op == WARMUP:
                    self._warm(bool(a))
                elif op == RELOAD:
                    try:
                        self._reload_on_ranks(None, None if a < 0 else a)
                    except _Refused:
                        pass  # every rank refused it; rank 0 raises
                else:
                    raise RuntimeError(f"unknown serving command {op}")

    def stop(self) -> None:
        """Rank 0: end the other ranks' :meth:`follow` (once; nothing
        without a mesh). Calls after it raise."""
        if self.mesh is None or self._stopped:
            return
        with self._lock:
            self._command(STOP)
            self._stopped = True

    # -- requests ----------------------------------------------------------

    def _reconstruct_chunk(self, chunk: np.ndarray) -> np.ndarray:
        """One chunk (<= max_batch rows) through its padded bucket."""
        n = len(chunk)
        b = self._bucket_for(n)
        inp = self._req[b]
        inp[:n].copy_(torch.from_numpy(chunk))
        inp[n:].zero_()
        if self._rng is not None:
            self._req_eps[b].normal_(generator=self._rng)
        self._command(RECONSTRUCT, b, n)
        return self._step("reconstruct", b, n).cpu().numpy()

    def reconstruct(self, x) -> np.ndarray:
        """[N, *sample_shape()] request batch (or a single sample) ->
        [N, H, W, 3]."""
        shape = self.sample_shape()
        x = np.asarray(x, np.float32)
        single = x.ndim == len(shape)
        if single:
            x = x[None]
        if x.shape[1:] != shape:
            raise ValueError(f"expected [N, {', '.join(map(str, shape))}] requests, "
                             f"got {x.shape}")
        if len(x) == 0:
            s = self.cfg.model.image_size
            return np.zeros((0, s, s, 3),
                            np.uint8 if self.output == "uint8" else np.float32)
        with self._lock:
            outs = [self._reconstruct_chunk(np.ascontiguousarray(x[lo:lo + self.max_batch]))
                    for lo in range(0, len(x), self.max_batch)]
        out = np.concatenate(outs)
        return out[0] if single else out

    def generate(self, n: int) -> np.ndarray:
        """Decode ``n`` samples z ~ N(0, I) with BatchNorm running statistics,
        in bucket-sized batches."""
        if n < 1:
            raise ValueError("n must be >= 1")
        outs, remaining = [], n
        with self._lock:
            while remaining > 0:
                k = min(remaining, self.max_batch)
                b = self._bucket_for(k)
                self._req_z[b].normal_(generator=self._gen_rng)
                self._command(GENERATE, b, k)
                outs.append(self._step("generate", b, k).cpu().numpy())
                remaining -= k
        return np.concatenate(outs)

    # -- reload ------------------------------------------------------------

    def _check_weights(self, sd: Dict[str, torch.Tensor], ckpt_dir: str) -> None:
        """Refuse a state dict whose keys or shapes are not the served
        model's (whole shapes: a voxel shard counts as the full ``fc1``)."""
        own = {k: tuple(v.shape) for k, v in self.model.state_dict().items()}
        if self.voxel_tp:
            hidden, cols = own[self._shard_key]
            own[self._shard_key] = (hidden, cols * self.mesh.model)
        bad = sorted(set(sd) ^ set(own))
        if bad:
            raise ValueError(
                f"checkpoint {ckpt_dir!r} has other keys than the serving model "
                f"(family/stage mismatch?) at {bad[:3]} (+{max(0, len(bad) - 3)} "
                f"more); reload refused")
        bad = [k for k in own if tuple(sd[k].shape) != own[k]]
        if bad:
            raise ValueError(
                f"checkpoint {ckpt_dir!r} shapes differ from the serving model at "
                f"{bad[:3]} (+{max(0, len(bad) - 3)} more); reload refused")

    @torch.no_grad()
    def _copy_weights(self, sd: Dict[str, torch.Tensor]) -> None:
        """Copy a checked state dict into the served tensors in place (this
        rank's columns of a voxel shard)."""
        for k, t in self.model.state_dict().items():
            src = sd[k]
            if self.voxel_tp and k == self._shard_key:
                lo, hi = self.mesh.model_slice(src.shape[1])
                src = src[:, lo:hi]
            t.copy_(src)

    def _reload_on_ranks(self, ckpt_dir: Optional[str], epoch: Optional[int]) -> Dict:
        """Every rank's part of a reload over a mesh: rank 0's path, each
        rank's read and check, one decision for all ranks, then each rank's
        copy. A checkpoint one rank refuses is refused by all, before any
        copy."""
        from fmri_tpu_torch.eval.inference import load_weights

        ckpt_dir = self.mesh.broadcast_bytes(
            None if ckpt_dir is None else ckpt_dir.encode()).decode()
        sd, source, err = None, {}, None
        try:
            sd, source = load_weights(ckpt_dir, epoch)
            self._check_weights(sd, ckpt_dir)
        except Exception as exc:  # decided below, with the other ranks
            err = exc
        refused = self.mesh.failing(err is not None)
        if refused:
            raise _Refused(err if err is not None else ValueError(
                f"checkpoint {ckpt_dir!r} refused on rank(s) {refused} of the serving "
                f"mesh; reload refused"))
        self._copy_weights(sd)
        return {"reloaded": ckpt_dir, "epoch": source.get("checkpoint_epoch")}

    def reload(self, ckpt_dir: str, epoch: Optional[int] = None) -> Dict:
        """Swap in the weights of a checkpoint without restarting the
        server. A checkpoint whose keys or shapes differ from the served
        model's is refused up front and the served weights stay. The copy
        happens under the compute lock, between batches, in place: the
        module and its tensors are never replaced, so the captured graphs
        stay valid and read the new weights. Over a mesh every rank reads
        the checkpoint and copies its own columns, and a refusal on any
        rank is a refusal on all."""
        from fmri_tpu_torch.eval.inference import load_weights

        if self.mesh is not None:
            with self._lock:
                self._command(RELOAD, -1 if epoch is None else epoch)
                try:
                    return self._reload_on_ranks(ckpt_dir, epoch)
                except _Refused as refused:
                    raise refused.reason from None
        sd, source = load_weights(ckpt_dir, epoch)
        self._check_weights(sd, ckpt_dir)
        with self._lock:
            self._copy_weights(sd)
        return {"reloaded": ckpt_dir, "epoch": source.get("checkpoint_epoch")}


class _Refused(Exception):
    """A reload every rank of a mesh refused; ``reason`` is this rank's
    error, or one naming the ranks that refused it."""

    def __init__(self, reason: Exception):
        super().__init__(str(reason))
        self.reason = reason


class ServerOverloaded(RuntimeError):
    """Raised by :meth:`BatchingServer.submit` when the pending queue is at
    ``max_queue``: explicit load shedding instead of unbounded growth."""


class BatchingServer:
    """Dynamic microbatcher over a :class:`ServingModel`.

    ``submit`` enqueues one sample and returns a ``Future``; a single worker
    thread drains the queue into padded bucket batches (full bucket or
    ``max_wait_ms`` after the first queued request, whichever first) and
    resolves the futures with per-sample images.

    The queue is bounded at ``max_queue`` pending samples (default
    ``8 * max_batch``); past that, :meth:`submit` raises
    :class:`ServerOverloaded`. :meth:`close` drains queued work by default
    before stopping, so no accepted request is dropped on shutdown.
    """

    _LAT_WINDOW = 2048

    def __init__(self, model: ServingModel, *, max_wait_ms: float = 5.0,
                 max_queue: Optional[int] = None):
        self.model = model
        self.max_wait = max(0.0, float(max_wait_ms)) / 1e3
        self.max_queue = int(max_queue if max_queue is not None
                             else 8 * model.max_batch)
        if self.max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        self._q: "queue.Queue" = queue.Queue(maxsize=self.max_queue)
        self._stop = threading.Event()
        self._closing = threading.Event()
        self._slock = threading.Lock()
        self._requests = 0
        self._batches = 0
        self._shed = 0
        self._occupancy_sum = 0.0
        self._lat_ms: List[float] = []
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="fmri-tpu-torch-batcher")
        self._thread.start()

    def submit(self, x) -> Future:
        x = np.asarray(x, np.float32)
        want = self.model.sample_shape()
        if x.shape != want:
            raise ValueError(f"sample shape {x.shape} != expected {want}")
        fut: Future = Future()
        # the closing check and the enqueue are one critical section with
        # close()'s _closing.set(), so no submit can enqueue after close()'s
        # sweep emptied the queue (a Future that would never resolve)
        with self._slock:
            if self._closing.is_set():
                raise RuntimeError("server is shutting down")
            try:
                self._q.put_nowait((x, fut, time.monotonic()))
            except queue.Full:
                self._shed += 1
                raise ServerOverloaded(
                    f"queue depth at max_queue={self.max_queue}; retry with "
                    f"backoff") from None
        return fut

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.monotonic() + self.max_wait
            while len(batch) < self.model.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            xs = np.stack([b[0] for b in batch])
            try:
                ys = self.model.reconstruct(xs)
            except Exception as exc:  # resolve every waiter, keep serving
                for _, fut, _ in batch:
                    if not fut.cancelled():
                        fut.set_exception(exc)
                continue
            done = time.monotonic()
            with self._slock:
                self._requests += len(batch)
                self._batches += 1
                self._occupancy_sum += len(batch) / self.model._bucket_for(len(batch))
                for _, _, t0 in batch:
                    self._lat_ms.append((done - t0) * 1e3)
                del self._lat_ms[:-self._LAT_WINDOW]
            for i, (_, fut, _) in enumerate(batch):
                if not fut.cancelled():
                    fut.set_result(ys[i])

    def stats(self) -> Dict:
        with self._slock:
            lat = np.asarray(self._lat_ms, np.float64)
            out = {
                "requests": self._requests,
                "batches": self._batches,
                "shed": self._shed,
                "queue_depth": self._q.qsize(),
                "max_queue": self.max_queue,
                "occupancy": (self._occupancy_sum / self._batches
                              if self._batches else 0.0),
                "buckets": self.model.buckets,
                "max_wait_ms": self.max_wait * 1e3,
            }
        if len(lat):
            out["latency_ms"] = {
                "p50": float(np.percentile(lat, 50)),
                "p95": float(np.percentile(lat, 95)),
                "p99": float(np.percentile(lat, 99)),
                "mean": float(lat.mean()),
            }
        return out

    def close(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop the worker. With ``drain`` (default), first reject new
        submissions and let the worker finish every queued request (bounded
        by ``timeout``); any request still queued afterwards fails with an
        exception instead of hanging its Future."""
        with self._slock:  # fence against in-flight submit() enqueues
            self._closing.set()
        if drain:
            deadline = time.monotonic() + timeout
            while not self._q.empty() and time.monotonic() < deadline:
                time.sleep(0.01)
        self._stop.set()
        self._thread.join(timeout=5)
        while True:  # fail anything the drain window didn't cover
            try:
                _, fut, _ = self._q.get_nowait()
            except queue.Empty:
                break
            if not fut.cancelled():
                fut.set_exception(RuntimeError("server shut down before "
                                               "this request ran"))


# --------------------------- socket transport ---------------------------


def _encode_image(img) -> Dict:
    if img.dtype == np.uint8:
        u8 = img
    else:
        u8 = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return {"shape": list(u8.shape), "dtype": "uint8",
            "data": base64.b64encode(u8.tobytes()).decode("ascii")}


class _Handler(socketserver.StreamRequestHandler):
    # one generate request may hold the model lock for at most this many
    # max_batch-sized batches, so a single client cannot stall reconstruct
    # traffic (the in-process ServingModel.generate stays uncapped)
    GENERATE_CAP_BATCHES = 8

    def handle(self) -> None:
        batcher: BatchingServer = self.server.batcher  # type: ignore[attr-defined]
        for line in self.rfile:
            line = line.strip()
            if not line:
                continue
            req = None
            try:
                req = json.loads(line)
                if req.get("cmd") == "stats":
                    resp = batcher.stats()
                elif req.get("cmd") == "ping":
                    resp = {"ok": True}
                elif req.get("cmd") == "reload":
                    if not getattr(self.server, "allow_reload", True):
                        raise PermissionError(
                            "reload is disabled on non-loopback TCP binds; "
                            "start the server with --allow-remote-reload to "
                            "accept remote weight swaps")
                    resp = batcher.model.reload(req["ckpt"], epoch=req.get("epoch"))
                elif req.get("cmd") == "generate":
                    n = int(req.get("n", 1))
                    cap = self.GENERATE_CAP_BATCHES * batcher.model.max_batch
                    if n > cap:
                        raise ValueError(
                            f"generate n={n} exceeds the per-request cap "
                            f"{cap}; split into multiple requests")
                    imgs = batcher.model.generate(n)
                    resp = {"id": req.get("id"), **_encode_image(imgs)}
                else:
                    key = "fmri" if batcher.model.data_kind == "pair" else "image"
                    x = np.asarray(req[key], np.float32).reshape(
                        batcher.model.sample_shape())
                    img = batcher.submit(x).result(timeout=60)
                    resp = {"id": req.get("id"), **_encode_image(img)}
            except ServerOverloaded as exc:
                resp = {"id": req.get("id") if isinstance(req, dict) else None,
                        "error": f"ServerOverloaded: {exc}", "shed": True}
            except Exception as exc:
                resp = {"id": req.get("id") if isinstance(req, dict) else None,
                        "error": f"{type(exc).__name__}: {exc}"}
            self.wfile.write((json.dumps(resp) + "\n").encode())
            self.wfile.flush()


class _ThreadingTCP(socketserver.ThreadingMixIn, socketserver.TCPServer):
    allow_reuse_address = True
    daemon_threads = True


if hasattr(socketserver, "UnixStreamServer"):
    class _ThreadingUnix(socketserver.ThreadingMixIn,
                         socketserver.UnixStreamServer):
        daemon_threads = True


def make_socket_server(batcher: BatchingServer, *,
                       unix_path: Optional[str] = None,
                       host: str = "127.0.0.1", port: int = 0,
                       allow_remote_reload: bool = False):
    """Build (not start) the threaded socket server; ``.server_address`` has
    the bound address (useful with port=0).

    ``reload`` is an unauthenticated admin verb, so on a TCP bind beyond
    loopback it is refused unless ``allow_remote_reload``."""
    if unix_path:
        if not hasattr(socketserver, "UnixStreamServer"):
            raise RuntimeError(
                "unix domain sockets are unsupported on this platform; "
                "use --host/--port (TCP) instead")
        if os.path.exists(unix_path):
            os.unlink(unix_path)
        srv = _ThreadingUnix(unix_path, _Handler)
        srv.allow_reload = True  # guarded by the socket file's permissions
    else:
        srv = _ThreadingTCP((host, port), _Handler)
        loopback = host in ("127.0.0.1", "::1", "localhost")
        srv.allow_reload = loopback or allow_remote_reload
    srv.batcher = batcher  # type: ignore[attr-defined]
    return srv


# --------------------------- CLI ---------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--family", choices=["vgan", "wae", "wae-vgan"], default="vgan")
    p.add_argument("--stage", type=int, choices=[1, 2, 3], default=3)
    p.add_argument("--preset", default="res64")
    p.add_argument("--ckpt", required=True,
                   help="a port training run's checkpoint dir, or a reference-layout "
                        ".pth state dict of the family and stage")
    p.add_argument("--load-epoch", type=int, default=None,
                   help="epoch to load from a checkpoint dir (default latest)")
    p.add_argument("--num-voxels", type=int, default=None,
                   help="override the preset's fMRI voxel count (must match "
                        "the checkpoint's CognitiveEncoder)")
    p.add_argument("--max-batch", type=int, default=64)
    p.add_argument("--min-bucket", type=int, default=1,
                   help="smallest batch bucket (fewer graphs at the cost of "
                        "more padding for tiny batches)")
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--max-queue", type=int, default=None,
                   help="pending-request bound before load shedding "
                        "(default 8 x max-batch); past it, requests get an "
                        "immediate 'shed' error instead of queuing unboundedly")
    p.add_argument("--allow-remote-reload", action="store_true",
                   help="accept the (unauthenticated) reload verb on "
                        "non-loopback TCP binds; off by default")
    p.add_argument("--sample", action="store_true",
                   help="reparameterize instead of decoding the mean latent")
    p.add_argument("--output", choices=["uint8", "float"], default="uint8",
                   help="on-device quantization of served images (uint8 = 4x "
                        "smaller device->host transfer; default)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-warmup", action="store_true")
    p.add_argument("--data-parallel", action="store_true",
                   help="split every bucket's rows over all local cards, one rank "
                        "each (--mesh data=<cards>)")
    p.add_argument("--mesh", default=None, metavar="data=N,model=M",
                   help="serve over N x M ranks: rows over N; model>1 splits the "
                        "cognitive encoder's fc1 by voxels over M (voxel tensor "
                        "parallelism, the training stage-2/3 layout)")
    p.add_argument("--unix-socket", default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7717)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def _serve(args, shape=None) -> int:
    """Serve as this process: alone, or as one rank of a ``(data, model)``
    mesh whose process group it joins (rank 0 serves, the others follow)."""
    device = resolve_device(args.device)
    mesh, voxel_tp = None, False
    if shape is not None:
        from fmri_tpu_torch.parallel.mesh import make_mesh

        data, model = shape
        mesh = make_mesh(data, model, ["cpu"] * (data * model) if device.type == "cpu"
                         else None)
        voxel_tp = model > 1
    try:
        served = ServingModel.from_checkpoint(
            args.ckpt, args.family, args.stage, args.preset,
            epoch=args.load_epoch, num_voxels=args.num_voxels,
            max_batch=args.max_batch, min_bucket=args.min_bucket,
            sample=args.sample, seed=args.seed, output=args.output, device=device,
            mesh=mesh, voxel_tp=voxel_tp)
        if mesh is not None and mesh.rank != 0:
            signal.signal(signal.SIGINT, signal.SIG_IGN)  # rank 0 stops the mesh
            served.follow()
            return 0
        return _front_end(args, served, device)
    finally:
        if mesh is not None:
            mesh.close()


def _front_end(args, served: ServingModel, device: torch.device) -> int:
    """Warm up, then answer the socket until shutdown or Ctrl-C; then stop
    the mesh's other ranks."""
    try:
        if not args.no_warmup:
            t0 = time.monotonic()
            served.warmup()
            what = (f"{served.graphs} graphs ({len(served.buckets)} buckets x "
                    f"reconstruct+generate) captured" if device.type == "cuda" else
                    f"{len(served.buckets)} buckets x reconstruct+generate run eagerly")
            print(f"warmup: {what} in {time.monotonic() - t0:.1f}s", flush=True)
        batcher = BatchingServer(served, max_wait_ms=args.max_wait_ms,
                                 max_queue=args.max_queue)
        srv = make_socket_server(batcher, unix_path=args.unix_socket,
                                 host=args.host, port=args.port,
                                 allow_remote_reload=args.allow_remote_reload)
        where = args.unix_socket or "%s:%d" % srv.server_address[:2]
        mesh = served.mesh
        over = "" if mesh is None else f" over a mesh data={mesh.data},model={mesh.model}"
        print(f"serving {args.family} stage {args.stage} ({args.preset}) on "
              f"{where}{over}", flush=True)
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            srv.shutdown()
            batcher.close()
    finally:
        served.stop()
    return 0


def _rank_main(rank: int, argv, world: int, port: int) -> None:
    """One started rank: torchrun's environment, then the CLI."""
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank))
    main(argv)


def _watch(procs) -> None:
    """Rank 0's watch over the ranks it started: one that fails takes the
    server down at once, rather than leaving rank 0 waiting on it."""
    for p in procs:
        p.join()
        if p.exitcode:
            print(f"serve: rank {procs.index(p) + 1} exited with code {p.exitcode}; "
                  f"stopping", file=sys.stderr, flush=True)
            for q in procs:
                q.kill()
            os._exit(1)


def _mesh_main(args, argv) -> int:
    """``--mesh`` / ``--data-parallel``: check the mesh against the model,
    the buckets and the cards, then serve as this process's rank (torchrun,
    or one rank) or start ranks 1.. and serve as rank 0."""
    from fmri_tpu_torch.configs.presets import get_config
    from fmri_tpu_torch.eval.steps import eval_module
    from fmri_tpu_torch.parallel.mesh import free_port, initialize_multihost
    from fmri_tpu_torch.train.run import _parse_mesh

    device = resolve_device(args.device)
    launched = "WORLD_SIZE" in os.environ
    cards = torch.cuda.device_count()  # --data-parallel spans them
    if args.mesh:
        data, model = _parse_mesh(args.mesh)
    elif device.type == "cpu":
        raise SystemExit("--data-parallel spans this machine's cards; on the CPU give "
                         "--mesh data=N[,model=M]")
    else:
        data, model = None, 1
    if data is None:
        if launched:
            world = int(os.environ["WORLD_SIZE"])
        elif device.type == "cuda":
            world = cards
        else:
            raise SystemExit("--mesh with --device cpu needs data=N")
        if world % model:
            raise SystemExit(f"--mesh: {world} ranks not divisible by model={model}")
        data = world // model
    cfg = get_config(args.preset)
    if args.num_voxels is not None:
        from fmri_tpu_torch.configs.presets import override_num_voxels

        cfg = override_num_voxels(cfg, args.num_voxels)
    try:
        check_mesh(eval_module(args.family, args.stage)[1], cfg, args.max_batch, data,
                   model, model > 1)
    except ValueError as exc:
        raise SystemExit(f"--mesh data={data},model={model}: {exc}") from None
    world = data * model
    if launched:
        if int(os.environ["WORLD_SIZE"]) != world:
            raise SystemExit(f"--mesh data={data},model={model}: {world} ranks, but the "
                             f"launcher started WORLD_SIZE={os.environ['WORLD_SIZE']}")
        return _serve(args, (data, model))
    if device.type == "cuda" and cards < world:
        raise SystemExit(f"--mesh data={data},model={model}: {world} ranks need {world} "
                         f"cards, one each; this machine has {cards}")
    port = free_port()
    if world > 1:
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_rank_main, args=(r, list(argv), world, port),
                             daemon=True) for r in range(1, world)]
        for p in procs:
            p.start()
        threading.Thread(target=_watch, args=(procs,), daemon=True).start()
    initialize_multihost(f"localhost:{port}", world, 0,
                         backend="gloo" if device.type == "cpu" else "nccl")
    code = _serve(args, (data, model))
    if world > 1:
        for p in procs:
            p.join()
    return code


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.mesh or args.data_parallel:
        return _mesh_main(args, argv)
    return _serve(args)


if __name__ == "__main__":
    sys.exit(main())
