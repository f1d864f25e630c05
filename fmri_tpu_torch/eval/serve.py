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
Runs on ``cuda`` unless ``--device cpu``. Not in this port yet (slice 10b,
the serving mesh): the JAX module's ``--data-parallel`` and ``--mesh``
serving over several cards.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import queue
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


class ServingModel:
    """A device-resident eval module behind bucketed batches.

    ``model`` is the eval module of ``family`` and ``stage``
    (``eval/steps.py::eval_module``). ``reconstruct`` takes any
    [N, *sample_shape()] request batch (or one sample) and returns
    [N, H, W, 3] images in [0, 1] (float32, or uint8 with
    ``output="uint8"``); ``generate`` decodes prior samples. On CUDA every
    (bucket, reconstruct | generate) program runs as a CUDA graph, captured
    by :meth:`warmup` or at the bucket's first use; ``graphs`` counts them.
    """

    def __init__(self, cfg: Config, model: torch.nn.Module, *,
                 family: str = "vgan", stage: int = 3,
                 max_batch: int = 64, min_bucket: int = 1,
                 sample: bool = False, seed: int = 0, output: str = "float",
                 device: str | torch.device = "cuda"):
        if output not in ("float", "uint8"):
            raise ValueError(f"output must be 'float' or 'uint8', got {output!r}")
        cls, self.data_kind = eval_module(family, stage)
        if not isinstance(model, cls):
            raise TypeError(f"family {family} stage {stage} serves a {cls.__name__}, "
                            f"got a {type(model).__name__}")
        self.cfg, self.output = cfg, output
        self.family, self.stage = family, stage
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.max_batch = int(max_batch)
        self.buckets = batch_buckets(self.max_batch, min_bucket)
        # the static buffers every program reads: the padded input, the
        # reparameterization noise (sampling models only) and the prior draws
        latent, dev = cfg.model.latent_dim, self.device
        self._inputs = {b: torch.zeros((b, *self.sample_shape()), device=dev)
                        for b in self.buckets}
        sampling = sample and model.samples
        self._eps = ({b: torch.zeros((b, latent), device=dev) for b in self.buckets}
                     if sampling else {})
        self._z = {b: torch.zeros((b, latent), device=dev) for b in self.buckets}
        # the normalization constants on the device: a host-to-device copy
        # cannot be captured
        self._mean, self._std = (torch.tensor(v, device=dev)
                                 for v in (cfg.data.mean, cfg.data.std))
        self._rng = torch.Generator(device=dev).manual_seed(seed) if sampling else None
        self._gen_rng = torch.Generator(device=dev).manual_seed(seed + 0x5EED)
        # {(kind, bucket): (graph, its static output)}, one memory pool for all
        self._graphs: Dict[tuple, tuple] = {}
        self._pool = torch.cuda.graph_pool_handle() if dev.type == "cuda" else None
        self._lock = threading.Lock()   # buffers, graphs, generators, weights

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
        """CUDA graphs captured so far (0 on the CPU)."""
        return len(self._graphs)

    # -- programs ----------------------------------------------------------

    def _finish(self, out: torch.Tensor) -> torch.Tensor:
        """Model output in [-1, 1] -> images in [0, 1] (or uint8), on device."""
        out = denormalize(out, self._mean, self._std).clamp(0.0, 1.0)
        if self.output == "uint8":
            out = (out * 255.0 + 0.5).to(torch.uint8)
        return out

    def _program(self, kind: str, b: int) -> torch.Tensor:
        """The (kind, bucket) program over the static buffers."""
        if kind == "generate":
            return self._finish(self.model.generate(self._z[b]))
        x = self._inputs[b]
        if self.data_kind == "image":
            x = eval_preprocess(x, self._mean, self._std)
        return self._finish(self.model.reconstruct(x, self._eps.get(b)))

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
        """Run the (kind, bucket) program: replay its graph on CUDA (captured
        at first use), eagerly on the CPU. The output is overwritten by the
        next call; the caller holds ``_lock`` until it has copied it out."""
        if self.device.type != "cuda":
            return self._program(kind, b)
        graph, out = self._graphs.get((kind, b)) or self._capture(kind, b)
        graph.replay()
        return out

    def warmup(self, generate: bool = True) -> None:
        """Capture (on the CPU: run) every bucket's reconstruct program and,
        by default, its generate program before traffic arrives. No noise is
        drawn, so the sampling streams stay where the seed put them."""
        with self._lock:
            for b in self.buckets:
                self._call("reconstruct", b)
                if generate:
                    self._call("generate", b)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    # -- requests ----------------------------------------------------------

    def _reconstruct_chunk(self, chunk: np.ndarray) -> np.ndarray:
        """One chunk (<= max_batch rows) through its padded bucket."""
        n = len(chunk)
        b = self._bucket_for(n)
        inp = self._inputs[b]
        inp[:n].copy_(torch.from_numpy(chunk))
        inp[n:].zero_()
        if self._rng is not None:
            self._eps[b].normal_(generator=self._rng)
        return self._call("reconstruct", b)[:n].cpu().numpy()

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
                self._z[b].normal_(generator=self._gen_rng)
                outs.append(self._call("generate", b)[:k].cpu().numpy())
                remaining -= k
        return np.concatenate(outs)

    def reload(self, ckpt_dir: str, epoch: Optional[int] = None) -> Dict:
        """Swap in the weights of a checkpoint without restarting the
        server. A checkpoint whose keys or shapes differ from the served
        model's is refused up front and the served weights stay. The copy
        happens under the compute lock, between batches, in place: the
        module and its tensors are never replaced, so the captured graphs
        stay valid and read the new weights."""
        from fmri_tpu_torch.eval.inference import load_weights

        sd, source = load_weights(ckpt_dir, epoch)
        own = self.model.state_dict()
        bad = sorted(set(sd) ^ set(own))
        if bad:
            raise ValueError(
                f"checkpoint {ckpt_dir!r} has other keys than the serving model "
                f"(family/stage mismatch?) at {bad[:3]} (+{max(0, len(bad) - 3)} "
                f"more); reload refused")
        bad = [k for k in own if tuple(sd[k].shape) != tuple(own[k].shape)]
        if bad:
            raise ValueError(
                f"checkpoint {ckpt_dir!r} shapes differ from the serving model at "
                f"{bad[:3]} (+{max(0, len(bad) - 3)} more); reload refused")
        with self._lock:
            self.model.load_state_dict(sd, strict=True)
        return {"reloaded": ckpt_dir, "epoch": source.get("checkpoint_epoch")}


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
                   help="serve over every local card (not in the port yet)")
    p.add_argument("--mesh", default=None, metavar="data=N,model=M",
                   help="explicit serving mesh (not in the port yet)")
    p.add_argument("--unix-socket", default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7717)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.mesh or args.data_parallel:
        raise SystemExit("--mesh / --data-parallel: serving over several cards is "
                         "not in the port yet (slice 10b, the serving mesh)")
    device = resolve_device(args.device)
    model = ServingModel.from_checkpoint(
        args.ckpt, args.family, args.stage, args.preset,
        epoch=args.load_epoch, num_voxels=args.num_voxels,
        max_batch=args.max_batch, min_bucket=args.min_bucket,
        sample=args.sample, seed=args.seed, output=args.output, device=device)
    if not args.no_warmup:
        t0 = time.monotonic()
        model.warmup()
        what = (f"{model.graphs} graphs ({len(model.buckets)} buckets x "
                f"reconstruct+generate) captured" if device.type == "cuda" else
                f"{len(model.buckets)} buckets x reconstruct+generate run eagerly")
        print(f"warmup: {what} in {time.monotonic() - t0:.1f}s", flush=True)
    batcher = BatchingServer(model, max_wait_ms=args.max_wait_ms,
                             max_queue=args.max_queue)
    srv = make_socket_server(batcher, unix_path=args.unix_socket,
                             host=args.host, port=args.port,
                             allow_remote_reload=args.allow_remote_reload)
    where = args.unix_socket or "%s:%d" % srv.server_address[:2]
    print(f"serving {args.family} stage {args.stage} ({args.preset}) on "
          f"{where}", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.shutdown()
        batcher.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
