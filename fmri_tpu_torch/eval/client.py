"""Python client for the serving protocol of ``fmri_tpu_torch.eval.serve``.

The server speaks newline-delimited JSON over a Unix or TCP socket; this
client wraps the wire format (base64 uint8 images, per-request ids) behind
a numpy API:

    from fmri_tpu_torch.eval.client import ServeClient

    with ServeClient(host="127.0.0.1", port=7717) as c:
        imgs = c.reconstruct(fmri_batch)     # [N, V] -> [N, H, W, 3] uint8
        prior = c.generate(4)                # [4, H, W, 3] uint8
        c.stats(); c.reload("/ckpts/new")    # observability / hot swap

The port's own copy of ``fmri_tpu/eval/client.py``: the wire format is the
JAX server's too, so either client talks to either server.

Concurrency model: the server dispatches one handler thread per
*connection* and serves a connection's requests strictly in order, so a
single socket can never fill a batch bucket. ``reconstruct`` therefore
fans samples over a small connection pool (``pool`` connections, default
8): concurrent in-flight requests are what the server's dynamic
microbatcher coalesces into full buckets. Stdlib + numpy only; no torch
import (usable from any client process).

Scope: this is the online-serving path (low-latency request/response over
JSON text). For bulk offline reconstruction of a whole dataset, prefer the
in-process batch API (``fmri_tpu_torch.eval.inference`` /
``ServingModel.reconstruct``): it skips the JSON+base64 transport.
"""

from __future__ import annotations

import base64
import json
import socket
import threading
from typing import Dict, List, Optional

import numpy as np


class ServeError(RuntimeError):
    """An {"error": ...} response from the server."""


class _Conn:
    def __init__(self, address, timeout: float):
        if isinstance(address, str):
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        else:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.settimeout(timeout)
        self._sock.connect(address)
        self._r = self._sock.makefile("rb")
        self._w = self._sock.makefile("wb")
        self.lock = threading.Lock()

    def rpc(self, obj: Dict) -> Dict:
        with self.lock:
            self._w.write((json.dumps(obj) + "\n").encode())
            self._w.flush()
            line = self._r.readline()
        if not line:
            raise ConnectionError("server closed the connection")
        resp = json.loads(line)
        if isinstance(resp, dict) and "error" in resp:
            raise ServeError(resp["error"])
        # Reject a stale reply (e.g. the buffered answer to a request whose
        # read timed out earlier): a desynchronized stream must fail loudly,
        # never hand request B the image of request A.
        if "id" in obj and resp.get("id") != obj["id"]:
            raise ConnectionError(
                f"response id {resp.get('id')!r} != request id {obj['id']!r} "
                "(connection desynchronized)")
        return resp

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def _decode_image(resp: Dict) -> np.ndarray:
    data = base64.b64decode(resp["data"])
    # .copy(): frombuffer over bytes is read-only; callers expect a normal
    # writable array (reconstruct's np.stack output already is)
    return np.frombuffer(data, np.uint8).reshape(resp["shape"]).copy()


class ServeClient:
    """Client for one serving endpoint.

    ``unix_path`` selects a Unix domain socket; otherwise ``host:port``
    (TCP).  Connections are created lazily up to ``pool`` and reused.
    Thread-safe: each pooled connection is mutex-guarded, and concurrent
    ``reconstruct`` calls simply share the pool.
    """

    def __init__(self, *, host: str = "127.0.0.1", port: int = 7717,
                 unix_path: Optional[str] = None, pool: int = 8,
                 timeout: float = 120.0):
        self._address = unix_path if unix_path else (host, int(port))
        self._timeout = float(timeout)
        self._pool_size = max(1, int(pool))
        self._conns: Dict[int, _Conn] = {}
        self._plock = threading.Lock()

    # -- pool ---------------------------------------------------------------

    def _conn(self, i: int) -> _Conn:
        key = i % self._pool_size
        with self._plock:
            c = self._conns.get(key)
        if c is not None:
            return c
        # connect OUTSIDE the pool lock: pool establishment must be
        # parallel, not serialized behind each (timeout-bounded) connect
        c = _Conn(self._address, self._timeout)
        with self._plock:
            cur = self._conns.get(key)
            if cur is not None:  # lost a benign create race
                c.close()
                return cur
            self._conns[key] = c
            return c

    def _rpc(self, i: int, obj: Dict) -> Dict:
        """rpc through pooled connection ``i % pool``; a connection that
        raises is evicted (its stream may hold a stale reply)."""
        conn = self._conn(i)
        try:
            return conn.rpc(obj)
        except BaseException:
            with self._plock:
                if self._conns.get(i % self._pool_size) is conn:
                    del self._conns[i % self._pool_size]
            conn.close()
            raise

    def close(self) -> None:
        with self._plock:
            for c in self._conns.values():
                c.close()
            self._conns = {}

    def __enter__(self) -> "ServeClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- commands -----------------------------------------------------------

    def ping(self) -> bool:
        return bool(self._rpc(0, {"cmd": "ping"}).get("ok"))

    def stats(self) -> Dict:
        return self._rpc(0, {"cmd": "stats"})

    def reload(self, ckpt_dir: str, epoch: Optional[int] = None) -> Dict:
        req = {"cmd": "reload", "ckpt": ckpt_dir}
        if epoch is not None:
            req["epoch"] = epoch
        return self._rpc(0, req)

    def generate(self, n: int) -> np.ndarray:
        """Sample ``n`` images from the prior -> [n, H, W, 3] uint8."""
        return _decode_image(self._rpc(0, {"cmd": "generate", "n": int(n)}))

    def reconstruct(self, x, *, key: str = "fmri") -> np.ndarray:
        """One sample ([V] / [H,W,3]) or a batch ([N, ...]) -> uint8 images.

        Batch requests fan out over the connection pool so the server's
        microbatcher can coalesce them into full buckets; results come
        back in input order.  ``key='image'`` targets stage-1 (image ->
        image autoencode) servers.
        """
        x = np.asarray(x, np.float32)
        if x.ndim not in (1, 2, 3, 4):
            raise ValueError(
                f"expected a sample ([V] / [H,W,3]) or a batch ([N, ...]), "
                f"got shape {x.shape}")
        single = x.ndim in (1, 3)
        if single:
            x = x[None]
        if len(x) == 0:
            raise ValueError("empty batch")

        out: List[Optional[np.ndarray]] = [None] * len(x)
        errors: List[BaseException] = []

        def send(i: int, conn_idx: int) -> None:
            resp = self._rpc(conn_idx,
                             {"id": i, key: x[i].reshape(-1).tolist()})
            out[i] = _decode_image(resp)

        n_workers = min(self._pool_size, len(x))
        if n_workers == 1:
            for i in range(len(x)):
                send(i, 0)
        else:
            def worker(w: int) -> None:
                try:
                    for i in range(w, len(x), n_workers):
                        send(i, w)
                except BaseException as e:  # surface the first failure
                    errors.append(e)

            threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                       for w in range(n_workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        if errors:
            raise errors[0]
        imgs = np.stack(out)  # type: ignore[arg-type]
        return imgs[0] if single else imgs
