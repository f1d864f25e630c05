"""The port's serving around the model: ``from_checkpoint`` and ``reload``
on port checkpoint dirs, the ``BatchingServer`` (futures, stats,
backpressure, drain), the NDJSON socket protocol, the port's and the JAX
package's clients against the port's server, and the CLI. Port code only,
on the CPU at ``tiny``, apart from the JAX client and ``BatchingServer``
the wire format and the stats keys are held against (neither compiles
anything).

Overload is tested deterministically: a stand-in model holds the worker,
so the queue fills at once whatever the host's load. Tolerances: served
uint8 images against the in-process float path 1 LSB (a value at a
rounding boundary may round either way); a row batched by the microbatcher
against the row alone 1e-5 (another batch shape may take another
convolution algorithm); the same requests through the same weights at the
same batch shape bitwise.
"""

import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from fmri_tpu_torch.checkpoints import store
from fmri_tpu_torch.configs import get_config
from fmri_tpu_torch.configs.presets import override_num_voxels
from fmri_tpu_torch.eval import serve
from fmri_tpu_torch.eval.client import ServeClient, ServeError
from fmri_tpu_torch.eval.serve import (
    BatchingServer, ServerOverloaded, ServingModel, make_socket_server,
)
from fmri_tpu_torch.train.stages import BUILDERS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Port checkpoint dirs at ``tiny``: stage I (epoch 0); stage II from it
    with epoch 0 and epoch 1, whose decoder is shifted by 0.1 so that its
    images differ; and a stage II with 8 more voxels."""
    cfg = get_config("tiny")
    root = tmp_path_factory.mktemp("serve_ckpts")
    d1, d2, dv = (str(root / n) for n in ("stage1", "stage2", "voxels"))
    state1 = BUILDERS["vgan_stage1"](cfg, steps_per_epoch=1, device="cpu")[0]
    store.save_checkpoint(d1, 0, state1)
    state2 = BUILDERS["vgan_stage2"](cfg, d1, steps_per_epoch=1, device="cpu")[0]
    store.save_checkpoint(d2, 0, state2)
    with torch.no_grad():
        for p in state2.nets.module("decoder").parameters():
            p.add_(0.1)
    store.save_checkpoint(d2, 1, state2)
    cfg_v = override_num_voxels(cfg, cfg.model.num_voxels + 8)
    store.save_checkpoint(dv, 0, BUILDERS["vgan_stage2"](
        cfg_v, d1, steps_per_epoch=1, device="cpu")[0])
    return d1, d2, dv


def _model(d2, epoch=0, **kw):
    kw.setdefault("max_batch", 4)
    return ServingModel.from_checkpoint(d2, "vgan", 2, "tiny", epoch=epoch,
                                        device="cpu", **kw)


@pytest.fixture(scope="module")
def model(ckpts):
    return _model(ckpts[1], max_batch=8)     # the default max_queue: 64


def _fmri(model, n, seed):
    return np.random.default_rng(seed).normal(
        size=(n, *model.sample_shape())).astype(np.float32)


def _u8(img):
    return np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)


# --------------------------------------------------------- checkpoints, reload


def test_from_checkpoint_and_load_epoch(ckpts):
    from fmri_tpu_torch.eval.steps import VaeGanCognitive

    _, d2, _ = ckpts
    m0, latest = _model(d2, 0), _model(d2, None)
    assert (m0.family, m0.stage, m0.data_kind) == ("vgan", 2, "pair")
    groups, _ = store.load_eval_state(d2, epoch=0)
    ref = VaeGanCognitive(m0.cfg.model)
    ref.load_state_dict({f"{g}.{k}": v for g in ("encoder", "decoder")
                         for k, v in groups[g].items()}, strict=True)
    x = _fmri(m0, 4, seed=1)                # bucket 4: no pad row
    want = ref.reconstruct(torch.from_numpy(x))
    want = torch.clamp(want * 0.5 + 0.5, 0, 1).numpy()
    np.testing.assert_array_equal(m0.reconstruct(x), want)
    assert np.abs(latest.reconstruct(x) - want).max() > 1e-3   # epoch 1
    np.testing.assert_array_equal(latest.reconstruct(x), _model(d2, 1).reconstruct(x))


def test_reload_moves_outputs_in_place(ckpts):
    """After reload the server answers with the new weights, equal to a
    fresh server's, and every parameter and buffer is the tensor it was
    (the captured graphs on the card read them by address)."""
    _, d2, _ = ckpts
    m = _model(d2, 0)
    x = _fmri(m, 2, seed=2)
    before = m.reconstruct(x)
    ptrs = {k: v.data_ptr() for k, v in m.model.state_dict().items()}
    assert m.reload(d2, epoch=1) == {"reloaded": d2, "epoch": 1}
    after = m.reconstruct(x)
    assert np.abs(after - before).max() > 1e-3
    np.testing.assert_array_equal(after, _model(d2, 1).reconstruct(x))
    assert {k: v.data_ptr() for k, v in m.model.state_dict().items()} == ptrs
    assert m.reload(d2)["epoch"] == 1                            # latest


def test_reload_refuses_a_mismatched_checkpoint(ckpts):
    d1, d2, dv = ckpts
    m = _model(d2, 0)
    x = _fmri(m, 2, seed=3)
    before = m.reconstruct(x)
    with pytest.raises(ValueError, match="other keys.*reload refused"):
        m.reload(d1)             # a stage-I dir: a visual encoder
    with pytest.raises(ValueError, match="shapes differ.*fc1.*reload refused"):
        m.reload(dv)             # 8 more voxels: fc1's shape
    np.testing.assert_array_equal(m.reconstruct(x), before)


# ------------------------------------------------------------ BatchingServer


def test_batching_server_futures_and_stats(model):
    srv = BatchingServer(model, max_wait_ms=20.0)
    try:
        xs = _fmri(model, 6, seed=4)
        futs = [srv.submit(xs[i]) for i in range(6)]
        outs = np.stack([f.result(timeout=60) for f in futs])
        np.testing.assert_allclose(outs, model.reconstruct(xs), atol=1e-5)
        st = srv.stats()
        assert st["requests"] == 6 and st["batches"] >= 1
        assert 0 < st["occupancy"] <= 1.0
        assert st["latency_ms"]["p50"] > 0
        assert srv._thread.name == "fmri-tpu-torch-batcher"
    finally:
        srv.close()


def test_batching_server_concurrent_stress(model):
    """16 client threads at once, the interpreter switching threads every
    microsecond: every future resolves to its own row's image, and the
    stats count every request once."""
    xs = _fmri(model, 48, seed=5)
    want = np.stack([model.reconstruct(x) for x in xs])
    srv = BatchingServer(model, max_wait_ms=3.0)
    results, errors = [None] * len(xs), []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def client(lo, hi):
        try:
            futs = [(i, srv.submit(xs[i])) for i in range(lo, hi)]
            for i, f in futs:
                results[i] = f.result(timeout=60)
        except Exception as e:  # pragma: no cover - failure reporting
            errors.append(e)

    try:
        threads = [threading.Thread(target=client, args=(lo, lo + 3))
                   for lo in range(0, 48, 3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors and not any(t.is_alive() for t in threads)
        np.testing.assert_allclose(np.stack(results), want, atol=1e-5)
        assert srv.stats()["requests"] == 48
    finally:
        sys.setswitchinterval(interval)
        srv.close()


def test_batching_server_rejects_bad_shape(model):
    srv = BatchingServer(model)
    try:
        with pytest.raises(ValueError):
            srv.submit(np.zeros(7, np.float32))
    finally:
        srv.close()


class _GatedModel:
    """A stand-in for ``ServingModel`` whose reconstruct blocks until
    released, so the queue depth is set exactly, whatever the host's load."""

    max_batch = 4
    buckets = [4]
    data_kind = "pair"

    def __init__(self):
        self.entered = threading.Event()
        self.release = threading.Event()

    def sample_shape(self):
        return (3,)

    def _bucket_for(self, n):
        return self.max_batch

    def reconstruct(self, xs):
        self.entered.set()
        assert self.release.wait(timeout=60)
        return np.zeros((len(xs), 2, 2, 3), np.float32)


def test_backpressure_sheds_load():
    """Exactly ``max_queue`` requests are accepted while the worker is held;
    every further submit raises ServerOverloaded; all accepted ones resolve
    after release."""
    m = _GatedModel()
    srv = BatchingServer(m, max_wait_ms=0.0, max_queue=3)
    try:
        first = srv.submit(np.zeros(3, np.float32))
        assert m.entered.wait(timeout=10)        # the worker is held
        queued = [srv.submit(np.zeros(3, np.float32)) for _ in range(3)]
        for _ in range(2):
            with pytest.raises(ServerOverloaded):
                srv.submit(np.zeros(3, np.float32))
        st = srv.stats()
        assert (st["shed"], st["queue_depth"], st["max_queue"]) == (2, 3, 3)
        m.release.set()
        for f in [first, *queued]:
            assert f.result(timeout=30).shape == (2, 2, 3)
        assert srv.stats()["shed"] == 2 and srv.stats()["requests"] == 4
    finally:
        m.release.set()
        srv.close()


def test_stats_keys_equal_the_jax_servers():
    from fmri_tpu.eval.serve import BatchingServer as JaxBatchingServer

    stats = []
    for cls in (BatchingServer, JaxBatchingServer):
        m = _GatedModel()
        m.release.set()
        srv = cls(m, max_wait_ms=0.0, max_queue=8)
        try:
            empty = set(srv.stats())
            srv.submit(np.zeros(3, np.float32)).result(timeout=30)
            full = srv.stats()
            stats.append((empty, set(full), set(full["latency_ms"])))
        finally:
            srv.close()
    assert stats[0] == stats[1]


def test_close_drains_accepted_requests():
    m = _GatedModel()
    m.release.set()
    srv = BatchingServer(m, max_wait_ms=0.0, max_queue=64)
    futs = [srv.submit(np.zeros(3, np.float32)) for _ in range(16)]
    srv.close()
    for f in futs:
        assert f.result(timeout=1).shape == (2, 2, 3)
    with pytest.raises(RuntimeError, match="shutting down"):
        srv.submit(np.zeros(3, np.float32))


def test_close_without_drain_fails_pending_fast():
    m = _GatedModel()
    srv = BatchingServer(m, max_wait_ms=0.0, max_queue=64)
    first = srv.submit(np.zeros(3, np.float32))
    assert m.entered.wait(timeout=10)
    pending = [srv.submit(np.zeros(3, np.float32)) for _ in range(5)]
    m.release.set()
    srv.close(drain=False)
    for f in [first, *pending]:
        try:
            f.result(timeout=10)
        except RuntimeError as e:
            assert "shut down" in str(e)


# ------------------------------------------------------------ socket transport


class _Served:
    """A batcher and its socket server on a Unix socket, serving on a
    thread."""

    def __init__(self, model, path, **kw):
        self.batcher = BatchingServer(model, **kw)
        self.srv = make_socket_server(self.batcher, unix_path=path)
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.srv.shutdown()
        self.srv.server_close()
        self.batcher.close()


def _lines(path):
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.connect(path)
    r, w = c.makefile("rb"), c.makefile("wb")

    def request(obj):
        import json

        w.write(obj if isinstance(obj, bytes) else (json.dumps(obj) + "\n").encode())
        w.flush()
        return json.loads(r.readline())

    return c, request


def test_socket_protocol(model, tmp_path):
    import base64

    path = str(tmp_path / "serve.sock")
    with _Served(model, path, max_wait_ms=2.0):
        c, request = _lines(path)
        assert request({"cmd": "ping"}) == {"ok": True}
        v = _fmri(model, 1, seed=6)[0]
        resp = request({"id": 42, "fmri": v.tolist()})
        assert resp["id"] == 42 and resp["dtype"] == "uint8"
        img = np.frombuffer(base64.b64decode(resp["data"]), np.uint8).reshape(resp["shape"])
        np.testing.assert_array_equal(img, _u8(model.reconstruct(v)))
        bad = request(b'{"bad json\n')
        assert bad["id"] is None and bad["error"].startswith("JSONDecodeError")
        assert request({"cmd": "ping"}) == {"ok": True}       # still usable
        wrong = request({"id": 3, "fmri": [0.0] * 7})
        assert wrong["id"] == 3 and wrong["error"].startswith("ValueError")
        assert request({"cmd": "stats"})["requests"] == 1
        gen = request({"cmd": "generate", "n": 2})
        assert gen["shape"] == [2, 16, 16, 3] and gen["dtype"] == "uint8"
        cap = request({"cmd": "generate", "n": 8 * model.max_batch + 1})
        assert "cap" in cap["error"] and "shed" not in cap
        c.close()


def test_image_kind_socket(ckpts, tmp_path):
    m = ServingModel.from_checkpoint(ckpts[0], "vgan", 1, "tiny", max_batch=4,
                                     output="uint8", device="cpu")
    x = np.random.default_rng(7).uniform(size=(2, 16, 16, 3)).astype(np.float32)
    path = str(tmp_path / "image.sock")
    with _Served(m, path, max_wait_ms=2.0), ServeClient(unix_path=path, pool=2) as c:
        np.testing.assert_array_equal(c.reconstruct(x, key="image"), m.reconstruct(x))
        with pytest.raises(ServeError, match="KeyError"):
            c.reconstruct(x[0])                                # key "fmri"


def test_socket_sheds_past_max_queue(tmp_path):
    """8 clients x 4 requests against a held worker and max_queue 3: exactly
    3 clients' first requests queue; the other 5 clients are shed on all 4
    (20 ``"shed": true`` replies); after release the 3 finish all theirs."""
    m = _GatedModel()
    path = str(tmp_path / "shed.sock")
    replies, bad = {"ok": 0, "shed": 0}, []
    lock = threading.Lock()

    def client(k):
        c, request = _lines(path)
        for i in range(4):
            resp = request({"id": 100 * k + i, "fmri": [0.0, 0.0, 0.0]})
            with lock:
                if resp.get("shed") and resp["error"].startswith("ServerOverloaded"):
                    replies["shed"] += 1
                elif resp.get("shape") == [2, 2, 3] and resp["id"] == 100 * k + i:
                    replies["ok"] += 1
                else:  # pragma: no cover - failure detail
                    bad.append(resp)
        c.close()

    with _Served(m, path, max_wait_ms=0.0, max_queue=3) as served:
        first = served.batcher.submit(np.zeros(3, np.float32))
        assert m.entered.wait(timeout=10)
        threads = [threading.Thread(target=client, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 60
        while served.batcher.stats()["shed"] < 20 and time.monotonic() < deadline:
            time.sleep(0.01)
        st = served.batcher.stats()
        assert (st["shed"], st["queue_depth"]) == (20, 3)
        m.release.set()
        for t in threads:
            t.join(timeout=60)
        first.result(timeout=10)
        assert not bad, bad[:2]
        assert replies == {"ok": 12, "shed": 20}
        st = served.batcher.stats()
        assert st["shed"] == 20 and st["requests"] == 13 and st["queue_depth"] <= 3


def test_remote_reload_guard(model):
    batcher = BatchingServer(model, max_wait_ms=1.0)
    try:
        srv = make_socket_server(batcher, host="127.0.0.1", port=0)
        assert srv.allow_reload
        srv.server_close()
        srv = make_socket_server(batcher, host="0.0.0.0", port=0)
        assert not srv.allow_reload
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            with ServeClient(port=srv.server_address[1], pool=1) as c:
                with pytest.raises(ServeError, match="PermissionError"):
                    c.reload("/nope")
        finally:
            srv.shutdown()
            srv.server_close()
        srv = make_socket_server(batcher, host="0.0.0.0", port=0,
                                 allow_remote_reload=True)
        assert srv.allow_reload
        srv.server_close()
    finally:
        batcher.close()


def test_port_client(ckpts, tmp_path):
    """The port's ServeClient: fan-out in order, single sample, generate,
    stats, reload over the wire, and an error reply raised."""
    _, d2, _ = ckpts
    m = _model(d2, 0)
    x = _fmri(m, 5, seed=8)
    want = _u8(m.reconstruct(x))
    path = str(tmp_path / "client.sock")
    with _Served(m, path, max_wait_ms=2.0), ServeClient(unix_path=path, pool=4) as c:
        assert c.ping()
        got = c.reconstruct(x)
        assert got.dtype == np.uint8
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        assert np.abs(c.reconstruct(x[2]).astype(int) - want[2].astype(int)).max() <= 1
        assert c.generate(3).shape == (3, 16, 16, 3)
        assert c.stats()["requests"] == 6
        assert c.reload(d2, epoch=1) == {"reloaded": d2, "epoch": 1}
        moved = c.reconstruct(x)
        assert np.abs(moved.astype(int) - got.astype(int)).max() > 1
        with pytest.raises(ServeError, match="ValueError"):
            c.reconstruct(np.zeros(7, np.float32))


def test_jax_client_against_the_port_server(model, tmp_path):
    """The JAX package's client speaks to the port's server: the wire
    format is the same."""
    from fmri_tpu.eval.client import ServeClient as JaxClient
    from fmri_tpu.eval.client import ServeError as JaxError

    x = _fmri(model, 3, seed=9)
    path = str(tmp_path / "jax.sock")
    with _Served(model, path, max_wait_ms=2.0), JaxClient(unix_path=path, pool=2) as c:
        assert c.ping()
        got = c.reconstruct(x)
        want = _u8(model.reconstruct(x))
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        assert c.generate(2).shape == (2, 16, 16, 3)
        st = c.stats()
        assert st["requests"] == 3 and st["buckets"] == model.buckets
        with pytest.raises(JaxError, match="ValueError"):
            c.reconstruct(np.zeros(7, np.float32))


# ------------------------------------------------------------------------ CLI


def test_cli_serves_on_the_cpu(ckpts, tmp_path):
    """``python -m fmri_tpu_torch.eval.serve --device cpu``: a request equals
    the in-process image; Ctrl-C drains and exits 0."""
    _, d2, _ = ckpts
    path = str(tmp_path / "cli.sock")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "fmri_tpu_torch.eval.serve", "--family", "vgan",
         "--stage", "2", "--preset", "tiny", "--ckpt", d2, "--load-epoch", "0",
         "--max-batch", "4", "--unix-socket", path, "--device", "cpu", "--no-warmup"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
    try:
        line = proc.stdout.readline()
        assert line.startswith(f"serving vgan stage 2 (tiny) on {path}"), \
            line + proc.stdout.read()
        m = _model(d2, 0)
        x = _fmri(m, 2, seed=10)
        with ServeClient(unix_path=path, pool=2) as c:
            got = c.reconstruct(x)
        want = _u8(m.reconstruct(x))
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_cli_refuses(ckpts):
    """A mesh that cannot serve exits with the reason before any rank
    starts; ``--data-parallel`` spans cards and names ``--mesh`` on the CPU;
    the default device is the card."""
    d1, d2, _ = ckpts
    args = ["--stage", "2", "--preset", "tiny", "--ckpt", d2, "--unix-socket", "unused"]
    for flag, match in ((["--mesh", "data=3"], "max_batch=64 not divisible"),
                        (["--mesh", "data=1,model=3"], "num_voxels=128 not divisible"),
                        (["--mesh", "data=2,model=2", "--stage", "1", "--ckpt", d1],
                         "voxel_tp serves cognitive"),
                        (["--data-parallel"], "on the CPU give --mesh")):
        with pytest.raises(SystemExit, match=match):
            serve.main(args + flag + ["--device", "cpu"])
    if torch.cuda.is_available():
        pytest.skip("a card is present: without --device the CLI would serve on it")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        serve.main(args)      # the default device is the card
