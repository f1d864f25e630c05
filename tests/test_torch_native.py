"""The port's native loader (``fmri_tpu_torch/native``) against numpy and
against the JAX package's loader (``fmri_tpu.native``) on the same arrays,
bitwise: ``gather``, ``gather_dequant`` and ``prefetch`` over dtypes, ranks,
memory-mapped and in-RAM arrays; the index and ``out=`` checks on both
paths; the numpy path under ``FMRI_TPU_NATIVE=0``; where the library
builds; and the port's ``Batches`` over a memory-mapped packed dir, epoch by
epoch, against the numpy gather and the JAX ``Batches``."""

import os
import threading

import numpy as np
import pytest

from fmri_tpu import native as jax_native
from fmri_tpu.data.packed import save_packed
from fmri_tpu.data.pipeline import Batches as JaxBatches
from fmri_tpu_torch import native
from fmri_tpu_torch.data import pipeline
from fmri_tpu_torch.data.packed import open_packed
from fmri_tpu_torch.native import build

SHAPES = {1: (37,), 2: (37, 5), 3: (37, 4, 3), 4: (37, 2, 3, 5)}
DTYPES = (np.uint8, np.float32, np.int64)


def _array(dtype, ndim, seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return rng.normal(size=SHAPES[ndim]).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, SHAPES[ndim], dtype=dtype, endpoint=True)


def _mapped(arr, tmp_path, name="a"):
    path = str(tmp_path / f"{name}.npy")
    np.save(path, arr)
    return np.load(path, mmap_mode="r")


@pytest.fixture
def numpy_path(monkeypatch):
    """The port's loader with its library off, as without a toolchain."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_err", "off for this test")


def test_the_library_builds_into_the_ports_build_dir():
    assert native.available(), native.why_unavailable()
    assert native.why_unavailable() is None
    path = build.library_path()
    assert os.path.dirname(path) == os.path.join(os.path.dirname(native.__file__), "_build")
    assert os.path.exists(path)
    assert "fmri_tpu_torch" in path and "_cache" not in path


@pytest.mark.parametrize("mapped", [False, True], ids=["ram", "mmap"])
@pytest.mark.parametrize("ndim", [1, 2, 4])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_gather_is_numpy_and_jax_bitwise(tmp_path, dtype, ndim, mapped):
    arr = _array(dtype, ndim)
    if mapped:
        arr = _mapped(arr, tmp_path)
    idx = np.random.default_rng(1).permutation(37)[:23]
    idx[5] = idx[6]  # a repeated row
    got = native.gather(arr, idx)
    assert got.dtype == arr.dtype and got.shape == (23, *arr.shape[1:])
    assert got.flags["C_CONTIGUOUS"] and got.flags["WRITEABLE"]
    assert not isinstance(got, np.memmap)
    np.testing.assert_array_equal(got, np.asarray(arr)[idx])
    np.testing.assert_array_equal(got, jax_native.gather(arr, idx))
    assert got.tobytes() == jax_native.gather(arr, idx).tobytes()


@pytest.mark.parametrize("mapped", [False, True], ids=["ram", "mmap"])
@pytest.mark.parametrize("ndim,scale", [(2, 1.0 / 255.0), (3, 1.0 / 255.0), (4, 0.5)])
def test_gather_dequant_is_numpy_and_jax_bitwise(tmp_path, ndim, scale, mapped):
    arr = _array(np.uint8, ndim, seed=ndim)
    if mapped:
        arr = _mapped(arr, tmp_path)
    idx = np.arange(36, -1, -3)
    got = native.gather_dequant(arr, idx, scale=scale)
    want = np.asarray(arr)[idx].astype(np.float32) * np.float32(scale)
    assert got.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    assert got.tobytes() == jax_native.gather_dequant(arr, idx, scale=scale).tobytes()
    with pytest.raises(TypeError, match="uint8"):
        native.gather_dequant(arr.astype(np.float32), idx)


@pytest.mark.parametrize("mapped", [False, True], ids=["ram", "mmap"])
def test_prefetch_is_issued_like_jax(tmp_path, mapped):
    arr = _array(np.float32, 3)
    if mapped:
        arr = _mapped(arr, tmp_path)
    before = np.array(arr)
    for idx in (np.array([0, 36, 5]), np.array([], np.int64)):
        assert native.prefetch(arr, idx) is True
        assert jax_native.prefetch(arr, idx) is True
    np.testing.assert_array_equal(np.asarray(arr), before)  # a hint, no write
    strided = np.asarray(arr)[:, :, ::2]  # not C-contiguous: no native hint
    assert native.prefetch(strided, np.array([1])) is jax_native.prefetch(strided, [1]) is False
    with pytest.raises(IndexError):
        native.prefetch(arr, np.array([37]))


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_empty_index(request, path):
    if path == "numpy":
        request.getfixturevalue("numpy_path")
    arr = _array(np.float32, 3)
    for fn in (native.gather, jax_native.gather):
        got = fn(arr, np.array([], np.int64))
        assert got.shape == (0, 4, 3) and got.dtype == np.float32
    assert native.gather_dequant(_array(np.uint8, 2), []).shape == (0, 5)


@pytest.mark.parametrize("idx", [[-1], [37], [0, 99]], ids=["negative", "n", "far"])
@pytest.mark.parametrize("path", ["native", "numpy"])
def test_bad_indices_raise_on_both_paths(request, path, idx):
    if path == "numpy":
        request.getfixturevalue("numpy_path")
    arr = _array(np.uint8, 2)
    for fn in (native.gather, native.gather_dequant, jax_native.gather):
        with pytest.raises(IndexError, match="out of range"):
            fn(arr, np.array(idx))
    with pytest.raises(ValueError, match="1-D"):
        native.gather(arr, np.zeros((2, 2), np.int64))


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_out_is_checked_and_written(request, path):
    if path == "numpy":
        request.getfixturevalue("numpy_path")
    arr = _array(np.float32, 3)
    idx = np.array([4, 2, 0])
    out = np.empty((3, 4, 3), np.float32)
    assert native.gather(arr, idx, out=out) is out
    np.testing.assert_array_equal(out, arr[idx])
    outq = np.empty((3, 5), np.float32)
    u8 = _array(np.uint8, 2)
    assert native.gather_dequant(u8, idx, out=outq) is outq
    assert outq.tobytes() == (u8[idx].astype(np.float32) * np.float32(1 / 255)).tobytes()
    with pytest.raises(ValueError, match="shape"):
        native.gather(arr, idx, out=np.empty((2, 4, 3), np.float32))
    with pytest.raises(TypeError, match="dtype"):
        native.gather(arr, idx, out=np.empty((3, 4, 3), np.float64))
    with pytest.raises(ValueError, match="contiguous"):
        native.gather(arr, idx, out=np.empty((3, 3, 4), np.float32).transpose(0, 2, 1))
    frozen = np.empty((3, 4, 3), np.float32)
    frozen.flags.writeable = False
    with pytest.raises(ValueError, match="writeable"):
        native.gather(arr, idx, out=frozen)


def test_arrays_native_code_cannot_address_take_numpy():
    """Object arrays (refcounted pointers) and strided views go through
    numpy on every host, with the same result."""
    objs = np.array([{"a": i} for i in range(6)], dtype=object)
    got = native.gather(objs, np.array([5, 0]))
    assert got[0] is objs[5] and got[1] is objs[0]
    strided = _array(np.int64, 2)[:, ::2]
    np.testing.assert_array_equal(native.gather(strided, [3, 1]), strided[[3, 1]])


def test_disabled_by_the_environment(monkeypatch):
    """``FMRI_TPU_NATIVE=0`` turns the library off; every entry point then
    gives numpy's result and ``prefetch`` reports no hint."""
    monkeypatch.setenv("FMRI_TPU_NATIVE", "0")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_err", None)
    assert not native.available()
    assert "FMRI_TPU_NATIVE=0" in native.why_unavailable()
    arr = _array(np.uint8, 3)
    idx = np.array([3, 3, 0])
    np.testing.assert_array_equal(native.gather(arr, idx), arr[idx])
    assert native.gather_dequant(arr, idx).tobytes() == jax_native.gather_dequant(
        arr, idx).tobytes()
    assert native.prefetch(arr, idx) is False


@pytest.mark.parametrize("threads", ["1", "3"])
def test_thread_count_comes_from_the_shared_variable(monkeypatch, threads):
    monkeypatch.setenv("FMRI_TPU_NATIVE_THREADS", threads)
    assert native._threads_default() == jax_native._threads_default() == int(threads)
    arr = _array(np.float32, 2)
    idx = np.random.default_rng(2).integers(0, 37, 200)
    np.testing.assert_array_equal(native.gather(arr, idx), arr[idx])


def test_concurrent_first_builds_leave_one_whole_library(tmp_path, monkeypatch):
    """Builds racing into an empty build dir each rename a whole file into
    place; no temporary file is left and the library loads."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    paths, errors = [], []

    def one():
        try:
            paths.append(build.build_library(force=True))
        except Exception as e:  # surfaced by the assertion below
            errors.append(e)

    workers = [threading.Thread(target=one) for _ in range(3)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=120)
    assert not any(w.is_alive() for w in workers) and not errors
    assert len(set(paths)) == 1 and os.listdir(tmp_path / "_build") == [
        os.path.basename(paths[0])]
    import ctypes

    assert ctypes.CDLL(paths[0]).ft_abi_version() == 1


@pytest.fixture
def packed_pairs(tmp_path):
    rng = np.random.default_rng(4)
    packed = str(tmp_path / "packed")
    save_packed(packed, {"image": rng.uniform(size=(70, 8, 8, 3)).astype(np.float32),
                         "fmri": rng.normal(size=(70, 33)).astype(np.float32)})
    return packed


@pytest.mark.parametrize("threads", ["1", "4"])
def test_batches_over_a_mapped_dir_are_the_numpy_gather(packed_pairs, monkeypatch, threads):
    """The port's ``Batches`` over memmaps (the native gather and read-ahead)
    equals, epoch by epoch, the same batches through numpy and the JAX
    ``Batches`` on the same dir; the native routines ran."""
    monkeypatch.setenv("FMRI_TPU_NATIVE_THREADS", threads)
    data = {k: v[6:] for k, v in open_packed(packed_pairs).items()}  # views stay memmaps
    assert all(isinstance(v, np.memmap) for v in data.values())
    calls = {"gather": 0, "prefetch": 0}
    for name in calls:
        real = getattr(native, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(native, name, counted)
    ours = pipeline.Batches(data, 16, shuffle=True, seed=3)
    theirs = JaxBatches(data, 16, shuffle=True, seed=3)
    for epoch in range(2):
        got, ref = list(ours), list(theirs)
        assert len(got) == len(ref) == 4
        order = np.random.default_rng((3, epoch)).permutation(64)
        for b, (g, r) in enumerate(zip(got, ref)):
            idx = order[b * 16:(b + 1) * 16]
            for k in ("image", "fmri"):
                want = np.asarray(data[k])[idx]
                assert g[k].tobytes() == want.tobytes() == r[k].tobytes(), (epoch, b, k)
                assert not isinstance(g[k], np.memmap) and g[k].flags["WRITEABLE"]
    assert calls == {"gather": 2 * 4 * 2, "prefetch": 2 * 3 * 2}


def test_in_ram_arrays_on_one_core_take_numpy(monkeypatch):
    monkeypatch.setenv("FMRI_TPU_NATIVE_THREADS", "1")
    monkeypatch.setattr(native, "gather", lambda *a, **k: pytest.fail("native gather"))
    monkeypatch.setattr(native, "prefetch", lambda *a, **k: pytest.fail("native hint"))
    data = _array(np.float32, 2)
    got = list(pipeline.Batches(data, 8, shuffle=True, seed=1))
    order = np.random.default_rng((1, 0)).permutation(37)
    for b, g in enumerate(got):
        np.testing.assert_array_equal(g, data[order[b * 8:(b + 1) * 8]])
