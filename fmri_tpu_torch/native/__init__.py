"""Native (C++) host-side loader routines, with a numpy fallback.

Counterpart of ``fmri_tpu/native/__init__.py``, over the port's own copy of
``loader.cc``: shuffled row gather, fused uint8 -> float32 dequantization
and ``madvise(WILLNEED)`` read-ahead for the packed/mmap store, loaded
through ctypes, which releases the GIL for each call (the input pipeline's
producer thread gathers concurrently with Python).

The library is compiled on first use with the system ``g++`` into
``_build/`` (``build.py``). Without a toolchain, or with
``FMRI_TPU_NATIVE=0``, every entry point takes numpy instead and gives the
same result. ``FMRI_TPU_NATIVE`` and ``FMRI_TPU_NATIVE_THREADS`` are the JAX
package's variables: one setting covers both packages.

``available()``             -> the native library loaded?
``why_unavailable()``       -> why not (None when it did).
``gather(arr, idx)``        -> ``arr[idx]`` over axis 0, for 1-D int ``idx``.
``gather_dequant(u8, idx)`` -> float32 ``u8[idx] * scale`` in one pass.
``prefetch(arr, idx)``      -> read-ahead hint for the rows' pages; True if
                               issued natively.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

_lib = None
_lib_err: Optional[str] = None
_lock = threading.Lock()
_ABI = 1


def _threads_default() -> int:
    if "FMRI_TPU_NATIVE_THREADS" in os.environ:
        return max(1, int(os.environ["FMRI_TPU_NATIVE_THREADS"]))
    return max(1, min(8, os.cpu_count() or 1))


def _load():
    """Build (if needed) and dlopen the loader library, once per process."""
    global _lib, _lib_err
    if _lib is not None or _lib_err is not None:
        return _lib
    with _lock:
        if _lib is not None or _lib_err is not None:
            return _lib
        if os.environ.get("FMRI_TPU_NATIVE", "1") in ("0", "false", "no"):
            _lib_err = "disabled via FMRI_TPU_NATIVE=0"
            return None
        try:
            from fmri_tpu_torch.native.build import build_library

            lib = ctypes.CDLL(build_library())
            lib.ft_abi_version.restype = ctypes.c_int64
            lib.ft_abi_version.argtypes = []
            if lib.ft_abi_version() != _ABI:
                raise RuntimeError(f"loader ABI {lib.ft_abi_version()} != expected {_ABI}")
            lib.ft_gather_rows.restype = None
            lib.ft_gather_rows.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int]
            lib.ft_gather_u8_f32.restype = None
            lib.ft_gather_u8_f32.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_float, ctypes.c_int]
            lib.ft_prefetch_rows.restype = None
            lib.ft_prefetch_rows.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
            _lib = lib
        except (OSError, RuntimeError) as e:  # no toolchain, failed build -> numpy
            _lib_err = f"{type(e).__name__}: {e}"
        return _lib


def available() -> bool:
    return _load() is not None


def why_unavailable() -> Optional[str]:
    """Why the native path is off (None when it is on)."""
    _load()
    return _lib_err


def _rows_ok(arr: np.ndarray) -> bool:
    """The native routines address rows as base + i * row_bytes: the array
    must be C-contiguous (the packed store's memmaps are) and hold no Python
    objects, whose pointers a memcpy would copy without their refcounts."""
    return (arr.flags["C_CONTIGUOUS"] and arr.ndim >= 1 and arr.size > 0
            and not arr.dtype.hasobject)


def _check_out(out: np.ndarray, shape: tuple, dtype) -> np.ndarray:
    """The native routines write raw bytes through ``out``'s base pointer, so
    a wrong shape, dtype or layout would corrupt the heap: check what the
    numpy path's assignment would enforce, and the layout."""
    if out.shape != shape:
        raise ValueError(f"out shape {out.shape} != expected {shape}")
    if out.dtype != dtype:
        raise TypeError(f"out dtype {out.dtype} != expected {np.dtype(dtype)}")
    if not out.flags["C_CONTIGUOUS"] or not out.flags["WRITEABLE"]:
        raise ValueError("out must be C-contiguous and writeable")
    return out


def _idx64(idx: np.ndarray, n_rows: int) -> np.ndarray:
    """Indices as contiguous int64, bound-checked before either path runs:
    negative indices raise on both (numpy's wraparound on the fallback
    would make one call differ between hosts)."""
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    if idx.ndim != 1:
        raise ValueError(f"idx must be 1-D, got shape {idx.shape}")
    if idx.size and (idx.min() < 0 or idx.max() >= n_rows):
        raise IndexError(f"gather index out of range [0, {n_rows}) (negative indices "
                         f"are rejected on every path)")
    return idx


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def _row_elems(arr: np.ndarray) -> int:
    return int(np.prod(arr.shape[1:], dtype=np.int64))


def gather(arr: np.ndarray, idx: np.ndarray, *, out: Optional[np.ndarray] = None,
           threads: Optional[int] = None) -> np.ndarray:
    """``arr[idx]`` over axis 0 (any dtype) into a new array (or ``out``),
    natively where the library is loaded and ``arr`` qualifies."""
    lib = _load()
    idx = _idx64(idx, arr.shape[0])
    if lib is None or not _rows_ok(arr):
        res = arr[idx]
        if out is None:
            return res
        _check_out(out, res.shape, res.dtype)
        out[...] = res
        return out
    if out is None:
        out = np.empty((idx.size, *arr.shape[1:]), dtype=arr.dtype)
    else:
        _check_out(out, (idx.size, *arr.shape[1:]), arr.dtype)
    lib.ft_gather_rows(_ptr(arr), arr.dtype.itemsize * _row_elems(arr), _ptr(idx),
                       idx.size, _ptr(out), threads or _threads_default())
    return out


def gather_dequant(arr: np.ndarray, idx: np.ndarray, *, scale: float = 1.0 / 255.0,
                   out: Optional[np.ndarray] = None,
                   threads: Optional[int] = None) -> np.ndarray:
    """``arr[idx].astype(float32) * float32(scale)`` for uint8 ``arr`` in one
    pass: the packed store's codec decoded without the uint8 batch."""
    if arr.dtype != np.uint8:
        raise TypeError(f"gather_dequant expects uint8, got {arr.dtype}")
    lib = _load()
    idx = _idx64(idx, arr.shape[0])
    if lib is None or not _rows_ok(arr):
        res = arr[idx].astype(np.float32) * np.float32(scale)
        if out is None:
            return res
        _check_out(out, res.shape, res.dtype)
        out[...] = res
        return out
    if out is None:
        out = np.empty((idx.size, *arr.shape[1:]), dtype=np.float32)
    else:
        _check_out(out, (idx.size, *arr.shape[1:]), np.float32)
    lib.ft_gather_u8_f32(_ptr(arr), _row_elems(arr), _ptr(idx), idx.size, _ptr(out),
                         ctypes.c_float(scale), threads or _threads_default())
    return out


def prefetch(arr: np.ndarray, idx: np.ndarray) -> bool:
    """Ask the kernel to read ahead the pages holding ``arr[idx]`` (madvise
    only, no copy). Meaningful for memory-mapped arrays, harmless on others.
    True if the hint was issued natively."""
    lib = _load()
    if lib is None or not _rows_ok(arr):
        return False
    idx = _idx64(idx, arr.shape[0])
    if idx.size:
        lib.ft_prefetch_rows(_ptr(arr), arr.dtype.itemsize * _row_elems(arr), _ptr(idx),
                             idx.size)
    return True
