"""Build the port's CUDA kernels on first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

The ``.so`` lands in ``fmri_tpu_torch/ops/_build/`` (listed in
``.gitignore``), named by a hash of the source and the flags, so an edited
source rebuilds and an unchanged one loads the existing library. No torch
headers are included: a build takes seconds, not minutes, and the sources
compile side by side. Nothing builds at import time; a failed build raises
with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

CSRC = os.path.join(os.path.dirname(__file__), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(__file__), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def kernel_names() -> list[str]:
    """Names of the kernel sources under ``csrc/`` (``ssim`` for ssim.cu)."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found on PATH or at /usr/local/cuda/bin; "
                           "the CUDA kernels build only where the toolkit is")
    return nvcc


def library_path(name: str) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(names: list[str] | None = None) -> None:
    """Compile the named kernels (default: all) that are not built yet: one
    nvcc per source, all started together, each waited for."""
    jobs = []
    for name in names or kernel_names():
        out = library_path(name)
        if os.path.exists(out):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        jobs.append((out, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for out, tmp, cmd, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    if failures:
        raise RuntimeError("\n".join(failures))


def load(name: str) -> ctypes.CDLL:
    """The kernel library for ``csrc/<name>.cu``, built if needed."""
    build([name])
    return ctypes.CDLL(library_path(name))
