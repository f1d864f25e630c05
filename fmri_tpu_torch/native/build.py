"""Build-on-first-use for the port's native loader library.

Compiles ``loader.cc`` with the system C++ compiler (``$CXX``, default
``g++``)::

    g++ -O3 -std=c++17 -shared -fPIC -pthread loader.cc -o _build/loader-<hash>.so

into ``fmri_tpu_torch/native/_build/`` (listed in ``.gitignore``), named by a
hash of the source, so an edited source rebuilds and a stale library never
loads. One translation unit, under a second with -O3.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile

SRC = os.path.join(os.path.dirname(__file__), "loader.cc")
BUILD_DIR = os.path.join(os.path.dirname(__file__), "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


def library_path() -> str:
    with open(SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"loader-{tag}.so")


def build_library(force: bool = False) -> str:
    """The path of the compiled library, built if missing (or ``force``)."""
    out = library_path()
    if os.path.exists(out) and not force:
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    # compile to a temp name, then rename: processes racing the first build
    # each write a whole file of their own, and the rename is atomic
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, SRC, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"native build failed ({' '.join(cmd)}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out
