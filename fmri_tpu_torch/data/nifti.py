"""Minimal pure-NumPy NIfTI-1 reader and writer: the port's copy of
``fmri_tpu/data/nifti.py`` (the same bytes in and out).

The reference reads BOLD5000 NIfTI volumes with nibabel
(``data_preprocessing/data_loader.py:9,73``; ``roi_extraction.py:61-62``).
nibabel is not part of this build's dependency set, and the subset of it the
reference exercises — ``nib.load(path).get_fdata()`` on single-file ``.nii`` /
``.nii.gz`` images — is a straightforward binary format, so it is implemented
here directly from the public NIfTI-1 specification (348-byte header + raw
voxel block, optional scl_slope/scl_inter scaling).

Only what the pipeline needs is supported: single-file NIfTI-1 (magic
``n+1``), the numeric datatypes BOLD5000/fmriprep emit, and gzip compression.
"""

from __future__ import annotations

import gzip
import struct
from typing import Tuple

import numpy as np

# NIfTI-1 datatype codes -> numpy dtypes (spec: nifti1.h).
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}

HEADER_SIZE = 348


class NiftiImage:
    """A loaded NIfTI-1 image: ``data`` (after scl scaling), ``affine``-free."""

    def __init__(self, data: np.ndarray, header: dict):
        self._data = data
        self.header = header

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._data.shape

    def get_fdata(self, dtype=np.float64) -> np.ndarray:
        """nibabel-compatible accessor (``roi_extraction.py:61-62``)."""
        return np.asarray(self._data, dtype=dtype)

    # nibabel<3 alias used by the reference (``data_loader.py:73``).
    get_data = get_fdata


def _read_bytes(path: str) -> bytes:
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


def load(path: str) -> NiftiImage:
    """Load a single-file NIfTI-1 image (``.nii`` or ``.nii.gz``)."""
    raw = _read_bytes(path)
    if len(raw) < HEADER_SIZE:
        raise ValueError(f"{path}: truncated NIfTI header")
    # sizeof_hdr at offset 0 tells us the byte order.
    (sizeof_hdr,) = struct.unpack("<i", raw[:4])
    bo = "<" if sizeof_hdr == HEADER_SIZE else ">"
    if bo == ">" and struct.unpack(">i", raw[:4])[0] != HEADER_SIZE:
        raise ValueError(f"{path}: not a NIfTI-1 file (sizeof_hdr={sizeof_hdr})")

    magic = raw[344:348]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")
    if magic[:3] == b"ni1":
        raise ValueError(f"{path}: two-file NIfTI (.hdr/.img) not supported")

    dim = struct.unpack(bo + "8h", raw[40:56])
    ndim = int(dim[0])
    if not 1 <= ndim <= 7:
        raise ValueError(f"{path}: bad ndim {ndim}")
    shape = tuple(int(d) for d in dim[1 : 1 + ndim])

    (datatype,) = struct.unpack(bo + "h", raw[70:72])
    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype code {datatype}")
    np_dtype = np.dtype(_DTYPES[datatype]).newbyteorder(bo)

    scl_slope, scl_inter = struct.unpack(bo + "2f", raw[112:120])
    (vox_offset,) = struct.unpack(bo + "f", raw[108:112])
    offset = int(vox_offset) if vox_offset else HEADER_SIZE + 4

    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=np_dtype, count=count, offset=offset)
    # NIfTI voxel order is Fortran (x fastest).
    data = data.reshape(shape, order="F")
    if scl_slope not in (0.0, 1.0) or scl_inter not in (0.0,):
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data * slope + scl_inter
    header = {"dim": shape, "datatype": datatype,
              "scl_slope": scl_slope, "scl_inter": scl_inter}
    return NiftiImage(np.asarray(data), header)


def save(path: str, data: np.ndarray) -> None:
    """Write a minimal single-file NIfTI-1 image (for tests / ETL round-trips)."""
    data = np.asarray(data)
    code = None
    for c, dt in _DTYPES.items():
        if np.dtype(dt) == data.dtype:
            code = c
            break
    if code is None:
        data = data.astype(np.float32)
        code = 16
    hdr = bytearray(HEADER_SIZE)
    struct.pack_into("<i", hdr, 0, HEADER_SIZE)
    dim = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)  # bitpix
    struct.pack_into("<f", hdr, 108, float(HEADER_SIZE + 4))  # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)               # scl slope/inter
    hdr[344:348] = b"n+1\x00"
    payload = bytes(hdr) + b"\x00\x00\x00\x00" + data.tobytes(order="F")
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(payload)
