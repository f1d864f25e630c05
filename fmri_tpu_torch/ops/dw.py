"""Convolution weight gradients through the hand-written CUDA kernel
``csrc/dw.cu``, or their plain PyTorch versions.

Counterpart of ``fmri_tpu/ops/pallas_dw.py``: ``_tap_matmul`` (:71) and the
two geometries that use it, ``conv2d_dw`` (:132) and ``conv2d_transpose_dw``
(:173). Each sums ``X_tap^T @ dY`` over batch and pixels for every kernel
tap, in fp32, and returns the weight grad **in the port's layout**:

* :func:`conv2d_dw` -> Conv2d OIHW ``[Co, Ci, k, k]``;
* :func:`conv2d_transpose_dw` -> ConvTranspose2d IOHW ``[Ci, Co, k, k]`` in
  torch's scatter convention (the JAX layout's 180-degree tap rotation lives
  only in ``checkpoints/convert.py``).

Activations are NCHW. Operands are fp32 or bf16 (the caller casts both to
the compute dtype); the result is fp32. A CUDA tensor launches
:func:`tap_matmul` (one kernel, counted in ``tap_matmul.launches``) or
raises; a CPU tensor takes ``*_plain``, one einsum per tap
(:func:`tap_matmul_plain`). On the card the product runs on the tensor
cores (``wgmma``): fp32 operands as 3xTF32, bf16 operands in one bf16 pass;
:func:`plan` picks the tile, the shared-memory patch of the shifted operand
(:func:`patch_shape`), the split of the reduction and the row pitches TMA
reads each operand on (:func:`pitch`), and the kernel is launched with that
geometry (its C entry checks that the patch holds every tap it reads). An
operand whose rows are not whole 16-byte units is first copied onto those
pitches, in the same C call and on the same stream, into scratch that
:func:`tap_matmul` allocates.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROW_BYTES = 128       # one staged reduction run: 32 fp32 or 64 bf16 (csrc/dw.cu)
TILE_N = (8, 32, 64, 128)  # N extents of the wgmma tiles
SMS = 132             # streaming multiprocessors of an H100 SXM
SMEM_PER_SM = 233472  # bytes of shared memory an SM holds
REGS_PER_SM = 65536
REGS_PER_THREAD = 228  # the widest dw_wgmma instance (fp32, 128 x 128), from ptxas
MIN_TILES = 8         # reduction tiles per split, at least
SETUP_TILES = 4       # a block's fixed cost (prologue, epilogue) in tiles
MAX_SPLITS = 512


def _out_size(n: int, k: int, stride: int, padding: int) -> int:
    return (n + 2 * padding - k) // stride + 1


def tap_matmul_plain(shifted: torch.Tensor, direct: torch.Tensor, k: int,
                     stride: int, pad: int) -> torch.Tensor:
    """:func:`tap_matmul` as one einsum per tap over the zero-padded
    ``shifted`` operand, in fp32."""
    _, _, hs, ws = shifted.shape
    _, _, ph, pw = direct.shape
    hi_h = max(0, (ph - 1) * stride + k - pad - hs)
    hi_w = max(0, (pw - 1) * stride + k - pad - ws)
    sp = F.pad(shifted.float(), (pad, hi_w, pad, hi_h))
    df = direct.float()
    taps = [torch.einsum("bshw,buhw->us",
                         sp[:, :, kh:kh + stride * (ph - 1) + 1:stride,
                            kw:kw + stride * (pw - 1) + 1:stride], df)
            for kh in range(k) for kw in range(k)]
    return torch.stack(taps, -1).view(direct.shape[1], shifted.shape[1], k, k)


def conv2d_dw_plain(x: torch.Tensor, dy: torch.Tensor, stride: int,
                    padding: int, k: int = 5) -> torch.Tensor:
    """OIHW fp32 weight grad of ``F.conv2d(x, w, stride, padding)``:
    dW[co, ci, kh, kw] = sum x[b, ci, oh*s - p + kh, ow*s - p + kw] * dy[b, co, oh, ow]."""
    return tap_matmul_plain(x, dy, k, stride, padding)


def conv2d_transpose_dw_plain(x: torch.Tensor, dy: torch.Tensor, stride: int = 2,
                              padding: int = 2, output_padding: int = 0,
                              k: int = 5) -> torch.Tensor:
    """IOHW fp32 weight grad of ``F.conv_transpose2d(x, w, stride, padding,
    output_padding)``: dW[ci, co, kh, kw] = sum x[b, ci, i, j] *
    dy[b, co, i*s - p + kh, j*s - p + kw] over the indices inside dy
    (``output_padding`` is implied by dy's shape)."""
    del output_padding
    return tap_matmul_plain(dy, x, k, stride, padding)


def _check(shifted: torch.Tensor, direct: torch.Tensor) -> str:
    """'cpu' or 'cuda' for a consistent operand pair; raises otherwise."""
    for name, t in (("shifted", shifted), ("direct", direct)):
        if t.dim() != 4:
            raise ValueError(f"{name} operand must be NCHW, got {tuple(t.shape)}")
    if shifted.device != direct.device:
        raise ValueError(f"operands on {shifted.device} and {direct.device}")
    if shifted.shape[0] != direct.shape[0]:
        raise ValueError(f"batch {shifted.shape[0]} vs {direct.shape[0]}")
    kind = shifted.device.type
    if kind == "cpu":
        return kind
    if kind != "cuda":
        raise ValueError(f"unsupported device {shifted.device}")
    if shifted.dtype not in KERNEL_DTYPES or direct.dtype != shifted.dtype:
        raise TypeError(f"operands must both be float32 or bfloat16, got "
                        f"{shifted.dtype} and {direct.dtype}")
    if not (shifted.is_contiguous() and direct.is_contiguous()):
        raise ValueError("operands must be contiguous NCHW")
    if max(shifted.numel(), direct.numel()) >= 2**31:
        raise ValueError("operands of 2**31 elements or more")
    return kind


@functools.cache
def _lib():
    """The built ``csrc/dw.cu``, typed for ctypes."""
    from fmri_tpu_torch.ops import build

    lib = build.load("dw")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tap_matmul.restype = i
    lib.tap_matmul.argtypes = [p, p, i] * 2 + [p] * 2 + [i] * 19 + [p]
    return lib


def patch_shape(mt: int, k: int, stride: int, cs: int, pw: int,
                esz: int = 4) -> tuple[int, int, int, bool]:
    """(Cp, Hp, Wp, within_row) of the S patch one stage of ``csrc/dw.cu``
    stages: the channels that mt consecutive rows of D can span; the input
    rows under the tile's output rows; and its columns, a run of RK
    positions when PW is a multiple of RK (``within_row``), else whole rows,
    from the 16-byte boundary at or below the first column (TMA's rule for
    where a box starts), rounded up to 16 bytes."""
    rk = ROW_BYTES // esz
    within_row = pw % rk == 0
    nrows = 1 if within_row else rk // pw if rk % pw == 0 else (rk - 1) // pw + 2
    cols = (rk - 1) * stride + k if within_row else (pw - 1) * stride + k
    unit = 16 // esz  # the box starts on 16 bytes, up to unit - 1 columns early
    return (min(cs, (mt - 1) // (k * k) + 2), (nrows - 1) * stride + k,
            (cols + 2 * unit - 2) // unit * unit, within_row)


def pitch(n: int, esz: int = 4) -> int:
    """The row pitch, in elements, that TMA reads a row of ``n`` elements on:
    n rounded up to a whole number of 16-byte units (TMA's rule for a row
    stride). A row already that long is read where it lies."""
    unit = 16 // esz
    return -(-n // unit) * unit


def ring_stages(nt: int) -> int:
    """Shared-memory ring depth of a tile nt wide (``csrc/dw.cu::ring_stages``)."""
    return 4 if nt >= 64 else 8


def smem_bytes(nt: int, patch_bytes: int, esz: int = 4) -> int:
    """Dynamic shared memory of one block of ``csrc/dw.cu::dw_wgmma``, as its
    ``launch`` computes it: alignment slack, the U ring, three lo buffers
    for fp32 operands, one S patch of ``patch_bytes`` per stage (on 1 KB
    boundaries), the position offsets and the barriers."""
    stages = ring_stages(nt)
    return (1024 + (stages + (3 if esz == 4 else 0)) * nt * ROW_BYTES
            + stages * -(-patch_bytes // 1024) * 1024
            + stages * (ROW_BYTES // esz) * 4 + stages * 8)


def resident_blocks(mt: int, nt: int, patch_bytes: int, esz: int = 4) -> int:
    """Blocks of one tile shape that fit on an SM at once: by shared memory
    (228 KB, 1 KB of it reserved per block) and by registers (65,536; up to
    228 a thread)."""
    return max(1, min(SMEM_PER_SM // (smem_bytes(nt, patch_bytes, esz) + 1024),
                      REGS_PER_SM // (2 * mt * REGS_PER_THREAD)))


class Plan(NamedTuple):
    """One launch of ``csrc/dw.cu``: the tile of D a block owns (mt x nt),
    the split of the reduction (``splits`` runs of ``chunk`` tiles), the S
    patch a stage holds (:func:`patch_shape`), and the row pitches TMA reads
    S's rows (Ws) and U's rows (PH*PW) on (:func:`pitch`)."""
    mt: int
    nt: int
    splits: int
    chunk: int
    cp: int
    hp: int
    wp: int
    within_row: bool
    s_pitch: int
    u_pitch: int


@functools.cache
def plan(shifted_shape: tuple, direct_shape: tuple, k: int, stride: int,
         esz: int = 4) -> Plan:
    """The launch of :func:`tap_matmul` for S ``shifted_shape`` and U
    ``direct_shape`` (NCHW) with ``esz``-byte operands. D is [n, m] = [Cu,
    Cs*k*k], summed over B * ceil(PH*PW / RK) reduction tiles. The tile: the
    narrowest wgmma N extent that covers n (128 for wider n, in several
    tiles); two warpgroups (mt = 128) at that width, one otherwise. The
    split minimises a model of the run time, waves of blocks on the card
    (``resident_blocks`` per SM, from this launch's shared memory) times the
    tiles of one block plus its fixed cost. Each split holds ``chunk``
    consecutive tiles, the last fewer. Kept per shape: the search loops
    over up to 512 split counts in Python, host time on the order of a
    narrow call's kernel."""
    def cdiv(a, b):
        return -(-a // b)

    b, cs = shifted_shape[:2]
    _, n, ph, pw = direct_shape
    m, tiles = cs * k * k, b * cdiv(ph * pw, ROW_BYTES // esz)
    nt = next((t for t in TILE_N if n <= t), TILE_N[-1])
    mt = 128 if nt == 128 and m > 64 else 64
    cp, hp, wp, within_row = patch_shape(mt, k, stride, cs, pw, esz)
    blocks = cdiv(m, mt) * cdiv(n, nt)
    resident = SMS * resident_blocks(mt, nt, cp * hp * wp * esz, esz)
    best = None
    for s in range(1, max(1, min(MAX_SPLITS, tiles // MIN_TILES)) + 1):
        cost = cdiv(blocks * s, resident) * (cdiv(tiles, s) + SETUP_TILES)
        if best is None or cost < best[0]:
            best = (cost, s)
    chunk = cdiv(tiles, best[1])
    return Plan(mt, nt, cdiv(tiles, chunk), chunk, cp, hp, wp, within_row,
                pitch(shifted_shape[3], esz), pitch(ph * pw, esz))


def _stage(t: torch.Tensor, rows: int, width: int, row_pitch: int) -> torch.Tensor | None:
    """Scratch of ``rows * row_pitch`` elements for an operand that TMA
    cannot read where it lies (rows of ``width`` elements not on the pitch,
    or a base off 16 bytes), which the kernel copies its rows into; else
    None."""
    if row_pitch == width and t.data_ptr() % 16 == 0:
        return None
    return torch.empty(rows * row_pitch, dtype=t.dtype, device=t.device)


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def tap_matmul(shifted: torch.Tensor, direct: torch.Tensor, k: int, stride: int,
               pad: int) -> torch.Tensor:
    """``out[cu, cs, kh, kw] = sum_{b,ph,pw} shifted[b, cs, ph*stride - pad + kh,
    pw*stride - pad + kw] * direct[b, cu, ph, pw]`` (zero outside
    ``shifted``), fp32 ``[Cu, Cs, k, k]``, by one launch of ``csrc/dw.cu``.
    CUDA tensors only."""
    if _check(shifted, direct) != "cuda":
        raise ValueError("tap_matmul runs on CUDA tensors; CPU callers use "
                         "conv2d_dw / conv2d_transpose_dw")
    b, cs, hs, ws = shifted.shape
    _, cu, ph, pw = direct.shape
    out = torch.empty((cu, cs, k, k), dtype=torch.float32, device=shifted.device)
    if out.numel() == 0 or b * ph * pw == 0:
        return out.zero_()
    p = plan(tuple(shifted.shape), tuple(direct.shape), k, stride, shifted.element_size())
    partial = (torch.empty((p.splits, cu, cs * k * k), dtype=torch.float32,
                           device=shifted.device) if p.splits > 1 else out)
    s_stage = _stage(shifted, b * cs * hs, ws, p.s_pitch)
    u_stage = _stage(direct, b * cu, ph * pw, p.u_pitch)
    with torch.cuda.device(shifted.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().tap_matmul(shifted.data_ptr(), _ptr(s_stage), p.s_pitch,
                               direct.data_ptr(), _ptr(u_stage), p.u_pitch,
                               partial.data_ptr(), out.data_ptr(),
                               KERNEL_DTYPES[shifted.dtype], p.mt, p.nt, b, cs, hs, ws,
                               cu, ph, pw, k, stride, pad, p.splits, p.chunk, p.cp,
                               p.hp, p.wp, int(p.within_row), stream)
    if rc != 0:
        raise RuntimeError(f"tap_matmul launch failed with code {rc} (a CUDA "
                           f"error; 1000: no TMA descriptor; 1001: the S patch does not fit in "
                           f"shared memory; 1002: the S patch misses a tap; 1003: an S patch "
                           f"side over 256, TMA's limit for a box; 1004: an operand not on 16 "
                           f"bytes) (shifted {tuple(shifted.shape)}, direct "
                           f"{tuple(direct.shape)}, k {k}, stride {stride})")
    tap_matmul.launches += 1
    return out


tap_matmul.launches = 0


def conv2d_dw(x: torch.Tensor, dy: torch.Tensor, stride: int, padding: int,
              k: int = 5) -> torch.Tensor:
    """OIHW fp32 weight grad of ``conv2d(x, w, stride, padding)``."""
    oh, ow = _out_size(x.shape[2], k, stride, padding), _out_size(x.shape[3], k, stride, padding)
    if tuple(dy.shape[2:]) != (oh, ow):
        raise ValueError(f"dy {tuple(dy.shape)} is not the output of x "
                         f"{tuple(x.shape)} at k {k}, stride {stride}, padding {padding}")
    if _check(x, dy) == "cpu":
        return conv2d_dw_plain(x, dy, stride, padding, k)
    return tap_matmul(x, dy, k, stride, padding)


def conv2d_transpose_dw(x: torch.Tensor, dy: torch.Tensor, stride: int = 2,
                        padding: int = 2, output_padding: int = 0,
                        k: int = 5) -> torch.Tensor:
    """IOHW fp32 weight grad of ``conv2d_transpose(x, w, stride, padding,
    output_padding)``."""
    want = tuple((n - 1) * stride - 2 * padding + k + output_padding
                 for n in x.shape[2:])
    if tuple(dy.shape[2:]) != want:
        raise ValueError(f"dy {tuple(dy.shape)} is not the output of x "
                         f"{tuple(x.shape)} at k {k}, stride {stride}, padding "
                         f"{padding}, output_padding {output_padding}")
    if _check(dy, x) == "cpu":
        return conv2d_transpose_dw_plain(x, dy, stride, padding, output_padding, k)
    return tap_matmul(dy, x, k, stride, padding)
