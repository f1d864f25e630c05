"""Device selection and numerics settings for the port's entry points."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise if CUDA is asked for and
    there is no card (never fall back to the CPU).

    On CUDA this also turns TF32 off for matmuls and cuDNN convolutions: cuDNN
    defaults to TF32 on Hopper, which keeps about three decimal digits and
    would break the fp32 parity with the reference. The ``-bf16`` presets cast
    their conv/matmul operands explicitly and are unaffected.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' (or --device cpu) to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}; use 'cuda' or 'cpu'")
    return dev


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms inside the block; the caller's
    setting comes back on exit. Every entry point that computes results runs
    in it (the ``Trainer``'s fit and evaluation, the inference CLI's
    reconstruction, serving's graphs): cuDNN's default algorithm for the
    stride-2 convs' input grads and the decoder's transposed convolutions
    (its dgrad engine) sums in no fixed order, so two runs of one epoch from
    one seed would part ways, and one request could come back different in
    its last bits. The JAX trainer resumes bit for bit; there is no opt-out."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


_CONSTANTS: dict = {}


def constant(value, dtype: torch.dtype, device: str | torch.device) -> torch.Tensor:
    """``torch.as_tensor(value, dtype=dtype, device=device)`` made once per
    (value, dtype, device) and then reused. On CUDA a tensor of host data is
    a pageable copy that waits for the device's queue to drain; a step that
    makes one per call stalls the host there every call. The tensor is
    shared by every caller: never write into it. ``value`` is a number or a
    tuple of numbers; ``device`` a tensor's (with its index on CUDA). A
    constant that a CUDA graph reads must first be made outside the capture
    (by the warm calls before it)."""
    key = (value, dtype, torch.device(device))
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS.setdefault(key, torch.as_tensor(value, dtype=dtype, device=device))
    return t
