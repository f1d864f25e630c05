"""Device selection for the port's entry points."""

from __future__ import annotations

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
