"""fmri_tpu_torch — the PyTorch/CUDA port of ``fmri_tpu`` for NVIDIA Hopper.

A second package beside ``fmri_tpu`` (the JAX reference, held unchanged). It
imports ``torch`` and numpy only: nothing of JAX and nothing of ``fmri_tpu``.
Public functions keep the reference's NHWC image layout; modules work in NCHW
with the reference's torch weight layouts, so reference ``.pth`` state dicts
load with ``strict=True``. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"`` (see :func:`fmri_tpu_torch.device.resolve_device`).

Ported so far: the cognitive VAE/GAN fMRI->image inference and serving path
(``eval/``), with a hand-written CUDA SSIM kernel (``ops/csrc/ssim.cu``); and
the stage-I Dual-VAE/GAN train step (``train/``), whose BatchNorm backward
and conv/deconv weight grads run through hand-written CUDA kernels
(``ops/csrc/bn.cu``, ``ops/csrc/dw.cu``) when ``pallas_bn`` and
``pallas_backward`` are set.
"""

__version__ = "0.1.0"
