"""fmri_tpu_torch — the PyTorch/CUDA port of ``fmri_tpu`` for NVIDIA Hopper.

A second package beside ``fmri_tpu`` (the JAX reference, held unchanged). It
imports ``torch`` and numpy only: nothing of JAX and nothing of ``fmri_tpu``.
Public functions keep the reference's NHWC image layout; modules work in NCHW
with the reference's torch weight layouts, so reference ``.pth`` state dicts
load with ``strict=True``. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"`` (see :func:`fmri_tpu_torch.device.resolve_device`).

Ported so far: inference and serving (``eval/``), with a hand-written CUDA
SSIM kernel (``ops/csrc/ssim.cu``); the train steps of the VAE/GAN and WAE
families (``train/steps_*.py``), whose BatchNorm backward and conv/deconv
weight grads run through hand-written CUDA kernels (``ops/csrc/bn.cu``,
``ops/csrc/dw.cu``) when ``pallas_bn`` and ``pallas_backward`` are set; and
the training driver: ``train/trainer.py``, the stage builders
(``train/stages.py``), the checkpoint store (``checkpoints/store.py``), the
input pipeline (``data/pipeline.py``), run artifacts (``utils/``) and the
``python -m fmri_tpu_torch.train.run`` CLI; the data path (the native
gather, the raw datasets, the BOLD5000 ETL and its ``data/prepare.py``
CLI); the Inception Score (``metrics/inception.py``, ``inception_v3.py``);
and the parity and user-study CLIs (``eval/parity.py``,
``eval/user_study.py``).
"""

__version__ = "0.1.0"
