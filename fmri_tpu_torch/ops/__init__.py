"""Convolution geometry and its optional weight-grad backward (``conv``),
the CUDA kernels and their plain versions (``ssim``; ``bn``, the BatchNorm
backward; ``dw``, the conv/deconv weight grad), and the build of the CUDA
sources under ``csrc/`` (``build``). Importing this package builds nothing."""
