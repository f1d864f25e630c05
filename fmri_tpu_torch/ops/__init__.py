"""Convolution geometry (``conv``), the SSIM kernel and its plain version
(``ssim``), and the build of the CUDA sources under ``csrc/`` (``build``).
Importing this package builds nothing."""
