"""Numerical primitives: expert fusion, losses, schedules, SSIM, and the
CUDA kernels (``ops.cuda``: the filtering scan and the PoE + sampling
cell)."""
