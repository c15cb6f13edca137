"""Numerical primitives: expert fusion, losses, schedules, and the CUDA
filtering-scan kernels (``ops.cuda``)."""
