"""The whole training step's share of the H100's dense TF32 peak (495
TFLOP/s): the operations that the window's steps require
(``work/model_flops.py:train_flops`` over the real steps of an epoch's
chunks) over the window's seconds (the untraced window of the traced
run)."""

from portbench.work.kernels import PEAK_TF32_FLOPS
from portbench.work.model_flops import train_flops


def read(ctx):
    if ctx["slice"] is None or not ctx["slice"].device_ops:
        return None
    per = ctx["lengths_units"]
    flops = train_flops(ctx["cfg"], ctx["lengths"], per)
    return 100.0 * flops * (ctx["window_units"] / per) / ctx["window_s"] / (
        PEAK_TF32_FLOPS)
