"""One evaluation's share of the H100's dense TF32 peak (495 TFLOP/s): the
operations that an evaluation of the real sequences requires
(``work/model_flops.py:eval_flops``; no backward, metrics left out) times
the evaluations of the window, over the window's seconds."""

from portbench.work.kernels import PEAK_TF32_FLOPS
from portbench.work.model_flops import eval_flops


def read(ctx):
    if ctx["slice"] is None or not ctx["slice"].device_ops:
        return None
    flops = eval_flops(ctx["cfg"], ctx["lengths"])
    return 100.0 * flops * (ctx["window_units"] / ctx["lengths_units"]) / (
        ctx["window_s"] * PEAK_TF32_FLOPS)
