"""The whole training step's share of the H100's dense TF32 peak (495
TFLOP/s) over the device's busy time: the operations that the traced
slice's steps require (``work/model_flops.py:train_flops`` over the real
steps of an epoch's chunks) over the seconds in which an operation ran on
the device in that slice. It bounds what the kernels' rooflines can add to
the device's rate."""

from portbench.work.kernels import PEAK_TF32_FLOPS
from portbench.work.model_flops import train_flops


def read(ctx):
    sl = ctx["slice"]
    if sl is None or not sl.busy_s:
        return None
    per = ctx["lengths_units"]
    flops = train_flops(ctx["cfg"], ctx["lengths"], per)
    return 100.0 * flops * (sl.units / per) / sl.busy_s / PEAK_TF32_FLOPS
