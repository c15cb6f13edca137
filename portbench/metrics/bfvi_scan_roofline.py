"""Share of their roofline that the filter scans' forward and backward
kernels reach over the traced slice's training steps: the least time of
the scan work that the steps require (``work/kernels.py:
scan_kernels_work`` for each filtering and smoothing pass over the real
steps of the epoch's chunks, the weights once a launch; float32 products
at 495/3 TFLOP/s, bytes once at 3.35 TB/s) over the device time of the
``bfvi_scan_fwd*`` and ``bfvi_scan_bwd*`` kernels. The bound is taken over
an epoch's totals, which is never more than the sum of its launches'
bounds, so the share is never read high."""

from portbench.work import kernels as kw
from portbench.work.model_flops import scan_passes_train


def read(ctx):
    sl = ctx["slice"]
    busy = sl and sl.kernel_seconds("bfvi_scan_fwd", "bfvi_scan_bwd")
    if not busy:
        return None
    cfg, lengths, per = ctx["cfg"], ctx["lengths"], ctx["lengths_units"]
    bound = sum(kw.bound_ms(*kw.scan_kernels_work(
        lengths * v, m, k, cfg["z_dim"], cfg["h_dim"], launches=per),
        peak=kw.PEAK_F32_PRODUCTS)
        for m, v, k in scan_passes_train(cfg))
    return 100.0 * bound * 1e-3 * (sl.units / per) / busy
