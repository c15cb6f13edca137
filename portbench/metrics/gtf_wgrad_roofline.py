"""Share of their roofline that the transition's weight-gradient kernels
reach over the traced slice's training steps: the least time of the
weight-gradient products that the steps require (``work/kernels.py:
scan_work``'s third part for each pass over the real steps of the epoch's
chunks, the weights once a launch; float32 products at 495/3 TFLOP/s,
bytes once at 3.35 TB/s) over the device time of the ``gtf_wgrad*``
kernels. The bound is taken over an epoch's totals, which is never more
than the sum of its launches' bounds."""

from portbench.work import kernels as kw
from portbench.work.model_flops import scan_passes_train


def read(ctx):
    sl = ctx["slice"]
    busy = sl and sl.kernel_seconds("gtf_wgrad")
    if not busy:
        return None
    cfg, lengths, per = ctx["cfg"], ctx["lengths"], ctx["lengths_units"]
    bound = sum(kw.bound_ms(*kw.scan_work(
        lengths * v, m, k, cfg["z_dim"], cfg["h_dim"], launches=per)[2],
        peak=kw.PEAK_F32_PRODUCTS)
        for m, v, k in scan_passes_train(cfg))
    return 100.0 * bound * 1e-3 * (sl.units / per) / busy
