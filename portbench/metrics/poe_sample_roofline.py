"""Share of their roofline that the evaluation filter's kernels reach: the
least time of one sampled filtering pass over the real sequences
(``work/kernels.py:filter_pass_bound_ms``: the cell launch over every
sequence, then each step launch over the sequences still running; float32
elementwise operations at 67 TFLOP/s, bytes once at 3.35 TB/s) times the
slice's evaluations, over the device time of ``poe_sample_cell_kernel``
and ``poe_sample_step_kernel`` in the traced slice."""

from portbench.work import kernels as kw


def read(ctx):
    sl = ctx["slice"]
    busy = sl and sl.kernel_seconds("poe_sample_cell", "poe_sample_step")
    if not busy:
        return None
    cfg = ctx["cfg"]
    bound = kw.filter_pass_bound_ms(
        ctx["lengths"], len(cfg["modalities"]),
        cfg["eval"]["flt_particles"], cfg["z_dim"])
    return 100.0 * bound * 1e-3 * (sl.units / ctx["lengths_units"]) / busy
