"""Host milliseconds an evaluation in its sampled filtering pass: the
program's ``mdmm/dmm.filter`` spans (the 200-particle pass, step after
step) over the traced slice's calls."""

from portbench.core import spans


def read(ctx):
    ms = spans.total_ms(ctx["slice"], "dmm.filter")
    return None if ms is None else ms / ctx["slice"].units
