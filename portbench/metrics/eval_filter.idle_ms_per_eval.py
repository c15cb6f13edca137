"""Device idle milliseconds an evaluation while the host was in the sampled
filtering pass: the gaps between the device's operations whose middle
lies inside a ``mdmm/dmm.filter`` span, over the traced slice's calls."""

from portbench.core import spans


def read(ctx):
    ms = spans.idle_ms_under(ctx["slice"], "dmm.filter")
    return None if ms is None else ms / ctx["slice"].units
