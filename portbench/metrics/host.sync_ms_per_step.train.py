"""Host milliseconds a training step spent waiting on the device: the
program's ``mdmm/sync.*`` spans' length over the traced slice's steps."""

from portbench.core import spans


def read(ctx):
    found = spans.syncs(ctx["slice"])
    if found is None:
        return None
    return sum(e - s for s, e in found) / 1e3 / ctx["slice"].units
