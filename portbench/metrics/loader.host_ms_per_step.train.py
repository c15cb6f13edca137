"""Host milliseconds a training step spent fetching its batch: the
program's ``mdmm/train.batch`` spans (the device loader's gather and
bursts, its copies in) over the traced slice's steps."""

from portbench.core import spans


def read(ctx):
    ms = spans.total_ms(ctx["slice"], "train.batch")
    return None if ms is None else ms / ctx["slice"].units
