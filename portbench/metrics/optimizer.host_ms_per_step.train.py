"""Host milliseconds a training step in the optimizer: the program's
``mdmm/train.optimizer`` spans (the clip and ``optimizer.step()``) over
the traced slice's steps."""

from portbench.core import spans


def read(ctx):
    ms = spans.total_ms(ctx["slice"], "train.optimizer")
    return None if ms is None else ms / ctx["slice"].units
