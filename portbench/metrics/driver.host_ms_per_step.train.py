"""Host milliseconds a training step in the epoch loop itself: the self
time of the program's ``mdmm/train.epoch`` spans (their length less the
batches', steps' and syncs' spans inside them) over the traced slice's
steps. Read under the profiler, which slows the host."""

from portbench.core import spans


def read(ctx):
    ms = spans.self_ms(ctx["slice"], "train.epoch")
    return None if ms is None else ms / ctx["slice"].units
