"""Host synchronisations a training step: the program's ``mdmm/sync.*``
spans, one a synchronising site passed, over the traced slice's steps."""

from portbench.core import spans


def read(ctx):
    found = spans.syncs(ctx["slice"])
    return None if found is None else len(found) / ctx["slice"].units
