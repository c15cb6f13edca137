"""Device milliseconds a training step: the union of the device operations'
intervals in the traced slice over its steps."""


def read(ctx):
    sl = ctx["slice"]
    if sl is None or not sl.device_ops:
        return None
    return 1e3 * sl.busy_s / sl.units
