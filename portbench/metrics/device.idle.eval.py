"""The share of the traced slice of evaluations in which no operation ran on
the device (the union of the device operations' intervals against the
slice's length on the host clock)."""


def read(ctx):
    sl = ctx["slice"]
    if sl is None or not sl.device_ops:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)
