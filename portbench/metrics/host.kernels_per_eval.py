"""Device kernels an evaluation, counted in the traced slice (copies and
fills left out): the host's dispatch work that the device waits on."""


def read(ctx):
    sl = ctx["slice"]
    if sl is None or not sl.device_ops:
        return None
    return len(sl.kernels()) / sl.units
