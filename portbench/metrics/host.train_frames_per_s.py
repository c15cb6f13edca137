"""The training rate on the host clock, per layer: every real frame of
every step of the untraced window's whole epochs over the window's
seconds, as ``train_frames_per_s`` measures it where that is end to end.
Where the host's speed spreads it beyond any bound, it stands here beside
the device's rate."""


def read(ctx):
    if ctx["slice"] is None or not ctx["slice"].device_ops:
        return None
    epochs = ctx["window_units"] / ctx["lengths_units"]
    return sum(ctx["lengths"]) * epochs / ctx["window_s"]
