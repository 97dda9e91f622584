"""The share of the traced slice in which the device ran nothing, in %:
one less the union of its activity intervals over the slice's length.
Moves ``offline_frames_per_s``."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
