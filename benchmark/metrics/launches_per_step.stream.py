"""Device activities (kernels, copies, fills) a streaming step launches,
counted in the traced slice over its steps. Moves ``stream_step_p95_ms``."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device or not ctx.counts.get("steps"):
        return None
    return len(ctx.trace.device) / ctx.counts["steps"]
