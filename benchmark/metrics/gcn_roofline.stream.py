"""The graph-conv kernel's share of its roofline in the streaming cell, in
%: the least time of every layer's graph-conv forward over B rows a traced
step (the FIFO's window sum runs as eager ops, not here; each part's larger
of its bytes at 3.35 TB/s and its operations at the fp32-accurate peak,
:mod:`benchmark.harness.yardstick`) over the device time of gcn_core's
kernels. Moves ``stream_step_p95_ms``."""

from benchmark.harness.yardstick import gcn_parts, least_seconds

KERNELS = ("core_fma_kernel", "core_mma_kernel")


def read(ctx):
    if ctx.trace is None or not ctx.counts.get("steps"):
        return None
    busy = ctx.trace.device_seconds(KERNELS)
    if busy <= 0:
        return None
    rows = ctx.counts["frames"] // ctx.counts["steps"]
    least = least_seconds(gcn_parts(ctx.cfg, [rows], train=False, window=False))
    return 100.0 * least * ctx.counts["steps"] / busy
