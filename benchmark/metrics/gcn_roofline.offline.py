"""The graph-conv kernels' share of their roofline in offline segmentation,
in %: the least time of every layer's graph-conv forward over the traced
slice's trials (RT-ST-GCN's window sums too; each part's larger of its bytes
at 3.35 TB/s and its operations at the fp32-accurate peak,
:mod:`benchmark.harness.yardstick`) over the device time of the kernels
below that do it. Moves ``offline_frames_per_s``."""

from benchmark.harness.yardstick import gcn_parts, least_seconds

# gcn_core's, the fused RT core's and the window pass's kernels
KERNELS = ("core_fma_kernel", "core_mma_kernel", "z_fma_kernel", "z_mma_kernel",
           "stgx::window_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    busy = ctx.trace.device_seconds(KERNELS)
    if busy <= 0:
        return None
    least = least_seconds(gcn_parts(ctx.cfg, ctx.counts["lengths"], train=False, window=True))
    return 100.0 * least / busy
