"""The graph-conv kernels' share of their roofline in training, in %: the
least time of the work the layers need over the traced slice's trials
(every layer's graph-conv forward, its input gradient and its parameter
gradients, and RT-ST-GCN's window sums forward and reversed; each part's
larger of its bytes at 3.35 TB/s and its operations at the fp32-accurate
peak, :mod:`benchmark.harness.yardstick`) over the device time of the
kernels below that do it. Moves ``train_frames_per_s``."""

from benchmark.harness.yardstick import gcn_parts, least_seconds

# gcn_core's, the fused RT core's, gcn_grads' and the window pass's kernels
KERNELS = ("core_fma_kernel", "core_mma_kernel", "z_fma_kernel", "z_mma_kernel",
           "stgx::grads::", "stgx::window_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    busy = ctx.trace.device_seconds(KERNELS)
    if busy <= 0:
        return None
    least = least_seconds(gcn_parts(ctx.cfg, ctx.counts["lengths"], train=True, window=True))
    return 100.0 * least / busy
