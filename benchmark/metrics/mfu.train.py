"""The whole training step's share of the card's fp32 peak, in %: the
model's MACs a frame (forward, and twice that backward) as two operations
each, times the trials' own frames trained in the traced slice, over the
slice's time and 67 TFLOP/s. Moves ``train_frames_per_s``."""

from benchmark.harness.yardstick import FP32_FLOP_S, macs_per_frame


def read(ctx):
    if ctx.trace is None or not ctx.counts.get("frames"):
        return None
    flops = 3 * 2 * macs_per_frame(ctx.cfg, ctx.num_classes) * ctx.counts["frames"]
    return 100.0 * flops / ctx.trace.window_s / FP32_FLOP_S
