"""Analytic MACs and device-memory bytes of RT-ST-GCN — the port of the
RT-ST-GCN counters of ``stgx/utils/flops.py``. Pure arithmetic on the
configuration; the same numbers as the JAX package's for the same
arguments."""

from __future__ import annotations

__all__ = ["rt_stgcn_macs_per_frame", "rt_stgcn_train_hbm_bytes_per_frame"]


def rt_stgcn_macs_per_frame(
    num_joints: int = 25,
    partitions: int = 3,
    in_feat: int = 3,
    num_classes: int = 52,
    in_ch=(64, 64, 64, 64, 128, 128, 128, 256, 256),
    out_ch=(64, 64, 64, 128, 128, 128, 256, 256, 256),
    residual=(1,) * 9,
) -> int:
    """MACs to advance the streaming RT-ST-GCN by one frame (the batch form
    does the same per frame)."""
    v, p = num_joints, partitions
    macs = v * in_feat * in_ch[0]  # fcn_in
    for cin, cout, res in zip(in_ch, out_ch, residual):
        macs += v * cin * cout * p  # partition-wise 1×1 conv
        macs += p * v * v * cout  # adjacency aggregation
        if res and cin != cout:
            macs += v * cin * cout  # residual 1×1
    macs += out_ch[-1] * num_classes  # fcn_out (after joint pool)
    return macs


def rt_stgcn_train_hbm_bytes_per_frame(
    num_joints: int = 25,
    partitions: int = 3,
    in_feat: int = 3,
    in_ch=(64, 64, 64, 64, 128, 128, 128, 256, 256),
    out_ch=(64, 64, 64, 128, 128, 128, 256, 256, 256),
    dtype_bytes: int = 2,
) -> float:
    """Device-memory bytes per frame of one fwd+bwd train step under a
    perfect-per-op-fusion model: per layer the aggregate reads x and writes
    the P-expanded intermediate, the channel matmul reads it back and
    writes y, the window-sum reads and writes, the norm reads twice and
    writes once, the residual reads x once more; the backward counts
    twice the forward. Parameter and optimizer traffic is per
    step, not per frame, and is left out."""
    v, p = num_joints, partitions
    bytes_fwd = v * (in_feat + in_ch[0])  # fcn_in read + write
    for cin, cout in zip(in_ch, out_ch):
        a_in, a_out = v * cin, v * cout
        bytes_fwd += (
            2 * a_in        # aggregate read x + residual read
            + 2 * p * a_in  # P-expanded intermediate write + read
            + a_out         # matmul write
            + 2 * a_out     # window-sum read + write
            + 3 * a_out     # norm stats read + normalize read + write
        )
    bytes_fwd += out_ch[-1]  # head read (post joint-pool)
    return bytes_fwd * dtype_bytes * 3.0
