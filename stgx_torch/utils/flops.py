"""Analytic MACs, device-memory bytes and parameter counts — the port of
``stgx/utils/flops.py``. Pure arithmetic on the configuration (or, for
:func:`param_words`, on a model's parameters); the same numbers as the JAX
package's for the same arguments."""

from __future__ import annotations

__all__ = ["rt_stgcn_macs_per_frame", "costgcn_macs_per_frame", "stgcn_macs_per_window",
           "rt_stgcn_train_hbm_bytes_per_frame", "stgcn_train_hbm_bytes_per_window",
           "param_words"]


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


def costgcn_macs_per_frame(
    num_joints: int = 25,
    partitions: int = 3,
    in_feat: int = 3,
    num_classes: int = 52,
    kernel: int = 9,
    in_ch=(64, 64, 64, 64, 128, 128, 128, 256, 256),
    out_ch=(64, 64, 64, 128, 128, 128, 256, 256, 256),
    residual=(1,) * 9,
) -> int:
    """MACs to advance the continual CoST-GCN by one frame: RT-ST-GCN's
    per-frame cost plus a full Γ-tap temporal conv over each layer's FIFO
    (dilation stretches the FIFO, not the MAC count). The batch form does
    the same per frame."""
    v, p = num_joints, partitions
    macs = v * in_feat * in_ch[0]  # fcn_in
    for cin, cout, res in zip(in_ch, out_ch, residual):
        macs += v * cin * cout * p  # partition-wise 1×1 conv
        macs += p * v * v * cout  # adjacency aggregation
        macs += v * cout * cout * kernel  # Γ-tap temporal conv
        if res and cin != cout:
            macs += v * cin * cout  # residual 1×1
    macs += out_ch[-1] * num_classes  # per-frame head
    return macs


def stgcn_macs_per_window(
    window: int = 50,
    num_joints: int = 25,
    partitions: int = 3,
    in_feat: int = 3,
    num_classes: int = 52,
    kernel: int = 9,
    in_ch=(64, 64, 64, 64, 128, 128, 128, 256, 256),
    out_ch=(64, 64, 64, 128, 128, 128, 256, 256, 256),
    stride=(1, 1, 1, 2, 1, 1, 2, 1, 1),
    residual=(1,) * 9,
) -> int:
    """MACs of one ST-GCN window classification: per layer the partition-wise
    1×1 conv and the adjacency over the layer's input frames, the Γ-tap
    temporal conv and the strided residual 1×1 over its output frames."""
    v, p = num_joints, partitions
    l = window
    macs = l * v * in_feat * in_ch[0]
    for cin, cout, s, res in zip(in_ch, out_ch, stride, residual):
        macs += l * v * cin * cout * p  # gcn 1×1
        macs += l * p * v * v * cout  # adjacency
        lo = -(-l // s)
        macs += lo * v * cout * cout * kernel  # temporal conv
        if res and (cin != cout or s != 1):
            macs += lo * v * cin * cout
        l = lo
    macs += out_ch[-1] * num_classes
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


def stgcn_train_hbm_bytes_per_window(
    window: int = 50,
    num_joints: int = 25,
    partitions: int = 3,
    in_feat: int = 3,
    kernel: int = 9,
    in_ch=(64, 64, 64, 64, 128, 128, 128, 256, 256),
    out_ch=(64, 64, 64, 128, 128, 128, 256, 256, 256),
    stride=(1, 1, 1, 2, 1, 1, 2, 1, 1),
    residual=(1,) * 9,
    dtype_bytes: int = 2,
    bwd_factor: float = 2.0,
) -> float:
    """Device-memory bytes to train on one ST-GCN window under a
    perfect-per-op-fusion model, per layer: the aggregate reads x and
    writes the P-expanded intermediate, the channel matmul reads it back and
    writes the pre-TCN activation, a norm reads twice and writes once, the
    Γ-tap temporal conv reads its input once and writes L/s frames, the
    second norm likewise, and the residual reads x once (and writes where
    it is a 1×1 conv); the backward counts ``bwd_factor`` times the forward.
    With ``window=1, stride=(1,)*9`` it is CoST-GCN's bytes a frame (its
    continual layers keep every frame), as the JAX package's train bench
    counts them. ``kernel`` is accepted and unused, as in the JAX package:
    the taps reuse what one read brought in."""
    v, p = num_joints, partitions
    l = window
    words = l * v * (in_feat + in_ch[0])  # fcn_in read + write
    for cin, cout, s, res in zip(in_ch, out_ch, stride, residual):
        lo = -(-l // s)
        a_in = l * v * cin
        a_pre = l * v * cout  # post-gcn, pre-TCN (full length)
        a_out = lo * v * cout
        words += (
            a_in + p * a_in     # aggregate: read x, write P-expanded
            + p * a_in + a_pre  # matmul: read it back, write y
            + 3 * a_pre         # norm 1: stats read + normalize read/write
            + a_pre + a_out     # TCN: read once, write decimated
            + 3 * a_out         # norm 2: stats read + normalize read/write
        )
        if res:
            words += a_in       # residual read
            if cin != cout or s != 1:
                words += a_out  # 1×1-conv residual write
        l = lo
    words += l * v * out_ch[-1]  # joint-pool read for the head
    return words * dtype_bytes * (1.0 + bwd_factor)


def param_words(model) -> int:
    """Parameter count of a model (the reference table's "memory words")."""
    return sum(p.numel() for p in model.parameters())
