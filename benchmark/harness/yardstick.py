"""The benchmark's frozen arithmetic: the card's peaks, the models' MACs a
frame and the least bytes and operations of the graph-conv work.

Copied from the program (``stgx_torch/utils/flops.py``'s MAC counts, and
``stgx_torch/bench/traffic_audit.py::kernel_traffic`` rewritten on shapes)
and frozen here, so that a change to the program cannot change the
yardstick; ``benchmark/tests`` holds the copies equal to today's originals.

Peaks of one H100 SXM (NVIDIA's data sheet, dense, at its 700 W limit):
3.35 TB/s of HBM; 67 TFLOP/s of fp32 outside the tensor cores, the peak
of the cells' compute type with TF32 off, which ``mfu.*`` divides by; and
495 TFLOP/s of TF32, of which the fastest route that keeps fp32's accuracy
(each operand split in two TF32 halves, three products) gets a third: a
roofline's operations are timed at that rate, so that no fp32-accurate
kernel can pass its roofline.
"""

from __future__ import annotations

__all__ = ["HBM_BYTES_S", "FP32_FLOP_S", "FP32_PRODUCT_FLOP_S", "FP32_ADD_S",
           "macs_per_frame", "gcn_core_traffic", "gcn_grads_traffic", "window_adds",
           "window_sum_traffic", "least_seconds", "layer_shapes", "gcn_parts"]

HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12  # fp32 FMAs, two operations each
FP32_PRODUCT_FLOP_S = 495e12 / 3  # three TF32 passes a product: fp32's accuracy
FP32_ADD_S = 33.5e12  # fp32 adds, one operation each


def layer_shapes(cfg: dict):
    """``(family, layers)``: per layer ``(C_in, C_out, taps, spacing,
    residual)`` of the configuration; the taps and spacing are the window
    sum's (``Γ // s``, ``s``) for RT-ST-GCN and the temporal conv's ``(Γ,
    dilation)`` for CoST-GCN."""
    family = cfg["processor"]["model"]
    arch = cfg["arch"]
    if family == "rt-st-gcn":
        sub = arch["rt-st-gcn"]
        spacing = sub["stride"]
        taps = [sub["kernel"] // s for s in spacing]
    elif family == "co-st-gcn":
        sub = arch.get("co-st-gcn", arch["st-gcn"])
        spacing = sub.get("dilation", sub["stride"])
        taps = [sub["kernel"]] * len(spacing)
    else:
        raise ValueError(f"no frozen arithmetic for {family!r}")
    return family, list(zip(sub["in_ch"], sub["out_ch"], taps, spacing, sub["residual"]))


def macs_per_frame(cfg: dict, num_classes: int, joints: int = 25, partitions: int = 3) -> int:
    """MACs to advance the model by one frame (the batch form does the same
    a frame): ``utils/flops.py``'s ``rt_stgcn_macs_per_frame`` and
    ``costgcn_macs_per_frame``."""
    family, layers = layer_shapes(cfg)
    v, p = joints, partitions
    macs = v * cfg["arch"]["in_feat"] * layers[0][0]  # fcn_in
    for cin, cout, taps, _, res in layers:
        macs += v * cin * cout * p  # partition-wise 1×1 conv
        macs += p * v * v * cout  # adjacency aggregation
        if family == "co-st-gcn":
            macs += v * cout * cout * taps  # Γ-tap temporal conv
        if res and cin != cout:
            macs += v * cin * cout  # residual 1×1
    return macs + layers[-1][1] * num_classes  # fcn_out after the joint pool


def gcn_core_traffic(rows: int, v: int, p: int, cin: int, cout: int, isz: int = 4):
    """``(read, write, operations)`` of the graph-conv core ``y = Σ_p A_pᵀ x W_p``
    over ``rows`` rows of V joints: x and the weights read once, y written
    once, a multiply-add two operations."""
    weights = p * v * v + p * cin * cout
    return (isz * (rows * v * cin + weights), isz * rows * v * cout,
            2 * rows * v * p * cin * (v + cout))


def gcn_grads_traffic(rows: int, v: int, p: int, cin: int, cout: int, isz: int = 4):
    """The same for the core's parameter gradients gA and gW (fp32) from x
    and the upstream gradient g."""
    weights = p * v * v + p * cin * cout
    return (isz * (rows * v * (cin + cout) + weights), 4 * weights,
            4 * rows * p * v * cin * (v + cout))


def window_adds(n: int, l: int, q: int, k: int, s: int) -> int:
    """Adds of a causal window sum of ``k`` taps ``s`` apart over ``(n, l, q)``:
    each output's taps inside the sequence, less one."""
    full = max(l - (k - 1) * s, 0)  # outputs whose taps all lie inside
    head = sum(min(k, t // s + 1) - 1 for t in range(min(l, (k - 1) * s)))
    return n * q * (head + full * (k - 1))


def window_sum_traffic(n: int, l: int, q: int, k: int, s: int, isz: int = 4):
    """``(read, write, adds)`` of the causal window sum over ``(n, l, q)``."""
    b = n * l * q * isz
    return b, b, window_adds(n, l, q, k, s)


def least_seconds(parts) -> float:
    """The least time of ``(read, write, products, adds)`` parts: each part's
    larger of its bytes at HBM's rate and its operations at the peak of
    their kind, summed."""
    return sum(max((r + w) / HBM_BYTES_S, prod / FP32_PRODUCT_FLOP_S + add / FP32_ADD_S)
               for r, w, prod, add in parts)


def gcn_parts(cfg: dict, lengths, train: bool, window: bool,
              joints: int = 25, partitions: int = 3) -> list:
    """The ``(read, write, products, adds)`` parts of the graph-conv layers'
    work over sequences of ``lengths`` frames (rows): every layer's core; in
    training its input gradient (the core on the transposed shapes) and its
    parameter gradients; with ``window`` RT-ST-GCN's window sums (and in
    training their reverse sums of the gradient)."""
    family, layers = layer_shapes(cfg)
    v, p = joints, partitions
    parts = []
    for l in lengths:
        for cin, cout, taps, s, _ in layers:
            r, w, ops = gcn_core_traffic(l, v, p, cin, cout)
            parts.append((r, w, ops, 0))
            if train:
                r, w, ops = gcn_core_traffic(l, v, p, cout, cin)
                parts.append((r, w, ops, 0))
                r, w, ops = gcn_grads_traffic(l, v, p, cin, cout)
                parts.append((r, w, ops, 0))
            if window and family == "rt-st-gcn" and taps > 1:
                r, w, adds = window_sum_traffic(1, l, v * cout, taps, s)
                parts += [(r, w, 0, adds)] * (2 if train else 1)
    return parts
