"""Core ops of the port: norms, graph conv, the causal window-sum and the
fused RT-layer core. Each op with a hand-written CUDA kernel (``gcn_core``,
``window_sum``, ``rt_fused_core``) keeps its plain PyTorch version beside it
and counts its kernel's launches in a ``launches`` attribute."""
