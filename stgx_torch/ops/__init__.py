"""Core ops of the port: norms, graph conv, the causal window-sum and the
fused RT-layer core. Each op with a hand-written CUDA kernel (``gcn_core``,
``window_sum``, ``rt_fused_core``, and the backward kernels ``gcn_grads``
and ``rt_fused_bwd``) keeps its plain PyTorch version beside it and counts
its kernel's launches in a ``launches`` attribute. The three forward ops are
``torch.autograd.Function``s whose backward runs kernels too."""
