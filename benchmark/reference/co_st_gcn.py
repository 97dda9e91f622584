"""CoST-GCN (Hedegaard et al., "Continual Spatio-Temporal Graph
Convolutional Networks", Pattern Recognition 2023, arXiv:2203.11009) in
plain PyTorch fp32, as the RT-ST-GCN reference repository runs it.

A layer is ST-GCN's: partitioned graph conv, norm, ReLU, a Γ-tap temporal
convolution (with its bias) over the frame axis, norm, and the ReLU of the
sum with the residual (the identity, or a 1×1 conv with bias and its norm
where the width changes). The continual form makes the temporal conv
causal, dilated by the layer's stride entry instead of striding, and delays
the residual by Γ//2 frames so that both branches refer to one frame. The
input is normalised per frame and mapped to the first width by a 1×1 conv;
the head pools the joints and maps each frame to the classes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import adjacency, graph_conv, norm

__all__ = ["param_shapes", "forward"]


def _arch(cfg):
    arch = cfg["arch"]
    sub = arch.get("co-st-gcn", arch["st-gcn"])
    dilation = sub.get("dilation", sub["stride"])
    return arch, sub, dilation


def param_shapes(cfg, num_classes: int) -> dict:
    """Every parameter's name and shape."""
    arch, sub, _ = _arch(cfg)
    p, v, _ = adjacency(cfg["processor"]["graph"]).shape
    cin, gamma = arch["in_feat"], sub["kernel"]
    layer_norm = arch["normalization"] == "LayerNorm"
    shapes = {"edge_importance": (sub["layers"], p, v, v),
              "norm_in.scale": (v, cin), "norm_in.bias": (v, cin),
              "fcn_in.kernel": (cin, sub["in_ch"][0]), "fcn_in.bias": (sub["in_ch"][0],)}
    for i, (ci, co) in enumerate(zip(sub["in_ch"], sub["out_ch"])):
        ch = (v, co) if layer_norm else (co,)
        pre = f"layers.{i}."
        if sub["residual"][i] and ci != co:
            shapes[pre + "res_kernel"] = (ci, co)
            shapes[pre + "res_bias"] = (co,)
            shapes[pre + "res_norm.scale"] = shapes[pre + "res_norm.bias"] = ch
        shapes[pre + "gcn.kernel"] = (p, ci, co)
        shapes[pre + "gcn.bias"] = (p, co)
        shapes[pre + "norm.scale"] = shapes[pre + "norm.bias"] = ch
        shapes[pre + "tcn_kernel"] = (gamma, co, co)
        shapes[pre + "tcn_bias"] = (co,)
        shapes[pre + "tcn_norm.scale"] = shapes[pre + "tcn_norm.bias"] = ch
    shapes["fcn_out.kernel"] = (sub["out_ch"][-1], num_classes)
    shapes["fcn_out.bias"] = (num_classes,)
    return shapes


def _causal_conv(x, W, b, dilation: int):
    """``y[t] = b + Σ_j x[t − (Γ−1−j)·d] W[j]``, frames before the start zero."""
    gamma = W.shape[0]
    span = (gamma - 1) * dilation
    xp = F.pad(x, (0, 0, 0, 0, span, 0))
    length = x.shape[1]
    y = b
    for j in range(gamma):
        y = y + xp[:, j * dilation: j * dilation + length] @ W[j]
    return y


def forward(params, cfg, x):
    """Per-frame logits ``(L, classes)`` of one trial ``(L, V, C_in)``."""
    arch, sub, dilation = _arch(cfg)
    kind = arch["normalization"]
    dims = (0, 1, 2)
    A = torch.as_tensor(adjacency(cfg["processor"]["graph"]), dtype=x.dtype, device=x.device)
    delay = sub["kernel"] // 2
    x = norm(kind, params, "norm_in", x[None], (0, 1))
    x = x @ params["fcn_in.kernel"] + params["fcn_in.bias"]
    for i, d in enumerate(dilation):
        pre = f"layers.{i}."
        if not sub["residual"][i]:
            res = 0.0
        else:
            if sub["in_ch"][i] != sub["out_ch"][i]:
                res = norm(kind, params, pre + "res_norm",
                           x @ params[pre + "res_kernel"] + params[pre + "res_bias"], dims)
            else:
                res = x
            res = F.pad(res, (0, 0, 0, 0, delay, 0))[:, : x.shape[1]]
        a = A * params["edge_importance"][i] if sub["importance"] else A
        y = graph_conv(x, a, params[pre + "gcn.kernel"], params[pre + "gcn.bias"])
        y = torch.relu(norm(kind, params, pre + "norm", y, dims))
        y = _causal_conv(y, params[pre + "tcn_kernel"], params[pre + "tcn_bias"], d)
        x = torch.relu(norm(kind, params, pre + "tcn_norm", y, dims) + res)
    return (x.mean(dim=2) @ params["fcn_out.kernel"] + params["fcn_out.bias"])[0]
