"""RT-ST-GCN (Yudayev et al., "RT-ST-GCN: Enabling Realtime Continual
Inference at the Edge", MLSP 2024) in plain PyTorch fp32.

A layer is a partitioned graph conv, a causal sum over the last Γ frames at
the layer's tap spacing ``s`` (``Γ // s`` taps ``s`` frames apart; time is
never downsampled), norm, ReLU, the residual (the identity, or a bias-free
1×1 conv and its norm where the width or the spacing changes) and a ReLU.
The input is normalised per joint and mapped to the first width by a 1×1
conv; the head pools the joints and maps each frame to the classes.

BatchNorm takes the statistics of the batch it is given: a trial's frames
in the batch form; in the streaming form the current frame of every stream
served together (its FIFO cell normalises each frame over the streams).
"""

from __future__ import annotations

import torch

from .common import adjacency, causal_taps, graph_conv, norm

__all__ = ["param_shapes", "forward", "stream_logits", "history"]


def _arch(cfg):
    arch = cfg["arch"]
    sub = arch["rt-st-gcn"]
    return arch, sub


def _has_res(sub, i) -> bool:
    return bool(sub["residual"][i]) and (sub["in_ch"][i] != sub["out_ch"][i]
                                         or sub["stride"][i] != 1)


def param_shapes(cfg, num_classes: int) -> dict:
    """Every parameter's name and shape."""
    arch, sub = _arch(cfg)
    p, v, _ = adjacency(cfg["processor"]["graph"]).shape
    cin = arch["in_feat"]
    per_joint = (v, cin)
    shapes = {"edge_importance": (sub["layers"], p, v, v),
              "norm_in.scale": per_joint, "norm_in.bias": per_joint,
              "fcn_in.kernel": (cin, sub["in_ch"][0]), "fcn_in.bias": (sub["in_ch"][0],)}
    for i, (ci, co) in enumerate(zip(sub["in_ch"], sub["out_ch"])):
        ch = (v, co) if arch["normalization"] == "LayerNorm" else (co,)
        pre = f"layers.{i}."
        if _has_res(sub, i):
            shapes[pre + "res_kernel"] = (ci, co)
            shapes[pre + "res_norm.scale"] = shapes[pre + "res_norm.bias"] = ch
        shapes[pre + "gcn.kernel"] = (p, ci, co)
        shapes[pre + "gcn.bias"] = (p, co)
        shapes[pre + "norm.scale"] = shapes[pre + "norm.bias"] = ch
    shapes["fcn_out.kernel"] = (sub["out_ch"][-1], num_classes)
    shapes["fcn_out.bias"] = (num_classes,)
    return shapes


def history(cfg) -> int:
    """The frames before the current one that a streamed frame's logits
    depend on: every layer's taps reach ``(Γ//s − 1)·s`` frames back."""
    _, sub = _arch(cfg)
    gamma = sub["kernel"]
    return sum((gamma // s - 1) * s for s in sub["stride"])


def _layers(params, cfg, x, dims, valid: bool):
    arch, sub = _arch(cfg)
    kind = arch["normalization"]
    A = torch.as_tensor(adjacency(cfg["processor"]["graph"]), dtype=x.dtype, device=x.device)
    gamma = sub["kernel"]
    for i, s in enumerate(sub["stride"]):
        pre = f"layers.{i}."
        a = A * params["edge_importance"][i] if sub["importance"] else A
        y = graph_conv(x, a, params[pre + "gcn.kernel"], params[pre + "gcn.bias"])
        y = causal_taps(y, gamma // s, s, valid)
        x = x[:, x.shape[1] - y.shape[1]:]
        if not sub["residual"][i]:
            res = 0.0
        elif _has_res(sub, i):
            res = norm(kind, params, pre + "res_norm", x @ params[pre + "res_kernel"], dims)
        else:
            res = x
        x = torch.relu(norm(kind, params, pre + "norm", y, dims)) + res
        if sub["residual"][i]:
            x = torch.relu(x)
    return x.mean(dim=2) @ params["fcn_out.kernel"] + params["fcn_out.bias"]


def forward(params, cfg, x):
    """Per-frame logits ``(L, classes)`` of one trial ``(L, V, C_in)``."""
    kind = cfg["arch"]["normalization"]
    x = norm(kind, params, "norm_in", x[None], (0, 1))
    x = x @ params["fcn_in.kernel"] + params["fcn_in.bias"]
    return _layers(params, cfg, x, (0, 1, 2), valid=False)[0]


@torch.no_grad()
def stream_logits(params, cfg, frames):
    """The streaming cell's logits ``(B, classes)`` at the last of
    ``frames`` ``(B, T, V, C_in)``: B streams served together, each with its
    last ``T ≥ history(cfg) + 1`` frames, every norm's statistics over the
    streams' current frame."""
    kind = cfg["arch"]["normalization"]
    x = norm(kind, params, "norm_in", frames, (0,))
    x = x @ params["fcn_in.kernel"] + params["fcn_in.bias"]
    return _layers(params, cfg, x, (0, 2), valid=True)[:, -1]
