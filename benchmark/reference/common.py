"""Plain PyTorch fp32 pieces shared by the benchmark's references.

What the models of the reference repository (github.com/maximyudayev/
Realtime-ST-GCN) compute, written out again from their description: the
skeleton's partitioned adjacency, the two norms, the partitioned graph
convolution, the segmentation loss and Adam. Tensors are channels-last
``(N, L, V, C)``; parameters are looked up by the names of the stgx
checkpoint format (``layers.3.gcn.kernel``), which is how the benchmark
hands one set of weights to the program and to the reference.

Imports torch and numpy only: nothing of the program under test and nothing
of JAX. Every product runs in fp32 with TF32 off (:func:`fp32_products`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["fp32_products", "adjacency", "layer_norm", "batch_norm", "graph_conv",
           "norm", "segmentation_loss", "adam_step", "class_weights", "causal_taps"]

# Kinect v2's 25 joints (PKU-MMD, NTU RGB+D); joint 20, the spine at the
# shoulders, is the centre the spatial partitions are taken from
_KINECT25 = (25, 20, [
    (0, 1), (1, 20), (2, 20), (3, 2), (4, 20), (5, 4), (6, 5), (7, 6),
    (8, 20), (9, 8), (10, 9), (11, 10), (12, 0), (13, 12), (14, 13), (15, 14),
    (16, 0), (17, 16), (18, 17), (19, 18), (21, 7), (22, 7), (23, 11), (24, 11)])
SKELETONS = {"pku-mmd": _KINECT25, "ntu-rgb+d": _KINECT25}


def fp32_products() -> None:
    """Matrix products in full fp32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def adjacency(graph: str, alpha: float = 1e-3) -> np.ndarray:
    """ST-GCN's spatial partitions (Yan et al. 2018) of one hop, each
    normalised as D^-1/2 A D^-1/2 with ``alpha`` added to the degrees, as
    ``(3, V, V)`` float64 indexed ``[p, v, w]``: ``y[w] = Σ_v x[v] A[p, v, w]``.

    Partition 0 is each joint itself; 1 the neighbours nearer the centre
    than the joint; 2 those farther from it (neighbours as far as the joint
    belong to neither)."""
    v, center, links = SKELETONS[graph]
    hops = np.full((v, v), np.inf)
    np.fill_diagonal(hops, 0.0)
    for i, j in links:
        hops[i, j] = hops[j, i] = 1.0
    for k in range(v):  # shortest hop counts
        hops = np.minimum(hops, hops[:, k:k + 1] + hops[k:k + 1, :])
    depth = hops[:, center]
    near = hops == 1.0
    parts = [np.eye(v),
             (near & (depth[None, :] < depth[:, None])).astype(np.float64),
             (near & (depth[None, :] > depth[:, None])).astype(np.float64)]
    out = []
    for a in parts:  # rows: the joint, columns: its neighbours
        d = (a.sum(axis=1) + alpha) ** -0.5
        out.append((d[:, None] * a * d[None, :]).T)
    return np.stack(out)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """Each frame of ``(N, L, V, C)`` normalised over its (V, C) values,
    with the unbiased variance (the reference's ``LayerNorm([C, 1, V])``)."""
    n = x.shape[-1] * x.shape[-2]
    mean = x.mean(dim=(-2, -1), keepdim=True)
    var = ((x - mean) ** 2).sum(dim=(-2, -1), keepdim=True) / (n - 1)
    return scale * (x - mean) / torch.sqrt(var + eps) + bias


def batch_norm(x, scale, bias, dims, eps: float = 1e-5):
    """Normalised by the statistics over ``dims`` of this very batch (no
    running statistics, in evaluation too), biased variance."""
    mean = x.mean(dim=dims, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=dims, keepdim=True)
    return scale * (x - mean) / torch.sqrt(var + eps) + bias


def norm(kind: str, params: dict, prefix: str, x, dims):
    """The config's norm with the parameters under ``prefix``: LayerNorm
    over each frame's (V, C), or BatchNorm over ``dims``."""
    scale, bias = params[prefix + ".scale"], params[prefix + ".bias"]
    if kind == "LayerNorm":
        return layer_norm(x, scale, bias)
    if kind == "BatchNorm":
        return batch_norm(x, scale, bias, dims)
    raise ValueError(f"unknown normalization {kind!r}")


def graph_conv(x, A, W, b):
    """``y[.., w, d] = Σ_p Σ_v A[p, v, w] (Σ_c x[.., v, c] W[p, c, d] + b[p, d])``:
    ST-GCN's 1×1 convolution to P·C_out channels (with its bias), then each
    partition's neighbourhood sum. The product that makes the smaller
    intermediate goes first."""
    if W.shape[1] <= W.shape[2]:
        agg = torch.einsum("...vc,pvw->...pwc", x, A)
        y = torch.einsum("...pwc,pcd->...wd", agg, W)
    else:
        xw = torch.einsum("...vc,pcd->...pvd", x, W)
        y = torch.einsum("...pvd,pvw->...wd", xw, A)
    return y + torch.einsum("pvw,pd->wd", A, b)


def class_weights(class_dist) -> torch.Tensor:
    """``1 − share_c``: each class weighted by one less its share of the frames."""
    d = torch.as_tensor(np.asarray(class_dist, dtype=np.float64))
    return (1.0 - d / d.sum()).float()


def segmentation_loss(logits, labels, weights):
    """``(ce, mse)`` of one trial's ``(L, classes)`` logits: the class-weighted
    mean of the frames' cross entropy, and 0.15 × the mean over frame pairs
    and classes of ``min((log p_t − log p_{t−1})², 16)`` with the earlier
    frame held constant (the reference's truncated smoothing loss)."""
    logp = torch.log_softmax(logits, dim=-1)
    w = weights[labels]
    ce = -(w * logp.gather(-1, labels[:, None])[:, 0]).sum() / w.sum()
    d = logp[1:] - logp[:-1].detach()
    mse = 0.15 * torch.clamp(d * d, max=16.0).mean()
    return ce, mse


def adam_step(params: dict, grads: dict, state: dict, lr: float,
              betas=(0.9, 0.999), eps: float = 1e-8) -> None:
    """One Adam update (Kingma and Ba, with bias correction) in place."""
    b1, b2 = betas
    state["t"] = t = state.get("t", 0) + 1
    for k, p in params.items():
        g = grads[k]
        m = state.setdefault("m." + k, torch.zeros_like(p))
        v = state.setdefault("v." + k, torch.zeros_like(p))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        denom = (v / (1 - b2 ** t)).sqrt_().add_(eps)
        p.sub_(lr / (1 - b1 ** t) * m / denom)


def causal_taps(x, taps: int, spacing: int, valid: bool = False):
    """``y[t] = Σ_{i<taps} x[t − i·spacing]`` over the frame axis 1, frames
    before the start zero; with ``valid`` only the outputs whose taps all
    lie inside ``x`` (``(taps − 1)·spacing`` fewer frames)."""
    span = (taps - 1) * spacing
    if not valid:
        x = F.pad(x, (0, 0, 0, 0, span, 0))
    length = x.shape[1] - span
    return sum(x[:, span - i * spacing: span - i * spacing + length] for i in range(taps))
