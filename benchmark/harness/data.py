"""Inputs and weights made from ``--seed``, on the device, in a few large calls.

* :func:`trials`: unequal-length skeleton trials labelled frame by frame, the
  shape of PKU-MMD's untrimmed sequences (25 joints, 3 coordinates, action
  segments over 52 classes). Each action class drives the joints with its
  own frequency, gain and offset, plus noise (the motion model of the
  repository's synthetic data). The lengths are the same for every seed,
  spread evenly over the traffic's range and dealt in the seed's order, so
  that two seeds give the same work.
* :func:`stream_ring`: ``ring`` frames of ``streams`` live captures, one
  action each, staged on the device; step ``k`` serves frame ``k mod ring``.
* :func:`weights`: every parameter the reference names, drawn at once.

A seed is any whole number; each use draws from its own generator.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["generator", "trials", "stream_ring", "weights"]

_PURPOSES = {"trials": 1, "streams": 2, "weights": 3, "sample": 4}


def generator(seed: int, purpose: str, device) -> torch.Generator:
    """A generator on ``device`` for one use of the seed."""
    key = (int(seed) % (1 << 58)) * 16 + _PURPOSES[purpose]
    return torch.Generator(device=device).manual_seed(key)


def _signatures(classes: int, joints: int, feat: int, gen, device):
    u = torch.rand((classes, feat + 2 * joints * feat), generator=gen, device=device)
    freqs = 0.02 + 0.28 * u[:, :feat]
    gains = 0.5 + 1.5 * u[:, feat: feat + joints * feat].reshape(classes, joints, feat)
    offsets = 0.5 * torch.randn((classes, joints, feat), generator=gen, device=device)
    return freqs, gains, offsets


def _motion(t, cls, phase, sig, noise: float, gen):
    """Frames ``(len(t), V, C)``: the class of each frame drives its joints."""
    freqs, gains, offsets = sig
    wave = torch.sin(t[:, None, None] * freqs[cls][:, None, :] + phase[:, None, None])
    x = gains[cls] * wave + offsets[cls]
    return x + noise * torch.randn(x.shape, generator=gen, device=x.device)


def trials(traffic: dict, classes: int, joints: int, feat: int, seed: int, device):
    """``(dataset, class_dist)``: a list of ``(x (L, V, C) float32, labels (L,)
    int64)`` numpy trials in host memory, and the frames of each class."""
    gen = generator(seed, "trials", device)
    n, lo, hi = traffic["trials"], traffic["min_frames"], traffic["max_frames"]
    spread = np.rint(np.linspace(lo, hi, n)).astype(np.int64)
    lengths = spread[torch.randperm(n, generator=gen, device=device).cpu().numpy()]
    sig = _signatures(classes, joints, feat, gen, device)
    segs = traffic["segments"]
    xs, ys = [], []
    for length in lengths.tolist():
        cuts = torch.randperm(length - 1, generator=gen, device=device)[: segs - 1] + 1
        bounds = torch.sort(cuts).values
        seg = torch.bucketize(torch.arange(length, device=device), bounds, right=True)
        seg_cls = torch.randint(0, classes, (segs,), generator=gen, device=device)
        seg_phase = 2 * math.pi * torch.rand((segs,), generator=gen, device=device)
        t = torch.arange(length, device=device, dtype=torch.float32)
        xs.append(_motion(t, seg_cls[seg], seg_phase[seg], sig, traffic["noise"], gen))
        ys.append(seg_cls[seg])
    x_all = torch.cat(xs).cpu().numpy()
    y_all = torch.cat(ys).cpu().numpy().astype(np.int64)
    edges = np.cumsum(lengths)[:-1]
    dataset = list(zip(np.split(x_all, edges), np.split(y_all, edges)))
    class_dist = np.bincount(y_all, minlength=classes).astype(np.float32)
    return dataset, class_dist


def stream_ring(traffic: dict, classes: int, joints: int, feat: int, seed: int, device):
    """``(ring, streams, V, C)`` float32 frames on ``device``."""
    gen = generator(seed, "streams", device)
    b, ring = traffic["streams"], traffic["ring_frames"]
    sig = _signatures(classes, joints, feat, gen, device)
    cls = torch.randint(0, classes, (b,), generator=gen, device=device)
    phase = 2 * math.pi * torch.rand((b,), generator=gen, device=device)
    t = torch.arange(ring, device=device, dtype=torch.float32)
    # (ring, b): every stream's own class and phase at every frame
    x = _motion(t.repeat_interleave(b), cls.repeat(ring), phase.repeat(ring), sig,
                traffic["noise"], gen)
    return x.reshape(ring, b, joints, feat)


def _bound(name: str, shapes: dict) -> float:
    """Uniform init bound of a kernel or bias: 1/√fan_in, the fan-in being the
    values summed into one output of its kernel (all axes but the last)."""
    kernel = name[: -len("bias")] + "kernel" if name.endswith("bias") else name
    shape = shapes[kernel]
    return 1.0 / math.sqrt(math.prod(shape[:-1]))


def weights(shapes: dict, seed: int, device) -> dict:
    """Every parameter of ``shapes`` (name → shape) in fp32 on ``device``.

    Kernels and their biases are uniform within ±1/√fan_in; the norms'
    scales and the edge importances are 1 ± 0.1 and the norms' biases
    ±0.1, uniform, so that no parameter starts at a value that hides it."""
    gen = generator(seed, "weights", device)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.rand(total, generator=gen, device=device) * 2 - 1
    out, at = {}, 0
    for name, shape in shapes.items():
        u = flat[at: at + math.prod(shape)].reshape(shape)
        at += math.prod(shape)
        norm_leaf = "." in name and "norm" in name.split(".")[-2]
        if name.endswith("scale") or name == "edge_importance":
            out[name] = 1 + 0.1 * u
        elif norm_leaf:
            out[name] = 0.1 * u
        else:
            out[name] = _bound(name, shapes) * u
    return out
