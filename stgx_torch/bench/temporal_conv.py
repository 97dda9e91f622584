"""The two routes of CoST-GCN's temporal conv on the card — the
measurement behind :func:`stgx_torch.ops.temporal.conv_route`.

One causal temporal conv of 256 channels over 8 x 1024 frames of 25
joints, the shape of CoST-GCN's widest layers in a train step, through
cuDNN's convolution (``F.conv2d``) and through the taps (one matrix product
a tap), at Γ in {9, 17, 33, 69}, dilation 1 and 4, fp32 and bf16, under
:func:`stgx_torch.strict_numerics` (TF32 off, cuDNN's deterministic
algorithms, as every entry point runs). Each figure is the wall time of one
call after a warm one, synchronised: the forward, and the forward and
backward.

Run (on the card):
    python -m stgx_torch.bench.temporal_conv

Prints one JSON line a case. cuDNN's cases past a dilated span of 17
frames take seconds each; the whole run takes about a minute.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
import torch.nn.functional as F

from stgx_torch import strict_numerics
from stgx_torch.ops.temporal import conv_product, conv_route

__all__ = ["measure", "main"]

SHAPE = (8, 1024, 25, 256)  # N, L, V, C
GAMMAS, DILATIONS = (9, 17, 33, 69), (1, 4)


def _wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def measure(gamma: int, dilation: int, dtype, route: str, seed: int = 0) -> dict:
    """``{"forward_ms", "forward_backward_ms"}`` of one causal temporal conv
    at SHAPE by ``route``."""
    n, l, v, c = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, l, v, c, generator=gen, device="cuda").to(dtype).requires_grad_()
    W = (torch.randn(gamma, c, c, generator=gen, device="cuda")
         * (c * gamma) ** -0.5).to(dtype).requires_grad_()
    g = torch.randn(n, l, v, c, generator=gen, device="cuda").to(dtype)

    def forward():
        xp = F.pad(x, (0, 0, 0, 0, (gamma - 1) * dilation, 0))
        return conv_product(xp, W, 1, dilation, route)

    def forward_backward():
        x.grad = W.grad = None
        forward().backward(g)

    forward_backward()
    return {"forward_ms": _wall_ms(forward), "forward_backward_ms": _wall_ms(forward_backward)}


def main(argv=None) -> list:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the temporal conv's routes are a device measurement; no CUDA "
                           "device is available")
    strict_numerics()
    records = []
    for dtype in (torch.bfloat16, torch.float32):
        for gamma in GAMMAS:
            for dilation in DILATIONS:
                rec = {"dtype": str(dtype)[6:], "gamma": gamma, "dilation": dilation,
                       "shape": SHAPE, "route": conv_route("cuda", dtype, gamma, dilation),
                       "device": torch.cuda.get_device_name(0)}
                for route in ("taps", "cudnn"):
                    rec[route] = measure(gamma, dilation, dtype, route)
                print(json.dumps(rec), flush=True)
                records.append(rec)
    return records


if __name__ == "__main__":
    main()
