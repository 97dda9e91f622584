"""Host-side rules and numerics of the tensor-core graph-conv kernels.

``csrc/gcn_core.cu`` and ``csrc/gcn_grads.cu`` run on the card only; what
they compute is held against the plain versions there by chip_smoke.py.
Here, on the CPU:

* the wrappers' host rules: the tile ``core_tile`` picks (narrow for the
  streaming cell's few rows, else the wide tile that covers C_out) and the
  row splits ``gcn_grads_splits`` gives each kernel;
* the numerics of the two routes, emulated in PyTorch at a small width:
  the fp32 route's three-pass TF32 split (``cvt.rna.tf32.f32``: round to
  10 mantissa bits, ties away from zero) over gcn_core's two contractions
  is held within TOL_FP32 of float64, as the card's fp32 checks hold the
  kernel, while plain one-pass TF32 is not; the bf16 route's hi + lo split
  of an fp32 intermediate keeps gcn_grads within TOL_FP32 of its plain
  version, while one bf16 rounding of it would not.
"""

import numpy as np
import pytest
import torch

from stgx_torch.ops.gcn_core import CORE_TILES, SMS, core_tile, gcn_core_plain
from stgx_torch.ops.gcn_grads import gcn_grads_plain, gcn_grads_splits

TOL_FP32 = 1e-4  # chip_smoke.py's kernel-vs-plain tolerance for fp32 outputs


def tf32(x):
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: 10 mantissa
    bits, to nearest, ties away from zero (on the magnitude bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def prod3(eq, a, b):
    """The fp32 route's product: lo·hi + hi·lo + hi·hi, summed in fp32."""
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    return torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl) + torch.einsum(eq, ah, bh)


def split_bf16(x):
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _rel(got, ref):
    return (got.double() - ref).abs().max().item() / max(1.0, ref.abs().max().item())


def _inputs(seed, r, v, p, cin, cout):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.normal(size=(r, v, cin)), dtype=torch.float32)
    A = torch.tensor(rng.uniform(size=(p, v, v)), dtype=torch.float32)
    W = torch.tensor(rng.normal(size=(p, cin, cout)) * cin**-0.5, dtype=torch.float32)
    g = torch.tensor(rng.normal(size=(r, v, cout)), dtype=torch.float32)
    return x, A, W, g


@pytest.mark.parametrize("rows,cout,tile", [
    (4096, 256, 0), (4096, 128, 1), (4096, 64, 2), (8192, 300, 0),  # batch form, gx
    (1, 64, 3), (1, 256, 3), (64, 64, 3), (64, 256, 3),  # the streaming cell
    (262, 256, 3), (263, 256, 0), (524, 64, 3), (525, 64, 2),  # the edge: one block an SM
])
def test_core_tile_narrow_only_for_few_rows(rows, cout, tile):
    assert core_tile(rows, cout) == tile
    if tile != len(CORE_TILES) - 1:
        nr, bn = CORE_TILES[tile]
        assert bn >= min(cout, 256)  # one block forms the aggregate for all its columns
        assert -(-rows // nr) * -(-cout // bn) >= SMS


def test_core_tile_covers_every_row():
    for rows in (1, 2, 5, 37, 1000, 4097):
        for cout in (1, 52, 64, 65, 128, 129, 256, 257):
            nr, bn = CORE_TILES[core_tile(rows, cout)]
            assert nr * -(-rows // nr) >= rows and bn * -(-cout // bn) >= cout


@pytest.mark.parametrize("rows,p,cin,cout", [
    (8192, 3, 64, 64), (8192, 3, 256, 256), (8192, 3, 128, 256), (8192, 4, 256, 256),
    (1, 3, 64, 64), (1000, 3, 3, 52), (37, 4, 40, 24), (8192, 3, 2048, 2048)])
def test_gcn_grads_splits_one_round(rows, p, cin, cout):
    """Each kernel launches at most one block an SM (its shared memory
    takes most of one), at least one split, never more splits than rows."""
    groups = -(-p // 3)
    tiles_w = groups * -(-cin // 64) * -(-cout // (64 if cout <= 64 else 128))
    tiles_a = groups * -(-cin // 32)
    for splits, tiles in zip(gcn_grads_splits(rows, p, cin, cout), (tiles_w, tiles_a)):
        assert 1 <= splits <= rows
        assert splits * tiles <= SMS or splits == 1
        assert splits == 1 or (splits + 1) * tiles > SMS or splits == rows


def test_tf32_split_keeps_fp32():
    x = torch.tensor(np.random.default_rng(1).normal(size=4096) * 10.0 ** np.arange(-4, 4).repeat(512),
                     dtype=torch.float32)
    hi, lo = split_tf32(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()  # 10 mantissa bits
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    assert ((hi - x).abs() <= x.abs() * 2.0**-11).all()
    resid = (x.double() - hi.double() - lo.double()).abs()
    assert (resid <= x.double().abs() * 2.0**-22).all()
    # ties go away from zero, as cvt.rna does
    assert tf32(torch.tensor([1 + 2.0**-11, -(1 + 2.0**-11)])).tolist() == [1 + 2.0**-10,
                                                                             -(1 + 2.0**-10)]


@pytest.mark.parametrize("r,v,p,cin,cout", [(16, 25, 3, 64, 64), (8, 25, 3, 256, 256),
                                            (4, 7, 2, 40, 24)])
def test_gcn_core_three_pass_tf32_within_fp32_tolerance(r, v, p, cin, cout):
    """gcn_core's fp32 route, emulated: T = xᵀA_p in three TF32 passes, kept
    in fp32, then T·W_p in three passes. Within TOL_FP32 of float64 (as
    close as the plain fp32 version, within a few times); one TF32 pass on
    each product is not."""
    x, A, W, _ = _inputs(r + cin, r, v, p, cin, cout)
    ref = torch.einsum("rvc,pvw,pcd->rwd", x.double(), A.double(), W.double())
    y3 = prod3("prwc,pcd->rwd", prod3("rvc,pvw->prwc", x, A), W)
    y1 = torch.einsum("prwc,pcd->rwd", tf32(torch.einsum("rvc,pvw->prwc", tf32(x), tf32(A))),
                      tf32(W))
    plain = _rel(gcn_core_plain(x, A, W), ref)
    assert _rel(y3, ref) <= min(TOL_FP32, 10 * plain + 1e-6)
    assert _rel(y1, ref) > TOL_FP32


def test_gcn_grads_bf16_route_keeps_intermediates():
    """gcn_grads' bf16 route, emulated: the products of bf16 inputs are
    exact and sum in fp32; T_p and U_p enter the second products as bf16
    hi + lo. Both gradients stay within TOL_FP32 of the plain version on
    the same bf16 inputs; one bf16 rounding of T_p and U_p would not."""
    x, A, W, g = (t.bfloat16().float() for t in _inputs(5, 64, 25, 3, 64, 96))
    ref_a, ref_w = (t.double() for t in gcn_grads_plain(x, g, A, W))

    def grads(cast):
        T = torch.einsum("rvc,pvw->prwc", x, A)
        U = torch.einsum("rwd,pcd->prwc", g, W)
        gW = sum(torch.einsum("prwc,rwd->pcd", part, g) for part in cast(T))
        gA = sum(torch.einsum("rvc,prwc->pvw", x, part) for part in cast(U))
        return gA, gW

    for got, ref in zip(grads(split_bf16), (ref_a, ref_w)):
        assert _rel(got, ref) <= TOL_FP32 / 10
    rounded = grads(lambda t: (t.bfloat16().float(),))
    assert max(_rel(got, ref) for got, ref in zip(rounded, (ref_a, ref_w))) > TOL_FP32
