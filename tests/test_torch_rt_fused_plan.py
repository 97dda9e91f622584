"""Host-side plans and the schedule of the fused RT-ST-GCN layer kernels.

``csrc/rt_fused.cu`` and ``csrc/rt_fused_bwd.cu`` run on the card only;
chip_smoke.py holds them against their plain versions there. Their
schedule:

    forward:  z = gcn(x) + beff in gcn_core's row tiles, into a workspace;
              y[t] = Σ_{j<K} z[t − j·s], zeros before t = 0;
    backward: gy[t] = Σ_{j<K} g[t + j·s], zeros past the end, into a
              workspace; gW and gbe as partials over gcn_grads' gW row
              splits, gA over its gA splits, of (x, gy), added in split
              order; gx = Σ_p A_p·(gy·W_pᵀ), the partition groups' slices
              added in group order.

Here, on the CPU:

* the host's plans: the forward's row tiles (gcn_core's, ``core_tile``) and
  the backward's row splits (``gcn_grads_splits``) cover every frame exactly once,
  fill the card at the main path's shapes, and each kernel's shared memory
  fits in the 227 KB a block may take for every halo the dispatch rule
  admits (no kernel keeps a ring of frames: the window passes go through
  workspaces);
* a replay of that schedule with plain ops equals ``rt_fused_plain`` and
  ``rt_fused_bwd_plain`` for ragged L, s ∈ {1, 2}, L shorter than the
  halo, and the longest halo the dispatch rule admits; tolerance 1e-6 of
  max(1, max|ref|), the plain version's own fp32 rounding (the replay runs
  in float64);
* the bf16 route's hi + lo parts of gy: the backward's fp32 gradients stay
  within chip_smoke.py's fp32 tolerance of the plain version, where one
  bf16 rounding of gy would not.
"""

import numpy as np
import pytest
import torch

from stgx_torch.ops.gcn_core import CORE_TILES, SMS, core_tile, gcn_core_plain
from stgx_torch.ops.gcn_grads import gcn_grads_plain, gcn_grads_splits
from stgx_torch.ops.rt_fused import _tile_t, rt_fused_bwd_plain, rt_fused_plain, workspace_floats
from stgx_torch.ops.window_sum import window_sum_plain

TOL = 1e-6
TOL_FP32 = 1e-4  # chip_smoke.py's kernel-vs-plain tolerance for fp32 outputs
SMEM_BLOCK = 232448  # shared memory a block may take (csrc/common.cuh: kMaxSmem)

# (C_in, C_out, stride) of RT-ST-GCN₉'s layers (configs/pku-mmd/as_is/rtstgcn.json)
LAYERS = [(64, 64, 1)] * 3 + [(64, 128, 2), (128, 128, 1), (128, 128, 1), (128, 256, 2),
                              (256, 256, 1), (256, 256, 1)]
# chip_smoke.py's ragged shapes: (N, L, V, P, C_in, C_out, Γ, s)
RAGGED = [(2, 45, 7, 4, 3, 52, 9, 1), (2, 45, 7, 4, 3, 300, 9, 2), (3, 5, 25, 3, 64, 64, 9, 1),
          (2, 200, 25, 3, 64, 64, 65, 1), (1, 100, 25, 3, 256, 256, 33, 1)]
MAIN = [(4, 1024), (8, 1024)]  # (N, L): the batch forward, the train step


def _admitted_halos(cin, cout):
    """Every halo (K−1)·s the dispatch rule sends to the kernels."""
    limit = min(_tile_t(cin, cout, True), _tile_t(cin, cout, False))
    return sorted({max(s, (gamma // s - 1) * s) for s in (1, 2) for gamma in range(2 * s, 200)
                   if max(s, (gamma // s - 1) * s) <= limit})


def _pad_mk(n, itemsize):
    return -(-n // 8) * 8 + 4 if itemsize == 4 else -(-n // 16) * 16 + 8


def _pad_kn(n):
    return -(-n // 16) * 16 + 8


def fwd_smem(dtype, tile, p):
    """Bytes of shared memory of the forward's graph-conv pass: gcn_core's
    (``csrc/gcn_core.cuh``: FmaSmem, MmaSmem)."""
    nr, bn = CORE_TILES[tile]
    if dtype == torch.float32:
        bm = 64 if tile in (0, 3) else 128
        return 4 * (p * 32 * 32 + 2 * (bm + 64) * 16 + 16 * bm + 2 * 16 * bn)
    bm = 32 * nr
    return 2 * (p * 32 * _pad_mk(32, 2) + 2 * bm * _pad_kn(64) + 2 * 64 * _pad_kn(bn)
                + bm * _pad_mk(64, 2))


def bwd_smem(dtype, cout):
    """Bytes of shared memory of the backward's gW and gA kernels
    (``csrc/gcn_grads.cuh``: GwSmem, GaSmem with gx, gy in GS parts)."""
    it = 4 if dtype == torch.float32 else 2
    gs = 1 if dtype == torch.float32 else 2
    bd = 64 if cout <= 64 else 128
    gw = it * (3 * 32 * _pad_mk(32, it) + 2 * 64 * _pad_kn(64) + 2 * gs * 64 * _pad_kn(bd)
               + (1 if it == 4 else 2) * 3 * 64 * _pad_kn(64))
    kd = 64 // it
    ldu = _pad_mk(32, 4) if it == 4 else 40
    ga = (it * (3 * 32 * _pad_mk(256, it) + 2 * gs * 128 * _pad_mk(kd, it)
                + 2 * 128 * _pad_mk(32, it) + 3 * 32 * _pad_mk(32, it))
          + 4 * 3 * 128 * ldu)
    return gw, ga


def _splits(rows, splits):
    per = -(-rows // splits)
    return [(s * per, min((s + 1) * per, rows)) for s in range(splits)]


# ---------------------------------------------------------------- the plans


@pytest.mark.parametrize("n,l,cout", [(4, 1024, 64), (4, 1024, 256), (8, 1024, 128),
                                      (2, 45, 52), (2, 45, 300), (3, 5, 64), (1, 1, 64)])
def test_forward_tiles_cover_every_frame_once(n, l, cout):
    rows = n * l
    for v in (25, 7):
        nr, bn = CORE_TILES[core_tile(rows, cout)]
        for dtype in (torch.float32, torch.bfloat16):
            # fp32 tiles take 32·NR dense rows m (the narrow one 64), bf16
            # tiles NR input rows with their joints padded to 32
            step = nr if dtype == torch.bfloat16 else (64 if nr == 1 else 32 * nr)
            count = torch.zeros(rows * v if dtype == torch.float32 else rows, dtype=torch.int64)
            for b in range(-(-count.numel() // step)):
                count[b * step:(b + 1) * step] += 1
            assert bool((count == 1).all())
        assert bn * -(-cout // bn) >= cout


@pytest.mark.parametrize("rows,v,p,cin,cout", [
    (8192, 25, 3, 64, 64), (8192, 25, 3, 256, 256), (90, 7, 4, 3, 52), (90, 7, 4, 3, 300),
    (15, 25, 3, 64, 64), (1, 25, 3, 64, 64)])
def test_backward_splits_cover_every_frame_once(rows, v, p, cin, cout):
    for splits in gcn_grads_splits(rows, p, cin, cout):
        assert 1 <= splits <= max(1, rows)
        count = torch.zeros(rows, dtype=torch.int64)
        for a, b in _splits(rows, splits):
            count[a:b] += 1
        assert bool((count == 1).all())


@pytest.mark.parametrize("cin,cout,stride", sorted(set(LAYERS)) + [(3, 52, 1), (3, 300, 2),
                                                                    (40, 24, 1)])
@pytest.mark.parametrize("p", [3, 4])
def test_shared_memory_fits_for_every_admitted_halo(cin, cout, stride, p):
    """No ring of frames: the kernels' shared memory does not grow with the
    halo, and fits in a block's 227 KB at every width, for each halo the
    dispatch rule admits (the window passes go through workspaces)."""
    halos = _admitted_halos(cin, cout)
    assert halos and max(halos) == (64 if max(cin, cout) <= 128 else 32)
    for dtype in (torch.float32, torch.bfloat16):
        for tile in range(len(CORE_TILES)):
            assert fwd_smem(dtype, tile, p) <= SMEM_BLOCK
        assert max(bwd_smem(dtype, cout)) <= SMEM_BLOCK
    assert workspace_floats(7) == 8 and workspace_floats(16) == 16


@pytest.mark.parametrize("n,l", MAIN)
def test_grids_fill_the_card_at_the_main_path_shapes(n, l):
    rows = n * l
    for cin, cout, _ in LAYERS:
        nr, bn = CORE_TILES[core_tile(rows, cout)]
        ct = -(-cout // bn)
        assert ct == 1  # one column tile: the aggregate formed once a row
        assert -(-rows // nr) * ct >= SMS and -(-rows * 25 // (32 * nr)) * ct >= SMS
        splits_w, splits_a = gcn_grads_splits(rows, 3, cin, cout)
        gw = -(-cin // 64) * -(-cout // (64 if cout <= 64 else 128)) * splits_w
        ga = -(-cin // 32) * splits_a
        assert gw <= SMS and ga <= SMS  # one round of one block an SM
        assert gw >= SMS // 2 and ga >= SMS // 2
        assert rows >= SMS  # the window passes: one block a row


# ------------------------------------------------------------ the schedule


def _inputs(seed, n, l, v, p, cin, cout):
    rng = np.random.default_rng(seed)
    x = torch.tensor(np.maximum(rng.normal(size=(n, l, v, cin)), 0), dtype=torch.float32)
    A = torch.tensor(rng.uniform(size=(p, v, v)), dtype=torch.float32)
    W = torch.tensor(rng.normal(size=(p, cin, cout)) * cin**-0.5, dtype=torch.float32)
    beff = torch.tensor(rng.normal(size=(v, cout)) * 0.1, dtype=torch.float32)
    g = torch.tensor(rng.normal(size=(n, l, v, cout)), dtype=torch.float32)
    return x, A, W, beff, g


def replay_forward(x, A, W, beff, gamma, stride):
    """rt_fused.cu's two passes: z = gcn(x) + beff, then its causal window."""
    n, l, v, cin = x.shape
    z = gcn_core_plain(x.reshape(n * l, v, cin), A, W).reshape(n, l, v, -1) + beff
    k = gamma // stride
    y = z.clone()
    for t in range(l):
        for j in range(1, min(k, t // stride + 1)):
            y[:, t] += z[:, t - j * stride]
    return y


def replay_backward(x, g, A, W, gamma, stride):
    """rt_fused_bwd.cu's passes: gy; gW and gbe as partials over the gW
    splits, gA over the gA splits, added in split order; each partition
    group's gx slice
    Σ_p A_p·(gy·W_pᵀ), the slices added in group order."""
    n, l, v, cin = x.shape
    p, _, cout = W.shape
    rows = n * l
    gy = window_sum_plain(g, gamma, stride, reverse=True).reshape(rows, v, cout)
    xr = x.reshape(rows, v, cin)
    splits_w, splits_a = gcn_grads_splits(rows, p, cin, cout)

    def in_order(parts):
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        return total

    gbe = in_order([gy[a:b].sum(0) for a, b in _splits(rows, splits_w)])
    gW = in_order([gcn_grads_plain(xr[a:b], gy[a:b], A, W)[1] for a, b in _splits(rows, splits_w)])
    gA = in_order([gcn_grads_plain(xr[a:b], gy[a:b], A, W)[0] for a, b in _splits(rows, splits_a)])
    gx = in_order([gcn_core_plain(gy, A[q:q + 3].transpose(1, 2), W[q:q + 3].transpose(1, 2))
                   for q in range(0, p, 3)])
    return gx.reshape(n, l, v, cin), gA, gW, gbe


def _close(got, ref, tol=TOL):
    err = (got.double() - ref.double()).abs().max().item()
    assert err <= tol * max(1.0, ref.abs().max().item()), err


@pytest.mark.parametrize("n,l,v,p,cin,cout,gamma,stride", RAGGED + [
    (2, 40, 25, 3, 16, 24, 9, 1), (1, 70, 11, 2, 6, 8, 9, 2), (2, 3, 5, 2, 4, 6, 9, 2)])
def test_replay_of_the_forward_equals_the_plain_version(n, l, v, p, cin, cout, gamma, stride):
    x, A, W, beff, _ = _inputs(l + cout, n, l, v, p, cin, cout)
    _close(replay_forward(*(t.double() for t in (x, A, W, beff)), gamma, stride),
           rt_fused_plain(x, A, W, beff, gamma, stride))


@pytest.mark.parametrize("n,l,v,p,cin,cout,gamma,stride", RAGGED + [
    (2, 40, 25, 3, 16, 24, 9, 1), (1, 70, 11, 2, 6, 8, 9, 2), (2, 3, 5, 2, 4, 6, 9, 2)])
def test_replay_of_the_backward_equals_the_plain_version(n, l, v, p, cin, cout, gamma, stride):
    x, A, W, _, g = _inputs(7 + l, n, l, v, p, cin, cout)
    for got, ref in zip(replay_backward(*(t.double() for t in (x, g, A, W)), gamma, stride),
                        rt_fused_bwd_plain(x, g, A, W, gamma, stride)):
        _close(got, ref)


def test_bf16_route_keeps_the_window_sum_of_g():
    """The backward's bf16 route, emulated: gy (a sum of bf16 values, in
    fp32) enters the products as bf16 hi + lo; x, A and W are bf16 and
    exact. gA and gW stay within TOL_FP32 of the plain version on the same
    bf16 inputs; gy rounded to one bf16 would not."""
    x, A, W, _, g = (t.bfloat16().float() for t in _inputs(3, 2, 64, 25, 3, 64, 96))
    n, l, v, cin = x.shape
    rows, cout = n * l, W.shape[-1]
    _, gA, gW, _ = rt_fused_bwd_plain(x, g, A, W, 9, 1)
    gy = window_sum_plain(g, 9, 1, reverse=True).reshape(rows, v, cout)
    hi = gy.bfloat16().float()
    xr = x.reshape(rows, v, cin)

    def grads(parts):
        out = [gcn_grads_plain(xr, part, A, W) for part in parts]
        return sum(o[0] for o in out), sum(o[1] for o in out)

    for got, ref in zip(grads((hi, (gy - hi).bfloat16().float())), (gA, gW)):
        assert (got - ref).abs().max().item() <= TOL_FP32 / 10 * max(1.0, ref.abs().max().item())
    rounded = grads((hi,))
    assert max((got - ref).abs().max().item() / max(1.0, ref.abs().max().item())
               for got, ref in zip(rounded, (gA, gW))) > TOL_FP32
