"""The temporal shift's backward kernel: its host plan and its schedule.

``csrc/temporal_shift.cu``'s backward runs on the card only; chip_smoke.py
holds it against ``temporal_shift_vjp_plain`` there (gx with
``torch.equal``, g_shift within the fp32 / bf16 kernel tolerance, the same
bits from run to run). Here, on the CPU:

* the tile rule (``shift_bwd_tile``): the staged rows of g on the input grid
  and of x fit the block's slab, and the tiles cover every output frame;
* a replay of the kernel's schedule: blocks over (n, v) columns and tiles of
  output frames, gx from G staged on the input grid with the two products
  and the add rounded separately in fp32, g_shift as per-block partials of
  eight thread rows added in row order, then spans of 256 partials, then the
  spans, all in a fixed order; gx equals the plain version bit for bit in
  fp32 and bf16, g_shift lies within 1e-6 of max(1, max|ref|) (the plain
  version sums in another order);
* on the CPU ``temporal_shift_bwd`` is the plain version itself.
"""

import numpy as np
import pytest
import torch

from stgx_torch.ops.shift import (
    MAX_SHIFT,
    SHIFT_SPAN,
    SLAB_ROWS,
    shift_bwd_tile,
    temporal_shift,
    temporal_shift_bwd,
    temporal_shift_vjp_plain,
)

ROWS_PAR = 8  # thread rows of a block (256 threads / 32 channels)
# shifts that are integers, negative, fractional, exactly +-K and beyond
CASES = [0.0, 1.0, -2.0, 3.0, 0.25, -0.75, 2.5, -3.3, 8.0, -8.0, 9.7, -12.0, 7.6, -7.9, 0.5,
         5.01]


@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("l", [5, 13, 25, 50, 200, 1000])
def test_tile_fits_the_slab_and_covers_the_frames(l, stride):
    tile = shift_bwd_tile(l, stride)
    lo = -(-l // stride)
    k = MAX_SHIFT
    assert 1 <= tile <= lo
    assert (tile - 1) * stride + 2 * k + 2 <= SLAB_ROWS  # x rows
    assert tile * stride + 2 * k + 1 <= SLAB_ROWS  # g rows on the input grid
    # the input frames the tiles form gx for: [t0*s, (t0 + tile)*s) ∩ [0, L)
    hits = torch.zeros(l, dtype=torch.int32)
    for t0 in range(0, lo, tile):
        hits[t0 * stride: min(l, (t0 + tile) * stride)] += 1
    assert (hits == 1).all()
    if l <= 50:  # the Shift-GCN widths: one tile a sequence
        assert tile == lo


def test_tile_refuses_a_band_wider_than_the_slab():
    with pytest.raises(ValueError, match="max_shift"):
        shift_bwd_tile(50, 1, max_shift=80)


def replay_shift_bwd(x, shift, g, stride, k=MAX_SHIFT):
    """``temporal_shift_bwd_kernel`` and its two reduction passes in fp32,
    vectorised over (n, v) columns and channels."""
    n, l, v, c = x.shape
    lo = g.shape[1]
    tile = shift_bwd_tile(l, stride, k)
    tiles = -(-lo // tile)
    sc = shift.float().clamp(-k, k)
    f = torch.floor(sc)
    a = sc - f
    wa = 1.0 - a
    fi = f.long()
    xf, gf = x.float(), g.float()
    gx = torch.empty(n, l, v, c)
    partial = torch.empty(n, v, tiles, c)

    def take(arr, row):  # arr[:, row[ch], :, ch] for each channel ch: (n, v, c)
        return torch.gather(arr, 1, row.view(1, 1, 1, c).expand(n, 1, v, c))[:, 0]

    for ti in range(tiles):
        t0 = ti * tile
        nt = min(tile, lo - t0)
        xfirst, gfirst = t0 * stride - k, t0 * stride - k - 1
        xrows, grows = (nt - 1) * stride + 2 * k + 2, nt * stride + 2 * k + 1
        xs = torch.zeros(n, xrows, v, c)
        for r in range(xrows):
            if 0 <= xfirst + r < l:
                xs[:, r] = xf[:, xfirst + r]
        gs = torch.zeros(n, grows, v, c)
        for r in range(grows):
            j = gfirst + r
            if j >= 0 and j % stride == 0 and j // stride < lo:
                gs[:, r] = gf[:, j // stride]
        for i in range(t0 * stride, min(l, (t0 + nt) * stride)):
            row = i - fi - gfirst  # (c,)
            p0 = wa * take(gs, row)
            p1 = a * take(gs, row - 1)
            gx[:, i] = p0 + p1
        red = []
        for part in range(ROWS_PAR):
            dot = torch.zeros(n, v, c)
            for to in range(part, nt, ROWS_PAR):
                t = (t0 + to) * stride
                r = t + fi - xfirst
                dx = take(xs, r + 1) - take(xs, r)
                dot = dot + gs[:, t - gfirst] * dx
            red.append(dot)
        s = red[0]
        for part in range(1, ROWS_PAR):
            s = s + red[part]
        partial[:, :, ti] = s
    partial = partial.reshape(-1, c)  # (n, v, tile) order, as the blocks index them
    p_count = partial.shape[0]
    spans = []
    for s0 in range(0, p_count, SHIFT_SPAN):
        red = []
        for part in range(ROWS_PAR):
            acc = torch.zeros(c)
            lo_p = s0 + part * (SHIFT_SPAN // ROWS_PAR)
            for p in range(lo_p, min(lo_p + SHIFT_SPAN // ROWS_PAR, p_count)):
                acc = acc + partial[p]
            red.append(acc)
        s = red[0]
        for part in range(1, ROWS_PAR):
            s = s + red[part]
        spans.append(s)
    total = torch.zeros(c)
    for s in spans:
        total = total + s
    sh = shift.float().abs()
    inside = torch.where(sh < k, 1.0, torch.where(sh == k, 0.5, 0.0))
    return gx.to(x.dtype), (total * inside).to(shift.dtype)


# (N, L, V, C, stride): the Shift-GCN widths at L = 50, 25, 13; C = 40 (two
# channel chunks, the second ragged); L = 200, two tiles; N*V = 320 partials,
# two spans of the first reduction pass
SHAPES = [(3, 50, 5, 40, 1), (3, 50, 5, 40, 2), (2, 13, 5, 16, 1), (2, 200, 3, 8, 1),
          (2, 201, 3, 8, 2), (64, 25, 5, 8, 1)]


@pytest.mark.parametrize("n,l,v,c,stride", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_replay_gives_the_plain_gx_bits_and_its_g_shift(n, l, v, c, stride, dtype):
    rng = np.random.default_rng(l + c + stride)
    sh = rng.uniform(-10.0, 10.0, size=c).astype(np.float32)
    sh[: min(c, len(CASES))] = CASES[: min(c, len(CASES))]
    x = torch.tensor(rng.normal(size=(n, l, v, c)).astype(np.float32)).to(dtype)
    g = torch.tensor(rng.normal(size=(n, -(-l // stride), v, c)).astype(np.float32)).to(dtype)
    shift = torch.tensor(sh).to(dtype)
    gx, gsh = replay_shift_bwd(x, shift, g, stride)
    ref_gx, ref_gsh = temporal_shift_vjp_plain(x, shift, g, stride)
    assert gx.dtype == ref_gx.dtype and gsh.dtype == ref_gsh.dtype
    assert torch.equal(gx, ref_gx)
    err = (gsh.float() - ref_gsh.float()).abs().max().item()
    scale = max(1.0, ref_gsh.float().abs().max().item())
    if dtype == torch.float32:
        assert err <= 1e-6 * scale, err
    else:  # both sum in fp32 and round once to bf16: at most one bf16 step apart
        assert err <= 2.0**-7 * scale, err


def test_wrapper_on_the_cpu_is_the_plain_version():
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(2, 13, 3, 8)).astype(np.float32))
    g = torch.tensor(rng.normal(size=(2, 7, 3, 8)).astype(np.float32))
    shift = torch.tensor(CASES[:8])
    before = temporal_shift_bwd.launches
    for got, ref in zip(temporal_shift_bwd(x, shift, g, 2),
                        temporal_shift_vjp_plain(x, shift, g, 2)):
        assert torch.equal(got, ref)
    # the autograd Function's backward takes the same path
    xr, sr = x.clone().requires_grad_(), shift.clone().requires_grad_()
    temporal_shift(xr, sr, 2).backward(g)
    ref_gx, ref_gs = temporal_shift_vjp_plain(x, shift, g, 2)
    assert torch.equal(xr.grad, ref_gx) and torch.equal(sr.grad, ref_gs)
    assert temporal_shift_bwd.launches == before  # a CPU tensor launches nothing
