"""The temporal shift's kernels: their host plan and their schedules.

``csrc/temporal_shift.cu``'s forward and backward run on the card only;
chip_smoke.py holds them against ``temporal_shift_plain`` and
``temporal_shift_vjp_plain`` there (y and gx with ``torch.equal``, g_shift
within the fp32 / bf16 kernel tolerance, the same bits from run to run, TP's
channel blocks joined bit for bit). Here, on the CPU:

* the plan (``shift_plan``): every tile's staged rows fit the block's
  budget and 227 KB of shared memory at every shape the models launch (C 8
  to 256, seq's halo-extended blocks, strides 1 to 3, L up to 1,000), the
  tiles cover every frame once, a window of L <= 52 takes one tile, and the
  backward's tile and partials do not depend on C or the type;
* a replay of the forward's schedule, block by block as the kernel walks
  it: each block's 32 columns (pairs and channels by the plan), its staged
  slab with zero frames outside the sequence, each output formed once, the
  two products and the add rounded separately in fp32: the plain version's
  bits in fp32, and in bf16 the fp32 plain version's of the widened inputs
  rounded once;
* a replay of the backward's: gx from g staged at its own frames and placed
  on the input grid by index arithmetic, the plain version's bits in fp32
  and bf16; g_shift summed over each warp's frames, the warps in order, the
  pairs of each aligned group of four in order, then 32 spans of partials
  and the spans in order: within 1e-6 of max(1, max|ref|) of the plain
  version (which sums in another order), and the same bits for channel
  blocks of C / 2 and C / 4 joined as for the whole launch;
* on the CPU ``temporal_shift_bwd`` is the plain version itself.
"""

import itertools

import numpy as np
import pytest
import torch

from stgx_torch.ops.shift import (
    COLS,
    GROUP,
    MAX_SHIFT,
    PARTS,
    RED_WARPS,
    SMEM_LIMIT,
    shift_plan,
    temporal_shift,
    temporal_shift_bwd,
    temporal_shift_plain,
    temporal_shift_vjp_plain,
)

# shifts that are integers, negative, fractional, exactly +-K and beyond
CASES = [0.0, 1.0, -2.0, 3.0, 0.25, -0.75, 2.5, -3.3, 8.0, -8.0, 9.7, -12.0, 7.6, -7.9, 0.5,
         5.01]


def _rows(tile, stride, k=MAX_SHIFT):
    """(x rows, g rows) a backward block of ``tile`` output frames stages."""
    back, ahead = (k + stride) // stride, (k + stride - 1) // stride
    return (tile - 1) * stride + 2 * k + 2, tile + back + ahead


@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("l", [5, 13, 25, 50, 200, 1000])
def test_tile_fits_the_slab_and_covers_the_frames(l, stride):
    lo = -(-l // stride)
    k = MAX_SHIFT
    for backward in (False, True):
        plan = shift_plan(4, l, 25, 64, stride, backward=backward)
        tile = plan.tile
        assert 1 <= tile <= lo and plan.grid[2] == -(-lo // tile)
        xrows, grows = _rows(tile, stride)
        assert plan.rows == (xrows + grows if backward else xrows)
        assert plan.smem == plan.rows * COLS * 16 <= SMEM_LIMIT
        # the output frames, and the input frames the backward's tiles form gx
        # for, [t0*s, (t0 + tile)*s) ∩ [0, L): each once
        outs, ins = torch.zeros(lo, dtype=torch.int32), torch.zeros(l, dtype=torch.int32)
        for t0 in range(0, lo, tile):
            outs[t0: t0 + tile] += 1
            ins[t0 * stride: min(l, (t0 + tile) * stride)] += 1
        assert (outs == 1).all() and (ins == 1).all()
        if l <= 52:  # the Shift-GCN widths: one tile a window
            assert tile == lo
        if not backward:
            assert xrows <= 96
    # the backward's tile and partials follow (N, L, V, stride, K) alone
    plans = [shift_plan(4, l, 25, c, stride, itemsize=size, vec=vec, backward=True)
             for c, size, vec in ((64, 4, True), (16, 2, True), (8, 4, True), (6, 2, False))]
    assert len({(p.tile, p.partials) for p in plans}) == 1


def test_tile_refuses_a_band_wider_than_the_slab():
    with pytest.raises(ValueError, match="max_shift"):
        shift_plan(2, 50, 25, 64, 1, max_shift=80, backward=True)
    with pytest.raises(ValueError, match="max_shift"):
        shift_plan(2, 50, 25, 64, 1, max_shift=80)


# every (L, C, stride) the models launch: Shift-GCN at W = 50, the Shift-GCN++
# teacher and student at W = 52, TP's blocks down to C = 8, seq's
# halo-extended blocks (about L / 2 + 17 frames), strides 1-3, L to 1,000
MODEL_LENGTHS = (50, 25, 13, 52, 26, 13, 42, 30, 24, 23, 21, 20)
MODEL_CHANNELS = (8, 16, 32, 64, 128, 256)


def test_plan_fits_shared_memory_at_every_model_shape():
    for l, c, stride, size in itertools.product(MODEL_LENGTHS + (200, 1000), MODEL_CHANNELS,
                                                (1, 2, 3), (4, 2)):
        lo = -(-l // stride)
        for backward in (False, True):
            plan = shift_plan(256, l, 25, c, stride, itemsize=size, backward=backward)
            assert plan.smem <= SMEM_LIMIT
            if l <= 52:
                assert plan.tile == lo
            # the columns follow the width: every lane holds channels
            cols = c * size // 16
            assert plan.pairs * min(cols, 8) == COLS
            assert plan.pairs % GROUP == 0  # a block holds whole groups of pairs
            assert plan.grid[0] * plan.pairs >= 256 * 25 > (plan.grid[0] - 1) * plan.pairs


def _block_columns(plan, n, v, c, bx, by):
    """The pair, first channel and validity of each of a block's 32
    columns, as ``column()`` in the kernel places them."""
    cols = torch.arange(COLS)
    cbv = 1 << plan.lcbv
    pair = bx * plan.pairs + (cols >> plan.lcbv)
    ch = (by * cbv + (cols & (cbv - 1))) * plan.width
    return pair, ch, (pair < n * v) & (ch < c)


def _stage(arr, pair, ch, ok, first, rows, width):
    """A block's slab ``(rows, 32, width)`` of ``arr`` ``(pairs, frames, C)``
    (fp32): frames [first, first + rows) of each valid column, zeros
    elsewhere."""
    slab = torch.zeros(rows, COLS, width)
    t = torch.arange(first, first + rows)
    inside = (t >= 0) & (t < arr.shape[1])
    cols = torch.nonzero(ok).flatten()
    if len(cols) and inside.any():
        chans = ch[cols][:, None] + torch.arange(width)[None, :]  # (cols, width)
        vals = arr[pair[cols][:, None, None], t[inside][None, :, None], chans[:, None, :]]
        slab[torch.nonzero(inside).flatten()[:, None], cols[None, :]] = vals.transpose(0, 1)
    return slab


def _taps(shift, k):
    sc = shift.float().clamp(-k, k)
    f = torch.floor(sc)
    a = sc - f
    return f.long(), a, 1.0 - a


def replay_shift_fwd(x, shift, stride, k=MAX_SHIFT, vec=True):
    """``temporal_shift_kernel`` block by block in fp32; returns y in x's
    type and the count of each output's forming."""
    n, l, v, c = x.shape
    lo = -(-l // stride)
    plan = shift_plan(n, l, v, c, stride, k, x.element_size(), vec)
    w = plan.width
    xp = x.float().permute(0, 2, 1, 3).reshape(n * v, l, c)  # (pair, frame, channel)
    f, a, wa = _taps(shift, k)
    y = torch.zeros(n * v, lo, c)
    formed = torch.zeros(n * v, lo, c, dtype=torch.int32)
    for bx, by, bz in itertools.product(*map(range, plan.grid)):
        pair, ch, ok = _block_columns(plan, n, v, c, bx, by)
        t0 = bz * plan.tile
        nt = min(plan.tile, lo - t0)
        rows = (nt - 1) * stride + 2 * k + 2
        assert rows * COLS * w * x.element_size() <= plan.smem
        slab = _stage(xp, pair, ch, ok, t0 * stride - k, rows, w)
        cols = torch.nonzero(ok).flatten()
        if not len(cols):
            continue
        chans = ch[cols][:, None] + torch.arange(w)[None, :]
        lane = cols[:, None].expand_as(chans)
        e = torch.arange(w)[None, :].expand_as(chans)
        for to in range(nt):
            r = to * stride + f[chans] + k
            p0 = wa[chans] * slab[r, lane, e]
            p1 = a[chans] * slab[r + 1, lane, e]
            y[pair[cols][:, None], t0 + to, chans] = p0 + p1
            formed[pair[cols][:, None], t0 + to, chans] += 1
    back = lambda t: t.reshape(n, v, lo, c).permute(0, 2, 1, 3)  # noqa: E731
    return back(y).to(x.dtype), back(formed)


def replay_shift_bwd(x, shift, g, stride, k=MAX_SHIFT, vec=True):
    """``temporal_shift_bwd_kernel`` block by block and ``shift_grad_kernel``
    in fp32; returns (gx, g_shift) in the inputs' type."""
    n, l, v, c = x.shape
    lo = g.shape[1]
    plan = shift_plan(n, l, v, c, stride, k, x.element_size(), vec, backward=True)
    w, tiles = plan.width, plan.grid[2]
    back_rows, ahead = (k + stride) // stride, (k + stride - 1) // stride
    xp = x.float().permute(0, 2, 1, 3).reshape(n * v, l, c)
    gp = g.float().permute(0, 2, 1, 3).reshape(n * v, lo, c)
    f, a, wa = _taps(shift, k)
    gx = torch.zeros(n * v, l, c)
    groups = -(-(n * v) // GROUP)
    partial = torch.zeros(groups * tiles, c)
    for bx, by, bz in itertools.product(*map(range, plan.grid)):
        pair, ch, ok = _block_columns(plan, n, v, c, bx, by)
        t0 = bz * plan.tile
        nt = min(plan.tile, lo - t0)
        xs = _stage(xp, pair, ch, ok, t0 * stride - k, (nt - 1) * stride + 2 * k + 2, w)
        gs = _stage(gp, pair, ch, ok, t0 - back_rows, nt + back_rows + ahead, w)
        chans = ch[:, None] + torch.arange(w)[None, :]  # (32, w); past C: no taps
        real = chans < c
        fc = torch.where(real, f[chans.clamp(max=c - 1)], 0)
        ac = torch.where(real, a[chans.clamp(max=c - 1)], 0.0)
        wac = torch.where(real, wa[chans.clamp(max=c - 1)], 1.0)
        lane = torch.arange(COLS)[:, None].expand_as(chans)
        e = torch.arange(w)[None, :].expand_as(chans)
        cols = torch.nonzero(ok).flatten()
        # gx: G[i - f] is row jr of g on the input grid, g row jr / s where s divides it
        for i in range(t0 * stride, min(l, (t0 + nt) * stride)):
            jr = i + (back_rows - t0) * stride - fc
            if stride == 1:
                g0, g1 = gs[jr, lane, e], gs[jr - 1, lane, e]
            else:
                q, m = jr // stride, jr % stride
                val = gs[q, lane, e]
                g0 = torch.where(m == 0, val, 0.0)
                g1 = torch.where(m == 1, val, 0.0)
            out = wac * g0 + ac * g1
            gx[pair[cols][:, None], i, chans[cols]] = out[cols]
        # g_shift: each warp's frames in order, then the warps, then each
        # aligned group's pairs
        dots = []
        for part in range(PARTS):
            dot = torch.zeros(COLS, w)
            for to in range(part, nt, PARTS):
                r = to * stride + fc + k
                dx = xs[r + 1, lane, e] - xs[r, lane, e]
                dot = dot + gs[to + back_rows, lane, e] * dx
            dots.append(dot)
        red = dots[0]
        for part in range(1, PARTS):
            red = red + dots[part]
        cbv = 1 << plan.lcbv
        red = red.reshape(plan.pairs // GROUP, GROUP, cbv, w)
        total = red[:, 0]
        for q in range(1, GROUP):
            total = total + red[:, q]
        for gi in range(plan.pairs // GROUP):
            group = bx * (plan.pairs // GROUP) + gi
            for cv in range(cbv):
                c0 = (by * cbv + cv) * w
                if group < groups and c0 < c:
                    partial[group * tiles + bz, c0: c0 + w] = total[gi, cv]
    # 32 spans of partials, each in order, then the spans in order
    count = partial.shape[0]
    span = -(-count // RED_WARPS)
    sums = []
    for warp in range(RED_WARPS):
        acc = torch.zeros(c)
        for p in range(warp * span, min((warp + 1) * span, count)):
            acc = acc + partial[p]
        sums.append(acc)
    gsh = sums[0]
    for warp in range(1, RED_WARPS):
        gsh = gsh + sums[warp]
    sh = shift.float().abs()
    inside = torch.where(sh < k, 1.0, torch.where(sh == k, 0.5, 0.0))
    gx = gx.reshape(n, v, l, c).permute(0, 2, 1, 3)
    return gx.to(x.dtype), (gsh * inside).to(shift.dtype)


def _inputs(n, l, v, c, stride, dtype, seed):
    rng = np.random.default_rng(seed)
    sh = rng.uniform(-10.0, 10.0, size=c).astype(np.float32)
    sh[: min(c, len(CASES))] = CASES[: min(c, len(CASES))]
    x = torch.tensor(rng.normal(size=(n, l, v, c)).astype(np.float32)).to(dtype)
    g = torch.tensor(rng.normal(size=(n, -(-l // stride), v, c)).astype(np.float32)).to(dtype)
    return x, torch.tensor(sh).to(dtype), g


# (N, L, V, C, stride): the Shift-GCN widths at L = 50, 25, 13; C = 40 (a
# ragged second channel chunk); L = 200 and 201, several tiles; N*V = 320
# pairs, many blocks and 80 groups of partials
SHAPES = [(3, 50, 5, 40, 1), (3, 50, 5, 40, 2), (2, 13, 5, 16, 1), (2, 200, 3, 8, 1),
          (2, 201, 3, 8, 2), (64, 25, 5, 8, 1)]


@pytest.mark.parametrize("n,l,v,c,stride", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_replay_gives_the_plain_gx_bits_and_its_g_shift(n, l, v, c, stride, dtype):
    x, shift, g = _inputs(n, l, v, c, stride, dtype, l + c + stride)
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


# (N, L, V, C, stride, vec): C = 8 and 16 (TP's narrowest blocks), 40, 6
# (not a multiple of the vector: columns of one channel), a seq block's 30
# frames, stride 3, L = 1000 (several tiles)
FWD_SHAPES = [(3, 50, 5, 8, 1, True), (2, 52, 5, 16, 2, True), (2, 30, 5, 40, 1, True),
              (2, 25, 5, 6, 3, False), (1, 1000, 2, 8, 1, True)]


@pytest.mark.parametrize("n,l,v,c,stride,vec", FWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_replay_forms_each_output_once_with_the_plain_bits(n, l, v, c, stride, vec,
                                                                   dtype):
    if dtype == torch.bfloat16 and vec and c % 8:
        vec = False  # 16 bytes are 8 bf16 channels
    x, shift, _ = _inputs(n, l, v, c, stride, dtype, 7 * l + c)
    y, formed = replay_shift_fwd(x, shift, stride, vec=vec)
    assert (formed == 1).all()
    # the fp32 plain version of the widened x and shift, rounded once
    ref = temporal_shift_plain(x.float(), shift.float(), stride).to(dtype)
    assert y.dtype == dtype and torch.equal(y, ref)
    if dtype == torch.float32:
        assert torch.equal(y, temporal_shift_plain(x, shift, stride))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [1, 2])
def test_g_shift_order_is_the_same_for_channel_blocks(stride, dtype):
    """TP's blocks: the launches on C / 2 and C / 4 channels give the whole
    launch's g_shift and gx bits, joined."""
    n, l, v, c = 3, 26, 5, 32
    x, shift, g = _inputs(n, l, v, c, stride, dtype, 11 + stride)
    gx, gsh = replay_shift_bwd(x, shift, g, stride)
    ref_gx, ref_gsh = temporal_shift_vjp_plain(x, shift, g, stride)
    assert torch.equal(gx, ref_gx)
    err = (gsh.float() - ref_gsh.float()).abs().max().item()
    assert err <= (1e-6 if dtype == torch.float32 else 2.0**-7) * max(
        1.0, ref_gsh.float().abs().max().item()), err
    for m in (2, 4):
        k = c // m
        parts = [replay_shift_bwd(x[..., r * k:(r + 1) * k].contiguous(),
                                  shift[r * k:(r + 1) * k].contiguous(),
                                  g[..., r * k:(r + 1) * k].contiguous(), stride)
                 for r in range(m)]
        assert torch.equal(torch.cat([p[0] for p in parts], -1), gx)
        assert torch.equal(torch.cat([p[1] for p in parts]), gsh)


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
