"""The int8 products' operand forms and routes (``stgx_torch.ops.int8_gemm``)
on the CPU, where each wrapper runs its plain version.

* form (b), an fp32 or bf16 operand quantized inside the product: the codes
  of the JAX package's ``_quantize_act`` (ties at .5 to even, the clamp at
  ±127), and the product of those codes, bit for bit;
* form (c), CoST-GCN's FIFO taps read in place: the product of the stacked
  taps (numpy's stack and the cell's), bit for bit, at dilations 1, 2 and 4
  and Γ = 9 and 69, in int8, fp32 and bf16 state and in w8;
* :func:`gemm_plan` and :func:`tma_ok`: which shapes take the tma route,
  and K covered once; every product site of the full-width RT-ST-GCN₉ and
  CoST-GCN₉ cells takes the route the card will take (``fcn_in``, K = 3,
  the staged one; CoST's tcn its taps);
* the refusals: a tap geometry no FIFO holds, FIFOs no route reads, and a
  bf16 operand off the tma route, which no cell hands a product.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stgx.bench.quant as jq
import stgx_torch.bench.quant as tq
import stgx_torch.ops.int8_gemm as ops
from stgx_torch.config import build_model, load_config
from stgx_torch.ops.int8_gemm import (
    gemm_plan,
    int8_gemm,
    int8_gemm_plain,
    quantize_codes,
    route,
    tap_operand,
    tma_ok,
    w8_gemm,
    w8_gemm_plain,
    weight_layout,
)

TOL_W8 = 1e-4  # w8 against a float64 product: fp32 sums, relative to max(1, max|ref|)


def _weight(rng, k, n):
    b = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    return b, weight_layout(torch.tensor(b)), torch.tensor((rng.random(n) * 0.01 + 1e-3)
                                                          .astype(np.float32))


def _ties_and_clamps(rng, m, k, scale):
    """fp32 values on exact .5 ties of ``x / scale`` (scale a power of two),
    past the clamp at ±127 (infinities and quotients past fp32's range
    among them), and normal values between."""
    x = rng.normal(size=(m, k)).astype(np.float32) * 40 * scale
    ties = (rng.integers(-130, 130, size=(m, k)) + 0.5).astype(np.float32) * scale
    big = np.sign(rng.normal(size=(m, k))).astype(np.float32) * scale * rng.integers(
        127, 400, size=(m, k))
    pick = rng.integers(0, 3, size=(m, k))
    out = np.where(pick == 0, ties, np.where(pick == 1, big, x)).astype(np.float32)
    out[0, :4] = [np.inf, -np.inf, 3e38, -3e38]
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_form_b_codes_are_the_jax_quantize_and_the_product_of_them(dtype):
    rng = np.random.default_rng(11)
    m, k, n = 37, 192, 52
    scale = np.float32(2.0 ** -5)
    x = _ties_and_clamps(rng, m, k, scale)
    xt = torch.tensor(x).to(getattr(torch, dtype))
    x32 = xt.float().numpy()  # the values the product sees
    with np.errstate(over="ignore", invalid="ignore"):  # the infinities' quotients
        q = x32 / scale
        ties = np.abs(np.abs(q) % 1 - 0.5) == 0
    assert ties.sum() > m * k // 6 and (np.abs(q) > 127).sum() > m * k // 6
    s = torch.tensor(scale)
    want_codes, _ = jq._quantize_act(jnp.asarray(x32), float(scale))
    np.testing.assert_array_equal(quantize_codes(xt, s).numpy(), np.asarray(want_codes))
    np.testing.assert_array_equal(  # numpy: half to even, then the clamp
        quantize_codes(xt, s).numpy(), np.clip(np.rint(q), -127, 127).astype(np.int8))
    b, bq, s_b = _weight(rng, k, n)
    bias = torch.tensor(rng.normal(size=n).astype(np.float32))
    got = int8_gemm(xt, bq, s, s_b, bias)
    np.testing.assert_array_equal(got.numpy(), int8_gemm_plain(quantize_codes(xt, s), bq, s,
                                                               s_b, bias).numpy())
    acc = np.asarray(want_codes).astype(np.int64) @ b.astype(np.int64)
    want = acc.astype(np.int32).astype(np.float32) * (scale * s_b.numpy()) + bias.numpy()
    np.testing.assert_array_equal(got.numpy(), want)


def _fifo(rng, gamma, d, dtype, rows=(2, 3), c=64):
    depth = (gamma - 1) * d + 1
    f = rng.normal(size=(depth, *rows, c)).astype(np.float32)
    if dtype == "int8":
        return torch.tensor(rng.integers(-127, 128, size=f.shape).astype(np.int8))
    return torch.tensor(f).to(getattr(torch, dtype))


@pytest.mark.parametrize("gamma,d", [(9, 1), (9, 2), (9, 4), (69, 1), (69, 2), (69, 4)])
@pytest.mark.parametrize("dtype", ["int8", "float32", "bfloat16"])
def test_form_c_taps_equal_the_stacked_operand(gamma, d, dtype):
    rng = np.random.default_rng(gamma * 10 + d)
    fifo = _fifo(rng, gamma, d, dtype)
    depth, c = fifo.shape[0], fifo.shape[-1]
    # numpy's stack of the taps: column tap * C + c of row r from slot depth - 1 - tap * d
    f = fifo.float().numpy().reshape(depth, -1, c)
    u = np.concatenate([f[depth - 1 - t * d] for t in range(gamma)], axis=1)
    np.testing.assert_array_equal(tap_operand(fifo, gamma, d).float().numpy(), u)
    _, bq, s_b = _weight(rng, gamma * c, 64)
    s = torch.tensor(np.float32(0.05))
    bias = torch.tensor(rng.normal(size=64).astype(np.float32))
    stacked = tap_operand(fifo, gamma, d)
    got = int8_gemm(fifo, bq, s, s_b, bias, taps=(gamma, d))
    assert got.shape == (6, 64)
    np.testing.assert_array_equal(got.numpy(), int8_gemm(stacked, bq, s, s_b, bias).numpy())
    if dtype != "int8":
        got8 = w8_gemm(fifo, bq, s_b, bias, taps=(gamma, d))
        np.testing.assert_array_equal(got8.numpy(), w8_gemm(stacked.float(), bq, s_b,
                                                            bias).numpy())
        ref = (u.astype(np.float64) @ bq.double().numpy()) * s_b.double().numpy() + bias.numpy()
        assert np.abs(got8.numpy() - ref).max() <= TOL_W8 * max(1.0, np.abs(ref).max())


def test_the_cost_cells_tap_product_is_the_stack_the_cell_built():
    """The CoST-GCN cell's tcn operand through ``int8_matmul(..., taps=...)``
    against the stack the cell used to build (``torch.stack`` of the slots
    on a new axis 2, reshaped to (N, V, Γ·C)), in each mode."""
    rng = np.random.default_rng(5)
    gamma, d = 9, 2
    fifo = _fifo(rng, gamma, d, "float32", rows=(2, 25))
    depth = fifo.shape[0]
    u = torch.stack([fifo[depth - 1 - k * d] for k in range(gamma)], dim=2)
    u = u.reshape(u.shape[0], u.shape[1], -1)
    w = torch.tensor(rng.normal(size=(gamma * 64, 64)).astype(np.float32))
    wq, sw = tq.quantize_weight(w)
    wq = weight_layout(wq)
    for mode, scales in (("dynamic", None), ("static", {"t": 0.02}), ("w8", None)):
        with tq.quant_mode(mode, scales):
            tq._static_reset()
            got = tq.int8_matmul(fifo, wq, sw, site="t", taps=(gamma, d))
            tq._static_reset()
            want = tq.int8_matmul(u, wq, sw, site="t")
        assert got.shape == (2, 25, 64)
        assert torch.equal(got, want), mode


@pytest.mark.parametrize("shape,dtype,stride,tma", [
    ((25, 192), torch.int8, None, True),      # a cell's gcn site, codes
    ((1600, 768), torch.float32, None, True),  # form (b)
    ((64, 256), torch.bfloat16, None, True),
    ((25, 3), torch.float32, None, False),     # fcn_in: 12-byte rows
    ((37, 40), torch.int8, None, False),       # 40-byte rows
    ((130, 100), torch.float32, None, True),   # 400-byte rows
    ((130, 100), torch.int8, None, False),     # 100-byte rows
    ((50, 64), torch.int8, 3, True),           # a slot of an (M, 3, K) FIFO
    ((50, 3), torch.int8, 3, False),           # the same at K = 3
    ((50, 64), torch.int8, "offset", False),   # a base off 16 bytes
])
def test_tma_ok_routes_by_shape(shape, dtype, stride, tma):
    m, k = shape
    if stride == 3:
        a = torch.zeros(m, 3, k, dtype=dtype)[:, 1]
    elif stride == "offset":
        a = torch.zeros(m, k + 1, dtype=dtype)[:, 1:]
    else:
        a = torch.zeros(m, k, dtype=dtype)
    for n, n_ok in ((64, True), (52, True), (50, False)):
        b = weight_layout(torch.zeros(a.shape[1], n, dtype=torch.int8))
        assert tma_ok(a, b, n) == (tma and n_ok and k % 16 == 0), (shape, n)
        for op in ("int8", "w8"):
            if tma_ok(a, b, n) or dtype != torch.bfloat16:
                assert route("x", op, a, b) == ("tma" if tma_ok(a, b, n) else "staged")
            else:  # the staged route takes no bf16 operand
                with pytest.raises(ValueError, match="no kernel reads a bf16 operand"):
                    route("x", op, a, b)
    # a weight whose columns are off 16 bytes takes the staged route too
    b = weight_layout(torch.zeros(40, 64, dtype=torch.int8))
    assert not tma_ok(torch.zeros(8, 40, dtype=torch.float32), b, 64)


@pytest.mark.parametrize("m,n,k", [(1600, 52, 192), (25, 52, 256), (102400, 256, 768),
                                   (1600, 256, 17664), (1, 52, 3), (300, 300, 100)])
def test_gemm_plan_tiles_and_splits(m, n, k):
    for op in ("int8", "w8"):
        plan = gemm_plan(m, n, k, op)
        assert plan.bn in (64, 128, 256)
        wide = 64 if n <= 64 else 128 if n <= 128 else 256  # the whole width up to 256
        if -(-m // 64) * -(-n // wide) >= 132:
            assert plan.bn == wide
        else:  # narrowed while SMs would idle
            assert plan.bn < wide or plan.bn == 64
        if op == "int8":  # an operand quantized inside: never narrowed, split sooner
            quantized = gemm_plan(m, n, k, op, codes=False)
            assert quantized.bn == wide
            if quantized.splits > 1:
                assert quantized.kper >= ops.SPLIT_STAGES_QUANTIZED
        assert plan.nc == (2 if -(-m // 128) * -(-n // plan.bn) >= 132 else 1)
        ktiles = -(-k // ops.KSTAGE[op])
        covered = [t for z in range(plan.splits)
                   for t in range(z * plan.kper, min(ktiles, (z + 1) * plan.kper))]
        assert covered == list(range(ktiles))  # every k stage once, each split non-empty
        assert plan.splits <= ops.MAX_SPLITS
        if plan.splits > 1:
            assert plan.kper >= ops.SPLIT_STAGES
        assert all(z * plan.kper < ktiles for z in range(plan.splits))


@pytest.mark.parametrize("config", ["configs/pku-mmd/as_is/rtstgcn.json",
                                    "configs/pku-mmd/ln/costgcn.json"])
def test_every_site_of_the_full_width_cells_takes_its_route(monkeypatch, config):
    """One dynamic-mode step of the full-width cell at B = 2 on the CPU,
    each product's route asked as the card would ask it: every site takes
    the tma route but ``fcn_in`` (K = 3), and CoST-GCN's tcn sites hand the
    product their FIFO (form (c)) rather than a stack."""
    cfg = load_config(config)
    name = cfg["processor"]["model"]
    model = build_model(cfg, 52, device="cpu")
    quantize, qstep, qinit = tq.QUANT_MODELS[name]
    qparams = quantize(model)
    seen = []
    for fn in ("int8_gemm", "w8_gemm"):
        plain = getattr(ops, f"{fn}_plain")

        def rec(a, b_q, *args, fn=fn, plain=plain, taps=None, **kw):
            seen.append((fn, route(fn, "int8" if fn == "int8_gemm" else "w8", a, b_q, taps),
                         taps is not None, a.dim()))
            return (plain(a, b_q, *args, taps=taps, **kw))
        monkeypatch.setattr(tq, fn, rec)
    x = torch.tensor(np.random.default_rng(0).normal(size=(2, 25, model.in_feat)),
                     dtype=torch.float32)
    for mode in ("dynamic", "w8"):
        seen.clear()
        with tq.quant_mode(mode):
            logits, _ = qstep(model, qparams, qinit(model, batch=2), x)
        assert logits.shape == (2, 52) and torch.isfinite(logits).all()
        fn = "w8_gemm" if mode == "w8" else "int8_gemm"
        assert {s[0] for s in seen} == {fn}
        assert seen[0][1] == "staged" and all(s[1] == "tma" for s in seen[1:]), seen
        taps = [s for s in seen if s[2]]
        assert len(taps) == (len(model.layers) if name == "co-st-gcn" else 0)
        assert all(s[3] == 4 for s in taps)  # the (depth, N, V, C) FIFO itself


def test_the_wrappers_refuse_impossible_taps_and_unreadable_fifos():
    rng = np.random.default_rng(2)
    fifo = _fifo(rng, 9, 2, "int8")  # depth 17
    _, bq, s_b = _weight(rng, 9 * 64, 64)
    s = torch.tensor(0.1)
    with pytest.raises(ValueError, match="depth >= "):  # 9 taps 3 apart need 25 slots
        int8_gemm(fifo, bq, s, s_b, taps=(9, 3))
    with pytest.raises(ValueError, match="K = gamma C"):
        int8_gemm(fifo, bq, s, s_b, taps=(8, 2))
    with pytest.raises(ValueError, match="depth >= "):
        w8_gemm(fifo[0].float(), bq, s_b, taps=(9, 2))  # no slot axis
    # what the card's route refuses: C off the k stage, rows off 16 bytes,
    # a FIFO that is not contiguous
    f48 = torch.zeros(17, 2, 3, 48, dtype=torch.int8)
    _, b48, _ = _weight(rng, 9 * 48, 64)
    with pytest.raises(ValueError, match="no kernel reads the taps"):
        route("int8_gemm", "int8", f48, b48, (9, 2))
    wide = torch.zeros(17, 2, 3, 72, dtype=torch.int8)[..., :64]
    with pytest.raises(ValueError, match="no kernel reads the taps"):
        route("int8_gemm", "int8", wide, bq, (9, 2))
    assert route("int8_gemm", "int8", fifo, bq, (9, 2)) == "tma"
    f32 = fifo.float()
    assert route("w8_gemm", "w8", f32, bq, (9, 2)) == "tma"
    with pytest.raises(ValueError, match="no kernel reads the taps"):
        route("w8_gemm", "w8", f32, weight_layout(torch.zeros(9 * 64, 50, dtype=torch.int8)),
              (9, 2))  # N off a multiple of 4
    np.testing.assert_array_equal(  # the plain version on the CPU reads the same FIFO
        w8_gemm(f32, bq, s_b, taps=(9, 2)).numpy(),
        w8_gemm_plain(tap_operand(f32, 9, 2), bq, s_b).numpy())


@pytest.mark.parametrize("config", ["configs/pku-mmd/as_is/rtstgcn.json",
                                    "configs/pku-mmd/ln/costgcn.json"])
def test_no_cell_hands_a_bf16_operand_off_the_tma_route(monkeypatch, config):
    """One step of the full-width cell at B = 2 with bf16 FIFO state in each
    mode, each product's route asked as the card would ask it (which raises
    for a bf16 operand off the tma route): bf16 reaches a product only as
    CoST-GCN's taps."""
    cfg = load_config(config)
    name = cfg["processor"]["model"]
    model = build_model(cfg, 52, device="cpu")
    quantize, qstep, qinit = tq.QUANT_MODELS[name]
    qparams = quantize(model)
    seen = []
    for fn in ("int8_gemm", "w8_gemm"):
        plain = getattr(ops, f"{fn}_plain")

        def rec(a, b_q, *args, fn=fn, plain=plain, taps=None, **kw):
            path = route(fn, "int8" if fn == "int8_gemm" else "w8", a, b_q, taps)
            seen.append((a.dtype, path, taps is not None))
            return plain(a, b_q, *args, taps=taps, **kw)
        monkeypatch.setattr(tq, fn, rec)
    x = torch.tensor(np.random.default_rng(1).normal(size=(2, 25, model.in_feat)),
                     dtype=torch.float32)
    for mode in ("dynamic", "w8"):
        seen.clear()
        with tq.quant_mode(mode):
            state = qinit(model, batch=2, dtype=torch.bfloat16)
            for _ in range(2):
                logits, state = qstep(model, qparams, state, x)
        assert torch.isfinite(logits).all()
        bf16 = [s for s in seen if s[0] == torch.bfloat16]
        assert all(s[1] == "tma" and s[2] for s in bf16), seen
        assert len(bf16) == (2 * len(model.layers) if name == "co-st-gcn" else 0)
