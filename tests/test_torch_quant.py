"""The int8 cells of the port (``stgx_torch.bench.quant``) against the JAX
package's (``stgx.bench.quant``) on the CPU, at the JAX quant tests' sizes:
the 3-layer RT-ST-GCN of ``tests/test_quant.py`` and its 3-layer CoST-GCN
(``imu_fogit_ABCD``, L = 24, LayerNorm), weights carried from the JAX init
by ``from_jax_params``, inputs normal from numpy seeds.

* ``quantize_weight``, ``quantize_rtstgcn`` / ``quantize_costgcn``: equal
  leaf for leaf (the port stores the weights column-major, the kernels'
  layout: the same values and bytes);
* ``int8_matmul``: bit for bit on shared int8 inputs and in the dynamic
  and static modes; w8 within 1e-4 of max(1, max|ref|) (fp32 sums in
  another order);
* the cells over the stream: w8 within 1e-4; dynamic and static, with
  fp32, bf16 and int8 state, within ``TOL_CELL``, which the docstring of
  :func:`test_cells_match_jax` explains;
* ``calibrate_scales``: the same sites in the same order, values within
  1e-6 relative;
* the int8 ``fifo_sum`` form equals the taps form bit for bit;
* the JAX tests' guards, with the same exception types, and the plain
  versions of the two int8 kernels against a numpy int64 product.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stgx.bench.quant as jq
import stgx_torch.bench.quant as tq
from stgx.bench.streaming import param_bytes
from stgx.graph import load_skeleton
from stgx.models.costgcn import CoStgcn as JCoStgcn
from stgx.models.costgcn import stream_sequence as j_co_stream
from stgx.models.rtstgcn import RtStgcn as JRtStgcn
from stgx.models.rtstgcn import stream_sequence as j_rt_stream
from stgx_torch.models.costgcn import CoStgcn
from stgx_torch.models.rtstgcn import RtStgcn
import stgx_torch.ops.int8_gemm as int8_ops
from stgx_torch.ops.int8_gemm import (
    KSTAGE,
    SPLIT_STAGES,
    STAGED_TILE,
    gemm_plan,
    int8_gemm,
    int8_gemm_plain,
    w8_gemm,
    w8_gemm_plain,
    weight_layout,
)
from stgx_torch.ops.temporal import init_accumulator_state
from stgx_torch.weights import from_jax_params

SKEL = load_skeleton("imu_fogit_ABCD")
NAMES = ["rt-st-gcn", "co-st-gcn"]
COMMON = dict(num_classes=5, in_feat=6, graph=SKEL, kernel=3, in_ch=(8, 8, 16),
              out_ch=(8, 16, 16), residual=(1, 1, 1), dropout=(0.0,) * 3,
              normalization="LayerNorm")
# (mode, state type): the cells the JAX tests run
CELLS = [("dynamic", "float32"), ("static", "float32"), ("static", "bfloat16"),
         ("static", "int8"), ("w8", "float32")]
J_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}
T_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}
# logits of the dynamic and static cells against JAX's, relative to
# max(1, max|ref|): twice the worst distance measured (2.95e-7, CoST-GCN's
# dynamic cell, over 4 seeds x 2 streams at 1 and 4 CPU threads)
TOL_CELL = 6e-7
TOL_W8 = 1e-4


def _pair(name):
    if name == "rt-st-gcn":
        kw = dict(COMMON, stride=(1, 1, 1))
        jm, tm = JRtStgcn(**kw), RtStgcn(**kw, device="cpu")
    else:
        kw = dict(COMMON, dilation=(1, 2, 1))
        jm, tm = JCoStgcn(**kw), CoStgcn(**kw, device="cpu")
    x = np.random.default_rng(0).normal(size=(1, 24, 7, 6)).astype(np.float32)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    tm.load_state_dict(from_jax_params(params, tm), strict=True)
    return jm, params, tm, x


def _flat(tree, path=""):
    """(path, numpy leaf) pairs of a qparams tree, dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}/{i}")
    else:
        yield path, np.asarray(tree)


class _Codes:
    """Records the int8 codes a cell makes (activations and int8 FIFO
    writes), step by step and flattened, by wrapping a quant module's
    ``_fifo_put`` and the function that makes its activation codes: the
    JAX cell's ``_quantize_act``; in the port the kernels quantize inside
    the product, whose plain version (the one a CPU tensor takes) makes
    the codes with ``ops.int8_gemm.quantize_codes``."""

    def __init__(self, mp, mod):
        self.codes = []
        put = mod._fifo_put

        def fifo_put(*a, **k):
            stored, s = put(*a, **k)
            if s is not None:
                self.codes.append(np.asarray(stored).reshape(-1))
            return stored, s

        mp.setattr(mod, "_fifo_put", fifo_put)
        if hasattr(mod, "_quantize_act"):
            act = mod._quantize_act

            def quantize_act(*a, **k):
                x_q, s = act(*a, **k)
                self.codes.append(np.asarray(x_q).reshape(-1))
                return x_q, s

            mp.setattr(mod, "_quantize_act", quantize_act)
        else:
            codes = int8_ops.quantize_codes

            def quantize_codes(*a, **k):
                x_q = codes(*a, **k)
                self.codes.append(np.asarray(x_q).reshape(-1))
                return x_q

            mp.setattr(int8_ops, "quantize_codes", quantize_codes)


def _run_jax(name, jm, qp, x, mode, sd, scales):
    _, step, init = jq.QUANT_MODELS[name]
    with pytest.MonkeyPatch.context() as mp, jq.quant_mode(mode, scales):
        rec = _Codes(mp, jq)
        st, outs = init(jm, dtype=J_DTYPES[sd]), []
        for t in range(x.shape[1]):
            logits, st = step(jm, qp, st, jnp.asarray(x[:, t]))
            outs.append(np.asarray(logits))
    return np.stack(outs, axis=1), rec.codes


def _run_port(name, tm, qp, x, mode, sd, scales):
    _, step, init = tq.QUANT_MODELS[name]
    with pytest.MonkeyPatch.context() as mp, tq.quant_mode(mode, scales):
        rec = _Codes(mp, tq)
        st, outs = init(tm, dtype=T_DTYPES[sd]), []
        for t in range(x.shape[1]):
            logits, st = step(tm, qp, st, torch.tensor(x[:, t]))
            outs.append(logits.numpy())
    return np.stack(outs, axis=1), rec.codes


@pytest.fixture(scope="module", params=NAMES)
def family(request):
    """Both packages' model, qparams and calibration, and every cell run
    over the stream, for one family."""
    name = request.param
    jm, params, tm, x = _pair(name)
    jqp = jq.QUANT_MODELS[name][0](jm, params)
    tqp = tq.QUANT_MODELS[name][0](tm)
    j_scales = jq.calibrate_scales(jm, jqp, jnp.asarray(x[0]), name)
    runs = {}
    for mode, sd in CELLS:
        scales = j_scales if mode == "static" else None
        runs[mode, sd] = (_run_jax(name, jm, jqp, x, mode, sd, scales),
                          _run_port(name, tm, tqp, x, mode, sd, scales))
    stream = j_rt_stream if name == "rt-st-gcn" else j_co_stream
    y_fp32 = np.asarray(stream(jm, params, jnp.asarray(x))[0])
    return dict(name=name, jm=jm, params=params, tm=tm, x=x, jqp=jqp, tqp=tqp,
                j_scales=j_scales, runs=runs, y_fp32=y_fp32)


# -- weights -------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(192, 64), (3, 8, 16), (3, 52), (256, 1)])
def test_quantize_weight_matches_jax(shape):
    w = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    w[..., 0] *= 1e-14  # a column under the 1e-12 floor of the scale
    jw, js = jq.quantize_weight(jnp.asarray(w))
    tw, ts = tq.quantize_weight(torch.tensor(w))
    assert tw.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quantized_params_match_jax_leaf_for_leaf(family):
    want = dict(_flat(family["jqp"]))
    got = dict(_flat(family["tqp"]))
    assert list(got) == list(want)
    for path, ref in want.items():
        assert got[path].dtype == ref.dtype, path
        np.testing.assert_array_equal(got[path], ref, err_msg=path)
    for wq in (t for t in tq._leaves(family["tqp"]) if t.dtype == torch.int8):
        assert wq.t().is_contiguous()  # the kernels' layout


def test_quantized_size_is_the_jax_figure_and_below_fp32(family):
    size = tq.quantized_size_bytes(family["tqp"])
    assert size == jq.quantized_size_bytes(family["jqp"])
    assert size < 0.75 * param_bytes(family["params"])
    assert size < sum(p.numel() * p.element_size() for p in family["tm"].parameters())


# -- int8_matmul ---------------------------------------------------------------------


def _matmul_operands(seed=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(4, 7, 48)).astype(np.float32)
    w = rng.normal(size=(48, 20)).astype(np.float32)
    jw, js = jq.quantize_weight(jnp.asarray(w))
    tw, ts = tq.quantize_weight(torch.tensor(w))
    return x, (jw, js), (weight_layout(tw), ts)


def test_int8_matmul_on_shared_int8_inputs_matches_jax():
    """The pre-quantized path (int8 FIFO taps feeding the product): the
    same codes and storage scale give the same bits, and the bias the port
    adds in the kernel's epilogue is the JAX cells' ``+ b``."""
    x, (jw, js), (tw, ts) = _matmul_operands()
    x_q = np.random.default_rng(3).integers(-127, 128, size=x.shape).astype(np.int8)
    s = 0.0123
    ref = np.asarray(jq.int8_matmul(jnp.asarray(x_q), jw, js, act_scale=s))
    got = tq.int8_matmul(torch.tensor(x_q), tw, ts, act_scale=s)
    np.testing.assert_array_equal(got.numpy(), ref)
    b = np.random.default_rng(4).normal(size=(20,)).astype(np.float32)
    got_b = tq.int8_matmul(torch.tensor(x_q), tw, ts, act_scale=torch.tensor(s),
                           bias=torch.tensor(b))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(jnp.asarray(ref) + b))
    with pytest.raises(ValueError, match="act_scale"):
        tq.int8_matmul(torch.tensor(x_q), tw, ts)


@pytest.mark.parametrize("mode", ["dynamic", "static", "w8"])
def test_int8_matmul_modes_match_jax(mode):
    x, (jw, js), (tw, ts) = _matmul_operands()
    scales = {"s0": float(np.abs(x).max() / 127.0 * 0.9)} if mode == "static" else None
    with jq.quant_mode(mode, scales):
        jq._static_reset()
        ref = np.asarray(jq.int8_matmul(jnp.asarray(x), jw, js, site="s0"))
    with tq.quant_mode(mode, scales):
        tq._static_reset()
        got = tq.int8_matmul(torch.tensor(x), tw, ts, site="s0").numpy()
    if mode == "w8":
        assert np.abs(got - ref).max() <= TOL_W8 * max(1.0, np.abs(ref).max())
    else:
        np.testing.assert_array_equal(got, ref)


# -- the cells -----------------------------------------------------------------------


@pytest.mark.parametrize("cell", CELLS, ids=[f"{m}-{d}" for m, d in CELLS])
def test_cells_match_jax(family, cell):
    """The int8 cells over the 24-frame stream against the JAX cells on the
    same weights and frames (static ones under JAX's calibrated scales).

    The integer products are exact and the epilogues round alike, so a
    difference can come only from an fp32 input to a quantize that differs
    in its last bit (the adjacency einsum and the norms sum in another
    order than XLA's): its code can then flip at a rounding tie, which
    moves the logits by a quantization step. The test prints how many codes
    differ and holds the logits to ``TOL_CELL`` of max(1, max|ref|), twice
    the worst distance measured with no code flipped (the static cells gave
    JAX's bits; the dynamic ones 2.95e-7 at worst, where the abs-max scales
    take the same last-bit differences). A code that flips fails it, on
    purpose: the bound is not the size of a flip. w8 quantizes no
    activation: ``TOL_W8``, fp32 sums in another order."""
    (ref, ref_codes), (got, got_codes) = family["runs"][cell]
    assert len(got_codes) == len(ref_codes)
    differ = sum(int((g != r).sum()) for g, r in zip(got_codes, ref_codes))
    total = sum(r.size for r in ref_codes)
    rel = np.abs(got - ref).max() / max(1.0, np.abs(ref).max())
    print(f"{family['name']} {cell}: {differ} of {total} codes differ from JAX's, "
          f"logits {rel:.3e} of max(1, max|ref|)")
    assert np.isfinite(got).all() and got.shape == ref.shape
    assert rel <= (TOL_W8 if cell[0] == "w8" else TOL_CELL), rel


def test_cells_track_fp32_at_the_jax_tests_bounds(family):
    """The JAX tests' bounds: dynamic, static and w8 against the fp32 cell
    (top-1 agreement > 0.9, mean relative distance < 0.2), bf16 and int8
    state against the fp32-state static cell (< 0.15), w8 no further from
    fp32 than dynamic."""
    runs, y_fp32 = family["runs"], family["y_fp32"]

    def close(y, ref, rel_max):
        agree = (y.argmax(-1) == ref.argmax(-1)).mean()
        rel = np.abs(y - ref).mean() / (np.abs(ref).mean() + 1e-9)
        assert agree > 0.9 and rel < rel_max, (agree, rel)

    port = {cell: run[1][0] for cell, run in runs.items()}
    for cell in (("dynamic", "float32"), ("static", "float32"), ("w8", "float32")):
        close(port[cell], y_fp32, 0.2)
    for sd in ("bfloat16", "int8"):
        close(port["static", sd], port["static", "float32"], 0.15)
    err = {m: np.abs(port[m, "float32"] - y_fp32).mean() for m in ("w8", "dynamic")}
    assert err["w8"] <= err["dynamic"] + 1e-9, err


def test_calibrate_scales_matches_jax(family):
    got = tq.calibrate_scales(family["tm"], family["tqp"], torch.tensor(family["x"][0]),
                              family["name"])
    want = family["j_scales"]
    assert list(got) == list(want)
    for site, v in want.items():
        assert abs(got[site] - v) <= 1e-6 * v, (site, got[site], v)
    state_sites = [s for s in got if s.endswith(".state")]
    if family["name"] == "rt-st-gcn":  # one accumulator FIFO a layer
        assert len(state_sites) == len(family["tm"].layers)
    else:  # the residual FIFOs; the main FIFO shares the tcn product's site
        assert state_sites and all(s.endswith(".res.state") for s in state_sites)


@pytest.mark.parametrize("stride", [1, 2])
def test_int8_fifo_sum_equals_the_taps(stride):
    """The deep-kernel form of the int8 accumulator (a strided view of every
    s-th slot, less the slot just stored) against the taps form, at K ≥ 16
    taps and B ≥ 8 streams, over frames past the FIFO's depth."""
    gamma = 17 * stride
    scale = 0.02
    rng = np.random.default_rng(5)
    with tq.quant_mode("static", {"s.state": scale}):
        out = {}
        for impl in ("taps", "fifo_sum"):
            state = init_accumulator_state(8, 25, 16, gamma, stride, dtype=torch.int8,
                                           device="cpu")
            ys = []
            for _ in range(40):
                tq._static_reset()
                y = torch.tensor(rng.normal(size=(8, 25, 16)).astype(np.float32))
                y_t, state = tq._quant_acc_step(state, y, gamma, stride, "s.state", impl=impl)
                ys.append(y_t)
            out[impl] = torch.stack(ys)
            rng = np.random.default_rng(5)
    assert torch.equal(out["taps"], out["fifo_sum"])


# -- guards, from the JAX tests ------------------------------------------------------


def test_static_scale_site_mismatch_fails_loudly(family):
    name, tm, tqp = family["name"], family["tm"], family["tqp"]
    _, step, init = tq.QUANT_MODELS[name]
    x_t = torch.tensor(family["x"][:, 0])
    scales = family["j_scales"]
    missing = {k: v for k, v in scales.items() if k != "layers.1.gcn"}
    with pytest.raises(KeyError, match="layers.1.gcn"):
        with tq.quant_mode("static", missing):
            step(tm, tqp, init(tm), x_t)
    with pytest.raises(ValueError, match="never consumed"):
        with tq.quant_mode("static", dict(scales, **{"layers.99.gcn": 1.0})):
            step(tm, tqp, init(tm), x_t)
    with pytest.raises(ValueError, match="site-keyed"):
        with tq.quant_mode("static", np.ones(5, np.float32)):
            pass
    # fp32 state leaves the .state sites unconsumed, without an error
    with tq.quant_mode("static", scales):
        step(tm, tqp, init(tm), x_t)


def test_duplicate_site_in_one_step_rejected():
    x, _, (tw, ts) = _matmul_operands(7)
    with pytest.raises(ValueError, match="consumed twice"):
        with tq.quant_mode("static", {"s0": 1.0}):
            tq._static_reset()
            tq.int8_matmul(torch.tensor(x), tw, ts, site="s0")
            tq.int8_matmul(torch.tensor(x), tw, ts, site="s0")


def test_int8_state_requires_static_scales(family):
    name, tm = family["name"], family["tm"]
    _, step, init = tq.QUANT_MODELS[name]
    for mode in ("dynamic", "w8"):
        with pytest.raises(ValueError, match="static calibrated scales"):
            with tq.quant_mode(mode):
                step(tm, family["tqp"], init(tm, dtype=torch.int8),
                     torch.tensor(family["x"][:, 0]))


def test_int8_state_is_a_quarter_of_fp32_state(family):
    init = tq.QUANT_MODELS[family["name"]][2]

    def nbytes(state):
        return sum(t.numel() * t.element_size() for layer in state for t in layer.values())

    b32 = nbytes(init(family["tm"], batch=8))
    assert nbytes(init(family["tm"], batch=8, dtype=torch.int8)) * 4 == b32
    assert nbytes(init(family["tm"], batch=8, dtype=torch.bfloat16)) * 2 == b32


# -- the kernels' plain versions -----------------------------------------------------


@pytest.mark.parametrize("m,k,n", [(1, 3, 64), (25, 3, 52), (1, 256, 52), (37, 40, 52),
                                   (3, 17664, 8)])
def test_gemm_plain_versions_against_numpy(m, k, n):
    """The wrappers on CPU tensors (their plain versions) at ragged shapes,
    against a numpy int64 product with the same epilogue, and against a
    row-strided view of the left operand."""
    rng = np.random.default_rng(m * 1000 + k)
    a = rng.integers(-127, 128, size=(m, 2 * k)).astype(np.int8)
    b = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    s_a, s_b = np.float32(0.013), (rng.random(n) * 0.01).astype(np.float32)
    bias = rng.normal(size=n).astype(np.float32)
    acc = a[:, k:].astype(np.int64) @ b.astype(np.int64)
    want = (acc.astype(np.int32).astype(np.float32) * (s_a * s_b)) + bias
    ta = torch.tensor(a)[:, k:]  # row stride 2k
    assert ta.stride() == (2 * k, 1)
    got = int8_gemm(ta, weight_layout(torch.tensor(b)), torch.tensor(s_a), torch.tensor(s_b),
                    torch.tensor(bias))
    np.testing.assert_array_equal(got.numpy(), want)
    x = rng.normal(size=(m, k)).astype(np.float32)
    ref = (x.astype(np.float64) @ b.astype(np.float64)) * s_b + bias
    got8 = w8_gemm(torch.tensor(x), weight_layout(torch.tensor(b)), torch.tensor(s_b),
                   torch.tensor(bias)).numpy()
    assert np.abs(got8 - ref).max() <= TOL_W8 * max(1.0, np.abs(ref).max())
    np.testing.assert_array_equal(
        int8_gemm_plain(ta, torch.tensor(b), torch.tensor(s_a), torch.tensor(s_b)).numpy(),
        acc.astype(np.int32).astype(np.float32) * (s_a * s_b))
    np.testing.assert_array_equal(
        w8_gemm_plain(torch.tensor(x), torch.tensor(b), torch.tensor(s_b)).numpy(),
        (torch.tensor(x) @ torch.tensor(b).float() * torch.tensor(s_b)).numpy())


def test_gemm_wrappers_refuse_what_the_kernels_do_not_take():
    a = torch.zeros(4, 8, dtype=torch.int8)
    b = weight_layout(torch.zeros(8, 3, dtype=torch.int8))
    s = torch.ones(3)
    with pytest.raises(ValueError, match="kernel layout"):
        int8_gemm(a, torch.zeros(8, 3, dtype=torch.int8), torch.tensor(1.0), s)
    with pytest.raises(TypeError, match="int8"):  # int8 codes, fp32 or bf16 only
        int8_gemm(a.double(), b, torch.tensor(1.0), s)
    with pytest.raises(ValueError, match="s_a"):
        int8_gemm(a, b, 1.0, s)
    with pytest.raises(TypeError, match="float32"):
        w8_gemm(a, b, s)
    with pytest.raises(ValueError, match="no kernel for device"):
        int8_gemm(a.to("meta"), b.to("meta"), torch.tensor(1.0, device="meta"), s.to("meta"))


@pytest.mark.parametrize("m,n,k", [(25, 256, 17664), (1, 52, 256), (1600, 256, 2304),
                                   (102400, 256, 768), (25, 64, 3)])
def test_gemm_plan_covers_k_once(m, n, k):
    for op in ("int8", "w8"):
        for tma in (True, False):
            plan = gemm_plan(m, n, k, op, tma)
            bk = KSTAGE[op] if tma else STAGED_TILE[op][2]
            bm = 64 * plan.nc if tma else STAGED_TILE[op][0]
            ktiles = -(-k // bk)
            assert plan.route == ("tma" if tma else "staged")
            assert plan.splits >= 1 and (plan.splits - 1) * plan.kper < ktiles
            assert ktiles <= plan.splits * plan.kper
            if plan.splits > 1:
                assert tma and plan.kper >= SPLIT_STAGES
                assert plan.splits * -(-m // bm) * -(-n // plan.bn) <= 2 * 132
