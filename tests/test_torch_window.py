"""The window-sum of the port at Γ = 69 and the plan and walk of its kernel.

``csrc/window.cuh``'s window pass runs on the card only; chip_smoke.py holds
it against ``window_sum_plain`` there with ``torch.equal``. Here, on the
CPU:

* the plain version (what the wrapper runs for a CPU tensor) against the JAX
  kernel ``causal_accumulate_pallas`` in Pallas interpret mode at Γ = 69,
  s ∈ {1, 2}, and its reverse against the JAX VJP, for L shorter than the
  halo, between, and longer; tolerance 1e-5 of max(1, max|ref|), as
  ``tests/test_torch_ops.py`` (fp32 sums of 69 terms in another order);
* the host's plan (``window_plan``): its chunks and column tiles cover every
  output once, it fills the card at the main path's shapes at Γ = 9 and
  Γ = 69, and a block's shared memory leaves room for four blocks an SM
  there (a halo too long for the 227 KB a block may take reads device
  memory instead);
* a replay in fp32 of the kernel's walk (chunks, staged halo, R accumulators,
  the newest frame first) equals ``window_sum_plain`` bit for bit in fp32
  and bf16, both directions, ragged L;
* the model-building repairs: ``arch.remat`` reaches RT-ST-GCN, which
  refuses it, and the layer arrays may sit under ``st-gcn``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from stgx.ops import temporal as j_temporal
from stgx.ops.pallas_acc import causal_accumulate_pallas
from stgx_torch.config import build_model, load_config
from stgx_torch.ops.gcn_core import SMS
from stgx_torch.ops.window_sum import (
    SMEM_BLOCK,
    WINDOW_COLS,
    WINDOW_R,
    WINDOW_THREAD_ROWS,
    window_plan,
    window_smem,
    window_sum,
    window_sum_plain,
)

TOL = 1e-5
CONFIG = "configs/pku-mmd/as_is/rtstgcn.json"
CONFIG_69 = "configs/pku-mmd/as_is/rtstgcn_69.json"
# (C_out, stride) of the RT-ST-GCN layers (both configs share them), V = 25
LAYERS = [(64, 1)] * 3 + [(128, 2), (128, 1), (128, 1), (256, 2), (256, 1), (256, 1)]
MAIN = [(4, 1024), (8, 1024)]  # (N, L): the batch forward, the train step


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=TOL,
                               atol=TOL * max(1.0, float(np.abs(ref).max())))


# L = 40 is shorter than the halo (68 frames at s = 1, 66 at s = 2), 100 lies
# between one halo and two, 257 is odd and a multiple of no block
@pytest.mark.parametrize("l", [40, 100, 257])
@pytest.mark.parametrize("stride", [1, 2])
def test_window_sum_matches_pallas_at_gamma_69(l, stride):
    rng = np.random.default_rng(l + 7 * stride)
    x = rng.normal(size=(2, l, 3, 4)).astype(np.float32)
    g = rng.normal(size=(2, l, 3, 4)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = causal_accumulate_pallas(jnp.asarray(x), 69, stride)
        _, vjp = jax.vjp(lambda t: causal_accumulate_pallas(t, 69, stride), jnp.asarray(x))
        (ref_rev,) = vjp(jnp.asarray(g))
    _close(window_sum(torch.tensor(x), 69, stride), ref)
    _close(window_sum(torch.tensor(g), 69, stride, reverse=True), ref_rev)
    # and the XLA form's VJP, the path the JAX model takes by default
    _, vjp = jax.vjp(lambda t: j_temporal.causal_accumulate(t, 69, stride), jnp.asarray(x))
    _close(window_sum(torch.tensor(g), 69, stride, reverse=True), vjp(jnp.asarray(g))[0])


# -- the plan ---------------------------------------------------------------


def _blocks(n, l, q, chunk):
    return n * -(-l // chunk) * -(-q // WINDOW_COLS)


def _plan_cases():
    cases = [(n, l, 25 * c, gamma // s, s) for n, l in MAIN for c, s in LAYERS
             for gamma in (9, 69)]
    # ragged: L shorter than the halo, L not a multiple of the chunk, Q not a
    # multiple of 4, stride 2 with L odd, one tap (the fused backward's sum of
    # partial slices), a halo past what shared memory holds
    return cases + [(2, 40, 1600, 69, 1), (3, 1000, 1600, 34, 2), (2, 301, 75, 69, 1),
                    (2, 1023, 3200, 34, 2), (2, 45, 7 * 52, 9, 1), (8, 1024, 75, 1, 1),
                    (1, 3000, 200, 2100, 1)]


@pytest.mark.parametrize("n,l,q,k,s", _plan_cases())
def test_window_plan_covers_every_output_once(n, l, q, k, s):
    r, chunk = WINDOW_R, window_plan(s)
    # whole rounds: every thread row a group of every residue class
    assert chunk % (r * s) == 0 and (chunk // r) % WINDOW_THREAD_ROWS == 0
    hits = torch.zeros(-(-l // chunk) * chunk, dtype=torch.int32)
    for c0 in range(0, l, chunk):
        for g in range(chunk // r):
            lo_t = c0 + g % s + (g // s) * r * s
            hits[lo_t + s * torch.arange(r)] += 1
    assert (hits[:l] == 1).all()
    # the column tiles: WINDOW_COLS columns each, the last one ragged
    cols = torch.zeros(-(-q // WINDOW_COLS) * WINDOW_COLS, dtype=torch.int32)
    for c in range(0, q, WINDOW_COLS):
        cols[c: c + WINDOW_COLS] += 1
    assert (cols[:q] == 1).all()


@pytest.mark.parametrize("gamma", [9, 69])
@pytest.mark.parametrize("n,l", MAIN)
@pytest.mark.parametrize("itemsize", [4, 2])
def test_window_plan_fills_the_card_and_fits(gamma, n, l, itemsize):
    for c, s in LAYERS:
        k, q = gamma // s, 25 * c
        chunk = window_plan(s)
        halo = (k - 1) * s
        # at least four blocks an SM at the narrowest layer
        assert _blocks(n, l, q, chunk) >= 4 * SMS
        # four blocks of a staged chunk share an SM's 227 KB
        assert 4 * window_smem(chunk, halo, itemsize) <= SMEM_BLOCK


def test_long_halo_reads_device_memory():
    """Past 227 KB of staged frames the kernel walks device memory: the
    shapes of chip_smoke.py's ragged case with a halo of 2099 frames."""
    assert window_smem(window_plan(1), 2099) > SMEM_BLOCK
    assert window_smem(window_plan(2), 2 * 68) <= SMEM_BLOCK


# -- a replay of the kernel's walk ------------------------------------------


def replay_window(x, k, s, reverse):
    """``csrc/window.cuh::window_kernel`` step by step in fp32, vectorised over
    blocks, groups and columns: each chunk stages its frames and halo (zeros
    outside [0, L)), each group of R outputs walks its R + K − 1 frames from
    the newest to the oldest, the first tap of an output assigned and every
    later one added, and the result is rounded once to x's type."""
    n, l, q = x.shape
    r, chunk = WINDOW_R, window_plan(s)
    halo = (k - 1) * s
    chunks = -(-l // chunk)
    xp = torch.zeros(n, chunks * chunk + 2 * halo, q)  # halo frames of zeros both sides
    xp[:, halo: halo + l] = x.float()
    c0 = torch.arange(chunks) * chunk
    first = c0 if reverse else c0 - halo  # frame of tile row 0
    rows = torch.arange(chunk + halo)
    tile = xp[:, (first[:, None] + rows[None, :]) + halo]  # (n, chunks, rows, q)
    g = torch.arange(chunk // r)
    lo_t = c0[:, None] + (g % s + (g // s) * r * s)[None, :]  # (chunks, groups)
    d = -1 if reverse else 1
    base = lo_t + (r - 1) * s if reverse else lo_t

    def frame(m):
        row = base + d * m * s - first[:, None]
        return tile[:, torch.arange(chunks)[:, None], row]  # (n, chunks, groups, q)

    acc = [None] * r
    for m in range(r - 1, -1, -1):
        v = frame(m)
        acc[m] = v.clone()
        for i in range(m + 1, r):
            if i - m < k:
                acc[i] = acc[i] + v
    for dd in range(1, k - r + 1):
        v = frame(-dd)
        acc = [a + v for a in acc]
    for e in range(r - 2, -1, -1):
        if e <= k - 2:
            v = frame(-(k - 1 - e))
            for i in range(e + 1):
                acc[i] = acc[i] + v
    y = torch.zeros(n, chunks * chunk + r * s, q)
    for i in range(r):
        t = base + d * i * s  # (chunks, groups)
        y[:, t.reshape(-1)] = acc[i].reshape(n, -1, q)
    return y[:, :l].to(x.dtype)


@pytest.mark.parametrize("gamma", [9, 69])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_replay_of_the_walk_gives_the_plain_bits(gamma, stride, reverse, dtype):
    k = gamma // stride
    rng = np.random.default_rng(gamma + stride)
    for l in (5, 40, 301, 600):  # shorter than the halo, ragged, over a chunk
        x = torch.tensor(rng.normal(size=(2, l, 12)).astype(np.float32)).to(dtype)
        ref = window_sum_plain(x[..., None], gamma, stride, reverse)[..., 0]
        assert torch.equal(replay_window(x, k, stride, reverse), ref), l


def test_replay_sums_the_taps_in_order():
    """The walk keeps the order j = 0, 1, …: with values whose fp32 sum
    depends on the order, the replay agrees with the plain version and not
    with the same taps added oldest first."""
    x = torch.zeros(1, 80, 1)
    x[0, :, 0] = torch.tensor([1.0, 2.0**-24, 2.0**-24] * 26 + [1.0, 2.0**-24])
    got = replay_window(x, 69, 1, False)
    assert torch.equal(got, window_sum_plain(x[..., None], 69, 1)[..., 0])
    oldest_first = torch.zeros(80)
    for t in range(80):
        acc = torch.tensor(0.0)
        for tt in range(max(0, t - 68), t + 1):
            acc = acc + x[0, tt, 0]
        oldest_first[t] = acc
    assert not torch.equal(got[0, :, 0], oldest_first)


# -- building the model -----------------------------------------------------


@pytest.mark.parametrize("config", [CONFIG, CONFIG_69])
def test_rtstgcn_refuses_remat(config):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build_model(load_config(config, ["arch.remat=true"]), 52, device="cpu")


def test_layer_arrays_under_st_gcn_build_the_same_model(tmp_path):
    """``stgx/config.py`` takes the ``st-gcn`` sub-dict where the model's own
    is missing; the port does the same."""
    import json

    with open(CONFIG_69) as f:
        raw = json.load(f)
    raw["arch"]["st-gcn"] = raw["arch"].pop("rt-st-gcn")
    path = tmp_path / "st_gcn_keys.json"
    path.write_text(json.dumps(raw))
    got = build_model(load_config(str(path)), 52, device="cpu")
    ref = build_model(load_config(CONFIG_69), 52, device="cpu")
    assert got.kernel == ref.kernel == 69
    sd_got, sd_ref = got.state_dict(), ref.state_dict()
    assert list(sd_got) == list(sd_ref)
    for key in sd_ref:
        assert torch.equal(sd_got[key], sd_ref[key]), key
