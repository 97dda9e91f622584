"""The port's shift ops (stgx_torch.ops.shift) against the JAX package on
the CPU.

``temporal_shift_plain`` and the port's ``temporal_shift`` (whose CPU path is
the plain version and whose backward is the closed-form VJP the card runs
too) are held against the JAX banded ``temporal_shift`` and against the
Pallas kernel ``temporal_shift_pallas`` in interpret mode, as
tests/test_shift.py runs it, on the same numpy inputs. The shifts cover
integers (a = 0), negative and fractional values, exactly ±8 and beyond
±8 (clipped); L = 13 is shorter than the band's 18 taps. The CUDA kernel is
held against the plain version on the card by chip_smoke.py.

Tolerances: fp32 outputs 1e-6 absolute for unit-normal inputs (two
products and one add, the same roundings); bf16 inputs 1e-2 (the port's
TOL_BF16); gradients 1e-5 for x (at most two terms an element) and 1e-4 for
the shift (a sum over N·L·V products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from stgx.ops import shift as j_shift
from stgx_torch.ops import shift

# integers, negative, fractional, exactly ±8, beyond ±8, near the clip
SHIFTS = np.asarray([0.0, 1.0, -2.0, 3.0, 0.25, -0.75, 2.5, -3.3, 8.0, -8.0,
                     9.7, -12.0, 7.6, -7.9, 0.5, 5.01], np.float32)
# the same kinds of shift, none exactly at ±8 where the clip's gradient
# is not defined
SHIFTS_SMOOTH = np.where(np.abs(SHIFTS) == 8.0, SHIFTS * 0.97, SHIFTS)


def _x(l, seed=0, c=len(SHIFTS)):
    return np.random.default_rng(seed + l).normal(size=(2, l, 5, c)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("l", [13, 40])
def test_temporal_shift_matches_jax(l, stride, dtype):
    x = _x(l)
    jx = jnp.asarray(x).astype(dtype)
    ref = np.asarray(j_shift.temporal_shift(jx, jnp.asarray(SHIFTS), stride), np.float32)
    tx = torch.tensor(x).to(getattr(torch, dtype))
    got = shift.temporal_shift(tx, torch.tensor(SHIFTS), stride)
    plain = shift.temporal_shift_plain(tx, torch.tensor(SHIFTS), stride)
    assert got.shape == (2, -(-l // stride), 5, len(SHIFTS)) and got.dtype == tx.dtype
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=tol)
    np.testing.assert_allclose(plain.float().numpy(), ref, rtol=0, atol=tol)
    if dtype == "float32":
        with pltpu.force_tpu_interpret_mode():
            kernel = j_shift.temporal_shift_pallas(jx, jnp.asarray(SHIFTS), stride)
        np.testing.assert_allclose(got.numpy(), np.asarray(kernel), rtol=0, atol=tol)


def test_shift_band_weights_match_jax():
    got = shift.shift_band_weights(torch.tensor(SHIFTS))
    ref = j_shift.shift_band_weights(jnp.asarray(SHIFTS))
    assert got.shape == (2 * shift.MAX_SHIFT + 2, len(SHIFTS)) == ref.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("l", [13, 40])
def test_temporal_shift_grads_match_jax_vjp(l, stride, pallas):
    """Gradients of x and the shift against jax.vjp of the banded form and
    of the Pallas kernel (whose VJP is the banded form's), away from the
    clip boundary; beyond ±8 the shift's gradient is zero on both sides."""
    x = _x(l, seed=1)
    out_l = -(-l // stride)
    g = np.random.default_rng(2).normal(size=(2, out_l, 5, len(SHIFTS))).astype(np.float32)
    fn = j_shift.temporal_shift_pallas if pallas else j_shift.temporal_shift
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda a, s: fn(a, s, stride), jnp.asarray(x),
                         jnp.asarray(SHIFTS_SMOOTH))
        gx, gs = vjp(jnp.asarray(g))
    tx = torch.tensor(x, requires_grad=True)
    ts = torch.tensor(SHIFTS_SMOOTH, requires_grad=True)
    shift.temporal_shift(tx, ts, stride).backward(torch.tensor(g))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(gs), rtol=0, atol=1e-4)
    assert (ts.grad.numpy()[np.abs(SHIFTS_SMOOTH) > 8] == 0).all()


def test_shift_grad_at_the_clip_is_jaxs():
    """Exactly at ±8 JAX's clip passes half the gradient; the port's VJP
    does the same."""
    x = _x(20, seed=3)
    _, vjp = jax.vjp(j_shift.temporal_shift, jnp.asarray(x), jnp.asarray(SHIFTS))
    g = np.ones((2, 20, 5, len(SHIFTS)), np.float32)
    _, gs = vjp(jnp.asarray(g))
    ts = torch.tensor(SHIFTS, requires_grad=True)
    shift.temporal_shift(torch.tensor(x), ts).sum().backward()
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(gs), rtol=0, atol=1e-4)


@pytest.mark.parametrize("reverse", [False, True])
def test_spatial_shift_matches_jax(reverse):
    x = np.random.default_rng(4).normal(size=(2, 6, 25, 70)).astype(np.float32)
    ref = np.asarray(j_shift.spatial_shift(jnp.asarray(x), reverse))
    got = shift.spatial_shift(torch.tensor(x), reverse)
    np.testing.assert_array_equal(got.numpy(), ref)
    idx = shift.spatial_shift_index(25, 70, reverse)
    np.testing.assert_array_equal(
        shift.spatial_shift(torch.tensor(x), reverse, index=idx).numpy(), ref)


def test_temporal_shift_refuses_bad_shapes():
    with pytest.raises(ValueError, match="shift"):
        shift.temporal_shift(torch.zeros(1, 4, 2, 3), torch.zeros(4))
    with pytest.raises(ValueError, match="stride"):
        shift.temporal_shift(torch.zeros(1, 4, 2, 3), torch.zeros(3), stride=0)
