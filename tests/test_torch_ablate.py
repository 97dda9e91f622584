"""The port's ablation profiler (``stgx_torch.bench.ablate``) on the CPU, at
small widths (two layers of 8 and 16 channels, PKU-MMD's 25 joints, Γ = 9),
built through the same config path as on the card.

* Every variant of the JAX package (``stgx.bench.ablate._variants``) is
  ported or refused with its reason; ``--only`` refuses a refused variant,
  and one whose op the model does not run, with that reason, before it
  looks for a card.
* Each subtractive patch reaches its op: under it the training forward's
  logits differ from ``full``'s (``no_norm``, ``no_acc``, ``no_tcn``,
  ``no_agg``, ``matmul_only``, ``pad_v32`` on a 32-joint skeleton);
  ``fwd_only`` runs the forward and the loss and leaves no gradient and the
  parameters as they were; ``no_mask`` runs with no mask (its logits differ
  from a step whose mask drops frames).
* The implementation A/Bs give ``full``'s loss: ``remat``, ``remat_dots``
  and ``rt_fused`` the same loss and gradients bit for bit in fp32 (the
  recompute, the saved products and the fused plain version form the same
  sums), ``norm_native`` the same in fp32 and within ``2e-3`` relative in
  bf16, where its statistics are bf16 sums (7.5e-5 for RT-ST-GCN and 1.4e-4
  for ST-GCN here).

No timing is asserted: the measurement itself needs the card.
"""

import numpy as np
import pytest
import torch

from stgx_torch.bench import ablate
from stgx_torch.bench.train_throughput import step_fn

SMALL = {name: [f"arch.{name}.{k}={v}" for k, v in (
    ("in_ch", "[8,8]"), ("out_ch", "[8,16]"), ("stride", "[1,2]"), ("residual", "[1,1]"),
    ("dropout", "[0,0]"))] for name in ("rt-st-gcn", "st-gcn")}
SUBTRACTIVE = {"rt-st-gcn": ("no_norm", "no_acc", "no_agg", "matmul_only", "pad_v32"),
               "st-gcn": ("no_norm", "no_tcn", "no_agg", "matmul_only", "pad_v32")}
AB = {"rt-st-gcn": ("remat", "remat_dots", "rt_fused", "norm_native"),
      "st-gcn": ("remat", "remat_dots", "norm_native")}


def _trainer(model, variant, dtype="float32"):
    return ablate.variant_trainer(model, variant, dtype, device="cpu", overrides=SMALL[model])


def _batch(trainer, seed=0):
    """``(x, y, mask)``: 6 windows of 50 frames, or 2 trials of 40 frames."""
    rng = np.random.default_rng(seed)
    v = trainer.model.num_joints
    if trainer.kind == "window":
        x = rng.normal(size=(6, 50, v, 3))
        series = (6,)
    else:
        x = rng.normal(size=(2, 40, v, 3))
        series = (2, 40)
    return (torch.tensor(x, dtype=torch.float32),
            torch.tensor(rng.integers(0, ablate.NUM_CLASSES, size=series)),
            torch.ones(series))


def _logits(model, variant, mask_fn=None):
    trainer = _trainer(model, variant)
    x, _, mask = _batch(trainer)
    if mask_fn is not None:
        mask = mask_fn(mask)
    with torch.no_grad(), ablate._patched(ablate.variant_patches(variant)):
        return trainer._outputs(x, mask, True)[0]


def test_every_jax_variant_is_ported_or_refused_with_its_reason():
    from stgx.bench.ablate import _variants

    assert set(ablate.VARIANTS) == set(_variants())
    ported = {*ablate.ported("rt-st-gcn"), *ablate.ported("st-gcn")}
    assert ported == {"full", *SUBTRACTIVE["rt-st-gcn"], *SUBTRACTIVE["st-gcn"],
                      "fwd_only", "no_mask", "remat", "rt_fused", "rt_fused_fwd",
                      "norm_native", "remat_dots"}
    assert ported.isdisjoint(ablate.REFUSED)
    for name, reason in ablate.REFUSED.items():
        with pytest.raises(ValueError, match="no counterpart") as e:
            ablate.main(["--only", f"full,{name}"])
        assert reason in str(e.value)
    for model, skipped in ablate.NOT_RUN_BY.items():
        for name, reason in skipped.items():
            with pytest.raises(ValueError, match="changes nothing") as e:
                ablate.main(["--model", model, "--only", name])
            assert reason in str(e.value)


@pytest.mark.parametrize("model,variant", [(m, v) for m, vs in SUBTRACTIVE.items() for v in vs])
def test_each_subtractive_patch_reaches_its_op(model, variant):
    full = _logits(model, "full")
    got = _logits(model, variant)
    assert got.shape == full.shape and bool(torch.isfinite(got).all())
    assert (got - full).abs().max() > 1e-3, "the patch changed nothing"
    if variant == "pad_v32":
        assert _trainer(model, variant).model.num_joints == 32


@pytest.mark.parametrize("model", ["rt-st-gcn", "st-gcn"])
def test_fwd_only_and_no_mask_set_their_knobs(model):
    trainer = _trainer(model, "full")
    x, y, mask = _batch(trainer)
    before = {k: p.detach().clone() for k, p in trainer.model.named_parameters()}
    ce, mse = step_fn(trainer, x, y, mask, fwd_only=True)()
    assert np.isfinite(float(ce) + float(mse))
    assert all(p.grad is None for p in trainer.model.parameters())
    assert all(torch.equal(p, before[k]) for k, p in trainer.model.named_parameters())
    step_fn(trainer, x, y, None)()  # no mask anywhere: a whole train step
    assert any(not torch.equal(p, before[k]) for k, p in trainer.model.named_parameters())

    def drop_frames(m):  # a mask that drops frames (a window) changes the logits
        m = m.clone()
        m[-1] = 0.0
        return m

    assert (_logits(model, "full", drop_frames) - _logits(model, "full")).abs().max() > 1e-3


@pytest.mark.parametrize("model,variant", [(m, v) for m, vs in AB.items() for v in vs])
def test_implementation_ab_gives_the_full_loss(model, variant):
    def step(name, dtype):
        trainer = _trainer(model, name, dtype)
        x, y, mask = _batch(trainer)
        with ablate._patched(ablate.variant_patches(name)):
            ce, mse, *_ = trainer.grad_step(x, y, mask, 1.0)
        return float(ce) + float(mse), {k: p.grad for k, p in trainer.model.named_parameters()}

    assert _trainer(model, variant).model.remat == (variant in ablate.REMAT)
    loss, grads = step(variant, "float32")
    ref_loss, ref_grads = step("full", "float32")
    assert loss == ref_loss
    for k, g in grads.items():
        assert torch.equal(g, ref_grads[k]), k
    if variant == "norm_native":
        loss, _ = step(variant, "bfloat16")
        ref_loss, _ = step("full", "bfloat16")
        assert abs(loss - ref_loss) <= 2e-3 * abs(ref_loss), (loss, ref_loss)
