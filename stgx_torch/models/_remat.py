"""Per-layer rematerialisation — the port of ``stgx/models/_remat.py``.

A layer run through :func:`checkpointed` keeps only its inputs for the
backward pass and runs its forward again there
(``torch.utils.checkpoint.checkpoint``, non-reentrant), trading compute for
activation memory on long trials. Models take this path when ``remat and
train`` (config key ``arch.remat``); the gradients equal the stored path's.

Two things a plain ``checkpoint`` would get wrong here:

* **Dropout.** The port draws its masks from an explicit
  ``torch.Generator`` (:func:`stgx_torch.models.rtstgcn.dropout`), which
  ``preserve_rng_state`` does not save: the recomputed forward would draw
  other masks and give wrong gradients without an error. So the
  generator's state is taken before the layer runs, set back for the
  recompute, and the generator is then returned to where the caller had
  left it, so that later layers and steps draw what they would without
  remat. No random number comes from the global generators, so their state
  is not saved.
* **Parameters bound by ``torch.func.functional_call``.** The ``Trainer``
  runs bf16 compute by binding cast parameters for the forward only; the
  recompute in the backward would find the fp32 parameters bound again.
  So the parameters the layer holds when it runs are bound again for the
  recompute.
* **The mesh layout** (:func:`stgx_torch.parallel.mesh.use_shards`). The
  recompute runs in the backward pass, outside the step's layout: on the
  card a CUDA backward runs on autograd's device thread, where the layout
  is unset, and where it is set it is the step's, not a strided one the
  model entered before this layer. Without its layout a recompute would
  take BatchNorm's statistics from this rank's block, skip the halo
  exchange and read the frames at the wrong bounds: wrong gradients, with
  no error where the recomputed tensors keep their shapes (zero halos
  under LayerNorm). So the layout the layer runs under is taken
  at the call and set again for the recompute. The recompute then runs the
  forward's collectives again (BatchNorm's sums, the halo exchange, the
  tensor-parallel gathers), in the same order on every rank: it always runs
  the whole layer (early stop off), since a rank that stopped before a
  collective its peers run would hang them.
"""

from __future__ import annotations

import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint, noop_context_fn, set_checkpoint_early_stop

from stgx_torch.parallel.mesh import current_shards, use_shards

__all__ = ["checkpointed"]


def checkpointed(layer: torch.nn.Module, *args, generator: torch.Generator | None = None,
                 context_fn=noop_context_fn, **kwargs):
    """``layer(*args, **kwargs)`` (plus ``generator=`` when given),
    rematerialised in the backward pass with the same dropout masks, the
    same parameters and the same mesh layout. ``context_fn`` goes to
    ``checkpoint`` (a selective-recompute policy, as the ablation's
    ``remat_dots`` gives)."""
    params = dict(layer.named_parameters())
    shards = current_shards()
    if generator is not None:
        kwargs = dict(kwargs, generator=generator)
        start = generator.get_state()
    ran = []

    def run(*inputs):
        if not ran:  # the forward
            ran.append(True)
            return layer(*inputs, **kwargs)
        with use_shards(shards):
            if generator is None:
                return functional_call(layer, params, inputs, kwargs)
            now = generator.get_state()
            generator.set_state(start)
            try:
                return functional_call(layer, params, inputs, kwargs)
            finally:
                generator.set_state(now)

    with set_checkpoint_early_stop(False):
        return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False,
                          context_fn=context_fn)
