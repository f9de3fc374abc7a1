"""Activation-checkpoint policy (the port of ``repro/nn/scanctl.py``).

`remat_policy` sets, for the layers run inside it, what a remat'd layer
(`nn/model.py` ``_remat``) keeps for its backward, and `checkpoint` runs
one layer under that policy through ``torch.utils.checkpoint``
(non-reentrant):

* ``None`` / ``"full"``: keep only the layer's input and recompute
  everything in the backward (the default);
* ``"dots"``: keep the outputs of the matrix products without batch
  dimensions (``aten.mm``, ``aten.addmm``: every projection and FFN
  product, which `nn.layers.dense` and `unembed` fold to 2-D) and
  recompute the rest, the counterpart of the reference's
  ``dots_with_no_batch_dims_saveable`` (the attention's batched
  products are recomputed, as there).

The reference's `scan_layers`, `unroll_scans` and `unrolling` have no
counterpart: the port's layer loops are Python loops already (one
layer after another, `nn/model.py`), which is what `unroll_scans`
switches to, and nothing lowers them to a ``lax.scan`` whose cost XLA
would count once.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
from torch.utils.checkpoint import (checkpoint as _checkpoint,
                                    create_selective_checkpoint_contexts)

_REMAT_POLICY = contextvars.ContextVar("repro_torch_remat_policy",
                                       default=None)
# the products "dots" keeps: matrix products with no batch dimensions
SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


@contextlib.contextmanager
def remat_policy(name):
    """Activation-checkpoint policy of the remat'd layers run inside:
    None/'full' (recompute everything) or 'dots' (keep the products
    without batch dims)."""
    if name not in (None, "full", "dots"):
        raise ValueError(name)
    tok = _REMAT_POLICY.set(name)
    try:
        yield
    finally:
        _REMAT_POLICY.reset(tok)


def checkpoint(fn, *args):
    """``fn(*args)`` under a non-reentrant checkpoint honouring the
    ambient `remat_policy`."""
    name = _REMAT_POLICY.get()
    if name in (None, "full"):
        return _checkpoint(fn, *args, use_reentrant=False)
    if name == "dots":
        return _checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=lambda: create_selective_checkpoint_contexts(
                list(SAVED_DOTS)))
    raise ValueError(name)
