"""Public wrapper for the propagation kernel — port of
``repro/kernels/ops.py``.

`batched_fixpoint` is a thin façade over the propagation-backend
registry (`core/backend.py`), kept for kernel-level tests and tools:

* ``impl="cuda"`` — the Hopper fixpoint kernel (`fixpoint_cuda`): on
  CUDA tensors one launch, on CPU tensors its plain version;
* ``impl="gather"`` — the lane-batched plain PyTorch gather sweep;
* ``impl="scatter"`` — the scatter form (the oracle's join strategy).

All three compute the same least fixed point; the stores are an integer
lattice, so the tests compare with exact equality.

Comparison spec: implementations agree (a) on the failed mask, and (b)
exactly on every non-failed lane's store.  The gather and scatter forms
compute bit-identical stores per *sweep* (the scatter form does not
scatter plain rows' disentailment slot onto the TRUE var: a disentailed
plain row fails through term tightening in the same sweep), and the
kernel follows the gather form's per-lane loop, so the three agree on
every lane even under a sweep cap.

The reference's ``impl="pallas"``, its ``lane_tile`` and its
``interpret`` flag have no counterpart: the kernel is ``impl="cuda"``, a
CTA runs one lane (no lane tile), and nothing is interpreted.
"""

from __future__ import annotations

from repro_torch.core.backend import get_backend
from repro_torch.core.compile import CompiledModel

IMPLS = ("gather", "scatter", "cuda")


def batched_fixpoint(cm: CompiledModel, lb, ub, impl: str = "gather",
                     max_sweeps: int = 16384, lane_tile=None):
    """Propagate a ``[L, V]`` batch of stores to their least fixed points
    (at most `max_sweeps` sweeps per lane).  Returns (lb', ub')."""
    if impl == "pallas" or lane_tile is not None:
        raise ValueError(
            "batched_fixpoint: the port has no 'pallas' impl and no lane "
            "tile; impl='cuda' runs the Hopper fixpoint kernel, one CTA per "
            "lane")
    if impl not in IMPLS:
        raise ValueError(f"batched_fixpoint: unknown impl {impl!r}; "
                         f"available: {', '.join(IMPLS)}")
    nlb, nub, _, _ = get_backend(impl).fixpoint_batch(cm, lb, ub,
                                                      max_iters=max_sweeps)
    return nlb, nub
