"""Plain PyTorch oracle for the propagation fixpoint kernel — port of
``repro/kernels/ref.py``.

The propagator-centric scatter form to the fixpoint, per lane: the slow
but obviously correct reference (`sweep_scatter` is "each propagator
joins its variables", the literal reading of the paper's load/store
compilation with atomic joins).
"""

from __future__ import annotations

from repro_torch.core.compile import CompiledModel
from repro_torch.core.fixpoint import fixpoint_batch


def fixpoint_ref(cm: CompiledModel, lb, ub, max_sweeps: int | None = None):
    """`lb`, `ub`: ``[L, V]`` lane-batched stores.  Returns (lb', ub').

    Each lane sweeps in scatter form until it stops changing, fails or
    reaches `max_sweeps`, on its own: `fixpoint_tile` sweeps only the
    lanes still live, which is the reference's vmap of the single-store
    loop."""
    nlb, nub, _, _ = fixpoint_batch(cm, lb, ub, max_iters=max_sweeps,
                                    stop_on_fail=True, use_scatter=True)
    return nlb, nub
