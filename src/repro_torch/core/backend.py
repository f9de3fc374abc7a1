"""Pluggable propagation backends — port of ``repro/core/backend.py``.

Search and EPS only need ``fixpoint_batch(cm, lb, ub, dom=None)``: a
whole ``[n_lanes, V]`` store tensor (and, when search carries it, the
``[n_lanes, V, W]`` bitset store) to its per-lane fixed points in one
call.  ``fixpoint(cm, lb, ub)`` is the single-store view (one store to
its least fixed point).  Four backends register here:

  ``gather``         the plain PyTorch sweep (`fixpoint.fixpoint_batch`);
  ``scatter``        the propagator-centric scatter form
                     (`fixpoint.sweep_scatter_batch`): each propagator
                     joins its variables through ``scatter_reduce``
                     (amin/amax), the paper's atomic-join reading; on
                     CUDA tensors it runs on the card as PyTorch ops;
  ``cuda``           the hand-written Hopper kernel
                     (`kernels/fixpoint_kernel.fixpoint_cuda`),
                     counterpart of the reference's ``pallas`` backend;
  ``cuda_resident``  ``cuda``'s fixpoint, plus `superstep_launch`: K
                     whole supersteps per launch of the resident search
                     kernel (`kernels/fixpoint_kernel.search_cuda`),
                     counterpart of ``pallas_resident``.

On CPU tensors the kernel wrappers run their plain versions; on CUDA
tensors they launch the kernel or raise — there is no fallback.  Every
``fixpoint_batch`` returns ``(lb', ub', sweeps[L], converged[L])``, with
dom' before the counters when `dom` is given, and *per-lane* sweep
counts, identical between the backends (and to the reference's gather,
scatter and pallas backends).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Protocol, Tuple, runtime_checkable

import torch

from repro_torch.core import fixpoint as F
from repro_torch.core.compile import CompiledModel

# (lb', ub', sweeps, converged), or (lb', ub', dom', sweeps, converged)
FixpointResult = Tuple[torch.Tensor, ...]


@runtime_checkable
class PropagationBackend(Protocol):
    """Contract every propagation implementation satisfies."""

    name: str

    def fixpoint(self, cm: CompiledModel, lb: torch.Tensor,
                 ub: torch.Tensor, *,
                 max_iters: Optional[int] = None) -> FixpointResult:
        ...

    def fixpoint_batch(self, cm: CompiledModel, lb: torch.Tensor,
                       ub: torch.Tensor, *, dom=None,
                       max_iters: Optional[int] = None) -> FixpointResult:
        ...


class GatherBackend:
    """The plain PyTorch gather sweep."""

    name = "gather"

    def fixpoint(self, cm, lb, ub, *, max_iters=None):
        return F.fixpoint(cm, lb, ub, max_iters=max_iters)

    def fixpoint_batch(self, cm, lb, ub, *, dom=None, max_iters=None):
        return F.fixpoint_batch(cm, lb, ub, dom, max_iters=max_iters)


class ScatterBackend:
    """The propagator-centric scatter-join form (the reference
    semantics)."""

    name = "scatter"

    def fixpoint(self, cm, lb, ub, *, max_iters=None):
        return F.fixpoint(cm, lb, ub, max_iters=max_iters, use_scatter=True)

    def fixpoint_batch(self, cm, lb, ub, *, dom=None, max_iters=None):
        return F.fixpoint_batch(cm, lb, ub, dom, max_iters=max_iters,
                                use_scatter=True)


class CudaBackend:
    """The Hopper fixpoint kernel (one CTA per lane, stores in shared
    memory); replaces the reference's ``pallas`` backend."""

    name = "cuda"

    def fixpoint(self, cm, lb, ub, *, max_iters=None):
        nlb, nub, sweeps, conv = self.fixpoint_batch(
            cm, lb[None], ub[None], max_iters=max_iters)
        return nlb[0], nub[0], sweeps[0], conv[0]

    def fixpoint_batch(self, cm, lb, ub, *, dom=None, max_iters=None):
        from repro_torch.kernels.fixpoint_kernel import fixpoint_cuda
        return fixpoint_cuda(cm, lb, ub, dom, max_sweeps=max_iters)


class CudaResidentBackend(CudaBackend):
    """The resident search kernel: the host chunk scheduler
    (`core/api._run_chunk`) calls `superstep_launch` once per K
    supersteps instead of driving `search.lanes_step` per superstep.
    As a plain `PropagationBackend` (EPS `decompose`) it is ``cuda``.

    ``lane_tile=0`` (default) keeps every lane in one pool queue, the
    mode whose dispatch trajectory equals the unfused loop's; a positive
    tile splits the lanes into `n_tiles` tiles with the pool strided
    across them (the reference's ``pallas_resident`` lane tile: sound
    and complete, a different dispatch trajectory)."""

    name = "cuda_resident"

    def __init__(self, lane_tile: int = 0):
        self.lane_tile = lane_tile or 0

    def n_tiles(self, cm, n_lanes: int) -> int:
        """Tiles of a launch over `n_lanes` lanes (of a slot's, in a
        `LaneBatch`): 1 in the one-queue mode, else ceil(n_lanes /
        tile).  The host scheduler sizes the carry's pool cursors with it
        (`api._init_carry`), and `LaneBatch` its per-slot cursors
        ``[B, n_tiles]``."""
        if not self.lane_tile:
            return 1
        from repro_torch.kernels.fixpoint_kernel import lane_tiles
        return lane_tiles(n_lanes, self.lane_tile)[1]

    def superstep_launch(self, cm, subs_lb, subs_ub, st, gbest, it,
                         pool_head, *, opts, supersteps: int):
        """One launch of K = `supersteps` supersteps; returns
        ``(st', gbest', it', pool_head', stopped)``.

        `cm` is one model (`search_cuda`: the state of its lanes, a pool
        ``[S, V]``, a 0-d bound, the superstep count and the cursor(s)),
        or a `LaneBatch`'s batch: a list of one model per slot
        (`search_slots_cuda`: the stacked state of every slot's lanes,
        the pools ``[B, S, V]``, bounds ``[B]``, superstep counts
        ``[B]`` and cursors, ``[B]`` or ``[B, n_tiles]``), one launch over
        every slot, whose outputs are per slot."""
        from repro_torch.kernels.fixpoint_kernel import (search_cuda,
                                                         search_slots_cuda)
        launch = (search_slots_cuda if isinstance(cm, (list, tuple))
                  else search_cuda)
        return launch(
            cm, subs_lb, subs_ub, st, gbest, it, pool_head,
            supersteps=supersteps, lane_tile=self.lane_tile,
            max_fixpoint_iters=opts.max_fixpoint_iters,
            var_strategy=opts.var_strategy,
            val_strategy=opts.val_strategy,
            stop_on_first=opts.stop_on_first)


_REGISTRY: Dict[str, Callable[[], PropagationBackend]] = {}


def register_backend(name: str,
                     factory: Callable[[], PropagationBackend]) -> None:
    """Register a backend factory under `name` (last registration wins)."""
    _REGISTRY[name] = factory


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_backend(name: str, **opts) -> PropagationBackend:
    """Instantiate a registered backend (``cuda_resident`` takes
    ``lane_tile``)."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown propagation backend {name!r}; "
            f"available: {', '.join(available_backends())}") from None
    return factory(**opts)


register_backend("gather", GatherBackend)
register_backend("scatter", ScatterBackend)
register_backend("cuda", CudaBackend)
register_backend("cuda_resident", CudaResidentBackend)
