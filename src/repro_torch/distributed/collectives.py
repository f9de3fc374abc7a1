"""Collectives of the in-process mesh — the solver half of
``repro/distributed/collectives.py``.

The reference reduces over a named mesh axis inside ``shard_map``
(``lax.pmin``/``pmax``).  The port's mesh is driven from one host loop,
so a collective takes the D per-shard 0-d tensors and returns one reduced
0-d tensor on the first shard's device; an operand moves there only when
it lives elsewhere (on one card nothing moves).  No host read happens
here: the caller reads the reduced flag once per superstep.

The gradient reductions of training (`int8_psum_mean`, `psum_mean`,
`pod_sync_grads`) are not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _stacked(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    dev = xs[0].device
    return torch.stack([x if x.device == dev else x.to(dev) for x in xs])


def all_min(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Min over the shards' values: the shared branch & bound bound."""
    return _stacked(xs).min()


def all_any(flags: Sequence[torch.Tensor]) -> torch.Tensor:
    """Boolean OR over the shards' flags."""
    return _stacked(flags).any()


def all_every(flags: Sequence[torch.Tensor]) -> torch.Tensor:
    """Boolean AND over the shards' flags."""
    return _stacked(flags).all()


def solver_bound_sync(best, done, any_sol):
    """One bound-sharing round of the distributed EPS engine, given each
    shard's incumbent bound, done flag and has-solution flag: the global
    bound is the min over shards, the pool is exhausted only when EVERY
    shard is done, and a solution exists iff SOME shard has one.  Runs
    once per mesh superstep (`api._run_mesh_chunk`), so every lane on
    every shard prunes against the best objective found anywhere."""
    return all_min(best), all_every(done), all_any(any_sol)
