"""Collectives (the port of ``repro/distributed/collectives.py``).

**The solver half** runs on the in-process mesh.  The reference reduces
over a named mesh axis inside ``shard_map`` (``lax.pmin``/``pmax``); the
port's mesh is driven from one host loop, so a collective takes the D
per-shard 0-d tensors and returns one reduced 0-d tensor on the first
shard's device; an operand moves there only when it lives elsewhere (on
one card nothing moves).  No host read happens here: the caller reads
the reduced flag once per superstep.

**The training half** runs over ``torch.distributed`` process groups, one
process per rank (`launch/train.py --devices N`): `psum_mean`,
`int8_psum_mean` (the reference's 1-byte gradient compression: a MAX
all-reduce of |x| gives every rank the same grid, ``scale = max(absmax,
1e-30)/127``, each rank rounds and clips to int8, the int8 values are
summed in int32, then ``· scale / n``), `pod_sync_grads` (the mean of a
grad dict over the ``pod`` dimension of a device mesh) and
`all_reduce_sum`, a sum that autograd differentiates (its backward sums
the cotangents, as ``psum``'s transpose).  They use only collectives that
both gloo and NCCL have (``all_reduce``, ``all_gather_into_tensor``,
``broadcast``).  gloo takes CUDA tensors for all three (torch 2.11 on
the H100, `chip_smoke.py` phase 39): it stages them through the host
itself, so the port copies nothing explicitly.
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist


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


# -- training: reductions over torch.distributed process groups -------------

def psum_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of `x` over the ranks of `group` (a new tensor)."""
    y = x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y / dist.get_world_size(group)


def int8_psum_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of `x` over the ranks of `group` with an int8 payload:
    every rank quantizes onto one grid (the MAX all-reduce of |x|), the
    int8 values are summed in int32, and the sum is scaled back; f32.
    Each element is off the exact mean by at most ``scale / 2``."""
    absmax = x.abs().max().to(torch.float32).reshape(1)
    dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(absmax, min=1e-30) / 127.0
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127
                    ).to(torch.int8)
    s = q.to(torch.int32)               # n ≤ 2^24 participants fit int32
    dist.all_reduce(s, op=dist.ReduceOp.SUM, group=group)
    return (s.to(torch.float32) * scale) / float(dist.get_world_size(group))


def pod_sync_grads(grads: Dict, mesh=None, axis: str = "pod",
                   compress: bool = True) -> Dict:
    """Average a grad dict over the `axis` dimension of `mesh` (a
    ``torch.distributed.device_mesh.DeviceMesh``): each leaf is reduced
    over the ranks that differ only in their `axis` coordinate (the
    group of that mesh dimension), in int8 with `compress`.  A mesh
    without `axis` (or none) returns `grads` itself.  Each leaf keeps
    its dtype."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return grads
    op = int8_psum_mean if compress else psum_mean
    group = mesh.get_group(axis)
    return {k: op(g, group).to(g.dtype) for k, g in grads.items()}


def all_gather_flat(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's `x` concatenated along dim 0 in rank order, ``[R·d0,
    ...]`` (``all_gather_into_tensor``, which torch 2.13 marks deprecated
    for ``all_gather_single``, a name torch 2.11 lacks)."""
    world = dist.get_world_size(group)
    out = torch.empty((world * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", category=FutureWarning,
                                message=".*all_gather_into_tensor")
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the cotangents (every rank
    holds the summed value, and each one's cotangent flows to every
    rank's operand)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group=None,
                   differentiable: Optional[bool] = None) -> torch.Tensor:
    """The sum of `x` over the ranks of `group`, as a new tensor; under
    autograd (`differentiable`, default: whether `x` requires grad) its
    backward all-reduces the cotangent."""
    if differentiable is None:
        differentiable = x.requires_grad
    if differentiable:
        return _AllReduceSum.apply(x, group)
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y
