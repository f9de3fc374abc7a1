"""Loss and train step (the port of ``repro/train/train_step.py``).

Loss: next-token cross-entropy over ``labels`` (-1 = ignore), computed in
f32 with logsumexp; the MoE balance aux added with a configurable
weight.  Gradients come from autograd (``torch.autograd.grad`` over the
param leaves; the reference's ``jax.value_and_grad``); the step runs no
kernel of the port, as the reference's runs no Pallas kernel
(``nn/attention.py``).

`sharded_train_step` is one rank's step of data-parallel training over a
``torch.distributed`` group of R ranks, the counterpart of the
reference's step under ``TRAIN_RULES`` on the host mesh (batch over
``data``, every leaf's ``embed`` dim over ``data``: ZeRO-3/FSDP).  Each
rank holds its shard of every param and of the AdamW moments
(`distributed.sharding.spec_for`; a leaf the rule does not divide is
whole on every rank).  Per step it all-gathers the full params, runs the
forward and backward on its rows of the global batch (`rank_rows`),
sums the gradients over the ranks (an all-reduce, then its slice: the
collectives gloo and NCCL share) and keeps its shard, and runs AdamW on
its shards.  The products' weight gradients are summed in f32 before
their one bf16 rounding (`nn.layers.unrounded_weight_grads`), as one
device sums them over the whole batch.  The loss is the global token
mean (the NLL sums and the token counts all-reduced), the clip reads the
global gradient norm, the MoE layers route over the global batch
(`nn.moe.route_group`), and microbatch i of every rank is its share of
the reference's global microbatch i, so the step computes the
reference's global-batch step.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.collectives import (all_gather_flat,
                                                 all_reduce_sum)
from repro_torch.nn import model as MD
from repro_torch.nn.layers import (BF16, set_matmul_precision,
                                   unrounded_weight_grads)
from repro_torch.nn.moe import route_group
from repro_torch.train.optimizer import OptConfig, apply_updates

F32 = torch.float32


def nll_sum(logits, labels):
    """(Σ NLL over the labelled positions, their count) of logits
    [B,S,V] f32 against labels [B,S] int (-1 = ignore)."""
    mask = labels >= 0
    safe = torch.clamp(labels, min=0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, safe[..., None], dim=-1)[..., 0]
    return ((lse - gold) * mask).sum(), mask.sum()


def cross_entropy(logits, labels):
    """logits [B,S,V] f32, labels [B,S] int (-1 = ignore)."""
    total, count = nll_sum(logits, labels)
    return total / torch.clamp(count, min=1)


def loss_fn(params, cfg: ArchConfig, batch: Dict, opt_cfg: OptConfig,
            remat: bool = True, chunks=(1024, 1024)):
    """(total loss, metrics): the cross-entropy (``loss``), plus
    ``moe_balance_weight · moe_balance`` where the model has MoE layers,
    and every aux of the forward in the metrics."""
    logits, aux = MD.forward_train(params, cfg, batch, remat=remat,
                                   chunks=chunks)
    loss = cross_entropy(logits, batch["labels"])
    total = loss
    if "moe_balance" in aux:
        total = total + opt_cfg.moe_balance_weight * aux["moe_balance"]
    return total, {"loss": loss, **aux}


def _global_loss(leaves, cfg: ArchConfig, batch: Dict, opt_cfg: OptConfig,
                 remat, chunks, group):
    """One rank's share of the global loss: (objective, total, metrics).
    The ranks' objectives sum to the global-batch loss (the NLL sum over
    the global token count, and ``moe_balance_weight / R`` of the global
    balance, whose all-reduce sums every rank's cotangent), so the sum of
    their gradients is its gradient.  ``loss`` and ``total`` are the
    global values, equal on every rank."""
    logits, aux = MD.forward_train(leaves, cfg, batch, remat=remat,
                                   chunks=chunks)
    nll, count = nll_sum(logits, batch["labels"])
    n = torch.clamp(all_reduce_sum(count, group), min=1)
    objective = nll / n
    loss = all_reduce_sum(nll.detach(), group) / n
    total = loss
    if "moe_balance" in aux:
        w = opt_cfg.moe_balance_weight
        objective = objective + w / dist.get_world_size(group) \
            * aux["moe_balance"]
        total = total + w * aux["moe_balance"].detach()
    return objective, total, {"loss": loss, **aux}


def loss_and_grads(params, cfg: ArchConfig, batch: Dict, opt_cfg: OptConfig,
                   remat: bool = True, chunks=(1024, 1024), group=None):
    """((total, metrics), grads): `loss_fn` and its gradient with respect
    to every param (a leaf that no path reaches gets zeros), each grad in
    its param's dtype.  On a rank of a process `group`, `batch` is the
    rank's rows, and the loss, the metrics and the grads are the global
    batch's: each rank's share (`_global_loss`) summed over the ranks
    (`_summed_grads`)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    if group is None:
        objective, metrics = loss_fn(leaves, cfg, batch, opt_cfg, remat,
                                     chunks)
        got = torch.autograd.grad(objective, list(leaves.values()),
                                  allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(leaves.items(), got)}
        return (objective.detach(),
                {k: v.detach() for k, v in metrics.items()}), grads
    # the backward recomputes remat'd layers, which route over the group
    stash = {}
    with route_group(group), unrounded_weight_grads(stash):
        objective, total, metrics = _global_loss(
            leaves, cfg, batch, opt_cfg, remat, chunks, group)
        got = torch.autograd.grad(objective, list(leaves.values()),
                                  allow_unused=True)
    grads = _summed_grads(leaves, got, stash, group)
    return (total.detach(), {k: v.detach() for k, v in metrics.items()}), \
        grads


@torch.no_grad()
def _summed_grads(leaves: Dict, got, stash: Dict, group) -> Dict:
    """Each leaf's gradient summed over the ranks: autograd's part (the
    leaves no product reads as bf16: norms, biases, the router, the
    embedding rows), and the products' weight gradients from the stash,
    rounded to bf16 once after the sum, as one device rounds them."""
    out = {}
    for (k, v), g in zip(leaves.items(), got):
        if g is not None:
            g = g.contiguous()
            dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
        entry = stash.get(id(v))
        if entry is not None:
            acc = entry[1]
            dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
            acc = acc.to(BF16).to(F32)
            g = acc if g is None else g + acc
        out[k] = torch.zeros_like(v) if g is None else g
    return out


def _accumulated_grads(params, cfg, batch, opt_cfg, remat, chunks,
                       microbatches, group=None):
    """(total, metrics, grads) of the batch, or averaged over its
    `microbatches` equal slices (grads accumulated in f32)."""
    if microbatches <= 1:
        (total, metrics), grads = loss_and_grads(params, cfg, batch,
                                                 opt_cfg, remat, chunks,
                                                 group)
    else:
        def split(x):
            b = x.shape[0]
            if b % microbatches:
                raise ValueError(f"batch of {b} does not split into "
                                 f"{microbatches} microbatches")
            return x.reshape((microbatches, b // microbatches)
                             + tuple(x.shape[1:]))

        mb = {k: split(v) for k, v in batch.items()}
        grads = {k: torch.zeros(p.shape, dtype=F32, device=p.device)
                 for k, p in params.items()}
        total, ms = 0.0, []
        for i in range(microbatches):
            (t, m), g = loss_and_grads(params, cfg,
                                       {k: v[i] for k, v in mb.items()},
                                       opt_cfg, remat, chunks, group)
            for k in grads:
                grads[k] = grads[k] + g[k].to(F32)
            total = total + t
            ms.append(m)
            del g
        grads = {k: g / microbatches for k, g in grads.items()}
        total = total / microbatches
        metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
    return total, metrics, grads


def train_step(params, opt_state, batch, cfg: ArchConfig,
               opt_cfg: OptConfig, remat: bool = True,
               chunks=(1024, 1024), microbatches: int = 1):
    """One optimizer step; `params` and `opt_state` are updated in place
    and returned (`apply_updates`), with the metrics: the loss's, the
    optimizer's (``lr``, ``grad_norm``) and ``total``.

    ``microbatches > 1``: gradient accumulation in f32 over equal slices
    of the batch's leading axis, then divided by the count; the totals
    and every metric are averaged, as the reference's scan does."""
    set_matmul_precision()
    total, metrics, grads = _accumulated_grads(params, cfg, batch, opt_cfg,
                                               remat, chunks, microbatches)
    params, opt_state, opt_metrics = apply_updates(params, grads, opt_state,
                                                   opt_cfg)
    return params, opt_state, {**metrics, **opt_metrics, "total": total}


# --------------------------------------------------------------------------
# data-parallel training over a process group (ZeRO-3 over `data`)
# --------------------------------------------------------------------------

def shard_dim(sharding) -> "int | None":
    """The dimension a leaf is split on over a 1-D mesh (None: whole)."""
    dims = [i for i, e in enumerate(sharding.spec) if e is not None]
    if len(dims) > 1:
        raise ValueError(f"spec {sharding.spec} splits more than one "
                         "dimension: training shards over a 1-D mesh")
    return dims[0] if dims else None


def shard_params(params: Dict, shardings: Dict, rank: int, world: int
                 ) -> Dict:
    """This rank's piece of every leaf (a copy): the `rank`-th of
    `world` equal slices along its `shard_dim`, or the whole leaf."""
    out = {}
    for k, v in params.items():
        d = shard_dim(shardings[k])
        out[k] = (v.clone() if d is None
                  else v.chunk(world, dim=d)[rank].contiguous())
    return out


@torch.no_grad()
def gather_params(shards: Dict, shardings: Dict, group=None) -> Dict:
    """The full leaves from every rank's pieces (an all-gather per
    sharded leaf, concatenated along its `shard_dim` in rank order)."""
    world = dist.get_world_size(group)
    out = {}
    for k, v in shards.items():
        d = shard_dim(shardings[k])
        if d is None:
            out[k] = v
            continue
        buf = all_gather_flat(v, group)
        shape = list(v.shape)
        shape[d] *= world
        out[k] = buf.view((world,) + tuple(v.shape)).movedim(0, d
                                                           ).reshape(shape)
    return out


def rank_rows(batch: Dict, rank: int, world: int, microbatches: int = 1
              ) -> Dict:
    """This rank's rows of a global batch: of each of the reference's
    `microbatches` equal slices of the batch, the rank-th of `world`
    equal parts, in microbatch order (so the rank's microbatch i is its
    share of global microbatch i, and with one microbatch the rows are
    the rank's contiguous block, as ``batch → data``)."""
    def rows(x):
        B = x.shape[0]
        if B % (microbatches * world):
            raise ValueError(f"global batch {B} does not split into "
                             f"{microbatches} microbatches x {world} ranks")
        per = B // (microbatches * world)
        idx = np.concatenate([np.arange(per) + (i * world + rank) * per
                              for i in range(microbatches)])
        return x[idx]
    return {k: rows(v) for k, v in batch.items()}


def sharded_train_step(params, opt_state, batch, cfg: ArchConfig,
                       opt_cfg: OptConfig, *, shardings: Dict, group=None,
                       remat: bool = True, chunks=(1024, 1024),
                       microbatches: int = 1):
    """One rank's optimizer step over a process `group`: `params` and
    `opt_state` hold the rank's shards (`shard_params` by `shardings`),
    `batch` its rows of the global batch (`rank_rows`); `group` None is
    the default group.  Updated in place and returned with the global
    metrics, as `train_step`'s."""
    set_matmul_precision()
    group = dist.group.WORLD if group is None else group
    full = gather_params(params, shardings, group)
    total, metrics, grads = _accumulated_grads(full, cfg, batch, opt_cfg,
                                               remat, chunks, microbatches,
                                               group)
    del full
    grads = shard_params(grads, shardings, dist.get_rank(group),
                         dist.get_world_size(group))
    sharded = frozenset(k for k in shardings
                        if shard_dim(shardings[k]) is not None)
    params, opt_state, opt_metrics = apply_updates(
        params, grads, opt_state, opt_cfg, group=group, sharded=sharded)
    return params, opt_state, {**metrics, **opt_metrics, "total": total}
