"""Loss and train step (the port of ``repro/train/train_step.py``).

Loss: next-token cross-entropy over ``labels`` (-1 = ignore), computed in
f32 with logsumexp; the MoE balance aux added with a configurable
weight.  Gradients come from autograd (``torch.autograd.grad`` over the
param leaves; the reference's ``jax.value_and_grad``); the step runs no
kernel of the port, as the reference's runs no Pallas kernel
(``nn/attention.py``).
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.nn import model as MD
from repro_torch.nn.layers import set_matmul_precision
from repro_torch.train.optimizer import OptConfig, apply_updates

F32 = torch.float32


def cross_entropy(logits, labels):
    """logits [B,S,V] f32, labels [B,S] int (-1 = ignore)."""
    mask = labels >= 0
    safe = torch.clamp(labels, min=0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, safe[..., None], dim=-1)[..., 0]
    nll = (lse - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1)


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


def loss_and_grads(params, cfg: ArchConfig, batch: Dict, opt_cfg: OptConfig,
                   remat: bool = True, chunks=(1024, 1024)):
    """((total, metrics), grads): `loss_fn` and its gradient with respect
    to every param (a leaf that no path reaches gets zeros), each grad in
    its param's dtype."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    total, metrics = loss_fn(leaves, cfg, batch, opt_cfg, remat, chunks)
    got = torch.autograd.grad(total, list(leaves.values()),
                              allow_unused=True)
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(leaves.items(), got)}
    return (total.detach(), {k: v.detach() for k, v in metrics.items()}), \
        grads


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
    if microbatches <= 1:
        (total, metrics), grads = loss_and_grads(params, cfg, batch,
                                                 opt_cfg, remat, chunks)
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
                                       opt_cfg, remat, chunks)
            for k in grads:
                grads[k] = grads[k] + g[k].to(F32)
            total = total + t
            ms.append(m)
            del g
        grads = {k: g / microbatches for k, g in grads.items()}
        total = total / microbatches
        metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}

    params, opt_state, opt_metrics = apply_updates(params, grads, opt_state,
                                                   opt_cfg)
    return params, opt_state, {**metrics, **opt_metrics, "total": total}
