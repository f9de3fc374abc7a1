"""Mixture-of-experts FFN (the port of ``repro/nn/moe.py``): top-k
token-choice routing with capacity-based gather dispatch (an index
gather, O(T·k) memory) and grouped expert products.

The capacity rule and its drops are the reference's bit for bit:
``C = max(8, ⌈T·K/E·1.25⌉ rounded up to 8)``; each assignment's rank
within its expert in (token, slot) order from a stable sort; an
assignment ranked past C is dropped and contributes zero.  Dropped
assignments all write the sentinel slot ``E·C``, which is sliced away,
so which of those writes lands there (unspecified on the card) never
matters.  The router runs in f32.

Under a process group of R data ranks (`route_group`, set by the
sharded training step) each rank routes its own rows of the global batch
with the reference's *global* semantics, which its SPMD forward has over
the whole batch: ``C`` comes from the global token count (R times the
rank's, the batch being split evenly), an assignment's rank within its
expert counts every assignment to that expert on lower ranks (an
all-gather of the ``[R, E]`` per-expert counts, whose exclusive prefix
sum offsets the local ranks), and ``moe_balance`` and ``moe_dropped``
are global means (a differentiable all-reduce of the sums behind ``me``,
a plain one of ``ce``'s and of the kept count).  A token's expert output
depends on that token alone, so each rank runs its kept tokens through
the experts in its own ``[E, C]`` table.  With no group, or one rank,
nothing changes.  The per-expert counts are a ``scatter_add_`` (no
``bincount``), so the layer also traces on the ``meta`` device
(`launch/dryrun.py`).

The expert products are plain PyTorch (the reference computes them
outside any Pallas kernel).  The gate and up products reach
``silu(g)·u`` in f32, as the reference's ``preferred_element_type=f32``,
through `ExpertProductF32` on every device: on the card one bf16 batched
GEMM with an f32 result (f32 accumulation, no rounding in between), on
the CPU the product of the bf16 values widened to f32.  Autograd has no
derivative for that GEMM (``torch.bmm(..., out_dtype=f32)``, torch
2.11), so the function's backward is the reference VJP's two products.
The down product is rounded once to bf16 (`einsum_bf16`).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.nn.layers import (BF16, F32, cast_bf16, current_stash,
                                   einsum_bf16, einsum_f32, stash_add,
                                   swiglu)


def topk_route(logits, k: int):
    """logits [T, E] f32 → (probs [T,k], idx [T,k]); probs renormalized
    over the selected experts (deepseek/dbrx convention).  A stable
    descending sort keeps ``lax.top_k``'s order: equal logits by index."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    return torch.softmax(vals, dim=-1), idx


# the process group the MoE layers route over (None: each call routes its
# own tokens); a process-wide setting, since a rank is a process and the
# backward's recomputation (remat) may run on autograd's own threads
_ROUTE_GROUP = None


@contextlib.contextmanager
def route_group(group):
    """Route every MoE layer called inside over the ranks of `group`
    (a ``torch.distributed`` process group, or None for local routing)
    with the reference's global-batch semantics."""
    global _ROUTE_GROUP
    prev, _ROUTE_GROUP = _ROUTE_GROUP, group
    try:
        yield
    finally:
        _ROUTE_GROUP = prev


def _ranks():
    """(group, rank, world) of the routing group; (None, 0, 1) without
    one."""
    g = _ROUTE_GROUP
    if g is None:
        return None, 0, 1
    return g, dist.get_rank(g), dist.get_world_size(g)


def expert_counts(flat, n_experts: int):
    """Assignments per expert, int64 ``[E]``: ``bincount`` as a
    ``scatter_add_``, which the ``meta`` device also traces."""
    return torch.zeros(n_experts, dtype=torch.int64,
                       device=flat.device).scatter_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int64))


def dispatch_indices(idx, n_experts: int, capacity: int, offset=None):
    """Build the [E, C] token-slot table from [T, k] expert assignments.

    Returns (slot_token [E*C] — flat token index or the T sentinel,
    keep_mask [T, k] — False for capacity-dropped assignments,
    pos [T, k] — each assignment's rank within its expert), int64 where
    the reference's are int32.  `offset` ([E], optional) counts the
    assignments to each expert that come before these tokens (on lower
    ranks): an assignment is kept while its offset plus its own rank is
    below `capacity`, and takes its own rank as its slot.
    """
    T, k = idx.shape
    dev = idx.device
    flat = idx.reshape(-1)                               # [T*k]
    # rank of each assignment within its expert, in (token, slot) order
    order = torch.argsort(flat, stable=True)
    sorted_e = flat[order]
    counts = expert_counts(sorted_e, n_experts)
    seg_start = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(T * k, device=dev) - seg_start[sorted_e]
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted
    keep = rank < capacity if offset is None else \
        rank + offset[flat] < capacity
    dest = torch.where(keep, flat * capacity + rank, n_experts * capacity)
    slot_token = torch.full((n_experts * capacity + 1,), T,
                            dtype=torch.int64, device=dev)
    slot_token[dest] = torch.arange(T * k, device=dev) // k
    return slot_token[:-1], keep.reshape(T, k), rank.reshape(T, k)


class ExpertProductF32(torch.autograd.Function):
    """bf16 xe [E, C, d] @ bf16(w) [E, d, f] → [E, C, f] in f32: on the
    card one batched GEMM with an f32 result.  The backward is the
    reference VJP's (``preferred_element_type=f32``): the f32 cotangent
    times the other operand widened to f32, each product rounded to bf16
    (the weight's then widened back to its own dtype).  Given a `stash`
    (`layers.unrounded_weight_grads`), the weight's f32 product goes
    there unrounded instead."""

    @staticmethod
    def forward(ctx, xe, w, stash=None):
        wb = w.detach().to(BF16)
        ctx.save_for_backward(xe, wb)
        ctx.w, ctx.stash = w, stash
        if xe.device.type == "cuda":
            return torch.bmm(xe, wb, out_dtype=F32)
        return torch.bmm(xe.to(F32), wb.to(F32))

    @staticmethod
    def backward(ctx, g):
        xe, wb = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.bmm(g, wb.to(F32).transpose(1, 2)).to(xe.dtype)
        if ctx.needs_input_grad[1]:
            gw = torch.bmm(xe.to(F32).transpose(1, 2), g)
            if ctx.stash is not None:
                stash_add(ctx.stash, ctx.w, gw)
                gw = None
            else:
                gw = gw.to(BF16).to(ctx.w.dtype)
        return gx, gw, None


def _expert_f32(xe, w):
    """xe [E, C, d] @ w [E, d, f] → [E, C, f] f32 from bf16 operands
    (`ExpertProductF32`; inside `layers.unrounded_weight_grads` its
    weight gradient goes to the stash)."""
    stash = current_stash() if w.requires_grad else None
    return ExpertProductF32.apply(cast_bf16(xe), w, stash)


def moe_ffn(p, prefix, x, cfg):
    """x [B, S, d] → MoE SwiGLU output [B, S, d] (+ aux losses dict:
    ``moe_balance``, the Switch-style load-balance loss, and
    ``moe_dropped``, the share of assignments past capacity; 0-d f32)."""
    moe = cfg.moe
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    E, K = moe.n_experts, moe.top_k
    group, r, R = _ranks()
    Tg = T * R                                          # global tokens
    C = int(np.ceil(Tg * K / E * moe.capacity_factor))
    C = max(8, -(-C // 8) * 8)                          # pad for lanes

    logits = torch.matmul(xt.to(F32), p[f"{prefix}/router"].to(F32))
    probs, idx = topk_route(logits, K)

    offset = None
    if R > 1:
        from repro_torch.distributed.collectives import all_gather_flat
        # every rank's per-expert counts; lower ranks come first
        mine = expert_counts(idx.reshape(-1), E)
        every = all_gather_flat(mine, group).view(R, E)
        offset = every[:r].sum(0)
    slot_token, keep, rank = dispatch_indices(idx, E, C, offset)
    zero_row = torch.zeros((1, d), dtype=BF16, device=x.device)
    xpad = torch.cat([cast_bf16(xt), zero_row])
    xe = xpad[slot_token].reshape(E, C, d)              # gather dispatch

    g = _expert_f32(xe, p[f"{prefix}/w_gate"])
    u = _expert_f32(xe, p[f"{prefix}/w_up"])
    h = cast_bf16(torch.nn.functional.silu(g) * u)
    ye = einsum_bf16("ecf,efd->ecd", h, p[f"{prefix}/w_down"])

    # combine: each (token, slot) gathers its expert output × prob
    # (bf16 gather, f32 accumulation)
    flat_dest = torch.where(keep.reshape(-1),
                            idx.reshape(-1) * C + rank.reshape(-1), E * C)
    ypad = torch.cat([ye.reshape(E * C, d), zero_row])
    per_assign = ypad[flat_dest].reshape(T, K, d)
    yt = einsum_f32("tkd,tk->td", per_assign, probs)

    # shared experts (deepseek): dense SwiGLU of width n_shared · d_expert
    if moe.n_shared > 0:
        yt = yt + _shared_ffn(p, prefix, xt).to(F32)

    # aux: load-balance loss (Switch-style) — what training reads
    counts = torch.zeros((T, E), dtype=F32, device=x.device)
    counts.scatter_add_(1, idx, torch.ones(idx.shape, dtype=F32,
                                           device=x.device))
    if R > 1:
        from repro_torch.distributed.collectives import all_reduce_sum
        me = all_reduce_sum(torch.softmax(logits, -1).sum(0), group) / Tg
        ce = all_reduce_sum((counts / K).sum(0), group,
                            differentiable=False) / Tg
        kept = all_reduce_sum(keep.to(F32).sum(), group,
                              differentiable=False)
        dropped = 1.0 - kept / (Tg * K)
    else:
        me = torch.softmax(logits, -1).mean(0)
        ce = (counts / K).mean(0)
        dropped = 1.0 - keep.to(F32).mean()
    aux = {"moe_balance": E * torch.sum(me * ce), "moe_dropped": dropped}
    return cast_bf16(yt).reshape(B, S, d), aux


def _shared_ffn(p, prefix, xt):
    return swiglu(xt, p[f"{prefix}/shared_gate"], p[f"{prefix}/shared_up"],
                  p[f"{prefix}/shared_down"])
