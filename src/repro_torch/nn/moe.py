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

The expert products are plain PyTorch (the reference computes them
outside any Pallas kernel).  The gate and up products reach
``silu(g)·u`` in f32, as the reference's ``preferred_element_type=f32``:
on the card each is one bf16 batched GEMM with an f32 result (f32
accumulation, no rounding in between), on the CPU the product of the
bf16 values widened to f32.  The down product is rounded once to bf16
(`einsum_bf16`).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.nn.layers import (BF16, F32, cast_bf16, einsum_bf16,
                                   einsum_f32, swiglu)


def topk_route(logits, k: int):
    """logits [T, E] f32 → (probs [T,k], idx [T,k]); probs renormalized
    over the selected experts (deepseek/dbrx convention).  A stable
    descending sort keeps ``lax.top_k``'s order: equal logits by index."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    return torch.softmax(vals, dim=-1), idx


def dispatch_indices(idx, n_experts: int, capacity: int):
    """Build the [E, C] token-slot table from [T, k] expert assignments.

    Returns (slot_token [E*C] — flat token index or the T sentinel,
    keep_mask [T, k] — False for capacity-dropped assignments,
    pos [T, k] — each assignment's rank within its expert), int64 where
    the reference's are int32.
    """
    T, k = idx.shape
    dev = idx.device
    flat = idx.reshape(-1)                               # [T*k]
    # rank of each assignment within its expert, in (token, slot) order
    order = torch.argsort(flat, stable=True)
    sorted_e = flat[order]
    counts = torch.bincount(sorted_e, minlength=n_experts)
    seg_start = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(T * k, device=dev) - seg_start[sorted_e]
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted
    keep = rank < capacity
    dest = torch.where(keep, flat * capacity + rank, n_experts * capacity)
    slot_token = torch.full((n_experts * capacity + 1,), T,
                            dtype=torch.int64, device=dev)
    slot_token[dest] = torch.arange(T * k, device=dev) // k
    return slot_token[:-1], keep.reshape(T, k), rank.reshape(T, k)


def _expert_f32(xe, w):
    """xe [E, C, d] @ w [E, d, f] → [E, C, f] f32 from bf16 operands: on
    the card one batched GEMM with an f32 result, on the CPU
    `einsum_f32`."""
    if xe.device.type == "cuda":
        return torch.bmm(cast_bf16(xe), cast_bf16(w), out_dtype=F32)
    return einsum_f32("ecd,edf->ecf", xe, w)


def moe_ffn(p, prefix, x, cfg):
    """x [B, S, d] → MoE SwiGLU output [B, S, d] (+ aux losses dict:
    ``moe_balance``, the Switch-style load-balance loss, and
    ``moe_dropped``, the share of assignments past capacity; 0-d f32)."""
    moe = cfg.moe
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    E, K = moe.n_experts, moe.top_k
    C = int(np.ceil(T * K / E * moe.capacity_factor))
    C = max(8, -(-C // 8) * 8)                          # pad for lanes

    logits = torch.matmul(xt.to(F32), p[f"{prefix}/router"].to(F32))
    probs, idx = topk_route(logits, K)

    slot_token, keep, rank = dispatch_indices(idx, E, C)
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
    me = torch.softmax(logits, -1).mean(0)
    counts = torch.zeros((T, E), dtype=F32, device=x.device)
    counts.scatter_add_(1, idx, torch.ones(idx.shape, dtype=F32,
                                           device=x.device))
    ce = (counts / K).mean(0)
    aux = {"moe_balance": E * torch.sum(me * ce),
           "moe_dropped": 1.0 - keep.to(F32).mean()}
    return cast_bf16(yt).reshape(B, S, d), aux


def _shared_ffn(p, prefix, xt):
    return swiglu(xt, p[f"{prefix}/shared_gate"], p[f"{prefix}/shared_up"],
                  p[f"{prefix}/shared_down"])
