"""Attention (the port of ``repro/nn/attention.py``): blocked
online-softmax attention with GQA/MQA and causal/bidirectional/window
masks, the GQA block with its KV-cache decode (a ring buffer of the
window's size when ``window > 0``), MLA (multi-head latent attention,
deepseek-v2) with its absorbed decode, and the routing of the prefill to
the flash kernel.

`blocked_attention` is plain PyTorch, the reference's chunked online
softmax with its Python loops in place of ``lax.scan``; every decode
step goes through it.  The prefill (`gqa_attention` without a cache)
goes to `kernels.flash_attention.flash_attention` wherever that kernel's
contract holds — causal or bidirectional, no window, query and key
positions both ``arange(S)``, dk == dv — which computes the same function
as the reference's `blocked_attention` there (the encoder of the
encoder-decoder is such a bidirectional prefill).  A windowed or MLA
prefill (q 192 wide, v 128 at deepseek-v2) stays on `blocked_attention`,
as in the reference.

Training takes `blocked_attention` for every cache-less call, as the
reference does (its Pallas flash kernel has no backward, and no module
of its ``nn`` calls it): a call under grad mode whose q requires grad
never reaches the flash kernel, which has no backward either and raises
rather than return an output without a gradient.  Autograd
differentiates `blocked_attention` as written.

One departure from the reference: the windowed decode on the ring's
first lap (fewer tokens than ring slots) gives the slots never written
no softmax weight (`_mask` drops keys of negative position); the
reference attends to their zero keys there (ROADMAP "Reference notes").
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.nn.layers import (F32, apply_rope, cast_bf16, dense,
                                   einsum_bf16, rms_norm)

NEG_INF = -1e30


def _mask(q_pos, kv_pos, kv_valid, *, causal: bool, window: int,
          kv_len=None):
    """[Sq, Sk] boolean validity mask from position vectors."""
    m = kv_valid[None, :].expand(q_pos.shape[-1], kv_pos.shape[-1])
    if causal:
        m = m & (q_pos[:, None] >= kv_pos[None, :])
    if window > 0:
        m = m & (q_pos[:, None] - kv_pos[None, :] < window)
    if kv_len is not None:                       # decode: valid prefix only
        # a ring slot not yet written has a negative position
        m = m & (kv_pos[None, :] >= 0) & (kv_pos[None, :] < kv_len)
    return m


def blocked_attention(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                      window: int = 0, kv_len=None,
                      q_chunk: int = 1024, kv_chunk: int = 1024):
    """q [B,Sq,H,dk], k [B,Sk,KV,dk], v [B,Sk,KV,dv] (H % KV == 0).
    Returns [B,Sq,H,dv] bf16.  Scores in f32 from the bf16 operands, p
    rounded to bf16 before the PV product, as the reference."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    rep = H // KV
    scale = 1.0 / np.sqrt(hd)

    qc = min(q_chunk, Sq)
    kc = min(kv_chunk, Sk)
    # pad ragged tails; padded KV is masked out, padded Q rows are sliced
    pq, pk = (-Sq) % qc, (-Sk) % kc
    kv_valid = torch.arange(Sk + pk, device=q.device) < Sk
    if pq:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pq))
        q_pos = torch.nn.functional.pad(q_pos, (0, pq))
    if pk:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pk))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pk))
        kv_pos = torch.nn.functional.pad(kv_pos, (0, pk))
    Sqp, Skp = Sq + pq, Sk + pk

    outs = []
    for q0 in range(0, Sqp, qc):
        qb = q[:, q0:q0 + qc].reshape(B, qc, KV, rep, hd).to(F32)
        qp = q_pos[q0:q0 + qc]
        acc = torch.zeros((B, KV, rep, qc, dv), dtype=F32, device=q.device)
        m = torch.full((B, KV, rep, qc), NEG_INF, dtype=F32, device=q.device)
        l = torch.zeros((B, KV, rep, qc), dtype=F32, device=q.device)
        for k0 in range(0, Skp, kc):
            kb = k[:, k0:k0 + kc].to(F32)
            vb = v[:, k0:k0 + kc].to(F32)
            s = torch.einsum("bqgrd,bkgd->bgrqk", qb, kb) * scale
            valid = _mask(qp, kv_pos[k0:k0 + kc], kv_valid[k0:k0 + kc],
                          causal=causal, window=window, kv_len=kv_len)
            s = torch.where(valid, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bgrqk,bkgd->bgrqd", cast_bf16(p).to(F32), vb)
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / l.clamp_min(1e-30)[..., None]           # [B,KV,rep,qc,dv]
        outs.append(cast_bf16(out.permute(0, 3, 1, 2, 4)))
    out = torch.cat(outs, dim=1).reshape(B, Sqp, H, dv)
    return out[:, :Sq]


# --------------------------------------------------------------------------
# GQA block (projections + rope + attention)
# --------------------------------------------------------------------------

def gqa_project_qkv(p, prefix, x, cfg):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    bias = ((lambda n: p.get(f"{prefix}/{n}_b")) if cfg.qkv_bias
            else (lambda n: None))
    q = dense(x, p[f"{prefix}/wq"], bias("wq")).reshape(B, S, H, hd)
    k = dense(x, p[f"{prefix}/wk"], bias("wk")).reshape(B, S, KV, hd)
    v = dense(x, p[f"{prefix}/wv"], bias("wv")).reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p[f"{prefix}/q_norm"], cfg.norm_eps)
        k = rms_norm(k, p[f"{prefix}/k_norm"], cfg.norm_eps)
    return q, k, v


class KVCache(NamedTuple):
    k: torch.Tensor          # [B, Smax, KV, hd]
    v: torch.Tensor
    length: torch.Tensor     # int32 — tokens currently in the cache


def _aligned(positions, S: int) -> bool:
    """Whether the positions are ``arange(S)`` (one read to the host).
    A ``meta`` tensor (the dry-run) holds no values: its positions are
    the forwards' own ``arange`` and only the shape is checked."""
    if positions.is_meta:
        return positions.shape == (S,)
    return positions.shape == (S,) and bool(torch.equal(
        positions, torch.arange(S, dtype=positions.dtype,
                                device=positions.device)))


def gqa_attention(p, prefix, x, cfg, positions, *, window: int = 0,
                  causal: bool = True, cache: Optional[KVCache] = None,
                  return_kv: bool = False, q_chunk=1024, kv_chunk=1024):
    """Full GQA block.

    cache=None: full-sequence attention (training and prefill; a
    training call, q requiring grad, takes `blocked_attention`).  With
    `return_kv`, also returns the rope'd (k, v) so the caller can prime
    a decode cache.  cache!=None: decode step(s); the keys are written at
    ``cache.length`` (ring-buffered at ``length % Smax`` iff window > 0;
    decode is S == 1 there) in place (``index_copy_``, where the
    reference's ``dynamic_update_slice`` makes a new array), so the
    caller's cache tensors hold the new entries afterwards.
    """
    B, S, _ = x.shape
    q, k, v = gqa_project_qkv(p, prefix, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta, seq_axis=1)
    k = apply_rope(k, positions, cfg.rope_theta, seq_axis=1)

    if cache is None:
        training = torch.is_grad_enabled() and q.requires_grad
        if (not training and window == 0 and q.shape[-1] == v.shape[-1]
                and _aligned(positions, S)):
            out = flash_attention(q, k, v, causal=causal)
        else:
            out = blocked_attention(q, k, v, positions, positions,
                                    causal=causal, window=window,
                                    q_chunk=q_chunk, kv_chunk=kv_chunk)
        aux = (k, v) if return_kv else None
    else:
        Smax = cache.k.shape[1]
        slot = cache.length % Smax if window > 0 else cache.length
        slots = slot.long() + torch.arange(S, device=x.device)
        ck = cache.k.index_copy_(1, slots, k)
        cv = cache.v.index_copy_(1, slots, v)
        phys = torch.arange(Smax, device=x.device)
        if window > 0:
            # ring buffer: absolute position of physical slot s
            base = cache.length - slot
            kv_pos = torch.where(phys <= slot, base + phys, base - Smax + phys)
        else:
            kv_pos = phys
        q_pos = cache.length + torch.arange(S, dtype=torch.int32,
                                            device=x.device)
        out = blocked_attention(q, ck, cv, q_pos, kv_pos, causal=True,
                                window=window, kv_len=cache.length + S,
                                q_chunk=q_chunk, kv_chunk=kv_chunk)
        aux = KVCache(ck, cv, cache.length + S)
    out = dense(out.reshape(B, S, -1), p[f"{prefix}/wo"])
    return out, aux


# --------------------------------------------------------------------------
# MLA — multi-head latent attention (deepseek-v2), absorbed decode
# --------------------------------------------------------------------------

class MLACache(NamedTuple):
    c_kv: torch.Tensor       # [B, Smax, kv_lora]   compressed KV
    k_rope: torch.Tensor     # [B, Smax, rope_dim]  shared rope key
    length: torch.Tensor


def mla_attention(p, prefix, x, cfg, positions, *,
                  cache: Optional[MLACache] = None, return_kv: bool = False,
                  q_chunk=1024, kv_chunk=1024):
    """Prefill: expand the compressed KV and run `blocked_attention` (with
    `return_kv`, also return (c_kv, k_rope) to prime a decode cache).
    Decode: the absorbed form — queries projected into the latent space,
    the cache ``kv_lora + rope_dim`` wide per position, written in place
    at ``cache.length``."""
    mla = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    nd, rd, vd, kvl = mla.nope_dim, mla.rope_dim, mla.v_dim, mla.kv_lora

    # --- queries (with LoRA) ---
    cq = rms_norm(dense(x, p[f"{prefix}/w_dq"]), p[f"{prefix}/q_norm"],
                  cfg.norm_eps)
    q = dense(cq, p[f"{prefix}/w_uq"]).reshape(B, S, H, nd + rd)
    q_nope = q[..., :nd]
    q_rope = apply_rope(q[..., nd:], positions, cfg.rope_theta, seq_axis=1)

    # --- compressed KV ---
    ckv = rms_norm(dense(x, p[f"{prefix}/w_dkv"]), p[f"{prefix}/kv_norm"],
                   cfg.norm_eps)                               # [B,S,kvl]
    krope = apply_rope(dense(x, p[f"{prefix}/w_kr"]), positions,
                       cfg.rope_theta, seq_axis=1)             # [B,S,rd]

    w_uk = p[f"{prefix}/w_uk"].reshape(kvl, H, nd)
    w_uv = p[f"{prefix}/w_uv"].reshape(kvl, H, vd)

    if cache is None:
        # prefill: expand the K latent into per-head keys; rope part shared
        k_nope = einsum_bf16("bsc,chd->bshd", ckv, w_uk)
        k_full = torch.cat([k_nope, krope[:, :, None, :].expand(B, S, H, rd)],
                           dim=-1)
        v_full = einsum_bf16("bsc,chd->bshd", ckv, w_uv)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        out = blocked_attention(q_full, k_full, v_full, positions, positions,
                                causal=True, q_chunk=q_chunk,
                                kv_chunk=kv_chunk)
        new_cache = (ckv, krope) if return_kv else None
    else:
        # absorbed decode: q' = q_nope @ W_uk -> latent-space scores
        Smax = cache.c_kv.shape[1]
        slots = cache.length.long() + torch.arange(S, device=x.device)
        cc = cache.c_kv.index_copy_(1, slots, ckv)
        cr = cache.k_rope.index_copy_(1, slots, krope)
        q_lat = einsum_bf16("bshd,chd->bshc", q_nope, w_uk)   # [B,S,H,kvl]
        # (c_kv ++ k_rope) as a single-KV-head key of dim kvl + rd
        k_cat = torch.cat([cc, cr], dim=-1)[:, :, None, :]
        q_cat = torch.cat([q_lat, q_rope], dim=-1)
        # scale correction: blocked_attention scales by 1/sqrt(kvl+rd);
        # MLA wants 1/sqrt(nd+rd).  The reference's bf16 q times this
        # numpy float64 is f32
        fix = float(np.float32(np.sqrt(kvl + rd) / np.sqrt(nd + rd)))
        ctx = blocked_attention(
            q_cat.to(F32) * fix, k_cat, cc[:, :, None, :],       # latent v
            cache.length + torch.arange(S, dtype=torch.int32,
                                        device=x.device),
            torch.arange(Smax, device=x.device), causal=True,
            kv_len=cache.length + S, q_chunk=q_chunk, kv_chunk=kv_chunk)
        out = einsum_bf16("bshc,chd->bshd", ctx, w_uv)
        new_cache = MLACache(cc, cr, cache.length + S)

    out = dense(out.reshape(B, S, H * vd), p[f"{prefix}/wo"])
    return out, new_cache
