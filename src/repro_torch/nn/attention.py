"""Attention (the port of ``repro/nn/attention.py``, dense GQA): blocked
online-softmax attention with GQA/MQA and causal/bidirectional/window
masks, the GQA block with its KV-cache decode, and the routing of the
prefill to the flash kernel.

`blocked_attention` is plain PyTorch, the reference's chunked online
softmax with its Python loops in place of ``lax.scan``; every decode
step goes through it.  The prefill (`gqa_attention` without a cache)
goes to `kernels.flash_attention.flash_attention` wherever that kernel's
contract holds — causal, no window, query and key positions both
``arange(S)``, dk == dv — which computes the same function as the
reference's `blocked_attention` there.

Not ported yet (ROADMAP queue 1 item 9): the ring-buffer KV cache of
``window > 0`` and MLA (``cfg.mla``); both raise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.nn.layers import F32, apply_rope, cast_bf16, dense, rms_norm

NEG_INF = -1e30
PENDING = "not ported yet (ROADMAP queue 1 item 9)"


def _mask(q_pos, kv_pos, kv_valid, *, causal: bool, window: int,
          kv_len=None):
    """[Sq, Sk] boolean validity mask from position vectors."""
    m = kv_valid[None, :].expand(q_pos.shape[-1], kv_pos.shape[-1])
    if causal:
        m = m & (q_pos[:, None] >= kv_pos[None, :])
    if window > 0:
        m = m & (q_pos[:, None] - kv_pos[None, :] < window)
    if kv_len is not None:                       # decode: valid prefix only
        m = m & (kv_pos[None, :] < kv_len)
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
    """Whether the positions are ``arange(S)`` (one read to the host)."""
    return positions.shape == (S,) and bool(torch.equal(
        positions, torch.arange(S, dtype=positions.dtype,
                                device=positions.device)))


def gqa_attention(p, prefix, x, cfg, positions, *, window: int = 0,
                  causal: bool = True, cache: Optional[KVCache] = None,
                  return_kv: bool = False, q_chunk=1024, kv_chunk=1024):
    """Full GQA block.

    cache=None: full-sequence attention (prefill).  With `return_kv`,
    also returns the rope'd (k, v) so the caller can prime a decode
    cache.  cache!=None: decode step(s); the keys are written at
    ``cache.length`` in place (``index_copy_``, where the reference's
    ``dynamic_update_slice`` makes a new array), so the caller's cache
    tensors hold the new entries afterwards.
    """
    if cfg.mla is not None:
        raise NotImplementedError(f"MLA attention: {PENDING}")
    if window > 0:
        raise NotImplementedError(f"the windowed ring-buffer cache: {PENDING}")
    B, S, _ = x.shape
    q, k, v = gqa_project_qkv(p, prefix, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta, seq_axis=1)
    k = apply_rope(k, positions, cfg.rope_theta, seq_axis=1)

    if cache is None:
        if causal and q.shape[-1] == v.shape[-1] and _aligned(positions, S):
            out = flash_attention(q, k, v, causal=True)
        else:
            out = blocked_attention(q, k, v, positions, positions,
                                    causal=causal, q_chunk=q_chunk,
                                    kv_chunk=kv_chunk)
        aux = (k, v) if return_kv else None
    else:
        Smax = cache.k.shape[1]
        slots = cache.length.long() + torch.arange(S, device=x.device)
        ck = cache.k.index_copy_(1, slots, k)
        cv = cache.v.index_copy_(1, slots, v)
        kv_pos = torch.arange(Smax, device=x.device)
        q_pos = cache.length + torch.arange(S, dtype=torch.int32,
                                            device=x.device)
        out = blocked_attention(q, ck, cv, q_pos, kv_pos, causal=True,
                                kv_len=cache.length + S,
                                q_chunk=q_chunk, kv_chunk=kv_chunk)
        aux = KVCache(ck, cv, cache.length + S)
    out = dense(out.reshape(B, S, -1), p[f"{prefix}/wo"])
    return out, aux
