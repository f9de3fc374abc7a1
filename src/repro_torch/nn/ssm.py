"""Mamba-2 SSD block (state-space duality, arXiv:2405.21060; the port of
``repro/nn/ssm.py``).

Prefill: the chunked SSD algorithm — intra-chunk quadratic (attention-like
with a causal decay mask) plus the inter-chunk recurrence, a Python loop
over the chunks where the reference scans.  Decode: the O(1) recurrence
h' = dA·h + dt·(B ⊗ x), y = C·h' + D·x.

Shapes follow the reference: d_inner = expand·d_model, heads of
head_dim, B/C shared across `n_groups` groups, state N per head channel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as Fn

from repro_torch.nn.layers import (BF16, F32, cast_bf16, dense, einsum_f32,
                                   rms_norm)


class SSMCache(NamedTuple):
    h: torch.Tensor          # [B, H, hd, N]  SSM state (f32)
    conv: torch.Tensor       # [B, conv-1, conv_dim]  causal-conv tail
    length: torch.Tensor


def _segsum(x):
    """log-decay matrix: L[i,j] = sum_{j<k<=i} x[k] (lower-tri), else -inf."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    L = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    return L.masked_fill(~mask, -torch.inf)


def _causal_conv(x, w, b, cache_tail=None):
    """Depthwise causal conv, width W. x [B,S,Cd] bf16, w [W,Cd] f32.
    With cache_tail [B,W-1,Cd]: streaming (decode) mode.  Returns
    (silu(conv + b) in x's dtype, the last W-1 inputs as the new tail)."""
    W = w.shape[0]
    if cache_tail is None:
        pad = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    else:
        pad = cache_tail.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    out = sum(xp[:, i:i + S, :] * w[i][None, None, :] for i in range(W))
    new_tail = xp[:, xp.shape[1] - (W - 1):, :]
    return Fn.silu((out + b[None, None, :]).to(F32)).to(x.dtype), new_tail


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int):
    """SSD over full sequences.
    xh [B,S,H,hd]; dt [B,S,H] (post-softplus); A [H] (negative);
    Bm/Cm [B,S,G,N].  Returns y [B,S,H,hd] bf16 and the final state
    [B,H,hd,N] f32.
    """
    B_, S, H, hd = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    # pad ragged tails with dt=0 positions: decay exp(0)=1 and zero input
    # contribution make padding state-neutral; padded outputs are sliced.
    S0 = S
    pad = (-S) % chunk
    if pad:
        def zp(a):
            return Fn.pad(a, (0, 0) * (a.ndim - 2) + (0, pad))
        xh, dt, Bm, Cm = zp(xh), zp(dt), zp(Bm), zp(Cm)
        S = S + pad
    nc = S // chunk
    rep = H // G

    xc = xh.reshape(B_, nc, chunk, H, hd)
    dtc = dt.reshape(B_, nc, chunk, H)
    Bc = Bm.reshape(B_, nc, chunk, G, N).to(F32)
    Cc = Cm.reshape(B_, nc, chunk, G, N).to(F32)
    dA = dtc * A[None, None, None, :]                    # [B,nc,Q,H]

    # ---- intra-chunk (quadratic, attention-like) ----
    Ls = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))     # [B,nc,H,Q,Q]
    CB = torch.einsum("bnqgs,bnkgs->bngqk", Cc, Bc)
    CB = torch.repeat_interleave(CB, rep, dim=2)         # groups -> heads
    M = CB * Ls * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_diag = einsum_f32("bnhqk,bnkhd->bnqhd", M, xc)

    # ---- chunk states & inter-chunk recurrence ----
    cs = torch.cumsum(dA, dim=2)
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)      # [B,nc,Q,H]
    states = torch.einsum("bnqgs,bnqh,bnqhd->bnhds", Bc,
                          (dtc * decay_to_end).to(F32), xc.to(F32))
    chunk_decay = torch.exp(dA.sum(dim=2))               # [B,nc,H]

    h = torch.zeros((B_, H, hd, N), dtype=F32, device=xh.device)
    h_prev = []
    for n in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, n, :, None, None] + states[:, n]
    h_prev = torch.stack(h_prev, dim=1)                  # [B,nc,H,hd,N]

    # ---- contribution of previous state to each position ----
    decay_from_start = torch.exp(cs)                     # [B,nc,Q,H]
    Ch = torch.repeat_interleave(Cc, rep, dim=3) if G != H else Cc
    y_off = torch.einsum("bnqhs,bnhds,bnqh->bnqhd", Ch, h_prev,
                         decay_from_start.to(F32))
    y = (y_diag + y_off).reshape(B_, S, H, hd)
    return cast_bf16(y[:, :S0]), h


def ssm_block(p, prefix, x, cfg, cache: Optional[SSMCache] = None,
              return_state: bool = False):
    """Full mamba2 block: in_proj → conv → SSD → gated norm → out_proj.
    With `return_state` (cache=None): returns (out, (h_final, conv_tail))
    so the caller can prime a decode cache."""
    ssm = cfg.ssm
    B, S, d = x.shape
    d_in = ssm.expand * cfg.d_model
    H = d_in // ssm.head_dim
    hd, N, G = ssm.head_dim, ssm.state, ssm.n_groups
    conv_dim = d_in + 2 * G * N

    zxbcdt = dense(x, p[f"{prefix}/in_proj"])
    z, xbc, dt_raw = torch.split(zxbcdt, [d_in, conv_dim, H], dim=-1)
    dt = Fn.softplus(dt_raw.to(F32) + p[f"{prefix}/dt_bias"].to(F32))
    A = -torch.exp(p[f"{prefix}/A_log"].to(F32))                  # [H]

    tail = cache.conv if cache is not None else None
    xbc, new_tail = _causal_conv(xbc, p[f"{prefix}/conv_w"],
                                 p[f"{prefix}/conv_b"], tail)
    xh, Bm, Cm = torch.split(xbc, [d_in, G * N, G * N], dim=-1)
    xh = xh.reshape(B, S, H, hd)
    Bm = Bm.reshape(B, S, G, N)
    Cm = Cm.reshape(B, S, G, N)

    if cache is None:
        y, hT = ssd_chunked(xh, dt, A, Bm, Cm, ssm.chunk)
        new_cache = (hT, new_tail) if return_state else None
    else:
        # O(1) decode recurrence (S == 1)
        dA = torch.exp(dt[:, 0] * A[None, :])                      # [B,H]
        dBx = torch.einsum("bgs,bh,bhd->bhds", Bm[:, 0].to(F32), dt[:, 0],
                           xh[:, 0].to(F32))
        h = cache.h * dA[..., None, None] + dBx
        rep = H // G
        Cr = (torch.repeat_interleave(Cm[:, 0], rep, dim=1) if G != H
              else Cm[:, 0])
        y = torch.einsum("bhs,bhds->bhd", Cr.to(F32), h)
        y = cast_bf16(y)[:, None]                                  # [B,1,H,hd]
        new_cache = SSMCache(h, new_tail, cache.length + S)

    y = y + xh * p[f"{prefix}/D"].to(BF16)[None, None, :, None]
    y = y.reshape(B, S, d_in)
    y = rms_norm(y * cast_bf16(Fn.silu(z.to(F32))), p[f"{prefix}/out_norm"],
                 cfg.norm_eps)
    return dense(y, p[f"{prefix}/out_proj"]), new_cache
