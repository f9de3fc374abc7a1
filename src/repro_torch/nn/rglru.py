"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427; the
port of ``repro/nn/rglru.py``).

Recurrence (per channel):
    r_t = σ(W_a x_t + b_a)          recurrence gate
    i_t = σ(W_x x_t + b_x)          input gate
    a_t = a^(c·r_t)                 a = σ(Λ), c = 8
    h_t = a_t ⊙ h_{t-1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)

The prefill scans h_t = a_t h_{t-1} + b_t, which composes associatively,
by recursive doubling: ⌈log₂ S⌉ steps of whole-sequence ops where the
reference calls ``lax.associative_scan`` (another tree over the same
operator, so the two round apart in f32: ``tests/test_torch_rglru.py``
states the bound).  Decode is the O(1) step.

The block wraps the LRU in the Griffin recurrent-block structure:
gated branch (linear → GeLU, tanh form as ``jax.nn.gelu``'s default) ⊗
(linear → causal conv → RG-LRU) → linear.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as Fn

from repro_torch.nn.layers import F32, cast_bf16, dense
from repro_torch.nn.ssm import _causal_conv


class RGLRUCache(NamedTuple):
    h: torch.Tensor          # [B, W]  LRU hidden state (f32)
    conv: torch.Tensor       # [B, conv-1, W] conv tail
    length: torch.Tensor


def _gates(r, a_param, c: float):
    """(a, √(1 − a²)) from the recurrence gate, in the log domain."""
    log_a = c * r * Fn.logsigmoid(a_param)
    return (torch.exp(log_a),
            torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)))


def _rglru_scan(x, r, i, a_param, c: float):
    """x/r/i [B,S,W] (f32). Returns h [B,S,W] and the final state."""
    a, norm = _gates(r, a_param[None, None, :], c)
    b = norm * (i * x)
    S, d = x.shape[1], 1
    while d < S:
        # element t absorbs element t - d: (a, b) ← (a_{t-d}·a_t,
        # a_t·b_{t-d} + b_t), the reference's `combine(left, right)`
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b, b[:, -1]


def rglru_step(x, r, i, a_param, c: float, h_prev):
    a, norm = _gates(r, a_param[None, :], c)
    h = a * h_prev + norm * (i * x)
    return h, h


def recurrent_block(p, prefix, x, cfg, cache: Optional[RGLRUCache] = None,
                    return_state: bool = False):
    """Griffin recurrent mixing block.  With `return_state` (cache=None):
    returns (out, (h_last, conv_tail)) to prime a decode cache."""
    rg = cfg.rglru
    W = rg.lru_width or cfg.d_model
    S = x.shape[1]

    gate = Fn.gelu(dense(x, p[f"{prefix}/w_gate"]).to(F32),
                   approximate="tanh")
    xr = dense(x, p[f"{prefix}/w_in"])                    # [B,S,W]
    tail = cache.conv if cache is not None else None
    xr, new_tail = _causal_conv(xr, p[f"{prefix}/conv_w"],
                                p[f"{prefix}/conv_b"], tail)
    xf = xr.to(F32)

    def block_diag(w, b):
        """Griffin block-diagonal gate: [H, W/H, W/H] blocks."""
        H = w.shape[0]
        xh = xf.reshape(*xf.shape[:-1], H, W // H)
        y = torch.einsum("...hk,hkj->...hj", xh, w.to(F32))
        return torch.sigmoid(y.reshape(xf.shape) + b.to(F32))

    r = block_diag(p[f"{prefix}/w_a"], p[f"{prefix}/b_a"])
    i = block_diag(p[f"{prefix}/w_x"], p[f"{prefix}/b_x"])
    a_param = p[f"{prefix}/a_param"].to(F32)

    if cache is None:
        h, h_last = _rglru_scan(xf, r, i, a_param, rg.c_exponent)
        new_cache = (h_last, new_tail) if return_state else None
    else:
        hs, h_last = rglru_step(xf[:, 0], r[:, 0], i[:, 0], a_param,
                                rg.c_exponent, cache.h)
        h = hs[:, None]
        new_cache = RGLRUCache(h_last, new_tail, cache.length + S)

    out = dense(cast_bf16(h) * cast_bf16(gate), p[f"{prefix}/w_out"])
    return out, new_cache
