"""Block-level assembly (the port of ``repro/nn/transformer.py``): every
layer family as (specs, forward) pairs side by side.

Params are flat dicts keyed by "<prefix>/<name>"; blocks are pre-norm
residual; caches are NamedTuples from the layer modules.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.nn import attention as A
from repro_torch.nn import moe as M
from repro_torch.nn import rglru as RG
from repro_torch.nn import ssm as SSM
from repro_torch.nn.layers import ParamSpec, Specs, dense, rms_norm, swiglu


def sub(params: Dict, prefix: str) -> Dict:
    pre = prefix + "/"
    return {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}


def add(specs: Specs, prefix: str, more: Specs) -> None:
    for k, v in more.items():
        specs[f"{prefix}/{k}"] = v


def gqa_specs(cfg: ArchConfig) -> Specs:
    H, KV, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_model
    s: Specs = {
        "wq": ParamSpec((d, H * hd), ("embed", "heads")),
        "wk": ParamSpec((d, KV * hd), ("embed", "kv")),
        "wv": ParamSpec((d, KV * hd), ("embed", "kv")),
        "wo": ParamSpec((H * hd, d), ("heads", "embed")),
    }
    if cfg.qkv_bias:
        s["wq_b"] = ParamSpec((H * hd,), ("heads",), init="zeros")
        s["wk_b"] = ParamSpec((KV * hd,), ("kv",), init="zeros")
        s["wv_b"] = ParamSpec((KV * hd,), ("kv",), init="zeros")
    if cfg.qk_norm:
        s["q_norm"] = ParamSpec((hd,), (None,), init="ones")
        s["k_norm"] = ParamSpec((hd,), (None,), init="ones")
    return s


def mla_specs(cfg: ArchConfig) -> Specs:
    mla = cfg.mla
    H, d = cfg.n_heads, cfg.d_model
    nd, rd, vd = mla.nope_dim, mla.rope_dim, mla.v_dim
    return {
        "w_dq": ParamSpec((d, mla.q_lora), ("embed", None)),
        "q_norm": ParamSpec((mla.q_lora,), (None,), init="ones"),
        "w_uq": ParamSpec((mla.q_lora, H * (nd + rd)), (None, "heads")),
        "w_dkv": ParamSpec((d, mla.kv_lora), ("embed", None)),
        "kv_norm": ParamSpec((mla.kv_lora,), (None,), init="ones"),
        "w_kr": ParamSpec((d, rd), ("embed", None)),
        "w_uk": ParamSpec((mla.kv_lora, H * nd), (None, "heads")),
        "w_uv": ParamSpec((mla.kv_lora, H * vd), (None, "heads")),
        "wo": ParamSpec((H * vd, d), ("heads", "embed")),
    }


def ffn_specs(d: int, ff: int) -> Specs:
    return {
        "w_gate": ParamSpec((d, ff), ("embed", "mlp")),
        "w_up": ParamSpec((d, ff), ("embed", "mlp")),
        "w_down": ParamSpec((ff, d), ("mlp", "embed")),
    }


def moe_specs(cfg: ArchConfig) -> Specs:
    moe = cfg.moe
    d, E, fe = cfg.d_model, moe.n_experts, moe.d_expert
    s: Specs = {
        "router": ParamSpec((d, E), ("embed", None)),
        "w_gate": ParamSpec((E, d, fe), ("expert", "embed", "mlp")),
        "w_up": ParamSpec((E, d, fe), ("expert", "embed", "mlp")),
        "w_down": ParamSpec((E, fe, d), ("expert", "mlp", "embed")),
    }
    if moe.n_shared > 0:
        fs = moe.n_shared * fe
        s["shared_gate"] = ParamSpec((d, fs), ("embed", "mlp"))
        s["shared_up"] = ParamSpec((d, fs), ("embed", "mlp"))
        s["shared_down"] = ParamSpec((fs, d), ("mlp", "embed"))
    return s


def ssm_specs(cfg: ArchConfig) -> Specs:
    ssm = cfg.ssm
    d = cfg.d_model
    d_in = ssm.expand * d
    H = d_in // ssm.head_dim
    conv_dim = d_in + 2 * ssm.n_groups * ssm.state
    return {
        "in_proj": ParamSpec((d, d_in + conv_dim + H), ("embed", "mlp")),
        "conv_w": ParamSpec((ssm.conv, conv_dim), (None, "mlp")),
        "conv_b": ParamSpec((conv_dim,), ("mlp",), init="zeros"),
        "dt_bias": ParamSpec((H,), (None,), init="zeros"),
        "A_log": ParamSpec((H,), (None,), init="zeros"),
        "D": ParamSpec((H,), (None,), init="ones"),
        "out_norm": ParamSpec((d_in,), ("mlp",), init="ones"),
        "out_proj": ParamSpec((d_in, d), ("mlp", "embed")),
    }


def rglru_specs(cfg: ArchConfig) -> Specs:
    rg = cfg.rglru
    d = cfg.d_model
    W = rg.lru_width or d
    H = cfg.n_heads                      # griffin: block-diagonal gates
    return {
        "w_gate": ParamSpec((d, W), ("embed", "mlp")),
        "w_in": ParamSpec((d, W), ("embed", "mlp")),
        "conv_w": ParamSpec((rg.conv, W), (None, "mlp")),
        "conv_b": ParamSpec((W,), ("mlp",), init="zeros"),
        "w_a": ParamSpec((H, W // H, W // H), ("heads", None, None)),
        "b_a": ParamSpec((W,), (None,), init="zeros"),
        "w_x": ParamSpec((H, W // H, W // H), ("heads", None, None)),
        "b_x": ParamSpec((W,), (None,), init="zeros"),
        "a_param": ParamSpec((W,), (None,), init="ones"),
        "w_out": ParamSpec((W, d), ("mlp", "embed")),
    }


def xattn_specs(cfg: ArchConfig) -> Specs:
    H, KV, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_model
    return {
        "wq": ParamSpec((d, H * hd), ("embed", "heads")),
        "wk": ParamSpec((d, KV * hd), ("embed", "kv")),
        "wv": ParamSpec((d, KV * hd), ("embed", "kv")),
        "wo": ParamSpec((H * hd, d), ("heads", "embed")),
    }


def norm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), (None,), init="ones")


# ==========================================================================
# forward blocks (pre-norm residual)
# ==========================================================================

def run_attn(p, x, cfg, positions, *, window=0, causal=True, cache=None,
             prime=False, chunks=(1024, 1024)):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if cfg.mla is not None:
        o, cache = A.mla_attention(p, "attn", h, cfg, positions, cache=cache,
                                   return_kv=prime, q_chunk=chunks[0],
                                   kv_chunk=chunks[1])
    else:
        o, cache = A.gqa_attention(p, "attn", h, cfg, positions,
                                   window=window, causal=causal, cache=cache,
                                   return_kv=prime, q_chunk=chunks[0],
                                   kv_chunk=chunks[1])
    return x + o, cache


def run_ffn(p, x, cfg):
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + swiglu(h, p["ffn/w_gate"], p["ffn/w_up"], p["ffn/w_down"])


def run_moe(p, x, cfg):
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    o, aux = M.moe_ffn(p, "moe", h, cfg)
    return x + o, aux


def run_ssm(p, x, cfg, cache=None, prime=False):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    o, cache = SSM.ssm_block(p, "ssm", h, cfg, cache=cache,
                             return_state=prime)
    return x + o, cache


def run_rglru(p, x, cfg, cache=None, prime=False):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    o, cache = RG.recurrent_block(p, "rec", h, cfg, cache=cache,
                                  return_state=prime)
    return x + o, cache


def run_cross_attn(p, x, enc_kv, cfg, chunks=(1024, 1024)):
    """Decoder cross-attention; enc_kv = (k, v) [B, S_enc, KV, hd]."""
    h = rms_norm(x, p["norm_x"], cfg.norm_eps)
    B, S, _ = h.shape
    H, hd = cfg.n_heads, cfg.hd
    q = dense(h, p["xattn/wq"]).reshape(B, S, H, hd)
    k, v = enc_kv
    S_enc = k.shape[1]
    zeros = (lambda n: torch.zeros(n, dtype=torch.int32,  # noqa: E731
                                   device=x.device))
    o = A.blocked_attention(q, k, v, zeros(S), zeros(S_enc), causal=False,
                            q_chunk=min(chunks[0], S),
                            kv_chunk=min(chunks[1], S_enc))
    return x + dense(o.reshape(B, S, H * hd), p["xattn/wo"])


def cross_kv(p, enc_out, cfg):
    B, S_enc, _ = enc_out.shape
    KV, hd = cfg.n_kv_heads, cfg.hd
    k = dense(enc_out, p["xattn/wk"]).reshape(B, S_enc, KV, hd)
    v = dense(enc_out, p["xattn/wv"]).reshape(B, S_enc, KV, hd)
    return k, v
