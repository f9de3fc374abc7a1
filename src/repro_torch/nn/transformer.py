"""Block-level assembly (the port of ``repro/nn/transformer.py``, dense
GQA family): spec functions and forward functions side by side.

Params are flat dicts keyed by "<prefix>/<name>"; blocks are pre-norm
residual.  The MLA, MoE, SSM, RG-LRU and cross-attention blocks of the
reference are not ported yet (ROADMAP queue 1 item 9).
"""

from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ArchConfig
from repro_torch.nn import attention as A
from repro_torch.nn.layers import ParamSpec, Specs, rms_norm, swiglu


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


def ffn_specs(d: int, ff: int) -> Specs:
    return {
        "w_gate": ParamSpec((d, ff), ("embed", "mlp")),
        "w_up": ParamSpec((d, ff), ("embed", "mlp")),
        "w_down": ParamSpec((ff, d), ("mlp", "embed")),
    }


def norm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), (None,), init="ones")


def run_attn(p, x, cfg, positions, *, window=0, causal=True, cache=None,
             prime=False, chunks=(1024, 1024)):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    o, cache = A.gqa_attention(p, "attn", h, cfg, positions, window=window,
                               causal=causal, cache=cache, return_kv=prime,
                               q_chunk=chunks[0], kv_chunk=chunks[1])
    return x + o, cache


def run_ffn(p, x, cfg):
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + swiglu(h, p["ffn/w_gate"], p["ffn/w_up"], p["ffn/w_down"])
