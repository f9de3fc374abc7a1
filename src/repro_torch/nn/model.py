"""Whole-model assembly (the port of ``repro/nn/model.py``, dense family):
param specs, prefill and decode forwards, KV caches.

The decoder stack is one homogeneous group of ``n_layers`` dense blocks
(pre-norm GQA attention + SwiGLU FFN).  A group of more than one layer
keeps its params stacked ``[L, ...]`` under one prefix, as the
reference's; a Python loop over the layers takes the place of its
``scan_layers`` (so ``nn/scanctl.py`` has no counterpart), and its decode
caches carry the same leading layer axis.

Not ported yet (ROADMAP queue 1 item 9): the MoE, MLA, SSM, hybrid
(RG-LRU), encoder-decoder and ViT-stub families, ``forward_train`` and
everything of training; each raises.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.nn import transformer as T
from repro_torch.nn.attention import PENDING, KVCache
from repro_torch.nn.layers import (ParamSpec, Specs, embed_lookup, rms_norm,
                                   unembed)


def _check_family(cfg: ArchConfig):
    if cfg.family != "dense" or any(
            (cfg.moe, cfg.mla, cfg.ssm, cfg.rglru, cfg.encdec, cfg.frontend)):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} {PENDING}; the port runs "
            "dense GQA decoders")


def decoder_groups(cfg: ArchConfig) -> List[Tuple[str, int, str]]:
    """[(kind, count, prefix)] for the decoder stack."""
    _check_family(cfg)
    return [("dense", cfg.n_layers, "blocks")]


def _block_specs(cfg: ArchConfig, kind: str) -> Specs:
    if kind != "dense":
        raise NotImplementedError(f"block kind {kind!r} {PENDING}")
    d = cfg.d_model
    s: Specs = {"norm1": T.norm_spec(d), "norm2": T.norm_spec(d)}
    T.add(s, "attn", T.gqa_specs(cfg))
    T.add(s, "ffn", T.ffn_specs(d, cfg.d_ff))
    return s


def _stack(specs: Specs, n: int) -> Specs:
    return {k: ParamSpec((n,) + v.shape, ("layers",) + v.axes, v.init,
                         v.scale) for k, v in specs.items()}


def param_specs(cfg: ArchConfig) -> Specs:
    d, V = cfg.d_model, cfg.vocab
    s: Specs = {
        "embed/tok": ParamSpec((V, d), ("vocab", "embed"), init="embed"),
        "final_norm": T.norm_spec(d),
    }
    if not cfg.tie_embeddings:
        s["unembed/w"] = ParamSpec((V, d), ("vocab", "embed"), init="embed")
    for kind, count, prefix in decoder_groups(cfg):
        bs = _block_specs(cfg, kind)
        if count > 1:
            bs = _stack(bs, count)
        for k, v in bs.items():
            s[f"{prefix}/{k}"] = v
    return s


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------

def _kv_cache(cfg, B, smax, n=None, device=None, dtype=torch.bfloat16):
    KV, hd = cfg.n_kv_heads, cfg.hd
    lead = (n,) if n else ()
    k = torch.zeros(lead + (B, smax, KV, hd), dtype=dtype, device=device)
    return KVCache(k, torch.zeros_like(k),
                   torch.zeros(lead, dtype=torch.int32, device=device))


def init_cache(cfg: ArchConfig, B: int, smax: int, device=None):
    """Zero caches for decoding up to `smax` tokens."""
    return {prefix: _kv_cache(cfg, B, smax, count if count > 1 else None,
                              device)
            for _, count, prefix in decoder_groups(cfg)}


# --------------------------------------------------------------------------
# block forward (single layer)
# --------------------------------------------------------------------------

def _run_block(kind: str, p, x, cfg, positions, cache, chunks,
               prime: bool = False):
    """Returns (x, new_cache_or_primed_state, aux)."""
    if kind != "dense":
        raise NotImplementedError(f"block kind {kind!r} {PENDING}")
    x, cache = T.run_attn(p, x, cfg, positions, cache=cache, prime=prime,
                          chunks=chunks)
    return T.run_ffn(p, x, cfg), cache, {}


def _layers(params, prefix: str, count: int):
    """Each layer's params of a group: the slices of a stacked group."""
    group = T.sub(params, prefix)
    if count == 1:
        return [group]
    return [{k: v[i] for k, v in group.items()} for i in range(count)]


# --------------------------------------------------------------------------
# public forwards
# --------------------------------------------------------------------------

def _embed_inputs(params, cfg, batch):
    """tokens -> (x [B,S,d], positions [S], n_prefix = 0)."""
    if cfg.frontend is not None:
        raise NotImplementedError(f"frontend {cfg.frontend!r} {PENDING}")
    x = embed_lookup(params["embed/tok"], batch["tokens"])
    S = x.shape[1]
    return x, torch.arange(S, dtype=torch.int32, device=x.device), 0


def _pad_prefix(arr, smax: int, seq_axis: int = 1):
    """[B, S, ...] KV written into a zeroed [B, smax, ...] cache (with a
    leading layer axis, ``seq_axis=2``: the reference vmaps instead)."""
    S = arr.shape[seq_axis]
    pad = [0, 0] * (arr.ndim - seq_axis - 1) + [0, smax - S]
    return torch.nn.functional.pad(arr, pad)


def _assemble_cache(kind, raw, cfg, smax: int, S: int, stacked: bool):
    """Primed per-layer (k, v) — stacked [L, B, S, KV, hd] or one layer's
    [B, S, KV, hd] — as a decode cache of `smax` slots holding S tokens."""
    if kind != "dense":
        raise NotImplementedError(f"block kind {kind!r} {PENDING}")
    k, v = (_pad_prefix(a, smax, 2 if stacked else 1) for a in raw)
    lead = k.shape[:1] if stacked else ()
    return KVCache(k, v, torch.full(lead, S, dtype=torch.int32,
                                    device=k.device))


def forward_prefill(params, cfg: ArchConfig, batch, smax: int,
                    chunks=(1024, 1024)):
    """Process a prompt with full-sequence attention (the flash kernel),
    then *prime* decode caches from each layer's (k, v).  Returns
    (last-token logits [B, V] f32, caches)."""
    x, positions, _ = _embed_inputs(params, cfg, batch)
    S = x.shape[1]
    caches = {}
    for kind, count, prefix in decoder_groups(cfg):
        raw = []
        for lp in _layers(params, prefix, count):
            x, kv, _ = _run_block(kind, lp, x, cfg, positions, None, chunks,
                                  prime=True)
            raw.append(kv)
        if count > 1:
            raw = tuple(torch.stack(t) for t in zip(*raw))
        else:
            raw = raw[0]
        caches[prefix] = _assemble_cache(kind, raw, cfg, smax, S, count > 1)
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = unembed(x, params.get("unembed/w", params["embed/tok"]))
    return logits[:, 0], caches


def forward_decode(params, cfg: ArchConfig, tokens, caches,
                   chunks=(1, 1024)):
    """One decode step: tokens [B, 1] → logits [B, V] f32, updated caches
    (the cache tensors are written in place; see `gqa_attention`)."""
    x = embed_lookup(params["embed/tok"], tokens)
    # absolute position = current cache length (uniform across batch)
    positions = _cache_length(cfg, caches)[None].to(torch.int32)
    new_caches = {}
    for kind, count, prefix in decoder_groups(cfg):
        c = caches[prefix]
        for i, lp in enumerate(_layers(params, prefix, count)):
            lc = c if count == 1 else KVCache(c.k[i], c.v[i], c.length[i])
            x, _, _ = _run_block(kind, lp, x, cfg, positions, lc, chunks)
        new_caches[prefix] = KVCache(c.k, c.v, c.length + tokens.shape[1])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(x, params.get("unembed/w", params["embed/tok"]))
    return logits[:, 0], new_caches


def _cache_length(cfg, caches):
    length = caches[decoder_groups(cfg)[0][2]].length
    return length[0] if length.ndim else length
