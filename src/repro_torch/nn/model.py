"""Whole-model assembly (the port of ``repro/nn/model.py``): param specs,
the training forward, prefill and decode forwards, caches.

Families (configs/base.py): dense | moe | vlm | hybrid | audio | ssm.
Layer stacks are grouped into homogeneous *groups*; a group of more than
one layer keeps its params stacked ``[L, ...]`` under one prefix, as the
reference's, and a size-1 group is unstacked (e.g. deepseek's leading
dense layer).  A Python loop over a group's layers takes the place of the
reference's ``scan_layers`` (`nn/scanctl.py` ports only the remat
policy).
Caches mirror the group structure with a leading layer axis; a hybrid
period's cache is a dict of its sub-layers' caches.  Decode writes every
cache in place: the KV and latent caches at the new position
(``index_copy_``), a stacked group's recurrent states and lengths into
their layer's slice.

Modality frontends are stubs, as in the reference: the caller provides
precomputed patch (``patch_embeds``) or frame (``frames``) embeddings,
and a learned projection (``frontend/proj``) maps them into the model.

Training (`forward_train`) writes no cache and nothing in place, so
autograd sees the whole forward.  With ``remat``, each layer of a
stacked group runs under `scanctl.checkpoint` (``torch.utils.checkpoint``,
non-reentrant), the counterpart of the reference's ``scanctl.checkpoint``
of its scan body: by default only the layer's input is kept and the
backward recomputes the rest; under ``scanctl.remat_policy("dots")`` the
products without batch dims are kept too.
A stacked leaf reaches its layers through one ``unbind``, so its
gradient is one stack of the layers' gradients.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.nn import transformer as T
from repro_torch.nn.attention import KVCache, MLACache, gqa_attention
from repro_torch.nn.layers import (BF16, F32, ParamSpec, Specs, dense,
                                   embed_lookup, rms_norm, unembed)
from repro_torch.nn.rglru import RGLRUCache
from repro_torch.nn.scanctl import checkpoint
from repro_torch.nn.ssm import SSMCache

# --------------------------------------------------------------------------
# group structure
# --------------------------------------------------------------------------


def decoder_groups(cfg: ArchConfig) -> List[Tuple[str, int, str]]:
    """[(kind, count, prefix)] for the decoder stack."""
    L = cfg.n_layers
    if cfg.family == "ssm":
        return [("ssm", L, "blocks")]
    if cfg.family == "hybrid":
        pat = cfg.rglru.pattern
        groups = [("period", L // len(pat), "periods")]
        for i in range(L % len(pat)):
            groups.append((f"tail_{pat[i]}", 1, f"tail{i}"))
        return groups
    if cfg.moe is not None:
        groups = []
        if cfg.moe.first_dense:
            groups.append(("dense", cfg.moe.first_dense, "dense0"))
        groups.append(("moe", L - cfg.moe.first_dense, "blocks"))
        return groups
    return [("dense", L, "blocks")]


def _is(kind: str, base: str) -> bool:
    """A sub-layer kind of a hybrid period, or its trailing form."""
    return kind == base or kind.startswith(f"tail_{base}")


# --------------------------------------------------------------------------
# param specs
# --------------------------------------------------------------------------

def _block_specs(cfg: ArchConfig, kind: str) -> Specs:
    d = cfg.d_model
    s: Specs = {}
    if kind in ("dense", "moe"):
        s["norm1"] = T.norm_spec(d)
        s["norm2"] = T.norm_spec(d)
        T.add(s, "attn", T.mla_specs(cfg) if cfg.mla else T.gqa_specs(cfg))
        if kind == "dense":
            ff = (cfg.moe.d_ff_dense if (cfg.moe and cfg.moe.d_ff_dense)
                  else cfg.d_ff)
            T.add(s, "ffn", T.ffn_specs(d, ff))
        else:
            T.add(s, "moe", T.moe_specs(cfg))
    elif kind == "ssm":
        s["norm1"] = T.norm_spec(d)
        T.add(s, "ssm", T.ssm_specs(cfg))
    elif _is(kind, "rec"):
        s["norm1"] = T.norm_spec(d)
        T.add(s, "rec", T.rglru_specs(cfg))
        s["norm2"] = T.norm_spec(d)
        T.add(s, "ffn", T.ffn_specs(d, cfg.d_ff))
    elif _is(kind, "attn") or kind == "enc":
        s["norm1"] = T.norm_spec(d)
        T.add(s, "attn", T.gqa_specs(cfg))
        s["norm2"] = T.norm_spec(d)
        T.add(s, "ffn", T.ffn_specs(d, cfg.d_ff))
    elif kind == "period":
        for i, sub_kind in enumerate(cfg.rglru.pattern):
            sk = "rec" if sub_kind == "rec" else "attn"
            T.add(s, f"sub{i}_{sub_kind}", _block_specs(cfg, sk))
    elif kind == "dec":
        s["norm1"] = T.norm_spec(d)
        T.add(s, "attn", T.gqa_specs(cfg))
        s["norm_x"] = T.norm_spec(d)
        T.add(s, "xattn", T.xattn_specs(cfg))
        s["norm2"] = T.norm_spec(d)
        T.add(s, "ffn", T.ffn_specs(d, cfg.d_ff))
    else:
        raise ValueError(kind)
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

    if cfg.encdec is not None:
        s["frontend/proj"] = ParamSpec((d, d), ("embed", None))
        s["enc_final_norm"] = T.norm_spec(d)
        for k, v in _stack(_block_specs(cfg, "enc"),
                           cfg.encdec.enc_layers).items():
            s[f"enc_blocks/{k}"] = v
        for k, v in _stack(_block_specs(cfg, "dec"),
                           cfg.encdec.dec_layers).items():
            s[f"dec_blocks/{k}"] = v
        return s

    if cfg.frontend == "vit_stub":
        s["frontend/proj"] = ParamSpec((d, d), ("embed", None))

    for kind, count, prefix in decoder_groups(cfg):
        bs = _block_specs(cfg, kind)
        if count > 1:
            bs = _stack(bs, count)
        for k, v in bs.items():
            s[f"{prefix}/{k}"] = v
    return s


def active_param_fraction(cfg: ArchConfig, path: str) -> float:
    """Per-token activation fraction (MoE routed experts only)."""
    if cfg.moe is not None and "/moe/w_" in path:
        return cfg.moe.top_k / cfg.moe.n_experts
    return 1.0


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------

def _lengths(n, device):
    return torch.zeros((n,) if n else (), dtype=torch.int32, device=device)


def _kv_cache(cfg, B, smax, n=None, device=None, dtype=BF16):
    KV, hd = cfg.n_kv_heads, cfg.hd
    lead = (n,) if n else ()
    k = torch.zeros(lead + (B, smax, KV, hd), dtype=dtype, device=device)
    return KVCache(k, torch.zeros_like(k), _lengths(n, device))


def _mla_cache(cfg, B, smax, n=None, device=None, dtype=BF16):
    mla = cfg.mla
    lead = (n,) if n else ()
    return MLACache(
        torch.zeros(lead + (B, smax, mla.kv_lora), dtype=dtype, device=device),
        torch.zeros(lead + (B, smax, mla.rope_dim), dtype=dtype,
                    device=device),
        _lengths(n, device))


def _ssm_cache(cfg, B, n=None, device=None):
    ssm = cfg.ssm
    d_in = ssm.expand * cfg.d_model
    H = d_in // ssm.head_dim
    conv_dim = d_in + 2 * ssm.n_groups * ssm.state
    lead = (n,) if n else ()
    return SSMCache(
        torch.zeros(lead + (B, H, ssm.head_dim, ssm.state), dtype=F32,
                    device=device),
        torch.zeros(lead + (B, ssm.conv - 1, conv_dim), dtype=BF16,
                    device=device),
        _lengths(n, device))


def _rglru_cache(cfg, B, n=None, device=None):
    W = cfg.rglru.lru_width or cfg.d_model
    lead = (n,) if n else ()
    return RGLRUCache(
        torch.zeros(lead + (B, W), dtype=F32, device=device),
        torch.zeros(lead + (B, cfg.rglru.conv - 1, W), dtype=BF16,
                    device=device),
        _lengths(n, device))


def init_cache(cfg: ArchConfig, B: int, smax: int, device=None):
    """Zero caches for decoding up to `smax` tokens (window archs use a
    ring buffer of the window size — bounded state)."""
    if cfg.encdec is not None:
        KV, hd = cfg.n_kv_heads, cfg.hd
        nL = cfg.encdec.dec_layers
        shape = (nL, B, cfg.frontend_tokens, KV, hd)
        return {"self": _kv_cache(cfg, B, smax, nL, device),
                "cross_k": torch.zeros(shape, dtype=BF16, device=device),
                "cross_v": torch.zeros(shape, dtype=BF16, device=device)}
    caches = {}
    window = min(cfg.rglru.window, smax) if cfg.rglru else 0
    for kind, count, prefix in decoder_groups(cfg):
        n = count if count > 1 else None
        if kind in ("dense", "moe"):
            c = (_mla_cache(cfg, B, smax, n, device) if cfg.mla
                 else _kv_cache(cfg, B, smax, n, device))
        elif kind == "ssm":
            c = _ssm_cache(cfg, B, n, device)
        elif kind == "period":
            c = {f"sub{i}": (_rglru_cache(cfg, B, n, device) if sk == "rec"
                             else _kv_cache(cfg, B, window, n, device))
                 for i, sk in enumerate(cfg.rglru.pattern)}
        elif _is(kind, "rec"):
            c = _rglru_cache(cfg, B, None, device)
        elif _is(kind, "attn"):
            c = _kv_cache(cfg, B, window, None, device)
        else:
            raise ValueError(kind)
        caches[prefix] = c
    return caches


def _cache_slice(c, i: int):
    """Layer i's view of a stacked cache (a cache tuple or a period's
    dict of them)."""
    if isinstance(c, dict):
        return {k: _cache_slice(v, i) for k, v in c.items()}
    return type(c)(*(t[i] for t in c))


def _cache_store(c, i: int, new):
    """Write layer i's decoded cache into the stacked cache `c`; a KV or
    latent cache written in place already (the same storage) is left."""
    if isinstance(c, dict):
        for k in c:
            _cache_store(c[k], i, new[k])
        return
    for dst, src in zip(c, new):
        d = dst[i]
        if d.data_ptr() != src.data_ptr():
            d.copy_(src)


# --------------------------------------------------------------------------
# block forward (single layer)
# --------------------------------------------------------------------------

def _run_block(kind: str, p, x, cfg, positions, cache, chunks,
               prime: bool = False):
    """Returns (x, new_cache_or_primed_state, aux)."""
    aux = {}
    if kind in ("dense", "moe"):
        x, cache = T.run_attn(p, x, cfg, positions, cache=cache,
                              prime=prime, chunks=chunks)
        if kind == "dense":
            x = T.run_ffn(p, x, cfg)
        else:
            x, aux = T.run_moe(p, x, cfg)
    elif kind == "ssm":
        x, cache = T.run_ssm(p, x, cfg, cache=cache, prime=prime)
    elif _is(kind, "rec"):
        x, cache = T.run_rglru(p, x, cfg, cache=cache, prime=prime)
        x = T.run_ffn(p, x, cfg)
    elif _is(kind, "attn"):
        x, cache = T.run_attn(p, x, cfg, positions,
                              window=cfg.rglru.window, cache=cache,
                              prime=prime, chunks=chunks)
        x = T.run_ffn(p, x, cfg)
    elif kind == "period":
        new_c = {}
        for i, sk in enumerate(cfg.rglru.pattern):
            sp = T.sub(p, f"sub{i}_{sk}")
            ci = cache[f"sub{i}"] if cache is not None else None
            x, nc, _ = _run_block("rec" if sk == "rec" else "attn",
                                  sp, x, cfg, positions, ci, chunks, prime)
            new_c[f"sub{i}"] = nc
        cache = new_c if (cache is not None or prime) else None
    else:
        raise ValueError(kind)
    return x, cache, aux


def _stacked(params, prefix: str):
    """Each layer's params of a stacked group: its slices (views, one
    ``unbind`` per leaf)."""
    group = T.sub(params, prefix)
    return [dict(zip(group, layer))
            for layer in zip(*(v.unbind(0) for v in group.values()))]


def _layers(params, prefix: str, count: int):
    """Each layer's params of a decoder group (a size-1 group unstacked)."""
    return [T.sub(params, prefix)] if count == 1 else _stacked(params,
                                                                prefix)


# --------------------------------------------------------------------------
# public forwards
# --------------------------------------------------------------------------

def _arange(S: int, device):
    return torch.arange(S, dtype=torch.int32, device=device)


def _embed_inputs(params, cfg, batch):
    """tokens (+ stub modality inputs) -> (x [B,S,d], positions [S],
    n_prefix) where n_prefix = frontend tokens prepended before text."""
    x = embed_lookup(params["embed/tok"], batch["tokens"])
    n_prefix = 0
    if cfg.frontend == "vit_stub":
        pe = dense(batch["patch_embeds"], params["frontend/proj"])
        x = torch.cat([pe, x], dim=1)
        n_prefix = pe.shape[1]
    return x, _arange(x.shape[1], x.device), n_prefix


def _logits(params, cfg, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(x, params.get("unembed/w", params["embed/tok"]))
    return logits[:, 0]


def _merge_aux(acc: Dict, aux: Dict):
    for k, v in aux.items():
        acc[k] = acc.get(k, 0.0) + v
    return acc


def _remat(on: bool, fn, *args):
    """``fn(*args)``, under `scanctl.checkpoint` (the ambient remat
    policy) when `on`."""
    if on:
        return checkpoint(fn, *args)
    return fn(*args)


def _train_block(kind, lp, x, cfg, positions, chunks):
    x, _, aux = _run_block(kind, lp, x, cfg, positions, None, chunks)
    return x, aux


def forward_train(params, cfg: ArchConfig, batch, *, remat: bool = True,
                  chunks=(1024, 1024)):
    """Teacher-forced logits [B, S, V] f32 (the ViT stub's patch prefix
    sliced off) and the aux losses, each summed over the layers (MoE:
    ``moe_balance``, ``moe_dropped``).  With `remat`, each layer of a
    stacked group is recomputed in the backward (a size-1 group is not,
    as in the reference)."""
    if cfg.encdec is not None:
        return _forward_encdec_train(params, cfg, batch, remat=remat,
                                     chunks=chunks)
    x, positions, n_prefix = _embed_inputs(params, cfg, batch)
    aux: Dict = {}
    for kind, count, prefix in decoder_groups(cfg):
        for lp in _layers(params, prefix, count):
            x, a = _remat(remat and count > 1, _train_block, kind, lp, x,
                          cfg, positions, chunks)
            _merge_aux(aux, a)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(x, params.get("unembed/w", params["embed/tok"]))
    if n_prefix:
        logits = logits[:, n_prefix:]
    return logits, aux


def _pad_prefix(arr, smax: int, seq_axis: int = 1):
    """[B, S, ...] KV written into a zeroed [B, smax, ...] cache (with a
    leading layer axis, ``seq_axis=2``: the reference vmaps instead)."""
    S = arr.shape[seq_axis]
    if S > smax:
        raise ValueError(f"a prefill of {S} positions does not fit a decode "
                         f"cache of {smax}")
    pad = [0, 0] * (arr.ndim - seq_axis - 1) + [0, smax - S]
    return torch.nn.functional.pad(arr, pad)


def _place_ring(arr, W: int, seq_axis: int = 1):
    """[B, S, ...] → ring buffer [B, W, ...] holding the last min(S, W)
    entries at physical slots ((S-w+i) mod W) — matches the decode-side
    ring reconstruction in `gqa_attention` (``seq_axis=2`` with a
    leading layer axis)."""
    S = arr.shape[seq_axis]
    w = min(S, W)
    phys = (S - w + torch.arange(w, device=arr.device)) % W
    shape = list(arr.shape)
    shape[seq_axis] = W
    return arr.new_zeros(shape).index_copy_(seq_axis, phys,
                                            arr.narrow(seq_axis, S - w, w))


def _assemble_cache(kind, raw, cfg, smax: int, S: int, stacked: bool):
    """Primed per-layer states — stacked with a leading layer axis, or one
    layer's — as a decode cache of `smax` slots holding S tokens."""
    if kind == "period":
        return {f"sub{i}": _assemble_cache("rec" if sk == "rec" else "attn",
                                           raw[f"sub{i}"], cfg, smax, S,
                                           stacked)
                for i, sk in enumerate(cfg.rglru.pattern)}
    seq_axis = 2 if stacked else 1
    lengths = torch.full(raw[0].shape[:1] if stacked else (), S,
                         dtype=torch.int32, device=raw[0].device)
    if kind in ("dense", "moe"):
        a, b = (_pad_prefix(t, smax, seq_axis) for t in raw)
        return (MLACache if cfg.mla is not None else KVCache)(a, b, lengths)
    if kind == "ssm":
        return SSMCache(*raw, lengths)
    if _is(kind, "rec"):
        return RGLRUCache(*raw, lengths)
    if _is(kind, "attn"):
        W = min(cfg.rglru.window, smax)
        k, v = (_place_ring(t, W, seq_axis) for t in raw)
        return KVCache(k, v, lengths)
    raise ValueError(kind)


def _stack_raw(raws):
    """Per-layer primed states (tuples, or a period's dict of tuples)
    stacked along a new leading layer axis."""
    if isinstance(raws[0], dict):
        return {k: _stack_raw([r[k] for r in raws]) for k in raws[0]}
    return tuple(torch.stack(t) for t in zip(*raws))


def forward_prefill(params, cfg: ArchConfig, batch, smax: int,
                    chunks=(1024, 1024)):
    """Process a prompt with full-sequence attention (the flash kernel
    wherever its contract holds), then *prime* decode caches from each
    layer's state.  Returns (last-token logits [B, V] f32, caches)."""
    if cfg.encdec is not None:
        return _prefill_encdec(params, cfg, batch, smax, chunks)
    x, positions, _ = _embed_inputs(params, cfg, batch)
    S = x.shape[1]
    caches = {}
    for kind, count, prefix in decoder_groups(cfg):
        raw = []
        for lp in _layers(params, prefix, count):
            x, st, _ = _run_block(kind, lp, x, cfg, positions, None, chunks,
                                  prime=True)
            raw.append(st)
        raw = _stack_raw(raw) if count > 1 else raw[0]
        caches[prefix] = _assemble_cache(kind, raw, cfg, smax, S, count > 1)
    return _logits(params, cfg, x[:, -1:]), caches


def forward_decode(params, cfg: ArchConfig, tokens, caches,
                   chunks=(1, 1024)):
    """One decode step: tokens [B, 1] → logits [B, V] f32, updated caches
    (written in place; see the module docstring)."""
    if cfg.encdec is not None:
        return _decode_encdec(params, cfg, tokens, caches, chunks)
    x = embed_lookup(params["embed/tok"], tokens)
    # absolute position = current cache length (uniform across batch); a
    # copy, since the lengths are written in place below
    positions = _cache_length(cfg, caches).reshape(1).clone()
    new_caches = {}
    for kind, count, prefix in decoder_groups(cfg):
        c = caches[prefix]
        if count == 1:
            x, c, _ = _run_block(kind, T.sub(params, prefix), x, cfg,
                                 positions, c, chunks)
        else:
            for i, lp in enumerate(_stacked(params, prefix)):
                x, nc, _ = _run_block(kind, lp, x, cfg, positions,
                                      _cache_slice(c, i), chunks)
                _cache_store(c, i, nc)
        new_caches[prefix] = c
    return _logits(params, cfg, x), new_caches


# --------------------------------------------------------------------------
# encoder-decoder (seamless)
# --------------------------------------------------------------------------

def _enc_layer(lp, x, cfg, pos, chunks):
    """One encoder layer: bidirectional self-attention, then the FFN."""
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    o, _ = gqa_attention(lp, "attn", h, cfg, pos, causal=False,
                         q_chunk=chunks[0], kv_chunk=chunks[1])
    return T.run_ffn(lp, x + o, cfg)


def _encode(params, cfg, frames, chunks, remat: bool = False):
    """The encoder over the frames: [B, S_enc, d] after its final norm."""
    enc = dense(frames.to(BF16), params["frontend/proj"])
    pos_e = _arange(enc.shape[1], enc.device)
    for lp in _stacked(params, "enc_blocks"):
        enc = _remat(remat, _enc_layer, lp, enc, cfg, pos_e, chunks)
    return rms_norm(enc, params["enc_final_norm"], cfg.norm_eps)


def _dec_train_layer(lp, x, enc, cfg, pos, chunks):
    x, _ = T.run_attn(lp, x, cfg, pos, chunks=chunks)
    x = T.run_cross_attn(lp, x, T.cross_kv(lp, enc, cfg), cfg, chunks)
    return T.run_ffn(lp, x, cfg)


def _forward_encdec_train(params, cfg, batch, *, remat, chunks):
    """Seamless, teacher-forced: the encoder, then the decoder with
    cross-attention to it; logits [B, S, V] f32, no aux."""
    enc = _encode(params, cfg, batch["frames"], chunks, remat)
    x = embed_lookup(params["embed/tok"], batch["tokens"])
    pos_d = _arange(x.shape[1], x.device)
    for lp in _stacked(params, "dec_blocks"):
        x = _remat(remat, _dec_train_layer, lp, x, enc, cfg, pos_d, chunks)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(x, params.get("unembed/w", params["embed/tok"])), {}


def encode_and_prime(params, cfg, batch, smax, chunks=(1024, 1024)):
    """Seamless: run the (bidirectional) encoder, prime the cross-KV
    caches, and an empty self-attention cache."""
    frames = batch["frames"]
    enc = _encode(params, cfg, frames, chunks)
    ck, cv = zip(*(T.cross_kv(lp, enc, cfg)
                   for lp in _stacked(params, "dec_blocks")))
    return {"self": _kv_cache(cfg, frames.shape[0], smax,
                              cfg.encdec.dec_layers, enc.device),
            "cross_k": torch.stack(ck), "cross_v": torch.stack(cv)}


def _prefill_encdec(params, cfg, batch, smax, chunks):
    """Seamless: encoder pass + cross-KV priming + teacher-forced decoder
    prefill over the prompt tokens."""
    caches = encode_and_prime(params, cfg, batch, smax, chunks)
    x = embed_lookup(params["embed/tok"], batch["tokens"])
    S = x.shape[1]
    pos = _arange(S, x.device)
    raw = []
    for i, lp in enumerate(_stacked(params, "dec_blocks")):
        x, kv = T.run_attn(lp, x, cfg, pos, prime=True, chunks=chunks)
        x = T.run_cross_attn(lp, x, (caches["cross_k"][i],
                                     caches["cross_v"][i]), cfg, chunks)
        x = T.run_ffn(lp, x, cfg)
        raw.append(kv)
    caches["self"] = _assemble_cache("dense", _stack_raw(raw), cfg, smax, S,
                                     True)
    return _logits(params, cfg, x[:, -1:]), caches


def _decode_encdec(params, cfg, tokens, caches, chunks):
    x = embed_lookup(params["embed/tok"], tokens)
    sc = caches["self"]
    pos = sc.length[0].reshape(1).clone()
    for i, lp in enumerate(_stacked(params, "dec_blocks")):
        x, nsc = T.run_attn(lp, x, cfg, pos, cache=_cache_slice(sc, i),
                            chunks=chunks)
        _cache_store(sc, i, nsc)
        x = T.run_cross_attn(lp, x, (caches["cross_k"][i],
                                     caches["cross_v"][i]), cfg, chunks)
        x = T.run_ffn(lp, x, cfg)
    return _logits(params, cfg, x), {**caches, "self": sc}


def _cache_length(cfg, caches):
    leaf = caches[decoder_groups(cfg)[0][2]]
    if isinstance(leaf, dict):                # period group
        leaf = next(iter(leaf.values()))
    length = leaf.length
    return length[0] if length.ndim else length
