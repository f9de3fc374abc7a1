"""Serving steps (the port of ``repro/train/serve_step.py``): prefill
(prompt → caches) and decode (one token per step, greedy or temperature
sampling).

Greedy decoding picks what the reference picks (the first maximal
logit).  Temperature sampling draws from a ``torch.Generator`` on the
logits' device, whose stream differs from ``jax.random``'s, so sampled
tokens are not the reference's.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.nn import model as MD
from repro_torch.nn.layers import set_matmul_precision


def prefill_step(params, cfg: ArchConfig, batch: Dict, smax: int,
                 chunks=(1024, 1024)):
    """Returns (first generated token [B] int32, caches)."""
    set_matmul_precision()
    logits, caches = MD.forward_prefill(params, cfg, batch, smax,
                                        chunks=chunks)
    return torch.argmax(logits, dim=-1).to(torch.int32), caches


def decode_step(params, cfg: ArchConfig, tokens, caches,
                temperature: float = 0.0,
                generator: Optional[torch.Generator] = None,
                chunks=(1, 1024)):
    """tokens [B, 1] → (next token [B] int32, caches', logits [B, V])."""
    set_matmul_precision()
    logits, caches = MD.forward_decode(params, cfg, tokens, caches,
                                       chunks=chunks)
    if temperature > 0 and generator is not None:
        probs = torch.softmax(logits / temperature, dim=-1)
        nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
    else:
        nxt = torch.argmax(logits, dim=-1)
    return nxt.to(torch.int32), caches, logits


def generate(params, cfg: ArchConfig, batch: Dict, steps: int, smax: int,
             temperature: float = 0.0, seed: int = 0, chunks=(1024, 1024),
             stats: Optional[dict] = None):
    """Greedy/sampled generation loop (host-side; serving example):
    [B, steps] int32 tokens.  Given a dict `stats`, it also fills in the
    wall seconds of the prefill and of the decode steps, each ended by a
    device synchronize."""
    dev = batch["tokens"].device

    def clock():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    t0 = clock() if stats is not None else 0.0
    tok, caches = prefill_step(params, cfg, batch, smax, chunks=chunks)
    if stats is not None:
        t1 = clock()
        stats["prefill_s"] = t1 - t0
    out = [tok]
    gen = torch.Generator(device=dev).manual_seed(seed)
    for _ in range(steps - 1):
        tok, caches, _ = decode_step(params, cfg, tok[:, None], caches,
                                     temperature=temperature, generator=gen,
                                     chunks=(1, chunks[1]))
        out.append(tok)
    if stats is not None:
        stats["decode_s"] = clock() - t1
    return torch.stack(out, dim=1)                # [B, steps]
