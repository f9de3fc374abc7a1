"""NN building blocks and the parameter-spec system (the port of
``repro/nn/layers.py``).

Params are flat dicts ``path -> tensor``; every param is declared once as
a `ParamSpec` (shape, logical axes, initializer), and the same specs
drive initialization and the parameter count.

Compute dtype policy, as the reference's: matmuls take bf16 operands and
accumulate in f32, norms and rope compute in f32, activations are bf16.
The reference stores every param in f32 and casts the matrices to bf16 at
each use (`dense`, `embed_lookup`, `unembed`); the port stores the
matrices in bf16 once (`init_params`, `params_from_numpy`), which computes
the same values at half the memory.  Every leaf the reference reads in
f32 stays f32 (`storage_dtype`): norm scales, biases, the MoE router, the
SSM and RG-LRU gate and decay parameters and their conv weights.

The reference's ``constrain`` (a sharding constraint, a no-op on one
device) has no counterpart: the training and serving shardings are
ROADMAP queue 1 item 9.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

BF16 = torch.bfloat16
F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]     # logical axis names, len == ndim
    init: str = "normal"                # normal | zeros | ones | embed
    scale: float = 1.0

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


Specs = Dict[str, ParamSpec]


# leaves the reference reads in f32 besides norm scales and biases: the
# MoE router (`moe_ffn`'s f32 logits), the SSM's dt_bias/A_log (f32 softplus
# and exp) and D (cast to bf16 at use: f32 storage gives the same value),
# both blocks' conv_w (bf16 activations times an f32 weight promote to
# f32), the RG-LRU's block-diagonal gates, their biases and a_param
F32_LEAVES = frozenset(("router", "dt_bias", "A_log", "D", "conv_w", "w_a",
                        "w_x", "b_a", "b_x", "a_param"))


def storage_dtype(path: str) -> torch.dtype:
    """A matrix (embedding, projection, FFN, expert, unembedding) is held
    in bf16; a norm scale (``*norm*``), a bias (``*_b``) or one of
    `F32_LEAVES` in f32."""
    leaf = path.rsplit("/", 1)[-1]
    return F32 if ("norm" in leaf or leaf.endswith("_b")
                   or leaf in F32_LEAVES) else BF16


def init_params(specs: Specs, generator: torch.Generator, device=None):
    """Random params drawn on `device` from `generator` (which must live on
    that device), with the reference's per-spec std: ``scale·0.02`` for
    embeddings, ``scale/√fan_in`` otherwise (fan_in = the second-to-last
    axis).  Draws in f32, then stores each param at `storage_dtype`.  The
    stream differs from ``jax.random``'s: to compare with the reference,
    carry its params over with `params_from_numpy`."""
    device = torch.device(device) if device is not None else generator.device
    out = {}
    for path, spec in sorted(specs.items()):
        dt = storage_dtype(path)
        if spec.init == "zeros":
            out[path] = torch.zeros(spec.shape, dtype=dt, device=device)
        elif spec.init == "ones":
            out[path] = torch.ones(spec.shape, dtype=dt, device=device)
        else:
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
            std = spec.scale / np.sqrt(max(fan_in, 1))
            if spec.init == "embed":
                std = spec.scale * 0.02
            w = torch.randn(spec.shape, generator=generator, dtype=F32,
                            device=device)
            out[path] = w.mul_(float(std)).to(dt)
    return out


def params_from_numpy(params: Dict[str, np.ndarray], device) -> dict:
    """The reference's flat param dict (numpy arrays, e.g.
    ``{k: np.asarray(v) for k, v in jax_params.items()}``) as the port's,
    under the same names, each at its `storage_dtype`: matrices rounded to
    bf16 (what the reference's `dense`/`embed_lookup`/`unembed` and the
    expert products do at each use), every leaf the reference reads in f32
    kept f32."""
    return {k: torch.tensor(np.asarray(v, np.float32), device=device)
            .to(storage_dtype(k)) for k, v in params.items()}


# --------------------------------------------------------------------------
# primitive layers (pure functions; weights passed in, bf16 compute)
# --------------------------------------------------------------------------

def cast_bf16(x):
    return x.to(BF16)


def matmul_f32(x, w):
    """``x @ w`` of bf16 operands, accumulated and returned in f32 (the
    reference's ``preferred_element_type=f32``): the operands' products in
    f32 (exact for bf16 values), with TF32 off (`set_matmul_precision`)."""
    return torch.matmul(cast_bf16(x).to(F32), cast_bf16(w).to(F32))


def einsum_f32(eq: str, a, b):
    """``einsum`` of bf16 operands accumulated and returned in f32 (the
    reference's ``preferred_element_type=f32``): the bf16 values widened
    to f32, whose products are exact."""
    return torch.einsum(eq, cast_bf16(a).to(F32), cast_bf16(b).to(F32))


def einsum_bf16(eq: str, a, b):
    """`einsum_f32` rounded once to bf16; on the card one bf16 batched
    GEMM (f32 accumulation, one rounding), as `dense`."""
    if a.device.type == "cuda":
        return torch.einsum(eq, cast_bf16(a), cast_bf16(b))
    return cast_bf16(einsum_f32(eq, a, b))


def dense(x, w, bias=None):
    """x [..., in] @ w [in, out] in bf16, f32 accumulation, bias added in
    f32, one rounding to bf16.  On the card without a bias the product is
    one bf16 GEMM (cuBLAS accumulates in f32 and rounds once, with
    reduced-precision reductions off: `set_matmul_precision`); the CPU has
    no such GEMM for every shape, so it takes the f32 product."""
    if bias is None and x.device.type == "cuda":
        return torch.matmul(cast_bf16(x), cast_bf16(w))
    y = matmul_f32(x, w)
    if bias is not None:
        y = y + bias.to(F32)
    return cast_bf16(y)


def set_matmul_precision():
    """The card's matmul settings the serving path assumes, set explicitly
    (``allow_tf32`` False: an f32 matmul runs in full f32;
    ``allow_bf16_reduced_precision_reduction`` False: a bf16 GEMM reduces
    in f32, rounding once)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def rms_norm(x, gamma, eps: float):
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return cast_bf16(xf * torch.rsqrt(var + eps) * gamma.to(F32))


def swiglu(x, w_gate, w_up, w_down):
    g = dense(x, w_gate)
    u = dense(x, w_up)
    return dense(cast_bf16(torch.nn.functional.silu(g.to(F32))) * u, w_down)


def embed_lookup(table, tokens):
    return cast_bf16(table[tokens])


def unembed(x, table):
    """Logits in f32: x [..., d] against table [V, d]."""
    return matmul_f32(x, cast_bf16(table).t())


# --------------------------------------------------------------------------
# rotary position embeddings
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x, positions, theta: float, seq_axis: int = 0):
    """x [..., S, ..., hd] with positions [S] on axis `seq_axis` (0 in the
    reference, which vmaps over a batch; 1 for a batch written out); the
    axes between S and hd broadcast.  Paired-halves rotation convention."""
    hd = x.shape[-1]
    # rope_freqs on the device (float64, as numpy), with no host copy
    freqs = (1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                          device=x.device) / hd)).to(F32)
    angles = positions[:, None].to(F32) * freqs                  # [S, hd/2]
    angles = angles.reshape(angles.shape[:1]
                            + (1,) * (x.ndim - seq_axis - 2) + (hd // 2,))
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return cast_bf16(out)
