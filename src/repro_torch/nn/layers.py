"""NN building blocks and the parameter-spec system (the port of
``repro/nn/layers.py``).

Params are flat dicts ``path -> tensor``; every param is declared once as
a `ParamSpec` (shape, logical axes, initializer), and the same specs
drive initialization and the parameter count.

Compute dtype policy, as the reference's: matmuls take bf16 operands and
accumulate in f32, norms and rope compute in f32, activations are bf16.
The reference stores every param in f32 and casts the matrices to bf16 at
each use (`dense`, `embed_lookup`, `unembed`).  For serving, the port
stores the matrices in bf16 once (`init_params`, `params_from_numpy`),
which computes the same values at half the memory; every leaf the
reference reads in f32 stays f32 (`storage_dtype`): norm scales, biases,
the MoE router, the SSM and RG-LRU gate and decay parameters and their
conv weights.  Training stores every leaf in f32, as the reference
(``dtype=torch.float32``): AdamW's update is mostly below a bf16 ulp of
the weight, and the primitives cast at use either way.

Data-parallel training (`train/train_step.sharded_train_step`) sums the
ranks' weight gradients before the one bf16 rounding that a product's
weight gradient gets on one device: inside `unrounded_weight_grads`,
every weight that a product reads as bf16 (`dense`, `unembed`,
`einsum_bf16`, the MoE expert products) enters it widened to f32
(`weight_f32`; `dense`'s bf16 GEMM on the card keeps its forward and
computes the weight gradient with an f32 result, as it does on one
device: `_DenseBF16`), and its
f32 gradient goes, unrounded, into a stash by param leaf instead of to
autograd; the caller sums the stash over the ranks and rounds it to
bf16 once, as one device does.  On the card `einsum_bf16`'s products
there are f32 GEMMs of the bf16 values (the same products, summed in
another order) in place of bf16 GEMMs.

The reference's ``constrain`` (a sharding constraint inside the SPMD
forward, a no-op on one device) has no counterpart: the port runs no
SPMD program.  Its data-parallel training shards the params by the rule
tables outside the forward (`train/train_step.sharded_train_step`).
"""

from __future__ import annotations

import contextlib
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


def init_params(specs: Specs, generator: torch.Generator, device=None,
                dtype: Optional[torch.dtype] = None):
    """Random params drawn on `device` from `generator` (which must live on
    that device), with the reference's per-spec std: ``scale·0.02`` for
    embeddings, ``scale/√fan_in`` otherwise (fan_in = the second-to-last
    axis).  Draws in f32, then stores each param at `dtype` (training:
    f32), by default at its `storage_dtype` (serving).  The stream
    differs from ``jax.random``'s: to compare with the reference, carry
    its params over with `params_from_numpy`."""
    device = torch.device(device) if device is not None else generator.device
    out = {}
    for path, spec in sorted(specs.items()):
        dt = dtype or storage_dtype(path)
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


def params_from_numpy(params: Dict[str, np.ndarray], device,
                      dtype: Optional[torch.dtype] = None) -> dict:
    """The reference's flat param dict (numpy arrays, e.g.
    ``{k: np.asarray(v) for k, v in jax_params.items()}``) as the port's,
    under the same names, each at `dtype` (training: f32, the reference's
    own storage), by default at its `storage_dtype`: matrices rounded to
    bf16 (what the reference's `dense`/`embed_lookup`/`unembed` and the
    expert products do at each use), every leaf the reference reads in f32
    kept f32."""
    return {k: torch.tensor(np.asarray(v, np.float32), device=device)
            .to(dtype or storage_dtype(k)) for k, v in params.items()}


# --------------------------------------------------------------------------
# primitive layers (pure functions; weights passed in, bf16 compute)
# --------------------------------------------------------------------------

def cast_bf16(x):
    return x.to(BF16)


# the weight-gradient stash of `unrounded_weight_grads` (None: off)
_STASH = None


@contextlib.contextmanager
def unrounded_weight_grads(stash: Dict):
    """Inside, the backward of every product's weight adds the weight's
    f32 gradient, unrounded, into ``stash[id(leaf)] = [leaf, sum]`` (the
    param leaf the weight is, or is a view of), and gives the weight no
    gradient through autograd."""
    global _STASH
    prev, _STASH = _STASH, stash
    try:
        yield
    finally:
        _STASH = prev


def current_stash() -> Optional[Dict]:
    """The stash of the enclosing `unrounded_weight_grads` (None: off)."""
    return _STASH


def stash_add(stash: Dict, w, g):
    """Add the f32 gradient `g` of weight `w` (a param leaf, or a view of
    one: a stacked layer's slice) to ``stash[id(leaf)]``, at `w`'s
    place in the (contiguous) leaf."""
    leaf = w._base if w._base is not None else w
    entry = stash.setdefault(id(leaf), [leaf, None])
    if entry[1] is None:
        entry[1] = torch.zeros(leaf.shape, dtype=F32, device=leaf.device)
    entry[1].as_strided(w.shape, w.stride(),
                        w.storage_offset() - leaf.storage_offset()).add_(g)


class _UnroundedWeight(torch.autograd.Function):
    """``w`` rounded to bf16 and widened to f32 (the value of
    ``cast_bf16(w).to(F32)``); the backward adds the f32 gradient to the
    stash."""

    @staticmethod
    def forward(ctx, w, stash):
        ctx.w, ctx.stash = w, stash
        return w.detach().to(BF16).to(F32)

    @staticmethod
    def backward(ctx, g):
        stash_add(ctx.stash, ctx.w, g)
        return None, None


class _DenseBF16(torch.autograd.Function):
    """`dense`'s bf16 GEMM on the card, ``x @ bf16(w)`` (bf16 x), with
    autograd's input gradient (a bf16 GEMM).  The weight gradient is a
    GEMM with an f32 result (``bmm(..., out_dtype=f32)``, the f32
    accumulator) rounded once to bf16, or, given a stash, added to it
    unrounded: so one device and the ranks of `unrounded_weight_grads`
    round the same f32 sums."""

    @staticmethod
    def forward(ctx, x, w, stash):
        wb = w.detach().to(BF16)
        ctx.save_for_backward(x, wb)
        ctx.w, ctx.stash = w, stash
        return torch.matmul(x, wb)

    @staticmethod
    def backward(ctx, g):
        x, wb = ctx.saved_tensors
        gx = torch.matmul(g, wb.t()) if ctx.needs_input_grad[0] else None
        gw = None
        if ctx.needs_input_grad[1] or ctx.stash is not None:
            x2, g2 = x.reshape(-1, x.shape[-1]), g.reshape(-1, g.shape[-1])
            gw = torch.bmm(x2.t()[None], g2[None], out_dtype=F32)[0]
            if ctx.stash is not None:
                stash_add(ctx.stash, ctx.w, gw)
                gw = None
            else:
                gw = gw.to(BF16).to(ctx.w.dtype)
        return gx, gw, None


def weight_f32(w):
    """A weight as its bf16 value in f32; inside `unrounded_weight_grads`
    (and when `w` requires grad) its gradient goes to the stash."""
    if _STASH is not None and w.requires_grad:
        return _UnroundedWeight.apply(w, _STASH)
    return cast_bf16(w).to(F32)


def matmul_f32(x, w):
    """``x @ w`` of bf16 operands, accumulated and returned in f32 (the
    reference's ``preferred_element_type=f32``): the operands' products in
    f32 (exact for bf16 values), with TF32 off (`set_matmul_precision`)."""
    return torch.matmul(cast_bf16(x).to(F32), weight_f32(w))


def einsum_f32(eq: str, a, b):
    """``einsum`` of bf16 operands accumulated and returned in f32 (the
    reference's ``preferred_element_type=f32``): the bf16 values widened
    to f32, whose products are exact."""
    return torch.einsum(eq, cast_bf16(a).to(F32), cast_bf16(b).to(F32))


def einsum_bf16(eq: str, a, b):
    """`einsum_f32` rounded once to bf16; on the card one bf16 batched
    GEMM (f32 accumulation, one rounding), as `dense`.  `b` is the
    weight (`weight_f32`)."""
    if a.device.type == "cuda" and _STASH is None:
        return torch.einsum(eq, cast_bf16(a), cast_bf16(b))
    return cast_bf16(torch.einsum(eq, cast_bf16(a).to(F32), weight_f32(b)))


def dense(x, w, bias=None):
    """x [..., in] @ w [in, out] in bf16, f32 accumulation, bias added in
    f32, one rounding to bf16.  On the card without a bias the product is
    one bf16 GEMM (cuBLAS accumulates in f32 and rounds once, with
    reduced-precision reductions off: `set_matmul_precision`); the CPU has
    no such GEMM for every shape, so it takes the f32 product.  In
    training (`w` requiring grad) the card's product is `_DenseBF16`."""
    if bias is None and x.device.type == "cuda":
        if w.requires_grad:
            return _DenseBF16.apply(cast_bf16(x), w, _STASH)
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
    return torch.matmul(cast_bf16(x).to(F32), weight_f32(table).t())


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
