"""Flash attention for Hopper and its plain PyTorch version.

`flash_attention` replaces the Pallas TPU kernel ``flash_attention``
(``src/repro/kernels/flash_attention.py``): causal or bidirectional GQA
self-attention over aligned positions, forward only (the prefill;
training and decode go through ``nn/attention.py``
`blocked_attention`).  Source
``csrc/flash_attention.cu``: one CTA per (head, batch, q-block), K/V
tiles fed by TMA into a ring of shared-memory stages, both products on
the tensor cores (``wgmma``), the softmax online in f32 registers, and p
into the PV product as a bf16 pair ``p_hi + p_lo`` (f32 precision, as the
reference keeps it).  It takes bf16 q/k/v, head_dim 16 (the smoke
configs), 64 or 128, q-blocks of 64 or 128 and KV blocks of 128; anything
else raises, on the CPU as on the card.

On a CPU tensor the wrapper runs `flash_attention_plain`; on a CUDA
tensor it launches the kernel or raises (failed build, refused launch).
It never falls back.  ``flash_attention.launches`` counts kernel
launches and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30
HEAD_DIMS = (16, 64, 128)
Q_BLOCKS = (64, 128)
KV_BLOCKS = (128,)


def _padding(S: int, bq: int, bk: int, causal: bool) -> int:
    """The rows the reference pads S with (blocks clipped to S); a
    bidirectional call with a ragged S raises, as the reference does."""
    bq, bk = min(bq, S), min(bk, S)
    pad = max((-S) % bq, (-S) % bk)
    if pad and not causal:
        raise ValueError("non-causal flash requires S % bk == 0")
    return pad


def flash_attention_plain(q, k, v, *, causal: bool = True, bq: int = 128,
                          bk: int = 128):
    """q [B,S,H,hd], k/v [B,S,KV,hd] (H % KV == 0) → [B,S,H,hd] in q's
    dtype: the reference kernel's function in f32 — S zero-padded to the
    blocks (clipped to S), head h on KV head h // (H/KV), scores at scale
    1/√hd with NEG_INF past the diagonal, softmax, output
    ``acc / max(l, 1e-30)`` rounded once.  Dense per batch element: its
    [H, S, S] f32 scores are the memory this version needs."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    pad = _padding(S, bq, bk, causal)
    scale = 1.0 / float(hd) ** 0.5
    if pad:
        z = (0, 0, 0, 0, 0, pad)
        q, k, v = (torch.nn.functional.pad(t, z) for t in (q, k, v))
    Sp = S + pad
    pos = torch.arange(Sp, device=q.device)
    out = torch.empty((B, Sp, H, hd), dtype=q.dtype, device=q.device)
    for b in range(B):
        qf = q[b].float() * scale                               # [Sp,H,hd]
        kf = k[b].float().repeat_interleave(rep, dim=1)
        vf = v[b].float().repeat_interleave(rep, dim=1)
        s = torch.einsum("qhd,khd->hqk", qf, kf)
        if causal:
            s = s.masked_fill(pos[None, :, None] < pos[None, None, :],
                              NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1)                                       # [H,Sp]
        acc = torch.einsum("hqk,khd->qhd", p, vf)
        out[b] = (acc / l.clamp_min(1e-30).t()[..., None]).to(q.dtype)
    return out[:, :S]


def _check(q, k, v, bq, bk, causal):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be [B, S, heads, hd]")
    B, S, H, hd = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, S) or k.shape[3] != hd:
        raise ValueError(f"flash_attention: k/v must be [{B}, {S}, KV, {hd}]"
                         f", got {tuple(k.shape)}/{tuple(v.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"flash_attention: {H} heads over {k.shape[2]} KV "
                         "heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if bq not in Q_BLOCKS or bk not in KV_BLOCKS:
        raise ValueError(f"flash_attention: blocks ({bq}, {bk}): bq must be "
                         f"in {Q_BLOCKS}, bk in {KV_BLOCKS}")
    if not all(t.dtype == torch.bfloat16 for t in (q, k, v)):
        raise TypeError(f"flash_attention: q, k, v must be bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_attention: q, k, v on {q.device}/{k.device}"
                         f"/{v.device}")
    _padding(S, bq, bk, causal)


def _lib():
    from repro_torch.kernels.build import load
    lib = load("flash_attention")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = [ptr] * 4 + [i32] * 8 + [ptr]
        lib.flash_attention_launch.restype = i32
        lib.flash_attention_error_string.argtypes = [i32]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def flash_attention(q, k, v, *, causal: bool = True, bq: int = 128,
                    bk: int = 128):
    """q [B,S,H,hd], k/v [B,S,KV,hd] bf16 (H % KV == 0) → [B,S,H,hd] bf16,
    equal to `flash_attention_plain` within the rounding of f32 sums.

    Forward only, as the reference's kernel: under grad mode an input
    that requires grad raises (on the card the output would carry no
    gradient; training attends through `nn.attention.blocked_attention`).
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no backward: q, k or v requires grad under "
            "grad mode (train through nn.attention.blocked_attention)")
    _check(q, k, v, bq, bk, causal)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, bq=bq, bk=bk)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must be 16-byte aligned")
    B, S, H, hd = q.shape
    out = torch.empty_like(q)
    lib = _lib()
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H,
        k.shape[2], hd, bq, bk, int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("flash_attention: launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
