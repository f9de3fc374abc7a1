"""Bit-packed finite domains — port of ``repro/core/bitset.py``.

The domain of each tracked variable is a row of packed words

    dom : i32[..., V, W]     (bit k of word w of var v  ⇔
                              value  off[v] + 32·w + k  is still possible)

where ``off[v]`` is the variable's initial lower bound and ``W`` (the
static ``n_words``) covers the widest tracked variable.  The store is a
lattice ordered by information: join (⊔) is AND and an empty row is
failure.  Variables wider than 32·W values are *untracked*: their
words are pinned to all-ones and never consulted (``dom_track``).

The reference carries the words as ``uint32``.  Torch's CPU ``uint32``
lacks ``~``, shifts, gathers, scatters and ``amin``, so the port carries
the same bit patterns as ``int32`` (``FULL`` is -1) and compares with the
reference through ``.view(np.int32)``.  Where a word has to be read as an
unsigned number (shifts, popcount, the hull), it is widened to int64 in
``[0, 2³²)`` (`unsigned`) and narrowed back to its int32 pattern
(`from_unsigned`); counts
and positions come back as int32.  The SWAR popcount then needs no
wraparound: the int64 product ``x · 0x01010101`` keeps the count in bits
24–31.

The device half (`popcount` … `to_bounds`) works on tensors; the host
half (`np_*`) mirrors the reference's numpy functions on ``uint32``
arrays for the compiler and the tests.
"""

from __future__ import annotations

import numpy as np
import torch

WORD_BITS = 32
FULL = np.uint32(0xFFFFFFFF)
FULL_I32 = -1               # FULL as an int32 bit pattern

_M1 = np.uint32(0x55555555)
_M2 = np.uint32(0x33333333)
_M4 = np.uint32(0x0F0F0F0F)
_H01 = np.uint32(0x01010101)
_MASK32 = 0xFFFFFFFF


def n_words_for(width: int) -> int:
    """Words needed for a domain of `width` values (host-side static)."""
    return max(1, -(-int(width) // WORD_BITS))


def unsigned(x):
    """int32 bit patterns → their unsigned values, as int64."""
    return x.long() & _MASK32


def from_unsigned(v):
    """int64 values in ``[0, 2³²)`` → their int32 bit patterns."""
    return (v - ((v >> 31) << 32)).to(torch.int32)


# --- word-level primitives (int32 bit patterns in) ------------------------

def popcount(x):
    """Set bits per word (SWAR on the int64 widening), int32."""
    x = unsigned(x)
    x = x - ((x >> 1) & int(_M1))
    x = (x & int(_M2)) + ((x >> 2) & int(_M2))
    x = (x + (x >> 4)) & int(_M4)
    return (((x * int(_H01)) >> 24) & 0xFF).to(torch.int32)


def ctz(x):
    """Trailing zeros per word; 32 for an empty word."""
    u = unsigned(x)
    return popcount(from_unsigned(((u & -u) - 1) & _MASK32))


def clz(x):
    """Leading zeros per word; 32 for an empty word."""
    u = unsigned(x)
    for s in (1, 2, 4, 8, 16):
        u = u | (u >> s)
    return WORD_BITS - popcount(from_unsigned(u))


def low_mask(n):
    """Word with bits [0, n) set, for n clipped into [0, 32]."""
    n = torch.clamp(torch.as_tensor(n).long(), 0, WORD_BITS)
    return from_unsigned((torch.ones_like(n) << n) - 1)


# --- lattice contract ------------------------------------------------------

def join(a, b):
    """⊔ in the bitset lattice: intersection of value sets (AND)."""
    return a & b


def count(dom):
    """|dom| per variable (int32)."""
    return popcount(dom).sum(-1, dtype=torch.int32)


# --- interval bridges ------------------------------------------------------

def from_bounds(lb, ub, off, n_words: int, track=None):
    """Bitset of the interval [lb, ub] per var: ``i32[..., V, W]``.

    `off` is the per-var value offset (the initial lower bound); an empty
    interval packs to all zeros.  With `track` (``[V]``, nonzero =
    tracked) untracked vars are pinned to all-ones."""
    base = torch.arange(n_words, dtype=torch.int64,
                        device=lb.device) * WORD_BITS            # [W]
    rel_lo = (lb.long() - off.long())[..., None] - base
    rel_hi = (ub.long() - off.long() + 1)[..., None] - base
    words = low_mask(rel_hi) & ~low_mask(rel_lo)                 # [..., V, W]
    if track is not None:
        words = torch.where((track != 0)[..., :, None], words, FULL_I32)
    return words


def min_value(dom, off):
    """Smallest remaining value per var; ``off + 32·W`` when empty."""
    W = dom.shape[-1]
    base = torch.arange(W, dtype=torch.int32, device=dom.device) * WORD_BITS
    pos = torch.where(dom != 0, base + ctz(dom), W * WORD_BITS).amin(-1)
    return off + pos.to(off.dtype)


def max_value(dom, off):
    """Largest remaining value per var; ``off - 1`` when empty."""
    W = dom.shape[-1]
    base = torch.arange(W, dtype=torch.int32, device=dom.device) * WORD_BITS
    hi = base + (WORD_BITS - 1) - clz(dom)
    pos = torch.where(dom != 0, hi, -1).amax(-1)
    return off + pos.to(off.dtype)


def to_bounds(dom, off):
    """Interval hull (lo, hi) of the domain; lo > hi iff empty, and an
    empty domain yields ``(off + 32·W, off - 1)``."""
    return min_value(dom, off), max_value(dom, off)


# --- host-side mirrors (numpy, uint32) --------------------------------------

def np_popcount(x):
    x = np.asarray(x, dtype=np.uint32)
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    return (x * _H01) >> 24


def np_from_bounds(lb, ub, off, n_words: int, track=None):
    lb = np.asarray(lb)
    ub = np.asarray(ub)
    off = np.asarray(off)
    base = np.arange(n_words, dtype=np.int64) * WORD_BITS
    rel_lo = np.clip((lb - off)[..., None] - base, 0, WORD_BITS)
    rel_hi = np.clip((ub - off + 1)[..., None] - base, 0, WORD_BITS)

    def lowm(n):
        n = n.astype(np.uint64)
        return ((np.uint64(1) << n) - np.uint64(1)).astype(np.uint32)

    words = lowm(rel_hi) & ~lowm(rel_lo)
    if track is not None:
        words = np.where((np.asarray(track) != 0)[..., :, None], words, FULL)
    return words


def np_count(dom):
    return np_popcount(dom).sum(axis=-1)


def np_is_empty(dom):
    return np.all(np.asarray(dom) == 0, axis=-1)


def np_to_bounds(dom, off):
    dom = np.asarray(dom, dtype=np.uint32)
    off = np.asarray(off)
    W = dom.shape[-1]
    base = np.arange(W, dtype=np.int64) * WORD_BITS
    tz = np_popcount((dom & (~dom + np.uint32(1))) - np.uint32(1))
    lo_pos = np.where(dom != 0, base + tz, W * WORD_BITS).min(axis=-1)
    sm = dom.copy()
    for s in (1, 2, 4, 8, 16):
        sm = sm | (sm >> s)
    lz = WORD_BITS - np_popcount(sm)
    hi_pos = np.where(dom != 0, base + WORD_BITS - 1 - lz.astype(np.int64),
                      -1).max(axis=-1)
    return off + lo_pos.astype(off.dtype), off + hi_pos.astype(off.dtype)


def np_has_value(dom, val, off):
    dom = np.asarray(dom, dtype=np.uint32)
    bit = np.asarray(val - off, dtype=np.int64)
    W = dom.shape[-1]
    ok = (bit >= 0) & (bit < W * WORD_BITS)
    w = np.clip(bit >> 5, 0, W - 1)
    word = np.take_along_axis(dom, w[..., None], axis=-1)[..., 0]
    mask = (np.uint32(1) << (bit & 31).astype(np.uint32))
    return ok & ((word & mask) != 0)


def np_clear_value(dom, val, off):
    """Remove one value (x ≠ v branching); out-of-range vals are no-ops."""
    dom = np.asarray(dom, dtype=np.uint32).copy()
    bit = np.asarray(val - off, dtype=np.int64)
    W = dom.shape[-1]
    ok = (bit >= 0) & (bit < W * WORD_BITS)
    w = np.clip(bit >> 5, 0, W - 1)
    mask = np.where(ok, np.uint32(1) << (bit & 31).astype(np.uint32),
                    np.uint32(0))
    cur = np.take_along_axis(dom, w[..., None], axis=-1)[..., 0]
    np.put_along_axis(dom, w[..., None], (cur & ~mask)[..., None], axis=-1)
    return dom
