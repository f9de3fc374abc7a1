"""Bit-packed finite domains — the host-side part the compiler needs.

Port of ``repro/core/bitset.py``: the word geometry (`WORD_BITS`,
`n_words_for`) that `compile.py` uses to size the Compact-Table bank and
the ``dom_track`` mask, plus the numpy ``np_*`` mirrors.  The torch
bitset operations (SWAR popcount/ctz/clz, `from_bounds`/`to_bounds` on
tensors) come with the Compact-Table slice of the port; until then no
propagation path in this package carries a bitset store.
"""

from __future__ import annotations

import numpy as np

WORD_BITS = 32
FULL = np.uint32(0xFFFFFFFF)

_M1 = np.uint32(0x55555555)
_M2 = np.uint32(0x33333333)
_M4 = np.uint32(0x0F0F0F0F)
_H01 = np.uint32(0x01010101)


def n_words_for(width: int) -> int:
    """Words needed for a domain of `width` values (host-side static)."""
    return max(1, -(-int(width) // WORD_BITS))


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
