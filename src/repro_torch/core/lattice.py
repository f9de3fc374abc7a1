"""Lattice primitives — port of ``repro/core/lattice.py``.

PCCP stores are Cartesian products of chain lattices.  The integer
interval lattice ``IZ = ZInc × ZDec`` is two dense tensors

    lb : i[V]   -- element of ZInc^V   (join = elementwise max)
    ub : i[V]   -- element of ZDec^V   (join = elementwise min)

Booleans are intervals over {0, 1}: ``lb == 1`` means *true is
entailed*, ``ub == 0`` means *false is entailed*, ``(0, 1)`` is unknown
(bottom) and ``lb > ub`` is top (failure).  The operations act on
torch tensors (the comparison operators on numpy arrays as well); the
``np_`` mirror at the bottom serves the sequential baseline and the
tests.

Pseudo-infinities: machine ints have no ±inf, so ``INF`` is a sentinel
small enough that ``coef * bound`` products and K-term sums stay within
the dtype; `clamp` keeps values in ``[-INF, INF]``.
"""

from __future__ import annotations

import numpy as np
import torch

INF32 = np.int32(1 << 20)
INF64 = np.int64(1 << 40)


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def inf_for(dtype) -> np.integer:
    """The pseudo-infinity of a store dtype (torch, numpy or its name)."""
    return INF64 if _itemsize(dtype) >= 8 else INF32


# --- chain lattices -------------------------------------------------------

def zinc_join(a, b):
    """Join in ZInc (increasing integers): max."""
    return torch.maximum(a, b)


def zdec_join(a, b):
    """Join in ZDec = ZInc^op (decreasing integers): min."""
    return torch.minimum(a, b)


def zinc_leq(a, b):
    """a <= b in ZInc (b carries at least as much information)."""
    return a <= b


def zdec_leq(a, b):
    return a >= b


# --- interval lattice IZ = ZInc x ZDec ------------------------------------

def iz_join(lb_a, ub_a, lb_b, ub_b):
    """Pointwise join of two interval stores."""
    return zinc_join(lb_a, lb_b), zdec_join(ub_a, ub_b)


def iz_leq(lb_a, ub_a, lb_b, ub_b):
    """(lb_a, ub_a) <= (lb_b, ub_b) in IZ: b is a sub-interval of a."""
    return torch.logical_and(lb_a <= lb_b, ub_a >= ub_b)


def is_empty(lb, ub):
    """Top of IZ per variable == failure (empty concretization)."""
    return lb > ub


def is_fixed(lb, ub):
    return lb == ub


def any_failed(lb, ub):
    return is_empty(lb, ub).any()


def all_fixed(lb, ub):
    return is_fixed(lb, ub).all()


def clamp(x, dtype: torch.dtype):
    """`x` clipped into ``[-INF, INF]`` of `dtype`, cast to it."""
    inf = int(inf_for(dtype))
    return torch.clamp(x, -inf, inf).to(dtype)


# --- boolean embedding -----------------------------------------------------

def bool_true(lb, ub, idx):
    """BInc view: lb[idx] >= 1 <=> `true` has been told."""
    return lb[..., idx] >= 1


def bool_false(lb, ub, idx):
    return ub[..., idx] <= 0


# --- host-side mirror (the sequential baseline and the tests) --------------

def np_iz_join(lb_a, ub_a, lb_b, ub_b):
    return np.maximum(lb_a, lb_b), np.minimum(ub_a, ub_b)
