"""Lattice primitives — port of ``repro/core/lattice.py``.

PCCP stores are Cartesian products of chain lattices.  The integer
interval lattice ``IZ = ZInc × ZDec`` is two dense tensors

    lb : i[V]   -- element of ZInc^V   (join = elementwise max)
    ub : i[V]   -- element of ZDec^V   (join = elementwise min)

Booleans are intervals over {0, 1}: ``lb == 1`` means *true is
entailed*, ``ub == 0`` means *false is entailed*, ``(0, 1)`` is unknown
(bottom) and ``lb > ub`` is top (failure).  Only the operations the
port's sweeps, search and EPS use are here; the comparison operators
work on numpy arrays as well.
"""

from __future__ import annotations

import torch


def zinc_join(a, b):
    """Join in ZInc (increasing integers): max."""
    return torch.maximum(a, b)


def zdec_join(a, b):
    """Join in ZDec = ZInc^op (decreasing integers): min."""
    return torch.minimum(a, b)


def iz_join(lb_a, ub_a, lb_b, ub_b):
    """Pointwise join of two interval stores."""
    return zinc_join(lb_a, lb_b), zdec_join(ub_a, ub_b)


def is_empty(lb, ub):
    """Top of IZ per variable == failure (empty concretization)."""
    return lb > ub


def is_fixed(lb, ub):
    return lb == ub


def any_failed(lb, ub):
    return is_empty(lb, ub).any()
