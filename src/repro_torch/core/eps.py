"""Embarrassingly-parallel-search decomposition — port of
``repro/core/eps.py``.

The root is split on the host into ~`target` consistent subproblems:
repeatedly split the widest frontier subproblem with the search
branching rule, propagate both children, drop failed children.  The
pool partitions the root search space, so lane-level DFS over it is
complete.

Propagation goes through the selected backend on the model's device:
under ``cuda`` each split is ONE 2-lane kernel launch for both children
(per-lane results are independent, so this equals two single-store
fixpoints).  The frontier's widths are kept beside it instead of being
recomputed every step; the pool is identical to the reference's.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from repro_torch.core import lattice as LT
from repro_torch.core import search as S
from repro_torch.core.backend import get_backend
from repro_torch.core.compile import CompiledModel


def _propagate(backend, cm, lbs: np.ndarray, ubs: np.ndarray):
    """Fixpoints of host stores ``[n, V]`` on the model's device."""
    dev = cm.device
    nlb, nub, _, _ = backend.fixpoint_batch(
        cm, torch.from_numpy(lbs).to(dev), torch.from_numpy(ubs).to(dev))
    return nlb.cpu().numpy(), nub.cpu().numpy()


def decompose(cm: CompiledModel, target: int,
              opts: "S.SearchOptions" = None) -> Tuple[np.ndarray, np.ndarray]:
    """Split the root into ~`target` consistent subproblems.

    Returns host arrays (subs_lb, subs_ub) of shape ``[S, V]``, S ≥ 1.
    """
    opts = opts or S.SearchOptions()
    backend = get_backend(opts.backend)
    lb0 = cm.lb0.cpu().numpy()[None]
    ub0 = cm.ub0.cpu().numpy()[None]
    lb, ub = _propagate(backend, cm, lb0, ub0)
    lb, ub = lb[0], ub[0]
    if LT.any_failed(lb, ub):
        return lb[None], ub[None]          # failed root: one failed sub

    bv = cm.branch_vars.cpu().numpy()

    def width(l, u):
        return int((u - l)[bv].clip(min=0).sum())

    frontier: List[Tuple[np.ndarray, np.ndarray]] = [(lb, ub)]
    widths: List[int] = [width(lb, ub)]
    leaves: List[Tuple[np.ndarray, np.ndarray]] = []
    while frontier and len(frontier) + len(leaves) < target:
        # widest subproblem first keeps the pool balanced
        i = int(np.argmax(widths))
        l, u = frontier.pop(i)
        widths.pop(i)
        unf = l[bv] < u[bv]
        if not unf.any():
            leaves.append((l, u))          # already a solution leaf
            continue
        if opts.var_strategy == S.MIN_DOM:
            w = np.where(unf, u[bv] - l[bv], np.iinfo(l.dtype).max // 4)
            v = int(bv[int(np.argmin(w))])
        elif opts.var_strategy == S.MIN_LB:
            w = np.where(unf, l[bv], np.iinfo(l.dtype).max // 4)
            v = int(bv[int(np.argmin(w))])
        else:
            v = int(bv[int(np.argmax(unf))])
        m = int(l[v]) if opts.val_strategy == S.VAL_MIN else int((l[v] + u[v]) // 2)
        cl = np.stack([l, l])              # children "le" (x ≤ m), "ge"
        cu = np.stack([u, u])
        cu[0, v] = min(cu[0, v], m)
        cl[1, v] = max(cl[1, v], m + 1)
        nlb, nub = _propagate(backend, cm, cl, cu)
        for k in range(2):
            if not (nlb[k] > nub[k]).any():
                frontier.append((nlb[k], nub[k]))
                widths.append(width(nlb[k], nub[k]))

    pool = frontier + leaves
    if not pool:                            # everything failed: UNSAT root
        bad_l = lb.copy(); bad_u = ub.copy()
        bad_l[0] = 1; bad_u[0] = 0          # an explicitly failed store
        pool = [(bad_l, bad_u)]
    subs_lb = np.stack([p[0] for p in pool])
    subs_ub = np.stack([p[1] for p in pool])
    return subs_lb, subs_ub


def pad_pool(subs_lb: np.ndarray, subs_ub: np.ndarray,
             size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a pool ``[S, V]`` up to ``size`` entries with explicitly-failed
    stores (``lb[0] > ub[0]``): a lane that pops one fails it in a single
    superstep and re-arms, so statuses/objectives are unchanged.
    ``size <= S`` is a no-op."""
    s = subs_lb.shape[0]
    if size <= s:
        return subs_lb, subs_ub
    fl = np.repeat(np.asarray(subs_lb[:1]).copy(), size - s, axis=0)
    fu = np.repeat(np.asarray(subs_ub[:1]).copy(), size - s, axis=0)
    fl[:, 0], fu[:, 0] = 1, 0
    return (np.concatenate([np.asarray(subs_lb), fl]),
            np.concatenate([np.asarray(subs_ub), fu]))


def fit_pool(subs_lb: np.ndarray, subs_ub: np.ndarray,
             size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Fit a pool ``[S, V]`` to exactly ``size`` entries (padding with
    inert failed stores); raises when the pool is larger."""
    s = int(subs_lb.shape[0])
    if s > size:
        raise ValueError(
            f"pool of {s} subproblems does not fit the fixed bucket size "
            f"{size}; decompose with a smaller eps_target")
    return pad_pool(np.asarray(subs_lb), np.asarray(subs_ub), size)


def failed_pool(template_lb: np.ndarray, template_ub: np.ndarray,
                size: int) -> Tuple[np.ndarray, np.ndarray]:
    """An all-failed pool ``[size, V]`` (every store has ``lb[0] >
    ub[0]``); ``template_lb/ub`` supply the dtype and width ``V``."""
    lb = np.asarray(template_lb).reshape(-1, np.asarray(template_lb).shape[-1])
    ub = np.asarray(template_ub).reshape(-1, np.asarray(template_ub).shape[-1])
    fl = np.repeat(lb[:1].copy(), size, axis=0)
    fu = np.repeat(ub[:1].copy(), size, axis=0)
    fl[:, 0], fu[:, 0] = 1, 0
    return fl, fu
