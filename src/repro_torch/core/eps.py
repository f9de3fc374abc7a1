"""Embarrassingly-parallel-search decomposition — port of
``repro/core/eps.py``.

The root is split on the host into ~`target` consistent subproblems:
repeatedly split the widest frontier subproblem (the earliest inserted
on ties) with the search branching rule, propagate both children, drop
failed children.  The pool is the frontier in insertion order, then the
leaves (subproblems with every branch variable fixed) in the order they
were picked; it partitions the root search space, so lane-level DFS
over it is complete, and it is the reference's row for row.

The frontier is a heap keyed by ``(-width, stamp)``, the stamp counting
insertions, so a pick is O(log n).  Propagation goes through the
selected backend on the model's device, in batches: when the rule picks
a node whose children are not known yet, that node and the next widest
open frontier nodes whose children are not known either, up to
`batch_size` nodes, have both children of each propagated in ONE
`fixpoint_batch` call (under ``cuda`` one launch, per-lane results
independent, so each equals a split's own two-store fixpoint).  The
rule then replays its picks from that cache; the children of nodes it
never picks are dropped.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core import lattice as LT
from repro_torch.core import search as S
from repro_torch.core import trace
from repro_torch.core.backend import get_backend
from repro_torch.core.compile import CompiledModel

# nodes a batch propagates off the card: each store costs the plain sweep
# its full time there, so speculation pays only where most of it is used;
# at 8 the widest-first rule took 86–94 % of what it propagated on ProGen
# J60 and J120 instances at a target of 4096
CPU_BATCH = 8


def batch_size(device) -> int:
    """Nodes a batch propagates on `device`: on a CUDA card half its SMs,
    so that the batch's two stores a node stay within the few-lane
    instance's one store per SM (`fixpoint_kernel.instance_threads`) and
    the launch takes about as long as its slowest store; elsewhere
    `CPU_BATCH`."""
    device = torch.device(device)
    if device.type == "cuda":
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        return max(1, sms // 2)
    return CPU_BATCH


def _propagate(backend, cm, lbs: np.ndarray, ubs: np.ndarray):
    """Fixpoints of host stores ``[n, V]`` on the model's device (the
    phases ``eps.stage``, ``eps.launch`` and ``eps.wait`` of the active
    trace)."""
    dev = cm.device
    trace.mark("eps.stage")
    nlb, nub, _, _ = backend.fixpoint_batch(
        cm, torch.from_numpy(lbs).to(dev), torch.from_numpy(ubs).to(dev))
    trace.mark("eps.wait")
    out = nlb.cpu().numpy(), nub.cpu().numpy()
    trace.mark("eps.host")
    return out


def _children(backend, cm, ls: np.ndarray, us: np.ndarray,
              bv: np.ndarray, opts: "S.SearchOptions") -> List[list]:
    """Split each of the non-leaf stores ``[k, V]`` by the branching rule
    (the "le" child x ≤ m, then the "ge" child x ≥ m + 1) and propagate
    the 2k children in one `_propagate`.  Returns per store its
    surviving children ``(lb, ub, width, leaf)``, "le" first."""
    k = ls.shape[0]
    rows = np.arange(k)
    lbv, ubv = ls[:, bv], us[:, bv]
    unf = lbv < ubv
    big = np.iinfo(ls.dtype).max // 4
    if opts.var_strategy == S.MIN_DOM:
        col = np.argmin(np.where(unf, ubv - lbv, big), axis=1)
    elif opts.var_strategy == S.MIN_LB:
        col = np.argmin(np.where(unf, lbv, big), axis=1)
    else:
        col = np.argmax(unf, axis=1)
    v = bv[col]
    lo, hi = ls[rows, v], us[rows, v]
    m = lo if opts.val_strategy == S.VAL_MIN else (lo + hi) // 2
    cl = np.repeat(ls, 2, axis=0)          # rows 2i "le", 2i + 1 "ge"
    cu = np.repeat(us, 2, axis=0)
    cu[2 * rows, v] = np.minimum(hi, m)
    cl[2 * rows + 1, v] = np.maximum(lo, m + 1)
    nlb, nub = _propagate(backend, cm, cl, cu)
    alive = (~(nlb > nub).any(axis=1)).tolist()
    widths = (nub - nlb)[:, bv].clip(min=0).sum(axis=1).tolist()
    leaf = (~(nlb[:, bv] < nub[:, bv]).any(axis=1)).tolist()
    return [[(nlb[j], nub[j], widths[j], leaf[j])
             for j in (2 * i, 2 * i + 1) if alive[j]] for i in range(k)]


def decompose(cm: CompiledModel, target: int,
              opts: "S.SearchOptions" = None) -> Tuple[np.ndarray, np.ndarray]:
    """Split the root into ~`target` consistent subproblems.

    Returns host arrays (subs_lb, subs_ub) of shape ``[S, V]``, S ≥ 1.
    Under an active trace (`trace.active`) its host work is the phase
    ``eps.host``, each batch's staging, launch and copy back
    ``eps.stage``, ``eps.launch`` and ``eps.wait``, and it tallies the
    splits the rule took (``eps.splits``) and the splits its batches
    propagated (``eps.spec``).
    """
    return _decompose(cm, target, opts, batch_size(cm.device))


def _decompose(cm: CompiledModel, target: int, opts, batch: int):
    """`decompose` with at most `batch` nodes split per propagation."""
    trace.mark("eps.host")
    opts = opts or S.SearchOptions()
    backend = get_backend(opts.backend)
    lb0 = cm.lb0.cpu().numpy()[None]
    ub0 = cm.ub0.cpu().numpy()[None]
    lb, ub = _propagate(backend, cm, lb0, ub0)
    lb, ub = lb[0], ub[0]
    if LT.any_failed(lb, ub):
        return lb[None], ub[None]          # failed root: one failed sub

    bv = cm.branch_vars.cpu().numpy()
    width = int((ub - lb)[bv].clip(min=0).sum())
    root_leaf = not (lb[bv] < ub[bv]).any()
    # the frontier by stamp, and as a heap, widest first (the lowest stamp
    # on ties); `todo`, the same order over the frontier's non-leaves
    # whose children are not known, holds stale entries of nodes the rule
    # has picked since (no longer in `nodes`)
    nodes: Dict[int, tuple] = {0: (lb, ub, root_leaf)}
    heap = [(-width, 0)]
    todo = [] if root_leaf else [(-width, 0)]
    stamp = 1
    known: Dict[int, list] = {}            # stamp: its surviving children
    leaves: List[Tuple[np.ndarray, np.ndarray]] = []
    splits = spec = 0
    while heap and len(heap) + len(leaves) < target:
        _, s = heapq.heappop(heap)
        l, u, leaf = nodes.pop(s)
        if leaf:
            leaves.append((l, u))          # already a solution leaf
            continue
        if s not in known:                 # s, then the widest of `todo`
            picked, ls, us = [s], [l], [u]
            while todo and len(picked) < batch:
                t = heapq.heappop(todo)[1]
                if t in nodes:
                    picked.append(t)
                    ls.append(nodes[t][0])
                    us.append(nodes[t][1])
            kids = _children(backend, cm, np.stack(ls), np.stack(us), bv,
                             opts)
            known.update(zip(picked, kids))
            spec += len(picked)
        splits += 1
        for cl, cu, w, cleaf in known.pop(s):
            nodes[stamp] = (cl, cu, cleaf)
            heapq.heappush(heap, (-w, stamp))
            if not cleaf:
                heapq.heappush(todo, (-w, stamp))
            stamp += 1
    trace.tally("eps.splits", splits)
    trace.tally("eps.spec", spec)

    # the frontier in insertion (stamp) order, then the leaves
    pool = [(l, u) for l, u, _ in nodes.values()] + leaves
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
