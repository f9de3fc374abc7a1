"""Sequential propagate-and-search baseline — port of
``repro/core/baseline.py`` (the paper's GECODE stand-in).

The host-side comparison solver of the port: an event-driven
propagation loop (propagators re-queued only when a watched variable
changes, the AC-3/AC-5-style engine the paper contrasts its eventless
AC-1 loop with), depth-first search with chronological backtracking on
copied stores, and branch & bound, all on numpy stores on the host.

It takes the port's `CompiledModel` on any device and copies its tables
to host numpy once, in `SequentialSolver.__init__`.  It uses the same
propagator math (one numpy transcription per propagator kind of the
`fixpoint` tiles: ReifLinLe rows, AllDifferent Hall-interval bounds
consistency, Cumulative time-table filtering, Compact-Table rows on
bitset domains), so its optima must equal the parallel engine's; that
agreement is itself a check of both.  It is not a propagation backend
and is not reachable through `SolveConfig.backend`.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core import bitset as B
from repro_torch.core import search as S
from repro_torch.core.api import OPTIMAL, SAT, UNSAT, UNKNOWN, SolveResult
from repro_torch.core.compile import CompiledModel


def _row_update(lb, ub, p: int,
                vidx, coef, rhs, bidx, box_lo, box_hi) -> List[int]:
    """Apply propagator row p in place; return list of changed var indices."""
    a = coef[p]
    vs = vidx[p]
    c = int(rhs[p])
    b = int(bidx[p])
    xl = lb[vs].astype(np.int64)
    xu = ub[vs].astype(np.int64)
    al = a.astype(np.int64)
    tl = np.where(al > 0, al * xl, al * xu)
    tu = np.where(al > 0, al * xu, al * xl)
    smin = int(tl.sum())
    smax = int(tu.sum())
    changed: List[int] = []

    def tighten_ub(v: int, val: int):
        val = max(val, int(box_lo[v]))
        if val < ub[v]:
            ub[v] = val
            changed.append(v)

    def tighten_lb(v: int, val: int):
        val = min(val, int(box_hi[v]))
        if val > lb[v]:
            lb[v] = val
            changed.append(v)

    if lb[b] >= 1:                           # ask b: Σ a x ≤ c
        for k in range(len(vs)):
            ak = int(al[k])
            if ak == 0:
                continue
            slack = c - (smin - int(tl[k]))
            if ak > 0:
                tighten_ub(int(vs[k]), slack // ak)
            else:
                tighten_lb(int(vs[k]), -((-slack) // ak))
    if ub[b] <= 0:                           # ask ¬b: Σ -a x ≤ -c-1
        for k in range(len(vs)):
            ak = -int(al[k])
            if ak == 0:
                continue
            slack = (-c - 1) - (-smax + int(tu[k]))
            if ak > 0:
                tighten_ub(int(vs[k]), slack // ak)
            else:
                tighten_lb(int(vs[k]), -((-slack) // ak))
    if smax <= c:
        tighten_lb(b, 1)                     # entailed
    if smin > c:
        tighten_ub(b, 0)                     # disentailed
    return changed


def _alldiff_update(lb, ub, vs, offs, box_lo, box_hi) -> List[int]:
    """Hall-interval bounds(Z) consistency for one AllDifferent row —
    numpy transcription of `fixpoint.alldiff_candidates_tile`."""
    yl = lb[vs].astype(np.int64) + offs
    yu = ub[vs].astype(np.int64) + offs
    n = len(vs)
    changed: List[int] = []

    def tighten_lb(v: int, val: int):
        val = min(val, int(box_hi[v]))
        if val > lb[v]:
            lb[v] = val
            changed.append(v)

    def tighten_ub(v: int, val: int):
        val = max(val, int(box_lo[v]))
        if val < ub[v]:
            ub[v] = val
            changed.append(v)

    for i in range(n):
        a = int(yl[i])
        for j in range(n):
            b = int(yu[j])
            if a > b:
                continue
            inside = (yl >= a) & (yu <= b)
            cnt = int(inside.sum())
            width = b - a + 1
            if cnt > width:                  # pigeonhole: unsatisfiable
                tighten_lb(int(vs[0]), int(box_hi[vs[0]]) + 1)
                return changed
            if cnt == width:                 # Hall interval: push others out
                for k in range(n):
                    if inside[k]:
                        continue
                    if a <= yl[k] <= b:
                        tighten_lb(int(vs[k]), b + 1 - int(offs[k]))
                    if a <= yu[k] <= b:
                        tighten_ub(int(vs[k]), a - 1 - int(offs[k]))
    return changed


def _cumulative_update(lb, ub, svars, durs, dems, cap, horizon,
                       box_lo, box_hi) -> List[int]:
    """Time-table filtering for one Cumulative row — numpy transcription
    of `fixpoint.cumulative_candidates_tile`."""
    est = lb[svars].astype(np.int64)
    lst = ub[svars].astype(np.int64)
    n = len(svars)
    changed: List[int] = []
    profile = np.zeros(horizon, dtype=np.int64)
    for t in range(n):
        if durs[t] > 0 and dems[t] > 0 and lst[t] < est[t] + durs[t]:
            profile[max(int(lst[t]), 0):int(est[t] + durs[t])] += dems[t]
    if (profile > cap).any():                # overload: unsatisfiable
        # fail through the first effective task (profile > 0 implies one
        # exists): box_hi = ub0 + 1 always crosses the upper bound
        t0 = next(t for t in range(n) if durs[t] > 0 and dems[t] > 0)
        v0 = int(svars[t0])
        if lb[v0] < int(box_hi[v0]):
            lb[v0] = int(box_hi[v0])
            changed.append(v0)
        return changed
    for t in range(n):
        if durs[t] <= 0 or dems[t] <= 0:
            continue
        own = np.zeros(horizon, dtype=np.int64)
        if lst[t] < est[t] + durs[t]:
            own[max(int(lst[t]), 0):int(est[t] + durs[t])] = dems[t]
        bad = profile - own + dems[t] > cap
        csum = np.concatenate([[0], np.cumsum(bad)])
        ends = np.minimum(np.arange(horizon) + int(durs[t]), horizon)
        feas = (csum[ends] - csum[:-1]) == 0
        v = int(svars[t])
        ok_lb = np.nonzero(feas & (np.arange(horizon) >= est[t]))[0]
        new_lb = int(ok_lb[0]) if len(ok_lb) else int(box_hi[v]) + 1
        new_lb = min(new_lb, int(box_hi[v]))
        if new_lb > lb[v]:
            lb[v] = new_lb
            changed.append(v)
        ok_ub = np.nonzero(feas & (np.arange(horizon) <= lst[t]))[0]
        new_ub = int(ok_ub[-1]) if len(ok_ub) else int(box_lo[v]) - 1
        new_ub = max(new_ub, int(box_lo[v]))
        if new_ub < ub[v]:
            ub[v] = new_ub
            changed.append(v)
    return changed


def _ct_update(lb, ub, dom, vs, supp, dom_off, n_words,
               box_lo, box_hi) -> List[int]:
    """Reset-based Compact-Table filtering for one extensional row —
    numpy transcription of `fixpoint.ct_candidates_tile` (DESIGN.md §17).

    `supp` is the de-padded support bank ``[R, K32, TW]``: bit j of word
    ``supp[r, k, j // 32]`` is set iff tuple j takes value
    ``dom_off[vs[r]] + k`` at position r.  All member vars are
    dom-tracked by construction (n_words covers table∪branch widths).
    """
    R = len(vs)
    K32 = B.WORD_BITS * n_words
    off = dom_off[vs]
    vbw = dom[vs] & B.np_from_bounds(lb[vs], ub[vs], off, n_words)
    shifts = np.arange(B.WORD_BITS, dtype=np.uint32)
    vb = ((vbw[:, :, None] >> shifts) & np.uint32(1)).reshape(R, K32)
    # OR of supports over live member values; sum == OR because each
    # tuple has exactly one value per position (disjoint bit columns)
    supp_on = (vb[:, :, None] * supp).sum(axis=1).astype(np.uint32)
    curr = np.bitwise_and.reduce(supp_on, axis=0)
    changed: List[int] = []
    if not curr.any():                       # currtable wiped: unsatisfiable
        v0 = int(vs[0])
        if lb[v0] < int(box_hi[v0]):         # box_hi = ub0+1 crosses ub
            lb[v0] = int(box_hi[v0])
            changed.append(v0)
        return changed
    surv = (supp & curr[None, None, :]).any(axis=2)           # [R, K32]
    nw = ((surv.reshape(R, n_words, B.WORD_BITS).astype(np.uint32)
           << shifts).sum(axis=2).astype(np.uint32))
    for r in range(R):
        v = int(vs[r])
        ndw = dom[v] & nw[r]
        if not np.array_equal(ndw, dom[v]):
            dom[v] = ndw
            changed.append(v)
        lo, hi = B.np_to_bounds(ndw, dom_off[v])
        nlb = min(int(lo), int(box_hi[v]))
        if nlb > lb[v]:
            lb[v] = nlb
            changed.append(v)
        nub = max(int(hi), int(box_lo[v]))
        if nub < ub[v]:
            ub[v] = nub
            changed.append(v)
    return changed


class SequentialSolver:
    """Event-queue propagation + DFS + B&B on numpy stores.

    Propagator ids: ``[0, P)`` are the ReifLinLe rows, ``[P, P+A)`` the
    AllDifferent rows, ``[P+A, P+A+C)`` the Cumulative rows,
    ``[P+A+C, P+A+C+T)`` the Compact-Table rows — all in one event
    queue with per-kind watch lists (DESIGN.md §12, §17).

    When the model has tables (or middle-out branching is selected) a
    packed bitset store rides along the interval stores on the DFS
    stack, exactly like the engine's optional `dom` carry.
    """

    def __init__(self, cm: CompiledModel,
                 opts: Optional[S.SearchOptions] = None):
        self.cm = cm
        self.opts = opts or S.SearchOptions()
        # the tables, copied to the host once
        host = {f: getattr(cm, f).cpu().numpy() for f in (
            "lb0", "ub0", "vidx", "coef", "rhs", "bidx", "box_lo", "box_hi",
            "branch_vars", "dom_off", "dom_track", "ad_vars", "ad_offs",
            "ad_mask", "cu_svar", "cu_dur", "cu_dem", "cu_cap", "ct_vars",
            "ct_mask", "ct_supp")}
        self.lb0, self.ub0 = host["lb0"], host["ub0"]
        self.vidx = host["vidx"]
        self.coef = host["coef"]
        self.rhs = host["rhs"]
        self.bidx = host["bidx"]
        self.box_lo = host["box_lo"]
        self.box_hi = host["box_hi"]
        self.branch_vars = host["branch_vars"]
        P, A, C = cm.n_props, cm.n_alldiff, cm.n_cumulative
        T = cm.n_table
        self.n_pids = P + A + C + T
        self.dom_off = host["dom_off"]
        self.dom_track = host["dom_track"]
        self.n_words = cm.n_words
        self.use_dom = T > 0 or self.opts.val_strategy == S.VAL_MIDDLE_OUT
        # native banks, de-padded to per-row member lists
        ad_mask = host["ad_mask"]
        self.ad_rows = []
        for a in range(A):
            sel = ad_mask[a] != 0
            self.ad_rows.append((host["ad_vars"][a][sel],
                                 host["ad_offs"][a][sel]))
        self.cu_rows = []
        for c in range(C):
            self.cu_rows.append((host["cu_svar"][c], host["cu_dur"][c],
                                 host["cu_dem"][c], int(host["cu_cap"][c])))
        ct_mask = host["ct_mask"]
        self.ct_rows = []
        for t in range(T):
            sel = ct_mask[t] != 0
            self.ct_rows.append((host["ct_vars"][t][sel],
                                 host["ct_supp"][t][sel]))
        # watchers: var -> pids that mention it (terms/reif bool/members)
        self.watch: List[List[int]] = [[] for _ in range(cm.n_vars)]
        for p in range(P):
            seen = set()
            for k in range(cm.k_terms):
                if self.coef[p, k] != 0:
                    seen.add(int(self.vidx[p, k]))
            seen.add(int(self.bidx[p]))
            for v in seen:
                self.watch[v].append(p)
        for a, (vs, _) in enumerate(self.ad_rows):
            for v in set(int(x) for x in vs):
                self.watch[v].append(P + a)
        for c, (vs, du, de, _) in enumerate(self.cu_rows):
            eff = set(int(v) for v, d_, r_ in zip(vs, du, de)
                      if d_ > 0 and r_ > 0)
            for v in eff:
                self.watch[v].append(P + A + c)
        for t, (vs, _) in enumerate(self.ct_rows):
            for v in set(int(x) for x in vs):
                self.watch[v].append(P + A + C + t)

    def _apply_pid(self, lb, ub, dom, pid: int) -> List[int]:
        P, A, C = self.cm.n_props, self.cm.n_alldiff, self.cm.n_cumulative
        if pid < P:
            return _row_update(lb, ub, pid, self.vidx, self.coef, self.rhs,
                               self.bidx, self.box_lo, self.box_hi)
        if pid < P + A:
            vs, offs = self.ad_rows[pid - P]
            return _alldiff_update(lb, ub, vs, offs, self.box_lo, self.box_hi)
        if pid < P + A + C:
            vs, du, de, cap = self.cu_rows[pid - P - A]
            return _cumulative_update(lb, ub, vs, du, de, cap,
                                      self.cm.horizon,
                                      self.box_lo, self.box_hi)
        vs, supp = self.ct_rows[pid - P - A - C]
        return _ct_update(lb, ub, dom, vs, supp, self.dom_off, self.n_words,
                          self.box_lo, self.box_hi)

    def _normalize(self, lb, ub, dom) -> List[int]:
        """`fixpoint.dom_normalize_tile` transcription: clip the bitset
        store to the interval hull and tighten tracked bounds back to
        the bitset hull.  Returns vars whose bounds moved."""
        dom &= B.np_from_bounds(lb, ub, self.dom_off, self.n_words,
                                track=self.dom_track)
        lo, hi = B.np_to_bounds(dom, self.dom_off)
        trk = self.dom_track != 0
        nlb = np.where(trk, np.maximum(lb, np.minimum(lo, self.box_hi)),
                       lb).astype(lb.dtype)
        nub = np.where(trk, np.minimum(ub, np.maximum(hi, self.box_lo)),
                       ub).astype(ub.dtype)
        ch = np.nonzero((nlb != lb) | (nub != ub))[0]
        lb[:] = nlb
        ub[:] = nub
        return [int(v) for v in ch]

    def propagate(self, lb, ub, dom=None,
                  dirty: Optional[List[int]] = None) -> bool:
        """Event loop to fixpoint (interleaved with dom↔bounds
        normalization when a bitset store rides along).  Returns False
        on failure.  A caller that passes no `dom` on a table model
        gets the engine's transient-dom fallback: a bounds-derived
        bitset per call (sound superset, weaker on holes)."""
        P = self.n_pids
        if dom is None and self.cm.n_table > 0:
            dom = B.np_from_bounds(lb, ub, self.dom_off, self.n_words,
                                   track=self.dom_track)
        if dirty is None:
            queue = list(range(P))
            queued = [True] * P
        else:
            queue = []
            queued = [False] * P
            for v in dirty:
                for p in self.watch[v]:
                    if not queued[p]:
                        queued[p] = True
                        queue.append(p)
        qi = 0
        while True:
            while qi < len(queue):
                p = queue[qi]
                qi += 1
                queued[p] = False
                changed = self._apply_pid(lb, ub, dom, p)
                for v in changed:
                    if lb[v] > ub[v]:
                        return False
                    for q in self.watch[v]:
                        if not queued[q]:
                            queued[q] = True
                            queue.append(q)
                if qi > 4096 * max(P, 1):    # safety valve
                    raise RuntimeError("event loop runaway")
            if dom is None:
                return True
            moved = self._normalize(lb, ub, dom)
            if not moved:
                return True
            for v in moved:
                if lb[v] > ub[v]:
                    return False
                for p in self.watch[v]:
                    if not queued[p]:
                        queued[p] = True
                        queue.append(p)

    def solve(self, timeout_s: Optional[float] = None,
              node_budget: Optional[int] = None) -> SolveResult:
        cm, opts = self.cm, self.opts
        t0 = time.time()
        big = np.iinfo(self.lb0.dtype).max // 4
        lb = self.lb0.copy()
        ub = self.ub0.copy()
        best_obj = big
        best_sol = None
        n_nodes = n_fails = n_sols = 0
        complete = True

        dom0 = (B.np_from_bounds(lb, ub, self.dom_off, self.n_words,
                                 track=self.dom_track)
                if self.use_dom else None)
        ok = self.propagate(lb, ub, dom0)
        stack: List[Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]] = []
        if ok:
            stack.append((lb, ub, dom0))

        while stack:
            if timeout_s is not None and time.time() - t0 > timeout_s:
                complete = False
                break
            if node_budget is not None and n_nodes >= node_budget:
                complete = False
                break
            lb, ub, dom = stack.pop()
            # B&B bound tell (joined on pop => valid for the whole subtree)
            if cm.obj_var >= 0 and best_obj < big:
                if ub[cm.obj_var] > best_obj - 1:
                    ub[cm.obj_var] = best_obj - 1
                if not self.propagate(lb, ub, dom, dirty=[cm.obj_var]):
                    n_nodes += 1
                    n_fails += 1
                    continue
            n_nodes += 1
            bl, bu = lb[self.branch_vars], ub[self.branch_vars]
            unfixed = bl < bu
            if not unfixed.any():
                n_sols += 1
                obj = int(lb[cm.obj_var]) if cm.obj_var >= 0 else 0
                if cm.obj_var < 0 or obj < best_obj:
                    best_obj = obj
                    best_sol = lb.copy()
                if cm.obj_var < 0 and opts.stop_on_first:
                    break
                continue
            # branch
            if opts.var_strategy == S.MIN_DOM:
                w = np.where(unfixed, bu - bl, big)
                pos = int(np.argmin(w))
            elif opts.var_strategy == S.MIN_LB:
                w = np.where(unfixed, bl, big)
                pos = int(np.argmin(w))
            else:
                pos = int(np.argmax(unfixed))
            v = int(self.branch_vars[pos])
            mid_out = (opts.val_strategy == S.VAL_MIDDLE_OUT
                       and dom is not None and self.dom_track[v] != 0)
            if mid_out:
                # pick the live value closest to the interval midpoint
                # (ties to the lower value), branch x = m  |  x ≠ m
                off_v = int(self.dom_off[v])
                vbw = dom[v] & B.np_from_bounds(lb[v], ub[v], off_v,
                                                self.n_words)
                shifts = np.arange(B.WORD_BITS, dtype=np.uint32)
                bits = ((vbw[:, None] >> shifts) & np.uint32(1)).reshape(-1)
                vals = off_v + np.nonzero(bits)[0].astype(np.int64)
                mid = (int(lb[v]) + int(ub[v])) // 2
                score = 2 * np.abs(vals - mid) + (vals > mid)
                mval = int(vals[int(np.argmin(score))])
                rl, ru = lb.copy(), ub.copy()
                rd = dom.copy()
                rd[v] = B.np_clear_value(dom[v], mval, off_v)
                if self.propagate(rl, ru, rd, dirty=[v]):
                    stack.append((rl, ru, rd))
                ll, lu, ld = lb, ub, dom      # reuse parent arrays for left
                ll[v] = lu[v] = mval
                if self.propagate(ll, lu, ld, dirty=[v]):
                    stack.append((ll, lu, ld))
                else:
                    n_fails += 1
                continue
            mval = int(lb[v]) if opts.val_strategy == S.VAL_MIN \
                else int((lb[v] + ub[v]) // 2)
            # right child pushed first => left (x ≤ m) explored first
            rl, ru = lb.copy(), ub.copy()
            rd = dom.copy() if dom is not None else None
            rl[v] = mval + 1
            if rl[v] <= ru[v] and self.propagate(rl, ru, rd, dirty=[v]):
                stack.append((rl, ru, rd))
            ll, lu, ld = lb, ub, dom          # reuse parent arrays for left
            lu[v] = mval
            if ll[v] <= lu[v] and self.propagate(ll, lu, ld, dirty=[v]):
                stack.append((ll, lu, ld))
            else:
                n_fails += 1

        wall = time.time() - t0
        has = best_sol is not None
        if has:
            status = OPTIMAL if complete and cm.obj_var >= 0 else SAT
            if cm.obj_var < 0:
                status = SAT
        else:
            status = UNSAT if complete else UNKNOWN
        return SolveResult(
            status=status,
            objective=(int(best_obj) if has and cm.obj_var >= 0 else None),
            solution=best_sol, n_nodes=n_nodes, n_fails=n_fails,
            n_sols=n_sols, n_sweeps=0, n_supersteps=0, wall_s=wall,
            complete=complete)
