"""The plain reference: RCPSP propagation, EPS and the lane search, in
plain PyTorch and numpy, written from the instance alone.

It imports nothing of the program.  The store of one subproblem holds,
per variable, a lower and an upper bound; its columns are the n start
times, the makespan (column n) and a constant ``true`` (column n + 1,
domain [1, 1]), which a store marks as failed by crossing its bounds.

Propagation reaches the greatest common fixpoint of

* the precedences ``s_i + d_i <= s_j`` and ``s_i + d_i <= makespan``,
  bounds consistent;
* per resource, time-table filtering: the profile of compulsory parts
  ``[lst, est + d)`` fails the store where it exceeds the capacity, and
  otherwise each task's start moves to its first (last) value whose run
  ``[s, s + d)`` meets no time at which the profile without the task
  plus its demand exceeds the capacity.

All of these are monotone and contracting, so the fixpoint does not
depend on the order in which they run; the reference reaches it by its
own schedule (precedences to their fixpoint, then one time-table pass,
repeated), so a program that stops short of it, or prunes past it,
reads differently.

`eps_pool` follows the EPS decomposition rule (split the widest
subproblem on its unfixed variable of least lower bound, x <= lb and
x >= lb + 1, keep the children that do not fail) and `Replay` one lane
superstep of depth-first branch and bound as the configuration states
it: pool dispatch, load, the bound tell, a full fixpoint, then record,
backtrack (full recomputation from the subproblem root) or branch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

BIG = np.iinfo(np.int32).max // 4          # "no incumbent" bound
UNASSIGNED = np.iinfo(np.int32).max // 2   # a lane with no subproblem


# --------------------------------------------------------------------------
# the ground check
# --------------------------------------------------------------------------

def check_schedule(inst, starts) -> Tuple[bool, int, str]:
    """(feasible, makespan, why not) for start times `starts[n]`."""
    s = np.asarray(starts, dtype=np.int64)
    d = np.asarray(inst.d, dtype=np.int64)
    if s.shape != d.shape:
        return False, -1, f"{s.shape[0]} starts for {d.shape[0]} jobs"
    if (s < 0).any():
        return False, -1, "negative start"
    for i, j in inst.arcs:
        if s[i] + d[i] > s[j]:
            return False, -1, f"precedence {i} -> {j} broken"
    mk = int((s + d).max())
    prof = np.zeros((inst.q.shape[0], mk + 1), dtype=np.int64)
    for i in range(len(d)):
        prof[:, s[i]:s[i] + d[i]] += inst.q[:, i:i + 1]
    over = prof > np.asarray(inst.cap)[:, None]
    if over.any():
        k, t = np.argwhere(over)[0]
        return False, -1, f"resource {k} over capacity at t={t}"
    return True, mk, ""


def lower_bound(inst) -> int:
    """A makespan no schedule beats: the longest precedence path, and per
    resource its work over its capacity."""
    es = np.zeros(inst.n, dtype=np.int64)
    for i, j in sorted(inst.arcs, key=lambda a: a[1]):
        es[j] = max(es[j], es[i] + inst.d[i])
    cp = int((es + inst.d).max())
    work = (inst.q * inst.d[None, :]).sum(1)
    energy = max(int(-(-w // c)) for w, c in zip(work, inst.cap) if c > 0)
    return max(cp, energy)


# --------------------------------------------------------------------------
# propagation
# --------------------------------------------------------------------------

NO_PATH = -(1 << 40)


def longest_paths(inst) -> np.ndarray:
    """``P[a, b]``: the longest sum of durations along a chain of
    precedences from job a to b (column n: to the makespan), ``NO_PATH``
    where b does not follow a; the diagonal is 0."""
    n = inst.n
    p = np.full((n + 1, n + 1), NO_PATH, dtype=np.int64)
    np.fill_diagonal(p, 0)
    for i, j in inst.arcs:
        p[i, j] = max(p[i, j], int(inst.d[i]))
    p[np.arange(n), n] = inst.d
    for k in range(n + 1):                 # Floyd–Warshall, max-plus
        via = p[:, k:k + 1] + p[k:k + 1, :]
        ok = (p[:, k:k + 1] > NO_PATH) & (p[k:k + 1, :] > NO_PATH)
        p = np.where(ok, np.maximum(p, via), p)
    return p


class Propagator:
    """The instance's propagators over batches of stores ``[B, n + 2]``
    (int64) on `device`."""

    def __init__(self, inst, device="cpu", block: int = 1024):
        self.n = n = inst.n
        self.h = inst.horizon
        self.dev = torch.device(device)
        self.block = block
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64,
                                      device=self.dev)
        self.paths = t(longest_paths(inst))             # [n + 1, n + 1]
        self.d = t(inst.d)
        self.q = t(inst.q)                                 # [K, n]
        self.cap = t(inst.cap)
        self.grid = torch.arange(self.h, dtype=torch.int64, device=self.dev)
        q, cap = np.asarray(inst.q), np.asarray(inst.cap)
        self.used = [k for k in range(q.shape[0]) if (q[k] > 0).any()]
        self.never_fits = bool((q > cap[:, None]).any())

    @property
    def width(self) -> int:
        return self.n + 2

    def root(self) -> Tuple[torch.Tensor, torch.Tensor]:
        n, h = self.n, self.h
        lb = torch.zeros((1, n + 2), dtype=torch.int64, device=self.dev)
        ub = torch.full((1, n + 2), h, dtype=torch.int64, device=self.dev)
        lb[:, n + 1] = 1
        ub[:, n + 1] = 1
        return lb, ub

    def _precedences(self, lb, ub):
        """The precedences to their own fixpoint in one step: each bound
        moved by its longest paths (the fixpoint of bounds propagation
        over difference constraints)."""
        m = self.n + 1
        p = self.paths
        nlb, nub = lb.clone(), ub.clone()
        nlb[:, :m] = torch.maximum(
            lb[:, :m], (lb[:, :m, None] + p[None]).amax(1))
        nub[:, :m] = torch.minimum(
            ub[:, :m], (ub[:, None, :m] - p[None]).amin(2))
        return nlb, nub

    def _timetable(self, lb, ub):
        """One time-table pass over every resource (stores not failed)."""
        n, h = self.n, self.h
        B = lb.shape[0]
        est, lst = lb[:, :n], ub[:, :n]
        ect = est + self.d
        t = self.grid
        cp = (t >= lst[..., None]) & (t < ect[..., None])       # [B, n, h]
        has_cp = lst < ect
        forbid = torch.zeros((B, n, h), dtype=torch.bool, device=self.dev)
        fail = torch.zeros(B, dtype=torch.bool, device=self.dev)
        for k in self.used:
            qk = self.q[k]
            uses = qk > 0
            add = torch.where(has_cp & uses, qk, 0)
            prof = torch.zeros((B, h + 1), dtype=torch.int64,
                               device=self.dev)
            prof.scatter_add_(1, lst.clamp(0, h), add)
            prof.scatter_add_(1, ect.clamp(0, h), -add)
            prof = prof.cumsum(1)[:, :h]                          # [B, h]
            fail |= (prof > self.cap[k]).any(1)
            thr = (self.cap[k] - qk)[None, :, None]               # [1, n, 1]
            forbid |= (prof[:, None, :] > thr) & uses[None, :, None]
            if self.never_fits:                                   # q > cap
                forbid |= (qk > self.cap[k])[None, :, None]
        forbid &= ~cp
        csum = torch.zeros((B, n, h + 1), dtype=torch.int32, device=self.dev)
        csum[:, :, 1:] = forbid.cumsum(2, dtype=torch.int32)
        end = (t[None, :] + self.d[:, None])                      # [n, h]
        fits = end <= h
        hit = (csum.gather(2, end.clamp(max=h).expand(B, n, h))
               - csum[:, :, :h]) > 0
        feas = fits[None] & ~hit
        first = torch.where(feas & (t >= est[..., None]), t, h + 1).amin(2)
        last = torch.where(feas & (t <= lst[..., None]), t, -1).amax(2)
        nlb, nub = lb.clone(), ub.clone()
        nlb[:, :n] = torch.maximum(est, first)
        nub[:, :n] = torch.minimum(lst, last)
        nlb[:, n + 1] = torch.where(fail, 2, nlb[:, n + 1])       # failed
        return nlb, nub

    def fixpoint(self, lb, ub) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
        """Stores ``[B, n + 2]`` to their fixpoints: (lb, ub, failed[B]).
        A failed store's bounds are whatever crossed first."""
        lb, ub = lb.clone(), ub.clone()
        for at in range(0, lb.shape[0], self.block):
            sl = slice(at, at + self.block)
            lb[sl], ub[sl] = self._fixpoint_block(lb[sl], ub[sl])
        return lb, ub, (lb > ub).any(1)

    def _fixpoint_block(self, lb, ub):
        live = ~(lb > ub).any(1)
        while bool(live.any()):
            idx = live.nonzero().squeeze(1)
            l, u = self._precedences(lb[idx], ub[idx])
            ok = ~(l > u).any(1)
            l2, u2 = l.clone(), u.clone()
            if bool(ok.any()):
                l2[ok], u2[ok] = self._timetable(l[ok], u[ok])
            moved = ((l2 != l) | (u2 != u)).any(1)
            lb[idx], ub[idx] = l2, u2
            live[idx] = moved & ~(l2 > u2).any(1)
        return lb, ub


# --------------------------------------------------------------------------
# EPS
# --------------------------------------------------------------------------

def eps_pool(prop: Propagator, target: int) -> Tuple[np.ndarray, np.ndarray]:
    """The EPS pool of the instance, ``[S, n + 2]`` host arrays: split
    the widest subproblem (first on ties) on its unfixed start or
    makespan of least lower bound (first on ties) at x <= lb / x >= lb + 1,
    keep the children that do not fail (the x <= lb child first), until
    the frontier and the fixed leaves reach `target`; the pool is the
    frontier, then the leaves.  A failed root gives one failed store."""
    nb = prop.n + 1                                 # starts and makespan
    lb, ub = prop.root()
    lb, ub, failed = prop.fixpoint(lb, ub)
    lb, ub = lb[0].cpu().numpy(), ub[0].cpu().numpy()
    if bool(failed[0]):
        return lb[None], ub[None]

    def width(l, u):
        return int(np.clip(u[:nb] - l[:nb], 0, None).sum())

    frontier = [(lb, ub)]
    widths = [width(lb, ub)]
    leaves = []
    while frontier and len(frontier) + len(leaves) < target:
        i = int(np.argmax(widths))
        l, u = frontier.pop(i)
        widths.pop(i)
        unf = l[:nb] < u[:nb]
        if not unf.any():
            leaves.append((l, u))
            continue
        v = int(np.argmin(np.where(unf, l[:nb], BIG)))
        m = int(l[v])
        cl = np.stack([l, l])
        cu = np.stack([u, u])
        cu[0, v] = min(cu[0, v], m)
        cl[1, v] = max(cl[1, v], m + 1)
        kl, ku, kf = prop.fixpoint(torch.from_numpy(cl).to(prop.dev),
                                   torch.from_numpy(cu).to(prop.dev))
        kl, ku, kf = kl.cpu().numpy(), ku.cpu().numpy(), kf.cpu().numpy()
        for k in range(2):
            if not kf[k]:
                frontier.append((kl[k], ku[k]))
                widths.append(width(kl[k], ku[k]))
    pool = frontier + leaves
    if not pool:
        bad_l, bad_u = lb.copy(), ub.copy()
        bad_l[prop.n + 1], bad_u[prop.n + 1] = 1, 0
        pool = [(bad_l, bad_u)]
    return (np.stack([p[0] for p in pool]), np.stack([p[1] for p in pool]))


# --------------------------------------------------------------------------
# the lane search
# --------------------------------------------------------------------------

LANE_FIELDS = ("lb", "ub", "root_lb", "root_ub", "dec_var", "dec_val",
               "dec_flip", "depth", "next_sub", "fresh", "done",
               "incomplete", "best_obj", "best_sol", "has_sol", "n_nodes",
               "n_fails", "n_sols")


@dataclasses.dataclass
class Lanes:
    """Every lane's search state, in the reference's columns: the
    current store and its subproblem root, the decision path (variable,
    value, whether on its right branch) and depth, the pool index it
    holds, its flags, incumbent and counters; beside them the shared
    bound, the superstep count and the pool cursor."""

    f: Dict[str, torch.Tensor]
    gbest: int
    it: int
    head: int


class Replay:
    """Supersteps of the lane search, as the configuration states them
    (var: least lower bound; value: x <= lb, then x >= lb + 1)."""

    def __init__(self, prop: Propagator, pool_lb, pool_ub,
                 stop_on_first: bool):
        self.prop = prop
        self.pool_lb = torch.as_tensor(pool_lb, dtype=torch.int64,
                                       device=prop.dev)
        self.pool_ub = torch.as_tensor(pool_ub, dtype=torch.int64,
                                       device=prop.dev)
        self.stop_on_first = stop_on_first

    def stopped(self, s: Lanes) -> bool:
        f = s.f
        return bool(f["done"].all()) or (self.stop_on_first
                                         and bool(f["has_sol"].any()))

    def run(self, s: Lanes, supersteps: int) -> Tuple[Lanes, bool]:
        """Up to `supersteps` supersteps; a superstep that starts with
        the search stopped is skipped.  Returns (lanes, stopped)."""
        for _ in range(supersteps):
            if self.stopped(s):
                break
            s = self.step(s)
        return s, self.stopped(s)

    def step(self, s: Lanes) -> Lanes:
        f = {k: v.clone() for k, v in s.f.items()}
        prop = self.prop
        n, dev = prop.n, prop.dev
        S = self.pool_lb.shape[0]
        L, md = f["dec_var"].shape
        obj = n
        # -- dispatch: lanes wanting work take the next pool indices ------
        want = f["fresh"] & ~f["done"] & (f["next_sub"] >= S)
        slot = s.head + torch.cumsum(want.to(torch.int64), 0) - 1
        got = want & (slot < S)
        f["next_sub"] = torch.where(got, slot, f["next_sub"])
        f["done"] = f["done"] | (want & (slot >= S))
        head = min(s.head + int(want.sum()), S)
        # -- load ---------------------------------------------------------
        load = f["fresh"] & (f["next_sub"] < S)
        sub = f["next_sub"].clamp(0, S - 1)
        lc = load[:, None]
        f["root_lb"] = torch.where(lc, self.pool_lb[sub], f["root_lb"])
        f["root_ub"] = torch.where(lc, self.pool_ub[sub], f["root_ub"])
        lb = torch.where(lc, f["root_lb"], f["lb"])
        ub = torch.where(lc, f["root_ub"], f["ub"])
        depth = torch.where(load, 0, f["depth"])
        f["next_sub"] = torch.where(load, UNASSIGNED, f["next_sub"])
        fresh = f["fresh"] & ~load & ~f["done"]
        active = ~f["done"] & ~fresh
        # -- the bound tell -----------------------------------------------
        inc = torch.minimum(torch.full_like(f["best_obj"], s.gbest),
                            f["best_obj"])
        bound = torch.where(inc < BIG, inc - 1, BIG)
        ub[:, obj] = torch.where(active, torch.minimum(ub[:, obj], bound),
                                 ub[:, obj])
        # -- propagate the active lanes ------------------------------------
        idx = active.nonzero().squeeze(1)
        if idx.numel():
            plb, pub, _ = prop.fixpoint(lb[idx], ub[idx])
            lb[idx], ub[idx] = plb, pub
        failed = active & (lb > ub).any(1)
        solved = active & ~failed & (lb == ub).all(1)
        f["n_nodes"] = f["n_nodes"] + active.to(torch.int64)
        f["n_fails"] = f["n_fails"] + failed.to(torch.int64)
        f["n_sols"] = f["n_sols"] + solved.to(torch.int64)
        better = solved & (lb[:, obj] < f["best_obj"])
        f["best_obj"] = torch.where(better, lb[:, obj], f["best_obj"])
        f["best_sol"] = torch.where(better[:, None], lb, f["best_sol"])
        f["has_sol"] = f["has_sol"] | solved
        # -- backtrack: the deepest open decision turns to its right branch
        bt = failed | solved
        lvl = torch.arange(md, device=dev)
        open_ = ~f["dec_flip"] & (lvl[None, :] < depth[:, None])
        has_open = open_.any(1)
        bt_level = torch.where(open_, lvl[None, :], -1).amax(1)
        exhausted = bt & ~has_open
        do_bt = bt & has_open
        flip = torch.where(
            do_bt[:, None],
            (f["dec_flip"] & (lvl[None, :] < bt_level[:, None]))
            | (lvl[None, :] == bt_level[:, None]), f["dec_flip"])
        depth_bt = bt_level + 1
        rlb, rub = f["root_lb"].clone(), f["root_ub"].clone()
        on = lvl[None, :] < depth_bt[:, None]
        dv = f["dec_var"].clamp(0, prop.width - 1)
        rub.scatter_reduce_(1, dv, torch.where(on & ~flip, f["dec_val"], BIG),
                            "amin", include_self=True)
        rlb.scatter_reduce_(1, dv, torch.where(on & flip, f["dec_val"] + 1,
                                               -BIG),
                            "amax", include_self=True)
        # -- branch ---------------------------------------------------------
        blb, bub = lb[:, :n + 1], ub[:, :n + 1]
        unf = blb < bub
        var = torch.where(unf, blb, BIG).argmin(1)
        m = lb.gather(1, var[:, None])[:, 0]
        do_branch = active & ~bt & unf.any(1)
        overflow = do_branch & (depth >= md)
        do_branch = do_branch & ~overflow
        at = ((lvl[None, :] == depth.clamp(0, md - 1)[:, None])
              & do_branch[:, None])
        f["dec_var"] = torch.where(at, var[:, None], f["dec_var"])
        f["dec_val"] = torch.where(at, m[:, None], f["dec_val"])
        f["dec_flip"] = torch.where(at, False, flip)
        cols = torch.arange(prop.width, device=dev)
        tell = (cols[None, :] == var[:, None]) & do_branch[:, None]
        bub_full = torch.where(tell, torch.minimum(ub, m[:, None]), ub)
        f["lb"] = torch.where(do_bt[:, None], rlb, lb)
        f["ub"] = torch.where(do_bt[:, None], rub, bub_full)
        f["depth"] = torch.where(do_bt, depth_bt,
                                 torch.where(do_branch, depth + 1, depth))
        f["fresh"] = fresh | exhausted | overflow
        f["incomplete"] = f["incomplete"] | overflow
        gbest = min(s.gbest, int(f["best_obj"].min()))
        return Lanes(f, gbest, s.it + 1, head)


def compare_lanes(ref: Lanes, got: Lanes) -> Tuple[int, List[str]]:
    """Lanes whose search state differs, plus one for each differing
    shared value (bound, superstep count, cursor); with the first few
    differences named.  A lane's store and path are compared only while
    it holds a subproblem; its incumbent only once it has one."""
    a, b = ref.f, got.f
    L = a["depth"].shape[0]
    bad = torch.zeros(L, dtype=torch.bool, device=a["depth"].device)
    notes: List[str] = []

    def mark(name, diff):
        nonlocal bad
        if bool(diff.any()) and len(notes) < 6:
            notes.append(f"{name}: {int(diff.sum())} lanes, first "
                         f"{int(diff.nonzero()[0, 0])}")
        bad = bad | diff

    for k in ("done", "fresh", "incomplete", "has_sol", "depth",
              "n_nodes", "n_fails", "n_sols"):
        mark(k, a[k] != b[k])
    mark("best_obj", a["has_sol"] & (a["best_obj"] != b["best_obj"]))
    mark("best_sol", a["has_sol"] & (a["best_sol"] != b["best_sol"]).any(1))
    holds = ~a["done"] & ~a["fresh"]
    for k in ("lb", "ub", "root_lb", "root_ub"):
        mark(k, holds & (a[k] != b[k]).any(1))
    md = a["dec_var"].shape[1]
    on = torch.arange(md, device=bad.device)[None, :] < a["depth"][:, None]
    for k in ("dec_var", "dec_val", "dec_flip"):
        mark(k, holds & (on & (a[k] != b[k])).any(1))
    n_bad = int(bad.sum())
    for k in ("gbest", "it", "head"):
        if getattr(ref, k) != getattr(got, k):
            n_bad += 1
            notes.append(f"{k}: reference {getattr(ref, k)}, "
                         f"program {getattr(got, k)}")
    return n_bad, notes


def compare_pools(ref_lb, ref_ub, got_lb, got_ub) -> Tuple[int, str]:
    """Rows that differ between two pools ``[S, n + 2]`` (failed stores
    are equal to one another), plus the difference in their sizes."""
    ref_lb, ref_ub = np.asarray(ref_lb), np.asarray(ref_ub)
    got_lb, got_ub = np.asarray(got_lb), np.asarray(got_ub)
    n_ref, n_got = ref_lb.shape[0], got_lb.shape[0]
    k = min(n_ref, n_got)
    fr = (ref_lb[:k] > ref_ub[:k]).any(1)
    fg = (got_lb[:k] > got_ub[:k]).any(1)
    same = (fr & fg) | (~fr & ~fg & (ref_lb[:k] == got_lb[:k]).all(1)
                        & (ref_ub[:k] == got_ub[:k]).all(1))
    n_bad = int((~same).sum()) + abs(n_ref - n_got)
    note = ""
    if n_bad:
        first = int(np.argmin(same)) if (~same).any() else k
        note = (f"{n_bad} rows differ (sizes {n_ref} and {n_got}; first "
                f"at row {first})")
    return n_bad, note
