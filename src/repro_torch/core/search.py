"""Batched propagate-and-search (paper §TURBO) — port of
``repro/core/search.py``.

A *lane* owns one EPS subproblem at a time and runs depth-first search
on it; lanes are the leading axis of every tensor.  Two stores per lane
(the subproblem root and the current store); backtracking re-joins the
root with the whole decision path (full recomputation, no trail);
branch & bound prunes against a shared best objective.

`lanes_step` is one superstep in four phases: `dispatch_pool_tile` (idle
lanes pop the next EPS subproblems), `lane_load_tile` (load + B&B tell),
**one** lane-batched backend fixpoint over the whole ``[n_lanes, V]``
store tensor, and `lane_commit_tile` (record, backtrack or branch).  All
phases are plain tensor functions with the reference's mask-based
control flow, so the state after k supersteps equals the reference's
field for field.

Value strategies: ``min`` and ``split`` branch x ≤ m / x ≥ m+1;
``middle_out`` branches x = m / x ≠ m on the remaining value nearest the
interval midpoint, the right branch a bit clear in the carried bitset
store (`LaneState.dom`/`root_dom`, int32 bit patterns; see `bitset`).
Search carries that store for table models and under ``middle_out``
(`use_dom`).  A variable wider than the 32·W-value bitset is untracked,
and ``middle_out`` branches on it exactly as ``split`` does (value and
tells); the reference's selection reads the pinned all-ones words of
such a variable instead, which can pick a value outside its interval
(ROADMAP, reference notes), so the two agree wherever every branch
variable is tracked.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import bitset as B
from repro_torch.core import lattice as LT
from repro_torch.core.backend import get_backend
from repro_torch.core.compile import CompiledModel

# variable-selection strategies
INPUT_ORDER = "input_order"
MIN_DOM = "min_dom"
MIN_LB = "min_lb"

# sentinel: lane has no assigned subproblem (shared-queue dispatch)
UNASSIGNED = np.iinfo(np.int32).max // 2
# value-selection strategies
VAL_MIN = "min"       # m = lb  (assign lower bound)
VAL_SPLIT = "split"   # m = (lb+ub)//2
VAL_MIDDLE_OUT = "middle_out"

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class SearchOptions:
    var_strategy: str = INPUT_ORDER
    val_strategy: str = VAL_MIN
    max_depth: int = 2048
    max_fixpoint_iters: Optional[int] = None
    stop_on_first: bool = False      # satisfaction: stop at first solution
    # propagation backend for the superstep's lane-batched fixpoint:
    # "cuda" | "cuda_resident" | "gather" (see core/backend.py)
    backend: str = "cuda"


class LaneState(NamedTuple):
    # current + root stores (the paper's two stores per block)
    lb: torch.Tensor            # i[L, V]
    ub: torch.Tensor            # i[L, V]
    root_lb: torch.Tensor       # i[L, V]
    root_ub: torch.Tensor       # i[L, V]
    # decision path
    dec_var: torch.Tensor       # i32[L, MD]
    dec_val: torch.Tensor       # i[L, MD]   branch point m
    dec_flip: torch.Tensor      # bool[L, MD] True once on the right branch
    depth: torch.Tensor         # i32[L]
    # subproblem queue cursor
    next_sub: torch.Tensor      # i32[L]
    fresh: torch.Tensor         # bool — needs to load a new subproblem
    done: torch.Tensor          # bool — queue exhausted
    incomplete: torch.Tensor    # bool — hit depth limit
    # incumbent
    best_obj: torch.Tensor      # i[L]
    best_sol: torch.Tensor      # i[L, V]
    has_sol: torch.Tensor       # bool[L]
    # stats (int32, as in the reference)
    n_nodes: torch.Tensor
    n_fails: torch.Tensor
    n_sols: torch.Tensor
    n_sweeps: torch.Tensor
    # bitset domain stores (int32 bit patterns), None unless `use_dom`
    dom: Optional[torch.Tensor] = None         # i32[L, V, W]
    root_dom: Optional[torch.Tensor] = None    # i32[L, V, W]


def _host_array(a):
    """A host array as torch takes it: ``uint32`` (the reference's
    bitset words) as its int32 view, everything else as it is."""
    a = np.array(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def lane_state_from_arrays(arrays: dict, device) -> LaneState:
    """A `LaneState` from host arrays keyed by field name (missing or
    None bitset fields stay None); dtypes are kept, except the bitset
    words, which become int32 bit patterns."""
    return LaneState(**{
        f: (None if arrays.get(f) is None else
            torch.from_numpy(_host_array(arrays[f])).to(device))
        for f in LaneState._fields})


def use_dom(cm: CompiledModel, opts: SearchOptions) -> bool:
    """Whether search carries the bitset store: table models always
    (Compact-Table filters value sets), and ``middle_out`` on any model
    (its right branch x ≠ m is a bitset tell)."""
    return cm.n_table > 0 or opts.val_strategy == VAL_MIDDLE_OUT


def init_lanes(cm: CompiledModel, n_lanes: int,
               opts: SearchOptions) -> LaneState:
    V = cm.n_vars
    dt, dev = cm.tdtype, cm.device
    big = torch.iinfo(dt).max // 4

    def z(*s, dtype=I32):
        return torch.zeros(s, dtype=dtype, device=dev)

    dom = z(n_lanes, V, cm.n_words) if use_dom(cm, opts) else None
    return LaneState(
        dom=dom, root_dom=None if dom is None else dom.clone(),
        lb=z(n_lanes, V, dtype=dt), ub=z(n_lanes, V, dtype=dt),
        root_lb=z(n_lanes, V, dtype=dt), root_ub=z(n_lanes, V, dtype=dt),
        dec_var=z(n_lanes, opts.max_depth),
        dec_val=z(n_lanes, opts.max_depth, dtype=dt),
        dec_flip=z(n_lanes, opts.max_depth, dtype=torch.bool),
        depth=z(n_lanes),
        next_sub=torch.full((n_lanes,), UNASSIGNED, dtype=I32, device=dev),
        fresh=torch.ones(n_lanes, dtype=torch.bool, device=dev),
        done=z(n_lanes, dtype=torch.bool),
        incomplete=z(n_lanes, dtype=torch.bool),
        best_obj=torch.full((n_lanes,), big, dtype=dt, device=dev),
        best_sol=z(n_lanes, V, dtype=dt),
        has_sol=z(n_lanes, dtype=torch.bool),
        n_nodes=z(n_lanes), n_fails=z(n_lanes), n_sols=z(n_lanes),
        n_sweeps=z(n_lanes),
    )


def dispatch_pool_tile(st: LaneState, pool_head, n_subs: int,
                       tile_id=0, n_tiles: int = 1):
    """Shared subproblem queue: fresh lanes pop the next pool indices;
    when the pool is drained they are marked done.  ``pool_head`` is a
    0-d int32 tensor.  With ``n_tiles > 1`` the pool is strided across
    tiles (tile ``t`` owns ``t, t + n_tiles, …``)."""
    want = st.fresh & ~st.done & (st.next_sub >= n_subs)
    rank = torch.cumsum(want, 0, dtype=I32) - 1
    slot = pool_head + rank
    idx = tile_id + n_tiles * slot if n_tiles > 1 else slot
    got = want & (idx < n_subs)
    next_sub = torch.where(got, idx.to(I32), st.next_sub)
    done = st.done | (want & (idx >= n_subs))
    shard = (n_subs if n_tiles == 1
             else -((n_subs - tile_id) // -n_tiles))     # ceil shard size
    new_head = torch.clamp(pool_head + want.sum(dtype=I32), max=shard)
    return st._replace(next_sub=next_sub, done=done), new_head


def apply_path_tile(root_lb, root_ub, dec_var, dec_val, dec_flip, depth, *,
                    val_strategy: str = VAL_MIN, root_dom=None,
                    dom_off=None, dom_track=None):
    """Full recomputation for a ``[L, V]`` tile: root ⊔ all decision
    tells, as one flat scatter-min/max — duplicate indices join
    associatively, as in the reference's ``.at[].min/max``.

    ``min``/``split`` branch left x ≤ m, right x ≥ m+1.  Under
    ``middle_out`` the left branch is x = m and the right branch x ≠ m,
    a bit clear in `root_dom`: the flipped decisions' one-hot word masks
    are summed by one flat scatter-add (an int64 accumulator, masked back
    to 32 bits, as the reference's uint32 add wraps) and cleared.
    Decisions on untracked vars tell x ≤ m / x ≥ m+1.  Returns (lb, ub),
    plus the recomputed dom when `root_dom` is carried."""
    L, V = root_lb.shape
    md = dec_var.shape[1]
    dev, dt = root_lb.device, root_lb.dtype
    lvl = torch.arange(md, device=dev)
    on = lvl[None, :] < depth[:, None]
    big = torch.iinfo(dt).max // 4
    dv = dec_var.long()
    ub_tell = torch.where(on & ~dec_flip, dec_val, big)       # left: x ≤ m
    if val_strategy == VAL_MIDDLE_OUT:
        trk = dom_track[dv] != 0                                  # [L, MD]
        lb_tell = torch.where(on & ~dec_flip & trk, dec_val,  # left: x = m
                              torch.where(on & dec_flip & ~trk,
                                          dec_val + 1, -big))  # x ≥ m+1
    else:
        lb_tell = torch.where(on & dec_flip, dec_val + 1, -big)  # x ≥ m+1
    rows = torch.arange(L, device=dev)[:, None] * V
    flat = (rows + dv).reshape(-1)
    ub = root_ub.reshape(L * V).clone().scatter_reduce_(
        0, flat, ub_tell.reshape(-1), "amin", include_self=True)
    lb = root_lb.reshape(L * V).clone().scatter_reduce_(
        0, flat, lb_tell.reshape(-1), "amax", include_self=True)
    lb, ub = lb.reshape(L, V), ub.reshape(L, V)
    if root_dom is None:
        return lb, ub
    dom = root_dom
    if val_strategy == VAL_MIDDLE_OUT:
        # right branches: clear bit (dec_val - off) of the decision var
        W = root_dom.shape[-1]
        bit = (dec_val - dom_off[dv]).long()                      # [L, MD]
        hit = on & dec_flip & trk & (bit >= 0) & (bit < W * B.WORD_BITS)
        word = torch.clamp(bit >> 5, 0, W - 1)
        mask = torch.where(hit, torch.ones_like(bit) << (bit & 31), 0)
        flat_w = (rows * W + dv * W + word).reshape(-1)
        acc = torch.zeros(L * V * W, dtype=torch.int64,
                          device=dev).scatter_add_(0, flat_w,
                                                   mask.reshape(-1))
        dom = dom & ~B.from_unsigned(acc & 0xFFFFFFFF).reshape(L, V, W)
    return lb, ub, dom


def select_branch_tile(lb, ub, branch_vars, *, var_strategy: str,
                       val_strategy: str, dom=None, dom_off=None,
                       dom_track=None):
    """Pick (var, m) for each lane's next decision over a ``[L, V]``
    tile.  Returns (var[L], m[L], any_unfixed[L]).  Ties go to the first
    index, as ``jnp.argmax``/``argmin`` do.

    ``middle_out`` (needs the carried `dom`) picks the remaining value
    nearest the interval midpoint (floor), ties to the lower value; on an
    untracked var (``dom_track`` 0) it picks the midpoint itself, as
    ``split`` does."""
    bv = branch_vars
    blb = lb.index_select(1, bv)                            # [L, B]
    bub = ub.index_select(1, bv)
    unfixed = blb < bub
    width = bub - blb
    big = torch.iinfo(lb.dtype).max // 4
    if var_strategy == INPUT_ORDER:
        pos = torch.argmax(unfixed.to(I32), dim=1)          # first True
    elif var_strategy == MIN_DOM:
        pos = torch.argmin(torch.where(unfixed, width, big), dim=1)
    elif var_strategy == MIN_LB:
        pos = torch.argmin(torch.where(unfixed, blb, big), dim=1)
    else:
        raise ValueError(var_strategy)
    var = bv[pos]                                           # [L]
    idx = var.long()[:, None]
    vlb = torch.gather(lb, 1, idx)[:, 0]
    vub = torch.gather(ub, 1, idx)[:, 0]
    if val_strategy == VAL_MIN:
        m = vlb
    elif val_strategy == VAL_SPLIT:
        m = torch.div(vlb + vub, 2, rounding_mode="floor")
    elif val_strategy == VAL_MIDDLE_OUT:
        if dom is None:
            raise ValueError("middle_out value ordering needs the bitset "
                             "domain store (search carries it whenever "
                             "the strategy is selected)")
        L, _, W = dom.shape
        K32 = W * B.WORD_BITS
        vdom = dom[torch.arange(L, device=dom.device), var.long()]  # [L, W]
        shifts = torch.arange(B.WORD_BITS, dtype=torch.int64,
                              device=dom.device)
        bits = ((B.unsigned(vdom)[:, :, None] >> shifts) & 1).reshape(L, K32)
        voff = dom_off[var.long()]                          # [L]
        vals = voff[:, None] + torch.arange(K32, dtype=lb.dtype,
                                            device=lb.device)[None, :]
        mid = torch.div(vlb + vub, 2, rounding_mode="floor")
        ok = (bits != 0) & (vals >= vlb[:, None]) & (vals <= vub[:, None])
        # 2·distance + 1 for the upper side: nearest wins, ties go low
        score = 2 * (vals - mid[:, None]).abs() + (vals > mid[:, None])
        pos = torch.argmin(torch.where(ok, score, big), dim=1)
        m = voff + pos.to(lb.dtype)
        m = torch.where(dom_track[var.long()] != 0, m, mid)
    else:
        raise ValueError(val_strategy)
    return var, m, unfixed.any(1)


class LanePrep(NamedTuple):
    """Lane-batched carry between `lane_load_tile` and `lane_commit_tile`;
    every field has a leading ``[L]`` lane axis."""
    lb: torch.Tensor            # i[L, V] store with decision + bound tells
    ub: torch.Tensor
    root_lb: torch.Tensor
    root_ub: torch.Tensor
    depth: torch.Tensor         # i32[L]
    next_sub: torch.Tensor      # i32[L]
    fresh: torch.Tensor         # bool[L]
    active: torch.Tensor        # bool[L] — lane participates this superstep
    dom: Optional[torch.Tensor] = None
    root_dom: Optional[torch.Tensor] = None


def lane_load_tile(subs_lb, subs_ub, st: LaneState, gbest, *,
                   obj_var: int, dom_off=None, dom_track=None,
                   n_words: int = 1) -> LanePrep:
    """Pre-propagation phase: subproblem load + B&B tell.

    `subs_lb/ub`: the pool ``[S, V]``; `gbest`: the 0-d global incumbent
    bound (already min-reduced across lanes).  With the bitset store a
    loaded lane's root dom is its subproblem's box (the EPS pool is
    interval-only, so this is lossless)."""
    S, V = subs_lb.shape
    dt = subs_lb.dtype
    big = torch.iinfo(dt).max // 4

    # -- 1. load the dispatcher-assigned subproblem when fresh -------------
    can_load = st.next_sub < S
    load = st.fresh & can_load
    sub = torch.clamp(st.next_sub, 0, S - 1)
    loadc = load[:, None]
    root_lb = torch.where(loadc, subs_lb.index_select(0, sub), st.root_lb)
    root_ub = torch.where(loadc, subs_ub.index_select(0, sub), st.root_ub)
    lb = torch.where(loadc, root_lb, st.lb)
    ub = torch.where(loadc, root_ub, st.ub)
    depth = torch.where(load, 0, st.depth)
    next_sub = torch.where(load, UNASSIGNED, st.next_sub)   # consumed
    fresh = st.fresh & ~load & ~st.done
    active = ~st.done & ~fresh
    dom = root_dom = None
    if st.dom is not None:
        fresh_dom = B.from_bounds(root_lb, root_ub, dom_off, n_words,
                                  track=dom_track)
        root_dom = torch.where(loadc[..., None], fresh_dom, st.root_dom)
        dom = torch.where(loadc[..., None], root_dom, st.dom)

    # -- 2. branch & bound tell ------------------------------------------
    if obj_var >= 0:
        inc = torch.minimum(gbest, st.best_obj)   # global ⊓ own incumbent
        bound = torch.where(inc < big, inc - 1, big)
        tell = torch.where(active, bound, big)                    # [L]
        ub[:, obj_var] = torch.minimum(ub[:, obj_var], tell)
    return LanePrep(lb=lb, ub=ub, root_lb=root_lb, root_ub=root_ub,
                    depth=depth, next_sub=next_sub, fresh=fresh,
                    active=active, dom=dom, root_dom=root_dom)


def lane_commit_tile(st: LaneState, pre: LanePrep, lb, ub, sweeps,
                     converged, branch_vars, *, obj_var: int,
                     var_strategy: str, val_strategy: str,
                     dom=None, dom_off=None, dom_track=None) -> LaneState:
    """Post-propagation phase: record / backtrack-or-branch.  `lb`, `ub`,
    `sweeps`, `converged` (and `dom`, when carried) are the batched
    backend fixpoint outputs."""
    L, V = lb.shape
    md = st.dec_var.shape[1]
    dev, dt = lb.device, lb.dtype
    big = torch.iinfo(dt).max // 4
    root_lb, root_ub = pre.root_lb, pre.root_ub
    depth, next_sub = pre.depth, pre.next_sub
    fresh, active, done = pre.fresh, pre.active, st.done

    failed = LT.is_empty(lb, ub).any(1)
    # a fully-fixed store is only a SOLUTION at a (per-lane) fixed point
    solved = active & converged & ~failed & LT.is_fixed(lb, ub).all(1)
    failed = active & failed

    n_nodes = st.n_nodes + (failed | (active & converged)).to(I32)
    n_fails = st.n_fails + failed.to(I32)
    n_sols = st.n_sols + solved.to(I32)
    n_sweeps = st.n_sweeps + sweeps.to(I32)

    # -- 3. record incumbent ------------------------------------------------
    if obj_var >= 0:
        better = solved & (lb[:, obj_var] < st.best_obj)
        best_obj = torch.where(better, lb[:, obj_var], st.best_obj)
    else:
        better = solved & ~st.has_sol
        best_obj = torch.where(better, big, st.best_obj)
    best_sol = torch.where(better[:, None], lb, st.best_sol)
    has_sol = st.has_sol | solved

    # -- 4. backtrack or branch ---------------------------------------------
    bt = failed | solved
    lvl = torch.arange(md, device=dev)
    open_mask = (~st.dec_flip) & (lvl[None, :] < depth[:, None])
    has_open = open_mask.any(1)
    bt_level = torch.where(open_mask, lvl[None, :], -1).amax(1)
    exhausted = active & bt & ~has_open

    do_bt = active & bt & has_open
    # pop everything deeper than bt_level, flip bt_level to its right branch
    dec_flip = torch.where(
        do_bt[:, None],
        (st.dec_flip & (lvl[None, :] < bt_level[:, None]))
        | (lvl[None, :] == bt_level[:, None]),
        st.dec_flip)
    depth_bt = (bt_level + 1).to(I32)

    # full recomputation for backtracking lanes
    root_dom = pre.root_dom
    if dom is None:
        rlb, rub = apply_path_tile(root_lb, root_ub, st.dec_var,
                                   st.dec_val, dec_flip, depth_bt,
                                   val_strategy=val_strategy,
                                   dom_track=dom_track)
    else:
        rlb, rub, rdom = apply_path_tile(root_lb, root_ub, st.dec_var,
                                         st.dec_val, dec_flip, depth_bt,
                                         val_strategy=val_strategy,
                                         root_dom=root_dom,
                                         dom_off=dom_off,
                                         dom_track=dom_track)

    # branching lanes (only at per-lane fixed points)
    var, m, any_unfixed = select_branch_tile(
        lb, ub, branch_vars, var_strategy=var_strategy,
        val_strategy=val_strategy, dom=dom, dom_off=dom_off,
        dom_track=dom_track)
    do_branch = active & ~bt & converged & any_unfixed
    overflow = do_branch & (depth >= md)
    do_branch = do_branch & ~overflow
    at_lvl = lvl[None, :] == torch.clamp(depth, 0, md - 1)[:, None]
    upd = do_branch[:, None] & at_lvl
    dec_var = torch.where(upd, var.to(I32)[:, None], st.dec_var)
    dec_val = torch.where(upd, m[:, None], st.dec_val)
    dec_flip = torch.where(upd, False, dec_flip)
    vcols = torch.arange(V, device=dev)
    btell = torch.where(do_branch, m, big)                        # [L]
    bub = torch.where(vcols[None, :] == var[:, None],             # left: x ≤ m
                      torch.minimum(ub, btell[:, None]), ub)
    if val_strategy == VAL_MIDDLE_OUT:                            # left: x = m
        trk_var = dom_track[var.long()] != 0
        btell_lo = torch.where(do_branch & trk_var, m, -big)     # wide: x ≤ m
        blb = torch.where(vcols[None, :] == var[:, None],
                          torch.maximum(lb, btell_lo[:, None]), lb)
    else:
        blb = lb

    # -- 5. commit per-lane outcome ------------------------------------------
    new_lb = torch.where(do_bt[:, None], rlb, blb)
    new_ub = torch.where(do_bt[:, None], rub, bub)
    new_depth = torch.where(do_bt, depth_bt,
                            torch.where(do_branch, depth + 1, depth))
    fresh = fresh | exhausted | overflow
    incomplete = st.incomplete | overflow
    new_dom = (None if dom is None
               else torch.where(do_bt[:, None, None], rdom, dom))

    return LaneState(
        lb=new_lb, ub=new_ub, root_lb=root_lb, root_ub=root_ub,
        dec_var=dec_var, dec_val=dec_val, dec_flip=dec_flip,
        depth=new_depth, next_sub=next_sub, fresh=fresh, done=done,
        incomplete=incomplete, best_obj=best_obj, best_sol=best_sol,
        has_sol=has_sol, n_nodes=n_nodes, n_fails=n_fails, n_sols=n_sols,
        n_sweeps=n_sweeps, dom=new_dom, root_dom=root_dom)


def lanes_step(cm: CompiledModel, subs_lb, subs_ub, opts: SearchOptions,
               st: LaneState, gbest, pool_head, *, tile_id: int = 0,
               n_tiles: int = 1):
    """One superstep over all lanes: pool dispatch → tile load → **one**
    lane-batched backend fixpoint over the whole ``[n_lanes, V]`` store
    tensor (one kernel launch under the ``cuda`` backend) → tile commit.
    ``tile_id``/``n_tiles``: the lanes are tile ``tile_id`` of a
    lane-tiled launch and draw from its pool shard
    (`dispatch_pool_tile`).  Returns (state', pool_head')."""
    st, pool_head = dispatch_pool_tile(st, pool_head, subs_lb.shape[0],
                                       tile_id=tile_id, n_tiles=n_tiles)
    dom_track = cm.dom_track.view(torch.int32)
    pre = lane_load_tile(subs_lb, subs_ub, st, gbest, obj_var=cm.obj_var,
                         dom_off=cm.dom_off, dom_track=dom_track,
                         n_words=cm.n_words)
    backend = get_backend(opts.backend)
    if pre.dom is not None:
        lb, ub, dom, sweeps, converged = backend.fixpoint_batch(
            cm, pre.lb, pre.ub, dom=pre.dom,
            max_iters=opts.max_fixpoint_iters)
    else:
        dom = None
        lb, ub, sweeps, converged = backend.fixpoint_batch(
            cm, pre.lb, pre.ub, max_iters=opts.max_fixpoint_iters)
    st = lane_commit_tile(st, pre, lb, ub, sweeps, converged,
                          cm.branch_vars, obj_var=cm.obj_var,
                          var_strategy=opts.var_strategy,
                          val_strategy=opts.val_strategy, dom=dom,
                          dom_off=cm.dom_off, dom_track=dom_track)
    return st, pool_head


def lanes_best(st: LaneState):
    """Cross-lane incumbent (the shared global-memory bound of the
    paper), a 0-d tensor."""
    return st.best_obj.min()


def all_done(st: LaneState) -> torch.Tensor:
    """Whether every lane has drained the pool (a 0-d bool tensor)."""
    return st.done.all()


def lane_totals(st: LaneState) -> dict:
    """Cross-lane counter totals, as host ints."""
    return dict(n_nodes=int(st.n_nodes.sum()),
                n_fails=int(st.n_fails.sum()),
                n_sols=int(st.n_sols.sum()),
                n_sweeps=int(st.n_sweeps.sum()))
