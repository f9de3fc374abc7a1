"""Eventless parallel fixpoint engine — the plain PyTorch version.

Port of ``repro/core/fixpoint.py``.  One *sweep* runs every propagator
once on the old store and joins all their tells into the new one (Jacobi
iteration: the paper's ``D(P₁) ⊔ … ⊔ D(Pₙ)``); sweeps repeat per lane
until nothing changes, the lane fails, or a sweep cap is hit.

The sweep is variable-centric (gather form): each bank computes its
candidate bounds, then every variable reduces over its occurrence list
with min/max and the result is clamped into the initial box.  This
module is the plain version the CUDA kernel
(`repro_torch/kernels/csrc/fixpoint.cu`) is held against: the same
arithmetic, the same neutral sentinels (``±iinfo.max // 4``), the same
floor/ceil divisions, and per-lane sweep counts and convergence flags.

Ported banks: the ReifLinLe bank (`candidates_tile`), the *dense*
AllDifferent bank (`alldiff_candidates_tile`) and the *dense*
Cumulative bank (`cumulative_candidates_tile`) — what RCPSP, N-queens,
graph coloring, knapsack and jobshop lower to at their smoke and bench
tiers.  `sweep_tile` raises ``NotImplementedError`` for the sparse
AllDifferent and Cumulative layouts, Compact-Table and a carried bitset
store, which come with later slices of the port; it never propagates
less than the reference silently.

Integer dtype discipline: every reduction passes ``dtype=`` (torch widens
int32 sums to int64, ``jnp`` does not), so stores stay in the model's
dtype end to end.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.compile import CompiledModel


def _neutrals(dtype: torch.dtype) -> Tuple[int, int]:
    big = torch.iinfo(dtype).max // 4
    return big, -big   # NEU_UB, NEU_LB


def _fdiv(p, q):
    return torch.div(p, q, rounding_mode="floor")


def _cdiv(p, q):
    return -torch.div(-p, q, rounding_mode="floor")


def _take(store, idx):
    """``jnp.take(store, idx, axis=1)`` for a ``[L, V]`` store and an
    index table of any shape: result ``[L, *idx.shape]``."""
    return store.index_select(1, idx.reshape(-1)).reshape(
        (store.shape[0],) + tuple(idx.shape))


def candidates_tile(lb, ub, vidx, coef, rhs, bidx):
    """All tells of one sweep of the ReifLinLe bank for ``[L, V]`` stores.

    Returns (cand_lb, cand_ub), each ``[L, P+1, K+1]``; slot K is the
    reified-boolean (entailment) slot.  Neutral candidates are ±big.
    """
    dt = lb.dtype
    a = coef[None, :, :]                                  # [1, P1, K]
    c = rhs[None, :, None]                                # [1, P1, 1]
    xl = _take(lb, vidx)                                  # [L, P1, K]
    xu = _take(ub, vidx)
    pos, neg = a > 0, a < 0
    tl = torch.where(pos, a * xl, a * xu)     # min of a_k x_k (0 when a==0)
    tu = torch.where(pos, a * xu, a * xl)     # max of a_k x_k
    smin = tl.sum(-1, dtype=dt)                           # [L, P1]
    smax = tu.sum(-1, dtype=dt)

    btrue = (_take(lb, bidx) >= 1)[:, :, None]            # ask b
    bfalse = (_take(ub, bidx) <= 0)[:, :, None]           # ask ¬b

    neu_ub, neu_lb = _neutrals(dt)
    safe_a = torch.where(a == 0, 1, a)

    # direction 1: Σ a x ≤ c (guard: b true)
    slack1 = c - (smin[:, :, None] - tl)
    ub1 = torch.where(pos & btrue, _fdiv(slack1, safe_a), neu_ub)
    lb1 = torch.where(neg & btrue, _cdiv(slack1, safe_a), neu_lb)

    # direction 2: Σ -a x ≤ -c-1 (guard: b false); with a' = -a the
    # positive and negative coefficients swap roles
    na = -a
    safe_na = torch.where(na == 0, 1, na)
    slack2 = (-c - 1) - (-smax[:, :, None] + tu)
    ub2 = torch.where(neg & bfalse, _fdiv(slack2, safe_na), neu_ub)
    lb2 = torch.where(pos & bfalse, _cdiv(slack2, safe_na), neu_lb)

    term_ub = torch.minimum(ub1, ub2)                     # [L, P1, K]
    term_lb = torch.maximum(lb1, lb2)

    # entailment slot (tells on the reified boolean)
    reif_lb = torch.where(smax <= rhs[None, :], 1, neu_lb).to(dt)
    reif_ub = torch.where(smin > rhs[None, :], 0, neu_ub).to(dt)

    cand_ub = torch.cat([term_ub, reif_ub[:, :, None]], dim=2)
    cand_lb = torch.cat([term_lb, reif_lb[:, :, None]], dim=2)
    return cand_lb, cand_ub


def alldiff_candidates_tile(lb, ub, ad_vars, ad_offs, ad_mask):
    """Bounds(Z)-consistency tells for the dense AllDifferent bank.

    Hall-interval reasoning on the shifted views ``y_k = x_k + off_k``:
    for every endpoint pair (i, j) the interval ``I = [yl_i, yu_j]`` is
    tested — more members inside I than its width fails the row (every
    member's lb is pushed to ``-neu_lb``, which the box clamp turns into
    a crossed bound); exactly as many makes I a Hall interval, and every
    other member's bound inside I is pushed out (lb → sup I + 1,
    ub → inf I - 1).  The ``[L, A1, N, N, N]`` tensor is the
    specification the kernel is held to, not its design.  Returns
    (cand_lb, cand_ub), each ``[L, A1, N]``, in unshifted variable space;
    padded members and the dummy row A are neutral.
    """
    dt = lb.dtype
    neu_ub, neu_lb = _neutrals(dt)
    msk = (ad_mask[None] != 0)                              # [1, A1, N]
    off = ad_offs[None]
    yl = _take(lb, ad_vars) + off                           # [L, A1, N]
    yu = _take(ub, ad_vars) + off
    a = yl[:, :, :, None]                    # interval inf from i
    b = yu[:, :, None, :]                    # interval sup from j
    pair_ok = msk[:, :, :, None] & msk[:, :, None, :] & (a <= b)
    inside = (msk[:, :, None, None, :]
              & (yl[:, :, None, None, :] >= a[..., None])
              & (yu[:, :, None, None, :] <= b[..., None]))  # [L,A1,N,N,N]
    cnt = inside.sum(-1, dtype=dt)                          # [L, A1, N, N]
    width = b - a + 1
    overflow = pair_ok & (cnt > width)
    hall = pair_ok & (cnt == width)

    # Hall pruning: member k outside I with a bound inside I is pushed out
    out_k = msk[:, :, None, None, :] & ~inside
    a5, b5 = a[..., None], b[..., None]
    klb, kub = yl[:, :, None, None, :], yu[:, :, None, None, :]
    push = hall[..., None]
    lb_cand = torch.where(push & out_k & (klb >= a5) & (klb <= b5),
                          b5 + 1, neu_lb)                   # [L,A1,N,N,N]
    ub_cand = torch.where(push & out_k & (kub >= a5) & (kub <= b5),
                          a5 - 1, neu_ub)
    cand_lb = lb_cand.amax(dim=(2, 3))                      # [L, A1, N]
    cand_ub = ub_cand.amin(dim=(2, 3))

    # pigeonhole overflow: the row is unsatisfiable — fail every member
    fail = overflow.any(3).any(2)                           # [L, A1]
    cand_lb = torch.where(fail[:, :, None] & msk, -neu_lb, cand_lb)
    # back to unshifted variable space (neutrals stay effectively neutral)
    return cand_lb - off, cand_ub - off


def cumulative_candidates_tile(lb, ub, cu_svar, cu_dur, cu_dem, cu_cap,
                               horizon: int):
    """Time-table tells for the dense Cumulative bank.

    Compulsory-part reasoning on the time grid ``[0, horizon)``: the
    profile sums the demands of compulsory parts ``[lst, est + d)``; a
    row whose profile exceeds its capacity fails every effective task;
    otherwise each task moves to its first (last) start whose run
    ``[s, min(s + d, horizon))`` avoids every time point where the
    profile without the task plus its demand exceeds the capacity.  No
    feasible start yields ``-neu_lb`` (resp. ``-neu_ub``), which the box
    clamp turns into a crossed bound.  Returns (cand_lb, cand_ub), each
    ``[L, C+1, T]``.
    """
    dt = lb.dtype
    L = lb.shape[0]
    C1, T = cu_svar.shape
    neu_ub, neu_lb = _neutrals(dt)
    est = _take(lb, cu_svar)                                # [L, C1, T]
    lst = _take(ub, cu_svar)
    d = cu_dur[None]
    q = cu_dem[None]
    act = (d > 0) & (q > 0)
    cap = cu_cap[None, :, None]                             # [1, C1, 1]
    tgrid = torch.arange(horizon, dtype=dt, device=lb.device)   # [H]
    run = (act[..., None] & (lst[..., None] <= tgrid)
           & (tgrid < (est + d)[..., None]))                # [L, C1, T, H]
    contrib = torch.where(run, q[..., None], 0)
    profile = contrib.sum(2, dtype=dt)                      # [L, C1, H]
    overload = (profile > cap).any(-1)                      # [L, C1]

    # per-task residual profile and forbidden time points
    bad = (act[..., None]
           & (profile[:, :, None, :] - contrib + q[..., None] > cap[..., None]))
    csum = torch.cumsum(bad, -1, dtype=dt)
    csum = torch.cat([torch.zeros_like(csum[..., :1]), csum], -1)
    ends = torch.clamp(tgrid[None, None, None, :] + d[..., None], 0, horizon)
    wbad = (torch.gather(csum, -1, ends.long().expand(L, C1, T, horizon))
            - csum[..., :-1])                               # [L, C1, T, H]
    feas = wbad == 0                                        # start grid feas.

    cand_lb = torch.where(feas & (tgrid >= est[..., None]), tgrid,
                          -neu_lb).amin(-1)                 # first feasible
    cand_ub = torch.where(feas & (tgrid <= lst[..., None]), tgrid,
                          -neu_ub).amax(-1)                 # last feasible
    cand_lb = torch.where(act, cand_lb, neu_lb)
    cand_ub = torch.where(act, cand_ub, neu_ub)
    # overload: fail every effective task of the row
    cand_lb = torch.where(overload[:, :, None] & act, -neu_lb, cand_lb)
    return cand_lb, cand_ub


def _gather_join(cand_lb, cand_ub, occ_inst, occ_pos, L):
    """Variable-centric join of one bank's candidates: each var reduces
    over its occurrence list (pure gather — no scatter, no atomics)."""
    width = cand_ub.shape[2]
    occ = (occ_inst * width + occ_pos).reshape(-1)          # [V*D]
    V, D = occ_inst.shape
    g_ub = cand_ub.reshape(L, -1).index_select(1, occ).reshape(
        L, V, D).amin(-1)
    g_lb = cand_lb.reshape(L, -1).index_select(1, occ).reshape(
        L, V, D).amax(-1)
    return g_lb, g_ub


def check_supported(*, n_alldiff: int = 0, ad_layout: str = "dense",
                    n_cumulative: int = 0, cu_layout: str = "dense",
                    n_table: int = 0, dom=None, **_statics) -> None:
    """Raise for the banks this slice of the port does not propagate yet
    (rather than propagating less than the reference)."""
    if n_alldiff and ad_layout != "dense":
        raise NotImplementedError(
            "the sparse AllDifferent tile is not ported yet (kernel "
            "sub-item 1d, ROADMAP queue 2)")
    if n_cumulative and cu_layout != "dense":
        raise NotImplementedError(
            "the sparse Cumulative tile is not ported yet (kernel sub-item "
            "1e, ROADMAP queue 2)")
    if n_table:
        raise NotImplementedError(
            "Compact-Table banks are not ported yet (kernel sub-item 1f, "
            "ROADMAP queue 2)")
    if dom is not None:
        raise NotImplementedError(
            "the bitset domain store comes with the Compact-Table slice "
            "(kernel sub-item 1f, ROADMAP queue 2)")


def sweep_tile(lb, ub, vidx, coef, rhs, bidx, occ_prop, occ_slot,
               ad_vars, ad_offs, ad_mask, ad_occ_inst, ad_occ_pos,
               ad_ptr, ad_pk_var, ad_pk_off, ad_pk_seg,
               cu_svar, cu_dur, cu_dem, cu_cap, cu_occ_inst, cu_occ_pos,
               cu_ptr, cu_pk_svar, cu_pk_dur, cu_pk_dem, cu_pk_seg,
               ct_vars, ct_mask, ct_supp, ct_occ_inst, ct_occ_pos,
               dom_off, dom_track,
               box_lo, box_hi, *, horizon: int, n_alldiff: int = 0,
               n_cumulative: int = 0, ad_layout: str = "dense",
               cu_layout: str = "dense", n_table: int = 0,
               n_words: int = 1, dom=None):
    """One eventless sweep over a ``[L, V]`` tile of stores (gather form).

    Same positional signature as the reference (`model_tables` order),
    so the two stay easy to read side by side.  Returns (lb', ub').
    """
    check_supported(n_alldiff=n_alldiff, ad_layout=ad_layout,
                    n_cumulative=n_cumulative, cu_layout=cu_layout,
                    n_table=n_table, dom=dom)
    L = lb.shape[0]
    cand_lb, cand_ub = candidates_tile(lb, ub, vidx, coef, rhs, bidx)
    # fold the reif-entailment slot in: occ_slot ∈ [0, K] indexes [K+1]
    g_lb, g_ub = _gather_join(cand_lb, cand_ub, occ_prop, occ_slot, L)
    if n_alldiff:
        ad_lb, ad_ub = alldiff_candidates_tile(lb, ub, ad_vars, ad_offs,
                                               ad_mask)
        j_lb, j_ub = _gather_join(ad_lb, ad_ub, ad_occ_inst, ad_occ_pos, L)
        g_lb = torch.maximum(g_lb, j_lb)
        g_ub = torch.minimum(g_ub, j_ub)
    if n_cumulative:
        cu_lb, cu_ub = cumulative_candidates_tile(
            lb, ub, cu_svar, cu_dur, cu_dem, cu_cap, horizon)
        j_lb, j_ub = _gather_join(cu_lb, cu_ub, cu_occ_inst, cu_occ_pos, L)
        g_lb = torch.maximum(g_lb, j_lb)
        g_ub = torch.minimum(g_ub, j_ub)
    # clamp candidates into the initial box (overflow guard; sound because
    # box_lo-1/box_hi+1 still cross the opposite bound on failure)
    g_ub = torch.maximum(g_ub, box_lo[None, :])
    g_lb = torch.minimum(g_lb, box_hi[None, :])
    return torch.maximum(lb, g_lb), torch.minimum(ub, g_ub)


def model_tables(cm: CompiledModel) -> Tuple:
    """The positional table args of `sweep_tile`, in order."""
    return (cm.vidx, cm.coef, cm.rhs, cm.bidx, cm.occ_prop, cm.occ_slot,
            cm.ad_vars, cm.ad_offs, cm.ad_mask, cm.ad_occ_inst,
            cm.ad_occ_pos, cm.ad_ptr, cm.ad_pk_var, cm.ad_pk_off,
            cm.ad_pk_seg, cm.cu_svar, cm.cu_dur, cm.cu_dem, cm.cu_cap,
            cm.cu_occ_inst, cm.cu_occ_pos, cm.cu_ptr, cm.cu_pk_svar,
            cm.cu_pk_dur, cm.cu_pk_dem, cm.cu_pk_seg,
            cm.ct_vars, cm.ct_mask, cm.ct_supp, cm.ct_occ_inst,
            cm.ct_occ_pos, cm.dom_off, cm.dom_track,
            cm.box_lo, cm.box_hi)


def model_statics(cm: CompiledModel) -> dict:
    """The static (kind/layout-dispatch) kwargs of `sweep_tile`."""
    return dict(horizon=cm.horizon, n_alldiff=cm.n_alldiff,
                n_cumulative=cm.n_cumulative,
                ad_layout=cm.ad_layout, cu_layout=cm.cu_layout,
                n_table=cm.n_table, n_words=cm.n_words)


def fixpoint_tile(lb, ub, *tables, horizon: int, n_alldiff: int = 0,
                  n_cumulative: int = 0, ad_layout: str = "dense",
                  cu_layout: str = "dense", n_table: int = 0,
                  n_words: int = 1, dom=None,
                  max_iters: Optional[int] = None,
                  stop_on_fail: bool = True):
    """Per-lane-masked fixpoint loop over a ``[L, V]`` tile.

    A lane takes part in a sweep iff its own condition (changed ∧
    it < max_iters ∧ ¬failed) holds.  Lanes are independent, so each
    sweep runs only on the lanes still live (the result equals the
    reference's masked sweep over all lanes, by idempotence of ⊔).
    Returns (lb', ub', sweeps i32[L], converged bool[L]).
    """
    statics = dict(horizon=horizon, n_alldiff=n_alldiff,
                   n_cumulative=n_cumulative, ad_layout=ad_layout,
                   cu_layout=cu_layout, n_table=n_table, n_words=n_words)
    check_supported(**statics, dom=dom)
    L = lb.shape[0]
    dev = lb.device
    changed = torch.ones(L, dtype=torch.bool, device=dev)
    it = torch.zeros(L, dtype=torch.int32, device=dev)
    lb, ub = lb.clone(), ub.clone()
    while True:
        live = changed.clone()
        if max_iters is not None:
            live &= it < max_iters
        if stop_on_fail:
            live &= ~(lb > ub).any(1)
        idx = live.nonzero().squeeze(1)
        if idx.numel() == 0:
            break
        olb, oub = lb[idx], ub[idx]
        nlb, nub = sweep_tile(olb, oub, *tables, **statics)
        changed[idx] = ((nlb != olb) | (nub != oub)).any(1)
        lb[idx], ub[idx] = nlb, nub
        it[idx] += 1
    converged = ~changed | (lb > ub).any(1)
    return lb, ub, it, converged


def fixpoint(cm: CompiledModel, lb, ub, max_iters: Optional[int] = None,
             stop_on_fail: bool = True):
    """One store to its least fixed point: (lb', ub', n_sweeps,
    converged), the single-lane view of `fixpoint_batch`."""
    nlb, nub, it, conv = fixpoint_batch(cm, lb[None], ub[None],
                                        max_iters=max_iters,
                                        stop_on_fail=stop_on_fail)
    return nlb[0], nub[0], it[0], conv[0]


def fixpoint_batch(cm: CompiledModel, lb, ub, dom=None,
                   max_iters: Optional[int] = None,
                   stop_on_fail: bool = True):
    """Lane-batched fixpoint over the whole ``[L, V]`` store tensor.

    Returns (lb', ub', sweeps[L], converged[L]).
    """
    return fixpoint_tile(lb, ub, *model_tables(cm), **model_statics(cm),
                         dom=dom, max_iters=max_iters,
                         stop_on_fail=stop_on_fail)
