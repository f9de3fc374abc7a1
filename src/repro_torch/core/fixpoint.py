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

Ported banks: the ReifLinLe bank (`candidates_tile`), the AllDifferent
bank in both layouts (`alldiff_candidates_tile`, dense;
`alldiff_candidates_sparse_tile`, packed), the Cumulative bank in both
layouts (`cumulative_candidates_tile`,
`cumulative_candidates_sparse_tile`) and the Compact-Table bank over the
bitset domain store (`ct_candidates_tile`, `_gather_join_dom`,
`dom_normalize_tile`): every bank the reference has.  A carried bitset
store (``dom``, ``[L, V, W]`` int32 bit patterns, see `bitset`) rides
through `sweep_tile`/`fixpoint_tile`/`fixpoint_batch` as in the
reference.

The semantics layer sits on the same kind tiles: the single-store
`sweep`, the propagator-centric scatter form (`sweep_scatter`,
`sweep_scatter_batch`: each propagator joins its variables through a
scatter-min/max, the paper's atomic-join reading, selected with
``use_scatter`` on `fixpoint`/`fixpoint_batch` and by the ``scatter``
backend), and the sequential chaotic iteration (`apply_one`,
`sequential_fixpoint`) of the paper's Prop. 3 and Thm. 6.  Gather and
scatter sweeps are bit-identical per sweep, not only at the fixpoint.

Integer dtype discipline: every reduction passes ``dtype=`` (torch widens
int32 sums to int64, ``jnp`` does not), so stores stay in the model's
dtype end to end.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import torch

from repro_torch.core import bitset as B
from repro_torch.core import lattice as LT
from repro_torch.core.compile import CompiledModel
from repro_torch.core.model import TRUE_VAR


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


# elements of one ``[L, M, M]`` tensor of the sparse AllDifferent tile;
# more lanes than fit are worked through in chunks (no result changes)
_AD_CHUNK_ELEMS = 1 << 25


def _lexsort(keys):
    """``jnp.lexsort(keys, axis=-1)`` for ``[L, n]`` keys (the last key is
    the primary one): chained stable sorts, least significant key first.
    Returns the permutation ``[L, n]`` (int64)."""
    perm = None
    for k in keys:
        kk = k if perm is None else torch.gather(k, 1, perm)
        order = torch.sort(kk, dim=1, stable=True).indices
        perm = order if perm is None else torch.gather(perm, 1, order)
    return perm


def alldiff_candidates_sparse_tile(lb, ub, ad_pk_var, ad_pk_off, ad_pk_seg,
                                   n_alldiff: int):
    """Segmented (packed/CSR) Hall-interval pass, the scale variant of
    `alldiff_candidates_tile`.

    Members of all rows live on one packed axis of length M with a
    segment id each (padding slots carry seg == n_alldiff and stay
    inert).  They are sorted by (segment, shifted lb); the count of
    members inside ``[a_i, b_j]`` is then a suffix count read at the
    first sorted position of i's key (tie-invariant, so the order among
    equal keys cannot change a result).  Hall intervals fold to the
    tightest inf per sup endpoint and the widest sup per inf endpoint
    before the push.  Builds ``[L, M, M]`` tensors, a chunk of lanes at a
    time.  Returns (cand_lb, cand_ub), each ``[L, M]`` over the packed
    axis in unshifted variable space.
    """
    L, M = lb.shape[0], ad_pk_var.shape[0]
    step = max(1, _AD_CHUNK_ELEMS // (M * M))
    if L > step:
        parts = [alldiff_candidates_sparse_tile(
            lb[i:i + step], ub[i:i + step], ad_pk_var, ad_pk_off, ad_pk_seg,
            n_alldiff) for i in range(0, L, step)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))
    dt = lb.dtype
    neu_ub, neu_lb = _neutrals(dt)
    off = ad_pk_off[None]                                   # [1, M]
    yl = _take(lb, ad_pk_var) + off                         # [L, M]
    yu = _take(ub, ad_pk_var) + off
    segb = ad_pk_seg[None].expand(L, M)

    perm = _lexsort((yl, segb))                             # seg, then yl
    inv = torch.argsort(perm, dim=1)
    syl = torch.gather(yl, 1, perm)
    syu = torch.gather(yu, 1, perm)
    sseg = torch.gather(segb, 1, perm)
    sact = sseg < n_alldiff

    same = sseg[:, :, None] == sseg[:, None, :]             # [L, M, M]
    a_i = syl[:, :, None]               # interval inf from i (axis 1)
    b_j = syu[:, None, :]               # interval sup from j (axis 2)

    # suffix count: S[p, j] = |{x >= p : seg_x = seg_j and yu_x <= yu_j}|
    T = (same & (syu[:, :, None] <= syu[:, None, :])).to(dt)
    S = T.flip(1).cumsum(1, dtype=dt).flip(1)
    # first sorted position of i's key = |{p : (seg_p, yl_p) < (seg_i, yl_i)}|
    lt = ((sseg[:, None, :] < sseg[:, :, None])
          | (same & (syl[:, None, :] < syl[:, :, None])))   # [L, i, p]
    fp = lt.sum(2)                                          # [L, M]
    cnt = torch.gather(S, 1, fp[:, :, None].expand(L, M, M))   # [L, i, j]

    pair_ok = same & sact[:, :, None] & sact[:, None, :] & (a_i <= b_j)
    width = b_j - a_i + 1
    overflow = pair_ok & (cnt > width)
    hall = pair_ok & (cnt == width)

    # extremal Hall data: tightest inf per sup endpoint j, widest sup per
    # inf endpoint i
    min_inf = torch.where(hall, a_i, neu_ub).amin(1)        # [L, M] per j
    max_sup = torch.where(hall, b_j, neu_lb).amax(2)        # [L, M] per i

    # lb push for member k: a Hall [a_i, b_j] with a_i <= yl_k <= b_j < yu_k
    yl_k, yu_k = syl[:, :, None], syu[:, :, None]           # k on axis 1
    s_lb = torch.where(same & sact[:, :, None]
                       & (min_inf[:, None, :] <= yl_k)
                       & (yl_k <= b_j) & (b_j < yu_k),
                       b_j + 1, neu_lb).amax(2)             # [L, M]
    # ub push, mirrored: yl_k < a_i <= yu_k <= max_sup_i
    a_i2 = syl[:, None, :]                                  # i on axis 2
    s_ub = torch.where(same & sact[:, :, None]
                       & (yl_k < a_i2) & (a_i2 <= yu_k)
                       & (yu_k <= max_sup[:, None, :]),
                       a_i2 - 1, neu_ub).amin(2)

    # pigeonhole overflow fails every member of the affected row
    rowfail = overflow.any(2)                               # [L, M] per i
    failk = (same & rowfail[:, None, :]).any(2)             # [L, M] per k
    s_lb = torch.where(failk & sact, -neu_lb, s_lb)

    # unsort to packed order, then back to unshifted variable space
    return torch.gather(s_lb, 1, inv) - off, torch.gather(s_ub, 1, inv) - off


def cumulative_candidates_sparse_tile(lb, ub, cu_pk_svar, cu_pk_dur,
                                      cu_pk_dem, cu_pk_seg, cu_cap,
                                      n_cumulative: int):
    """Event-based time-table pass, the scale variant of
    `cumulative_candidates_tile`; never builds the ``[.., T, horizon]``
    grid.

    Each packed task emits two events (+q at lst, -q at ect, delta 0
    without a compulsory part); sorted by (segment, time, kind) with
    ends before starts, their prefix sum is each segment's
    piecewise-constant profile (each segment's deltas sum to 0).  An
    event owns ``[u, v)`` up to the next event of its segment; empty
    intervals are disabled.  Overload and each task's forbidden
    intervals are tested per interval; the first and last feasible start
    come from a forward and a backward monotone-jump scan.  The
    reference scans all 2M events with a same-segment mask; here each
    task scans only its own segment's events, which the seg-major sort
    keeps contiguous at ``[2·start, 2·end)`` of the segment's packed
    slots, with the same result.  Returns (cand_lb, cand_ub), each
    ``[L, M]`` over the packed axis.
    """
    dt = lb.dtype
    neu_ub, neu_lb = _neutrals(dt)
    dev = lb.device
    L, M = lb.shape[0], cu_pk_svar.shape[0]
    seg = cu_pk_seg
    d = cu_pk_dur[None]                                     # [1, M]
    q = cu_pk_dem[None]
    act = (seg < n_cumulative)[None] & (d > 0) & (q > 0)
    cap = cu_cap.index_select(0, seg)[None]                 # [1, M] per task
    est = _take(lb, cu_pk_svar)                             # [L, M]
    lst = _take(ub, cu_pk_svar)
    ect = est + d
    has_cp = act & (lst < ect)                              # compulsory part

    times = torch.cat([lst, ect], 1)                        # [L, 2M]
    delta = torch.cat([torch.where(has_cp, q, 0),
                       torch.where(has_cp, -q, 0)], 1)
    esegb = torch.cat([seg, seg])[None].expand(L, 2 * M)
    # ends sort before starts at equal times: transient profiles are then
    # confined to empty [t, t) intervals, which the u < v guard disables
    kindb = torch.cat([torch.ones(M, dtype=dt, device=dev),
                       torch.zeros(M, dtype=dt, device=dev)]
                      )[None].expand(L, 2 * M)
    perm = _lexsort((kindb, times, esegb))                  # seg, time, kind
    stime = torch.gather(times, 1, perm)
    sdelta = torch.gather(delta, 1, perm)
    sseg = torch.gather(esegb, 1, perm)
    prof = sdelta.cumsum(1, dtype=dt)                       # [L, 2M]

    # event e owns [u, v) up to the next event while it stays in-segment;
    # the last event of a segment owns an empty (disabled) interval
    nxt_t = torch.cat([stime[:, 1:], stime[:, -1:]], 1)
    nxt_s = torch.cat([sseg[:, 1:], torch.full_like(sseg[:, -1:], -1)], 1)
    u_t = stime
    v_t = torch.where(nxt_s == sseg, nxt_t, stime)
    over_e = (u_t < v_t) & (prof > cu_cap[sseg.long()])     # [L, 2M]
    # per-task overload: any overloaded interval in my segment
    seg_ovl = torch.zeros((L, n_cumulative + 1), dtype=torch.int32,
                          device=dev).scatter_reduce(
        1, sseg.long(), over_e.to(torch.int32), "amax")
    ovl = torch.index_select(seg_ovl, 1, seg) != 0          # [L, M]

    # each task's segment: sorted events [2·start, 2·(start + n))
    segl = seg.long()
    counts = torch.bincount(segl, minlength=n_cumulative + 1)
    e0 = (2 * (torch.cumsum(counts, 0) - counts))[segl]     # [M]
    ne = 2 * counts[segl]
    n_scan = 2 * int(counts.max())

    # forbidden-window scans: task t cannot run through interval [u, v)
    # if profile-without-t + q_t > cap there (t's own compulsory part is
    # tested at u only: its endpoints are events, so coverage is constant
    # on [u, v))
    def hit_at(t, s):
        e = (e0 + t).clamp(max=2 * M - 1)
        u, v, p = u_t[:, e], v_t[:, e], prof[:, e]          # [L, M]
        cov = has_cp & (u >= lst) & (u < ect)
        bad = act & (u < v) & (p + torch.where(cov, 0, q) > cap)
        return (t < ne) & bad & (s < v) & (s + d > u), u, v

    s_est = est                                    # first feasible >= est
    for t in range(n_scan):
        hit, u, v = hit_at(t, s_est)
        s_est = torch.where(hit, v, s_est)
    s_lst = lst                                    # last feasible <= lst
    for t in reversed(range(n_scan)):
        hit, u, v = hit_at(t, s_lst)
        s_lst = torch.where(hit, u - d, s_lst)

    cand_lb = s_est
    # no feasible start >= 0: the dense tile's max over an empty set
    cand_ub = torch.where(s_lst >= 0, s_lst, -neu_ub)
    # a lone task over capacity: every start is forbidden (the dense tile
    # marks the whole grid bad; events only cover [first, last))
    qbig = act & (q > cap)
    cand_lb = torch.where(qbig, -neu_lb, cand_lb)
    cand_ub = torch.where(qbig, -neu_ub, cand_ub)
    cand_lb = torch.where(act, cand_lb, neu_lb)
    cand_ub = torch.where(act, cand_ub, neu_ub)
    # overload: fail every effective task of the row
    cand_lb = torch.where(ovl & act, -neu_lb, cand_lb)
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


def _gather_join_flat(cand_lb, cand_ub, occ, L):
    """`_gather_join` for packed-axis candidates: `occ` ``[V, D]`` holds
    flat indices into the ``[L, M]`` candidates (``ptr[occ_inst] +
    occ_pos``: the CSR rows are contiguous)."""
    V, D = occ.shape
    idx = occ.reshape(-1)
    g_ub = cand_ub.index_select(1, idx).reshape(L, V, D).amin(-1)
    g_lb = cand_lb.index_select(1, idx).reshape(L, V, D).amax(-1)
    return g_lb, g_ub


# elements of the ``[L, T1, R, 32W, TW]`` support tensor of the
# Compact-Table tile; more lanes than fit are worked through in chunks
_CT_CHUNK_ELEMS = 1 << 24


def ct_candidates_tile(lb, ub, dom, ct_vars, ct_mask, ct_supp, dom_off,
                       n_table: int):
    """Compact-Table tells for the extensional bank (the reset variant,
    stateless per sweep), over ``[L, V]`` bounds and their ``[L, V, W]``
    bitset domain:

      1. each member's remaining value bits, from `dom`;
      2. per member, the OR of the supports of its remaining values (the
         masked supports never share a bit, each tuple having ONE value
         per position, so the integer sum is the OR);
      3. the AND of the members' words is the current table; an all-zero
         current table fails the row (every member's lb is pushed past
         its box);
      4. a value survives iff its support meets the current table: the
         surviving bits give each member a domain word mask and a
         [min, max] hull candidate.

    `ct_supp` is the ``[T1, R, 32W, TW]`` support table as int32 bit
    patterns.  Returns (cand_lb, cand_ub, cand_dom), ``[L, T1, R]`` ×2
    and ``[L, T1, R, W]``; padded member slots and the dummy row are
    neutral (±big bounds, all-ones words).  Works through the lanes in
    chunks of at most ``_CT_CHUNK_ELEMS`` support elements.
    """
    L = lb.shape[0]
    T1, R, K32, TW = ct_supp.shape
    step = max(1, _CT_CHUNK_ELEMS // (T1 * R * K32 * TW))
    if L > step:
        parts = [ct_candidates_tile(lb[i:i + step], ub[i:i + step],
                                    dom[i:i + step], ct_vars, ct_mask,
                                    ct_supp, dom_off, n_table)
                 for i in range(0, L, step)]
        return tuple(torch.cat([p[k] for p in parts]) for k in range(3))
    dt = lb.dtype
    neu_ub, neu_lb = _neutrals(dt)
    W = K32 // B.WORD_BITS
    dev = lb.device
    # 1. member value bits, unpacked to the [K32] value axis
    mdom = dom.index_select(1, ct_vars.reshape(-1)).reshape(L, T1, R, W)
    shifts = torch.arange(B.WORD_BITS, dtype=torch.int64, device=dev)
    vb = ((B.unsigned(mdom)[..., None] >> shifts) & 1).reshape(L, T1, R, K32)
    # 2. OR of the supports of the remaining values == SUM (disjoint)
    mor = torch.where(vb[..., None] != 0, ct_supp[None], 0).sum(
        3, dtype=torch.int32)                               # [L,T1,R,TW]
    # 3. current table = AND over the real members (padding all-ones)
    real = ct_mask[None] != 0                               # [1,T1,R]
    mor = torch.where(real[..., None], mor, B.FULL_I32)
    curr = mor[:, :, 0, :]
    for r in range(1, R):                       # R is static and small
        curr = curr & mor[:, :, r, :]
    fail = (curr == 0).all(-1)                              # [L,T1]
    # 4. surviving values = supports meeting the current table
    surv = ((ct_supp[None] & curr[:, :, None, None, :]) != 0).any(-1)
    ks = torch.arange(K32, dtype=dt, device=dev)
    kmin = torch.where(surv, ks, neu_ub).amin(-1)           # [L,T1,R]
    kmax = torch.where(surv, ks, neu_lb).amax(-1)
    omem = dom_off.index_select(0, ct_vars.reshape(-1)).reshape(T1, R)
    cand_lb = torch.where(real, omem[None] + kmin, neu_lb)
    cand_ub = torch.where(real, omem[None] + kmax, neu_ub)
    # row failure: push every real member past its box (the box clamp
    # turns -neu_lb into box_hi, which crosses ub)
    cand_lb = torch.where(fail[:, :, None] & real, -neu_lb, cand_lb)
    # pack the surviving bits back into domain words
    weights = torch.ones(B.WORD_BITS, dtype=torch.int64, device=dev) << shifts
    packed = (surv.reshape(L, T1, R, W, B.WORD_BITS).long() * weights).sum(-1)
    cand_dom = torch.where(real[..., None], B.from_unsigned(packed), B.FULL_I32)
    return cand_lb, cand_ub, cand_dom


def _gather_join_dom(cand_dom, occ_inst, occ_pos, dom):
    """Variable-centric join of the CT bank's domain-word candidates:
    each var ANDs the masks of its occurrences into its words (the
    bitset-lattice ⊔)."""
    L, _, R, W = cand_dom.shape
    V, D = occ_inst.shape
    occ = (occ_inst * R + occ_pos).reshape(-1)
    g = cand_dom.reshape(L, -1, W).index_select(1, occ).reshape(L, V, D, W)
    for d in range(D):                          # D is static and small
        dom = B.join(dom, g[:, :, d])
    return dom


def dom_normalize_tile(lb, ub, dom, dom_off, dom_track, box_lo, box_hi,
                       n_words: int):
    """Re-sync the two lattices after a sweep's joins: the bitset loses
    the values outside [lb, ub], and the bounds tighten to the bitset's
    hull.  Untracked vars (dom_track == 0) pass through on both sides.
    An empty tracked domain reads back as the crossed hull (off + 32W,
    off - 1), which the box clamp keeps crossed: bitset wipeout is
    bounds failure."""
    trk = (dom_track != 0)[None, :]
    rng = B.from_bounds(lb, ub, dom_off, n_words)
    dom = torch.where(trk[..., None], B.join(dom, rng), dom)
    lo, hi = B.to_bounds(dom, dom_off)
    nlb, nub = LT.iz_join(lb, ub, torch.minimum(lo, box_hi[None, :]),
                          torch.maximum(hi, box_lo[None, :]))
    nlb = torch.where(trk, nlb, lb)
    nub = torch.where(trk, nub, ub)
    return nlb, nub, dom


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
    so the two stay easy to read side by side.  With `dom` (the carried
    ``[L, V, W]`` bitset store) the Compact-Table tile filters it, the
    sweep ends with `dom_normalize_tile` and (lb', ub', dom') comes back;
    without it a table model's CT tile reads the transient range domain
    of the current bounds (untracked vars all-ones) and (lb', ub') comes
    back.
    """
    L = lb.shape[0]
    cand_lb, cand_ub = candidates_tile(lb, ub, vidx, coef, rhs, bidx)
    # fold the reif-entailment slot in: occ_slot ∈ [0, K] indexes [K+1]
    g_lb, g_ub = _gather_join(cand_lb, cand_ub, occ_prop, occ_slot, L)
    if n_alldiff:
        if ad_layout == "sparse":
            ad_lb, ad_ub = alldiff_candidates_sparse_tile(
                lb, ub, ad_pk_var, ad_pk_off, ad_pk_seg, n_alldiff)
            occ = ad_ptr[ad_occ_inst.long()] + ad_occ_pos   # flat [V, Dad]
            j_lb, j_ub = _gather_join_flat(ad_lb, ad_ub, occ, L)
        else:
            ad_lb, ad_ub = alldiff_candidates_tile(lb, ub, ad_vars, ad_offs,
                                                   ad_mask)
            j_lb, j_ub = _gather_join(ad_lb, ad_ub, ad_occ_inst, ad_occ_pos,
                                      L)
        g_lb, g_ub = LT.iz_join(g_lb, g_ub, j_lb, j_ub)
    if n_cumulative:
        if cu_layout == "sparse":
            cu_lb, cu_ub = cumulative_candidates_sparse_tile(
                lb, ub, cu_pk_svar, cu_pk_dur, cu_pk_dem, cu_pk_seg,
                cu_cap, n_cumulative)
            occ = cu_ptr[cu_occ_inst.long()] + cu_occ_pos   # flat [V, Dcu]
            j_lb, j_ub = _gather_join_flat(cu_lb, cu_ub, occ, L)
        else:
            cu_lb, cu_ub = cumulative_candidates_tile(
                lb, ub, cu_svar, cu_dur, cu_dem, cu_cap, horizon)
            j_lb, j_ub = _gather_join(cu_lb, cu_ub, cu_occ_inst, cu_occ_pos,
                                      L)
        g_lb, g_ub = LT.iz_join(g_lb, g_ub, j_lb, j_ub)
    if n_table:
        d_in = dom if dom is not None else B.from_bounds(
            lb, ub, dom_off, n_words, track=dom_track)
        ct_lb, ct_ub, ct_dm = ct_candidates_tile(
            lb, ub, d_in, ct_vars, ct_mask, ct_supp, dom_off, n_table)
        j_lb, j_ub = _gather_join(ct_lb, ct_ub, ct_occ_inst, ct_occ_pos, L)
        g_lb, g_ub = LT.iz_join(g_lb, g_ub, j_lb, j_ub)
        if dom is not None:
            dom = _gather_join_dom(ct_dm, ct_occ_inst, ct_occ_pos, dom)
    # clamp candidates into the initial box (overflow guard; sound because
    # box_lo-1/box_hi+1 still cross the opposite bound on failure)
    g_ub = torch.maximum(g_ub, box_lo[None, :])
    g_lb = torch.minimum(g_lb, box_hi[None, :])
    nlb, nub = LT.iz_join(lb, ub, g_lb, g_ub)
    if dom is None:
        return nlb, nub
    return dom_normalize_tile(nlb, nub, dom, dom_off, dom_track,
                              box_lo, box_hi, n_words)


def model_tables(cm: CompiledModel) -> Tuple:
    """The positional table args of `sweep_tile`, in order; the two
    ``uint32`` tables (`ct_supp`, `dom_track`) as their int32 views."""
    return (cm.vidx, cm.coef, cm.rhs, cm.bidx, cm.occ_prop, cm.occ_slot,
            cm.ad_vars, cm.ad_offs, cm.ad_mask, cm.ad_occ_inst,
            cm.ad_occ_pos, cm.ad_ptr, cm.ad_pk_var, cm.ad_pk_off,
            cm.ad_pk_seg, cm.cu_svar, cm.cu_dur, cm.cu_dem, cm.cu_cap,
            cm.cu_occ_inst, cm.cu_occ_pos, cm.cu_ptr, cm.cu_pk_svar,
            cm.cu_pk_dur, cm.cu_pk_dem, cm.cu_pk_seg,
            cm.ct_vars, cm.ct_mask, cm.ct_supp.view(torch.int32),
            cm.ct_occ_inst, cm.ct_occ_pos, cm.dom_off,
            cm.dom_track.view(torch.int32), cm.box_lo, cm.box_hi)


def model_statics(cm: CompiledModel) -> dict:
    """The static (kind/layout-dispatch) kwargs of `sweep_tile`."""
    return dict(horizon=cm.horizon, n_alldiff=cm.n_alldiff,
                n_cumulative=cm.n_cumulative,
                ad_layout=cm.ad_layout, cu_layout=cm.cu_layout,
                n_table=cm.n_table, n_words=cm.n_words)


def propagator_candidates(cm: CompiledModel, lb, ub):
    """Single-store view of `candidates_tile` (each ``[P+1, K+1]``): the
    entry point of the linear scatter form and the sequential SELECT
    semantics, which are defined on the ReifLinLe bank."""
    cand_lb, cand_ub = candidates_tile(lb[None], ub[None], cm.vidx, cm.coef,
                                       cm.rhs, cm.bidx)
    return cand_lb[0], cand_ub[0]


def sweep(cm: CompiledModel, lb, ub):
    """One parallel iteration D(P₁) ⊔ … ⊔ D(Pₙ) applied to one store."""
    nlb, nub = sweep_tile(lb[None], ub[None], *model_tables(cm),
                          **model_statics(cm))
    return nlb[0], nub[0]


def sweep_batch(cm: CompiledModel, lb, ub, dom=None):
    """Gather sweep over lane-batched ``[L, V]`` stores; pass `dom` to
    carry the bitset store (3-tuple return)."""
    return sweep_tile(lb, ub, *model_tables(cm), **model_statics(cm),
                      dom=dom)


def _scatter_join(lb, ub, cand_lb, cand_ub, v, box_lo, box_hi):
    """Propagator-centric join of one bank's candidates ``[L, *v.shape]``
    into ``[L, V]`` stores: each candidate, clamped into its variable's
    box, is scatter-maxed (lb) or scatter-minned (ub) onto variable
    ``v``.  Integer min/max is associative, so duplicate targets reduce
    to the same value in any order."""
    L = lb.shape[0]
    v = v.reshape(-1).long()
    idx = v.expand(L, -1)
    c_lb = torch.minimum(cand_lb.reshape(L, -1), box_hi[v])
    c_ub = torch.maximum(cand_ub.reshape(L, -1), box_lo[v])
    return (lb.scatter_reduce(1, idx, c_lb, "amax", include_self=True),
            ub.scatter_reduce(1, idx, c_ub, "amin", include_self=True))


def sweep_scatter_batch(cm: CompiledModel, lb, ub, dom=None):
    """Propagator-centric scatter form of the sweep over ``[L, V]``
    stores: each propagator writes its variables through a join (the
    paper's load/store formulation with atomic joins), here one
    `scatter_reduce` per bank over every lane at once.  The banks reuse
    the gather form's kind tiles and differ only in join strategy, so a
    scatter sweep equals a gather sweep bit for bit (and equals the
    reference's per-lane vmapped `sweep_scatter`: lanes never share a
    row of the scatter).  With `dom` the bitset store is carried and
    (lb', ub', dom') comes back."""
    (vidx, coef, rhs, bidx, _, _, ad_vars, ad_offs, ad_mask, _, _, _,
     ad_pk_var, ad_pk_off, ad_pk_seg, cu_svar, cu_dur, cu_dem, cu_cap, _,
     _, _, cu_pk_svar, cu_pk_dur, cu_pk_dem, cu_pk_seg, ct_vars, ct_mask,
     ct_supp, ct_occ_inst, ct_occ_pos, dom_off, dom_track, box_lo,
     box_hi) = model_tables(cm)
    cand_lb, cand_ub = candidates_tile(lb, ub, vidx, coef, rhs, bidx)
    # plain rows (b == TRUE) must not scatter their (dis)entailment slot:
    # the gather form has no TRUE-var occurrence for it, and a
    # disentailed plain row always fails through term tightening in the
    # same sweep; neutralising it keeps both forms bit-identical per sweep
    neu_ub, neu_lb = _neutrals(lb.dtype)
    plain = bidx == TRUE_VAR
    cand_ub[:, :, -1].masked_fill_(plain, neu_ub)
    cand_lb[:, :, -1].masked_fill_(plain, neu_lb)
    tgt = torch.cat([vidx, bidx[:, None]], 1)              # [P1, K+1]
    new_lb, new_ub = _scatter_join(lb, ub, cand_lb, cand_ub, tgt, box_lo,
                                   box_hi)
    if cm.n_alldiff:
        if cm.ad_layout == "sparse":
            ad_lb, ad_ub = alldiff_candidates_sparse_tile(
                lb, ub, ad_pk_var, ad_pk_off, ad_pk_seg, cm.n_alldiff)
            v = ad_pk_var
        else:
            ad_lb, ad_ub = alldiff_candidates_tile(lb, ub, ad_vars, ad_offs,
                                                   ad_mask)
            v = ad_vars
        new_lb, new_ub = _scatter_join(new_lb, new_ub, ad_lb, ad_ub, v,
                                       box_lo, box_hi)
    if cm.n_cumulative:
        if cm.cu_layout == "sparse":
            cu_lb, cu_ub = cumulative_candidates_sparse_tile(
                lb, ub, cu_pk_svar, cu_pk_dur, cu_pk_dem, cu_pk_seg, cu_cap,
                cm.n_cumulative)
            v = cu_pk_svar
        else:
            cu_lb, cu_ub = cumulative_candidates_tile(
                lb, ub, cu_svar, cu_dur, cu_dem, cu_cap, cm.horizon)
            v = cu_svar
        new_lb, new_ub = _scatter_join(new_lb, new_ub, cu_lb, cu_ub, v,
                                       box_lo, box_hi)
    if cm.n_table:
        d_in = dom if dom is not None else B.from_bounds(
            lb, ub, dom_off, cm.n_words, track=dom_track)
        ct_lb, ct_ub, ct_dm = ct_candidates_tile(
            lb, ub, d_in, ct_vars, ct_mask, ct_supp, dom_off, cm.n_table)
        new_lb, new_ub = _scatter_join(new_lb, new_ub, ct_lb, ct_ub, ct_vars,
                                       box_lo, box_hi)
        if dom is not None:
            # the bitset join stays in gather form under the scatter
            # strategy too: there is no scatter-AND, and ⊔-associativity
            # makes the strategy irrelevant
            dom = _gather_join_dom(ct_dm, ct_occ_inst, ct_occ_pos, dom)
    if dom is None:
        return new_lb, new_ub
    return dom_normalize_tile(new_lb, new_ub, dom, dom_off, dom_track,
                              box_lo, box_hi, cm.n_words)


def sweep_scatter(cm: CompiledModel, lb, ub, dom=None):
    """Single-store view of `sweep_scatter_batch` (the scatter oracle)."""
    out = sweep_scatter_batch(cm, lb[None], ub[None],
                              None if dom is None else dom[None])
    return tuple(o[0] for o in out)


def fixpoint_tile(lb, ub, *tables, horizon: int, n_alldiff: int = 0,
                  n_cumulative: int = 0, ad_layout: str = "dense",
                  cu_layout: str = "dense", n_table: int = 0,
                  n_words: int = 1, dom=None,
                  max_iters: Optional[int] = None,
                  stop_on_fail: bool = True, step=None):
    """Per-lane-masked fixpoint loop over a ``[L, V]`` tile.

    A lane takes part in a sweep iff its own condition (changed ∧
    it < max_iters ∧ ¬failed) holds.  Lanes are independent, so each
    sweep runs only on the lanes still live (the result equals the
    reference's masked sweep over all lanes, by idempotence of ⊔).
    With `dom` the bitset store is carried, and a sweep counts as
    changed when any domain word moved even if the hull did not.
    `step` overrides the sweep (the scatter form passes its join
    strategy here): ``step(lb, ub)``, or ``step(lb, ub, dom)`` when the
    store is carried, over the live lanes only; the default is
    `sweep_tile` on `tables`.
    Returns (lb', ub', sweeps i32[L], converged bool[L]), with dom'
    before the counters when it is carried.
    """
    if step is None:
        statics = dict(horizon=horizon, n_alldiff=n_alldiff,
                       n_cumulative=n_cumulative, ad_layout=ad_layout,
                       cu_layout=cu_layout, n_table=n_table,
                       n_words=n_words)

        def step(lb_, ub_, dom_=None):
            return sweep_tile(lb_, ub_, *tables, **statics, dom=dom_)
    L = lb.shape[0]
    dev = lb.device
    have_dom = dom is not None
    changed = torch.ones(L, dtype=torch.bool, device=dev)
    it = torch.zeros(L, dtype=torch.int32, device=dev)
    lb, ub = lb.clone(), ub.clone()
    if have_dom:
        dom = dom.clone()
    while True:
        live = changed.clone()
        if max_iters is not None:
            live &= it < max_iters
        if stop_on_fail:
            live &= ~LT.is_empty(lb, ub).any(1)
        idx = live.nonzero().squeeze(1)
        if idx.numel() == 0:
            break
        olb, oub = lb[idx], ub[idx]
        if have_dom:
            odom = dom[idx]
            nlb, nub, ndom = step(olb, oub, odom)
            dom[idx] = ndom
        else:
            nlb, nub = step(olb, oub)
        ch = ((nlb != olb) | (nub != oub)).any(1)
        if have_dom:
            ch |= (ndom != odom).any(2).any(1)
        changed[idx] = ch
        lb[idx], ub[idx] = nlb, nub
        it[idx] += 1
    converged = ~changed | LT.is_empty(lb, ub).any(1)
    if have_dom:
        return lb, ub, dom, it, converged
    return lb, ub, it, converged


def fixpoint(cm: CompiledModel, lb, ub, max_iters: Optional[int] = None,
             stop_on_fail: bool = True, use_scatter: bool = False):
    """One store to its least fixed point: (lb', ub', n_sweeps,
    converged), the single-lane view of `fixpoint_batch`."""
    nlb, nub, it, conv = fixpoint_batch(cm, lb[None], ub[None],
                                        max_iters=max_iters,
                                        stop_on_fail=stop_on_fail,
                                        use_scatter=use_scatter)
    return nlb[0], nub[0], it[0], conv[0]


def fixpoint_batch(cm: CompiledModel, lb, ub, dom=None,
                   max_iters: Optional[int] = None,
                   stop_on_fail: bool = True, use_scatter: bool = False):
    """Lane-batched fixpoint over the whole ``[L, V]`` store tensor, in
    gather form or, with `use_scatter`, in scatter form.

    Returns (lb', ub', sweeps[L], converged[L]); with `dom` (``[L, V,
    W]`` int32) the carried bitset store comes back before the counters.
    """
    step = partial(sweep_scatter_batch, cm) if use_scatter else None
    return fixpoint_tile(lb, ub, *model_tables(cm), **model_statics(cm),
                         dom=dom, max_iters=max_iters,
                         stop_on_fail=stop_on_fail, step=step)


# --------------------------------------------------------------------------
# Sequential / chaotic iteration semantics: the paper's `seq P` (Prop. 3)
# and fair schedules (Def. 5 / Thm. 6), on the ReifLinLe bank.
# --------------------------------------------------------------------------

def apply_one(cm: CompiledModel, lb, ub, p):
    """Apply one guarded command (SELECT rule): one transition of ↪.
    Row p's candidates, clamped into the box, join its terms and its
    reified boolean (a plain row's disentailment lands on the TRUE
    var)."""
    p = int(p)
    rows = slice(p, p + 1)
    cand_lb, cand_ub = candidates_tile(lb[None], ub[None], cm.vidx[rows],
                                       cm.coef[rows], cm.rhs[rows],
                                       cm.bidx[rows])
    tgt = torch.cat([cm.vidx[p], cm.bidx[rows]]).long()
    row_lb = torch.minimum(cand_lb[0, 0], cm.box_hi[tgt])
    row_ub = torch.maximum(cand_ub[0, 0], cm.box_lo[tgt])
    return (lb.scatter_reduce(0, tgt, row_lb, "amax"),
            ub.scatter_reduce(0, tgt, row_ub, "amin"))


def sequential_fixpoint(cm: CompiledModel, lb, ub, order=None,
                        max_rounds: int = 10_000):
    """fix D(seq P) under the schedule `order` (default: program order):
    rounds of `apply_one` over `order` until a round changes nothing.
    Returns (lb', ub') on the model's device; raises when `max_rounds`
    rounds do not converge."""
    order = range(cm.n_props) if order is None else [int(p) for p in order]
    lb = torch.as_tensor(lb, device=cm.device)
    ub = torch.as_tensor(ub, device=cm.device)
    for _ in range(max_rounds):
        plb, pub = lb, ub
        for p in order:
            lb, ub = apply_one(cm, lb, ub, p)
        if torch.equal(lb, plb) and torch.equal(ub, pub):
            return lb, ub
    raise RuntimeError("sequential fixpoint did not converge")
