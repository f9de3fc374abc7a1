"""The reshaped sweep phases of `fixpoint_cuda` (``csrc/fixpoint_lane.cuh``),
emulated in numpy and held against the form they replace and against the
port's plain banks, and the rule that picks the few-lane instance.

Each phase is written once in the kernel, templated on the CTA's thread
count; these emulations follow its index arithmetic:

* the sparse Cumulative scans: a forward and a backward scan per task,
  each starting where the sorted events first matter (a binary search)
  and stopping at the first event that provably cannot move the start;
* the dense Cumulative profile, built as a difference array (+q where a
  compulsory part starts, -q where it ends, clipped to the horizon) and a
  per-row prefix sum, against the C1·H·T compare loop;
* the bitonic sort with the in-warp steps (j < 32) as register exchanges
  of thread t with thread t ^ j, against `block_sort`'s shared-memory
  pairs, with tied keys carrying different payloads;
* the lane groups of the linear rows (a term per lane, smin/smax reduced
  by an xor butterfly) and of the join (occurrence slots strided over the
  group, max/min by the butterfly).

The kernels themselves run only on the card: ``tests/test_torch_kernel.py``
holds both instances against `fixpoint_batch` there.  This file imports
no JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import eps
from repro_torch.core import fixpoint as F
from repro_torch.core import search as S
from repro_torch.core.models import rcpsp
from repro_torch.kernels import fixpoint_kernel as K
from repro_torch.testing import random_substores

torch.set_num_threads(1)

H100_SMS = 132


def _rcpsp(n, layout, seed=0, **kw):
    m, _ = rcpsp.build_model(rcpsp.generate(n, n_resources=4, seed=seed,
                                            **kw))
    return m.compile(device="cpu", bank_layout=layout)


def _eps_stores(cm, target):
    """The ``[n, V]`` stores `eps.decompose` propagates (the root and the
    two children of every split), recorded on the way."""
    calls, propagate = [], eps._propagate

    def record(backend, cm_, lbs, ubs):
        calls.append((lbs.copy(), ubs.copy()))
        return propagate(backend, cm_, lbs, ubs)

    eps._propagate = record
    try:
        eps.decompose(cm, target, S.SearchOptions(backend="gather"))
    finally:
        eps._propagate = propagate
    return (np.concatenate([c[0] for c in calls]),
            np.concatenate([c[1] for c in calls]))


def _stores(cm, n_random, target, seed):
    lbs, ubs = random_substores(np.random.default_rng(seed), cm, n_random)
    elb, eub = _eps_stores(cm, target)
    return np.concatenate([lbs, elb]), np.concatenate([ubs, eub])


def _np(t):
    return t.cpu().numpy().astype(np.int64)


# ---- the sparse Cumulative scans ------------------------------------------

def _scan_full(times, prof, e0, e1, est, lst, d, q, cap):
    """The forward and backward monotone-jump scans over a whole segment
    (the form the kernel had: every event, no exit)."""
    cp, ect = lst < est + d, est + d
    st = est
    u = times[e0] if e0 < e1 else 0
    for e in range(e0, e1):
        v = times[e + 1] if e + 1 < e1 else u
        if u < v:
            own = cp and lst <= u < ect
            if prof[e] + (0 if own else q) > cap and st < v and st + d > u:
                st = v
        u = v
    sl = lst
    v = times[e1 - 1] if e1 > e0 else 0
    for e in range(e1 - 1, e0 - 1, -1):
        u = times[e]
        if u < v:
            own = cp and lst <= u < ect
            if prof[e] + (0 if own else q) > cap and sl < v and sl + d > u:
                sl = u - d
        v = u
    return st, sl


def _first_after(times, lo, hi, t, strict):
    """``fixlane::first_after``: the first index of [lo, hi) whose time is
    > t (strict) or >= t, else hi, by binary search."""
    while lo < hi:
        mid = (lo + hi) >> 1
        if (times[mid] > t) if strict else (times[mid] >= t):
            hi = mid
        else:
            lo = mid + 1
    return lo


def _scan_early(times, prof, e0, e1, est, lst, d, q, cap):
    """``fixlane::cu_sparse_starts``: each scan starts where events first
    matter and stops where none can move it; returns the two results and
    the iterations each ran."""
    cp, ect = lst < est + d, est + d
    st, n_fwd = est, 0
    e = _first_after(times, e0 + 1, e1, est, True) - 1
    while e + 1 < e1:
        u, v = times[e], times[e + 1]
        if u >= st + d:
            break
        n_fwd += 1
        if u < v:
            own = cp and lst <= u < ect
            if prof[e] + (0 if own else q) > cap and st < v:
                st = v
        e += 1
    sl, n_bwd = lst, 0
    e = min(_first_after(times, e0, e1, lst + d, False), e1 - 1) - 1
    while e >= e0:
        u, v = times[e], times[e + 1]
        if v <= sl:
            break
        n_bwd += 1
        if u < v:
            own = cp and lst <= u < ect
            if prof[e] + (0 if own else q) > cap and sl + d > u:
                sl = u - d
        e -= 1
    return st, sl, n_fwd, n_bwd


def _sparse_cumulative(cm, lb, ub, early):
    """One lane's sparse Cumulative candidates as the kernel computes them
    (events, seg-major sort, prefix-sum profile, overload flags, then the
    scans of `early` or the full ones), over the packed axis."""
    neu = int(np.iinfo(np.int32).max) // 4
    svar, dur, dem, seg = (_np(cm.cu_pk_svar), _np(cm.cu_pk_dur),
                           _np(cm.cu_pk_dem), _np(cm.cu_pk_seg))
    cap_c, ptr, C = _np(cm.cu_cap), _np(cm.cu_ptr), cm.n_cumulative
    M = svar.shape[0]
    est, lst = lb[svar], ub[svar]
    cp = (seg < C) & (dur > 0) & (dem > 0) & (lst < est + dur)
    t = np.concatenate([lst, est + dur])
    kind = np.concatenate([np.ones(M, np.int64), np.zeros(M, np.int64)])
    sg = np.concatenate([seg, seg])
    delta = np.concatenate([np.where(cp, dem, 0), np.where(cp, -dem, 0)])
    order = np.lexsort((kind, t, sg))
    times, prof, sseg = t[order], np.cumsum(delta[order]), sg[order]
    ovl = np.zeros(C + 1, bool)
    for e in range(2 * M):
        nxt = times[e + 1] if e + 1 < 2 * M and sseg[e + 1] == sseg[e] \
            else times[e]
        if times[e] < nxt and prof[e] > cap_c[sseg[e]]:
            ovl[sseg[e]] = True
    clb, cub = np.full(M, -neu), np.full(M, neu)
    steps = 0
    for m in range(M):
        c, d, q = seg[m], dur[m], dem[m]
        if not (c < C and d > 0 and q > 0):
            continue
        cap = cap_c[c]
        if q > cap:
            clb[m], cub[m] = neu, -neu
            continue
        e0, e1 = 2 * ptr[c], 2 * ptr[c + 1]
        args = (times, prof, e0, e1, est[m], lst[m], d, q, cap)
        if early:
            st, sl, nf, nb = _scan_early(*args)
            steps += max(nf, nb)
        else:
            st, sl = _scan_full(*args)
            steps += e1 - e0
        clb[m] = neu if ovl[c] else st
        cub[m] = sl if sl >= 0 else -neu
    return clb, cub, steps


@pytest.mark.parametrize("n_tasks", [30, 60])
def test_early_exit_scans_equal_full_scans_and_the_plain_bank(n_tasks):
    """Random stores and the stores EPS propagates, J30 and J60 compiled
    to the sparse Cumulative layout: the early-exit scans give the full
    scans' candidates, which equal the plain bank's."""
    cm = _rcpsp(n_tasks, "sparse")
    lbs, ubs = _stores(cm, 24, 16, seed=n_tasks)
    tables = F.model_tables(cm)
    ref_lb, ref_ub = F.cumulative_candidates_sparse_tile(
        torch.from_numpy(lbs), torch.from_numpy(ubs), *tables[22:26],
        cm.cu_cap, cm.n_cumulative)
    full_steps = early_steps = 0
    for i in range(lbs.shape[0]):
        lb, ub = lbs[i].astype(np.int64), ubs[i].astype(np.int64)
        if (lb > ub).any():
            continue
        flb, fub, fs = _sparse_cumulative(cm, lb, ub, early=False)
        elb, eub, es = _sparse_cumulative(cm, lb, ub, early=True)
        np.testing.assert_array_equal(elb, flb)
        np.testing.assert_array_equal(eub, fub)
        np.testing.assert_array_equal(flb, _np(ref_lb[i]))
        np.testing.assert_array_equal(fub, _np(ref_ub[i]))
        full_steps += fs
        early_steps += es
    assert 0 < early_steps < full_steps


def test_early_exit_scans_on_ties_and_empty_intervals():
    """Segments of 1-12 tasks on a narrow time range (many tied events,
    zero-length intervals, zero durations and demands, tasks without a
    compulsory part, stores crossing zero): every task's scans agree."""
    rng = np.random.default_rng(7)
    checked = 0
    for _ in range(3000):
        n = int(rng.integers(1, 13))
        est = rng.integers(-3, 8, n)
        lst = est + rng.integers(-2, 6, n)
        d = rng.integers(0, 4, n)
        q = rng.integers(0, 4, n)
        cap = int(rng.integers(0, 6))
        cp = (d > 0) & (q > 0) & (lst < est + d)
        t = np.concatenate([lst, est + d])
        kind = np.concatenate([np.ones(n, np.int64), np.zeros(n, np.int64)])
        delta = np.concatenate([np.where(cp, q, 0), np.where(cp, -q, 0)])
        order = np.lexsort((kind, t))
        times, prof = t[order], np.cumsum(delta[order])
        for m in range(n):
            if not (d[m] > 0 and 0 < q[m] <= cap):
                continue
            args = (times, prof, 0, 2 * n, est[m], lst[m], d[m], q[m], cap)
            assert _scan_early(*args)[:2] == _scan_full(*args)
            checked += 1
    assert checked > 5000


# ---- the dense Cumulative profile -----------------------------------------

def _profile_compare_loop(cm, lb, ub):
    """The C1·H·T form: one (row, time) point at a time over every task."""
    svar, dur, dem = _np(cm.cu_svar), _np(cm.cu_dur), _np(cm.cu_dem)
    C1, T = svar.shape
    H = cm.horizon
    tau = np.arange(H)
    prof = np.zeros((C1, H), np.int64)
    for c in range(C1):
        for j in range(T):
            d, q, v = dur[c, j], dem[c, j], svar[c, j]
            if d > 0 and q > 0:
                prof[c] += np.where((ub[v] <= tau) & (tau < lb[v] + d), q, 0)
    return prof


def _profile_difference_array(cm, lb, ub):
    """``fixpoint_lane`` (1c)/(2b), dense: ±q at the ends of each
    compulsory part clipped to [0, H) (no write at H), then a prefix sum
    per row in chunks of 32 (a warp's inclusive scan plus the carry)."""
    svar, dur, dem = _np(cm.cu_svar), _np(cm.cu_dur), _np(cm.cu_dem)
    C1, T = svar.shape
    H = cm.horizon
    diff = np.zeros((C1, H), np.int64)
    for c in range(C1):
        for j in range(T):
            d, q, v = dur[c, j], dem[c, j], svar[c, j]
            if not (d > 0 and q > 0):
                continue
            lo, hi = max(ub[v], 0), min(lb[v] + d, H)
            if lo >= hi:
                continue
            diff[c, lo] += q
            if hi < H:
                diff[c, hi] -= q
    prof = np.zeros_like(diff)
    for c in range(C1):
        run = 0
        for t0 in range(0, H, 32):
            chunk = np.cumsum(diff[c, t0:t0 + 32]) + run
            prof[c, t0:t0 + 32] = chunk
            run = chunk[-1]
    return prof


@pytest.mark.parametrize("n_tasks", [30, 60])
def test_difference_array_profile_equals_the_compare_loop(n_tasks):
    """J30 and J60 (dense Cumulative), random stores, EPS stores, stores
    pushed past both ends of the horizon and stores that pin every task
    near 0: equal profiles; the plain bank fails every task of each row
    the profile overloads."""
    cm = _rcpsp(n_tasks, "dense")
    assert cm.cu_layout == "dense"
    lbs, ubs = _stores(cm, 16, 8, seed=n_tasks)
    rng = np.random.default_rng(n_tasks)
    wide_lb = lbs[:8] + rng.integers(-400, 400, lbs[:8].shape)
    wide_ub = wide_lb + rng.integers(-20, 60, lbs[:8].shape)
    # every task pinned into the first few time points: overloads
    pinned = rng.integers(0, 6, lbs[:8].shape)
    lbs = np.concatenate([lbs, wide_lb, pinned])
    ubs = np.concatenate([ubs, wide_ub, pinned])
    cap = _np(cm.cu_cap)
    tables = F.model_tables(cm)
    plain_lb, _ = F.cumulative_candidates_tile(
        torch.from_numpy(lbs.astype(np.int32)),
        torch.from_numpy(ubs.astype(np.int32)), *tables[15:19], cm.horizon)
    act = (_np(cm.cu_dur) > 0) & (_np(cm.cu_dem) > 0)
    neu = int(np.iinfo(np.int32).max) // 4
    n_over = 0
    for i in range(lbs.shape[0]):
        lb, ub = lbs[i].astype(np.int64), ubs[i].astype(np.int64)
        ref = _profile_compare_loop(cm, lb, ub)
        got = _profile_difference_array(cm, lb, ub)
        np.testing.assert_array_equal(got, ref)
        over = (got > cap[:, None]).any(1)
        n_over += int(over.any())
        failed = ((_np(plain_lb[i]) == neu) | ~act).all(1) & act.any(1)
        assert not (over & ~failed).any()
    assert n_over > 0


# ---- the bitonic sort -------------------------------------------------------

def _sort_step(key, val, n, k, j):
    """``fixlane::sort_step``: the (k, j) step's pairs in place."""
    for t in range(n // 2):
        i = 2 * j * (t // j) + t % j
        lo, hi = key[i], key[i + j]
        if (lo > hi) if (i & k) == 0 else (lo < hi):
            key[i], key[i + j] = hi, lo
            val[i], val[i + j] = val[i + j], val[i]


def _block_sort_smem(key, val, n):
    key, val = list(key), list(val)
    k = 2
    while k <= n:
        j = k >> 1
        while j > 0:
            _sort_step(key, val, n, k, j)
            j >>= 1
        k <<= 1
    return key, val


def _block_sort_regs(key, val, n, nt):
    """``fixlane::block_sort`` at n <= NT: thread t holds key t; steps
    with j >= 32 go through shared memory, the others exchange with
    thread t ^ j.  Threads t >= n hold a dummy key and store nothing.
    Returns (keys, payloads, barriers)."""
    assert n <= nt
    a = [key[t] if t < n else 0 for t in range(nt)]
    x = [val[t] if t < n else 0 for t in range(nt)]
    smem_k, smem_v = list(key), list(val)
    barriers = 0
    k = 2
    while k <= n:
        if k > 32:
            smem_k[:n], smem_v[:n] = a[:n], x[:n]
            barriers += 1
            j = k >> 1
            while j >= 32:
                _sort_step(smem_k, smem_v, n, k, j)
                barriers += 1
                j >>= 1
            a[:n], x[:n] = smem_k[:n], smem_v[:n]
        j = min(k >> 1, 16)
        while j > 0:
            b, y = [a[t ^ j] for t in range(nt)], [x[t ^ j] for t in range(nt)]
            for t in range(nt):
                up, lower = (t & k) == 0, (t & j) == 0
                swap = ((a[t] > b[t]) if lower else (b[t] > a[t])) if up \
                    else ((a[t] < b[t]) if lower else (b[t] < a[t]))
                if swap:
                    a[t], x[t] = b[t], y[t]
            j >>= 1
        k <<= 1
    return a[:n], x[:n], barriers + 1


@pytest.mark.parametrize("n", [1, 2, 8, 32, 64, 256, 1024])
def test_shuffle_bitonic_equals_block_sort(n):
    """Keys drawn from few values (ties everywhere) with distinct
    payloads: the register network returns block_sort's keys and payloads
    exactly, sorted; n = 1024 takes 21 barriers (55 steps)."""
    rng = np.random.default_rng(n)
    for trial in range(3 if n >= 256 else 20):
        key = [int(k) for k in rng.integers(0, 1 + n // 4 + trial, n)]
        val = list(range(n))
        ref = _block_sort_smem(key, val, n)
        got_k, got_v, barriers = _block_sort_regs(key, val, n, max(n, 32))
        assert got_k == ref[0] == sorted(key)
        assert got_v == ref[1]
    if n == 1024:
        assert barriers == 21


# ---- the lane groups: linear rows and the join ------------------------------

def _lane_group(n, fit):
    """``fixlane::lane_group``."""
    g = 1
    while g < n and g < 32 and 2 * g <= fit:
        g <<= 1
    return g


def _butterfly(x, op):
    """Every lane of a group ends with op over the group: the xor
    exchanges of ``__shfl_xor`` at offsets 1, 2, 4, ..."""
    x = list(x)
    o = 1
    while o < len(x):
        x = [op(x[i], x[i ^ o]) for i in range(len(x))]
        o <<= 1
    return x


def test_lane_groups():
    assert [_lane_group(k, 32) for k in (0, 1, 2, 3, 8, 9, 40)] == [
        1, 1, 2, 4, 8, 16, 32]
    # the few-lane instance's join (GJ) at J120 (V 122), J60 (V 62),
    # N-queens 32 (V 33) and N-queens 256 (V 257), and its linear groups
    # (GL) at J120 (P1 1241) and J60 (P1 323), K = 8; the 256-thread
    # instance keeps GL = GJ = 1
    assert [_lane_group(32, K.FEW_THREADS // v)
            for v in (122, 62, 33, 257)] == [8, 16, 16, 2]
    assert [_lane_group(8, K.FEW_THREADS // p1)
            for p1 in (1241, 323)] == [1, 2]


@pytest.mark.parametrize("n_tasks", [30, 60])
def test_row_term_groups_equal_the_serial_rows(n_tasks):
    """The linear rows by (row, term), groups of every size the rule can
    pick for K = 8: each lane sums its terms, the butterfly gives every
    lane of the group the row's smin and smax, equal to the serial
    loop's; the entailment pair the group's first lane writes from them
    equals the plain bank's."""
    cm = _rcpsp(n_tasks, "dense")
    lbs, ubs = _stores(cm, 8, 8, seed=n_tasks)
    coef, vidx = _np(cm.coef), _np(cm.vidx)
    P1, Kt = coef.shape
    groups = sorted({_lane_group(Kt, fit) for fit in (1, 2, 4, 32)})
    assert groups == [1, 2, 4, 8]
    tables = F.model_tables(cm)
    ref_lb, ref_ub = F.candidates_tile(torch.from_numpy(lbs),
                                       torch.from_numpy(ubs), *tables[:4])
    ref_lb, ref_ub = _np(ref_lb), _np(ref_ub)
    rhs = _np(cm.rhs)
    for i in range(lbs.shape[0]):
        lb, ub = lbs[i].astype(np.int64), ubs[i].astype(np.int64)
        xl, xu = lb[vidx], ub[vidx]
        tl = np.where(coef > 0, coef * xl, coef * xu)
        tu = np.where(coef > 0, coef * xu, coef * xl)
        for r in range(P1):
            for G in groups:
                smin = _butterfly([int(tl[r, g::G].sum()) for g in range(G)],
                                  lambda a, b: a + b)
                smax = _butterfly([int(tu[r, g::G].sum()) for g in range(G)],
                                  lambda a, b: a + b)
                assert set(smin) == {int(tl[r].sum())}
                assert set(smax) == {int(tu[r].sum())}
            # the entailment pair the group's first lane writes
            assert ref_lb[i, r, Kt] == (1 if smax[0] <= rhs[r]
                                        else -(np.iinfo(np.int32).max // 4))
            assert ref_ub[i, r, Kt] == (0 if smin[0] > rhs[r]
                                        else np.iinfo(np.int32).max // 4)


def test_join_groups_equal_the_serial_join():
    """GJ lanes per variable stride its occurrence slots; the max/min
    butterfly gives the serial max/min for any slot count."""
    rng = np.random.default_rng(3)
    for D in (1, 3, 8, 120, 131):
        for gj in (1, 2, 8, 16, 32):
            cand = rng.integers(-50, 50, D)
            lanes_max = [int(cand[g::gj].max()) if g < D else -10 ** 9
                         for g in range(gj)]
            lanes_min = [int(cand[g::gj].min()) if g < D else 10 ** 9
                         for g in range(gj)]
            assert set(_butterfly(lanes_max, max)) == {int(cand.max())}
            assert set(_butterfly(lanes_min, min)) == {int(cand.min())}


# ---- the instance rule and the budget ---------------------------------------

@pytest.mark.parametrize("lanes,threads", [
    (1, K.FEW_THREADS), (2, K.FEW_THREADS), (132, K.FEW_THREADS),
    (133, K.THREADS), (1024, K.THREADS)])
def test_instance_rule(lanes, threads):
    """EPS's root and splits (1 and 2 lanes) take the few-lane instance;
    beyond one lane per SM of an H100, the 256-thread one."""
    assert K.instance_threads(lanes, H100_SMS) == threads


def test_instance_rule_follows_the_sm_count():
    assert K.instance_threads(8, 8) == K.FEW_THREADS
    assert K.instance_threads(9, 8) == K.THREADS


def test_few_lane_budget():
    """No region of a CTA's shared memory depends on its thread count:
    the block scan keeps one word per warp, and the few-lane CTA's 32
    warps fit the 32 scan words; the budget of J120 × 10⁷ (the largest
    the port runs, int64) still fits one H100 block."""
    assert K.FEW_THREADS // 32 <= K.SCAN_WORDS
    assert K.FEW_THREADS % K.THREADS == 0
    inst = rcpsp.generate(120, n_resources=4, seed=0)
    m, _ = rcpsp.build_model(dataclasses.replace(
        inst, durations=inst.durations * 10 ** 7))
    cm = m.compile(device="cpu")
    assert cm.dtype == "int64"
    b = K.fit_smem(cm)
    assert b["total"] == 223_824 <= K.SMEM_LIMIT_BYTES
    # the resident kernel's extra words follow its own 256-thread CTA
    assert K.SEARCH_EXTRA_WORDS == K.THREADS + K.SCAN_WORDS + 32
