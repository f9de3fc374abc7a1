"""Two phases of the resident search's redesign, emulated in numpy with
the kernels' index arithmetic.

The dense AllDifferent bank's Hall pass from member bitmasks
(``ad_dense_masks`` and ``ad_dense_hall`` in
``csrc/fixpoint_lane.cuh``), emulated in numpy with the kernel's index
arithmetic, held against the endpoint-pair loop it replaces (one thread
per (row, i, j) counting the row's N members) and against the port's
plain dense bank (`fixpoint.alldiff_candidates_tile`).

For a row of N members, W = ceil(N / 32) words per set: GEL_i = {k :
yl_k >= yl_i}, GEU_i = {k : yu_k >= yl_i}, LEU_j = {k : yu_k <= yu_j},
LEL_j = {k : yl_k <= yu_j} and NE = {k : yl_k <= yu_k}, one thread per
member and word.  A pair (i, j) counts popc(GEL_i & LEU_j & NE) and pushes the
set bits of GEL_i & LEL_j & ~inside and GEU_i & LEU_j & ~inside.  Both
passes are emulated on the resident search's and the many-lane
fixpoint's 256-thread CTA and on a 1024-thread one, whose spare threads
split a member's or an endpoint's loop (``fixlane::slices``); the
few-lane instance at int64 keeps the endpoint-pair loop (`_hall_loop`).

The lanes claimed per superstep (``csrc/search.cu``): a CTA claims a
lane from an atomic counter and computes its pool index from its own copy
of the scan of the want flags (chunks of ceil(L / 256) lanes), in any
order; held against `search.dispatch_pool_tile` in one queue and in lane
tiles.

The kernels run only on the card (``tests/test_torch_kernel.py`` holds
both against their plain versions there, on a forced-dense AllDifferent
of two mask words and a deep N-queens 32 state among others).  This file
imports no JAX.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import fixpoint as F
from repro_torch.core import search as S
from repro_torch.kernels import fixpoint_kernel as K

torch.set_num_threads(1)

BIG = 0x7FFFFFFF // 4          # fixlane::Lim<int32_t>::BIG, the neutral
A = 3                          # real rows; row A is the dummy one
LANES = 24


def _rows(n, seed):
    """`LANES` stores of A rows of up to `n` members, one variable per
    member (V = A·n): per lane (ad_vars, ad_offs, ad_mask, lb, ub).  Row
    0 is full, rows 1 and 2 padded (n - 1 and about n / 2 real members,
    at least 1); values are drawn from few distinct endpoints so that
    endpoints tie, Hall intervals and empty pairs occur; every third
    lane makes its full row overfull (its members inside fewer values
    than members), and the next one fixes the row's first member on a
    value inside the second's bounds (a Hall interval that pushes)."""
    rng = np.random.default_rng(seed)
    A1, V = A + 1, A * n
    sizes = (n, max(1, n - 1), max(1, n // 2))
    ad_vars = np.zeros((A1, n), np.int32)
    ad_mask = np.zeros((A1, n), np.int32)
    ad_offs = np.zeros((A1, n), np.int32)
    for a, size in enumerate(sizes):
        ad_vars[a, :size] = a * n + np.arange(size)
        ad_mask[a, :size] = 1
        ad_offs[a, :size] = rng.integers(-2, 3, size)
    lbs = np.zeros((LANES, V), np.int32)
    ubs = np.zeros((LANES, V), np.int32)
    for lane in range(LANES):
        span = max(2, n + int(rng.integers(-1, 3)))
        lo = rng.integers(0, span, V)
        width = rng.choice([0, 0, 1, 2, span], V)
        lbs[lane], ubs[lane] = lo, lo + width
        if lane % 3 == 0:                       # overfull: fewer values
            v = ad_vars[0]
            base = int(rng.integers(0, span))
            lbs[lane, v] = base - ad_offs[0]
            ubs[lane, v] = base + n - 2 - ad_offs[0]
        if lane % 3 == 1:                       # a Hall interval [b, b]
            (v0, v1), (o0, o1) = ad_vars[0, :2], ad_offs[0, :2]
            lbs[lane, v0], ubs[lane, v0] = 1 - o0, 1 - o0
            lbs[lane, v1], ubs[lane, v1] = 1 - o1, 2 - o1
    return ad_vars, ad_offs, ad_mask, lbs, ubs


def _staged(ad_vars, ad_offs, ad_mask, lb, ub):
    """Step (1b): the shifted member bounds of one store, padding as the
    empty interval yl = BIG > yu = -BIG."""
    yl = np.where(ad_mask != 0, lb[ad_vars] + ad_offs, BIG).astype(np.int64)
    yu = np.where(ad_mask != 0, ub[ad_vars] + ad_offs, -BIG).astype(np.int64)
    return yl.reshape(-1), yu.reshape(-1)


def _slices(items, steps, nt):
    """``fixlane::slices``: threads per item when the CTA has spare ones."""
    return 1 if items >= nt else min(steps, nt // max(items, 1))


def _masks(yl, yu, A1, N, nt):
    """``ad_dense_masks`` on a CTA of `nt` threads: thread x of the slice
    sl, word w and member ai walks its members k of the word and ORs its
    bits into the (cleared) words."""
    W = -(-N // 32)
    AN, size = A * N, A1 * N * W
    S = _slices(AN * W, min(N, 32), nt)
    amask = np.zeros(K.ad_mask_words(A1, N), np.uint64)
    for x in range(AN * W * S):
        sl, iw = divmod(x, AN * W)
        w, ai = divmod(iw, AN)
        i = ai % N
        a0 = ai - i
        li, ui = yl[ai], yu[ai]
        k0, k1 = 32 * w, min(N, 32 * w + 32)
        words = [0] * 5
        for k in range(k0 + sl, k1, S):
            lk, uk = yl[a0 + k], yu[a0 + k]
            bit = 1 << (k - k0)
            for n, hit in enumerate((lk >= li, uk >= li, uk <= ui,
                                     lk <= ui, lk <= uk)):
                words[n] |= bit if hit else 0
        for n in range(4):
            amask[n * size + ai * W + w] |= words[n]
        if i == 0:
            amask[4 * size + (a0 // N) * W + w] |= words[4]
    return amask


def _hall_bitmask(yl, yu, A1, N, nt):
    """``ad_dense_hall`` on a CTA of `nt` threads over the masks of
    `_masks`: thread x of the slice sl and upper endpoint aj walks the
    lower endpoints i; returns (alb, aub, afail)."""
    W = -(-N // 32)
    AN, size = A * N, A1 * N * W
    S = _slices(AN, N, nt)
    amask = _masks(yl, yu, A1, N, nt)
    alb = np.full(A1 * N, -BIG, np.int64)
    aub = np.full(A1 * N, BIG, np.int64)
    afail = np.zeros(A1, np.int32)

    def push(base, lbm, ubm, lo, hi):
        for k in range(32):
            if (lbm >> k) & 1:
                alb[base + k] = max(alb[base + k], hi + 1)
            if (ubm >> k) & 1:
                aub[base + k] = min(aub[base + k], lo - 1)

    for x in range(AN * S):
        sl, aj = divmod(x, AN)
        a = aj // N
        a0 = a * N
        hi = yu[aj]
        gel = amask[a0 * W:]
        geu = amask[size + a0 * W:]
        leu = amask[2 * size + aj * W:]
        lel = amask[3 * size + aj * W:]
        ne = amask[4 * size + a * W:]
        for i in range(sl, N, S):
            lo = yl[a0 + i]
            if lo > hi:
                continue
            inside = [int(gel[i * W + w] & leu[w] & ne[w]) for w in range(W)]
            cnt = sum(bin(v).count("1") for v in inside)
            width = hi - lo + 1
            if cnt > width:
                afail[a] = 1
            elif cnt == width:
                for w in range(W):
                    out = ~inside[w] & 0xFFFFFFFF
                    push(a0 + 32 * w, int(gel[i * W + w] & lel[w]) & out,
                         int(geu[i * W + w] & leu[w]) & out, lo, hi)
    return alb, aub, afail


def _hall_loop(yl, yu, A1, N):
    """The form it replaces: per (row, i, j) a count over the row's N
    members, then a push loop over them (vectorised over k)."""
    alb = np.full(A1 * N, -BIG, np.int64)
    aub = np.full(A1 * N, BIG, np.int64)
    afail = np.zeros(A1, np.int32)
    for a in range(A):
        kl, ku = yl[a * N:(a + 1) * N], yu[a * N:(a + 1) * N]
        for i in range(N):
            for j in range(N):
                lo, hi = kl[i], ku[j]
                if lo > hi:
                    continue
                inside = (kl >= lo) & (ku <= hi) & (kl <= ku)
                cnt, width = int(inside.sum()), hi - lo + 1
                if cnt > width:
                    afail[a] = 1
                elif cnt == width:
                    push_l = ~inside & (kl >= lo) & (kl <= hi)
                    push_u = ~inside & (ku >= lo) & (ku <= hi)
                    seg_l = alb[a * N:(a + 1) * N]
                    seg_u = aub[a * N:(a + 1) * N]
                    seg_l[push_l] = np.maximum(seg_l[push_l], hi + 1)
                    seg_u[push_u] = np.minimum(seg_u[push_u], lo - 1)
    return alb, aub, afail


@pytest.mark.parametrize("n", [2, 3, 8, 31, 32, 33, 35])
def test_bitmask_hall_equals_the_pair_loop_and_the_plain_bank(n):
    ad_vars, ad_offs, ad_mask, lbs, ubs = _rows(n, seed=n)
    A1 = A + 1
    plain_lb, plain_ub = F.alldiff_candidates_tile(
        torch.from_numpy(lbs), torch.from_numpy(ubs),
        torch.from_numpy(ad_vars).long(), torch.from_numpy(ad_offs),
        torch.from_numpy(ad_mask))
    real = ad_mask != 0
    seen = dict(fail=0, push=0, padding=int((~real[:A]).sum()), empty=0)
    for lane in range(LANES):
        yl, yu = _staged(ad_vars, ad_offs, ad_mask, lbs[lane], ubs[lane])
        ref = _hall_loop(yl, yu, A1, n)
        for nt in (K.THREADS, K.FEW_THREADS):
            got = _hall_bitmask(yl, yu, A1, n, nt)
            for g, r in zip(got, ref):
                np.testing.assert_array_equal(g, r)
        alb, aub, afail = got
        # the join's view (fixpoint_lane.cuh, step (3)): a failed row's lb
        # candidates at -NEU_LB, then shifted back by the member's offset
        jl = (np.where(afail[:, None] != 0, BIG, alb.reshape(A1, n))
              - ad_offs)
        ju = aub.reshape(A1, n) - ad_offs
        np.testing.assert_array_equal(jl[real], plain_lb[lane].numpy()[real])
        np.testing.assert_array_equal(ju[real], plain_ub[lane].numpy()[real])
        seen["fail"] += int(afail.any())
        seen["push"] += int(((alb > -BIG) | (aub < BIG)).any()
                            and not afail.all())
        y = yl.reshape(A1, n)[:A], yu.reshape(A1, n)[:A]
        seen["empty"] += int((y[0][:, :, None] > y[1][:, None, :]).any())
    assert all(seen.values()), seen


def test_mask_words_fit_every_dense_width():
    """One word per set up to N = 32, two from 33 (the widest row the
    `auto` layout keeps dense is 35; a forced dense bank may be wider),
    and the budget counts them (``fixlane::ad_mask_words``)."""
    assert [K.ad_mask_words(4, n) for n in (2, 32, 33, 64, 65)] == [
        36, 516, 1064, 2056, 3132]


# ---- lanes claimed per superstep --------------------------------------------

def _claimed_dispatch(want, next_sub, done, heads, n_subs, tile, order,
                      threads=K.THREADS):
    """``search_kernel``'s dispatch folded into the claim: the block scan
    of the want flags over `threads` chunks of ceil(L / threads) lanes,
    then, lane by lane in `order`, the claimer's rank from that scan (a
    chunk's prefix plus the flags before the lane in its chunk) and the
    pool index — in lane tiles of `tile` lanes (``NT`` tiles; `tile` None
    for one queue) the rank within the tile and its strided index.
    Returns (next_sub, done) after the dispatch."""
    L = len(want)
    per = -(-L // threads)
    sums = [int(want[c * per:(c + 1) * per].sum()) for c in range(threads)]
    scan = np.concatenate([[0], np.cumsum(sums)[:-1]])
    total = int(want.sum())

    def prefix(x):
        if x >= L:
            return total
        c = x // per
        return int(scan[c]) + int(want[c * per:x].sum())

    next_sub, done = next_sub.copy(), done.copy()
    n_tiles = 1 if tile is None else -(-L // tile)
    for lane in order:
        if not want[lane]:
            continue
        if tile is None:
            idx = int(heads[0]) + prefix(lane)
        else:
            tt = lane // tile
            idx = int(heads[tt]) + prefix(lane) - prefix(tt * tile)
            if n_tiles > 1:
                idx = tt + n_tiles * idx
        if idx < n_subs:
            next_sub[lane] = idx
        else:
            done[lane] = True
    return next_sub, done


@pytest.mark.parametrize("tile", [None, 256, 384, 7, 1000])
def test_claimed_ranks_equal_dispatch_pool_tile(tile):
    """1000 lanes (the last scan chunk short) with random fresh, done and
    pending flags, a pool that runs out mid-way, claimed in a shuffled
    order: next_sub and done equal `dispatch_pool_tile`'s, per tile with
    its own cursor and strided pool shard."""
    rng = np.random.default_rng(21 if tile is None else tile)
    L, n_subs = 1000, 500
    for _ in range(4):
        fresh = rng.random(L) < 0.6
        done = rng.random(L) < 0.2
        next_sub = np.where(rng.random(L) < 0.1, rng.integers(0, n_subs, L),
                            S.UNASSIGNED).astype(np.int32)
        want = fresh & ~done & (next_sub >= n_subs)
        n_tiles = 1 if tile is None else -(-L // tile)
        heads = rng.integers(100 // n_tiles, 300 // n_tiles + 2, n_tiles)
        got = _claimed_dispatch(want, next_sub, done, heads, n_subs, tile,
                                rng.permutation(L))
        for t in range(n_tiles):
            lanes = (slice(None) if tile is None
                     else slice(t * tile, min(L, (t + 1) * tile)))
            ref_st = S.LaneState(*(None,) * len(S.LaneState._fields))._replace(
                fresh=torch.from_numpy(fresh[lanes]),
                done=torch.from_numpy(done[lanes]),
                next_sub=torch.from_numpy(next_sub[lanes]))
            ref, _ = S.dispatch_pool_tile(
                ref_st, torch.tensor(int(heads[t]), dtype=torch.int32),
                n_subs, tile_id=t, n_tiles=n_tiles)
            np.testing.assert_array_equal(got[0][lanes],
                                          ref.next_sub.numpy())
            np.testing.assert_array_equal(got[1][lanes], ref.done.numpy())
        assert got[1].sum() > done.sum()          # the pool runs out
