"""Test inputs and comparisons for the port, without JAX: `chip_smoke.py`
and the kernel tests use them on the card as well as on the CPU."""

from __future__ import annotations

import numpy as np


def random_substores(rng: np.random.Generator, cm, n: int):
    """n stores made by random tells on the root box (consistent or not),
    as host arrays ``[n, V]``; the recipe of the JAX package's test helper
    of the same name, so one seed gives the same stores on both sides."""
    lb0, ub0 = cm.lb0.cpu().numpy(), cm.ub0.cpu().numpy()
    V = cm.n_vars
    lbs = np.tile(lb0, (n, 1))
    ubs = np.tile(ub0, (n, 1))
    for i in range(n):
        for _ in range(int(rng.integers(0, 8))):
            v = int(rng.integers(1, V))
            if lb0[v] >= ub0[v]:
                continue
            cut = int(rng.integers(lb0[v], ub0[v] + 1))
            if rng.random() < 0.5:
                lbs[i, v] = max(lbs[i, v], cut)
            else:
                ubs[i, v] = min(ubs[i, v], cut)
    return lbs, ubs


def pigeonhole_stores(rng: np.random.Generator, cm, lbs, ubs, n: int):
    """Copies of the first `n` stores of ``lbs``/``ubs`` in which one
    AllDifferent row (picked at random) is overfull: its first
    m = min(members, 3) members are told into m - 1 shifted values, which
    fails the row by pigeonhole at the first sweep (N-queens: three
    queens in two columns; coloring: both ends of an edge on one colour).
    A store whose row has no such room in the root box is left as it was.
    """
    vars_ = cm.ad_vars.cpu().numpy()
    offs = cm.ad_offs.cpu().numpy()
    mask = cm.ad_mask.cpu().numpy()
    lb0, ub0 = cm.lb0.cpu().numpy(), cm.ub0.cpu().numpy()
    lbs, ubs = lbs[:n].copy(), ubs[:n].copy()
    for i in range(lbs.shape[0]):
        a = int(rng.integers(0, cm.n_alldiff))
        k = np.flatnonzero(mask[a])[:3]
        v, off = vars_[a, k], offs[a, k]
        lo = int((lb0[v] + off).max())           # shifted interval [lo, hi]
        hi = lo + len(k) - 2
        if hi < lo or hi > int((ub0[v] + off).min()):
            continue
        lbs[i, v] = lo - off
        ubs[i, v] = hi - off
    return lbs, ubs


# Compact-Table hand cases (the reference's tests/test_compact_table.py
# models), built with a `Model` class given by the caller: the port's, or
# the JAX package's in the tests that hold one against the other.

def chain_model(cls):
    """x, y, z in [0, 4], table(x, y) and table(y, z), x >= 1: chain
    filtering to x in [1, 3], y in [2, 4], z in [1, 2]."""
    m = cls("ct-chain")
    x, y, z = (m.int_var(0, 4, n) for n in "xyz")
    m.table([x, y], [(0, 1), (1, 2), (3, 4), (4, 0)])
    m.table([y, z], [(1, 3), (2, 2), (4, 1)])
    m.add(x >= 1)
    m.minimize(x)
    m.branch_on([x, y, z])
    return m


def holes_model(cls):
    """x restricted to {1, 3} by a unary table: a hole bounds cannot see,
    which the second table turns into y in {0, 7}."""
    m = cls("ct-holes")
    x = m.int_var(0, 4, "x")
    y = m.int_var(0, 9, "y")
    m.table([x], [(1,), (3,)])
    m.table([x, y], [(1, 0), (2, 5), (3, 7)])
    m.minimize(y)
    m.branch_on([x, y])
    return m


def wipeout_model(cls):
    """Two tables over (x, y) with no tuple in common: the root fails."""
    m = cls("ct-wipe")
    x = m.int_var(0, 3, "x")
    y = m.int_var(0, 3, "y")
    m.table([x, y], [(0, 1), (1, 2)])
    m.table([x, y], [(2, 3), (3, 0)])
    m.branch_on([x, y])
    return m


def mixed_ct_model(cls):
    """Two tables and a linear objective coupling: every kind of bank
    a table model compiles to in one model."""
    m = cls("ct-mixed")
    xs = [m.int_var(0, 5, f"x{i}") for i in range(4)]
    m.table(xs, [(0, 1, 2, 3), (1, 2, 3, 4), (2, 3, 4, 5),
                 (5, 4, 3, 2), (0, 2, 4, 1)])
    m.table([xs[0], xs[3]], [(0, 3), (2, 3), (5, 2), (1, 4)])
    obj = m.int_var(0, 30, "obj")
    for c in (xs[0] * 3 + xs[1]).eq(obj):
        m.add(c)
    m.minimize(obj)
    m.branch_on(xs)
    return m


def wide_table_model(cls, seed: int = 0):
    """Tables of more than 32 tuples (``ct_words`` = 2): 48 and 40
    distinct random tuples over two overlapping triples of x0..x4 in
    [0, 9], and a linear objective x0 + x4."""
    rng = np.random.default_rng(seed)
    m = cls("ct-wide")
    xs = [m.int_var(0, 9, f"x{i}") for i in range(5)]

    def tuples(n):
        out = set()
        while len(out) < n:
            out.add(tuple(int(v) for v in rng.integers(0, 10, size=3)))
        return sorted(out)

    m.table(xs[:3], tuples(48))
    m.table(xs[2:], tuples(40))
    obj = m.int_var(0, 18, "obj")
    for c in (xs[0] + xs[4]).eq(obj):
        m.add(c)
    m.minimize(obj)
    m.branch_on(xs)
    return m


CT_HAND_MODELS = {"chain": chain_model, "holes": holes_model,
                  "wipeout": wipeout_model, "mixed": mixed_ct_model,
                  "wide": wide_table_model}


def random_dom_stores(rng: np.random.Generator, cm, lbs, ubs,
                      n_wipe: int = 0):
    """Bitset stores ``[n, V, W]`` (``uint32``) for the host stores
    ``lbs``/``ubs``: the range words of each store (`np_from_bounds`,
    untracked variables all-ones) with about a quarter of the values
    strictly inside each tracked variable's interval cleared at random.
    In the first `n_wipe` stores of a table model, every member of one
    table row (picked at random) loses all of its interior values
    instead, so the hull is intact and only the words show what is gone
    (the table's interior is wiped out).  Hand them to torch as
    ``.view(np.int32)``."""
    from repro_torch.core.bitset import WORD_BITS, np_from_bounds
    off = cm.dom_off.cpu().numpy()
    track = cm.dom_track.cpu().numpy() != 0
    W = cm.n_words
    dom = np_from_bounds(lbs, ubs, off, W, track=track)
    n, V = lbs.shape
    vals = off[None, :, None] + np.arange(WORD_BITS * W)[None, None, :]
    interior = ((vals > lbs[:, :, None]) & (vals < ubs[:, :, None])
                & track[None, :, None])                     # [n, V, 32W]
    clear = interior & (rng.random(interior.shape) < 0.25)
    if cm.n_table:
        ct_vars = cm.ct_vars.cpu().numpy()
        ct_mask = cm.ct_mask.cpu().numpy() != 0
        for i in range(min(n_wipe, n)):
            t = int(rng.integers(0, cm.n_table))
            members = ct_vars[t][ct_mask[t]]
            clear[i, members] = interior[i, members]
    weights = np.uint64(1) << np.arange(WORD_BITS, dtype=np.uint64)
    bits = (clear.reshape(n, V, W, WORD_BITS).astype(np.uint64)
            * weights).sum(-1).astype(np.uint32)
    return dom & ~bits


def search_inputs(cm, n_lanes: int, eps_target, opts, pool=None):
    """The inputs of one resident launch at the start of a solve, as
    `Solver` makes them: the EPS pool (`pool`, or decomposed to
    `eps_target`) padded to its bucket with failed stores, fresh lanes,
    the neutral bound and pool cursor 0 — on the model's device.
    Returns (subs_lb, subs_ub, st, gbest, pool_head)."""
    import torch

    from repro_torch.core import eps
    from repro_torch.core import search as S
    from repro_torch.core.api import _bucket
    lb, ub = pool if pool is not None else eps.decompose(cm, eps_target,
                                                         opts)
    lb, ub = eps.pad_pool(lb, ub, _bucket(lb.shape[0]))
    dev = cm.device
    big = torch.iinfo(cm.tdtype).max // 4
    return (torch.from_numpy(np.array(lb)).to(dev),
            torch.from_numpy(np.array(ub)).to(dev),
            S.init_lanes(cm, n_lanes, opts),
            torch.tensor(big, dtype=cm.tdtype, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev))


def search_diff(ref, got) -> list:
    """Names of what differs between two ``(st, gbest, it, pool_head,
    stopped)`` results of a resident launch: every LaneState field
    (values, dtypes and shapes), then the bound, the superstep count,
    the pool cursor (a scalar, or ``[n_tiles]`` cursors of a lane-tiled
    launch, compared with their shape) and the stop flag."""
    import torch
    ref_st, got_st = ref[0], got[0]
    bad = []
    for f in ref_st._fields:
        a, b = getattr(ref_st, f), getattr(got_st, f)
        if a is None or b is None:
            if (a is None) != (b is None):
                bad.append(f)
        elif a.dtype != b.dtype or not torch.equal(a.cpu(), b.cpu()):
            bad.append(f)
    for name, a, b in zip(("gbest", "it", "pool_head", "stopped"),
                          ref[1:], got[1:]):
        a, b = torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu()
        if a.shape != b.shape or not torch.equal(a.long(), b.long()):
            bad.append(name)
    return bad
