"""The port's semantics layer against the JAX package (DESIGN.md §6).

The reference's properties of ``tests/test_semantics.py`` on the port,
each also held equal to the JAX function on the same model and store
(the model compiled by the JAX package and carried across with
`port_from_jax`; stores from the seeded `util.random_substores`):

Thm 2   — fix D(P) is extensive, monotone and idempotent;
Prop 3  — fix D(seq P) == fix D(P) (`sequential_fixpoint` == `fixpoint`);
Thm 6   — every fair schedule reaches the same fixpoint;
GNF     — one gather sweep == one scatter sweep (`sweep` ==
          `sweep_scatter`), bit for bit.

`sequential_fixpoint`, `apply_one`, `propagator_candidates`, `sweep`,
`sweep_batch` and `sweep_scatter` equal their JAX counterparts exactly,
as do the lattice and bitset additions (`inf_for`, the order relations,
`all_fixed`, `clamp`, the boolean views, `np_iz_join`; `meet`, `leq`,
`is_empty`, `has_value`) and `search.dispatch_pool`.  The stores are an
integer lattice: equality is exact, no tolerance applies.  Seeds drive
every case (numpy), so the cases are the same on every run.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import bitset as JB
from repro.core import fixpoint as JF
from repro.core import lattice as JL
from repro.core import search as JS
from repro.core.model import Model as JModel
from repro_torch.core import bitset as TB
from repro_torch.core import fixpoint as TF
from repro_torch.core import lattice as TL
from repro_torch.core import search as TS
from repro_torch.core.model import Model
from test_torch_compile import port_from_jax
from util import random_model, random_substores

torch.set_num_threads(1)      # tiny tensors: thread hand-offs cost more

SEEDS = list(range(8))


def _case(seed, n=1):
    """(JAX model, port model, lbs, ubs) of one seed."""
    rng = np.random.default_rng(seed)
    jcm = random_model(rng).compile()
    lbs, ubs = random_substores(rng, jcm, n)
    return jcm, port_from_jax(jcm), lbs, ubs, rng


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _eq(got, ref, what=""):
    """A port tensor equal to a JAX/numpy array in values and dtype."""
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.dtype == ref.dtype, what
    np.testing.assert_array_equal(got, ref, err_msg=what)


def _fix(cm, lb, ub):
    lb, ub, _, _ = TF.fixpoint(cm, _t(lb), _t(ub), stop_on_fail=False)
    return lb, ub


def _agree(a, b):
    """Comparison spec (kernels/ops.py): equal failed flag; exact equality
    when not failed (the sequential form signals a plain row's failure
    through the TRUE var, the parallel one through the term bounds)."""
    (la, ua), (lb_, ub_) = a, b
    fa, fb = bool((la > ua).any()), bool((lb_ > ub_).any())
    if fa or fb:
        return fa == fb
    return torch.equal(la, lb_) and torch.equal(ua, ub_)


@pytest.mark.parametrize("seed", SEEDS)
def test_closure_operator(seed):
    """Thm 2: extensive and idempotent, and equal to JAX's fixpoint."""
    jcm, cm, lb, ub, _ = _case(seed)
    l1, u1 = _fix(cm, lb[0], ub[0])
    assert (l1.numpy() >= lb[0]).all() and (u1.numpy() <= ub[0]).all()
    l2, u2 = _fix(cm, l1, u1)
    assert torch.equal(l1, l2) and torch.equal(u1, u2)
    ref = JF.fixpoint(jcm, jnp.asarray(lb[0]), jnp.asarray(ub[0]),
                      stop_on_fail=False)
    _eq(l1, ref[0], "lb")
    _eq(u1, ref[1], "ub")


@pytest.mark.parametrize("seed", SEEDS)
def test_monotone(seed):
    """Thm 2: s ≤ s' ⇒ fix(s) ≤ fix(s') (≤ = information order)."""
    jcm, cm, lb, ub, rng = _case(seed)
    lb2, ub2 = lb[0].copy(), ub[0].copy()
    for _ in range(3):
        v = int(rng.integers(1, cm.n_vars))
        if lb2[v] < ub2[v]:
            lb2[v] += 1
    l1, u1 = _fix(cm, lb[0], ub[0])
    l2, u2 = _fix(cm, lb2, ub2)
    assert bool(TL.iz_leq(l1, u1, l2, u2).all())


@pytest.mark.parametrize("seed", SEEDS)
def test_prop3_seq_equals_par(seed):
    """Prop 3: program-order chaotic iteration reaches the parallel sweep
    fixpoint, and equals JAX's `sequential_fixpoint` exactly."""
    jcm, cm, lb, ub, _ = _case(seed)
    lp, up = _fix(cm, lb[0], ub[0])
    ls, us = TF.sequential_fixpoint(cm, lb[0], ub[0])
    assert _agree((lp, up), (ls, us))
    ref = JF.sequential_fixpoint(jcm, lb[0], ub[0])
    _eq(ls, ref[0], "lb")
    _eq(us, ref[1], "ub")


@pytest.mark.parametrize("seed", SEEDS)
def test_thm6_fair_schedules_agree(seed):
    """Thm 6: a random round-robin permutation converges to the program
    order's fixpoint (exactly) and to the parallel sweep's, and equals
    JAX's `sequential_fixpoint` under the same order."""
    jcm, cm, lb, ub, _ = _case(seed)
    order = list(np.random.default_rng(100 + seed).permutation(cm.n_props))
    lf, uf = TF.sequential_fixpoint(cm, lb[0], ub[0], order=order)
    ls, us = TF.sequential_fixpoint(cm, lb[0], ub[0])
    assert torch.equal(lf, ls) and torch.equal(uf, us)
    assert _agree(_fix(cm, lb[0], ub[0]), (lf, uf))
    ref = JF.sequential_fixpoint(jcm, lb[0], ub[0], order=order)
    _eq(lf, ref[0], "lb")
    _eq(uf, ref[1], "ub")


@pytest.mark.parametrize("seed", SEEDS)
def test_gnf_gather_equals_scatter_sweep(seed):
    """One gather sweep == one scatter sweep, bit for bit, failed stores
    included; each equal to JAX's `sweep` and `sweep_scatter`, and the
    batched forms to the single-store ones."""
    jcm, cm, lbs, ubs, _ = _case(seed, 4)
    for lb, ub in zip(lbs, ubs):
        g = TF.sweep(cm, _t(lb), _t(ub))
        sc = TF.sweep_scatter(cm, _t(lb), _t(ub))
        assert torch.equal(g[0], sc[0]) and torch.equal(g[1], sc[1])
        jg = JF.sweep(jcm, jnp.asarray(lb), jnp.asarray(ub))
        jsc = JF.sweep_scatter(jcm, jnp.asarray(lb), jnp.asarray(ub))
        for got, ref, name in zip(g + sc, jg + jsc, ("lb", "ub") * 2):
            _eq(got, ref, name)
    gb = TF.sweep_batch(cm, _t(lbs), _t(ubs))
    sb = TF.sweep_scatter_batch(cm, _t(lbs), _t(ubs))
    jgb = JF.sweep_batch(jcm, jnp.asarray(lbs), jnp.asarray(ubs))
    for got, alt, ref in zip(gb, sb, jgb):
        _eq(got, ref)
        assert torch.equal(got, alt)


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_apply_one_and_candidates_match_jax(seed):
    """`propagator_candidates` and every row's `apply_one` (one SELECT
    transition) equal the reference's on the same store."""
    jcm, cm, lbs, ubs, _ = _case(seed, 2)
    for lb, ub in zip(lbs, ubs):
        got = TF.propagator_candidates(cm, _t(lb), _t(ub))
        ref = JF.propagator_candidates(jcm, jnp.asarray(lb), jnp.asarray(ub))
        for g, r in zip(got, ref):
            _eq(g, r)
        for p in range(cm.n_props):
            got = TF.apply_one(cm, _t(lb), _t(ub), p)
            ref = JF.apply_one(jcm, jnp.asarray(lb), jnp.asarray(ub),
                               jnp.asarray(p))
            for g, r, name in zip(got, ref, ("lb", "ub")):
                _eq(g, r, f"row {p} {name}")


def test_sequential_fixpoint_raises_when_cut():
    jcm, cm, lb, ub, _ = _case(0)
    with pytest.raises(RuntimeError, match="did not converge"):
        TF.sequential_fixpoint(cm, cm.lb0, cm.ub0, max_rounds=0)


def _reif_model(cls):
    m = cls()
    x = m.int_var(0, 10, "x")
    b = m.reify(x <= 3)
    return m, x, b


def test_ask_guard_blocks_until_told():
    """ask semantics: a reified propagator prunes nothing until its guard
    is entailed; the port equals the reference at each step."""
    m, x, b = _reif_model(Model)
    cm = m.compile(device="cpu")
    jcm = _reif_model(JModel)[0].compile()
    lb0, ub0 = cm.lb0.numpy(), cm.ub0.numpy()
    told_true, told_false = lb0.copy(), ub0.copy()
    told_true[b.idx] = 1
    told_false[b.idx] = 0
    for lb, ub, want in ((lb0, ub0, (0, 10)), (told_true, ub0, (0, 3)),
                         (lb0, told_false, (4, 10))):
        l, u, _, _ = TF.fixpoint(cm, _t(lb), _t(ub))
        assert (int(l[x.idx]), int(u[x.idx])) == want
        ref = JF.fixpoint(jcm, jnp.asarray(lb), jnp.asarray(ub))
        _eq(l, ref[0])
        _eq(u, ref[1])
    l, u, _, _ = TF.fixpoint(cm, cm.lb0, cm.ub0)
    assert (int(l[b.idx]), int(u[b.idx])) == (0, 1)


def test_entailment_monotone_lemma1():
    """Lemma 1: entailment is decided at the root when the row's maximum
    already satisfies it."""
    m = Model()
    x = m.int_var(0, 10, "x")
    y = m.int_var(0, 10, "y")
    b = m.reify(x + y <= 20)
    cm = m.compile(device="cpu")
    l, _, _, _ = TF.fixpoint(cm, cm.lb0, cm.ub0)
    assert int(l[b.idx]) == 1


# --- lattice and bitset additions ------------------------------------------

@pytest.mark.parametrize("seed", SEEDS[:4])
def test_lattice_additions_match_jax(seed):
    rng = np.random.default_rng(seed)
    la, ua, lb_, ub_ = (rng.integers(-6, 6, size=16).astype(np.int32)
                        for _ in range(4))
    t = [_t(a) for a in (la, ua, lb_, ub_)]
    j = [jnp.asarray(a) for a in (la, ua, lb_, ub_)]
    for name in ("zinc_leq", "zdec_leq"):
        _eq(getattr(TL, name)(t[0], t[2]), getattr(JL, name)(j[0], j[2]),
            name)
    _eq(TL.iz_leq(*t), JL.iz_leq(*j), "iz_leq")
    for lo, hi in ((t[0], t[1]), (t[0], t[0])):
        assert bool(TL.all_fixed(lo, hi)) == bool(
            JL.all_fixed(jnp.asarray(lo.numpy()), jnp.asarray(hi.numpy())))
    for idx in (3, [1, 5, 7]):
        _eq(TL.bool_true(t[0], t[1], idx), JL.bool_true(j[0], j[1], idx))
        _eq(TL.bool_false(t[0], t[1], idx), JL.bool_false(j[0], j[1], idx))
    for got, ref in zip(TL.np_iz_join(la, ua, lb_, ub_),
                        JL.np_iz_join(la, ua, lb_, ub_)):
        _eq(got, ref)
    wide = rng.integers(-2 ** 45, 2 ** 45, size=16, dtype=np.int64)
    for dtype, jdtype in ((torch.int32, jnp.int32),
                          (torch.int64, jnp.int64)):
        assert TL.inf_for(dtype) == JL.inf_for(jdtype)
        assert TL.inf_for(np.dtype(jdtype)) == JL.inf_for(jdtype)
    assert TL.inf_for("int64") == JL.INF64 and TL.inf_for("int32") == \
        JL.INF32
    # clamp: into [-INF, INF] of the dtype (int32 values; the int64 case
    # against numpy, since the tier-1 run keeps JAX at 32 bits)
    _eq(TL.clamp(_t(wide.astype(np.int32) >> 8), torch.int32),
        JL.clamp(jnp.asarray(wide.astype(np.int32) >> 8), jnp.int32))
    _eq(TL.clamp(_t(wide), torch.int64),
        np.clip(wide, -JL.INF64, JL.INF64))


def _words(seed, shape):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2 ** 32, size=shape, dtype=np.uint64)
    w.flat[:4] = [0, 0xFFFFFFFF, 0x80000000, 1]
    return w.astype(np.uint32)


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_bitset_additions_match_jax(seed):
    """`meet`, `leq`, `is_empty` and `has_value` on ``[V, W]`` words (the
    port's int32 bit patterns against the reference's uint32)."""
    a, b = _words(seed, (12, 2)), _words(seed + 50, (12, 2))
    a[3] = 0
    b[4] = b[4] & a[4]                       # b ⊆ a on one row
    ta, tb = _t(a.view(np.int32)), _t(b.view(np.int32))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    _eq(TB.meet(ta, tb), np.asarray(JB.meet(ja, jb)).view(np.int32))
    _eq(TB.leq(ta, tb), JB.leq(ja, jb))
    _eq(TB.leq(ta, TB.join(ta, tb)), JB.leq(ja, JB.join(ja, jb)))
    _eq(TB.is_empty(ta), JB.is_empty(ja))
    rng = np.random.default_rng(seed)
    off = rng.integers(-5, 5, size=12).astype(np.int32)
    for val in (off + rng.integers(-3, 70, size=12).astype(np.int32),
                off + 7, off - 1, off + 64):
        _eq(TB.has_value(ta, _t(val), _t(off)),
            JB.has_value(ja, jnp.asarray(val), jnp.asarray(off)))
    # a batch of stores: one value per lane and var, the shared offsets
    # broadcast over the lanes (the reference takes them at full shape)
    batch = _words(seed + 9, (3, 12, 2))
    vals = off + rng.integers(-2, 66, size=(3, 12)).astype(np.int32)
    _eq(TB.has_value(_t(batch.view(np.int32)), _t(vals), _t(off)),
        JB.has_value(jnp.asarray(batch), jnp.asarray(vals),
                     jnp.asarray(np.broadcast_to(off, vals.shape))))


# --- search.dispatch_pool --------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS[:4])
def test_dispatch_pool_matches_jax(seed):
    """The single-queue dispatch on lanes with random fresh/done/cursor
    state, for a pool that runs out part-way and one that does not."""
    jcm, cm, _, _, rng = _case(seed)
    n = 12
    jst = JS.init_lanes(jcm, n, JS.SearchOptions())
    st = TS.init_lanes(cm, n, TS.SearchOptions(backend="gather"))
    fresh = rng.random(n) < 0.7
    done = rng.random(n) < 0.2
    n_subs = 9
    nxt = np.where(rng.random(n) < 0.5, rng.integers(0, n_subs, n),
                   TS.UNASSIGNED).astype(np.int32)
    jst = jst._replace(fresh=jnp.asarray(fresh), done=jnp.asarray(done),
                       next_sub=jnp.asarray(nxt))
    st = st._replace(fresh=_t(fresh), done=_t(done), next_sub=_t(nxt))
    for head in (0, 5, n_subs):
        got_st, got_head = TS.dispatch_pool(
            st, torch.tensor(head, dtype=torch.int32), n_subs)
        ref_st, ref_head = JS.dispatch_pool(jst, jnp.asarray(head,
                                                             jnp.int32),
                                            n_subs)
        _eq(got_head, ref_head, "pool_head")
        for f in ("next_sub", "done"):
            _eq(getattr(got_st, f), getattr(ref_st, f), f)
