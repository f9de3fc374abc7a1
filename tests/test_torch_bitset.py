"""The port's lattice and bitset primitives (`repro_torch.core.lattice`,
`repro_torch.core.bitset`) against the JAX package's.

Same seeded inputs → equal results: words compared as int32 bit
patterns (the port carries ``uint32`` words as ``int32``, the reference's
through ``.view(np.int32)``), counts and positions as values.  The
inputs include words with bit 31 set, empty and full domains, and
``W`` = 1, 2 and 6.  The laws of ``tests/test_bitset_props.py`` and
``tests/test_lattice_props.py`` are checked on the port's functions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitset as JB
from repro.core import lattice as JL
from repro_torch.core import bitset as TB
from repro_torch.core import lattice as TL

SEEDS = [0, 1, 2]
CORNERS = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0xAAAAAAAA, 0x55555555,
                    0x7FFFFFFF, 0xFFFE0001, 0x80000001, 0x40000000],
                   dtype=np.uint64).astype(np.uint32)


def _words(seed, shape=(96,)):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2 ** 32, size=shape, dtype=np.uint64).astype(
        np.uint32)
    w.flat[:CORNERS.size] = CORNERS[:min(CORNERS.size, w.size)]
    return w


def _doms(seed, n_vars=16, n_words=2):
    rng = np.random.default_rng(seed)
    dom = rng.integers(0, 2 ** 32, size=(n_vars, n_words),
                       dtype=np.uint64).astype(np.uint32)
    dom[0] = 0                                    # an empty domain
    dom[1] = JB.FULL                              # a full domain
    dom[2] = np.uint32(0x80000000)                # only bit 31
    mask = rng.random((n_vars, n_words)) < 0.3
    dom[3:] &= np.where(mask[3:], np.uint32(0x01010101), JB.FULL)
    return dom


def _t(words):
    """uint32 numpy words → the port's int32 bit-pattern tensor."""
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


def _eq_words(got, ref):
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref).view(np.int32))


def _eq_values(got, ref):
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  np.asarray(ref).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_swar_primitives_match_jax(seed):
    w = _words(seed)
    for name in ("popcount", "ctz", "clz"):
        got = getattr(TB, name)(_t(w))
        assert got.dtype == torch.int32
        _eq_values(got, getattr(JB, name)(jnp.asarray(w)))
    ref_pop = np.array([bin(int(x)).count("1") for x in w])
    np.testing.assert_array_equal(TB.popcount(_t(w)).numpy(), ref_pop)


def test_low_mask_matches_jax():
    ns = np.arange(-3, 36)
    _eq_words(TB.low_mask(torch.from_numpy(ns)),
              JB.low_mask(jnp.asarray(ns)))


@pytest.mark.parametrize("seed", SEEDS)
def test_join_matches_jax(seed):
    a, b = _words(seed, (24, 3)), _words(seed + 50, (24, 3))
    ta, tb = _t(a), _t(b)
    _eq_words(TB.join(ta, tb), JB.join(jnp.asarray(a), jnp.asarray(b)))
    # the laws: ⊔ is ACI and extensive (a's value set holds a ⊔ b's)
    c = _t(_words(seed + 100, (24, 3)))
    assert torch.equal(TB.join(ta, tb), TB.join(tb, ta))
    assert torch.equal(TB.join(TB.join(ta, tb), c),
                       TB.join(ta, TB.join(tb, c)))
    assert torch.equal(TB.join(ta, ta), ta)
    assert bool((TB.join(ta, tb) & ~ta == 0).all())


@pytest.mark.parametrize("n_words", [1, 2, 6])
@pytest.mark.parametrize("seed", SEEDS)
def test_count_and_hull_match_jax(seed, n_words):
    dom = _doms(seed, n_words=n_words)
    off = np.random.default_rng(seed).integers(-40, 40, size=dom.shape[0]
                                               ).astype(np.int32)
    td, jd = _t(dom), jnp.asarray(dom)
    _eq_values(TB.count(td), JB.count(jd))
    assert int(TB.count(td)[0]) == 0 and int(TB.count(td)[1]) == 32 * n_words
    toff = torch.from_numpy(off)
    for got, ref in zip(TB.to_bounds(td, toff),
                        JB.to_bounds(jd, jnp.asarray(off))):
        assert got.dtype == torch.int32
        _eq_values(got, ref)
    lo, hi = TB.to_bounds(td, toff)
    assert int(lo[0]) == off[0] + 32 * n_words and int(hi[0]) == off[0] - 1


@pytest.mark.parametrize("n_words", [1, 2, 6])
@pytest.mark.parametrize("seed", SEEDS)
def test_from_bounds_matches_jax(seed, n_words):
    rng = np.random.default_rng(seed)
    n = 24
    off = rng.integers(-50, 50, size=n).astype(np.int32)
    lb = (off + rng.integers(-2, 32 * n_words + 2, size=n)).astype(np.int32)
    ub = (lb + rng.integers(-3, 32 * n_words, size=n)).astype(np.int32)
    track = (rng.random(n) < 0.7).astype(np.uint32)
    args_t = [torch.from_numpy(a) for a in (lb, ub, off)]
    args_j = [jnp.asarray(a) for a in (lb, ub, off)]
    for tr in (None, track):
        got = TB.from_bounds(*args_t, n_words,
                             track=None if tr is None
                             else torch.from_numpy(tr.view(np.int32)))
        ref = JB.from_bounds(*args_j, n_words,
                             track=None if tr is None else jnp.asarray(tr))
        _eq_words(got, ref)
        _eq_words(got, JB.np_from_bounds(lb, ub, off, n_words, track=tr))
    # the Galois connection: to_bounds(from_bounds(l, u)) == (l, u)
    lbc = np.clip(lb, off, off + 32 * n_words - 1)
    ubc = np.clip(ub, lbc - 1, off + 32 * n_words - 1)
    lo, hi = TB.to_bounds(TB.from_bounds(torch.from_numpy(lbc),
                                         torch.from_numpy(ubc),
                                         torch.from_numpy(off), n_words),
                          torch.from_numpy(off))
    ok = lbc <= ubc
    np.testing.assert_array_equal(lo.numpy()[ok], lbc[ok])
    np.testing.assert_array_equal(hi.numpy()[ok], ubc[ok])
    assert (lo.numpy()[~ok] > hi.numpy()[~ok]).all()


def test_host_mirrors_are_the_reference():
    """The port's ``np_*`` mirrors equal the JAX package's."""
    dom = _doms(4, n_words=3)
    off = np.arange(dom.shape[0]) - 5
    np.testing.assert_array_equal(TB.np_popcount(dom), JB.np_popcount(dom))
    np.testing.assert_array_equal(TB.np_count(dom), JB.np_count(dom))
    np.testing.assert_array_equal(TB.np_is_empty(dom), JB.np_is_empty(dom))
    for g, r in zip(TB.np_to_bounds(dom, off), JB.np_to_bounds(dom, off)):
        np.testing.assert_array_equal(g, r)
    vals = off + 7
    np.testing.assert_array_equal(TB.np_has_value(dom, vals, off),
                                  JB.np_has_value(dom, vals, off))
    np.testing.assert_array_equal(TB.np_clear_value(dom, vals, off),
                                  JB.np_clear_value(dom, vals, off))


@pytest.mark.parametrize("seed", SEEDS)
def test_lattice_matches_jax(seed):
    rng = np.random.default_rng(seed)
    la, ua, lb_, ub_ = (rng.integers(-20, 20, size=12).astype(np.int32)
                        for _ in range(4))
    t = [torch.from_numpy(a) for a in (la, ua, lb_, ub_)]
    j = [jnp.asarray(a) for a in (la, ua, lb_, ub_)]
    for got, ref in zip(TL.iz_join(*t), JL.iz_join(*j)):
        _eq_values(got, ref)
    for name in ("zinc_join", "zdec_join"):
        _eq_values(getattr(TL, name)(t[0], t[2]),
                   getattr(JL, name)(j[0], j[2]))
    for name in ("is_empty", "is_fixed"):
        np.testing.assert_array_equal(
            getattr(TL, name)(t[0], t[1]).numpy(),
            np.asarray(getattr(JL, name)(j[0], j[1])))
    assert bool(TL.any_failed(t[0], t[1])) == bool(JL.any_failed(j[0], j[1]))
    assert bool(TL.any_failed(la, ua)) == bool(JL.any_failed(j[0], j[1]))
    # the laws: join commutative, idempotent and extensive (its interval
    # lies inside both arguments')
    l1, u1 = TL.iz_join(*t)
    l2, u2 = TL.iz_join(t[2], t[3], t[0], t[1])
    assert torch.equal(l1, l2) and torch.equal(u1, u2)
    assert bool(JL.iz_leq(j[0], j[1], jnp.asarray(l1.numpy()),
                          jnp.asarray(u1.numpy())).all())
    l3, u3 = TL.iz_join(t[0], t[1], t[0], t[1])
    assert torch.equal(l3, t[0]) and torch.equal(u3, t[1])
