"""The port's search and EPS (`repro_torch.core.search`, `.eps`) against JAX.

Identical tables (carried across with `from_arrays`) → identical EPS
pools from `eps.decompose`, and — from the same pool — a `LaneState`
equal field for field (values and dtypes; the bitset words as int32
bit patterns) after k `lanes_step` supersteps, under the ``min`` and
``split`` value strategies, capped and uncapped sweeps, on RCPSP and on
random linear models.  ``middle_out`` and the bitset store are held in
``test_torch_table.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import eps as jeps
from repro.core import search as JS
from repro.core.api import _bucket
from repro_torch.core import eps as teps
from repro_torch.core import search as TS
from test_torch_compile import bench, j30, port_from_jax, small
from test_torch_fixpoint import _jax_rcpsp
from util import random_model


def _opts(mod, backend, **kw):
    return mod.SearchOptions(backend=backend, **kw)


OPTS = {
    "prove": dict(var_strategy="min_lb", max_depth=64),
    "fast": dict(var_strategy="min_lb", max_depth=64, max_fixpoint_iters=4),
    "split": dict(var_strategy="min_dom", val_strategy="split",
                  max_depth=64),
    "input": dict(max_depth=64, max_fixpoint_iters=1),
}


# decompose propagates uncapped whatever the preset, so "fast" adds nothing
@pytest.mark.parametrize("name", ["input", "prove", "split"])
@pytest.mark.parametrize("tier,kw", [("small", small(0)), ("bench", bench(1)),
                                     ("j30", j30(2))],
                         ids=["small", "bench", "j30"])
def test_decompose_matches_jax(tier, kw, name):
    jcm = _jax_rcpsp(kw)
    tcm = port_from_jax(jcm)
    target = 24 if tier == "j30" else 32
    ref = jeps.decompose(jcm, target, _opts(JS, "gather", **OPTS[name]))
    for backend in ("gather", "cuda") if tier == "j30" else ("gather",):
        got = teps.decompose(tcm, target, _opts(TS, backend, **OPTS[name]))
        for r, g in zip(ref, got):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)


def test_decompose_failed_root_and_pool_helpers():
    rng = np.random.default_rng(4)
    jcm = random_model(rng, n_vars=5, n_props=9).compile()
    tcm = port_from_jax(jcm)
    for target in (1, 8, 64):
        ref = jeps.decompose(jcm, target)
        got = teps.decompose(tcm, target, TS.SearchOptions(backend="gather"))
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(g, r)
    lb, ub = ref
    for size in (lb.shape[0], lb.shape[0] + 3, _bucket(lb.shape[0] + 5)):
        for r, g in zip(jeps.pad_pool(lb, ub, size),
                        teps.pad_pool(lb, ub, size)):
            np.testing.assert_array_equal(g, r)
        for r, g in zip(jeps.fit_pool(lb, ub, size),
                        teps.fit_pool(lb, ub, size)):
            np.testing.assert_array_equal(g, r)
        for r, g in zip(jeps.failed_pool(lb, ub, size),
                        teps.failed_pool(lb, ub, size)):
            np.testing.assert_array_equal(g, r)
    with pytest.raises(ValueError, match="does not fit"):
        teps.fit_pool(lb, ub, lb.shape[0] - 1 or 0)


def _jax_state_arrays(st):
    return {f: (None if getattr(st, f) is None else np.asarray(getattr(st, f)))
            for f in JS.LaneState._fields}


def _assert_state_equal(jst, tst, where):
    """Every field equal in values and dtypes; the reference's ``uint32``
    bitset words against the port's int32 bit patterns."""
    for f in JS.LaneState._fields:
        r, g = getattr(jst, f), getattr(tst, f)
        if r is None:
            assert g is None, f"{where}: {f}"
            continue
        r, g = np.asarray(r), g.numpy()
        if r.dtype == np.uint32:
            r = r.view(np.int32)
        assert g.dtype == r.dtype, f"{where}: {f} {g.dtype} vs {r.dtype}"
        np.testing.assert_array_equal(g, r, err_msg=f"{where}: {f}")


def _pool(jcm, opts, target):
    lb, ub = jeps.decompose(jcm, target, opts)
    return jeps.pad_pool(lb, ub, _bucket(lb.shape[0]))


def _run_both(jcm, tcm, name, n_lanes, steps, target=32):
    """Step JAX and the port side by side from one pool, comparing the
    whole `LaneState`, the bound and the pool cursor at every k in
    `steps`; after each check the port goes on from JAX's state, carried
    across with `lane_state_from_arrays`."""
    jopts = _opts(JS, "gather", **OPTS[name])
    topts = _opts(TS, "gather", **OPTS[name])
    plb, pub = _pool(jcm, jopts, target)
    jsl, jsu = jnp.asarray(plb), jnp.asarray(pub)
    tsl, tsu = torch.from_numpy(np.array(plb)), torch.from_numpy(np.array(pub))
    big = np.iinfo(plb.dtype).max // 4
    jst = JS.init_lanes(jcm, n_lanes, jopts)
    jg, jh = jnp.asarray(big, plb.dtype), jnp.asarray(0, jnp.int32)
    tst = TS.init_lanes(tcm, n_lanes, topts)
    tg = torch.tensor(big, dtype=tst.lb.dtype)
    th = torch.zeros((), dtype=torch.int32)
    _assert_state_equal(jst, tst, "init")
    k = 0
    for target_k in steps:
        while k < target_k:
            jst, jh = JS.lanes_step(jcm, jsl, jsu, jopts, jst, jg, jh)
            jg = jnp.minimum(jg, jnp.min(jst.best_obj))
            tst, th = TS.lanes_step(tcm, tsl, tsu, topts, tst, tg, th)
            tg = torch.minimum(tg, tst.best_obj.min())
            k += 1
        _assert_state_equal(jst, tst, f"{name} after {k} supersteps")
        assert int(tg) == int(jg) and int(th) == int(jh)
        assert TS.lane_totals(tst) == JS.lane_totals(jst)
        # carry JAX's state across and keep going from it
        tst = TS.lane_state_from_arrays(_jax_state_arrays(jst), "cpu")
    return jst


@pytest.mark.parametrize("name", sorted(OPTS))
def test_lanes_step_matches_jax_rcpsp(name):
    jcm = _jax_rcpsp(bench(0))
    jst = _run_both(jcm, port_from_jax(jcm), name, n_lanes=8,
                    steps=(1, 4, 16))
    assert int(np.asarray(jst.n_nodes).sum()) > 0


def test_lanes_step_matches_jax_j30():
    jcm = _jax_rcpsp(j30(0))
    _run_both(jcm, port_from_jax(jcm), "fast", n_lanes=6, steps=(1, 4, 16),
              target=12)


@pytest.mark.parametrize("seed", range(3))
def test_lanes_step_matches_jax_random_linear(seed):
    rng = np.random.default_rng(100 + seed)
    jcm = random_model(rng, n_vars=6, n_props=10).compile()
    _run_both(jcm, port_from_jax(jcm), "split" if seed % 2 else "input",
              n_lanes=4, steps=(1, 4, 16), target=8)


@pytest.mark.parametrize("n_tiles", [1, 2, 3])
def test_dispatch_pool_tile_matches_jax(n_tiles):
    jcm = _jax_rcpsp(small(2))
    opts = JS.SearchOptions(max_depth=4)
    jst = JS.init_lanes(jcm, 7, opts)
    rng = np.random.default_rng(n_tiles)
    arrays = _jax_state_arrays(jst)
    arrays["fresh"] = rng.random(7) < 0.7
    arrays["done"] = rng.random(7) < 0.2
    arrays["next_sub"] = np.where(rng.random(7) < 0.5, JS.UNASSIGNED,
                                  rng.integers(0, 9, 7)).astype(np.int32)
    jst = JS.LaneState(**{k: (None if v is None else jnp.asarray(v))
                          for k, v in arrays.items()})
    tst = TS.lane_state_from_arrays(arrays, "cpu")
    for tile_id in range(n_tiles):
        for head in (0, 2, 5):
            jout, jh = JS.dispatch_pool_tile(jst, jnp.asarray(head, jnp.int32),
                                             9, tile_id, n_tiles)
            tout, th = TS.dispatch_pool_tile(
                tst, torch.tensor(head, dtype=torch.int32), 9, tile_id,
                n_tiles)
            _assert_state_equal(jout, tout, f"tile {tile_id} head {head}")
            assert int(th) == int(jh)


def test_lane_state_from_arrays_round_trip():
    jcm = _jax_rcpsp(small(1))
    st = JS.init_lanes(jcm, 3, JS.SearchOptions(max_depth=5))
    arrays = _jax_state_arrays(st)
    tst = TS.lane_state_from_arrays(arrays, "cpu")
    _assert_state_equal(st, tst, "round trip")
    assert tst.dom is None and tst.root_dom is None


def test_middle_out_raises_until_the_bitset_slice():
    """``middle_out`` raises no more: its lanes carry the bitset store,
    equal to the reference's from `init_lanes` on, and its EPS pool (an
    interval split at the midpoint) equals the reference's."""
    jcm = _jax_rcpsp(small(0))
    tcm = port_from_jax(jcm)
    kw = dict(val_strategy="middle_out", max_depth=8)
    jst = JS.init_lanes(jcm, 2, _opts(JS, "gather", **kw))
    tst = TS.init_lanes(tcm, 2, _opts(TS, "gather", **kw))
    assert tst.dom.shape == (2, tcm.n_vars, tcm.n_words)
    _assert_state_equal(jst, tst, "init middle_out")
    assert TS.use_dom(tcm, _opts(TS, "gather", **kw))
    assert not TS.use_dom(tcm, _opts(TS, "gather"))
    ref = jeps.decompose(jcm, 16, _opts(JS, "gather", **kw))
    got = teps.decompose(tcm, 16, _opts(TS, "gather", **kw))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)
