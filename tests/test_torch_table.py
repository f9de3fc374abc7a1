"""The port's Compact-Table bank, bitset store and ``middle_out``
branching against the JAX package's.

Identical tables (carried across with `from_arrays`, or compiled on both
sides from the same hand-built model), identical inputs (seeded numpy;
the bitset words as int32 bit patterns on the port's side and ``uint32``
on the reference's) → identical results, compared exactly:

* `to_arrays`/`from_arrays` round-trip the Compact-Table tables;
* per sweep: `ct_candidates_tile`, `_gather_join_dom`,
  `dom_normalize_tile` and `sweep_tile` with a carried store and with
  the transient one, on crossword and configuration small and bench and
  on the hand cases of `repro_torch.testing` (chain filtering, holes that
  bounds cannot see, a wipeout, a mixed model, tables of more than 32
  tuples), from random stores whose words have random holes, some
  wiping out a table's interior under an intact hull;
* `fixpoint_batch(dom=...)` capped at 1 and 4 sweeps and uncapped
  against JAX's gather `fixpoint_batch`, and against `fixpoint_pallas`
  in interpret mode;
* the `LaneState` (dom and root_dom included) after 1, 4 and 16
  `lanes_step` supersteps under ``middle_out`` and on table models, and
  `search_plain` against JAX `search_pallas(..., lane_tile=0,
  interpret=True)` on crossword small;
* `SolveResult` of the three port backends (on CPU tensors: the plain
  versions) against JAX's on crossword and configuration small under
  ``min`` and ``middle_out``, and on N-queens, coloring and RCPSP small
  under ``middle_out``;
* ``middle_out`` on a model with no tracked branch variable equals
  ``split`` (the port's contract, where the reference's selection reads
  the pinned words; both agree wherever every branch variable is
  tracked).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import solver as jsolver
from repro.core import fixpoint as JF
from repro.core import models as jzoo
from repro.core import search as JS
from repro.core.api import _bucket
from repro.core.eps import decompose as jdecompose, pad_pool
from repro.core.model import Model as JModel
from repro.kernels import fixpoint_kernel as JFK
from repro_torch import solver as tsolver
from repro_torch.core import bitset as TB
from repro_torch.core import fixpoint as TF
from repro_torch.core import models as tzoo
from repro_torch.core import search as TS
from repro_torch.core.model import Model as TModel
from repro_torch.kernels import fixpoint_kernel as TFK
from repro_torch.testing import CT_HAND_MODELS, random_dom_stores
from test_torch_compile import port_from_jax
from test_torch_resident import _both
from test_torch_search import _assert_state_equal, _jax_state_arrays
from util import random_substores

torch.set_num_threads(1)      # small tensors: thread hand-offs cost more


def _zoo(name, tier):
    return jzoo.ZOO[name].build_model(tier(name, seed=0))[0].compile()


# name: JAX compile
MODELS = {
    "crossword_small": lambda: _zoo("crossword", jzoo.small_instance),
    "crossword_bench": lambda: _zoo("crossword", jzoo.bench_instance),
    "configuration_small": lambda: _zoo("configuration",
                                        jzoo.small_instance),
    "configuration_bench": lambda: _zoo("configuration",
                                        jzoo.bench_instance),
    **{name: (lambda make=make: make(JModel).compile())
       for name, make in CT_HAND_MODELS.items()},
}
_CACHE = {}


def _model(name):
    if name not in _CACHE:
        jcm = MODELS[name]()
        _CACHE[name] = (jcm, port_from_jax(jcm))
    return _CACHE[name]


def _inputs(jcm, lanes, seed):
    """Random stores (the root box first) and their random words, the
    first quarter wiping out a table's interior: (lbs, ubs, doms u32)."""
    rng = np.random.default_rng(seed)
    lbs, ubs = random_substores(rng, jcm, lanes)
    lbs[0], ubs[0] = np.asarray(jcm.lb0), np.asarray(jcm.ub0)
    doms = random_dom_stores(rng, port_from_jax(jcm), lbs, ubs,
                             n_wipe=lanes // 4)
    return lbs, ubs, doms


def _eq(got, ref, what):
    ref = np.asarray(ref)
    if ref.dtype == np.uint32:
        ref = ref.view(np.int32)
    assert str(got.dtype) == f"torch.{ref.dtype}", what
    np.testing.assert_array_equal(got.numpy(), ref, err_msg=what)


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                            else a.copy())


def test_hand_models_have_the_reference_tables():
    """The hand cases built with the port's `Model` compile to the JAX
    package's tables (so the other tests may carry either across), and
    the wide one has two support words per tuple set."""
    from test_torch_compile import jax_arrays
    from repro_torch.core.compile import to_arrays
    for name, make in CT_HAND_MODELS.items():
        ref_arrays, ref_statics = jax_arrays(make(JModel).compile())
        arrays, statics = to_arrays(make(TModel).compile(device="cpu"))
        assert statics == ref_statics, name
        for k, r in ref_arrays.items():
            assert arrays[k].dtype == r.dtype, (name, k)
            np.testing.assert_array_equal(arrays[k], r, err_msg=k)
    assert _model("wide")[1].ct_words == 2


def test_ct_tables_round_trip():
    """`to_arrays`/`from_arrays` carry the Compact-Table tables across
    unchanged, the ``uint32`` supports and tracked flags included."""
    from repro_torch.core.compile import from_arrays, to_arrays
    for name in ("configuration_bench", "wide"):
        jcm, tcm = _model(name)
        again = from_arrays(*to_arrays(tcm), "cpu")
        for f in ("ct_vars", "ct_mask", "ct_supp", "ct_occ_inst",
                  "ct_occ_pos", "dom_off", "dom_track"):
            got, ref = getattr(again, f), getattr(tcm, f)
            assert got.dtype == ref.dtype and torch.equal(got, ref), f
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(getattr(jcm, f)))
        assert again.ct_supp.dtype == torch.uint32
        assert (again.n_table, again.ct_words, again.n_words) == \
            (tcm.n_table, tcm.ct_words, tcm.n_words)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_ct_tiles_and_sweeps_match_jax(name):
    jcm, tcm = _model(name)
    lbs, ubs, doms = _inputs(jcm, 12, 3)
    jl, ju, jd = jnp.asarray(lbs), jnp.asarray(ubs), jnp.asarray(doms)
    tl, tu, td = _t(lbs), _t(ubs), _t(doms)
    tl2, tu2 = tl, tu
    jl2, ju2 = jl, ju
    tables, statics = TF.model_tables(tcm), TF.model_statics(tcm)
    args = ("ct_vars", "ct_mask", "ct_supp", "dom_off")
    for k in range(3):
        what = f"{name} sweep {k + 1}"
        ref = JF.ct_candidates_tile(jl, ju, jd, *(getattr(jcm, a)
                                                  for a in args),
                                    jcm.n_table)
        got = TF.ct_candidates_tile(tl, tu, td, tcm.ct_vars, tcm.ct_mask,
                                    tcm.ct_supp.view(torch.int32),
                                    tcm.dom_off, tcm.n_table)
        for side, r, g in zip(("lb", "ub", "dom"), ref, got):
            _eq(g, r, f"{what} ct {side}")
        _eq(TF._gather_join_dom(got[2], tcm.ct_occ_inst, tcm.ct_occ_pos,
                                td),
            JF._gather_join_dom(ref[2], jcm.ct_occ_inst, jcm.ct_occ_pos,
                                jd), f"{what} join")
        norm_args = (jcm.dom_off, jcm.dom_track, jcm.box_lo, jcm.box_hi)
        for g, r in zip(TF.dom_normalize_tile(
                tl, tu, td, tcm.dom_off, tcm.dom_track.view(torch.int32),
                tcm.box_lo, tcm.box_hi, tcm.n_words),
                JF.dom_normalize_tile(jl, ju, jd, *norm_args,
                                      jcm.n_words)):
            _eq(g, r, f"{what} normalize")
        # carried store (3-tuple) and transient range words (2-tuple)
        jl, ju, jd = JF.sweep_batch(jcm, jl, ju, dom=jd)
        tl, tu, td = TF.sweep_tile(tl, tu, *tables, **statics, dom=td)
        for side, g, r in zip(("lb", "ub", "dom"), (tl, tu, td),
                              (jl, ju, jd)):
            _eq(g, r, f"{what} {side}")
        jl2, ju2 = JF.sweep_batch(jcm, jl2, ju2)
        tl2, tu2 = TF.sweep_tile(tl2, tu2, *tables, **statics)
        _eq(tl2, jl2, f"{what} transient lb")
        _eq(tu2, ju2, f"{what} transient ub")


def test_hand_cases_filter_as_the_reference_says():
    """Chain filtering to x in [1, 3], y in [2, 4], z in [1, 2]; the hole
    at x = 2 keeps y = 5 out (y in {0, 7}); the wipeout fails its root."""
    for name in ("chain", "holes", "wipeout"):
        _, tcm = _model(name)
        lb, ub = tcm.lb0[None], tcm.ub0[None]
        dom = TB.from_bounds(lb, ub, tcm.dom_off, tcm.n_words,
                             track=tcm.dom_track.view(torch.int32))
        nlb, nub, ndom, _, conv = TF.fixpoint_batch(tcm, lb, ub, dom)
        if name == "chain":
            assert nlb[0, 1:4].tolist() == [1, 2, 1]
            assert nub[0, 1:4].tolist() == [3, 4, 2]
        elif name == "holes":
            y = 2
            assert (int(nlb[0, y]), int(nub[0, y])) == (0, 7)
            words = ndom[0, y].numpy().view(np.uint32)
            assert not TB.np_has_value(words, 5, int(tcm.dom_off[y]))
            assert TB.np_has_value(words, 7, int(tcm.dom_off[y]))
        else:
            assert bool((nlb > nub).any())


@pytest.mark.parametrize("max_iters", [1, 4, None])
@pytest.mark.parametrize("name", ["configuration_bench", "crossword_small",
                                  "mixed", "wide"])
def test_fixpoint_with_dom_matches_jax_gather(name, max_iters):
    jcm, tcm = _model(name)
    lbs, ubs, doms = _inputs(jcm, 16, 5)
    for d in (doms, None):
        ref = JF.fixpoint_batch(jcm, jnp.asarray(lbs), jnp.asarray(ubs),
                                None if d is None else jnp.asarray(d),
                                max_iters=max_iters)
        got = TF.fixpoint_batch(tcm, _t(lbs), _t(ubs),
                                None if d is None else _t(d),
                                max_iters=max_iters)
        assert len(got) == len(ref)
        for k, (r, g) in enumerate(zip(ref, got)):
            _eq(g, r, f"{name} max_iters={max_iters} dom={d is not None} "
                      f"output {k}")


@pytest.mark.parametrize("max_sweeps", [1, 16384])
def test_fixpoint_with_dom_matches_pallas_interpret(max_sweeps):
    jcm, tcm = _model("crossword_small")
    lbs, ubs, doms = _inputs(jcm, 8, 9)
    ref = JFK.fixpoint_pallas(jcm, jnp.asarray(lbs), jnp.asarray(ubs),
                              jnp.asarray(doms), lane_tile=8,
                              max_sweeps=max_sweeps, interpret=True)
    got = TF.fixpoint_batch(tcm, _t(lbs), _t(ubs), _t(doms),
                            max_iters=max_sweeps)
    for k, (r, g) in enumerate(zip(ref, got)):
        _eq(g, r, f"pallas max_sweeps={max_sweeps} output {k}")


def _step_both(jcm, tcm, opt_kw, n_lanes, steps, target):
    """JAX and the port side by side from one pool: the whole
    `LaneState` (the bitset store included), the bound and the pool
    cursor equal at every k in `steps`."""
    jopts = JS.SearchOptions(backend="gather", max_depth=64, **opt_kw)
    topts = TS.SearchOptions(backend="gather", max_depth=64, **opt_kw)
    lb, ub = jdecompose(jcm, target, jopts)
    lb, ub = pad_pool(lb, ub, _bucket(lb.shape[0]))
    jsl, jsu = jnp.asarray(lb), jnp.asarray(ub)
    tsl, tsu = _t(lb), _t(ub)
    big = np.iinfo(lb.dtype).max // 4
    jst = JS.init_lanes(jcm, n_lanes, jopts)
    tst = TS.init_lanes(tcm, n_lanes, topts)
    assert tst.dom is not None
    jg, jh = jnp.asarray(big, lb.dtype), jnp.asarray(0, jnp.int32)
    tg = torch.tensor(big, dtype=tst.lb.dtype)
    th = torch.zeros((), dtype=torch.int32)
    k = 0
    for target_k in steps:
        while k < target_k:
            jst, jh = JS.lanes_step(jcm, jsl, jsu, jopts, jst, jg, jh)
            jg = jnp.minimum(jg, jnp.min(jst.best_obj))
            tst, th = TS.lanes_step(tcm, tsl, tsu, topts, tst, tg, th)
            tg = torch.minimum(tg, tst.best_obj.min())
            k += 1
        _assert_state_equal(jst, tst, f"after {k} supersteps")
        assert int(tg) == int(jg) and int(th) == int(jh)
        tst = TS.lane_state_from_arrays(_jax_state_arrays(jst), "cpu")
    return jst


# name: (model, options)
STEP_CASES = {
    "crossword_bench_middle_out": ("crossword_bench",
                                   dict(var_strategy="min_dom",
                                        val_strategy="middle_out")),
    "configuration_bench_min_lb": ("configuration_bench",
                                   dict(var_strategy="min_lb")),
    "mixed_middle_out_capped": ("mixed", dict(val_strategy="middle_out",
                                              max_fixpoint_iters=1)),
    "nqueens_small_middle_out": ("nqueens", dict(var_strategy="min_dom",
                                                 val_strategy="middle_out")),
    "coloring_small_middle_out": ("coloring",
                                  dict(val_strategy="middle_out")),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_lanes_step_with_dom_matches_jax(case):
    name, opt_kw = STEP_CASES[case]
    jcm = (_model(name)[0] if name in MODELS
           else _zoo(name, jzoo.small_instance))
    jst = _step_both(jcm, port_from_jax(jcm), opt_kw, 8, (1, 4, 16), 16)
    assert int(np.asarray(jst.n_nodes).sum()) > 0


@pytest.mark.parametrize("val", ["min", "middle_out"])
def test_search_plain_with_dom_matches_search_pallas(val):
    jcm = _model("crossword_small")[0]
    opt_kw = dict(var_strategy="min_dom", val_strategy=val)
    jargs, targs = _both(jcm, 8, 16, 1, True, opt_kw)
    assert jargs[2].dom is not None and targs[2].dom is not None
    kw = dict(supersteps=4, var_strategy="min_dom", val_strategy=val)
    jst, jg, jit, jh, jstop = JFK.search_pallas(jcm, *jargs, lane_tile=0,
                                                interpret=True, **kw)
    tst, tg, tit, th, tstop = TFK.search_plain(port_from_jax(jcm), *targs,
                                               **kw)
    _assert_state_equal(jst, tst, f"search_pallas {val}")
    assert (int(tg), int(tit), int(th), bool(tstop)) == \
        (int(jg), int(jit), int(jh[0]), bool(jstop))


COUNTERS = ("status", "objective", "n_nodes", "n_fails", "n_sols",
            "n_sweeps", "n_supersteps", "complete")


@pytest.fixture(scope="module")
def jax_session():
    return jsolver.Solver()


@pytest.mark.parametrize("name,val", [
    ("crossword", "min"), ("crossword", "middle_out"),
    ("configuration", "min"), ("configuration", "middle_out"),
    ("nqueens", "middle_out"), ("coloring", "middle_out"),
    ("rcpsp", "middle_out")])
def test_smoke_solves_match_jax(jax_session, name, val):
    kw = dict(n_lanes=16, val_strategy=val)
    jm, _ = jzoo.ZOO[name].build_model(jzoo.small_instance(name, seed=0))
    ref = jax_session.solve(jm.compile(), config=jsolver.SolveConfig.preset(
        "prove", backend="gather", **kw))
    inst = tzoo.small_instance(name, seed=0)
    m, handles = tzoo.ZOO[name].build_model(inst)
    cm = m.compile(device="cpu")
    for backend in ("gather", "cuda", "cuda_resident"):
        res = tsolver.Solver(tsolver.SolveConfig.preset(
            "prove", backend=backend, device="cpu", **kw)).solve(cm)
        for c in COUNTERS:
            assert getattr(res, c) == getattr(ref, c), (backend, c)
        np.testing.assert_array_equal(res.solution, ref.solution)
        assert tzoo.ground_check(tzoo.ZOO[name], inst, handles, res) is True
    assert ref.status == "OPTIMAL"


def test_middle_out_without_tracked_branch_vars_equals_split():
    """RCPSP with 10 tasks: every start is wider than the 32-value
    bitset, so no branch variable is tracked and ``middle_out`` branches
    as ``split`` does, counter for counter.  The reference's selection
    reads the pinned all-ones words instead: once a start's lower bound
    is past its first 32 values it returns the start's initial lower
    bound, outside [lb, ub]; the port returns the midpoint."""
    m, _ = tzoo.rcpsp.build_model(tzoo.rcpsp.generate(
        n_tasks=10, n_resources=2, seed=0))
    cm = m.compile(device="cpu")
    bv = cm.branch_vars.long()
    assert int(cm.dom_track[bv].sum()) == 0
    got = {val: tsolver.Solver(tsolver.SolveConfig.preset(
        "prove", backend="gather", n_lanes=8, eps_target=16, device="cpu",
        val_strategy=val)).solve(cm) for val in ("split", "middle_out")}
    for c in COUNTERS:
        assert getattr(got["split"], c) == getattr(got["middle_out"], c), c
    assert got["split"].status == "OPTIMAL"
    # one store, its first start moved past the bitset window
    v = int(bv[0])
    lb, ub = cm.lb0.clone()[None], cm.ub0.clone()[None]
    lb[0, v] = int(cm.dom_off[v]) + 34
    dom = TB.from_bounds(lb, ub, cm.dom_off, cm.n_words,
                         track=cm.dom_track.view(torch.int32))
    kw = dict(var_strategy="input_order", dom=dom, dom_off=cm.dom_off)
    tvar, tm, _ = TS.select_branch_tile(
        lb, ub, cm.branch_vars, val_strategy="middle_out",
        dom_track=cm.dom_track.view(torch.int32), **kw)
    _, split_m, _ = TS.select_branch_tile(lb, ub, cm.branch_vars,
                                          var_strategy="input_order",
                                          val_strategy="split")
    assert int(tvar[0]) == v and int(tm[0]) == int(split_m[0])
    _, jm, _ = JS.select_branch_tile(
        jnp.asarray(lb.numpy()), jnp.asarray(ub.numpy()),
        jnp.asarray(cm.branch_vars.numpy()), var_strategy="input_order",
        val_strategy="middle_out",
        dom=jnp.asarray(dom.numpy().view(np.uint32)),
        dom_off=jnp.asarray(cm.dom_off.numpy()))
    assert int(jm[0]) == int(cm.dom_off[v]) < int(lb[0, v])
