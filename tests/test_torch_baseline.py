"""The port's sequential baseline (`repro_torch.core.baseline`) against
the JAX package's.

The same tables (a JAX compile carried across with `port_from_jax`) and
the same `SearchOptions` → the same `SolveResult`: ``status``,
``objective``, ``n_nodes``, ``n_fails``, ``n_sols`` and ``solution``
(values and dtype), on

* the four RCPSP seeds of ``tests/test_solver.py``
  (``test_engine_matches_baseline_statuses``);
* the zoo's small instances under the options of ``tests/test_models.py``;
* the Compact-Table cases of ``tests/test_compact_table.py``
  (``test_sequential_baseline_agrees``) under ``min`` and ``middle_out``;
* RCPSP J30 seed 0, and J60 seed 0 cut by a ``node_budget`` (a
  deterministic cut);
* `SequentialSolver.propagate` on random substores (with and without a
  bitset store);

and its optimum equals the port's `Solver.solve` on the small
instances.  An int64 compile gives the int32 compile's result (the
values are the same, so the search is too).
"""

import numpy as np
import pytest
import torch

from repro.core import baseline as JBL
from repro.core import models as jzoo
from repro.core import search as JS
from repro_torch import solver as tsolver
from repro_torch.core import baseline as TBL
from repro_torch.core import bitset as TB
from repro_torch.core import models as tzoo
from repro_torch.core import search as TS
from repro_torch.testing import random_dom_stores
from test_torch_compile import j30, j60, port_from_jax
from util import random_substores

torch.set_num_threads(1)      # small tensors: thread hand-offs cost more

RESULT = ("status", "objective", "n_nodes", "n_fails", "n_sols", "complete")
# tests/test_solver.py and tests/test_models.py
OPTS = dict(var_strategy="min_lb", max_depth=256)


def _build(name, inst):
    return jzoo.ZOO[name].build_model(inst)[0].compile()


def _both(jcm, timeout_s=120, node_budget=None, **opts):
    """(JAX result, port result) of the same model and options."""
    ref = JBL.SequentialSolver(jcm, JS.SearchOptions(**opts)).solve(
        timeout_s=timeout_s, node_budget=node_budget)
    cm = port_from_jax(jcm)
    got = TBL.SequentialSolver(cm, TS.SearchOptions(**opts)).solve(
        timeout_s=timeout_s, node_budget=node_budget)
    for k in RESULT:
        assert getattr(got, k) == getattr(ref, k), k
    assert (got.solution is None) == (ref.solution is None)
    if ref.solution is not None:
        assert got.solution.dtype == ref.solution.dtype
        np.testing.assert_array_equal(got.solution, ref.solution)
    assert (got.n_sweeps, got.n_supersteps) == (0, 0)
    return cm, got


@pytest.mark.parametrize("seed", range(4))
def test_rcpsp_small_matches_jax(seed):
    jcm = _build("rcpsp", jzoo.rcpsp.generate(5, n_resources=2, seed=seed,
                                              edge_prob=0.3))
    cm, got = _both(jcm, **OPTS)
    assert got.status == "OPTIMAL"
    par = tsolver.Solver(tsolver.SolveConfig(
        n_lanes=4, eps_target=8, backend="gather", device="cpu",
        **OPTS)).solve(cm)
    assert par.status == "OPTIMAL" and par.objective == got.objective


@pytest.mark.parametrize("name", sorted(jzoo.ZOO))
def test_zoo_small_matches_jax(name):
    jcm = _build(name, jzoo.small_instance(name))
    cm, got = _both(jcm, **OPTS)
    assert got.status == "OPTIMAL"
    par = tsolver.Solver(tsolver.SolveConfig(
        n_lanes=8, eps_target=16, backend="gather", device="cpu",
        **OPTS)).solve(cm)
    assert par.status == "OPTIMAL" and par.objective == got.objective
    inst = tzoo.small_instance(name)
    _, handles = tzoo.ZOO[name].build_model(inst)
    assert tzoo.ground_check(tzoo.ZOO[name], inst, handles, got) is True


@pytest.mark.parametrize("val_strategy", ["min", "middle_out"])
@pytest.mark.parametrize("name", ["crossword", "configuration"])
def test_compact_table_matches_jax(name, val_strategy):
    jcm = _build(name, jzoo.small_instance(name, seed=1))
    cm, got = _both(jcm, val_strategy=val_strategy, **OPTS)
    assert got.status == "OPTIMAL"
    par = tsolver.Solver(tsolver.SolveConfig.preset(
        "prove", val_strategy=val_strategy, n_lanes=8, eps_target=16,
        max_depth=256, backend="gather", device="cpu")).solve(cm)
    assert par.status == "OPTIMAL" and par.objective == got.objective


def test_j30_matches_jax():
    jcm = _build("rcpsp", jzoo.rcpsp.generate(**j30(0)))
    _, got = _both(jcm, var_strategy="min_lb", max_depth=1024)
    assert (got.status, got.objective) == ("OPTIMAL", 34)


def test_j60_node_budget_matches_jax():
    """A deterministic cut: 100 nodes of J60 seed 0 leave an incumbent
    that is not yet proven."""
    jcm = _build("rcpsp", jzoo.rcpsp.generate(**j60(0)))
    _, got = _both(jcm, node_budget=100, var_strategy="min_lb",
                   max_depth=1024)
    assert got.status == "SAT" and not got.complete
    assert got.n_nodes == 100 and got.objective >= 82


@pytest.mark.parametrize("name", ["rcpsp", "nqueens", "crossword",
                                  "configuration"])
def test_propagate_matches_jax(name):
    """`propagate` on the root and random substores: the same verdict
    and the same stores (and bitset store) after the event loop."""
    jcm = _build(name, jzoo.bench_instance(name))
    cm = port_from_jax(jcm)
    ref_s = JBL.SequentialSolver(jcm, JS.SearchOptions())
    got_s = TBL.SequentialSolver(cm, TS.SearchOptions())
    rng = np.random.default_rng(4)
    lbs, ubs = random_substores(rng, jcm, 12)
    doms = (random_dom_stores(rng, cm, lbs, ubs, n_wipe=2)
            if cm.n_table else [None] * len(lbs))
    # the root store first, with its range words (it propagates without
    # failing)
    lb0, ub0 = np.asarray(jcm.lb0), np.asarray(jcm.ub0)
    lbs = np.concatenate([lb0[None], lbs])
    ubs = np.concatenate([ub0[None], ubs])
    if cm.n_table:
        doms = np.concatenate([TB.np_from_bounds(
            lb0, ub0, cm.dom_off.numpy(), cm.n_words,
            track=cm.dom_track.numpy())[None], doms])
    else:
        doms = doms + [None]
    verdicts = set()
    for lb, ub, dom in zip(lbs, ubs, doms):
        for dirty in (None, [int(rng.integers(1, cm.n_vars))]):
            r = [lb.copy(), ub.copy(), None if dom is None else dom.copy()]
            g = [a if a is None else a.copy() for a in r]
            ok = ref_s.propagate(*r, dirty=dirty)
            assert got_s.propagate(*g, dirty=dirty) == ok
            verdicts.add(ok)
            for a, b in zip(g, r):
                if b is not None:
                    np.testing.assert_array_equal(a, b)
    assert verdicts == {True, False}


def test_int64_compile_matches_int32():
    """`big` follows the model's dtype: J30 compiled to int64 gives the
    int32 compile's result, and the solution keeps int64."""
    from repro_torch.core.models import rcpsp
    m, _ = rcpsp.build_model(rcpsp.generate(**j30(0)))
    opts = TS.SearchOptions(var_strategy="min_lb", max_depth=1024)
    r32 = TBL.SequentialSolver(m.compile(device="cpu"), opts).solve()
    cm64 = m.compile(device="cpu", force_dtype="int64")
    assert cm64.dtype == "int64"
    r64 = TBL.SequentialSolver(cm64, opts).solve()
    for k in RESULT:
        assert getattr(r64, k) == getattr(r32, k), k
    assert r64.solution.dtype == np.int64
    np.testing.assert_array_equal(r64.solution, r32.solution)


def test_copies_the_tables_once():
    """The solver holds host numpy copies, made in `__init__`: the model's
    tensors are read once, not per node."""
    jcm = _build("knapsack", jzoo.small_instance("knapsack"))
    cm = port_from_jax(jcm)
    s = TBL.SequentialSolver(cm)
    for f in ("vidx", "coef", "rhs", "bidx", "box_lo", "box_hi",
              "branch_vars", "dom_off", "dom_track"):
        assert isinstance(getattr(s, f), np.ndarray), f
        np.testing.assert_array_equal(getattr(s, f),
                                      getattr(cm, f).numpy())
