"""The port's batched solving (`Solver.solve_many`, `LaneBatch`,
`BatchSnapshot`, the module-level `solve*`) against the JAX package's.

At the reference tests' size (``tests/test_serve.py`` SMALL: 4 lanes,
eps_target 8, chunk 8, max_depth 128), on `small_instance` of knapsack,
N-queens and jobshop from the same seeds:

* `solve_many` against JAX `solve_many`: the port's ``gather`` against
  JAX ``gather``, and the port's ``cuda_resident`` (on the CPU the slot
  wrapper runs `search_plain` slot by slot) against JAX
  ``pallas_resident`` (interpret mode, as ``tests/test_api.py`` runs
  it): status, objective and every counter, solutions ground-checked;
  the shape-mismatch error and the empty list.
* `LaneBatch` driven through the same splice/step/retire sequence as a
  JAX `LaneBatch` (the same pools): equal `BatchSnapshot` arrays every
  quantum and equal `retire` results — a mid-flight join, an early
  retire that never claims a proof, and slot misuse raising.
"""

import numpy as np
import pytest

from repro import solver as jsolver
from repro.core import eps as jeps
from repro.core import models as jzoo
from repro_torch import solver as tsolver
from repro_torch.core import models as tzoo
from repro_torch.kernels import fixpoint_kernel as TFK

SMALL = dict(n_lanes=4, eps_target=8, chunk=8, max_depth=128)
COUNTERS = ("status", "objective", "n_nodes", "n_fails", "n_sols",
            "n_sweeps", "n_supersteps", "complete")
# the port's backend -> the JAX package's
BACKENDS = {"gather": "gather", "cuda_resident": "pallas_resident"}
SNAP_FIELDS = ("superstep", "gdone", "best_obj", "has_sol", "n_nodes",
               "n_sols")


@pytest.fixture(scope="module")
def jax_session():
    """One JAX session for the file: its runner cache is keyed by shape
    and config, so each bucket compiles once."""
    return jsolver.Solver(jsolver.SolveConfig.preset("prove", **SMALL))


def _jcm(name, seed):
    m, _ = jzoo.ZOO[name].build_model(jzoo.small_instance(name, seed=seed))
    return m.compile()


def _tcase(name, seed):
    inst = tzoo.small_instance(name, seed=seed)
    m, handles = tzoo.ZOO[name].build_model(inst)
    return tzoo.ZOO[name], inst, handles, m.compile(device="cpu")


def _cfgs(backend="gather", **kw):
    kw = dict(SMALL, **kw)
    return (jsolver.SolveConfig.preset("prove", backend=BACKENDS[backend],
                                       **kw),
            tsolver.SolveConfig.preset("prove", backend=backend,
                                       device="cpu", **kw))


def _same_result(got, ref, what):
    for k in COUNTERS:
        assert getattr(got, k) == getattr(ref, k), (what, k)
    if ref.solution is None:
        assert got.solution is None, what
    else:
        np.testing.assert_array_equal(got.solution, ref.solution)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("name", ["knapsack", "nqueens", "jobshop"])
def test_solve_many_matches_jax(jax_session, name, backend):
    jcfg, tcfg = _cfgs(backend)
    ref = jax_session.solve_many([_jcm(name, s) for s in range(3)],
                                 config=jcfg)
    cases = [_tcase(name, s) for s in range(3)]
    before = TFK.search_cuda.launches
    got = tsolver.Solver(tcfg).solve_many([c[3] for c in cases])
    assert TFK.search_cuda.launches == before      # CPU: the plain version
    for i, (r, g, (mod, inst, handles, _)) in enumerate(zip(ref, got,
                                                            cases)):
        _same_result(g, r, (name, backend, i))
        assert g.status == tsolver.OPTIMAL
        assert tzoo.ground_check(mod, inst, handles, g)
    # the batch equals sequential solves too
    for g, c in zip(got, cases):
        _same_result(g, tsolver.Solver(tcfg).solve(c[3]), (name, "seq"))


def test_solve_many_shape_mismatch_and_empty():
    k, q = _tcase("knapsack", 0)[3], _tcase("nqueens", 0)[3]
    sess = tsolver.Solver(tsolver.SolveConfig.preset("prove", **SMALL,
                                                     device="cpu"))
    with pytest.raises(ValueError, match="same-shape"):
        sess.solve_many([k, q])
    with pytest.raises(ValueError, match="same-shape"):
        jsolver.Solver().solve_many([_jcm("knapsack", 0),
                                     _jcm("nqueens", 0)])
    assert sess.solve_many([]) == [] == jsolver.Solver().solve_many([])


def test_module_level_solve_functions(jax_session, monkeypatch):
    """`solve`, `solve_many` and `solve_iter` with a config, against the
    JAX package's module-level functions; without a config they use the
    default session (`SolveConfig()`, on the card), which raises where
    there is no card rather than moving to the CPU."""
    jcfg, tcfg = _cfgs()
    jcms = [_jcm("knapsack", s) for s in range(2)]
    tcms = [_tcase("knapsack", s)[3] for s in range(2)]
    _same_result(tsolver.solve(tcms[0], config=tcfg),
                 jsolver.solve(jcms[0], config=jcfg), "solve")
    for g, r in zip(tsolver.solve_many(tcms, config=tcfg),
                    jsolver.solve_many(jcms, config=jcfg)):
        _same_result(g, r, "solve_many")
    tev = list(tsolver.solve_iter(tcms[1], config=tcfg))
    jev = list(jsolver.solve_iter(jcms[1], config=jcfg))
    assert [e.superstep for e in tev] == [e.superstep for e in jev]
    _same_result(tev[-1].result, jev[-1].result, "solve_iter")
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    monkeypatch.setattr("repro_torch.core.api._default_solver", None)
    with pytest.raises(RuntimeError, match="is_available"):
        tsolver.solve(tcms[0])
    with pytest.raises(RuntimeError, match="is_available"):
        tsolver.default_solver()


def _snapshots_equal(ts, js, what):
    for f in SNAP_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(ts, f)), np.asarray(getattr(js, f)),
            err_msg=f"{what}: BatchSnapshot.{f}")


class _Pair:
    """A port `LaneBatch` and a JAX `LaneBatch` driven in lockstep."""

    def __init__(self, jax_session, name, cfgs, width):
        self.jcfg, self.tcfg = cfgs
        self.name = name
        self.j = jax_session.lane_batch(_jcm(name, 0), width=width,
                                        config=self.jcfg)
        self.t = tsolver.Solver(self.tcfg).lane_batch(
            _tcase(name, 0)[3], width=width)
        self.quanta = 0

    def splice(self, i, seed, rid):
        jcm = _jcm(self.name, seed)
        lb, ub = jeps.decompose(jcm, self.jcfg.resolved_eps_target(),
                                self.jcfg.search_options())
        self.j.splice(i, jcm, lb, ub, request_id=rid)
        self.t.splice(i, _tcase(self.name, seed)[3], np.asarray(lb),
                      np.asarray(ub), request_id=rid)
        _snapshots_equal(self.t.snapshot(), self.j.snapshot(),
                         f"after splice {rid}")

    def step(self):
        self.quanta += 1
        ts, js = self.t.step(), self.j.step()
        _snapshots_equal(ts, js, f"quantum {self.quanta}")
        for i in self.t.live_slots():
            assert self.t.incumbent(i)[0] == self.j.incumbent(i)[0]
        return ts

    def retire(self, i):
        g = self.t.retire(i, wall_s=0.0)
        r = self.j.retire(i, wall_s=0.0)
        _same_result(g, r, f"retire {i}")
        return g


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_lane_batch_midflight_join_matches_jax(jax_session, backend):
    """A second request joins while the first searches (chunk 1 under
    gather; one K=1 launch under cuda_resident); every snapshot and both
    results equal JAX's, and each equals a sequential solve."""
    kw = (dict(chunk=1) if backend == "gather"
          else dict(supersteps_per_launch=1))
    p = _Pair(jax_session, "knapsack", _cfgs(backend, **kw), 2)
    p.splice(0, 0, "first")
    snap = p.step()
    assert not bool(snap.gdone[0]), "instance too easy for one superstep"
    p.splice(1, 1, "late")
    while not bool(p.t.snapshot().gdone.all()):
        p.step()
    got = [p.retire(i) for i in (0, 1)]
    for g, seed in zip(got, (0, 1)):
        assert g.complete
        _same_result(g, tsolver.Solver(p.tcfg).solve(
            _tcase("knapsack", seed)[3]), "sequential")
    assert p.t.occupancy == 0 and p.t.n_retired == 2
    _snapshots_equal(p.t.snapshot(), p.j.snapshot(), "after retiring")


@pytest.mark.parametrize("name", ["knapsack", "jobshop"])
def test_lane_batch_early_retire_matches_jax(jax_session, name):
    """Eviction after one quantum derives from the live state: never a
    completed proof, equal to JAX's; the slot is reusable, and the
    second solve on it equals JAX's and a sequential solve."""
    p = _Pair(jax_session, name, _cfgs("gather", chunk=1), 2)
    p.splice(0, 0, "evict-me")
    assert not bool(p.step().gdone[0])
    res = p.retire(0)
    assert not res.complete and res.status in (tsolver.SAT, tsolver.UNKNOWN)
    p.splice(0, 0, "again")
    p.splice(1, 2, "other")
    while not bool(p.t.snapshot().gdone.all()):
        p.step()
    res2 = p.retire(0)
    assert res2.complete
    _same_result(res2, tsolver.Solver(p.tcfg).solve(_tcase(name, 0)[3]),
                 "sequential")
    p.retire(1)


def test_lane_batch_slot_misuse_raises():
    tcfg = _cfgs()[1]
    mod, inst, handles, cm = _tcase("knapsack", 0)
    batch = tsolver.Solver(tcfg).lane_batch(cm, width=2)
    lb, ub = jeps.decompose(_jcm("knapsack", 0), 8,
                            _cfgs()[0].search_options())
    with pytest.raises(ValueError, match="idle"):
        batch.retire(0, wall_s=0.0)
    batch.splice(0, cm, lb, ub)
    with pytest.raises(ValueError, match="occupied"):
        batch.splice(0, cm, lb, ub)
    with pytest.raises(ValueError, match="signature"):
        batch.splice(1, _tcase("jobshop", 0)[3], lb, ub)
    with pytest.raises(ValueError, match="fit"):
        batch.splice(1, cm, np.repeat(lb, 16, 0), np.repeat(ub, 16, 0))
    with pytest.raises(ValueError, match="width"):
        tsolver.Solver(tcfg).lane_batch(cm, width=0)
    assert batch.idle_slots() == [1] and batch.live_slots() == [0]
    assert batch.request_id(0) is None and batch.obj_var == cm.obj_var
