"""The port's solver service (`repro_torch.serve`, `launch/serve_solver.py`)
against the JAX package's (`repro.serve`), the cases of
``tests/test_serve.py`` at its size (4 lanes, eps_target 8, chunk 8,
max_depth 128):

* mixed-shape requests bucket apart, each result equal to the JAX
  scheduler's (status, objective, every counter, the solution) and to a
  sequential `Solver.solve`, under ``gather`` (JAX ``gather``) and
  ``cuda_resident`` (JAX ``pallas_resident``, interpret mode); a
  per-request config opens its own bucket;
* a deadline that expires while queued answers UNKNOWN without a slot;
  eviction at the deadline derives from the live state (never a proof),
  equal to the JAX scheduler's eviction after the same quanta;
* request validation, pool padding inert under continuous admission;
* `poisson_trace` equal to JAX's `Arrival` list from the same seed (the
  default mix and the card's mix of ``chip_smoke.py`` phase 32); the
  open-loop smoke equal to sequential solves and to the JAX package's;
* `MetricsRecorder.summary` equal on the same events, the request queue
  under concurrent pushes, the threaded `SolverService` submit/stream,
  the `Progress` timing contract, and the CLI on the CPU.
"""

import sys
import threading
import time

import numpy as np
import pytest

from repro import serve as jserve
from repro import solver as jsolver
from repro.core import eps as jeps
from repro.core import models as jzoo
from repro.serve import loadgen as jloadgen
from repro_torch import serve as tserve
from repro_torch import solver as tsolver
from repro_torch.core import eps as teps
from repro_torch.core import models as tzoo
from repro_torch.serve import loadgen as tloadgen

SMALL = dict(n_lanes=4, eps_target=8, chunk=8, max_depth=128)
JCFG = jsolver.SolveConfig.preset("prove", **SMALL)
TCFG = tsolver.SolveConfig.preset("prove", **SMALL, device="cpu")
COUNTERS = ("status", "objective", "n_nodes", "n_fails", "n_sols",
            "n_sweeps", "n_supersteps", "complete")
# the port's backend -> the JAX package's
BACKENDS = {"gather": "gather", "cuda_resident": "pallas_resident"}
# chip_smoke.py phase 32's mix: every shape signature seed-stable
CARD_MIX = (("nqueens", dict(n=32), 1.0), ("knapsack", dict(n=20), 2.0),
            ("crossword", dict(n=8), 1.0))


@pytest.fixture(scope="module")
def jsess():
    """One JAX session for the file (its runner cache is keyed by shape
    and config, so a bucket compiles once)."""
    return jsolver.Solver(JCFG)


def _jcm(name, seed):
    m, _ = jzoo.ZOO[name].build_model(jzoo.small_instance(name, seed=seed))
    return m.compile()


def _tcm(name, seed):
    m, _ = tzoo.ZOO[name].build_model(tzoo.small_instance(name, seed=seed))
    return m.compile(device="cpu")


def _same(got, ref, what, counters=COUNTERS):
    for k in counters:
        assert getattr(got, k) == getattr(ref, k), (what, k)
    if ref.solution is None:
        assert got.solution is None, what
    else:
        np.testing.assert_array_equal(got.solution, ref.solution)


def _sequential(cfg, cm):
    """A sequential solve of `cm` on its pool padded to the size a
    scheduler's bucket pads it to (padding adds failed nodes to the
    counters, never a solution)."""
    from repro_torch.core.api import _bucket
    pool = teps.fit_pool(*teps.decompose(cm, cfg.resolved_eps_target(),
                                         cfg.search_options()),
                         _bucket(cfg.resolved_eps_target()))
    return tsolver.Solver(cfg).solve(cm, subs=pool)


def _run(sched_cls, cfg, cms, max_batch, **kw):
    sched = sched_cls(cfg, max_batch=max_batch, **kw)
    req = tserve.SolveRequest if sched_cls is tserve.SolverScheduler \
        else jserve.SolveRequest
    handles = [sched.submit(req(cm=cm, request_id=f"q{i}"))
               for i, cm in enumerate(cms)]
    sched.run_until_drained(max_wall_s=600.0)
    return sched, [h.result() for h in handles]


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_mixed_shapes_bucket_separately_and_match_jax(jsess, backend):
    names = [("knapsack", 0), ("jobshop", 0), ("knapsack", 1),
             ("jobshop", 1)]
    jcfg = JCFG.replace(backend=BACKENDS[backend])
    tcfg = TCFG.replace(backend=backend)
    _, ref = _run(jserve.SolverScheduler, jcfg,
                  [_jcm(*n) for n in names], 2, session=jsess)
    sched, got = _run(tserve.SolverScheduler, tcfg,
                      [_tcm(*n) for n in names], 2)
    buckets = sched.buckets()
    assert len(buckets) == 2, buckets
    for label, b in buckets.items():
        assert b["n_requests"] == 2 and b["n_spliced"] == 2
        assert b["n_builds"] == 0 and b["build_s"] == 0.0    # CPU
    for n, g, r in zip(names, got, ref):
        _same(g, r, (backend, n))
        assert g.complete
        _same(g, _sequential(tcfg, _tcm(*n)), (backend, n, "sequential"))


def test_per_request_config_gets_its_own_bucket(jsess):
    cms = {"t": _tcm("knapsack", 0), "j": _jcm("knapsack", 0)}
    out = {}
    for side, mod, cfg in (("t", tserve, TCFG), ("j", jserve, JCFG)):
        kw = {} if side == "t" else dict(session=jsess)
        sched = mod.SolverScheduler(cfg, max_batch=2, **kw)
        h1 = sched.submit(mod.SolveRequest(cm=cms[side], request_id="a"))
        h2 = sched.submit(mod.SolveRequest(
            cm=cms[side], request_id="b", config=cfg.replace(n_lanes=2)))
        sched.run_until_drained(max_wall_s=600.0)
        assert len(sched.buckets()) == 2    # compile_key differs
        out[side] = (h1.result(), h2.result())
    for g, r in zip(out["t"], out["j"]):
        _same(g, r, "per-request config")
        assert g.status == tsolver.OPTIMAL


def test_deadline_expired_while_queued_is_unknown(jsess):
    for mod, cfg, cm, kw in ((tserve, TCFG, _tcm("knapsack", 0), {}),
                             (jserve, JCFG, _jcm("knapsack", 0),
                              dict(session=jsess))):
        sched = mod.SolverScheduler(cfg, max_batch=2, **kw)
        h = sched.submit(mod.SolveRequest(cm=cm, request_id="late",
                                          deadline_s=1e-4))
        time.sleep(0.01)                    # the deadline passes queued
        sched.run_until_drained(max_wall_s=60.0)
        res = h.result()
        assert res.status == "UNKNOWN" and not res.complete
        assert res.solution is None and res.n_nodes == 0
        rec = sched.recorder.requests["late"]
        assert rec.deadline_missed and rec.t_admit is None


@pytest.mark.parametrize("name", ["knapsack", "jobshop"])
def test_deadline_eviction_is_honest_and_matches_jax(jsess, name):
    """A request admitted with a distant deadline whose deadline is moved
    into the past after two quanta (chunk 1) is evicted after the third
    with its live state: never a proof, and equal on every counter to the
    JAX scheduler's eviction at the same quantum."""
    out = {}
    for side, mod, cfg, cm, kw in (
            ("t", tserve, TCFG, _tcm(name, 0), {}),
            ("j", jserve, JCFG, _jcm(name, 0), dict(session=jsess))):
        sched = mod.SolverScheduler(cfg.replace(chunk=1), max_batch=1, **kw)
        h = sched.submit(mod.SolveRequest(cm=cm, request_id="tight",
                                          deadline_s=600.0))
        sched.step()
        sched.step()
        (bucket,) = sched._buckets.values()
        assert not h.done(), "instance too easy for two quanta"
        bucket.active[0].deadline_t = time.time() - 1.0
        sched.run_until_drained(max_wall_s=120.0)
        out[side] = h.result()
        assert sched.recorder.requests["tight"].deadline_missed
    res = out["t"]
    assert not res.complete and res.status in (tsolver.SAT, tsolver.UNKNOWN)
    assert res.n_supersteps == 3
    if res.status == tsolver.SAT:
        assert res.solution is not None
    _same(res, out["j"], "eviction")


def test_request_validation():
    for mod in (tserve, jserve):
        with pytest.raises(ValueError, match="deadline"):
            mod.SolveRequest(cm=None, deadline_s=0.0)
        with pytest.raises(ValueError, match="deadline"):
            mod.SolveRequest(cm=None, deadline_s=-1.0)
        a, b = mod.SolveRequest(cm=None), mod.SolveRequest(cm=None)
        assert a.request_id != b.request_id    # auto ids stay distinct
    with pytest.raises(ValueError, match="max_batch"):
        tserve.SolverScheduler(TCFG, max_batch=0)


def test_spliced_pool_padding_is_inert():
    """Padded pools on spliced slots and all-failed pools on idle and
    retired slots add no phantom subproblem: results and solution counts
    equal the JAX package's unpadded sequential solves."""
    jref = jsolver.Solver(JCFG.replace(pad_pool=False))
    ref = [jref.solve(_jcm("knapsack", s)) for s in range(3)]
    sched, got = _run(tserve.SolverScheduler, TCFG,
                      [_tcm("knapsack", s) for s in range(3)], 2)
    (bucket,) = sched.buckets().values()
    assert bucket["n_spliced"] == 3 and bucket["n_retired"] == 3
    for g, r in zip(got, ref):
        _same(g, r, "padding", COUNTERS[:5])


def test_fit_pool_and_failed_pool_match_jax():
    rng = np.random.default_rng(0)
    lb = rng.integers(0, 5, (3, 4)).astype(np.int32)
    ub = lb + rng.integers(0, 5, (3, 4)).astype(np.int32)
    for a, b in zip(teps.fit_pool(lb, ub, 8), jeps.fit_pool(lb, ub, 8)):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(teps.failed_pool(lb[0], ub[0], 5),
                    jeps.failed_pool(lb[0], ub[0], 5)):
        np.testing.assert_array_equal(a, np.asarray(b))
    with pytest.raises(ValueError, match="fit"):
        teps.fit_pool(lb, ub, 2)


@pytest.mark.parametrize("kw", [dict(n=40, rate=100.0, seed=7),
                                dict(n=16, rate=8.0, seed=0, mix=CARD_MIX,
                                     deadlines=(None, 120.0, 600.0))])
def test_poisson_trace_equals_jax(kw):
    kw = dict(kw)
    n, rate = kw.pop("n"), kw.pop("rate")
    got = tloadgen.poisson_trace(n, rate, **kw)
    ref = jloadgen.poisson_trace(n, rate, **kw)
    assert [tuple(vars(a).values()) for a in got] == \
        [tuple(vars(a).values()) for a in ref]
    assert got == tloadgen.poisson_trace(n, rate, **kw)
    times = [a.t_arrival for a in got]
    assert times == sorted(times) and times[0] > 0.0
    assert len({a.model for a in got}) >= 2
    for bad in ((0, 100.0), (5, 0.0)):
        with pytest.raises(ValueError):
            tloadgen.poisson_trace(*bad)
    assert tloadgen.DEFAULT_MIX == jloadgen.DEFAULT_MIX
    assert tloadgen.DEFAULT_DEADLINES == jloadgen.DEFAULT_DEADLINES


def test_open_loop_smoke_matches_sequential_and_jax():
    trace = tloadgen.poisson_trace(6, 200.0, seed=3)
    sched = tserve.SolverScheduler(TCFG, max_batch=2)
    handles = tloadgen.run_open_loop(sched, trace, max_wall_s=600.0)
    ref = jloadgen.sequential_reference(jloadgen.poisson_trace(
        6, 200.0, seed=3), JCFG)
    assert tloadgen.sequential_reference(trace, TCFG) == ref
    for a, h in handles:
        res = h.result()
        assert res.complete
        assert (res.status, res.objective) == ref[h.request.request_id]
        _same(res, _sequential(TCFG, tloadgen.compile_arrival(a, "cpu")),
              h.request.request_id)
    s = sched.recorder.summary()
    assert s["n_done"] == 6 and s["n_deadline_missed"] == 0
    assert all(b["n_builds"] == 0 for b in sched.buckets().values())


def test_metrics_summary_equals_jax():
    class R:                                 # minimal SolveResult stand-in
        def __init__(self, status, obj, complete):
            self.status, self.objective = status, obj
            self.complete, self.n_supersteps = complete, 5

    out = []
    for mod in (tserve, jserve):
        m = mod.MetricsRecorder()
        m.record_submit("a", 100.0)
        m.record_admit("a", "b0", 101.0)
        m.record_first_incumbent("a", 102.0)
        m.record_first_incumbent("a", 109.0)     # the first one wins
        m.record_done("a", R("OPTIMAL", 7, True), 103.0)
        m.record_submit("b", 100.5)
        m.record_admit("b", "b0", 100.5)
        m.record_done("b", R("SAT", None, False), 104.5,
                      deadline_missed=True)
        m.record_submit("c", 103.25)              # never done
        for d in (2, 0, 5):
            m.sample_queue_depth(d)
        m.sample_occupancy("b0", 2, 4)
        m.sample_occupancy("b0", 3, 4)
        m.sample_occupancy("b1", 1, 2)
        m.record_bucket("b1", n_requests=3)
        out.append(m.summary())
    got, ref = out
    for b in ref["buckets"].values():       # the port counts builds
        b["n_builds"] = b.pop("n_compiles")
    assert got == ref
    assert got["ttfi_s"]["p50"] == 2.0 and got["span_s"] == 4.5
    assert got["instances_per_sec"] == round(2 / 4.5, 2)


def test_request_queue_under_concurrent_pushes():
    """Pushes from more threads than cores, with a short switch
    interval, lose nothing and keep each thread's order; `drain` takes
    everything once."""
    for mod in (tserve, jserve):
        q = mod.RequestQueue()
        assert len(q) == 0 and q.drain() == []
        n_threads, n_items = 16, 500
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(
                target=lambda t=t: [q.push((t, i)) for i in range(n_items)])
                for t in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60.0)
            assert not any(th.is_alive() for th in threads)
        finally:
            sys.setswitchinterval(old)
        assert len(q) == n_threads * n_items
        items = q.drain()
        assert len(items) == n_threads * n_items and len(q) == 0
        for t in range(n_threads):
            assert [i for tt, i in items if tt == t] == list(range(n_items))


def test_progress_t_host_is_the_single_timing_source():
    cm = _tcm("knapsack", 0)
    t_before = time.time()
    events = list(tsolver.Solver(TCFG).solve_iter(cm))
    t_after = time.time()
    assert events and events[-1].final
    hosts = [ev.t_host for ev in events]
    assert hosts == sorted(hosts)
    assert all(t_before <= h <= t_after for h in hosts)
    starts = [ev.t_host - ev.wall_s for ev in events]
    assert max(starts) - min(starts) < 1e-6
    assert events[-1].wall_s == events[-1].result.wall_s


def test_solver_service_threaded_submit_and_stream(jsess):
    jref = [jsess.solve(_jcm("knapsack", s)) for s in range(3)]
    cms = [_tcm("knapsack", s) for s in range(3)]
    with tserve.SolverService(TCFG, max_batch=2) as svc:
        handles = [svc.submit(c, request_id=f"t{i}")
                   for i, c in enumerate(cms)]
        events = list(handles[0].events(timeout=600.0))
        assert events and events[-1].final
        assert events[-1].result is not None
        assert all(not e.final for e in events[:-1])
        for h, r in zip(handles, jref):
            _same(h.result(timeout=600.0), r, h.request.request_id)
    assert not svc._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(cms[0])


def test_serve_solver_cli_on_cpu(capsys):
    from repro_torch.launch import serve_solver
    serve_solver.main(["--device", "cpu", "--backend", "gather",
                       "--requests", "6", "--lanes", "4", "--eps-target",
                       "8", "--parity"])
    out = capsys.readouterr().out
    assert "parity: OK over 6 requests" in out
    assert '"n_builds": 0' in out
