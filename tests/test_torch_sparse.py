"""The port's sparse AllDifferent and Cumulative banks against the JAX
package's.

Identical tables (carried across with `from_arrays`, or compiled on both
sides with the same ``bank_layout``), identical input stores (seeded
numpy) → identical results, compared exactly (the stores are an integer
lattice):

* per sweep: the sparse tiles (`alldiff_candidates_sparse_tile`,
  `cumulative_candidates_sparse_tile`) and five sweeps of `sweep_tile`,
  on forced-sparse N-queens 9 and rcpsp-7 (the models of
  ``tests/test_sparse_tiles.py``), forced-sparse jobshop small, N-queens
  36 (sparse by the crossover) and a few lanes of the J90 class;
* `fixpoint_batch` capped at 1 and 2 sweeps and uncapped against JAX's
  gather `fixpoint_batch`, and against `fixpoint_pallas` in interpret
  mode on rcpsp-7;
* the port's sparse compile against its dense compile, per sweep, on the
  non-failed stores, with equal failed masks (the reference's own
  contract between the layouts);
* stores whose Cumulative rows have tied event keys (several tasks with
  one lst, one ect, or an lst equal to another's ect) and whose
  AllDifferent rows have tied lower bounds;
* `search_plain` against JAX `search_pallas(..., lane_tile=0,
  interpret=True)` on forced-sparse models, K = 1 and 4;
* `SolveResult` of the ``gather``, ``cuda`` and ``cuda_resident``
  backends (on CPU tensors: the plain versions) against the JAX
  package's on forced-sparse rcpsp, nqueens and jobshop smoke instances,
  and rcpsp-96 (``large_instance("rcpsp")``, 8 lanes, eps 16) to its
  proven optimum 55.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import solver as jsolver
from repro.core import fixpoint as JF
from repro.core import models as jzoo
from repro.kernels import fixpoint_kernel as JFK
from repro_torch import solver as tsolver
from repro_torch.core import fixpoint as TF
from repro_torch.core import models as tzoo
from repro_torch.kernels import fixpoint_kernel as TFK
from test_torch_compile import port_from_jax
from test_torch_resident import _both
from test_torch_search import _assert_state_equal
from util import random_substores

torch.set_num_threads(1)      # small tensors: thread hand-offs cost more


def _nqueens(n, **kw):
    return jzoo.nqueens.build_model(jzoo.nqueens.generate(n, seed=0)
                                    )[0].compile(**kw)


def _rcpsp(n, **kw):
    gen = dict(n_resources=2, seed=3, edge_prob=0.3) if n == 7 else \
        dict(n_resources=4, seed=0)
    return jzoo.rcpsp.build_model(jzoo.rcpsp.generate(n, **gen)
                                  )[0].compile(**kw)


def _jobshop(**kw):
    return jzoo.jobshop.build_model(jzoo.small_instance("jobshop")
                                    )[0].compile(**kw)


# name: (JAX compile, lanes of random stores)
MODELS = {
    "nqueens9": (lambda: _nqueens(9, bank_layout="sparse"), 16),
    "rcpsp7": (lambda: _rcpsp(7, bank_layout="sparse"), 16),
    "jobshop_small": (lambda: _jobshop(bank_layout="sparse"), 16),
    "nqueens36": (lambda: _nqueens(36), 16),
    "j90": (lambda: _rcpsp(90), 3),
}
_CACHE = {}


def _model(name):
    if name not in _CACHE:
        make, lanes = MODELS[name]
        jcm = make()
        _CACHE[name] = (jcm, port_from_jax(jcm), lanes)
    return _CACHE[name]


def _stores(jcm, lanes, seed):
    lbs, ubs = random_substores(np.random.default_rng(seed), jcm, lanes)
    return lbs, ubs


def _eq(got, ref, what):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref),
                                  err_msg=what)


def _sparse_tiles(jcm, tcm, lbs, ubs):
    """(JAX, port) candidate pairs of every sparse bank of the model."""
    out = []
    jl, ju = jnp.asarray(lbs), jnp.asarray(ubs)
    tl, tu = torch.from_numpy(lbs), torch.from_numpy(ubs)
    if jcm.n_alldiff and jcm.ad_layout == "sparse":
        args = ("ad_pk_var", "ad_pk_off", "ad_pk_seg")
        out.append(("alldiff", JF.alldiff_candidates_sparse_tile(
            jl, ju, *(getattr(jcm, a) for a in args), jcm.n_alldiff),
            TF.alldiff_candidates_sparse_tile(
                tl, tu, *(getattr(tcm, a) for a in args), tcm.n_alldiff)))
    if jcm.n_cumulative and jcm.cu_layout == "sparse":
        args = ("cu_pk_svar", "cu_pk_dur", "cu_pk_dem", "cu_pk_seg",
                "cu_cap")
        out.append(("cumulative", JF.cumulative_candidates_sparse_tile(
            jl, ju, *(getattr(jcm, a) for a in args), jcm.n_cumulative),
            TF.cumulative_candidates_sparse_tile(
                tl, tu, *(getattr(tcm, a) for a in args),
                tcm.n_cumulative)))
    assert out, "no sparse bank"
    return out


def _assert_tiles_equal(jcm, tcm, lbs, ubs, what):
    for bank, ref, got in _sparse_tiles(jcm, tcm, lbs, ubs):
        for side, r, g in zip(("lb", "ub"), ref, got):
            assert g.dtype == tcm.tdtype
            _eq(g, r, f"{what} {bank} {side}")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_sparse_tiles_and_sweeps_match_jax(name):
    jcm, tcm, lanes = _model(name)
    lbs, ubs = _stores(jcm, lanes, 11)
    jl, ju = jnp.asarray(lbs), jnp.asarray(ubs)
    tl, tu = torch.from_numpy(lbs), torch.from_numpy(ubs)
    tables, statics = TF.model_tables(tcm), TF.model_statics(tcm)
    for k in range(5):
        _assert_tiles_equal(jcm, tcm, np.array(jl), np.array(ju),
                            f"{name} before sweep {k + 1}")
        jl, ju = JF.sweep_batch(jcm, jl, ju)
        tl, tu = TF.sweep_tile(tl, tu, *tables, **statics)
        _eq(tl, jl, f"{name} sweep {k + 1} lb")
        _eq(tu, ju, f"{name} sweep {k + 1} ub")


@pytest.mark.parametrize("max_iters", [1, 2, None])
@pytest.mark.parametrize("name", ["jobshop_small", "nqueens36", "nqueens9",
                                  "rcpsp7"])
def test_fixpoint_matches_jax_gather(name, max_iters):
    jcm, tcm, lanes = _model(name)
    lbs, ubs = _stores(jcm, lanes, 23)
    ref = JF.fixpoint_batch(jcm, jnp.asarray(lbs), jnp.asarray(ubs),
                            max_iters=max_iters)
    got = TF.fixpoint_batch(tcm, torch.from_numpy(lbs),
                            torch.from_numpy(ubs), max_iters=max_iters)
    for what, r, g in zip(("lb", "ub", "sweeps", "converged"), ref, got):
        _eq(g, r, f"{name} max_iters={max_iters} {what}")


@pytest.mark.parametrize("max_sweeps", [1, 16384])
def test_fixpoint_matches_pallas_interpret(max_sweeps):
    jcm, tcm, lanes = _model("rcpsp7")
    lbs, ubs = _stores(jcm, lanes, 5)
    ref = JFK.fixpoint_pallas(jcm, jnp.asarray(lbs), jnp.asarray(ubs),
                              lane_tile=8, max_sweeps=max_sweeps,
                              interpret=True)
    got = TF.fixpoint_batch(tcm, torch.from_numpy(lbs),
                            torch.from_numpy(ubs), max_iters=max_sweeps)
    for what, r, g in zip(("lb", "ub", "sweeps", "converged"), ref, got):
        _eq(g, r, f"pallas max_sweeps={max_sweeps} {what}")


@pytest.mark.parametrize("name", ["jobshop", "nqueens9", "rcpsp7"])
def test_port_sparse_equals_port_dense(name):
    """Per sweep, the sparse compile equals the dense compile on the
    stores that are not failed, with equal failed masks."""
    make = {"jobshop": _jobshop, "nqueens9": lambda **kw: _nqueens(9, **kw),
            "rcpsp7": lambda **kw: _rcpsp(7, **kw)}[name]
    dn, sp = (port_from_jax(make(bank_layout=lay))
              for lay in ("dense", "sparse"))
    assert "sparse" in (sp.ad_layout, sp.cu_layout)
    lbs, ubs = _stores(make(), 24, 31)
    dl = sl = torch.from_numpy(lbs)
    du = su = torch.from_numpy(ubs)
    for k in range(5):
        dl, du = TF.sweep_tile(dl, du, *TF.model_tables(dn),
                               **TF.model_statics(dn))
        sl, su = TF.sweep_tile(sl, su, *TF.model_tables(sp),
                               **TF.model_statics(sp))
        failed = (dl > du).any(1)
        assert torch.equal(failed, (sl > su).any(1)), f"sweep {k + 1}"
        ok = ~failed
        assert torch.equal(dl[ok], sl[ok]) and torch.equal(du[ok], su[ok])
    assert bool(ok.any())


def _tied_cumulative_stores(rng, jcm, lbs, ubs):
    """Stores where tasks of one Cumulative row share event times: two or
    three tasks told one lst, two told one est (so one ect where their
    durations agree), and one task's lst set to another's ect."""
    seg = np.asarray(jcm.cu_pk_seg)
    svar = np.asarray(jcm.cu_pk_svar)
    dur = np.asarray(jcm.cu_pk_dur)
    lb0, ub0 = np.asarray(jcm.lb0), np.asarray(jcm.ub0)
    lbs, ubs = lbs.copy(), ubs.copy()
    for i in range(lbs.shape[0]):
        c = int(rng.integers(0, jcm.n_cumulative))
        tasks = np.flatnonzero((seg == c) & (dur > 0))
        pick = rng.choice(tasks, size=min(3, len(tasks)), replace=False)
        v = svar[pick]
        t = int(rng.integers(lb0[v].max(), ub0[v].min() + 1)) \
            if lb0[v].max() <= ub0[v].min() else int(lb0[v].max())
        mode = i % 3
        if mode == 0:                                  # one lst
            ubs[i, v] = np.maximum(lbs[i, v], t)
        elif mode == 1:                                # one est (ect ties)
            lbs[i, v] = np.minimum(ubs[i, v], t)
        else:                                          # lst_b = ect_a
            a, b = v[0], v[-1]
            ubs[i, b] = max(lbs[i, b], lbs[i, a] + int(dur[pick[0]]))
    return lbs, ubs


def _tied_alldiff_stores(rng, jcm, lbs, ubs):
    """Stores where members of one AllDifferent row share a shifted lower
    bound (equal (seg, yl) keys), some with equal upper bounds too."""
    seg = np.asarray(jcm.ad_pk_seg)
    var = np.asarray(jcm.ad_pk_var)
    off = np.asarray(jcm.ad_pk_off)
    lb0 = np.asarray(jcm.lb0)
    lbs, ubs = lbs.copy(), ubs.copy()
    for i in range(lbs.shape[0]):
        a = int(rng.integers(0, jcm.n_alldiff))
        k = rng.choice(np.flatnonzero(seg == a), size=3, replace=False)
        y = int((lb0[var[k]] + off[k]).max()) + int(rng.integers(0, 2))
        lbs[i, var[k]] = y - off[k]
        ubs[i, var[k]] = np.maximum(ubs[i, var[k]], lbs[i, var[k]])
        if i % 2:
            ubs[i, var[k[:2]]] = y + 1 - off[k[:2]]
    return lbs, ubs


@pytest.mark.parametrize("name", ["j90", "jobshop_small", "nqueens9",
                                  "nqueens36", "rcpsp7"])
def test_tied_event_keys_match_jax(name):
    jcm, tcm, lanes = _model(name)
    rng = np.random.default_rng(7)
    lbs, ubs = _stores(jcm, max(lanes, 6), 41)
    tie = (_tied_alldiff_stores if jcm.ad_layout == "sparse"
           else _tied_cumulative_stores)
    lbs, ubs = tie(rng, jcm, lbs, ubs)
    _assert_tiles_equal(jcm, tcm, lbs, ubs, f"{name} tied")
    ref = JF.fixpoint_batch(jcm, jnp.asarray(lbs), jnp.asarray(ubs),
                            max_iters=3)
    got = TF.fixpoint_batch(tcm, torch.from_numpy(lbs),
                            torch.from_numpy(ubs), max_iters=3)
    for what, r, g in zip(("lb", "ub", "sweeps", "converged"), ref, got):
        _eq(g, r, f"{name} tied {what}")


# name: (JAX compile, lanes, eps, warm supersteps, K, options)
SEARCH_CASES = {
    "rcpsp7_k1": (lambda: _rcpsp(7, bank_layout="sparse"), 8, 16, 0, 1,
                  dict(var_strategy="min_lb")),
    "rcpsp7_k4_warm": (lambda: _rcpsp(7, bank_layout="sparse"), 8, 16, 2,
                       4, dict(var_strategy="min_lb")),
    "nqueens9_k4_split": (lambda: _nqueens(9, bank_layout="sparse"), 8, 16,
                          0, 4, dict(var_strategy="min_dom",
                                     val_strategy="split")),
    "jobshop_k1_capped": (lambda: _jobshop(bank_layout="sparse"), 8, 16, 0,
                          1, dict(var_strategy="min_lb",
                                  max_fixpoint_iters=1)),
}


@pytest.mark.parametrize("case", sorted(SEARCH_CASES))
def test_search_plain_matches_search_pallas(case):
    make, lanes, target, warm, k, opt_kw = SEARCH_CASES[case]
    jcm = make()
    jargs, targs = _both(jcm, lanes, target, warm, False, opt_kw)
    kw = dict(supersteps=k,
              max_fixpoint_iters=opt_kw.get("max_fixpoint_iters"),
              var_strategy=opt_kw.get("var_strategy", "input_order"),
              val_strategy=opt_kw.get("val_strategy", "min"))
    jst, jg, jit, jh, jstop = JFK.search_pallas(
        jcm, *jargs, lane_tile=0, interpret=True, **kw)
    tst, tg, tit, th, tstop = TFK.search_plain(port_from_jax(jcm), *targs,
                                               **kw)
    _assert_state_equal(jst, tst, case)
    assert (int(tg), int(tit), int(th), bool(tstop)) == \
        (int(jg), int(jit), int(jh[0]), bool(jstop))
    assert int(np.asarray(jst.n_nodes).sum()) > 0


COUNTERS = ("status", "objective", "n_nodes", "n_fails", "n_sols",
            "n_sweeps", "n_supersteps", "complete")
PORT_BACKENDS = ("gather", "cuda", "cuda_resident")


@pytest.fixture(scope="module")
def jax_session():
    return jsolver.Solver()


def _solve_both(jax_session, name, inst_of, layout, lanes, eps_target=None):
    kw = dict(n_lanes=lanes)
    if eps_target:
        kw["eps_target"] = eps_target
    jm, _ = jzoo.ZOO[name].build_model(inst_of(jzoo))
    ref = jax_session.solve(jm.compile(bank_layout=layout),
                            config=jsolver.SolveConfig.preset(
                                "prove", backend="gather", **kw))
    inst = inst_of(tzoo)
    m, handles = tzoo.ZOO[name].build_model(inst)
    cm = m.compile(device="cpu", bank_layout=layout)
    got = {}
    for backend in PORT_BACKENDS:
        res = tsolver.Solver(tsolver.SolveConfig.preset(
            "prove", backend=backend, device="cpu", **kw)).solve(cm)
        for k in COUNTERS:
            assert getattr(res, k) == getattr(ref, k), (backend, k)
        np.testing.assert_array_equal(res.solution, ref.solution)
        assert tzoo.ground_check(tzoo.ZOO[name], inst, handles, res) is True
        got[backend] = res
    return cm, ref


@pytest.mark.parametrize("name", ["jobshop", "nqueens", "rcpsp"])
def test_smoke_solves_match_jax_forced_sparse(jax_session, name):
    cm, ref = _solve_both(jax_session, name,
                          lambda zoo: zoo.small_instance(name, seed=0),
                          "sparse", 16)
    assert "sparse" in (cm.ad_layout, cm.cu_layout)
    assert ref.status == "OPTIMAL"


def test_rcpsp96_proves_its_optimum(jax_session):
    """``large_instance("rcpsp")`` compiles to the sparse Cumulative
    layout and proves OPTIMAL 55 on every port backend, as in JAX."""
    cm, ref = _solve_both(jax_session, "rcpsp",
                          lambda zoo: zoo.large_instance("rcpsp"), "auto",
                          8, eps_target=16)
    assert cm.cu_layout == "sparse"
    assert (ref.status, ref.objective) == ("OPTIMAL", 55)
