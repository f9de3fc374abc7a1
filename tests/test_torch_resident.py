"""The port's resident search against the JAX package's.

* `search_plain` (the plain version of the port's `search_cuda`, which
  the wrapper runs on CPU tensors) against JAX `search_pallas(...,
  lane_tile=0, interpret=True)`: from the same pool and state, every
  LaneState field (values and dtypes), the bound, the superstep count,
  the pool cursor and the stop flag are exactly equal — at K = 1, 4 and
  16 supersteps per launch, with the capped fixpoint, with
  ``stop_on_first`` tripping mid-launch, under ``min_lb``/``split`` and
  ``input_order``/``min``; on the RCPSP small instance of
  ``tests/test_resident.py`` (8 lanes, eps 8, max_depth 64) and on a
  J30-class state at 16 lanes.
* `Solver(backend="cuda_resident", device="cpu")` against JAX
  `Solver(backend="pallas_resident")`: every `SolveResult` counter.
* `SolveConfig` validation of ``supersteps_per_launch``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import solver as jsolver
from repro.core import eps as jeps
from repro.core import models as zoo
from repro.core import search as JS
from repro.core.api import _bucket
from repro.kernels import fixpoint_kernel as JFK
from repro_torch import solver as tsolver
from repro_torch.core import search as TS
from repro_torch.kernels import fixpoint_kernel as TFK
from repro_torch.testing import search_diff
from test_torch_compile import j30, port_from_jax
from test_torch_fixpoint import _jax_rcpsp
from test_torch_search import _assert_state_equal, _jax_state_arrays

COUNTERS = ("status", "objective", "n_nodes", "n_fails", "n_sols",
            "n_sweeps", "n_supersteps", "complete")


def _small():
    inst = zoo.small_instance("rcpsp", seed=0)
    return zoo.ZOO["rcpsp"].build_model(inst)[0].compile()


def _both(jcm, n_lanes, eps_target, warm, pad, opt_kw):
    """One start on both sides: (JAX args, port args) of a launch after
    `warm` unfused JAX supersteps from fresh lanes."""
    jopts = JS.SearchOptions(max_depth=64, **opt_kw)
    lb, ub = jeps.decompose(jcm, eps_target, jopts)
    if pad:
        lb, ub = jeps.pad_pool(lb, ub, _bucket(lb.shape[0]))
    jsl, jsu = jnp.asarray(lb), jnp.asarray(ub)
    jst = JS.init_lanes(jcm, n_lanes, jopts)
    big = np.iinfo(lb.dtype).max // 4
    jg, jh = jnp.asarray(big, lb.dtype), jnp.asarray(0, jnp.int32)
    for _ in range(warm):
        jst, jh = JS.lanes_step(jcm, jsl, jsu, jopts, jst, jg, jh)
        jg = jnp.minimum(jg, JS.lanes_best(jst, jcm.jdtype))
    jargs = (jsl, jsu, jst, jg, jnp.asarray(warm, jnp.int32),
             jnp.reshape(jh, (1,)))
    tsl, tsu = torch.from_numpy(np.array(lb)), torch.from_numpy(np.array(ub))
    targs = (tsl, tsu,
             TS.lane_state_from_arrays(_jax_state_arrays(jst), "cpu"),
             torch.tensor(int(jg), dtype=tsl.dtype), warm,
             torch.tensor(int(jh), dtype=torch.int32))
    return jargs, targs


# name: (setup, lanes, eps, warm supersteps, pad the pool, K, options)
CASES = {
    "small_k1": ("small", 8, 8, 0, False, 1, {}),
    "small_k4": ("small", 8, 8, 0, False, 4, {}),
    "small_k16": ("small", 8, 8, 0, False, 16, {}),
    "small_capped": ("small", 8, 8, 0, False, 16,
                     dict(max_fixpoint_iters=1)),
    "small_stop_on_first": ("small", 8, 8, 0, False, 16,
                            dict(stop_on_first=True)),
    "small_min_lb_split": ("small", 8, 8, 0, False, 16,
                           dict(var_strategy="min_lb",
                                val_strategy="split")),
    "small_warm_input_order_min": ("small", 8, 8, 3, False, 4, {}),
    "j30_warm_min_lb": ("j30", 16, 32, 5, True, 4,
                        dict(var_strategy="min_lb")),
    "j30_warm_capped_split": ("j30", 16, 32, 5, True, 16,
                              dict(var_strategy="min_dom",
                                   val_strategy="split",
                                   max_fixpoint_iters=4)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_search_plain_matches_search_pallas(case):
    setup, lanes, target, warm, pad, k, opt_kw = CASES[case]
    jcm = _small() if setup == "small" else _jax_rcpsp(j30(0))
    jargs, targs = _both(jcm, lanes, target, warm, pad, opt_kw)
    kw = dict(supersteps=k, max_fixpoint_iters=opt_kw.get(
                  "max_fixpoint_iters"),
              var_strategy=opt_kw.get("var_strategy", "input_order"),
              val_strategy=opt_kw.get("val_strategy", "min"),
              stop_on_first=opt_kw.get("stop_on_first", False))
    jst, jg, jit, jh, jstop = JFK.search_pallas(
        jcm, *jargs, lane_tile=0, interpret=True, **kw)
    tst, tg, tit, th, tstop = TFK.search_plain(port_from_jax(jcm), *targs,
                                               **kw)
    _assert_state_equal(jst, tst, case)
    assert tg.dtype == targs[3].dtype and tg.shape == ()
    assert (int(tg), int(tit), int(th), bool(tstop)) == \
        (int(jg), int(jit), int(jh[0]), bool(jstop))
    assert int(tit) - warm <= k
    if kw["stop_on_first"]:
        assert bool(tstop) and int(tit) < k, "no mid-launch stop"
    if case == "j30_warm_min_lb":
        assert int(np.asarray(jst.n_nodes).sum()) > 0


def test_search_cuda_on_cpu_is_search_plain_and_idle_launches():
    """On CPU tensors the wrapper is the plain version; a launch from a
    stopped state is the identity (no superstep counted)."""
    jcm = _small()
    _, targs = _both(jcm, 8, 8, 0, False, dict(stop_on_first=True))
    cm = port_from_jax(jcm)
    before = TFK.search_cuda.launches
    first = TFK.search_cuda(cm, *targs, supersteps=16, stop_on_first=True)
    assert TFK.search_cuda.launches == before
    assert bool(first[4]) and 0 < int(first[2]) < 16
    again = TFK.search_cuda(cm, *targs[:2], *first[:4], supersteps=16,
                            stop_on_first=True)
    assert search_diff(first, again) == []


@pytest.mark.parametrize("preset,k", [("prove", 16), ("prove", 4),
                                      ("fast", 16), ("first_solution", 16)])
def test_resident_solve_matches_jax_pallas_resident(preset, k):
    jcm = _small()
    kw = dict(n_lanes=8, eps_target=8, timeout_s=600, max_depth=512,
              supersteps_per_launch=k)
    ref = jsolver.Solver(jsolver.SolveConfig.preset(
        preset, backend="pallas_resident", **kw)).solve(jcm)
    got = tsolver.Solver(tsolver.SolveConfig.preset(
        preset, backend="cuda_resident", device="cpu", **kw)).solve(
            port_from_jax(jcm))
    for c in COUNTERS:
        assert getattr(got, c) == getattr(ref, c), c
    np.testing.assert_array_equal(got.solution, ref.solution)
    assert [i.objective for i in got.improvements] == \
        [i.objective for i in ref.improvements]
    assert got.status == ("SAT" if preset == "first_solution"
                          else "OPTIMAL")


def test_config_supersteps_per_launch():
    cfg = tsolver.SolveConfig.preset("prove", backend="cuda_resident",
                                     device="cpu", supersteps_per_launch=4)
    assert cfg.resolved_supersteps() == 4
    assert tsolver.SolveConfig(backend="cuda_resident",
                               device="cpu").resolved_supersteps() == 16
    with pytest.raises(ValueError, match="cuda_resident"):
        tsolver.SolveConfig.preset("prove", backend="gather", device="cpu",
                                   supersteps_per_launch=4)
    with pytest.raises(ValueError, match="cuda_resident"):
        tsolver.SolveConfig(device="cpu", supersteps_per_launch=16)
    for bad in (0, -1, 2.5, "16"):
        with pytest.raises(ValueError, match="positive int"):
            tsolver.SolveConfig(backend="cuda_resident", device="cpu",
                                supersteps_per_launch=bad)


def test_cli_resident_backend_on_cpu(capsys):
    from repro_torch.launch import solve
    solve.main(["--n", "8", "--lanes", "16", "--device", "cpu",
                "--backend", "cuda_resident", "--supersteps-per-launch",
                "4"])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert "OPTIMAL" in out and "ground_check=OK" in out
    assert "search_launches=0" in out      # CPU tensors: the plain version
    with pytest.raises(ValueError, match="cuda_resident"):
        solve.main(["--n", "5", "--device", "cpu",
                    "--supersteps-per-launch", "4"])
