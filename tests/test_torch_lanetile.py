"""The port's lane-tiled resident search against the JAX package's.

* `search_plain(..., lane_tile=N)` (the plain version of the port's
  `search_cuda` in its lane-tiled mode, which the wrapper runs on CPU
  tensors) against JAX `search_pallas(..., lane_tile=N,
  interpret=True)`: tile t of the lanes draws pool indices t, t+NT, …
  with its own cursor, bound, superstep count and done flag.  Every
  LaneState field, the least bound, the largest superstep count, the
  ``[NT]`` pool cursors and the stop flag are exactly equal: 8 lanes in
  tiles of 4, 12 lanes in tiles of 8 (a short last tile, which the
  reference pads with inert lanes), tiles of one lane, and under
  ``stop_on_first``.
* `Solver(backend="cuda_resident", lane_tile=4, device="cpu")` against
  JAX `Solver(backend="pallas_resident", backend_opts=(("lane_tile",
  4),))`: status, objective and every counter.
* `SolveConfig` and the CLI refuse a lane tile off ``cuda_resident`` and
  a non-positive one.
"""

import numpy as np
import pytest

from repro import solver as jsolver
from repro.kernels import fixpoint_kernel as JFK
from repro_torch import solver as tsolver
from repro_torch.kernels import fixpoint_kernel as TFK
from test_torch_compile import port_from_jax
from test_torch_resident import COUNTERS, _both, _small
from test_torch_search import _assert_state_equal

# name: (lanes, eps, warm supersteps, lane tile, K, options)
CASES = {
    "l8_tile4": (8, 8, 0, 4, 16, {}),
    "l8_tile4_warm_min_lb_split": (8, 16, 2, 4, 8,
                                   dict(var_strategy="min_lb",
                                        val_strategy="split")),
    "l12_tile8_short_last": (12, 16, 0, 8, 16, {}),
    "l8_tile1": (8, 8, 0, 1, 8, {}),
    "l8_tile4_stop_on_first": (8, 8, 0, 4, 16, dict(stop_on_first=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tiled_search_plain_matches_search_pallas(case):
    lanes, target, warm, tile, k, opt_kw = CASES[case]
    jcm = _small()
    jargs, targs = _both(jcm, lanes, target, warm, False, opt_kw)
    kw = dict(supersteps=k, lane_tile=tile,
              var_strategy=opt_kw.get("var_strategy", "input_order"),
              val_strategy=opt_kw.get("val_strategy", "min"),
              stop_on_first=opt_kw.get("stop_on_first", False))
    jst, jg, jit, jh, jstop = JFK.search_pallas(jcm, *jargs,
                                                interpret=True, **kw)
    tst, tg, tit, th, tstop = TFK.search_plain(port_from_jax(jcm), *targs,
                                               **kw)
    n_tiles = -(-lanes // tile)
    _assert_state_equal(jst, tst, case)
    assert tuple(th.shape) == tuple(jh.shape) == (n_tiles,)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert (int(tg), int(tit), bool(tstop)) == \
        (int(jg), int(jit), bool(jstop))
    assert tg.dtype == targs[3].dtype and tg.shape == ()
    assert int(np.asarray(jst.n_nodes).sum()) > 0
    if kw["stop_on_first"]:
        assert bool(tstop) and int(tit) < k, "no mid-launch stop"
    # a launch from the result runs on from each tile's own cursor
    again = TFK.search_plain(port_from_jax(jcm), *targs[:2], tst, tg, tit,
                             th, **kw)
    jagain = JFK.search_pallas(jcm, *jargs[:2], jst, jg, jit, jh,
                               interpret=True, **kw)
    _assert_state_equal(jagain[0], again[0], case + " again")
    np.testing.assert_array_equal(again[3].numpy(), np.asarray(jagain[3]))


def test_tiled_search_cuda_on_cpu_is_search_plain():
    jcm = _small()
    _, targs = _both(jcm, 8, 8, 0, False, {})
    cm = port_from_jax(jcm)
    before = TFK.search_cuda.launches
    got = TFK.search_cuda(cm, *targs, supersteps=4, lane_tile=4)
    ref = TFK.search_plain(cm, *targs, supersteps=4, lane_tile=4)
    assert TFK.search_cuda.launches == before
    for a, b in zip(ref[1:], got[1:]):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert TFK.lane_tiles(12, 8) == (8, 2)
    assert TFK.lane_tiles(8, 64) == (8, 1)
    assert TFK.lane_tiles(8, 1) == (1, 8)


@pytest.mark.parametrize("preset", ["prove", "first_solution"])
def test_tiled_resident_solve_matches_jax_pallas_resident(preset):
    jcm = _small()
    kw = dict(n_lanes=8, eps_target=8, timeout_s=600, max_depth=512,
              supersteps_per_launch=8)
    ref = jsolver.Solver(jsolver.SolveConfig.preset(
        preset, backend="pallas_resident",
        backend_opts=(("lane_tile", 4),), **kw)).solve(jcm)
    got = tsolver.Solver(tsolver.SolveConfig.preset(
        preset, backend="cuda_resident", lane_tile=4, device="cpu",
        **kw)).solve(port_from_jax(jcm))
    for c in COUNTERS:
        assert getattr(got, c) == getattr(ref, c), c
    np.testing.assert_array_equal(got.solution, ref.solution)
    assert got.status == ("SAT" if preset == "first_solution"
                          else "OPTIMAL")


def test_config_and_cli_lane_tile():
    cfg = tsolver.SolveConfig(backend="cuda_resident", device="cpu",
                              lane_tile=4)
    assert cfg.lane_tile == 4
    with pytest.raises(ValueError, match="cuda_resident"):
        tsolver.SolveConfig(backend="cuda", device="cpu", lane_tile=4)
    with pytest.raises(ValueError, match="cuda_resident"):
        tsolver.SolveConfig(backend="gather", device="cpu", lane_tile=4)
    for bad in (0, -1, 2.5, "4"):
        with pytest.raises(ValueError, match="positive int"):
            tsolver.SolveConfig(backend="cuda_resident", device="cpu",
                                lane_tile=bad)
    from repro_torch.launch import solve
    for argv in (["--lane-tile", "4"],
                 ["--backend", "gather", "--lane-tile", "4"]):
        with pytest.raises(SystemExit):
            solve.main(["--n", "5", "--device", "cpu", *argv])
    with pytest.raises(ValueError, match="positive int"):
        solve.main(["--n", "5", "--device", "cpu", "--backend",
                    "cuda_resident", "--lane-tile", "0"])


def test_cli_lane_tile_on_cpu(capsys):
    from repro_torch.launch import solve
    solve.main(["--n", "8", "--lanes", "16", "--device", "cpu",
                "--backend", "cuda_resident", "--supersteps-per-launch",
                "4", "--lane-tile", "4"])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert "OPTIMAL" in out and "ground_check=OK" in out
    assert "search_launches=0" in out      # CPU tensors: the plain version
