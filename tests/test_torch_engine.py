"""The port's legacy entry point (`repro_torch.core.engine`) and the
reference CLI flags that `launch/solve.py` gained with it (``--subs``,
``--fast``, ``--dryrun``), against the JAX package on the CPU.

* ``engine.solve`` on a J30-class RCPSP seed: status, objective and
  every counter equal to the JAX package's ``engine.solve`` with the
  same keyword arguments; it warns `DeprecationWarning` exactly once
  per call and re-exports the reference's names.
* ``--subs 16 --fast`` gives the line of ``--eps-target 16 --preset
  fast`` (and warns), and ``--subs`` is the fallback of
  ``--eps-target``.
* ``--dryrun [--multi-pod]`` prints the reference's OK line with the
  per-device bytes of the solver's shapes on the production mesh.
"""

import re
import warnings

import numpy as np
import pytest

from repro.core import engine as jengine
from repro.core import search as JS
from repro.core.models import rcpsp as jrcpsp
from repro_torch.core import engine
from repro_torch.core import search as S
from repro_torch.core.models import rcpsp as trcpsp
from repro_torch.launch import solve as cli

COUNTERS = ("status", "objective", "n_nodes", "n_fails", "n_sols",
            "n_sweeps", "n_supersteps", "complete")
KW = dict(n_tasks=30, n_resources=4, seed=1)


def _deprecations(caught):
    return [w for w in caught if issubclass(w.category, DeprecationWarning)
            and "engine.solve is deprecated" in str(w.message)]


@pytest.mark.parametrize("kw", [dict(n_lanes=16),
                                dict(n_lanes=8, n_subproblems=32,
                                     max_supersteps=20, chunk=4)],
                         ids=["defaults", "capped"])
def test_engine_solve_matches_jax(kw):
    jm, _ = jrcpsp.build_model(jrcpsp.generate(**KW))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = jengine.solve(jm.compile(),
                            opts=JS.SearchOptions(backend="gather"), **kw)
    m, handles = trcpsp.build_model(trcpsp.generate(**KW))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = engine.solve(m.compile(device="cpu"),
                           opts=S.SearchOptions(backend="gather"), **kw)
    assert len(_deprecations(caught)) == 1
    for k in COUNTERS:
        assert getattr(got, k) == getattr(ref, k), k
    if ref.solution is not None:
        np.testing.assert_array_equal(got.solution, ref.solution)


def test_engine_default_backend_and_reexports():
    """The port's default backend (``cuda``, its plain version on the
    CPU) gives the reference's ``gather`` counters; the shim re-exports
    the reference's names."""
    jm, _ = jrcpsp.build_model(jrcpsp.generate(**KW))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = jengine.solve(jm.compile(), n_lanes=16)
        m, _ = trcpsp.build_model(trcpsp.generate(**KW))
        got = engine.solve(m.compile(device="cpu"), n_lanes=16)
    for k in COUNTERS:
        assert getattr(got, k) == getattr(ref, k), k
    for name in ("OPTIMAL", "SAT", "UNSAT", "UNKNOWN"):
        assert getattr(engine, name) == getattr(jengine, name)
    for name in ("SolveResult", "Improvement", "SolveConfig",
                 "derive_result"):
        assert hasattr(engine, name)


def _fields(out):
    """The counters of the CLI's result line (no times)."""
    line = next(ln for ln in out.splitlines() if ln.startswith("gen-"))
    keep = ("objective", "nodes", "supersteps", "kernel_launches",
            "search_launches", "complete", "ground_check")
    got = dict(re.findall(r"(\w+)=(\S+)", line))
    return line.split()[1], {k: got[k] for k in keep}


def test_cli_subs_and_fast_match_eps_target_and_preset(capsys):
    base = ["--n", "8", "--lanes", "8", "--device", "cpu"]
    with pytest.warns(DeprecationWarning, match="--preset fast"):
        cli.main(base + ["--subs", "16", "--fast"])
    old = _fields(capsys.readouterr().out)
    cli.main(base + ["--eps-target", "16", "--preset", "fast"])
    new = _fields(capsys.readouterr().out)
    assert old == new and old[0] == "OPTIMAL"
    # --subs is only the fallback: --eps-target wins
    cli.main(base + ["--eps-target", "16", "--subs", "64", "--preset",
                     "fast"])
    assert _fields(capsys.readouterr().out) == new


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16",
                                                          "2x16x16"])
def test_cli_solver_dryrun(capsys, multi_pod):
    total = cli.main(["--dryrun", "--n", "6"]
                     + (["--multi-pod"] if multi_pod else []))
    out = capsys.readouterr().out
    tag, n = ("2x16x16", 512) if multi_pod else ("16x16", 256)
    assert f"SOLVER dry-run OK on {tag} ({n} devices)" in out
    assert "left out (no XLA)" in out and "solver_bound_sync" in out
    # 8 lanes per device: the lane state alone is more than the pool
    m, _ = trcpsp.build_model(trcpsp.generate(6, n_resources=4, seed=0))
    cm = m.compile(device="cpu")
    pool = 2 * 16 * cm.n_vars * 4
    assert total > pool + 8 * 2 * cm.n_vars * 4
