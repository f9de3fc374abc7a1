"""Whole solves through the port's ``scatter`` backend against the JAX
package's ``scatter`` backend.

`SolveConfig(backend="scatter")` runs EPS and every superstep's
fixpoint in the scatter form (`fixpoint.sweep_scatter_batch`).  On the
RCPSP small tier (seeds 1 and 2) and on the smoke tier of the seven-model zoo
(``small_instance(name, seed=0)``, ``prove``, 16 lanes, default
eps_target) its status, objective, every counter and the solution equal
JAX ``scatter``'s; the solution passes the model's ground check, and the
counters equal the port's ``gather`` solve (the two join strategies are
bit-identical per sweep, so the search takes the same path).
"""

import numpy as np
import pytest
import torch

from repro import solver as jsolver
from repro.core import models as jzoo
from repro_torch import solver as tsolver
from repro_torch.core import models as tzoo
from test_torch_compile import small

torch.set_num_threads(1)      # small tensors: thread hand-offs cost more

COUNTERS = ("status", "objective", "n_nodes", "n_fails", "n_sols",
            "n_sweeps", "n_supersteps", "complete")
LANES = 16


@pytest.fixture(scope="module")
def jax_session():
    return jsolver.Solver()


def _solve_both(jax_session, name, inst_of):
    jm, _ = jzoo.ZOO[name].build_model(inst_of(jzoo))
    ref = jax_session.solve(jm.compile(), config=jsolver.SolveConfig.preset(
        "prove", backend="scatter", n_lanes=LANES))
    inst = inst_of(tzoo)
    m, handles = tzoo.ZOO[name].build_model(inst)
    cm = m.compile(device="cpu")
    got = {b: tsolver.Solver(tsolver.SolveConfig.preset(
        "prove", backend=b, n_lanes=LANES, device="cpu")).solve(cm)
        for b in ("scatter", "gather")}
    for k in COUNTERS:
        assert getattr(got["scatter"], k) == getattr(ref, k), k
        assert getattr(got["gather"], k) == getattr(ref, k), ("gather", k)
    np.testing.assert_array_equal(got["scatter"].solution, ref.solution)
    assert tzoo.ground_check(tzoo.ZOO[name], inst, handles,
                             got["scatter"]) is True
    return got["scatter"]


@pytest.mark.parametrize("seed", [1, 2])
def test_rcpsp_small_matches_jax_scatter(jax_session, seed):
    """RCPSP small-tier seeds beside the zoo's (seed 0 is its smoke
    instance)."""
    res = _solve_both(jax_session, "rcpsp",
                      lambda zoo: zoo.rcpsp.generate(**small(seed)))
    assert res.status == "OPTIMAL"


@pytest.mark.parametrize("name", sorted(tzoo.ZOO))
def test_zoo_smoke_matches_jax_scatter(jax_session, name):
    res = _solve_both(jax_session, name,
                      lambda zoo: zoo.small_instance(name, seed=0))
    assert res.status == "OPTIMAL"
