"""The port's model zoo (`repro_torch.core.models`) against the JAX one.

* Compile parity for all seven zoo models: the port's own generators
  and models compile to exactly the JAX package's tables (values and
  dtypes), statics and `shape_signature` on the small and bench tiers
  under every ``bank_layout``, and on N-queens 32 and coloring 64 (the
  card's main-path instances); a forced-dense compile that the
  reference refuses is refused alike.
* `SolveResult` parity on the smoke tier of the models the port solves
  (rcpsp, nqueens, coloring, knapsack, jobshop) under the ``prove``,
  ``fast`` and ``first_solution`` presets: the port's ``gather``,
  ``cuda`` and ``cuda_resident`` backends (on CPU tensors: the plain
  versions) against JAX ``gather``, every counter, the solution and the
  anytime trace; the solution passes the model's ground check, and the
  ``prove`` counters are the ones ``chip_smoke.py`` holds the card to.
"""

import os
import sys

import numpy as np
import pytest
import torch

from repro import solver as jsolver
from repro.core import models as jzoo
from repro_torch import solver as tsolver
from repro_torch.core import models as tzoo
from test_torch_compile import assert_same_compile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

torch.set_num_threads(1)      # tiny tensors: thread hand-offs cost more

TIERS = {"small": "small_instance", "bench": "bench_instance"}
LAYOUTS = ("auto", "dense", "sparse")


def _compile_both(name, make, **compile_kw):
    """(JAX compile or its ValueError, port compile or its ValueError)
    of one instance, each side from its own generator."""
    out = []
    for zoo, kw in ((jzoo, {}), (tzoo, dict(device="cpu"))):
        m, _ = zoo.ZOO[name].build_model(make(zoo))
        try:
            out.append(m.compile(**kw, **compile_kw))
        except ValueError as e:
            out.append(e)
    return out


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("name", sorted(jzoo.ZOO))
def test_compile_matches_jax(name, tier, layout):
    jcm, tcm = _compile_both(
        name, lambda zoo: getattr(zoo, TIERS[tier])(name, seed=0),
        bank_layout=layout)
    assert not isinstance(jcm, ValueError), jcm    # these tiers compile
    assert_same_compile(jcm, tcm)


@pytest.mark.parametrize("tag,name,make", [
    ("nqueens32", "nqueens", lambda zoo: zoo.nqueens.generate(32)),
    ("coloring64", "coloring", lambda zoo: zoo.large_instance("coloring")),
], ids=["nqueens32", "coloring64"])
def test_main_path_instances_compile_alike(tag, name, make):
    jcm, tcm = _compile_both(name, make)
    assert_same_compile(jcm, tcm)
    assert tcm.ad_layout == "dense" and tcm.dtype == "int32"
    assert tuple(tcm.ad_vars.shape) == {"nqueens32": (4, 32),
                                        "coloring64": (251, 4)}[tag]


def test_forced_dense_raises_like_the_reference():
    jerr, terr = _compile_both("nqueens",
                               lambda zoo: zoo.nqueens.generate(256),
                               bank_layout="dense")
    assert isinstance(jerr, ValueError) and isinstance(terr, ValueError)
    assert str(terr) == str(jerr)
    assert "bytes" in str(terr) and "sparse" in str(terr)


def test_zoo_tiers_and_protocol_match():
    assert sorted(tzoo.ZOO) == sorted(jzoo.ZOO)
    assert tzoo._TIERS == jzoo._TIERS
    with pytest.raises(ValueError, match="unknown zoo model"):
        tzoo.small_instance("sudoku")
    for name, mod in tzoo.ZOO.items():
        for fn in ("generate", "build_model", "check_solution"):
            assert callable(getattr(mod, fn)), (name, fn)


COUNTERS = ("status", "objective", "n_nodes", "n_fails", "n_sols",
            "n_sweeps", "n_supersteps", "complete")
PORT_BACKENDS = ("gather", "cuda", "cuda_resident")


@pytest.fixture(scope="module")
def jax_session():
    return jsolver.Solver()


@pytest.mark.parametrize("preset", ["prove", "fast", "first_solution"])
@pytest.mark.parametrize("name", chip_smoke.ZOO_SMOKE)
def test_smoke_tier_solves_match_jax(jax_session, name, preset):
    lanes = chip_smoke.ZOO_SMOKE_LANES
    jm, _ = jzoo.ZOO[name].build_model(jzoo.small_instance(name, seed=0))
    ref = jax_session.solve(jm.compile(), config=jsolver.SolveConfig.preset(
        preset, n_lanes=lanes, backend="gather"))
    inst = tzoo.small_instance(name, seed=0)
    m, handles = tzoo.ZOO[name].build_model(inst)
    cm = m.compile(device="cpu")
    for backend in PORT_BACKENDS:
        got = tsolver.Solver(tsolver.SolveConfig.preset(
            preset, n_lanes=lanes, backend=backend, device="cpu")).solve(cm)
        for k in COUNTERS:
            assert getattr(got, k) == getattr(ref, k), (backend, k)
        np.testing.assert_array_equal(got.solution, ref.solution)
        assert [i.objective for i in got.improvements] == \
            [i.objective for i in ref.improvements]
        assert tzoo.ground_check(tzoo.ZOO[name], inst, handles, got) is True
    if preset == "prove":
        # the reference counters chip_smoke.py holds the card's run to
        assert {k: getattr(ref, k) for k in
                chip_smoke.ZOO_SMOKE_REFERENCE[name]} == \
            chip_smoke.ZOO_SMOKE_REFERENCE[name]
