"""N-queens 256 (the sparse AllDifferent bank at the zoo's large tier)
solved by the port and by the JAX package, both through ``gather``.

The card finds no solution of N-queens 256 under first-fail with
bisection; this holds the port's search to the reference's over its
first supersteps, from the same EPS pool: 8 lanes, eps_target 16,
``min_dom``/``split``, ``stop_on_first``, and ``chunk`` =
``max_supersteps`` = 32.  Status and every counter must be equal.
``scripts/nqueens256_parity.py --supersteps 256`` runs the same
comparison further (about three minutes on one CPU).
"""

import torch

from repro.core import api as japi
from repro.core.models import nqueens as jnqueens
from repro_torch.core import api as tapi
from test_torch_compile import port_from_jax

torch.set_num_threads(1)      # small tensors: thread hand-offs cost more

COUNTERS = ("status", "objective", "n_nodes", "n_fails", "n_sols",
            "n_sweeps", "n_supersteps", "complete")


def compare(supersteps: int):
    """(JAX result, port result) of N-queens 256 cut at `supersteps`;
    raises AssertionError naming the first counter that differs."""
    jcm = jnqueens.build_model(jnqueens.generate(256, seed=0))[0].compile()
    cm = port_from_jax(jcm)
    assert cm.ad_layout == "sparse"
    kw = dict(n_lanes=8, eps_target=16, var_strategy="min_dom",
              val_strategy="split", stop_on_first=True, chunk=supersteps,
              max_supersteps=supersteps, backend="gather")
    ref = japi.Solver(japi.SolveConfig(**kw)).solve(jcm)
    got = tapi.Solver(tapi.SolveConfig(device="cpu", **kw)).solve(cm)
    for k in COUNTERS:
        assert getattr(got, k) == getattr(ref, k), (
            f"{k}: port {getattr(got, k)}, JAX {getattr(ref, k)}")
    return ref, got


def test_nqueens256_first_supersteps_match_jax():
    ref, got = compare(32)
    assert got.n_supersteps == 32 and got.n_nodes > 0
