"""The model zoo (DESIGN.md §10) — the PyTorch port's own copy of
``repro/core/models/__init__.py``, with the same models and tiers.

Every workload compiles through the same `ReifLinLe` guarded normal form
(`core/model.py` → `core/compile.py`), so each runs unchanged on every
propagation backend and through the EPS-decomposed engine.  A zoo module
exposes the uniform protocol:

* ``generate(size..., seed=0)`` — seeded reproducible instance;
* ``build_model(inst) -> (Model, handles)`` — handles include
  ``check_vars``, the IntVars (in order) that ``check_solution`` expects;
* ``check_solution(inst, values) -> (feasible, objective)`` — ground
  checker independent of the solver, with `objective` in *model* terms
  (i.e. what the engine minimizes — negated profit for knapsack).

``ZOO`` maps the canonical names to the modules; ``small_instance``
yields the seeded smoke instances used by the port's tests and
``chip_smoke.py``.

The port propagates and solves all seven at every tier: rcpsp, knapsack
and jobshop through the ReifLinLe and Cumulative banks (dense, or
sparse where the auto crossover puts the large tiers), nqueens and
coloring through the AllDifferent bank (likewise), crossword and
configuration through the Compact-Table bank and the bitset store.
"""

from __future__ import annotations

from repro_torch.core.models import (coloring, configuration, crossword,
                                     jobshop, knapsack, nqueens, rcpsp)

ZOO = {
    "rcpsp": rcpsp,
    "nqueens": nqueens,
    "coloring": coloring,
    "knapsack": knapsack,
    "jobshop": jobshop,
    "crossword": crossword,
    "configuration": configuration,
}


# per-model generate() kwargs for the three instance tiers:
# smoke (seconds-to-optimum on every backend), bench (heavier), and
# large (industrial sizes exercising the sparse bank layouts,
# DESIGN.md §16 — compiled/bench-inspected everywhere; solved to proven
# optimum only where the `large`-marked tests say so)
_TIERS = {
    "rcpsp": (dict(n_tasks=5, n_resources=2, edge_prob=0.3),
              dict(n_tasks=8, n_resources=3, edge_prob=0.25),
              dict(n_tasks=96, n_resources=4, edge_prob=0.06)),
    "nqueens": (dict(n=5), dict(n=7), dict(n=256)),
    "coloring": (dict(n=6, edge_prob=0.5), dict(n=9, edge_prob=0.45),
                 dict(n=64, edge_prob=0.12)),
    "knapsack": (dict(n=6), dict(n=10), dict(n=512)),
    "jobshop": (dict(n_jobs=2, n_machines=2), dict(n_jobs=3, n_machines=2),
                dict(n_jobs=20, n_machines=15)),
    "crossword": (dict(n=3), dict(n=4), dict(n=8)),
    "configuration": (dict(k=4, m=4), dict(k=6, m=5),
                      dict(k=24, m=8)),
}
assert set(_TIERS) == set(ZOO)


def _instance(name: str, tier: int, seed: int):
    try:
        kw = _TIERS[name][tier]
    except KeyError:
        raise ValueError(
            f"unknown zoo model {name!r}; have {sorted(ZOO)}") from None
    return ZOO[name].generate(seed=seed, **kw)


def small_instance(name: str, seed: int = 0):
    """Seeded small instance of each zoo model: solvable to proven
    optimum in seconds on every backend (the smoke/CI tier)."""
    return _instance(name, 0, seed)


def bench_instance(name: str, seed: int = 0):
    """Larger seeded instance per model (the benchmark tier)."""
    return _instance(name, 1, seed)


def large_instance(name: str, seed: int = 0):
    """Industrial-size seeded instance per model (the scale tier,
    DESIGN.md §16): 10²–10³ variables, compiled onto the sparse bank
    layouts by the auto crossover (coloring's stays dense: ``chip_smoke.py``
    solves it on the card)."""
    return _instance(name, 2, seed)


def ground_check(mod, inst, handles, res):
    """Ground-check a SolveResult against `mod.check_solution`: True/False
    for a checked solution, None when there is no solution to check
    (timeout/UNSAT — distinct from a checker failure)."""
    if res.solution is None:
        return None
    vals = [int(res.solution[v.idx]) for v in handles["check_vars"]]
    ok, obj = mod.check_solution(inst, vals)
    return bool(ok and obj == res.objective)
