"""0/1 knapsack — pure linear arithmetic on booleans (DESIGN.md §10).

The PyTorch port's own copy of ``repro/core/models/knapsack.py``:
the same seeded generator, model and ground checker (numpy only).

Item booleans `x_i ∈ (0, 1)`, one capacity constraint
`Σ w_i x_i ≤ C`, and profit channelled into the minimization objective:

    negprofit ∈ (-Σp, 0),   Σ p_i x_i + negprofit = 0,   minimize negprofit

so the model objective is the *negated* best profit (the engine only
minimizes).  No reification is needed — the zoo's stress test for the
plain K-ary linear propagator with mixed-sign coefficients.

`dp_optimum` is the exact dynamic program over capacity, the independent
oracle the tests compare the solver against.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

from repro_torch.core.model import LinExpr, Model


@dataclasses.dataclass
class Knapsack:
    weights: np.ndarray        # i[n]
    profits: np.ndarray        # i[n]
    capacity: int
    name: str = "knapsack"

    @property
    def n_items(self) -> int:
        return len(self.weights)


def generate(n: int, seed: int = 0, max_weight: int = 9,
             max_profit: int = 9) -> Knapsack:
    """Seeded instance: uniform weights/profits, capacity = half the
    total weight (the classic hard regime)."""
    rng = np.random.default_rng(seed)
    w = rng.integers(1, max_weight + 1, size=n)
    p = rng.integers(1, max_profit + 1, size=n)
    cap = max(int(w.sum()) // 2, int(w.max()))
    return Knapsack(weights=w, profits=p, capacity=cap,
                    name=f"knapsack-n{n}-s{seed}")


def build_model(inst: Knapsack) -> Tuple[Model, dict]:
    n = inst.n_items
    w = [int(x) for x in inst.weights]
    p = [int(x) for x in inst.profits]
    m = Model(name=inst.name)
    x = [m.bool_var(f"x{i}") for i in range(n)]
    neg = m.int_var(-sum(p), 0, "negprofit")
    m.add(sum((w[i] * x[i] for i in range(n)), start=LinExpr({}, 0))
          <= inst.capacity)
    m.add((sum((p[i] * x[i] for i in range(n)), start=LinExpr({}, 0))
           + neg).eq(0))
    m.minimize(neg)
    m.branch_on(x)                     # negprofit follows by propagation
    return m, dict(x=x, neg=neg, check_vars=x)


def check_solution(inst: Knapsack, take: Sequence[int]) -> Tuple[bool, int]:
    """Ground checker. Returns (feasible, objective) with objective the
    model's minimized value, i.e. the *negated* profit."""
    t = np.asarray([int(v) for v in take])
    if len(t) != inst.n_items or ((t != 0) & (t != 1)).any():
        return False, 0
    if int((inst.weights * t).sum()) > inst.capacity:
        return False, 0
    return True, -int((inst.profits * t).sum())


def dp_optimum(inst: Knapsack) -> int:
    """Exact max profit by DP over capacity (independent oracle)."""
    best = np.zeros(inst.capacity + 1, dtype=np.int64)
    for w, p in zip(inst.weights, inst.profits):
        w, p = int(w), int(p)
        for c in range(inst.capacity, w - 1, -1):
            best[c] = max(best[c], best[c - w] + p)
    return int(best[inst.capacity])
