"""N-queens — the classic CP benchmark (DESIGN.md §10, §12).

The PyTorch port's own copy of ``repro/core/models/nqueens.py``:
the same seeded generator, model and ground checker (numpy only).

Place n queens, one per row, so that no two share a column or diagonal.
Column variable `q_i ∈ (0, n-1)` per row; the three all-different families

    alldifferent(q_i),  alldifferent(q_i + i),  alldifferent(q_i - i)

lower (since §12) to THREE native `AllDifferent` propagator-table rows —
bounds(Z)-consistent Hall-interval filtering in the fixpoint engine.
``build_model(inst, decompose=True)`` emits the pre-§12 lowering instead:
each family decomposed by `Model.neq` into the paper's reified
disjunction b< ⇔ (lhs < rhs) ∥ b> ⇔ (lhs > rhs) ∥ b< + b> ≥ 1 — a
3·3·n(n-1)/2-row `ReifLinLe` blowup kept as the parity oracle
(tests/test_propagators.py); both run unchanged on every backend.

The engine is branch & bound, so the zoo's satisfaction problems carry a
canonical objective: minimize `q_0` (the first queen's column).  Its
optimum is a deterministic instance invariant — ideal for cross-backend
identity checks.  `generate` takes (size, seed) for protocol uniformity
with the rest of the zoo; the instance is fully determined by `n`, so the
seed only stamps the name.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

from repro_torch.core.model import Model


@dataclasses.dataclass
class NQueens:
    n: int
    name: str = "nqueens"


def generate(n: int, seed: int = 0) -> NQueens:
    """Seeded generator (zoo protocol): n-queens of size `n`."""
    return NQueens(n=n, name=f"nqueens-n{n}-s{seed}")


def build_model(inst: NQueens, decompose: bool = False) -> Tuple[Model, dict]:
    n = inst.n
    m = Model(name=inst.name)
    q = [m.int_var(0, n - 1, f"q{i}") for i in range(n)]
    if decompose:
        for i in range(n):
            for j in range(i + 1, n):
                # q_i ≠ q_j + c for c ∈ {0, j-i, i-j}: column + diagonals
                for c in (0, j - i, i - j):
                    m.neq(q[i], q[j] + c)
    else:
        # columns, ↗ diagonals (q_i + i), ↘ diagonals (q_i - i): one
        # native row each (q_i = q_j + (j-i) ⇔ q_i + i = q_j + j, etc.)
        m.alldifferent(q)
        m.alldifferent(q, offsets=[i for i in range(n)])
        m.alldifferent(q, offsets=[-i for i in range(n)])
    m.minimize(q[0])
    m.branch_on(q)
    return m, dict(q=q, check_vars=q)


def check_solution(inst: NQueens, cols: Sequence[int]) -> Tuple[bool, int]:
    """Ground checker: pairwise column/diagonal clashes.
    Returns (feasible, objective) with objective = q_0."""
    n = inst.n
    c = [int(x) for x in cols]
    if len(c) != n or any(not (0 <= x < n) for x in c):
        return False, -1
    for i in range(n):
        for j in range(i + 1, n):
            if c[i] == c[j] or abs(c[i] - c[j]) == j - i:
                return False, -1
    return True, c[0]
