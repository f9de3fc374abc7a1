"""Graph coloring — chromatic-number search (DESIGN.md §10, §12).

The PyTorch port's own copy of ``repro/core/models/coloring.py``:
the same seeded generator, model and ground checker (numpy only).

Color variable `c_i` per vertex, `c_i ≠ c_j` per edge, and a `cmax`
variable with `c_i ≤ cmax` minimized by branch & bound — the optimum is
χ(G) - 1.  Since §12 each edge lowers to ONE native two-member
`AllDifferent` row (1 table row per edge instead of the 3 `ReifLinLe`
rows + 2 fresh booleans of the reified-disjunction `Model.neq`
decomposition, which ``build_model(inst, decompose=True)`` still emits
as the parity oracle).

Value-symmetry breaking: vertex i's domain is `(0, min(i, n-1))` — any
coloring can be relabeled so colors appear in first-use order, so
restricting vertex i to the first i+1 colors preserves the chromatic
number while cutting the k! color-permutation symmetry.

`generate(n, seed)` samples a G(n, p) Erdős–Rényi graph.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core.model import Model


@dataclasses.dataclass
class Coloring:
    n: int
    edges: List[Tuple[int, int]]
    name: str = "coloring"


def generate(n: int, seed: int = 0, edge_prob: float = 0.5) -> Coloring:
    """Seeded G(n, p) instance; isolated vertices are fine (color 0)."""
    rng = np.random.default_rng(seed)
    edges = [(i, j) for i in range(n) for j in range(i + 1, n)
             if rng.random() < edge_prob]
    return Coloring(n=n, edges=edges,
                    name=f"coloring-n{n}-p{edge_prob}-s{seed}")


def build_model(inst: Coloring, decompose: bool = False) -> Tuple[Model, dict]:
    n = inst.n
    m = Model(name=inst.name)
    c = [m.int_var(0, min(i, n - 1), f"c{i}") for i in range(n)]
    cmax = m.int_var(0, n - 1, "cmax")
    for (i, j) in inst.edges:
        if decompose:
            m.neq(c[i], c[j])
        else:
            m.alldifferent([c[i], c[j]])
    for i in range(n):
        m.add(c[i] <= cmax)
    m.minimize(cmax)
    m.branch_on(c + [cmax])
    return m, dict(c=c, cmax=cmax, check_vars=c)


def check_solution(inst: Coloring, colors: Sequence[int]) -> Tuple[bool, int]:
    """Ground checker: proper coloring. Returns (feasible, max color)."""
    col = [int(x) for x in colors]
    if len(col) != inst.n:
        return False, -1
    for (i, j) in inst.edges:
        if col[i] == col[j]:
            return False, -1
    return True, max(col) if col else 0
