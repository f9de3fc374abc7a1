"""Product configuration — mixed extensional + linear optimization
(DESIGN.md §10, §17).

The PyTorch port's own copy of ``repro/core/models/configuration.py``:
the same seeded generator, model and ground checker (numpy only).

Pick one option per component (`x_i ∈ (0, m-1)`) subject to pairwise
compatibility: each dependent pair (i, j) carries an arity-2 `Table` of
the allowed option combinations.  Cost couples in through a second CT
shape — a per-component *weight-link* table `{(o, w_i[o])}` binding the
option var to its price var — and a linear row sums the price vars into
the minimized objective.  This is the mixed workload the bounds-only
engine handles worst (compatibility sets are full of holes) and
Compact-Table handles natively; ``decompose=True`` emits the reified
disjunction oracle for every table.

`generate(k, m, seed)` plants a random full assignment and makes it
compatible on every pair (always SAT), then mixes in seeded extra
compatible pairs so the optimum is a non-trivial search.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core.model import Model


@dataclasses.dataclass
class Configuration:
    k: int                                  # components
    m: int                                  # options per component
    weights: List[List[int]]                # k×m option prices
    pairs: List[Tuple[int, int]]            # dependent component pairs
    compat: List[List[Tuple[int, int]]]     # allowed option pairs, per pair
    name: str = "configuration"


def generate(k: int, m: int, seed: int = 0,
             extra_prob: float = 0.3) -> Configuration:
    """Seeded instance: ring + random-chord dependency graph, planted
    compatible assignment, `extra_prob` of the remaining option pairs
    allowed per edge."""
    rng = np.random.default_rng(seed)
    weights = [[int(w) for w in rng.integers(1, 9, size=m)]
               for _ in range(k)]
    planted = [int(o) for o in rng.integers(0, m, size=k)]
    pairs = [(i, i + 1) for i in range(k - 1)]
    if k > 2:
        pairs.append((0, k - 1))
    chords = [(i, j) for i in range(k) for j in range(i + 2, k - 1)]
    pairs += [p for p in chords if rng.random() < 0.2]
    compat = []
    for (i, j) in pairs:
        allowed = {(planted[i], planted[j])}
        for a in range(m):
            for b in range(m):
                if rng.random() < extra_prob:
                    allowed.add((a, b))
        compat.append(sorted(allowed))
    return Configuration(k=k, m=m, weights=weights, pairs=pairs,
                         compat=compat,
                         name=f"configuration-k{k}-m{m}-s{seed}")


def build_model(inst: Configuration,
                decompose: bool = False) -> Tuple[Model, dict]:
    k, m_opts = inst.k, inst.m
    m = Model(name=inst.name)
    xs = [m.int_var(0, m_opts - 1, f"x{i}") for i in range(k)]
    ws = []
    for i in range(k):
        wi = inst.weights[i]
        w = m.int_var(min(wi), max(wi), f"w{i}")
        # weight link: one CT row binding the option to its price
        m.table([xs[i], w], [(o, wi[o]) for o in range(m_opts)],
                decompose=decompose)
        ws.append(w)
    for (i, j), allowed in zip(inst.pairs, inst.compat):
        m.table([xs[i], xs[j]], allowed, decompose=decompose)
    total = m.int_var(0, sum(max(wi) for wi in inst.weights), "total")
    expr = ws[0]._as_expr()
    for w in ws[1:]:
        expr = expr + w
    for c in expr.eq(total):
        m.add(c)
    m.minimize(total)
    m.branch_on(xs)
    return m, dict(x=xs, w=ws, total=total, check_vars=xs)


def check_solution(inst: Configuration,
                   options: Sequence[int]) -> Tuple[bool, int]:
    """Ground checker: every dependent pair compatible.
    Returns (feasible, objective) with objective = Σ price."""
    v = [int(x) for x in options]
    if len(v) != inst.k or any(not (0 <= x < inst.m) for x in v):
        return False, -1
    for (i, j), allowed in zip(inst.pairs, inst.compat):
        if (v[i], v[j]) not in set(allowed):
            return False, -1
    return True, sum(inst.weights[i][v[i]] for i in range(inst.k))
