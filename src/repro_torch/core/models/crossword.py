"""Crossword grid fill — the Compact-Table flagship workload (DESIGN.md
§10, §17).

The PyTorch port's own copy of ``repro/core/models/crossword.py``:
the same seeded generator, model and ground checker (numpy only).

Fill an n×n grid with letters (0..25) so every row *and* every column,
read left-to-right / top-to-bottom, is a word from a shared lexicon.
Each of the 2n line constraints lowers to ONE native extensional
`Table` row over the packed-support bank — the classic CT benchmark
shape: few constraints, wide arity, shared tuple set.
``build_model(inst, decompose=True)`` emits the paper-style oracle
instead: one reified conjunction per (line, word) plus a Σb ≥ 1
disjunction row — a |lexicon|·2n `ReifLinLe` blowup kept for parity.

`generate(n, seed)` plants a uniformly random grid, takes its rows and
columns as the lexicon core (so the instance is always SAT), and mixes
in seeded decoy words.  The canonical objective is the top-left cell
`g[0][0]` (satisfaction model, zoo protocol) — a deterministic instance
invariant for cross-backend identity checks.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core.model import Model


@dataclasses.dataclass
class Crossword:
    n: int
    lexicon: List[Tuple[int, ...]]
    name: str = "crossword"


def generate(n: int, seed: int = 0, n_decoys: int = -1) -> Crossword:
    """Seeded instance: planted random grid + `n_decoys` decoy words
    (default 2n).  The planted grid guarantees satisfiability."""
    rng = np.random.default_rng(seed)
    grid = rng.integers(0, 26, size=(n, n))
    words = {tuple(int(x) for x in row) for row in grid}
    words |= {tuple(int(x) for x in col) for col in grid.T}
    if n_decoys < 0:
        n_decoys = 2 * n
    target = len(words) + n_decoys
    while len(words) < target:
        words.add(tuple(int(x) for x in rng.integers(0, 26, size=n)))
    return Crossword(n=n, lexicon=sorted(words),
                     name=f"crossword-n{n}-s{seed}")


def build_model(inst: Crossword, decompose: bool = False) -> Tuple[Model, dict]:
    n = inst.n
    m = Model(name=inst.name)
    g = [[m.int_var(0, 25, f"g{i}_{j}") for j in range(n)] for i in range(n)]
    for i in range(n):
        m.table(g[i], inst.lexicon, decompose=decompose)
    for j in range(n):
        m.table([g[i][j] for i in range(n)], inst.lexicon,
                decompose=decompose)
    cells = [g[i][j] for i in range(n) for j in range(n)]
    m.minimize(g[0][0])
    m.branch_on(cells)
    return m, dict(g=g, check_vars=cells)


def check_solution(inst: Crossword, letters: Sequence[int]) -> Tuple[bool, int]:
    """Ground checker: every row and column word is in the lexicon.
    Returns (feasible, objective) with objective = g[0][0]."""
    n = inst.n
    v = [int(x) for x in letters]
    if len(v) != n * n or any(not (0 <= x < 26) for x in v):
        return False, -1
    grid = [v[i * n:(i + 1) * n] for i in range(n)]
    lex = set(inst.lexicon)
    for i in range(n):
        if tuple(grid[i]) not in lex:
            return False, -1
    for j in range(n):
        if tuple(grid[i][j] for i in range(n)) not in lex:
            return False, -1
    return True, grid[0][0]
