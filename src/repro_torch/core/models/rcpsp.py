"""RCPSP — resource-constrained project scheduling (paper §PCCP example).

The PyTorch port's own copy of ``repro/core/models/rcpsp.py``: the same
seeded generator, model, ground checker and parsers (numpy only).

The exact PCCP model of the paper:

    ∃s_i : IZ (starting dates),  ∃b_{ij} : IZ over (0,1) (overlap booleans)
    s_i ← (0, h)   ∥   b_{ij} ← (0, 1)
    ∥  ∀(i ≪ j) ∈ P,   ⟦ s_i + d_i ≤ s_j ⟧
    ∥  ∀i, j,          ⟦ b_{ij} ⇔ (s_i ≤ s_j ∧ s_j < s_i + d_i) ⟧
    ∥  ∀k, j,          ⟦ Σ_i r_{k,i} · b_{i,j} ≤ c_k ⟧

i.e. the standard cumulative decomposition (Schutt et al. 2009).  The
paper's `lsum` helper variable in the resource compilation is an indexical
implementation detail — the direct K-ary linear propagator here has the
same propagation strength and entailment condition.

Makespan objective: minimize `mk` with ∀i, s_i + d_i ≤ mk (classic).

Offline data policy (DESIGN.md §8): the Patterson / PSPLIB j30 suites are
not shipped in this container, so `generate(...)` produces seeded random
instances of the same family (n tasks, precedence DAG, ≤4 renewable
resources, capacities between max single demand and total demand).  The
`.rcp` (Patterson) and `.sm` (PSPLIB) parsers below accept the real files
whenever they are available.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.model import Model
from repro_torch.core import search as S


@dataclasses.dataclass
class RCPSP:
    """⟨T, P, R⟩ with durations d, usages r[k,i], capacities c[k]."""

    durations: np.ndarray                  # i[n]
    precedences: List[Tuple[int, int]]     # (i, j): i ≪ j
    usage: np.ndarray                      # i[K, n]
    capacity: np.ndarray                   # i[K]
    name: str = "rcpsp"

    @property
    def n_tasks(self) -> int:
        return len(self.durations)

    @property
    def n_resources(self) -> int:
        return len(self.capacity)

    @property
    def horizon(self) -> int:
        return int(self.durations.sum())


def build_model(inst: RCPSP, var_strategy: str = S.MIN_LB,
                decompose: bool = False) -> Tuple[Model, dict]:
    """Compile the paper's PCCP model for an instance.

    Since §12 each renewable resource lowers to ONE native `Cumulative`
    table row (time-table filtering).  ``decompose=True`` emits the
    paper-faithful pre-§12 lowering instead — the overlap-boolean
    decomposition (Schutt et al. 2009) with its O(n²) booleans and
    ~4·n² `ReifLinLe` rows — kept as the parity oracle.

    Returns (model, handles) where handles maps names to variable lists
    (``b`` is None in the native lowering).
    """
    n = inst.n_tasks
    h = inst.horizon
    d = [int(x) for x in inst.durations]
    m = Model(name=inst.name)

    s = [m.int_var(0, h, f"s{i}") for i in range(n)]
    mk = m.int_var(0, h, "makespan")

    b = None
    if decompose:
        # b[i][j] ⇔ (s_i ≤ s_j ∧ s_j ≤ s_i + d_i - 1): i runs at s_j's start
        b = [[None] * n for _ in range(n)]
        for i in range(n):
            for j in range(n):
                bij = m.bool_var(f"b{i}_{j}")
                b[i][j] = bij
                if d[i] == 0:
                    m.add(bij <= 0)        # zero-duration: never overlaps
                    continue
                m.iff_and(bij, [s[i] - s[j] <= 0,
                                s[j] - s[i] <= d[i] - 1])

    for (i, j) in inst.precedences:
        m.add(s[i] + d[i] <= s[j])

    for k in range(inst.n_resources):
        c_k = int(inst.capacity[k])
        used = [i for i in range(n) if int(inst.usage[k, i]) > 0]
        if not used:
            continue
        if decompose:
            for j in range(n):
                terms = [(int(inst.usage[k, i]), b[i][j]) for i in used]
                expr = sum((coef * var for coef, var in terms), start=0)
                m.add(expr <= c_k)
        else:
            m.cumulative([s[i] for i in used], [d[i] for i in used],
                         [int(inst.usage[k, i]) for i in used], c_k)

    for i in range(n):
        m.add(s[i] + d[i] <= mk)
    m.minimize(mk)
    m.branch_on(s + [mk])                  # booleans follow by propagation
    return m, dict(s=s, b=b, mk=mk, check_vars=s)


def check_solution(inst: RCPSP, starts: Sequence[int]) -> Tuple[bool, int]:
    """Ground checker (independent of the solver): precedence + resource
    profile over time. Returns (feasible, makespan).  The profile only
    rises where a task starts, so it is read at those points in
    [0, makespan) (the same verdict as reading every time point, and
    fast when durations are large)."""
    st = np.asarray(starts, dtype=np.int64)
    d = np.asarray(inst.durations, dtype=np.int64)
    for (i, j) in inst.precedences:
        if st[i] + d[i] > st[j]:
            return False, -1
    mk = int((st + d).max()) if len(st) else 0
    points = np.maximum(st[(d > 0) & (st + d > 0)], 0)
    for t in np.unique(points[points < mk]):
        run = (st <= t) & (t < st + d)
        for k in range(inst.n_resources):
            if inst.usage[k][run].sum() > inst.capacity[k]:
                return False, -1
    return True, mk


def generate(n_tasks: int, n_resources: int = 4, seed: int = 0,
             edge_prob: float = 0.15, max_duration: int = 8,
             max_usage: int = 6, tightness: float = 0.55) -> RCPSP:
    """Seeded generator in the Patterson/j30 family.

    `tightness` interpolates capacities between the max single demand
    (hard) and the max concurrent demand (trivial): lower = harder.
    """
    rng = np.random.default_rng(seed)
    d = rng.integers(1, max_duration + 1, size=n_tasks)
    prec = []
    for i in range(n_tasks):
        for j in range(i + 1, n_tasks):
            if rng.random() < edge_prob:
                prec.append((i, j))
    usage = rng.integers(0, max_usage + 1, size=(n_resources, n_tasks))
    # every task uses at least one resource (j30 style)
    for i in range(n_tasks):
        if usage[:, i].sum() == 0:
            usage[rng.integers(0, n_resources), i] = 1 + int(
                rng.integers(0, max_usage))
    single = usage.max(axis=1)
    total = usage.sum(axis=1)
    cap = np.maximum(single,
                     (single + tightness * (total - single)).astype(np.int64))
    return RCPSP(durations=d, precedences=prec, usage=usage, capacity=cap,
                 name=f"gen-n{n_tasks}-k{n_resources}-s{seed}")


# ---------------------------------------------------------------------------
# parsers for the real suites (used when files are present)
# ---------------------------------------------------------------------------

def parse_patterson(path: str) -> RCPSP:
    """Patterson .rcp format: n, K / capacities / per-task: d, r_1..r_K,
    n_succ, successors (1-based, includes dummy source/sink)."""
    toks: List[int] = []
    with open(path) as f:
        for line in f:
            toks += [int(t) for t in line.split()]
    it = iter(toks)
    n = next(it)
    k = next(it)
    cap = np.array([next(it) for _ in range(k)], dtype=np.int64)
    dur = np.zeros(n, dtype=np.int64)
    usage = np.zeros((k, n), dtype=np.int64)
    prec: List[Tuple[int, int]] = []
    for i in range(n):
        dur[i] = next(it)
        for r in range(k):
            usage[r, i] = next(it)
        ns = next(it)
        for _ in range(ns):
            prec.append((i, next(it) - 1))
    return RCPSP(dur, prec, usage, cap, name=path.rsplit("/", 1)[-1])


def parse_psplib_sm(path: str) -> RCPSP:
    """PSPLIB single-mode .sm parser (j30/j60/...)."""
    with open(path) as f:
        lines = f.readlines()
    n = None
    i = 0
    prec: List[Tuple[int, int]] = []
    dur = usage = cap = None
    while i < len(lines):
        ln = lines[i]
        if "jobs (incl. supersource" in ln:
            n = int(ln.split(":")[1].strip())
        if ln.strip().startswith("jobnr.") and "#successors" in ln.replace(" ", ""):
            i += 1
            for _ in range(n):
                parts = [int(x) for x in lines[i].split()]
                j = parts[0] - 1
                for succ in parts[3:3 + parts[2]]:
                    prec.append((j, succ - 1))
                i += 1
            continue
        if ln.strip().startswith("jobnr.") and "duration" in ln:
            i += 2
            dur = np.zeros(n, dtype=np.int64)
            rows = []
            for _ in range(n):
                parts = [int(x) for x in lines[i].split()]
                dur[parts[0] - 1] = parts[2]
                rows.append(parts[3:])
                i += 1
            usage = np.asarray(rows, dtype=np.int64).T
            continue
        if "RESOURCEAVAILABILITIES" in ln.replace(" ", ""):
            i += 2
            cap = np.array([int(x) for x in lines[i].split()], dtype=np.int64)
        i += 1
    assert n is not None and dur is not None and cap is not None
    return RCPSP(dur, prec, usage, cap, name=path.rsplit("/", 1)[-1])
