"""Job-shop scheduling — disjunctive machines (DESIGN.md §10, §12).

The PyTorch port's own copy of ``repro/core/models/jobshop.py``:
the same seeded generator, model and ground checker (numpy only).

Each job is a fixed sequence of operations, one per machine, with
durations; operations of different jobs on the same machine must not
overlap.  Start variable `s_{j,k}` per operation:

    within-job precedence:  s_{j,k} + d_{j,k} ≤ s_{j,k+1}        (plain)
    machine exclusivity:    cumulative(ops on machine, dem 1, cap 1)
    makespan:               s_{j,last} + d ≤ mk,  minimize mk

Since §12 each machine lowers to ONE native unit-capacity `Cumulative`
row (time-table filtering — the disjunctive case).  ``build_model(inst,
decompose=True)`` emits the pre-§12 lowering instead: the pairwise
before/after reified disjunction b ⇔ (end_a ≤ start_b) ∥ b' ⇔ (end_b ≤
start_a) ∥ b + b' ≥ 1 per op pair — kept as the parity oracle.  RCPSP's
cumulative generalizes this to capacities > 1.

`generate(n_jobs, n_machines, seed)` samples a square-ish Taillard-style
instance: each job visits every machine once in a random order.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

from repro_torch.core.model import Model


@dataclasses.dataclass
class JobShop:
    machines: np.ndarray       # i[J, M] machine of op k of job j
    durations: np.ndarray      # i[J, M] duration of op k of job j
    name: str = "jobshop"

    @property
    def n_jobs(self) -> int:
        return self.machines.shape[0]

    @property
    def n_machines(self) -> int:
        return self.machines.shape[1]

    @property
    def horizon(self) -> int:
        return int(self.durations.sum())


def generate(n_jobs: int, n_machines: int = 2, seed: int = 0,
             max_duration: int = 5) -> JobShop:
    """Seeded Taillard-style instance (every job visits every machine)."""
    rng = np.random.default_rng(seed)
    mach = np.stack([rng.permutation(n_machines) for _ in range(n_jobs)])
    dur = rng.integers(1, max_duration + 1, size=(n_jobs, n_machines))
    return JobShop(machines=mach, durations=dur,
                   name=f"jobshop-j{n_jobs}-m{n_machines}-s{seed}")


def build_model(inst: JobShop, decompose: bool = False) -> Tuple[Model, dict]:
    J, M = inst.n_jobs, inst.n_machines
    h = inst.horizon
    d = inst.durations
    m = Model(name=inst.name)
    s = [[m.int_var(0, h, f"s{j}_{k}") for k in range(M)] for j in range(J)]
    mk = m.int_var(0, h, "makespan")

    for j in range(J):
        for k in range(M - 1):
            m.add(s[j][k] + int(d[j, k]) <= s[j][k + 1])
        m.add(s[j][M - 1] + int(d[j, M - 1]) <= mk)

    # per-machine exclusivity between operations of different jobs
    for mach in range(M):
        ops = [(j, int(np.where(inst.machines[j] == mach)[0][0]))
               for j in range(J)]
        if not decompose:
            # one native unit-capacity cumulative row per machine (§12)
            m.cumulative([s[j][k] for j, k in ops],
                         [int(d[j, k]) for j, k in ops],
                         [1] * len(ops), 1)
            continue
        for a in range(len(ops)):
            for b in range(a + 1, len(ops)):
                (ja, ka), (jb, kb) = ops[a], ops[b]
                ab = m.reify(s[ja][ka] + int(d[ja, ka]) <= s[jb][kb],
                             f"m{mach}_{ja}b4{jb}")
                ba = m.reify(s[jb][kb] + int(d[jb, kb]) <= s[ja][ka],
                             f"m{mach}_{jb}b4{ja}")
                m.add(ab + ba >= 1)

    m.minimize(mk)
    flat = [v for job in s for v in job]
    m.branch_on(flat + [mk])
    return m, dict(s=s, mk=mk, check_vars=flat)


def check_solution(inst: JobShop, starts: Sequence[int]) -> Tuple[bool, int]:
    """Ground checker: within-job precedence + machine exclusivity.
    `starts` is the row-major flattening of s[j][k].
    Returns (feasible, makespan)."""
    J, M = inst.n_jobs, inst.n_machines
    st = np.asarray([int(x) for x in starts]).reshape(J, M)
    d = inst.durations
    if (st < 0).any():
        return False, -1
    for j in range(J):
        for k in range(M - 1):
            if st[j, k] + d[j, k] > st[j, k + 1]:
                return False, -1
    for mach in range(M):
        ivals = []
        for j in range(J):
            k = int(np.where(inst.machines[j] == mach)[0][0])
            ivals.append((int(st[j, k]), int(st[j, k] + d[j, k])))
        ivals.sort()
        for (s0, e0), (s1, _) in zip(ivals, ivals[1:]):
            if s1 < e0:
                return False, -1
    return True, int((st + d).max())
