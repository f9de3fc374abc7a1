"""Seeded RCPSP instances from ProGen's class parameters.

ProGen (Kolisch, Sprecher & Drexl 1995, Management Science 41(10)) built
the PSPLIB single-mode sets (Kolisch & Sprecher 1996, EJOR 96) from
three parameters: NC, the non-redundant arcs per activity; RF, the share
of the K resources an activity requests; RS, the resource strength, which
places each capacity between the largest single demand (RS = 0) and the
peak demand of the precedence-only earliest-start schedule (RS = 1).
This generator follows those definitions, with the choices ProGen leaves
finer listed under ``assumed`` in each configuration file:

* n jobs (no dummy source or sink), indexed in a topological order;
* durations uniform on 1..10, demands uniform on 1..10;
* every job requests exactly ``round(RF·K)`` resources, drawn uniformly,
  so the instance's RF is exactly the class's;
* ``round(NC·n)`` arcs among the n jobs, none redundant (no arc is implied
  by a path of others), at most 3 successors and 3 predecessors per job:
  first every job past the first three gets a predecessor and every job
  before the last three a successor, then random pairs until the count;
* capacity ``k_min + floor(RS·(k_max − k_min) + 1/2)``.

numpy only: the harness, the tests and the reference share it, and it
imports nothing of the program.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Sequence, Tuple

import numpy as np

N_START_FINISH = 3      # jobs allowed without a predecessor / successor
NETWORK_ATTEMPTS = 20   # random networks tried before a class is refused


@dataclasses.dataclass(frozen=True)
class Instance:
    """One instance: durations ``d[n]``, arcs ``(i, j)`` with i ≪ j,
    demands ``q[K, n]``, capacities ``cap[K]``, and the class point it
    was drawn at."""

    d: np.ndarray
    arcs: Tuple[Tuple[int, int], ...]
    q: np.ndarray
    cap: np.ndarray
    nc: float
    rf: float
    rs: float
    seed: int

    @property
    def n(self) -> int:
        return int(self.d.shape[0])

    @property
    def horizon(self) -> int:
        """Sum of the durations: every schedule of interest ends by it."""
        return int(self.d.sum())

    @property
    def name(self) -> str:
        return (f"progen-n{self.n}-nc{self.nc}-rf{self.rf}-rs{self.rs}"
                f"-s{self.seed}")


def earliest_starts(d: np.ndarray, arcs: Sequence[Tuple[int, int]]
                    ) -> np.ndarray:
    """Earliest starts under the precedences alone (jobs are indexed in a
    topological order, so one pass in index order suffices)."""
    es = np.zeros(len(d), dtype=np.int64)
    preds: List[List[int]] = [[] for _ in range(len(d))]
    for i, j in arcs:
        preds[j].append(i)
    for j in range(len(d)):
        for i in preds[j]:
            es[j] = max(es[j], es[i] + d[i])
    return es


def peak_demand(d: np.ndarray, q: np.ndarray, starts: np.ndarray
                ) -> np.ndarray:
    """Per resource, the highest demand the schedule `starts` puts on
    it at any time."""
    h = int((starts + d).max())
    prof = np.zeros((q.shape[0], h + 1), dtype=np.int64)
    for i in range(len(d)):
        prof[:, starts[i]:starts[i] + d[i]] += q[:, i:i + 1]
    return prof.max(axis=1)


def capacities(d: np.ndarray, arcs, q: np.ndarray, rs: float) -> np.ndarray:
    """ProGen's capacity at resource strength `rs`."""
    k_min = q.max(axis=1)
    k_max = peak_demand(d, q, earliest_starts(d, arcs))
    return k_min + np.floor(rs * (k_max - k_min) + 0.5).astype(np.int64)


class _Network:
    """Arcs with their transitive closure, refusing redundant ones."""

    def __init__(self, n: int, max_degree: int):
        self.n = n
        self.max_degree = max_degree
        self.reach = np.zeros((n, n), dtype=bool)      # path a → b
        self.arcs: List[Tuple[int, int]] = []
        self.n_succ = np.zeros(n, dtype=np.int64)
        self.n_pred = np.zeros(n, dtype=np.int64)

    def can_add(self, i: int, j: int) -> bool:
        if not i < j or self.reach[i, j]:
            return False
        if (self.n_succ[i] >= self.max_degree
                or self.n_pred[j] >= self.max_degree):
            return False
        up = self.reach[:, i].copy()
        up[i] = True                       # i and every job reaching it
        down = self.reach[j].copy()
        down[j] = True                     # j and every job it reaches
        # an existing arc a → b with a ∈ up and b ∈ down becomes redundant
        if not self.arcs:
            return True
        a, b = np.asarray(self.arcs).T
        return not bool(np.any(up[a] & down[b]))

    def add(self, i: int, j: int) -> None:
        up = self.reach[:, i].copy()
        up[i] = True
        down = self.reach[j].copy()
        down[j] = True
        self.reach |= up[:, None] & down[None, :]
        self.arcs.append((i, j))
        self.n_succ[i] += 1
        self.n_pred[j] += 1


def _first_addable(net: "_Network", pairs, rng: np.random.Generator):
    """A pair drawn uniformly among those `net` can take (the first of a
    random order that it takes), or None."""
    for k in rng.permutation(len(pairs)):
        if net.can_add(*pairs[k]):
            return pairs[k]
    return None


def _network(n: int, n_arcs: int, max_degree: int,
             rng: np.random.Generator):
    net = _Network(n, max_degree)
    # every non-start job gets a predecessor, every non-finish job a
    # successor, drawn among the jobs that keep the network non-redundant
    for j in range(N_START_FINISH, n):
        if net.n_pred[j] == 0 and len(net.arcs) < n_arcs:
            arc = _first_addable(net, [(i, j) for i in range(j)], rng)
            if arc is not None:
                net.add(*arc)
    for i in range(n - N_START_FINISH):
        if net.n_succ[i] == 0 and len(net.arcs) < n_arcs:
            arc = _first_addable(net, [(i, j) for j in range(i + 1, n)],
                                 rng)
            if arc is not None:
                net.add(*arc)
    pairs = [(i, j) for i, j in itertools.combinations(range(n), 2)]
    order = rng.permutation(len(pairs))
    for k in order:
        if len(net.arcs) >= n_arcs:
            break
        i, j = pairs[k]
        if net.can_add(i, j):
            net.add(i, j)
    if len(net.arcs) != n_arcs:
        raise ValueError(f"no non-redundant network of {n_arcs} arcs on "
                         f"{n} jobs with degrees <= {max_degree}")
    return tuple(sorted(net.arcs))


def generate(n: int, nc: float, rf: float, rs: float, seed: int, *,
             n_resources: int = 4, max_duration: int = 10,
             max_demand: int = 10, max_degree: int = 3) -> Instance:
    """One instance at the class point (nc, rf, rs), from `seed` alone."""
    rng = np.random.default_rng(seed)
    d = rng.integers(1, max_duration + 1, size=n).astype(np.int64)
    for attempt in range(NETWORK_ATTEMPTS):
        try:
            arcs = _network(n, int(np.floor(nc * n + 0.5)), max_degree, rng)
            break
        except ValueError:
            if attempt == NETWORK_ATTEMPTS - 1:
                raise
    k_used = int(np.floor(rf * n_resources + 0.5))
    if not 1 <= k_used <= n_resources:
        raise ValueError(f"RF {rf} requests {k_used} of {n_resources} "
                         "resources")
    q = np.zeros((n_resources, n), dtype=np.int64)
    for i in range(n):
        used = rng.choice(n_resources, size=k_used, replace=False)
        q[used, i] = rng.integers(1, max_demand + 1, size=k_used)
    cap = capacities(d, arcs, q, rs)
    return Instance(d=d, arcs=arcs, q=q, cap=cap, nc=nc, rf=rf, rs=rs,
                    seed=int(seed))


def redundant_arcs(n: int, arcs) -> List[Tuple[int, int]]:
    """Arcs implied by a path of the other arcs (none in a ProGen
    network)."""
    out = []
    for a in arcs:
        rest = [b for b in arcs if b != a]
        reach = np.zeros((n, n), dtype=bool)
        for i, j in rest:
            reach[i, j] = True
        for k in range(n):                 # Floyd–Warshall closure
            reach |= reach[:, k:k + 1] & reach[k:k + 1, :]
        if reach[a]:
            out.append(a)
    return out
