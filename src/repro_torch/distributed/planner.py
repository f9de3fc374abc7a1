"""Constraint-based distributed planning — port of
``repro/distributed/planner.py``.

The solver as a planning engine: `plan_partition` assigns layers to
pipeline stages (contiguous, minimizing the bottleneck stage cost under a
per-stage memory cap), `schedule_microbatches` schedules pipeline rounds
as an RCPSP, and `plan_steal` is the work-stealing plan of the
distributed EPS engine (`core/dist_solve.py`).  Each solve goes through
the port's `solver.solve` on ``device`` (``None``: the card; pass
``"cpu"`` for the plain PyTorch path), and is deterministic in its
inputs, so every host computes the same plan.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from repro_torch import solver
from repro_torch.core import search as S
from repro_torch.core.model import Model
from repro_torch.core.models import rcpsp


def plan_partition(layer_costs: Sequence[int], layer_mems: Sequence[int],
                   n_stages: int, mem_cap: int, timeout_s: float = 60.0,
                   device=None) -> Tuple[List[int], int]:
    """Contiguous layer→stage assignment minimizing the max stage cost.

    Stage indices g_i are monotone (g_i ≤ g_{i+1} ≤ g_i + 1) and the
    membership booleans b_{ik} ⇔ (g_i = k) are reified linear rows.
    Returns (stage_of_layer, bottleneck_cost).  Raises if infeasible.
    """
    L, P = len(layer_costs), n_stages
    m = Model("partition")
    g = [m.int_var(0, P - 1, f"g{i}") for i in range(L)]
    m.add(g[0] <= 0)                       # first layer in stage 0
    m.add(g[L - 1] >= P - 1)               # last layer in the last stage
    for i in range(L - 1):
        m.add(g[i] <= g[i + 1])            # monotone
        m.add(g[i + 1] <= g[i] + 1)        # contiguous, no empty stages
    T = m.int_var(max(layer_costs), int(sum(layer_costs)), "T")
    b = [[None] * P for _ in range(L)]
    for i in range(L):
        for k in range(P):
            bik = m.bool_var(f"b{i}_{k}")
            b[i][k] = bik
            m.iff_and(bik, [g[i] <= k, -g[i] <= -k])    # b ⇔ (g_i == k)
    for k in range(P):
        m.add(sum(int(layer_costs[i]) * b[i][k] for i in range(L)) <= T)
        m.add(sum(int(layer_mems[i]) * b[i][k] for i in range(L))
              <= int(mem_cap))
    m.minimize(T)
    m.branch_on(g + [T])
    cfg = solver.SolveConfig(n_lanes=16, eps_target=64,
                             var_strategy=S.INPUT_ORDER, max_depth=1024,
                             timeout_s=timeout_s,
                             **_device_kw(device))
    res = solver.solve(m.compile(device=cfg.device), config=cfg)
    if res.solution is None:
        raise ValueError(f"no feasible partition ({res.status}): "
                         f"mem_cap={mem_cap} too tight?")
    stages = [int(res.solution[v.idx]) for v in g]
    return stages, int(res.objective)


def schedule_microbatches(stage_costs: Sequence[int], n_microbatches: int,
                          timeout_s: float = 60.0, device=None):
    """Pipeline round schedule as RCPSP.  Returns (start[m][s], makespan,
    result).

    Tasks: (m, s) with duration stage_costs[s]; precedence (m,s)≪(m,s+1);
    resource: one unit-capacity resource per stage.
    """
    Sn = len(stage_costs)
    M = n_microbatches
    n = M * Sn
    tid = lambda mb, st: mb * Sn + st            # noqa: E731
    dur = np.array([stage_costs[t % Sn] for t in range(n)], dtype=np.int64)
    prec = [(tid(mb, st), tid(mb, st + 1))
            for mb in range(M) for st in range(Sn - 1)]
    usage = np.zeros((Sn, n), dtype=np.int64)
    for t in range(n):
        usage[t % Sn, t] = 1
    cap = np.ones(Sn, dtype=np.int64)
    inst = rcpsp.RCPSP(durations=dur, precedences=prec, usage=usage,
                       capacity=cap, name=f"pipe-{Sn}x{M}")
    model, handles = rcpsp.build_model(inst)
    cfg = solver.SolveConfig(n_lanes=16, eps_target=64,
                             var_strategy=S.MIN_LB, max_depth=2048,
                             timeout_s=timeout_s, **_device_kw(device))
    res = solver.solve(model.compile(device=cfg.device), config=cfg)
    if res.solution is None:
        raise RuntimeError(f"scheduler failed: {res.status}")
    starts = [[int(res.solution[handles["s"][tid(mb, st)].idx])
               for st in range(Sn)] for mb in range(M)]
    return starts, int(res.objective), res


def _device_kw(device) -> dict:
    return {} if device is None else dict(device=str(device))


def plan_steal(owned: Sequence[Sequence[int]], n_shards: int
               ) -> Tuple[List[List[int]], int]:
    """Work-stealing plan for the distributed EPS engine: repartition the
    undispatched subproblem ids over ``n_shards`` so shard loads are
    balanced to within one entry, moving as few entries as possible (a
    shard keeps its own ids up to its quota before any surplus migrates
    to deficit shards).

    Deterministic in its inputs.  Returns ``(assignment, n_moved)`` where
    ``assignment[d]`` is the id list shard ``d`` owns after the steal.
    ``n_shards`` may differ from ``len(owned)``: the elastic-remesh path
    replans a lost shard's slice over the surviving shards with it.
    """
    total = sum(len(o) for o in owned)
    base, extra = divmod(total, n_shards)
    quota = [base + (1 if d < extra else 0) for d in range(n_shards)]
    assignment: List[List[int]] = [[] for _ in range(n_shards)]
    surplus: List[int] = []
    for d in range(n_shards):
        own = sorted(owned[d]) if d < len(owned) else []
        assignment[d] = own[:quota[d]]
        surplus.extend(own[quota[d]:])
    # a shrinking remesh folds the dropped shards' ids into the surplus
    surplus.extend(x for o in owned[n_shards:] for x in sorted(o))
    surplus.sort()
    moved = len(surplus)
    for d in range(n_shards):
        need = quota[d] - len(assignment[d])
        if need > 0:
            assignment[d].extend(surplus[:need])
            del surplus[:need]
    assert not surplus, "plan_steal: quota bookkeeping broke"
    return assignment, moved


def pipeline_efficiency(stage_costs: Sequence[int], makespan: int,
                        n_microbatches: int) -> float:
    """Schedule quality against the pipeline lower bound
    Σcosts + (M−1)·max; 1.0 is a perfectly packed pipeline."""
    ideal = sum(stage_costs) + (n_microbatches - 1) * max(stage_costs)
    return ideal / makespan if makespan else 0.0
