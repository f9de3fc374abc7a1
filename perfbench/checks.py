"""The comparison that decides ``correct``: what the timed path produced,
and the instances drawn from the seed that the same path solved after
the window, judged by the problem class's plain reference once the
window has closed.

Three layers are compared, each number against its limit (all exact, so
every limit is 0):

* ``schedules_bad``: solves (the window's and the drawn ones) whose
  answer the problem class rejects (``answer_ok``; for RCPSP no
  schedule, a schedule that breaks a precedence or a capacity, an
  objective that is not its makespan or lies under the instance's lower
  bound);
* ``pool_rows_bad``: rows of the EPS pool of sampled solves that differ
  from the pool the reference decomposes from the instance (its
  fixpoints included);
* ``replay_lanes_bad``: lanes (and shared values) of sampled quanta of
  the search (``check_launches`` of the window's solves, and one of each
  drawn solve) (a launch of the resident search, or one superstep under
  the other backends) whose state after the quantum differs from the
  reference's supersteps run from the quantum's own input state;
* ``errors``: solves that raised; ``unchecked``: sampled checks that
  found nothing to check.

The replay follows the program from the program's own state, launch by
launch; the start it skips (the pool) is the EPS check, and the launches
it skips are held by the answers' check.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List

import numpy as np

LIMITS = {"schedules_bad": 0, "pool_rows_bad": 0, "replay_lanes_bad": 0,
          "errors": 0, "unchecked": 0}
_BOOL = ("dec_flip", "fresh", "done", "incomplete", "has_sol")
_STORE = ("lb", "ub", "root_lb", "root_ub", "best_sol")


def to_lanes(R, st, gbest, it, head, cols: np.ndarray, device):
    """The program's lane state in the reference's (module `R`) columns."""
    import torch
    dev = torch.device(device)
    V = st.lb.shape[1]
    c = torch.as_tensor(cols, device=dev)
    inv = torch.full((V,), -1, dtype=torch.int64, device=dev)
    inv[c] = torch.arange(len(cols), device=dev)
    f = {}
    for k in R.LANE_FIELDS:
        a = getattr(st, k).to(dev)
        if k in _STORE:
            a = a.index_select(1, c)
        if k == "dec_var":
            a = inv[a.long().clamp(0, V - 1)]
        f[k] = a.bool() if k in _BOOL else a.long()
    return R.Lanes(f, int(gbest), int(it), int(torch.as_tensor(head)))


def judge(run, drawn, rec, problem, sample: np.random.Generator,
          device: str, log=print) -> Dict:
    """Every number against its limit; `failed` counts the solves, the
    window's and the `drawn` ones, that any check rejects."""
    t = time.perf_counter()
    cfg, traffic = run.config, run.traffic
    R = problem.reference
    every = run.solves + drawn
    bad: Dict[int, List[str]] = {}
    n = dict.fromkeys(LIMITS, 0)
    for sv in every:
        if sv.error is not None:
            n["errors"] += 1
            bad.setdefault(sv.k, []).append(sv.error.strip().splitlines()[-1])
            print(sv.error, file=sys.stderr)
            continue
        why = problem.answer_ok(sv.inst, sv.result, sv.cols)
        if why:
            n["schedules_bad"] += 1
            bad.setdefault(sv.k, []).append(why)

    by_k = {sv.k: sv for sv in every if sv.error is None}
    window_ks = {sv.k for sv in run.solves}
    target = (cfg["solver"]["eps_target"]
              or 4 * cfg["solver"]["n_lanes"])

    def pick(keys, count):
        keys = sorted(keys)
        if count >= len(keys):
            return keys
        return sorted(int(k) for k in sample.choice(keys, count,
                                                    replace=False))

    pools = pick([k for k in rec.pools if k in by_k and k in window_ks],
                 traffic["check_pools"])
    n["unchecked"] += traffic["check_pools"] - len(pools)
    t_pools = time.perf_counter()
    for k in pools:
        sv = by_k[k]
        prop = R.Propagator(sv.inst, device)
        ref_lb, ref_ub = R.eps_pool(prop, target)
        got_lb, got_ub = (np.asarray(a)[:, sv.cols] for a in rec.pools[k])
        nb, note = R.compare_pools(ref_lb, ref_ub, got_lb, got_ub)
        n["pool_rows_bad"] += nb
        if nb:
            bad.setdefault(k, []).append(f"pool: {note}")

    t_pools = time.perf_counter() - t_pools
    launches = pick([k for k in rec.launches if k in by_k and k in window_ks],
                    traffic["check_launches"])
    n["unchecked"] += traffic["check_launches"] - len(launches)
    for sv in drawn:
        if sv.k in by_k and sv.k in rec.launches:
            launches.append(sv.k)
        else:
            n["unchecked"] += 1
    for k in launches:
        sv = by_k[k]
        q = rec.launches[k]
        prop = R.Propagator(sv.inst, device)
        c = np.asarray(sv.cols)
        slb, sub = q["subs"]
        rp = R.Replay(prop, slb[:, c], sub[:, c], stop_on_first=q["first"])
        start = to_lanes(R, q["st"], q["gbest"], q["it"], q["head"], c,
                         device)
        if q["supersteps"] is None:       # one superstep, no shared values
            st2, head2 = q["out"]
            ref = rp.step(start)
            got = to_lanes(R, st2, ref.gbest, ref.it, head2, c, device)
            nb, notes = R.compare_lanes(ref, got)
        else:
            ref, ref_stop = rp.run(start, q["supersteps"])
            st2, gbest2, it2, head2, stop2 = q["out"]
            nb, notes = R.compare_lanes(ref, to_lanes(R, st2, gbest2, it2,
                                                      head2, c, device))
            if bool(stop2) != ref_stop:
                nb += 1
                notes.append(f"stopped: reference {ref_stop}, program "
                             f"{bool(stop2)}")
        n["replay_lanes_bad"] += nb
        if nb:
            bad.setdefault(k, []).append("replay: " + "; ".join(notes))

    names = {sv.k: sv.inst.name for sv in every}
    for k, whys in sorted(bad.items()):
        log(f"solve {k} ({names[k]}): " + " | ".join(whys))
    checks = {name: {"value": n[name], "limit": LIMITS[name]}
              for name in LIMITS}
    correct = (len(run.solves) > 0
               and all(n[k] <= LIMITS[k] for k in LIMITS))
    log(f"reference: {len(pools)} pools in {t_pools:.1f} s, "
        f"{len(launches)} launches replayed ({len(drawn)} of drawn "
        f"instances); {time.perf_counter() - t:.1f} s in all")
    for name, c in checks.items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    return dict(correct=correct, failed=len(bad), checks=checks)
