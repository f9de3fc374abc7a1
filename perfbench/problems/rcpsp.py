"""The RCPSP problem class: PSPLIB-style instances from ProGen's class
parameters, the program's model of them, the check of an answer, and
the plain reference that the comparison runs.

A configuration names its problem class (``"problem": "rcpsp"``); the
harness finds this file by that name.  A problem module gives:

* ``draw(config, traffic, k, seed)``: the instance at position k of a
  mix, from `seed` (what the class point of position k is, the mix's
  ``class_point`` says);
* ``model(inst)``: the program's model of the instance and the
  program's store column of each reference column;
* ``answer_ok(inst, result, cols)``: why a solve's answer is wrong, or
  ``""``;
* ``reference``: the module of the plain reference (propagator, EPS pool,
  lane replay and their comparisons), which imports nothing of the
  program.
"""

from __future__ import annotations

import numpy as np

import progen
import reference

CLASS_POINTS = ("hardest", "cycle")


def class_point(config: dict, traffic: dict, k: int):
    """The class point (NC, RF, RS) of a mix's k-th instance.

    ``class_point`` in the mix is ``hardest`` (the grid's least NC, most
    RF and least RS), ``cycle`` (NC[k mod |NC|], RF[k mod |RF|], RS[k mod
    |RS|]: the whole grid once in every |NC|·|RF|·|RS| instances when the
    three counts are coprime, as 3, 4 and 5 are), or a list of
    ``[NC, RF, RS]`` points that position k takes in turn."""
    g = config["grid"]
    point = traffic["class_point"]
    if point == "hardest":
        return min(g["NC"]), max(g["RF"]), min(g["RS"])
    if point == "cycle":
        return (g["NC"][k % len(g["NC"])], g["RF"][k % len(g["RF"])],
                g["RS"][k % len(g["RS"])])
    if isinstance(point, list) and point:
        return tuple(point[k % len(point)])
    raise ValueError(f"unknown class_point {point!r}: one of "
                     f"{CLASS_POINTS} or a list of [NC, RF, RS] points")


def draw(config: dict, traffic: dict, k: int, seed: int):
    """The instance at the class point of position k, from `seed`."""
    nc, rf, rs = class_point(config, traffic, k)
    return progen.generate(config["n_jobs"], nc, rf, rs, seed,
                           n_resources=config["n_resources"],
                           max_duration=config["durations"][1],
                           max_demand=config["demands"][1],
                           max_degree=config["max_degree"])


def model(inst):
    """The program's model of `inst`, and the program's store column of
    each reference column: the starts, the makespan, the constant true
    (the program's variable 0)."""
    from repro_torch.core.models import rcpsp
    m, handles = rcpsp.build_model(rcpsp.RCPSP(
        durations=inst.d, precedences=list(inst.arcs), usage=inst.q,
        capacity=inst.cap, name=inst.name))
    cols = np.asarray([v.idx for v in handles["s"]]
                      + [handles["mk"].idx, 0], dtype=np.int64)
    return m, cols


def answer_ok(inst, res, cols) -> str:
    """Why the solve's answer is wrong, or '': no schedule, a schedule
    that breaks a precedence or a capacity, an objective that is not its
    makespan, or a makespan under the instance's lower bound."""
    if res is None:
        return "no result"
    if res.solution is None or res.status not in ("OPTIMAL", "SAT"):
        return f"status {res.status} without a schedule"
    sol = np.asarray(res.solution)
    n = inst.n
    ok, mk, why = reference.check_schedule(inst, sol[cols[:n]])
    if not ok:
        return why
    if res.objective != mk or int(sol[cols[n]]) != mk:
        return (f"objective {res.objective}, makespan variable "
                f"{int(sol[cols[n]])}, schedule ends at {mk}")
    lb = reference.lower_bound(inst)
    if mk < lb:
        return f"makespan {mk} under the lower bound {lb}"
    return ""
