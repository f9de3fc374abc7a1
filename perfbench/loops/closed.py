"""The closed loop: one client that sends the next instance as soon as
the last one returns, until the window closes.

A mix names its loop (``"loop": "closed"``); the harness finds this file
by that name and calls ``run(window)`` once, inside the measured window.
``window`` (`harness.Window`) gives the mix (``traffic``), the window's
``t0``, ``t_end`` and ``seconds``, the mix's instance set (``instances``)
and the order a run visits it (``order``), and ``solve(k, inst,
t_stop)``, which builds, compiles and solves one instance through the
program with `t_stop` (host clock) as its deadline and returns the
`harness.Solve`.  The loop returns every `Solve` it started.

The mix's keys this loop reads:

* ``deadline``: ``share`` (each instance gets ``seconds / set_size`` from
  its start, at most until the window's close) or ``none`` (no deadline;
  one still running at the close may take ``late_s`` more);
* ``min_budget_s``: the least time left at which another instance is
  started (the first always is).
"""

import time


def run(window) -> list:
    traffic = window.traffic
    solves = []
    while True:
        now = time.perf_counter()
        left = window.t_end - now
        if left <= 0 or (solves and left < traffic["min_budget_s"]):
            return solves
        inst = window.instances[next(window.order)]
        if traffic["deadline"] == "share":
            t_stop = min(window.t_end,
                         now + window.seconds / traffic["set_size"])
        elif traffic["deadline"] == "none":
            t_stop = window.t_end + traffic["late_s"]
        else:
            raise ValueError(f"unknown deadline {traffic['deadline']!r}")
        solves.append(window.solve(len(solves), inst, t_stop))
