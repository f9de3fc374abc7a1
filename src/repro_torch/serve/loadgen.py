"""Open-loop synthetic load generator — port of
``repro/serve/loadgen.py``.

*Open loop*: arrivals are drawn up front from a seeded Poisson process
and submitted at their offsets whatever the server does, so queueing
delay shows in the latency percentiles instead of being hidden by
closed-loop self-throttling.

A trace is a seeded mix over zoo models and sizes (two or more shape
signatures by default, so the scheduler's bucketing is exercised) with
mixed deadlines.  `run_open_loop` drives a `SolverScheduler` on the host
clock: submit every due arrival, run one scheduler quantum, repeat until
the trace is exhausted and the queue drains.  Instances are compiled
before the clock starts; kernel builds happen in-band, as the cost of a
cold bucket.  One seed gives the reference's arrivals (the same numpy
stream).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import models as zoo
from repro_torch.serve.queue import SolveRequest
from repro_torch.serve.scheduler import SolverScheduler
from repro_torch.serve.session import RequestHandle

# (zoo model, generate() kwargs, relative weight).  knapsack and jobshop
# have different store widths and banks, so the default mix gives two
# shape buckets, and both families' shape signatures are seed-stable
# (contents vary per seed, table shapes do not), so every request after
# a bucket's first lands in it.  (coloring and rcpsp are absent: their
# edge counts depend on the seed, so each seed would open its own bucket.)
DEFAULT_MIX: Tuple[Tuple[str, dict, float], ...] = (
    ("knapsack", dict(n=6), 2.0),
    ("jobshop", dict(n_jobs=2, n_machines=2), 1.0),
)

# deadline mix (seconds, None = no deadline), cycled over arrivals
DEFAULT_DEADLINES: Tuple[Optional[float], ...] = (None, 120.0, 600.0)


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One scheduled request: when it arrives and what it asks for."""
    t_arrival: float                  # seconds after trace start
    model: str                        # zoo model name
    gen_kwargs: Tuple[Tuple[str, object], ...]
    seed: int
    deadline_s: Optional[float]

    def generate(self):
        return zoo.ZOO[self.model].generate(seed=self.seed,
                                            **dict(self.gen_kwargs))


def poisson_trace(n_requests: int, rate_rps: float, *, seed: int = 0,
                  mix: Sequence[Tuple[str, dict, float]] = DEFAULT_MIX,
                  deadlines: Sequence[Optional[float]] = DEFAULT_DEADLINES,
                  ) -> List[Arrival]:
    """A seeded open-loop trace: exponential inter-arrivals at
    ``rate_rps`` requests/s, models drawn from ``mix`` by weight, each
    request's instance seed drawn from the same stream (so the trace is
    reproducible from ``seed`` alone), deadlines cycled."""
    if n_requests < 1 or not rate_rps > 0:
        raise ValueError(f"need n_requests >= 1 and rate_rps > 0, got "
                         f"{n_requests}, {rate_rps}")
    rng = np.random.default_rng(seed)
    names = [m for m, _, _ in mix]
    w = np.asarray([float(x) for _, _, x in mix])
    w = w / w.sum()
    kwargs = {m: tuple(sorted(kw.items())) for m, kw, _ in mix}
    t = 0.0
    out = []
    for k in range(n_requests):
        t += float(rng.exponential(1.0 / rate_rps))
        name = names[int(rng.choice(len(names), p=w))]
        out.append(Arrival(
            t_arrival=t, model=name, gen_kwargs=kwargs[name],
            seed=int(rng.integers(0, 2 ** 31 - 1)),
            deadline_s=deadlines[k % len(deadlines)] if deadlines else None))
    return out


def compile_arrival(arr: Arrival, device=None):
    """Generate, build and compile the arrival's instance onto `device`
    (the card unless asked; host-side)."""
    m, _ = zoo.ZOO[arr.model].build_model(arr.generate())
    return m.compile(device=device)


def run_open_loop(scheduler: SolverScheduler, trace: Sequence[Arrival], *,
                  max_wall_s: Optional[float] = None,
                  ) -> List[Tuple[Arrival, RequestHandle]]:
    """Drive ``scheduler`` with ``trace`` on the host clock (open loop:
    submission never waits for the server) until every request has
    retired.  Instances compile onto the scheduler's configured device.
    Returns ``(arrival, handle)`` pairs in arrival order; each handle's
    `result()` is available on return."""
    cms = [compile_arrival(a, scheduler.config.device)
           for a in trace]                         # off the clock
    handles: List[Tuple[Arrival, RequestHandle]] = []
    t0 = time.time()
    i = 0
    while i < len(trace) or scheduler.has_work():
        if max_wall_s is not None and time.time() - t0 > max_wall_s:
            raise TimeoutError(
                f"open-loop run not drained within {max_wall_s}s "
                f"({i}/{len(trace)} submitted, "
                f"{scheduler.queue_depth()} queued)")
        now = time.time() - t0
        while i < len(trace) and trace[i].t_arrival <= now:
            a = trace[i]
            handles.append((a, scheduler.submit(SolveRequest(
                cm=cms[i], request_id=f"r{i}", deadline_s=a.deadline_s,
                meta=dict(model=a.model, seed=a.seed)))))
            i += 1
        if not scheduler.step() and i < len(trace):
            # idle until the next arrival is due (open-loop pacing)
            time.sleep(min(0.002, max(trace[i].t_arrival - (time.time() - t0),
                                      0.0)))
    return handles


def sequential_reference(trace: Sequence[Arrival],
                         config) -> Dict[str, Tuple[str, Optional[int]]]:
    """The parity oracle: solve every trace request in turn through one
    `Solver` and return ``request_id -> (status, objective)``, what the
    scheduler must reproduce (deadlines permitting)."""
    from repro_torch.core.api import Solver
    sess = Solver(config)
    out: Dict[str, Tuple[str, Optional[int]]] = {}
    for k, arr in enumerate(trace):
        res = sess.solve(compile_arrival(arr, config.device))
        out[f"r{k}"] = (res.status, res.objective)
    return out
