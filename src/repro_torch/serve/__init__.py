"""Solver as a service — port of ``repro/serve``: continuous batching
across *requests*, not just across subproblems of one instance.

`SolveRequest`s enter an ingress queue (`serve/queue.py`), are bucketed
by ``shape_signature`` × config into per-bucket continuous batches
(`serve/scheduler.py`) built on the lane-owning `api.LaneBatch`: late
same-shape work joins at the next quantum boundary, finished requests
retire early, and per-request incumbent/`Progress` events stream back to
callers (`serve/session.py`).  Under ``cuda_resident`` a bucket's quantum
is one launch of the resident search kernel over all its slots.
`serve/loadgen.py` is the open-loop load generator and
`serve/metrics.py` the latency/occupancy recorder.

Quickstart::

    from repro_torch import serve, solver

    with serve.SolverService(solver.SolveConfig.preset("prove")) as svc:
        h1 = svc.submit(cm_a)                  # any thread
        h2 = svc.submit(cm_b, deadline_s=30.0)
        for ev in h1.events():                 # streamed incumbents
            print(ev.superstep, ev.best_objective)
        print(h2.result().status)

or, single-threaded and deterministic (tests, ``chip_smoke.py``, the
`launch/serve_solver.py` CLI)::

    sched = serve.SolverScheduler(cfg, max_batch=4)
    handles = serve.run_open_loop(sched, serve.poisson_trace(50, 100.0))
    print(sched.recorder.summary())
"""

from repro_torch.serve.queue import SolveRequest, RequestQueue      # noqa: F401
from repro_torch.serve.metrics import MetricsRecorder               # noqa: F401
from repro_torch.serve.scheduler import SolverScheduler             # noqa: F401
from repro_torch.serve.session import RequestHandle, SolverService  # noqa: F401
from repro_torch.serve.loadgen import (Arrival, DEFAULT_MIX,        # noqa: F401
                                       compile_arrival, poisson_trace,
                                       run_open_loop)

__all__ = [
    "SolveRequest", "RequestQueue", "MetricsRecorder",
    "SolverScheduler", "RequestHandle", "SolverService",
    "Arrival", "DEFAULT_MIX", "compile_arrival", "poisson_trace",
    "run_open_loop",
]
