"""``repro_torch.solver`` — the public solver surface of the port::

    from repro_torch import solver

    cfg = solver.SolveConfig.preset("prove", n_lanes=1024)   # on the card
    sess = solver.Solver(cfg)
    res = sess.solve(cm)
    results = sess.solve_many(cms)      # N same-shape instances, one batch
    for ev in sess.solve_iter(cm):      # anytime
        print(ev.superstep, ev.best_objective)

Pass ``device="cpu"`` (and ``compile_model(..., device="cpu")``) to run
the plain PyTorch path on the CPU.  Module-level `solve`, `solve_many`
and `solve_iter` use a process-wide default session (`default_solver`).

`LaneBatch` (via `Solver.lane_batch`) is the continuous-batching
primitive underneath `solve_many`: a fixed-width batch whose slots
independent requests join (`splice`) and leave (`retire`) at quantum
boundaries; under ``cuda_resident`` a quantum is one launch of the
resident search kernel over every slot.  The request-queue scheduler
built on it is `repro_torch.serve`.
"""

from repro_torch.core.api import (  # noqa: F401
    OPTIMAL, SAT, UNSAT, UNKNOWN,
    PRESETS, SolveConfig, Solver,
    SolveResult, Progress, Improvement,
    BatchSnapshot, LaneBatch,
    default_solver, derive_result, shape_signature,
    solve, solve_iter, solve_many,
)

__all__ = [
    "OPTIMAL", "SAT", "UNSAT", "UNKNOWN",
    "PRESETS", "SolveConfig", "Solver",
    "SolveResult", "Progress", "Improvement",
    "BatchSnapshot", "LaneBatch",
    "default_solver", "derive_result", "shape_signature",
    "solve", "solve_iter", "solve_many",
]
