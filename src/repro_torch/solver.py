"""``repro_torch.solver`` — the public solver surface of the port::

    from repro_torch import solver

    cfg = solver.SolveConfig.preset("prove", n_lanes=1024)   # on the card
    res = solver.Solver(cfg).solve(cm)
    for ev in solver.Solver(cfg).solve_iter(cm):              # anytime
        print(ev.superstep, ev.best_objective)

Pass ``device="cpu"`` (and ``compile_model(..., device="cpu")``) to run
the plain PyTorch path on the CPU.
"""

from repro_torch.core.api import (  # noqa: F401
    OPTIMAL, SAT, UNSAT, UNKNOWN,
    PRESETS, SolveConfig, Solver,
    SolveResult, Progress, Improvement,
    derive_result, shape_signature,
)

__all__ = [
    "OPTIMAL", "SAT", "UNSAT", "UNKNOWN",
    "PRESETS", "SolveConfig", "Solver",
    "SolveResult", "Progress", "Improvement",
    "derive_result", "shape_signature",
]
