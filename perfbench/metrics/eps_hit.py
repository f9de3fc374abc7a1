"""eps_hit (%, the program's counts), in j120-first: the splits that EPS's
widest-first rule took over the splits its batches propagated,
Σ ``eps.splits`` / Σ ``eps.spec`` over the window's solves (the counts
of ``SolveResult.trace``, `core/trace.py`).  A program that keeps no
such counts gives None."""

from spans import trace_of


def read(run):
    took = spec = 0
    for sv in run.in_window():
        tallies = getattr(trace_of(sv), "tallies", None) or {}
        took += tallies.get("eps.splits", 0)
        spec += tallies.get("eps.spec", 0)
    return 100.0 * took / spec if spec else None
