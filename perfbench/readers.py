"""Readers that several metrics share: a metric whose quantity is split
by the cells it moves (``nodes_per_s.j120`` and ``nodes_per_s.j60``) has
a file of its own for each part, and each names one of these."""

import roofline


def nodes_per_s(run):
    """The search nodes of every solve of the window over the time from
    the window's start to the last solve's return (build, compile and
    EPS included)."""
    done = [s for s in run.solves if s.result is not None]
    if not done:
        return None
    span = max(s.t_done for s in done) - run.t0
    return sum(s.result.n_nodes for s in done) / span


def superstep_ms(run):
    """The host loop's time per superstep of the resident search,
    Σ(wall_s − eps_s) ÷ Σ n_supersteps over the window's solves (the
    program's counters and clock)."""
    done = [s for s in run.solves if s.result is not None]
    steps = sum(s.result.n_supersteps for s in done)
    if not steps:
        return None
    return 1e3 * sum(s.result.wall_s - s.result.eps_s for s in done) / steps


def search_roofline(run):
    """The least time the resident search launches of the window need
    for their work (`roofline.search_work`: from each instance, the
    configuration's lanes and depth limit, and the program's sweep,
    superstep and launch counters) over their device time
    (``search_kernel`` in the profiler's trace), in %."""
    device_s = run.device_seconds("search_kernel")
    if not device_s or not run.int_peak == run.int_peak:
        return None
    s = run.config["solver"]
    least = 0.0
    for sv in run.solves:
        if sv.result is None or not sv.launches:
            continue
        nbytes, ops = roofline.search_work(
            sv.inst, s["n_lanes"], s["max_depth"], sv.result.n_sweeps,
            sv.result.n_supersteps, sv.launches)
        least += roofline.least_seconds(nbytes, ops, run.int_peak)
    return 100.0 * least / device_s if least else None


def device_idle(run):
    """The share of the traced window (its start to the last solve's
    return) in which no operation runs on the card, in %."""
    if not run.window_s == run.window_s or not run.device_ops:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
