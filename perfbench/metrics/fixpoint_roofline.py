"""fixpoint_roofline (%): the least time the fixpoint launches of the
window (under the resident backend, the EPS decomposition's) need for
their work (`roofline.fixpoint_work`: from each instance and the sweeps,
stores and launches the program's fixpoint calls returned) over their
device time (``fixpoint`` kernels in the profiler's trace)."""

import roofline


def read(run):
    device_s = run.device_seconds("fixpoint")
    if not device_s or not run.int_peak == run.int_peak:
        return None
    least = 0.0
    for sv in run.solves:
        if sv.fixpoint is None:
            continue
        sweeps, stores, launches = sv.fixpoint
        nbytes, ops = roofline.fixpoint_work(sv.inst, sweeps, stores,
                                             launches)
        least += roofline.least_seconds(nbytes, ops, run.int_peak)
    return 100.0 * least / device_s if least else None
