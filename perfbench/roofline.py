"""The yardstick of the kernels' roofline shares: peaks of the card and
the least work a launch needs, counted from the instance alone.

The counts read the jobs, arcs, resources, demands and horizon of the
instance, the lanes and integer width the configuration states, and the
program's own sweep and superstep counters (the work depends on the
data).  They never read the program's compiled tables or layouts, so a
change of layout does not move the yardstick: each is a lower bound on
the work of any implementation.

Peaks (NVIDIA H100 SXM data sheet): HBM at 3.35 TB/s; int32 operations
at SMs × 64 INT32 lanes × the SM clock, 132 × 64 × 1980 MHz = 16.73
T op/s on the H100 80GB HBM3 (the harness reads the SM count and the
maximum SM clock of the card it runs on).
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64
WORD = 4                                  # int32 stores and tables


def int32_peak(n_sms: int, max_sm_mhz: float) -> float:
    """Integer operations per second of the card."""
    return n_sms * INT32_LANES_PER_SM * max_sm_mhz * 1e6


def n_vars(inst) -> int:
    """Variables of one store: the starts, the makespan and the constant
    true."""
    return inst.n + 2


def linear_rows(inst) -> int:
    """Precedence rows: one per arc and one per job's end before the
    makespan."""
    return len(inst.arcs) + inst.n


def tasks_per_resource(inst):
    return [int((inst.q[k] > 0).sum()) for k in range(inst.q.shape[0])]


def ops_per_sweep(inst) -> int:
    """Integer operations one propagation sweep of one store needs: per
    two-term precedence row 8 per term for its tells and 2 per term to
    join them into the bounds; per (resource, task) 4 for the compulsory
    part's two ends and the first and last start, and 2 to join; per
    resource of m tasks the lesser of a prefix sum and a compare over the
    horizon (2·h) and a sort of its 2m events with a sum and a compare
    per event (4m·⌈log2 2m⌉ + 4m)."""
    rows = linear_rows(inst)
    ops = 8 * 2 * rows + 2 * 2 * rows
    h = inst.horizon
    for m in tasks_per_resource(inst):
        if m:
            ops += 4 * m + 2 * m
            ops += min(2 * h, 4 * m * math.ceil(math.log2(2 * m)) + 4 * m)
    return ops


def table_bytes(inst) -> int:
    """Bytes of the instance's propagator data, read once a launch: per
    precedence row its two variables, two coefficients and bound; per
    (resource, task) its variable, duration and demand; per resource
    its capacity."""
    uses = sum(tasks_per_resource(inst))
    return WORD * (5 * linear_rows(inst) + 3 * uses + inst.q.shape[0])


def lane_state_bytes(inst, max_depth: int) -> int:
    """Bytes of one lane's search state: the current and root stores and
    the incumbent (5 stores of V words), the decision path to the
    configuration's depth limit (variable and value words, one flag
    byte), seven counters and cursors, four flag bytes."""
    V = n_vars(inst)
    return 5 * V * WORD + max_depth * (2 * WORD + 1) + 7 * WORD + 4


def fixpoint_work(inst, sweeps: int, stores: int, launches: int):
    """(bytes, ops) of `launches` fixpoint launches over `stores` stores
    in all that took `sweeps` sweeps in all: each store read and written
    once, the tables once a launch."""
    V = n_vars(inst)
    nbytes = stores * 2 * 2 * V * WORD + launches * table_bytes(inst)
    return nbytes, sweeps * ops_per_sweep(inst)


def search_work(inst, lanes: int, max_depth: int, sweeps: int,
                supersteps: int, launches: int):
    """(bytes, ops) of `launches` resident search launches that ran
    `supersteps` supersteps and `sweeps` lane sweeps: the lane state read
    and written once a launch, the tables once a launch; the sweeps'
    propagation and, per lane and superstep, the solved and failed tests
    (2·V) and the branch choice (3·B, B = n + 1 branching variables)."""
    V = n_vars(inst)
    nbytes = launches * (2 * lanes * lane_state_bytes(inst, max_depth)
                         + table_bytes(inst))
    ops = (sweeps * ops_per_sweep(inst)
           + supersteps * lanes * (2 * V + 3 * (inst.n + 1)))
    return nbytes, ops


def least_seconds(nbytes: float, ops: float, int_peak: float) -> float:
    """The larger of bytes over the HBM rate and operations over the
    integer peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / int_peak)
