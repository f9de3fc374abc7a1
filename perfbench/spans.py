"""Readers of the program's own phases, and the clock that lays them
beside the device's trace.

A solve of ``repro_torch`` keeps its phases on ``SolveResult.trace``
(``src/repro_torch/core/trace.py``): a count and seconds per phase
always, and in a traced run every span ``(name, t0_ns, t1_ns)`` on the
host's ``perf_counter`` clock, the clock of the harness's ``t0``,
``t_start`` and ``t_done``.  A program without them (an older one) gives
every reader here ``None``.

The device's trace (``Run.device_ops``) counts from the profiler's own
start, which the harness takes for the window's ``t0``.  `clock` does
not assume it: each launch that the program stamps bounds the offset
``T0`` of the device's zero on the host clock, since a kernel starts
after its enqueue and ends before the read that waits for it returns,

    enqueue − start ≤ T0 ≤ return − end.

The program stamps each launch with the kernel its wrapper enqueued
(``SolveTrace.launches``); the stamps of one kernel are matched in order
to the device's operations of that kernel, and each one's return is the
end of the first read phase after it (``eps.wait`` or ``search.read``:
both wait for the whole stream).  So the clock follows whatever kernels
the backend launches.  ``T0`` is the middle of the bracket, the
intersection of the launches' bounds.  The profiler's clock is not held
to the host's for a whole window: on the H100 it drifts by 0.1–0.5 % for
seconds at a time and then slews back within a few milliseconds, by up
to about 13 ms, so the launches, in the device's order, are split into
segments, each the longest run whose bounds still intersect, and each
segment's bracket places the trace until the next segment's first
launch.  A launch whose own bounds are empty (its kernel, on the
device's clock, outlasts its enqueue to its read: the two clocks ran
apart during it) bounds nothing: it ends the segment, joins none and is
counted (`Clock.skipped`).  No bracket is widened; where a kernel's
stamps and its device operations do not pair one to one, there is no
clock and the readers that need one return ``None``.

`idle_unnamed` checks that the phases cover the solve on the card's
idle time; it does not check the clock, which places the phases only
to within its bracket.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
from typing import Dict, List, Optional

# the phases whose end a launch's kernel has ended by
READS = ("eps.wait", "search.read")
EPS_WAIT = "eps.wait"
QUANTUM_READ = "search.read"
QUANTUM_HOST = ("search.host", "search.launch", "solve.loop")


def trace_of(sv):
    """The program's trace of solve `sv`, or None."""
    return getattr(sv.result, "trace", None) if sv.result is not None \
        else None


def eps_host_s(run) -> Optional[float]:
    """The mean over the window's solves of EPS's phases other than the
    wait on the copy back (``eps.*`` less ``eps.wait``), in seconds."""
    per = []
    for sv in run.in_window():
        tr = trace_of(sv)
        if tr is None:
            continue
        eps = [k for k in tr.phases if k.startswith("eps.") and k != EPS_WAIT]
        if eps:
            per.append(tr.seconds(*eps))
    return sum(per) / len(per) if per else None


def quantum_host_ms(run) -> Optional[float]:
    """Host milliseconds per quantum of the search outside the quantum's
    read: the phases before and at the enqueue and the bookkeeping
    between quanta (`QUANTUM_HOST`), over the quanta (``search.read``),
    summed over the solves of the run."""
    host, quanta = 0.0, 0
    for sv in run.solves:
        tr = trace_of(sv)
        if tr is None:
            continue
        host += tr.seconds(*QUANTUM_HOST)
        quanta += tr.count(QUANTUM_READ)
    return 1e3 * host / quanta if quanta else None


# --------------------------------------------------------------------------
# the clock
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Clock:
    """Where the device's zero lies on the host clock: per segment of
    the device's time its first moment (s from the trace's start; the
    first segment from the start), ``T0`` (s, host clock), the bracket's
    width and the launches in it; and the launches that bounded nothing
    (their own bounds empty)."""

    dev_starts: List[float]
    t0s: List[float]
    widths: List[float]
    sizes: List[int]
    skipped: int = 0

    @property
    def n_launches(self) -> int:
        return sum(self.sizes)

    @property
    def width_s(self) -> float:
        """The widest segment's bracket."""
        return max(self.widths)

    def share_within(self, width_s: float) -> float:
        """The share of the launches in segments no wider than
        `width_s`."""
        return sum(n for n, w in zip(self.sizes, self.widths)
                   if w <= width_s) / self.n_launches

    def to_host(self, t_dev: float) -> float:
        """A device time (s from the trace's start) on the host clock."""
        k = max(0, bisect.bisect_right(self.dev_starts, t_dev) - 1)
        return t_dev + self.t0s[k]


def launch_stamps(tr) -> Optional[Dict[str, List[tuple]]]:
    """``{kernel: [(enqueue s, return s), ...]}`` of a solve's timeline:
    each stamped launch, and the end of the first read phase (`READS`)
    after it; None where a launch has no read after it."""
    reads = [(a, b) for name, a, b in tr.spans or () if name in READS]
    starts = [a for a, _ in reads]
    out: Dict[str, List[tuple]] = {}
    for kernel, t in tr.launches or ():
        j = bisect.bisect_left(starts, t)
        if j == len(reads):
            return None                    # a launch without its read
        out.setdefault(kernel, []).append((t / 1e9, reads[j][1] / 1e9))
    return out


def kernel_ops(run, kernel: str) -> List[tuple]:
    """The device's operations of `kernel` (its name a word of theirs),
    in order."""
    named = re.compile(r"\b" + re.escape(kernel) + r"\b").search
    return [op for op in run.device_ops if named(op[0])]


def launches(run) -> Optional[List[tuple]]:
    """``(device start, lo, hi)`` of every stamped launch of the window in
    the device's order, ``[lo, hi]`` its bounds on ``T0``; None where no
    launch is stamped, or a kernel's stamps and its device operations do
    not pair one to one."""
    stamps: Dict[str, List[tuple]] = {}
    for sv in run.solves:
        tr = trace_of(sv)
        if tr is None or tr.spans is None:
            continue
        st = launch_stamps(tr)
        if st is None:
            return None
        for k, v in st.items():
            stamps.setdefault(k, []).extend(v)
    out = []
    for kernel, st in stamps.items():
        ops = kernel_ops(run, kernel)
        if len(ops) != len(st):
            return None
        out += [(start, enq - start, ret - (start + dur))
                for (enq, ret), (_, start, dur) in zip(st, ops)]
    return sorted(out) or None


def clock(run) -> Optional[Clock]:
    """The device trace's zero on the host clock (module docstring), or
    None; computed once per run."""
    if "_spans_clock" not in run.__dict__:
        run._spans_clock = _clock(run)
    return run._spans_clock


def _clock(run) -> Optional[Clock]:
    if not run.device_ops:
        return None
    bounds = launches(run)
    if not bounds:
        return None
    ck = Clock([], [], [], [])

    def close(start, lo, hi, n):
        ck.dev_starts.append(start if ck.dev_starts else -float("inf"))
        ck.t0s.append((lo + hi) / 2)
        ck.widths.append(hi - lo)
        ck.sizes.append(n)

    start, lo, hi, n = None, None, None, 0
    for s, l, h in bounds:
        if n and max(lo, l) <= min(hi, h):
            lo, hi, n = max(lo, l), min(hi, h), n + 1
            continue
        if n:
            close(start, lo, hi, n)
        if l > h:                          # at odds with itself
            ck.skipped += 1
            n = 0
            continue
        start, lo, hi, n = s, l, h, 1
    if n:
        close(start, lo, hi, n)
    return ck if ck.t0s else None


# --------------------------------------------------------------------------
# the card's idle time by phase
# --------------------------------------------------------------------------

def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def named_intervals(run) -> List[tuple]:
    """``(start, end, name)`` on the host clock, in order: every leaf
    span of the window's solves, and the harness's ``build`` and
    ``compile`` of each."""
    out = []
    for sv in run.solves:
        out += [(sv.t_start, sv.t_built, "build"),
                (sv.t_built, sv.t_compiled, "compile")]
        tr = trace_of(sv)
        if tr is not None and tr.spans:
            out += [(a / 1e9, b / 1e9, name) for name, a, b in tr.spans]
    return sorted(o for o in out if o[1] > o[0])


def idle_by_phase(run) -> Optional[Dict[Optional[str], float]]:
    """Seconds of the traced window (its ``t0`` to the last solve's
    return, on the host clock) in which no operation runs on the card,
    split by the phase or harness span they fall in (`named_intervals`);
    the key None holds what none covers.  None without a clock."""
    ck = clock(run)
    if ck is None:
        return None
    busy = _merged((ck.to_host(a), ck.to_host(a) + d)
                   for _, a, d in run.device_ops)
    t_end = run.t0 + run.window_s
    idle, at = [], run.t0
    for a, b in busy:
        if a > at:
            idle.append((at, min(a, t_end)))
        at = max(at, b)
        if at >= t_end:
            break
    if at < t_end:
        idle.append((at, t_end))
    named = named_intervals(run)
    out: Dict[Optional[str], float] = {None: 0.0}
    j = 0
    for a, b in idle:
        if b <= a:
            continue
        covered = 0.0
        while j < len(named) and named[j][1] <= a:
            j += 1
        k = j
        while k < len(named) and named[k][0] < b:
            s, e, name = named[k]
            d = min(b, e) - max(a, s)
            if d > 0:
                out[name] = out.get(name, 0.0) + d
                covered += d
            k += 1
        out[None] += max(0.0, (b - a) - covered)
    return out


def idle_unnamed(run) -> Optional[float]:
    """The share of the card's idle time in the traced window that no
    leaf span of the program and no ``build`` or ``compile`` of the
    harness covers, in %."""
    by = idle_by_phase(run)
    if by is None:
        return None
    total = sum(by.values())
    return 100.0 * by[None] / total if total > 0 else None
