"""The phases of one solve, on the host's ``time.perf_counter_ns`` clock.

`Solver.solve_iter` opens a `SolveTrace` per solve and switches it from
phase to phase at the boundaries of its work; the leaf phases tile the
solve from its start to its result, less the time a consumer spends
between the solve's events:

=============  ==========================================================
``eps.host``   `eps.decompose`'s host work: the frontier, the children's
               stores, the pool
``eps.stage``  a split's staging: its host stores to the device and the
               kernel wrapper's checks and arguments
``eps.launch`` the two-store launch's enqueue (from just before the
               kernel's launch call; on the CPU the plain version's run)
               up to `fixpoint_batch`'s return
``eps.wait``   the copy of the split's fixpoints back (``.cpu()``)
``pool``       the pool's padding and its copy to the device
``init``       the lanes' initialisation
``search.host`` per quantum, the host work before the enqueue: under
               ``cuda_resident`` `search_cuda`'s checks, copies and
               argument packing up to the launch; otherwise the
               superstep's `lanes_step` and the done flag's reduction
``search.launch`` from just before the quantum's first kernel launch
               call (the resident search, or under ``cuda`` the first
               fixpoint; on the CPU their plain versions) up to the read;
               ``gather`` launches no kernel
``search.read`` the quantum's one host read (``.tolist()`` of the
               superstep count and stop flag, or ``bool(done)``)
``solve.loop`` `solve_iter`'s bookkeeping between quanta (its counters'
               reads, the incumbent, the budgets)
``solve.result`` the final reads and `derive_result`
=============  ==========================================================

Every phase keeps a count and a total (`SolveTrace.phases`), always:
a switch is one clock read and a dictionary update, about a
microsecond.  While a ``torch.profiler`` records, or inside
`recording()`, the trace also keeps each span as ``(name, t0_ns,
t1_ns)`` (`SolveTrace.spans`) and each kernel launch as ``(kernel,
t_ns)`` (`SolveTrace.launches`: the kernel the wrapper enqueued, as the
device's trace names it, or on the CPU the plain function that stands
in for it), so that a reader can lay the host's phases beside the
device's trace.

Calls that `solve_iter` makes (`eps.decompose`, `_run_chunk` and the
kernel wrappers under it) reach the current solve's trace through a
context variable (`active`, `mark`, `launch`), set only around those
calls, so that their signatures stay as they are.  A kernel wrapper
calls `launch` just before its enqueue; that opens the launch phase
only from the phase that `LAUNCH_PHASE` names, and leaves any other
phase open.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Dict, List, Optional, Tuple

import torch.autograd.profiler as _autograd_profiler

_clock = time.perf_counter_ns
_current: contextvars.ContextVar[Optional["SolveTrace"]] = \
    contextvars.ContextVar("repro_torch_solve_trace", default=None)
_recording = 0
# the phase a kernel's enqueue opens, by the phase it is enqueued from
LAUNCH_PHASE = {"eps.stage": "eps.launch", "search.host": "search.launch"}


def timeline_on() -> bool:
    """Whether a new solve keeps its spans: a ``torch.profiler`` records,
    or a `recording()` block is open."""
    return bool(_recording or _autograd_profiler._is_profiler_enabled)


@contextlib.contextmanager
def recording():
    """Keep the spans of every solve that starts inside the block, with
    or without a profiler."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


class SolveTrace:
    """The phases of one solve: a count and nanoseconds per phase, and
    while the timeline is on (`timeline_on`, read once at construction)
    the spans ``(name, t0_ns, t1_ns)`` and the kernel launches
    ``(kernel, t_ns)`` in order.  Opens `first` at construction;
    `switch` closes the open phase and opens another, `pause` closes it
    and opens none."""

    __slots__ = ("_acc", "spans", "launches", "_name", "_t")

    def __init__(self, first: Optional[str] = None):
        self._acc: Dict[str, List[int]] = {}
        on = timeline_on()
        self.spans: Optional[List[Tuple[str, int, int]]] = [] if on else None
        self.launches: Optional[List[Tuple[str, int]]] = [] if on else None
        self._name = first
        self._t = _clock()

    def switch(self, name: Optional[str]) -> None:
        """Close the open phase now and open `name` (None: none).  A
        switch to the open phase changes nothing."""
        if name == self._name:
            return
        t = _clock()
        if self._name is not None:
            acc = self._acc.get(self._name)
            if acc is None:
                acc = self._acc[self._name] = [0, 0]
            acc[0] += 1
            acc[1] += t - self._t
            if self.spans is not None:
                self.spans.append((self._name, self._t, t))
        self._name, self._t = name, t

    def pause(self) -> None:
        """Close the open phase; the next `switch` opens one again."""
        self.switch(None)

    def launch(self, kernel: str) -> None:
        """`kernel` is about to be enqueued: open the launch phase of
        the open phase (`LAUNCH_PHASE`; any other phase stays open), and
        while the timeline is on stamp the launch."""
        nxt = LAUNCH_PHASE.get(self._name)
        if nxt is not None:
            self.switch(nxt)
        if self.launches is not None:
            self.launches.append((kernel, _clock()))

    @property
    def phases(self) -> Dict[str, Tuple[int, float]]:
        """``{phase: (count, seconds)}`` of the closed phases."""
        return {k: (n, ns / 1e9) for k, (n, ns) in self._acc.items()}

    def seconds(self, *names: str) -> float:
        """Total seconds of the phases `names` (all with none given)."""
        keys = names or tuple(self._acc)
        return sum(self._acc[k][1] for k in keys if k in self._acc) / 1e9

    def count(self, name: str) -> int:
        return self._acc.get(name, (0, 0))[0]

    def table(self) -> List[str]:
        """One line per phase: seconds, count and mean, in the order
        the solve first entered them."""
        return [f"{k:<14} {ns / 1e9:10.4f} s {n:8d}x {ns / n / 1e3:10.1f} us"
                for k, (n, ns) in self._acc.items()]


@contextlib.contextmanager
def active(tr: Optional[SolveTrace]):
    """Make `tr` the trace that `mark` switches, for the block only."""
    token = _current.set(tr)
    try:
        yield tr
    finally:
        _current.reset(token)


def mark(name: str) -> None:
    """Switch the active trace, if any, to phase `name`."""
    tr = _current.get()
    if tr is not None:
        tr.switch(name)


def launch(kernel: str) -> None:
    """`kernel` is about to be enqueued (`SolveTrace.launch`) under the
    active trace, if any: called by the kernel wrappers just before the
    launch call, so that the launch phase and the stamp come no later
    than the kernel."""
    tr = _current.get()
    if tr is not None:
        tr.launch(kernel)
