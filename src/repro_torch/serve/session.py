"""Caller-facing serving sessions: per-request event streams and the
threaded service — port of ``repro/serve/session.py``.

`RequestHandle` is what `submit` returns: a thread-safe stream of the
request's `Progress` events (improvements while the solve runs, then
exactly one ``final=True`` event carrying the `SolveResult`) and a
blocking `result()`.  The scheduler pushes into the handle from its host
loop; callers consume from any thread.

`SolverService` runs a `SolverScheduler` in a daemon thread, so callers
get submit-and-stream from any thread while the scheduler stays a
single-threaded host loop.  Every CUDA call of that thread goes to the
batch's device and that device's current stream (`LaneBatch.step` runs
under ``torch.cuda.device``; the kernels launch on
``torch.cuda.current_stream``).
"""

from __future__ import annotations

import threading
import time
from typing import Iterator, Optional

from repro_torch.core.api import Progress, SolveConfig, SolveResult
from repro_torch.core.compile import CompiledModel
from repro_torch.serve.queue import SolveRequest


class RequestHandle:
    """One request's stream of `Progress` events and terminal result."""

    def __init__(self, request: SolveRequest):
        self.request = request
        self._cv = threading.Condition()
        self._events = []
        self._result: Optional[SolveResult] = None

    # -- scheduler side ----------------------------------------------------

    def _push(self, ev: Progress) -> None:
        with self._cv:
            self._events.append(ev)
            if ev.final:
                self._result = ev.result
            self._cv.notify_all()

    # -- caller side -------------------------------------------------------

    def done(self) -> bool:
        with self._cv:
            return self._result is not None

    def result(self, timeout: Optional[float] = None) -> SolveResult:
        """Block until the request retires; raises TimeoutError on a
        caller-side wait timeout (the request itself keeps running)."""
        deadline = None if timeout is None else time.time() + timeout
        with self._cv:
            while self._result is None:
                left = (None if deadline is None
                        else max(deadline - time.time(), 0.0))
                if left == 0.0:
                    raise TimeoutError(
                        f"request {self.request.request_id} not done "
                        f"within {timeout}s")
                self._cv.wait(left)
            return self._result

    def events(self, timeout: Optional[float] = None) -> Iterator[Progress]:
        """Yield this request's `Progress` events in order, blocking for
        new ones until the ``final=True`` event; ``timeout`` bounds each
        wait."""
        i = 0
        while True:
            with self._cv:
                while i >= len(self._events):
                    if self._result is not None and self._events and \
                            self._events[-1].final:
                        return
                    if not self._cv.wait(timeout):
                        raise TimeoutError(
                            f"no event within {timeout}s for request "
                            f"{self.request.request_id}")
                ev = self._events[i]
            i += 1
            yield ev
            if ev.final:
                return


class SolverService:
    """Threaded serving facade: a `SolverScheduler` host loop in a daemon
    thread, `submit` callable from any thread.

    ``poll_s`` is how long the loop sleeps when there is no work at all;
    while work exists it spins at quantum granularity.  Use as a context
    manager: `close()` drains in-flight requests by default."""

    def __init__(self, config: Optional[SolveConfig] = None, *,
                 max_batch: int = 4, poll_s: float = 0.002, **sched_kw):
        from repro_torch.serve.scheduler import SolverScheduler
        self.scheduler = SolverScheduler(config, max_batch=max_batch,
                                         **sched_kw)
        self._poll_s = poll_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="repro-torch-serve-loop")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            if not self.scheduler.step():
                time.sleep(self._poll_s)

    def submit(self, cm: CompiledModel, *,
               deadline_s: Optional[float] = None,
               config: Optional[SolveConfig] = None,
               request_id: str = "", **meta) -> RequestHandle:
        if self._stop.is_set():
            raise RuntimeError("SolverService is closed")
        return self.scheduler.submit(SolveRequest(
            cm=cm, request_id=request_id, deadline_s=deadline_s,
            config=config, meta=meta))

    def close(self, *, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Stop the loop; with ``drain`` (default) keep stepping until
        every submitted request has retired first."""
        if drain:
            t0 = time.time()
            while self.scheduler.has_work():
                if timeout is not None and time.time() - t0 > timeout:
                    break
                time.sleep(self._poll_s)
        self._stop.set()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "SolverService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
