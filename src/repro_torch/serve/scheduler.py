"""The continuous-batching scheduler — port of
``repro/serve/scheduler.py``.

One `SolverScheduler` owns a `Solver` session and a set of *buckets*,
keyed by ``(shape_signature, config.compile_key(), pool bucket)``.  Each
bucket wraps an `api.LaneBatch` of ``max_batch`` slots, reused for every
request that lands in the bucket.  Under ``cuda_resident`` one quantum
of a bucket is one launch of the resident search kernel over all its
slots.

Per scheduler quantum (`step`):

1. **ingress**: drain the thread-safe `RequestQueue`, routing each
   request to its bucket (creating the bucket on first sight of a new
   shape/config);
2. **admission**: earliest-deadline-first over each bucket's waiting
   list, splicing requests into idle slots at the quantum boundary
   (`LaneBatch.splice`, after `eps.decompose` of the request on the
   host; requests whose deadline expired while queued are answered
   UNKNOWN without ever occupying a slot);
3. **stepping**: one `LaneBatch.step` per non-empty bucket, then
   per-slot bookkeeping off the `BatchSnapshot`: improvement events
   stream to the request's handle, finished slots retire with their
   `derive_result`, deadline-missed slots are evicted with their best
   anytime incumbent (``complete=False``, never OPTIMAL/UNSAT);
4. **observability**: queue depth, per-bucket occupancy and the kernel
   libraries each bucket's batch had built, sampled into the
   `MetricsRecorder`.

Policy: EDF at admission (no-deadline requests last, FIFO among
themselves), run-to-completion once admitted (a slot is never preempted
for a later request; eviction happens only at the request's own
deadline).  With one host thread this is cooperative scheduling at
quantum granularity.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core import eps
from repro_torch.core.api import (Improvement, LaneBatch, Progress,
                                  SolveConfig, SolveResult, Solver, UNKNOWN,
                                  _bucket, shape_signature)
from repro_torch.serve.metrics import MetricsRecorder
from repro_torch.serve.queue import RequestQueue, SolveRequest
from repro_torch.serve.session import RequestHandle


@dataclasses.dataclass
class _Active:
    """A request occupying a lane-batch slot."""
    request: SolveRequest
    handle: RequestHandle
    t_admit: float
    deadline_t: Optional[float]            # absolute, None = no deadline
    best_seen: Optional[int] = None
    found_sol: bool = False
    improvements: List[Improvement] = dataclasses.field(default_factory=list)


class _Bucket:
    """One shape×config bucket: a `LaneBatch` plus its waiting list."""

    def __init__(self, label: str, cfg: SolveConfig, batch: LaneBatch):
        self.label = label
        self.cfg = cfg
        self.batch = batch
        self.waiting: List[Tuple[SolveRequest, RequestHandle]] = []
        self.active: Dict[int, _Active] = {}
        self.n_requests = 0


def _on(device: torch.device):
    """The batch's device as the thread's current CUDA device (so the
    kernels' ``torch.cuda.current_stream`` is that device's)."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


class SolverScheduler:
    """Single-threaded continuous-batching host loop (drive `step`
    yourself, or wrap in `serve.SolverService` for the threaded
    surface).  ``max_batch`` is the slot width of every bucket's
    `LaneBatch`."""

    def __init__(self, config: Optional[SolveConfig] = None, *,
                 max_batch: int = 4, session: Optional[Solver] = None,
                 recorder: Optional[MetricsRecorder] = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.config = (config if config is not None
                       else SolveConfig.preset("prove"))
        self.session = session if session is not None else Solver(self.config)
        self.recorder = recorder if recorder is not None else MetricsRecorder()
        self.max_batch = int(max_batch)
        self.queue = RequestQueue()
        self._buckets: Dict[tuple, _Bucket] = {}
        self._open_lock = threading.Lock()
        self._n_open = 0

    # -- submission (any thread) ------------------------------------------

    def submit(self, request: SolveRequest) -> RequestHandle:
        request.t_submit = time.time()
        handle = RequestHandle(request)
        with self._open_lock:
            self._n_open += 1
        self.recorder.record_submit(request.request_id, request.t_submit)
        self.queue.push((request, handle))
        return handle

    # -- introspection -----------------------------------------------------

    def has_work(self) -> bool:
        with self._open_lock:
            return self._n_open > 0

    def queue_depth(self) -> int:
        return len(self.queue) + sum(len(b.waiting)
                                     for b in self._buckets.values())

    def buckets(self) -> Dict[str, Dict[str, Any]]:
        """Per-bucket stats (label → counters), with the kernel libraries
        the bucket's batch had built and their seconds (0 for a bucket
        whose kernels were built before it, and under ``gather``)."""
        return {
            b.label: dict(
                n_requests=b.n_requests, width=b.batch.width,
                pool_size=b.batch.pool_size,
                n_spliced=b.batch.n_spliced, n_retired=b.batch.n_retired,
                n_builds=b.batch.n_builds,
                build_s=round(b.batch.build_s, 4))
            for b in self._buckets.values()
        }

    # -- the scheduler quantum ---------------------------------------------

    def step(self) -> bool:
        """One quantum: ingress → admission → step buckets → bookkeeping.
        Returns False when there was nothing at all to do (the idle
        signal the threaded service sleeps on)."""
        now = time.time()
        progressed = False
        for req, handle in self.queue.drain():
            self._route(req, handle)
            progressed = True
        for b in self._buckets.values():
            progressed |= self._admit(b, now)
        for b in self._buckets.values():
            if b.batch.occupancy == 0:
                continue
            with _on(b.batch.device):
                snap = b.batch.step()
            self.recorder.sample_occupancy(b.label, b.batch.occupancy,
                                           b.batch.width)
            self.recorder.record_bucket(
                b.label, n_builds=b.batch.n_builds, width=b.batch.width)
            self._process(b, snap)
            progressed = True
        if progressed:
            self.recorder.sample_queue_depth(self.queue_depth())
        return progressed

    def run_until_drained(self, *, max_wall_s: Optional[float] = None) -> None:
        """Step until every submitted request has retired."""
        t0 = time.time()
        while self.has_work():
            self.step()
            if max_wall_s is not None and time.time() - t0 > max_wall_s:
                raise TimeoutError(
                    f"scheduler not drained within {max_wall_s}s "
                    f"({self.queue_depth()} queued)")

    # -- internals ---------------------------------------------------------

    def _route(self, req: SolveRequest, handle: RequestHandle) -> None:
        cfg = req.config if req.config is not None else self.config
        sig = shape_signature(req.cm)
        tgt = cfg.resolved_eps_target()
        pool_size = _bucket(tgt) if cfg.pad_pool else tgt
        key = (sig, cfg.compile_key(), pool_size)
        b = self._buckets.get(key)
        if b is None:
            label = f"b{len(self._buckets)}:{req.cm.name or 'anon'}"
            batch = self.session.lane_batch(
                req.cm, width=self.max_batch, pool_size=pool_size,
                config=cfg)
            b = self._buckets[key] = _Bucket(label, cfg, batch)
            self.recorder.record_bucket(label, width=batch.width)
        b.n_requests += 1
        self.recorder.record_bucket(b.label, n_requests=1)
        b.waiting.append((req, handle))

    @staticmethod
    def _deadline_t(req: SolveRequest) -> Optional[float]:
        return (None if req.deadline_s is None
                else req.t_submit + req.deadline_s)

    def _admit(self, b: _Bucket, now: float) -> bool:
        if not b.waiting:
            return False
        progressed = False
        # expire requests whose deadline passed while still queued
        still: List[Tuple[SolveRequest, RequestHandle]] = []
        for req, handle in b.waiting:
            dt = self._deadline_t(req)
            if dt is not None and now > dt:
                self._expire_waiting(req, handle, now)
                progressed = True
            else:
                still.append((req, handle))
        # EDF: earliest absolute deadline first; no-deadline requests
        # last, FIFO among themselves
        still.sort(key=lambda rh: (self._deadline_t(rh[0])
                                   if self._deadline_t(rh[0]) is not None
                                   else math.inf, rh[0].t_submit))
        b.waiting = still
        for i in b.batch.idle_slots():
            if not b.waiting:
                break
            req, handle = b.waiting.pop(0)
            opts = b.cfg.search_options()
            t0 = time.time()
            with _on(b.batch.device):
                subs_lb, subs_ub = eps.decompose(
                    req.cm.to(b.batch.device), b.cfg.resolved_eps_target(),
                    opts)
            b.batch.splice(i, req.cm, subs_lb, subs_ub,
                           request_id=req.request_id,
                           eps_s=time.time() - t0)
            b.active[i] = _Active(request=req, handle=handle, t_admit=now,
                                  deadline_t=self._deadline_t(req))
            self.recorder.record_admit(req.request_id, b.label, now)
            progressed = True
        return progressed

    def _expire_waiting(self, req: SolveRequest, handle: RequestHandle,
                        now: float) -> None:
        """A deadline elapsed before the request reached a slot: answer
        UNKNOWN (no search state exists to derive from)."""
        res = SolveResult(status=UNKNOWN, objective=None, solution=None,
                          n_nodes=0, n_fails=0, n_sols=0, n_sweeps=0,
                          n_supersteps=0, wall_s=now - req.t_submit,
                          complete=False)
        with self._open_lock:
            self._n_open -= 1
        self.recorder.record_done(req.request_id, res, now,
                                  deadline_missed=True)
        handle._push(Progress(
            superstep=0, best_objective=None, has_solution=False,
            incumbent=None, n_nodes=0, n_sols=0,
            wall_s=res.wall_s, final=True, result=res, t_host=now))

    def _process(self, b: _Bucket, snap) -> None:
        obj_model = b.batch.obj_var >= 0
        for i in sorted(b.active):
            act = b.active[i]
            rid = act.request.request_id
            wall = snap.t_host - act.t_admit
            superstep = int(snap.superstep[i])
            if bool(snap.has_sol[i]):
                obj = int(snap.best_obj[i]) if obj_model else None
                improved = (not act.found_sol if not obj_model
                            else act.best_seen is None or obj < act.best_seen)
                if improved:
                    act.found_sol = True
                    act.best_seen = obj
                    self.recorder.record_first_incumbent(rid, snap.t_host)
                    _, sol = b.batch.incumbent(i)
                    if obj_model:
                        act.improvements.append(
                            Improvement(superstep, wall, obj))
                    act.handle._push(Progress(
                        superstep=superstep, best_objective=obj,
                        has_solution=True, incumbent=sol,
                        n_nodes=int(snap.n_nodes[i]),
                        n_sols=int(snap.n_sols[i]), wall_s=wall,
                        t_host=snap.t_host))
            done = bool(snap.gdone[i])
            expired = (act.deadline_t is not None
                       and snap.t_host > act.deadline_t)
            if not (done or expired):
                continue
            res = b.batch.retire(i, wall_s=wall,
                                 improvements=act.improvements)
            del b.active[i]
            with self._open_lock:
                self._n_open -= 1
            self.recorder.record_done(rid, res, snap.t_host,
                                      deadline_missed=expired and not done)
            act.handle._push(Progress(
                superstep=superstep, best_objective=res.objective,
                has_solution=res.solution is not None,
                incumbent=res.solution, n_nodes=res.n_nodes,
                n_sols=res.n_sols, wall_s=wall, final=True, result=res,
                t_host=snap.t_host))
