"""Serving observability: per-request latency records and the fleet
summary — port of ``repro/serve/metrics.py``.

One `MetricsRecorder` per scheduler.  Every timestamp comes from the
`Progress`/`BatchSnapshot` timing contract (host ``time.time()``); the
recorder never times anything itself.

Latencies, all relative to *submission*:

* **time to first incumbent (TTFI)**: submit → first solution found;
* **time to optimal (TTO)**: submit → terminal result for requests that
  completed their proof (OPTIMAL/UNSAT with ``complete=True``);
* **latency**: submit → terminal result, whatever the status (deadline
  evictions included).

Occupancy is sampled per bucket step: live slots / batch width at every
quantum the bucket ran.  Queue depth counts submitted requests not yet
admitted (ingress and per-bucket waiting).  A bucket's ``n_builds``
counts the kernel libraries its batch had built (`api.LaneBatch`), where
the reference counts compiles.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class RequestRecord:
    request_id: str
    t_submit: float
    bucket: Optional[str] = None
    t_admit: Optional[float] = None
    t_first_incumbent: Optional[float] = None
    t_done: Optional[float] = None
    status: Optional[str] = None
    objective: Optional[int] = None
    complete: bool = False
    deadline_missed: bool = False
    n_supersteps: int = 0

    @property
    def ttfi_s(self) -> Optional[float]:
        return (None if self.t_first_incumbent is None
                else self.t_first_incumbent - self.t_submit)

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.t_done is None else self.t_done - self.t_submit

    @property
    def queue_wait_s(self) -> Optional[float]:
        return None if self.t_admit is None else self.t_admit - self.t_submit


def _pctl(xs: List[float]) -> Dict[str, float]:
    if not xs:
        return dict(n=0)
    a = np.asarray(xs, float)
    return dict(n=len(xs), p50=round(float(np.percentile(a, 50)), 4),
                p99=round(float(np.percentile(a, 99)), 4),
                mean=round(float(a.mean()), 4),
                max=round(float(a.max()), 4))


class MetricsRecorder:
    """Thread-safe recorder; the scheduler calls the ``record_*`` and
    ``sample_*`` hooks, callers read `summary()`."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests: Dict[str, RequestRecord] = {}
        self.depth_samples: List[int] = []
        self.occupancy_samples: List[float] = []   # live/width per step
        self.live_samples: List[int] = []          # live slots per step
        self.bucket_stats: Dict[str, Dict[str, Any]] = {}

    # -- per-request lifecycle --------------------------------------------

    def record_submit(self, request_id: str, t: float) -> None:
        with self._lock:
            self.requests[request_id] = RequestRecord(request_id, t)

    def record_admit(self, request_id: str, bucket: str, t: float) -> None:
        with self._lock:
            r = self.requests[request_id]
            r.bucket, r.t_admit = bucket, t

    def record_first_incumbent(self, request_id: str, t: float) -> None:
        with self._lock:
            r = self.requests[request_id]
            if r.t_first_incumbent is None:
                r.t_first_incumbent = t

    def record_done(self, request_id: str, res, t: float, *,
                    deadline_missed: bool = False) -> None:
        with self._lock:
            r = self.requests[request_id]
            r.t_done, r.status, r.objective = t, res.status, res.objective
            r.complete = bool(res.complete)
            r.deadline_missed = deadline_missed
            r.n_supersteps = int(res.n_supersteps)

    # -- per-quantum samples ----------------------------------------------

    def sample_queue_depth(self, depth: int) -> None:
        with self._lock:
            self.depth_samples.append(int(depth))

    def sample_occupancy(self, bucket: str, live: int, width: int) -> None:
        with self._lock:
            self.live_samples.append(int(live))
            self.occupancy_samples.append(live / max(width, 1))
            b = self.bucket_stats.setdefault(
                bucket, dict(n_steps=0, n_requests=0, n_builds=0,
                             width=width))
            b["n_steps"] += 1

    def record_bucket(self, bucket: str, *, n_requests: int = 0,
                      n_builds: Optional[int] = None,
                      width: Optional[int] = None) -> None:
        with self._lock:
            b = self.bucket_stats.setdefault(
                bucket, dict(n_steps=0, n_requests=0, n_builds=0,
                             width=width or 0))
            b["n_requests"] += n_requests
            if n_builds is not None:
                b["n_builds"] = n_builds
            if width is not None:
                b["width"] = width

    # -- summary -----------------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            recs = list(self.requests.values())
            depth = list(self.depth_samples)
            live = list(self.live_samples)
            occ = list(self.occupancy_samples)
            buckets = {k: dict(v) for k, v in self.bucket_stats.items()}
        done = [r for r in recs if r.t_done is not None]
        proven = [r for r in done if r.complete]
        span_s = (max(r.t_done for r in done) - min(r.t_submit for r in recs)
                  if done else 0.0)
        statuses: Dict[str, int] = {}
        for r in done:
            statuses[r.status] = statuses.get(r.status, 0) + 1
        return dict(
            n_requests=len(recs),
            n_done=len(done),
            n_deadline_missed=sum(r.deadline_missed for r in done),
            statuses=statuses,
            ttfi_s=_pctl([r.ttfi_s for r in recs if r.ttfi_s is not None]),
            tto_s=_pctl([r.latency_s for r in proven]),
            latency_s=_pctl([r.latency_s for r in done]),
            queue_wait_s=_pctl([r.queue_wait_s for r in recs
                                if r.queue_wait_s is not None]),
            queue_depth=_pctl([float(d) for d in depth]),
            batch_occupancy=_pctl(occ),
            batch_live_slots=_pctl([float(x) for x in live]),
            instances_per_sec=round(len(done) / span_s, 2) if span_s > 0
            else None,
            span_s=round(span_s, 4),
            buckets=buckets,
        )
