"""Serving ingress: `SolveRequest` and the thread-safe admission queue —
port of ``repro/serve/queue.py``.

The queue is an ingress buffer between caller threads and the
scheduler's host loop.  All policy (shape bucketing, EDF ordering,
deadline eviction) lives in `serve/scheduler.py`, which drains this
queue at every scheduler quantum; callers never block on solver state,
only on the queue lock for the microseconds of a push.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
from collections import deque
from typing import Any, Dict, List, Optional

from repro_torch.core.api import SolveConfig
from repro_torch.core.compile import CompiledModel

_req_counter = itertools.count()


@dataclasses.dataclass
class SolveRequest:
    """One serving request: a compiled model plus per-request policy.

    ``deadline_s`` is relative to submission; when it elapses before the
    solve completes the scheduler retires the request early with its
    best anytime incumbent (SAT/UNKNOWN, ``complete=False``).
    ``config`` overrides the scheduler's default `SolveConfig` and is
    part of the bucket key, so differently configured requests never
    share a batch.
    """
    cm: CompiledModel
    request_id: str = ""
    deadline_s: Optional[float] = None
    config: Optional[SolveConfig] = None
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # stamped by the scheduler at submission (host wall clock)
    t_submit: float = 0.0

    def __post_init__(self):
        if not self.request_id:
            self.request_id = f"req-{next(_req_counter)}"
        if self.deadline_s is not None and not self.deadline_s > 0:
            raise ValueError(f"deadline_s must be None or > 0, got "
                             f"{self.deadline_s!r}")


class RequestQueue:
    """Thread-safe FIFO ingress buffer (submission order kept); the
    scheduler drains it whole once per quantum."""

    def __init__(self):
        self._lock = threading.Lock()
        self._items: deque = deque()

    def push(self, item) -> None:
        with self._lock:
            self._items.append(item)

    def drain(self) -> List:
        """Pop everything queued, in submission order."""
        with self._lock:
            items = list(self._items)
            self._items.clear()
        return items

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)
