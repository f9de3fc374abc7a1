"""Failure detection, elastic re-mesh and lane rebalance — the solver half
of ``repro/ft/fault_tolerance.py``.

* `Heartbeat` tracks per-host liveness from beat timestamps on an
  injectable clock, and `FailureInjector` silences hosts on a
  deterministic schedule; the distributed EPS solver names its shards
  ``shard<d>`` and ticks a `LogicalClock` once per host chunk
  (`solver_heartbeat`), so a lost shard is declared dead at the next
  chunk boundary.
* `solver_shard_loss` recovers a distributed solve from a lost shard
  (`DeviceLoss`) given the last chunk-boundary snapshot, and
  `elastic_remesh` places the survivors' state on the smaller mesh
  (`distributed/sharding.shard_tree`, the counterpart of the reference's
  ``device_put`` with recomputed shardings).
* `scaled_batch` and `rebalance_lanes` are host arithmetic.
* `TrainSupervisor` drives (restore → step* → checkpoint)* for training:
  the data pipeline is step-addressable and the step deterministic, so a
  run killed at any step and resumed from its last checkpoint equals the
  uninterrupted run bit for bit.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.distributed.sharding import shard_tree, tree_map


# --------------------------------------------------------------------------
# heartbeat / failure detection (simulation-grade, injectable clock)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Heartbeat:
    """Tracks per-host liveness from beat timestamps."""
    hosts: List[str]
    timeout_s: float = 30.0
    clock: Callable[[], float] = time.time

    def __post_init__(self):
        now = self.clock()
        self.last_beat: Dict[str, float] = {h: now for h in self.hosts}

    def beat(self, host: str):
        self.last_beat[host] = self.clock()

    def dead_hosts(self) -> List[str]:
        now = self.clock()
        return [h for h, t in self.last_beat.items()
                if now - t > self.timeout_s]

    def all_alive(self) -> bool:
        return not self.dead_hosts()


class FailureInjector:
    """Deterministic fault schedule for tests: {step: [host, ...]}."""

    def __init__(self, schedule: Dict[int, List[str]]):
        self.schedule = schedule
        self.failed: set = set()

    def advance(self, step: int, hb: Heartbeat):
        for h in self.schedule.get(step, []):
            self.failed.add(h)
        # failed hosts stop beating; everyone else beats
        for h in hb.hosts:
            if h not in self.failed:
                hb.beat(h)


# --------------------------------------------------------------------------
# elastic re-mesh
# --------------------------------------------------------------------------

def elastic_remesh(tree, new_mesh, axis: str = "lanes", rules=None):
    """Place a host tree (leaves with a leading logical ``axis``) on a new
    (smaller or larger) mesh: the split is recomputed from the logical
    rules for the surviving topology (`shard_tree`), so nothing depends
    on device ids.  Returns the per-shard trees, in mesh order."""
    return shard_tree(tree, new_mesh, axis=axis, rules=rules)


def scaled_batch(global_batch: int, n_data_shards: int) -> int:
    """Per-shard batch after an elastic rescale: exact when divisible,
    else the floor (at least 1)."""
    if global_batch % n_data_shards == 0:
        return global_batch // n_data_shards
    return max(1, global_batch // n_data_shards)


# --------------------------------------------------------------------------
# training supervisor: crash-safe step loop
# --------------------------------------------------------------------------

def restore_like(like, restored):
    """The numpy tree `restored` as tensors at the dtype and on the device
    of each leaf of `like`, the tree they replace (dicts by key)."""
    if isinstance(like, dict):
        return {k: restore_like(v, restored[k]) for k, v in like.items()}
    return torch.as_tensor(np.asarray(restored)).to(like.device, like.dtype)


@dataclasses.dataclass
class TrainSupervisor:
    """Drives (restore → step* → checkpoint)* with failure handling.

    The step function ``step_fn(params, opt_state, step) -> (params,
    opt_state, metrics)`` must be deterministic in (params, opt, step):
    the data pipeline being step-addressable makes resumed runs
    bit-exact.
    """
    checkpointer: "object"
    ckpt_every: int = 50
    heartbeat: Optional[Heartbeat] = None
    injector: Optional[FailureInjector] = None

    def run(self, params, opt_state, step_fn, n_steps: int,
            start_step: int = 0, on_failure: Optional[Callable] = None):
        step = start_step
        restored = self.checkpointer.restore()
        if restored is not None:
            step, p_np, o_np = restored
            params = restore_like(params, p_np)
            opt_state = restore_like(opt_state, o_np)
        metrics_log = []
        while step < n_steps:
            if self.injector is not None and self.heartbeat is not None:
                self.injector.advance(step, self.heartbeat)
                if not self.heartbeat.all_alive():
                    dead = self.heartbeat.dead_hosts()
                    if on_failure is not None:
                        return on_failure(dead, step, metrics_log)
                    raise RuntimeError(f"hosts lost at step {step}: {dead}")
            params, opt_state, metrics = step_fn(params, opt_state, step)
            step += 1
            metrics_log.append({k: float(v) for k, v in metrics.items()})
            if step % self.ckpt_every == 0 or step == n_steps:
                self.checkpointer.save(step, params, opt_state,
                                       background=True)
        self.checkpointer.wait()
        return params, opt_state, metrics_log


# --------------------------------------------------------------------------
# solver-side elastic remesh (distributed EPS engine)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DeviceLoss:
    """Deterministic fault schedule for the distributed EPS solver
    (`core/dist_solve.py`): after ``at_chunk`` completed host chunks,
    shard ``shard`` is declared dead.  Detected by the Heartbeat /
    FailureInjector pair (hosts named ``shard<d>``), recovered by
    `solver_shard_loss`."""
    at_chunk: int
    shard: int


class LogicalClock:
    """Chunk-counter clock for the solver heartbeat: the solve loop sets
    ``t`` once per host chunk, so a shard that misses one beat is dead at
    the next chunk boundary, whatever the wall clock says."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def solver_heartbeat(n_shards: int, loss: Optional[DeviceLoss]):
    """(Heartbeat, FailureInjector) pair watching the solve's shards.
    With ``loss=None`` the schedule is empty: every shard beats forever.
    The heartbeat runs on a `LogicalClock` (``hb.clock``)."""
    hosts = [f"shard{d}" for d in range(n_shards)]
    schedule = ({loss.at_chunk: [f"shard{loss.shard}"]}
                if loss is not None else {})
    hb = Heartbeat(hosts=hosts, timeout_s=0.5, clock=LogicalClock())
    return hb, FailureInjector(schedule)


def solver_shard_loss(snapshot: dict, lost: int) -> dict:
    """Recover a distributed solve from the loss of shard ``lost``, given
    the last chunk-boundary ``snapshot`` (host numpy views, leading axis
    = shard):

    * ``state``    — tree of lane state, each leaf ``[D, L, ...]``
    * ``owned``    — per-shard lists of undispatched pool ids
    * ``inflight`` — per-shard ``(root_lb, root_ub)`` rows of lanes that
      are mid-search (loaded a subproblem, not yet done)

    Returns the survivor view: the lost shard's lane state is dropped,
    while what the host can rebuild is requeued — its undispatched pool
    slice verbatim, plus the *root* stores of its in-flight subproblems
    (re-exploring part of a subtree repeats nodes, nothing more).  The
    incumbent is not taken from the lost shard: callers fold in the host
    incumbent checkpoint of every chunk boundary.
    """
    D = len(snapshot["owned"])
    keep = [d for d in range(D) if d != lost]
    state = tree_map(lambda x: np.asarray(x)[keep], snapshot["state"])
    owned = [list(snapshot["owned"][d]) for d in keep]
    requeue_ids = sorted(snapshot["owned"][lost])
    lost_lb, lost_ub = snapshot["inflight"][lost]
    return dict(state=state, owned=owned, requeue_ids=requeue_ids,
                requeue_roots=(np.asarray(lost_lb), np.asarray(lost_ub)),
                survivors=keep)


# --------------------------------------------------------------------------
# solver-side straggler mitigation (lane rebalance)
# --------------------------------------------------------------------------

def rebalance_lanes(next_sub: np.ndarray, done: np.ndarray, n_subs: int,
                    n_lanes: int):
    """Host-side EPS queue rebalance: move unconsumed subproblem cursors
    from overloaded lanes to exhausted ones (a lane strides the pool by
    ``n_lanes``).  Updates ``next_sub`` and ``done`` in place and returns
    them with the number of moves."""
    remaining = np.maximum(0, (n_subs - next_sub + n_lanes - 1) // n_lanes)
    order = np.argsort(-remaining)
    idle = [i for i in order if done[i] or remaining[i] == 0]
    busy = [i for i in order if remaining[i] > 1]
    moved = 0
    for i in idle:
        if not busy:
            break
        donor = busy.pop(0)
        # steal the donor's last queued subproblem index
        last = next_sub[donor] + (remaining[donor] - 1) * n_lanes
        next_sub[i] = last
        done[i] = False
        remaining[donor] -= 1
        moved += 1
        if remaining[donor] > 1:
            busy.append(donor)
    return next_sub, done, moved
