"""Distributed EPS: the lane pool in shards over a solve mesh — port of
``repro/core/dist_solve.py``.

The pool of consistent subproblems that `eps.decompose` produces
partitions the root search space, so disjoint lane blocks can explore its
shards and share only two values: the global bound (a min) and the
global done flag (an AND).  This module runs that regime over a 1-D
``solve`` mesh (`distributed/sharding.Mesh`) of D shards:

* **Sharding**: the ``[D·Ssh, V]`` pool and the ``[D·L, …]`` lane state
  split over ``solve`` (`SOLVE_RULES`, `shard_tree`); each shard runs the
  unchanged superstep (`search.lanes_step`) on its own slice and cursor.
* **Bound sharing**: every mesh superstep ends with ONE
  `collectives.solver_bound_sync` and one host read of the mesh's done
  flag (`api._run_mesh_chunk`); the host also folds the bound into its
  incumbent checkpoint once per chunk (the anytime stream).
* **Work stealing**, per host chunk: when a shard's queue drains (some
  lane done, no undispatched entries) while work remains elsewhere,
  `planner.plan_steal` repartitions the undispatched ids (fewest moves,
  balanced to within one) and every lane's done flag is cleared.
* **Device loss** (`ft.DeviceLoss`): detected by the Heartbeat /
  FailureInjector pair on a logical clock and recovered by
  `ft.solver_shard_loss`: survivors roll back to the last chunk-boundary
  snapshot, the lost shard's undispatched ids and the roots of its
  in-flight subproblems are requeued, and the survivors re-mesh over
  D−1 shards (`ft.elastic_remesh`).  The incumbent survives because the
  host checkpoints (objective, solution) every chunk.

The mesh is in-process: one host loop drives every shard, and all D
shards sit on the config's device (the torch counterpart of the
reference's fake host devices; mesh 1, 2 and 4 run on one card as on the
CPU).  The port runs eagerly, so there
is no runner cache.

**Completeness**: steals move only undispatched entries, so at every
chunk boundary the shards' undispatched id sets are pairwise disjoint and,
with the consumed ids, cover the pool (`DistTrace.assignments`,
``consumed_per_chunk``, ``all_ids``).  Device loss requeues a superset of
the lost shard's unexplored work, and the post-loss bound comes from the
surviving lanes and the host checkpoint, never from the failed chunk.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import eps
from repro_torch.core import search as S
from repro_torch.core.api import (_HOST_FIELDS, Improvement, MeshCarry,
                                  Progress, SolveConfig, SolveResult,
                                  _bucket, _init_mesh_carry,
                                  _run_mesh_chunk, _to_host, derive_result)
from repro_torch.core.compile import CompiledModel
from repro_torch.distributed import planner
from repro_torch.distributed.sharding import Mesh, make_mesh, shard_tree
from repro_torch.ft.fault_tolerance import (DeviceLoss, elastic_remesh,
                                            solver_heartbeat,
                                            solver_shard_loss)

AXIS = "solve"


@dataclasses.dataclass
class DistTrace:
    """Host-side record of one distributed solve."""
    n_chunks: int = 0
    n_bound_syncs: int = 0              # chunk-boundary host bound folds
    n_supersteps: int = 0               # per-superstep bound syncs
    gbest_per_chunk: List[int] = dataclasses.field(default_factory=list)
    steal_events: List[dict] = dataclasses.field(default_factory=list)
    remesh_events: List[dict] = dataclasses.field(default_factory=list)
    # per chunk boundary: per-shard undispatched id lists + consumed ids
    assignments: List[List[List[int]]] = dataclasses.field(
        default_factory=list)
    consumed_per_chunk: List[List[int]] = dataclasses.field(
        default_factory=list)
    all_ids: List[int] = dataclasses.field(default_factory=list)

    @property
    def n_steals(self) -> int:
        return len(self.steal_events)


class _Pool:
    """Host bookkeeping for the sharded EPS pool.

    Identity lives in integer *ids* (rows of the original decomposition,
    plus fresh ids for roots requeued by device-loss recovery); the layout
    (which contiguous slice of a shard a row occupies) is recomputed on
    every steal and remesh while the ids stay, which is what makes the
    disjointness/cover invariant checkable.
    """

    def __init__(self, subs_lb: np.ndarray, subs_ub: np.ndarray,
                 n_shards: int, pad_bucket: bool):
        self.store: Dict[int, Tuple[np.ndarray, np.ndarray]] = {
            i: (subs_lb[i].copy(), subs_ub[i].copy())
            for i in range(subs_lb.shape[0])}
        self.next_id = subs_lb.shape[0]
        self.consumed: set = set()
        self.n_shards = n_shards
        self.pad_bucket = pad_bucket
        self.template = (subs_lb[0].copy(), subs_ub[0].copy())
        self.owned, _ = planner.plan_steal([sorted(self.store)], n_shards)
        self.shard_size = self._shard_size()
        self.heads = np.zeros(n_shards, np.int64)
        self._layout()

    def _shard_size(self) -> int:
        need = max(max((len(o) for o in self.owned), default=1), 1)
        return _bucket(need) if self.pad_bucket else need

    def _layout(self):
        """Materialize `owned` into contiguous per-shard slices, padded
        with explicitly failed stores (`eps.pad_pool` semantics)."""
        D, Ssh = self.n_shards, self.shard_size
        V = self.template[0].shape[0]
        lb = np.empty((D * Ssh, V), self.template[0].dtype)
        ub = np.empty((D * Ssh, V), self.template[1].dtype)
        ids = np.full(D * Ssh, -1, np.int64)
        pad_lb, pad_ub = self.template[0].copy(), self.template[1].copy()
        pad_lb[0], pad_ub[0] = 1, 0
        for d in range(D):
            for k in range(Ssh):
                row = d * Ssh + k
                if k < len(self.owned[d]):
                    i = self.owned[d][k]
                    lb[row], ub[row] = self.store[i]
                    ids[row] = i
                else:
                    lb[row], ub[row] = pad_lb, pad_ub
        self.lb, self.ub, self.ids = lb, ub, ids
        self.heads = np.zeros(D, np.int64)

    def advance(self, heads: np.ndarray):
        """Consume the entries dispatched to lanes since the last chunk
        boundary (everything below each shard's new cursor)."""
        Ssh = self.shard_size
        for d in range(self.n_shards):
            lo, hi = int(self.heads[d]), min(int(heads[d]), Ssh)
            for pos in range(lo, hi):
                i = int(self.ids[d * Ssh + pos])
                if i >= 0:
                    self.consumed.add(i)
                    self.store.pop(i, None)
            self.heads[d] = hi
        self.owned = [
            [int(i) for i in self.ids[d * Ssh + int(self.heads[d]):
                                      (d + 1) * Ssh] if i >= 0]
            for d in range(self.n_shards)]

    def remaining(self) -> int:
        return sum(len(o) for o in self.owned)

    def steal(self) -> int:
        """Repartition the undispatched ids (`planner.plan_steal`) and
        re-layout.  Returns the number of entries that moved."""
        self.owned, moved = planner.plan_steal(self.owned, self.n_shards)
        self._layout()
        return moved

    def requeue(self, ids: List[int],
                roots: Tuple[np.ndarray, np.ndarray]) -> List[int]:
        """Device-loss recovery: `ids` come back as they are (their rows
        are still in `store`); in-flight roots get fresh ids."""
        new_ids = list(ids)
        r_lb, r_ub = roots
        for k in range(r_lb.shape[0]):
            i = self.next_id
            self.next_id += 1
            self.store[i] = (r_lb[k].copy(), r_ub[k].copy())
            new_ids.append(i)
        return new_ids

    def remesh(self, owned: List[List[int]], extra: List[int]):
        """Shrink to ``len(owned)`` shards, folding ``extra`` (the lost
        shard's requeued work) into a balanced repartition."""
        self.n_shards = len(owned)
        self.owned, _ = planner.plan_steal(owned + [extra], self.n_shards)
        self.shard_size = self._shard_size()
        self._layout()

    def all_ids(self) -> List[int]:
        return sorted(self.consumed | set(self.store))


def _mesh_for(n_shards: int, devices=None, device=None) -> Mesh:
    """A 1-D ``solve`` mesh of ``n_shards`` shards, every one on
    ``device`` (``None``: the card); a re-mesh passes the survivors'
    ``devices`` instead."""
    if devices is not None and len(devices) < n_shards:
        raise RuntimeError(
            f"mesh_shards={n_shards} but only {len(devices)} device(s) "
            "given")
    return make_mesh((n_shards,), (AXIS,), devices=devices, device=device)


class _Incumbent:
    """The host incumbent checkpoint: streamed once per chunk, and the
    only thing that survives a device loss."""

    def __init__(self, cm: CompiledModel):
        self.cm = cm
        self.big = torch.iinfo(cm.tdtype).max // 4
        self.obj = self.big
        self.sol: Optional[np.ndarray] = None
        self.has_sol = False

    def fold(self, h: Dict[str, np.ndarray]) -> None:
        has = h["has_sol"].reshape(-1)
        if not has.any():
            return
        if self.cm.obj_var >= 0:
            best = h["best_obj"].reshape(-1)
            i = int(best.argmin())
            if int(best[i]) < self.obj or not self.has_sol:
                self.obj = int(best[i])
                self.sol = h["best_sol"].reshape(
                    -1, self.cm.n_vars)[i].copy()
        elif not self.has_sol:
            i = int(has.argmax())
            self.sol = h["best_sol"].reshape(-1, self.cm.n_vars)[i].copy()
        self.has_sol = True

    def rows(self, V: int):
        """One extra lane row carrying the checkpoint, appended to the
        terminal state before `derive_result`."""
        sol = self.sol if self.sol is not None else np.zeros(V, np.int64)
        return (np.asarray([self.obj]), np.asarray([self.has_sol]),
                np.asarray(sol).reshape(1, V))


def _host(carry: MeshCarry, fields) -> Dict[str, np.ndarray]:
    """``fields`` of the shards' lane states, each concatenated over the
    shards in mesh order (``[D·L, …]``), and the shards' cursors
    (``heads``), on the host in one device-to-host copy."""
    dev = carry.gbest.device
    parts = [(f, torch.cat([getattr(st, f).to(dev) for st in carry.st]))
             for f in fields if getattr(carry.st[0], f) is not None]
    parts.append(("heads", torch.stack([h.to(dev)
                                        for h in carry.pool_head])))
    return _to_host(parts)


def solve_iter_dist(session, cm: CompiledModel, cfg: SolveConfig, *,
                    subs: Optional[tuple] = None,
                    fault: Optional[DeviceLoss] = None,
                    trace: Optional[DistTrace] = None
                    ) -> Iterator[Progress]:
    """Anytime distributed solve over ``cfg.mesh_shards`` shards (all on
    ``cfg.device``) for the `Solver`
    ``session``; yields the `Progress` stream of the
    single-device engine (one event per host chunk), the final event
    carrying the `SolveResult`."""
    trace = trace if trace is not None else DistTrace()
    opts = cfg.search_options()
    t0 = time.time()
    D = int(cfg.mesh_shards or 1)
    mesh = _mesh_for(D, device=cfg.device)
    hb, injector = solver_heartbeat(D, fault)

    # -- pool ---------------------------------------------------------------
    if subs is None:
        subs_lb, subs_ub = eps.decompose(cm, cfg.resolved_eps_target(), opts)
    else:
        subs_lb, subs_ub = subs
    eps_s = time.time() - t0
    pool = _Pool(np.asarray(subs_lb), np.asarray(subs_ub), D,
                 pad_bucket=cfg.pad_pool)
    trace.all_ids = pool.all_ids()

    def placed():
        """The pool's current layout on the mesh, and the model on each
        shard's device."""
        pools = shard_tree((pool.lb, pool.ub), mesh, axis="pool")
        return pools, [cm.to(lb.device) for lb, _ in pools]

    # -- carry --------------------------------------------------------------
    pools, cms = placed()
    carry = _init_mesh_carry(cms, S.init_lanes(cm, cfg.n_lanes * D, opts),
                             mesh)
    inc = _Incumbent(cm)
    improvements: List[Improvement] = []
    best_seen = inc.big
    lost_totals = dict(n_nodes=0, n_fails=0, n_sols=0, n_sweeps=0)
    snapshot: Optional[dict] = None
    chunk_idx = 0
    stop, exhausted = False, False
    # a fault needs the whole state at every boundary for its snapshot
    fields = S.LaneState._fields if fault is not None else _HOST_FIELDS

    def boundary_snapshot(h):
        """Checkpoint for recovery: per-shard lane state, owned ids and
        in-flight subproblem roots (kept only when a fault is
        scheduled)."""
        L, Dn = cfg.n_lanes, pool.n_shards
        inflight = []
        for d in range(Dn):
            sl = slice(d * L, (d + 1) * L)
            mask = (~h["done"][sl]) & (~h["fresh"][sl])
            inflight.append((h["root_lb"][sl][mask].copy(),
                             h["root_ub"][sl][mask].copy()))
        state = S.LaneState(**{
            f: None if f not in h else h[f].reshape((Dn, L) + h[f].shape[1:])
            for f in S.LaneState._fields})
        return dict(state=state, owned=[list(o) for o in pool.owned],
                    inflight=inflight, heads=pool.heads.copy())

    while not stop:
        # -- failure detection + elastic remesh (ft/) ----------------------
        hb.clock.t = float(chunk_idx)
        injector.advance(chunk_idx, hb)
        dead = hb.dead_hosts()
        if dead and pool.n_shards > 1 and snapshot is not None:
            lostd = int(dead[0].replace("shard", ""))
            rec = solver_shard_loss(snapshot, lostd)
            requeued = pool.requeue(rec["requeue_ids"],
                                    rec["requeue_roots"])
            # everyone rolls back to the checkpoint: the failed chunk's
            # bound sync never completed; the checkpoint keeps the lost
            # shard's counters (its incumbents are already in `inc`)
            for k in lost_totals:
                lost_totals[k] += int(
                    getattr(snapshot["state"], k)[lostd].sum())
            Dn = pool.n_shards - 1
            pool.remesh([list(o) for o in rec["owned"]], requeued)
            mesh = _mesh_for(Dn, devices=[
                d for i, d in enumerate(mesh.devices.reshape(-1))
                if i != lostd])
            st_prev = S.LaneState(*(
                None if x is None else x.reshape((-1,) + x.shape[2:])
                for x in rec["state"]))
            # revive drained survivor lanes so they take requeued work
            st_prev = st_prev._replace(done=np.zeros_like(st_prev.done))
            pools, cms = placed()
            # the bound restarts from the host checkpoint and the
            # survivors' own incumbents, never the failed chunk's value
            gbest = (min(inc.obj, int(st_prev.best_obj.min()))
                     if cm.obj_var >= 0 else inc.big)
            carry = MeshCarry(
                elastic_remesh(st_prev, mesh),
                torch.tensor(gbest, dtype=cm.tdtype, device=cms[0].device),
                False, carry.it,
                [torch.zeros((), dtype=torch.int32, device=c.device)
                 for c in cms])
            # a fresh heartbeat AND injector: shards renumber after the
            # remesh (the single scheduled loss is consumed)
            hb, injector = solver_heartbeat(Dn, None)
            trace.remesh_events.append(dict(
                chunk=chunk_idx, lost_shard=lostd,
                n_requeued=len(requeued), shards_before=Dn + 1,
                shards_after=Dn))
            snapshot = None

        # -- one mesh chunk -------------------------------------------------
        carry = _run_mesh_chunk(opts, cfg.stop_on_first, cfg.chunk, cms,
                                pools, carry)
        chunk_idx += 1
        trace.n_chunks += 1
        trace.n_bound_syncs += 1
        h = _host(carry, fields)
        pool.advance(h["heads"])
        inc.fold(h)
        superstep = carry.it
        trace.n_supersteps = superstep
        wall = time.time() - t0
        trace.gbest_per_chunk.append(inc.obj)
        trace.assignments.append([list(o) for o in pool.owned])
        trace.consumed_per_chunk.append(sorted(pool.consumed))
        if fault is not None:
            snapshot = boundary_snapshot(h)

        # -- anytime event --------------------------------------------------
        n_nodes = int(h["n_nodes"].sum()) + lost_totals["n_nodes"]
        n_sols = int(h["n_sols"].sum()) + lost_totals["n_sols"]
        has = bool(h["has_sol"].any()) or inc.has_sol
        obj = None
        incumbent = None
        if cm.obj_var >= 0 and has:
            obj = inc.obj
            if obj < best_seen:
                best_seen = obj
                improvements.append(Improvement(superstep, wall, obj))
                incumbent = inc.sol

        # -- termination / stealing ----------------------------------------
        if carry.gdone:
            if cfg.stop_on_first and has:
                stop = True
            else:
                stop = pool.remaining() == 0
                exhausted = stop and bool(h["done"].all())
        if not stop and cfg.steal and pool.n_shards > 1:
            L = cfg.n_lanes
            done_by_shard = h["done"].reshape(pool.n_shards, L)
            drained = [d for d in range(pool.n_shards)
                       if done_by_shard[d].any()
                       and len(pool.owned[d]) == 0]
            if drained and pool.remaining() > 0:
                before = [len(o) for o in pool.owned]
                moved = pool.steal()
                pools, cms = placed()
                h["done"] = np.zeros_like(h["done"])
                carry = MeshCarry(
                    [st._replace(done=torch.zeros_like(st.done))
                     for st in carry.st],
                    carry.gbest, False, carry.it,
                    [torch.zeros_like(x) for x in carry.pool_head])
                trace.steal_events.append(dict(
                    chunk=chunk_idx, drained_shards=drained,
                    n_moved=moved, owned_before=before,
                    owned_after=[len(o) for o in pool.owned]))
        if cfg.timeout_s is not None and wall > cfg.timeout_s:
            stop = True
        if (cfg.max_supersteps is not None
                and superstep >= cfg.max_supersteps):
            stop = True

        if not stop:
            yield Progress(superstep=superstep, best_objective=obj,
                           has_solution=has, incumbent=incumbent,
                           n_nodes=n_nodes, n_sols=n_sols, wall_s=wall,
                           t_host=t0 + wall)
            continue

        # -- terminal result ------------------------------------------------
        totals = {k: int(h[k].sum()) + v for k, v in lost_totals.items()}
        xo, xh, xs = inc.rows(cm.n_vars)
        best_obj = np.concatenate([h["best_obj"].reshape(-1), xo])
        has_sol = np.concatenate([h["has_sol"].reshape(-1), xh])
        best_sol = np.concatenate(
            [h["best_sol"].reshape(-1, cm.n_vars), xs])
        res = derive_result(
            cm, best_obj, has_sol, best_sol, h["incomplete"],
            exhausted, totals["n_nodes"], totals["n_fails"],
            totals["n_sols"], totals["n_sweeps"], superstep,
            time.time() - t0, tuple(improvements), eps_s)
        yield Progress(superstep=superstep, best_objective=res.objective,
                       has_solution=has, incumbent=res.solution,
                       n_nodes=res.n_nodes, n_sols=res.n_sols,
                       wall_s=res.wall_s, final=True, result=res,
                       t_host=t0 + res.wall_s)
        return


def solve_dist(cm: CompiledModel, config: Optional[SolveConfig] = None, *,
               subs: Optional[tuple] = None,
               fault: Optional[DeviceLoss] = None,
               session=None, **overrides
               ) -> Tuple[SolveResult, DistTrace]:
    """Blocking distributed solve; returns ``(result, trace)``.  Without
    ``mesh_shards`` it runs one shard: every shard sits on
    ``cfg.device``, so more of them add launches, not devices."""
    from repro_torch.core.api import Solver
    cfg = config if config is not None else SolveConfig()
    if overrides:
        cfg = cfg.replace(**overrides)
    if cfg.mesh_shards is None:
        cfg = cfg.replace(mesh_shards=1)
    sess = session if session is not None else Solver(cfg)
    trace = DistTrace()
    res = None
    for ev in solve_iter_dist(sess, cm.to(cfg.device), cfg, subs=subs,
                              fault=fault, trace=trace):
        if ev.final:
            res = ev.result
    return res, trace
