"""Session-oriented solver API — port of ``repro/core/api.py``.

`SolveConfig` is one frozen, validated configuration with the
reference's named presets (``prove``, ``first_solution``, ``fast``) and
one field the reference does not have: ``device`` (``cuda`` unless the
caller asks for ``cpu``; a missing GPU raises).  `Solver.solve_iter`
decomposes the root (`eps.decompose`), pads the pool to its `_bucket`
with explicitly failed stores, and drives the search from a host loop
in quanta (`_run_chunk`), stopping on the exact superstep where the
reference's ``while_loop`` stops:

* ``gather`` and ``cuda``: up to ``chunk`` `search.lanes_step`
  supersteps, each ending with one host read of the global done flag
  (one device synchronisation per superstep);
* ``cuda_resident``: one launch of the resident search kernel covering
  ``supersteps_per_launch`` supersteps (default 16), after which the
  host reads the superstep count and the stop flag once; with
  ``lane_tile`` the lanes run in tiles, each with its own pool cursor
  (the carry holds ``[n_tiles]`` cursors).

Timeouts and ``max_supersteps`` are checked once per quantum.  PyTorch
runs eagerly, so there is no compiled-runner cache.

Batched solving: `LaneBatch` holds B same-shape instance *slots* (one
request each) in one lane state, and `Solver.solve_many` drives one to
the end; the serving scheduler (`repro_torch.serve`) admits requests
into its slots.  Under ``cuda_resident`` one quantum of the batch is
ONE launch of the resident search kernel over every slot
(`kernels/fixpoint_kernel.search_slots_cuda`), the counterpart of the
reference's vmapped ``search_pallas``; under ``gather`` and ``cuda`` a
quantum runs `_run_chunk` on each live slot's rows in turn.
"""

from __future__ import annotations

import dataclasses
import time
from typing import (Any, Dict, Iterator, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from repro_torch.core import eps
from repro_torch.core import search as S
from repro_torch.core.backend import available_backends, get_backend
from repro_torch.core.compile import CompiledModel
from repro_torch.core.device import resolve_device

# terminal statuses
OPTIMAL = "OPTIMAL"
SAT = "SAT"
UNSAT = "UNSAT"
UNKNOWN = "UNKNOWN"


class Improvement(NamedTuple):
    """One incumbent improvement in a solve's anytime trace."""
    superstep: int
    wall_s: float
    objective: int


@dataclasses.dataclass
class SolveResult:
    status: str
    objective: Optional[int]
    solution: Optional[np.ndarray]
    n_nodes: int
    n_fails: int
    n_sols: int
    n_sweeps: int
    n_supersteps: int
    wall_s: float
    complete: bool
    # anytime trace, observed per host chunk
    improvements: Tuple[Improvement, ...] = ()
    # host seconds spent in eps.decompose (part of wall_s)
    eps_s: float = 0.0

    @property
    def nodes_per_sec(self) -> float:
        return self.n_nodes / max(self.wall_s, 1e-9)


@dataclasses.dataclass
class Progress:
    """One anytime event from `Solver.solve_iter`, emitted per host
    chunk; the last one has ``final=True`` and carries the result."""
    superstep: int
    best_objective: Optional[int]
    has_solution: bool
    incumbent: Optional[np.ndarray]
    n_nodes: int
    n_sols: int
    wall_s: float
    final: bool = False
    result: Optional[SolveResult] = None
    t_host: float = 0.0


_VAR_STRATEGIES = (S.INPUT_ORDER, S.MIN_DOM, S.MIN_LB)
_VAL_STRATEGIES = (S.VAL_MIN, S.VAL_SPLIT, S.VAL_MIDDLE_OUT)

PRESETS: Dict[str, Dict[str, Any]] = {
    "prove": dict(var_strategy=S.MIN_LB, max_depth=1024),
    "first_solution": dict(var_strategy=S.MIN_LB, max_depth=1024,
                           stop_on_first=True),
    "fast": dict(var_strategy=S.MIN_LB, max_depth=1024,
                 max_fixpoint_iters=4),
}


@dataclasses.dataclass(frozen=True)
class SolveConfig:
    """Everything `Solver` needs besides the model itself; validated on
    construction.  ``SolveConfig.preset("fast", n_lanes=128)``."""

    # lanes / EPS decomposition
    n_lanes: int = 64
    eps_target: Optional[int] = None          # None → 4 * n_lanes
    # host chunking / budgets
    chunk: int = 256
    timeout_s: Optional[float] = None
    max_supersteps: Optional[int] = None
    # propagation backend (core/backend.py)
    backend: str = "cuda"
    # cuda_resident only: supersteps per kernel launch (None → 16)
    supersteps_per_launch: Optional[int] = None
    # cuda_resident only: lanes per tile, each tile with its own strided
    # pool shard, cursor, bound and done flag (None → one pool queue)
    lane_tile: Optional[int] = None
    # search strategy (core/search.py)
    var_strategy: str = S.INPUT_ORDER
    val_strategy: str = S.VAL_MIN
    max_depth: int = 2048
    max_fixpoint_iters: Optional[int] = None
    stop_on_first: bool = False
    # pad EPS pools to `_bucket` sizes with explicitly failed stores
    pad_pool: bool = True
    # where the tensors live: "cuda" (default) or "cpu"
    device: str = "cuda"
    preset_name: Optional[str] = dataclasses.field(default=None,
                                                   compare=False)

    def __post_init__(self):
        def bad(msg):
            raise ValueError(f"SolveConfig: {msg}")

        for name in ("n_lanes", "chunk", "max_depth"):
            v = getattr(self, name)
            if not isinstance(v, int) or v < 1:
                bad(f"{name} must be a positive int, got {v!r}")
        for name in ("eps_target", "max_supersteps", "max_fixpoint_iters",
                     "supersteps_per_launch", "lane_tile"):
            v = getattr(self, name)
            if v is not None and (not isinstance(v, int) or v < 1):
                bad(f"{name} must be None or a positive int, got {v!r}")
        for name in ("supersteps_per_launch", "lane_tile"):
            if (getattr(self, name) is not None
                    and self.backend != "cuda_resident"):
                bad(f"{name} is only meaningful with "
                    "backend='cuda_resident'")
        if self.timeout_s is not None and not self.timeout_s > 0:
            bad(f"timeout_s must be None or > 0, got {self.timeout_s!r}")
        if self.backend not in available_backends():
            bad(f"unknown backend {self.backend!r}; "
                f"available: {', '.join(available_backends())}")
        if self.var_strategy not in _VAR_STRATEGIES:
            bad(f"var_strategy {self.var_strategy!r} not in "
                f"{_VAR_STRATEGIES}")
        if self.val_strategy not in _VAL_STRATEGIES:
            bad(f"val_strategy {self.val_strategy!r} not in "
                f"{_VAL_STRATEGIES}")
        resolve_device(self.device)

    @classmethod
    def preset(cls, name: str, **overrides) -> "SolveConfig":
        """Build a named preset (``prove`` | ``first_solution`` |
        ``fast``), optionally overriding any field."""
        try:
            base = PRESETS[name]
        except KeyError:
            raise ValueError(
                f"unknown preset {name!r}; available: "
                f"{', '.join(sorted(PRESETS))}") from None
        kw = dict(base)
        kw.update(overrides)
        kw.setdefault("preset_name", name)
        return cls(**kw)

    def replace(self, **overrides) -> "SolveConfig":
        if "preset_name" not in overrides:
            overrides["preset_name"] = None if overrides else self.preset_name
        return dataclasses.replace(self, **overrides)

    def search_options(self) -> S.SearchOptions:
        return S.SearchOptions(
            var_strategy=self.var_strategy, val_strategy=self.val_strategy,
            max_depth=self.max_depth,
            max_fixpoint_iters=self.max_fixpoint_iters,
            stop_on_first=self.stop_on_first, backend=self.backend)

    def resolved_supersteps(self) -> int:
        return (16 if self.supersteps_per_launch is None
                else self.supersteps_per_launch)

    def resolved_eps_target(self) -> int:
        return (self.eps_target if self.eps_target is not None
                else 4 * self.n_lanes)

    def compile_key(self) -> tuple:
        """The config half of a serving bucket's key: the fields that
        shape a quantum (the reference keys its compiled runner on
        them).  Budgets (timeout_s, max_supersteps), eps_target and
        pad_pool are host-side only: configs that differ only there
        share a bucket."""
        return (self.n_lanes, self.chunk, self.backend,
                self.supersteps_per_launch, self.lane_tile,
                self.var_strategy, self.val_strategy, self.max_depth,
                self.max_fixpoint_iters, self.stop_on_first, self.device)


def shape_signature(cm: CompiledModel) -> tuple:
    """Every static field and table shape that shapes a solve — the
    reference's cache-key half, kept so the two compiles can be held
    against each other."""
    return (cm.n_vars, cm.n_props, cm.k_terms, cm.d_occ,
            cm.n_alldiff, cm.ad_width, cm.ad_docc,
            cm.n_cumulative, cm.cu_width, cm.cu_docc, cm.horizon,
            cm.ad_layout, cm.ad_packed, cm.cu_layout, cm.cu_packed,
            cm.n_table, cm.ct_arity, cm.ct_words, cm.ct_docc, cm.n_words,
            int(cm.branch_vars.shape[0]), cm.obj_var, cm.dtype)


def _bucket(n: int) -> int:
    """Pool-size padding bucket: next power of two ≥ n up to 1024, then
    the next multiple of 1024."""
    if n <= 1:
        return 1
    if n <= 1024:
        return 1 << (n - 1).bit_length()
    return ((n + 1023) // 1024) * 1024


class Carry(NamedTuple):
    """Host-loop carry: lane state (its bitset store `dom`/`root_dom`
    included when search carries one), global bound (0-d device tensor),
    global done flag and superstep counter (host values), pool cursor
    (0-d int32 device tensor, or one per lane tile, ``[n_tiles]``)."""
    st: S.LaneState
    gbest: torch.Tensor
    gdone: bool
    it: int
    pool_head: torch.Tensor


def _carry_heads(cfg: SolveConfig, cm: CompiledModel):
    """The shape of the carry's pool cursor: ``()`` for one pool queue,
    ``(n_tiles,)`` for a lane-tiled ``cuda_resident`` solve."""
    if cfg.lane_tile is None:
        return ()
    return (get_backend(cfg.backend, lane_tile=cfg.lane_tile)
            .n_tiles(cm, cfg.n_lanes),)


def _init_carry(cm: CompiledModel, n_lanes: int, opts: S.SearchOptions,
                heads=()) -> Carry:
    big = torch.iinfo(cm.tdtype).max // 4
    return Carry(S.init_lanes(cm, n_lanes, opts),
                 torch.tensor(big, dtype=cm.tdtype, device=cm.device),
                 False, 0,
                 torch.zeros(heads, dtype=torch.int32, device=cm.device))


def _run_chunk(opts: S.SearchOptions, stop_on_first: bool, chunk: int,
               cm: CompiledModel, subs_lb, subs_ub, carry: Carry, *,
               supersteps: int = 16, lane_tile: int = 0) -> Carry:
    """One scheduler quantum.

    * ``cuda_resident``: ONE launch of the resident search kernel
      covering `supersteps` supersteps (`chunk` is not consulted), over
      lane tiles of `lane_tile` lanes when it is positive; the kernel
      derives the global (or each tile's) done flag each superstep and
      runs identity steps once it is set, and the host reads the
      superstep count and the stop flag once per launch;
    * otherwise up to `chunk` `lanes_step` supersteps, stopping after
      the superstep that sets the global done flag (the reference's
      ``while_loop`` condition).
    """
    st, gbest, gdone, it, pool_head = carry
    if opts.backend == "cuda_resident":
        st, gbest, it_t, pool_head, stopped = get_backend(
            opts.backend, lane_tile=lane_tile).superstep_launch(
                cm, subs_lb, subs_ub, st, gbest, it, pool_head, opts=opts,
                supersteps=supersteps)
        it, stop = torch.stack((it_t.to(torch.int32),
                                stopped.to(torch.int32))).tolist()
        return Carry(st, gbest, bool(stop), it, pool_head)
    for _ in range(chunk):
        if gdone:
            break
        st, pool_head = S.lanes_step(cm, subs_lb, subs_ub, opts, st, gbest,
                                     pool_head)
        gbest = torch.minimum(gbest, S.lanes_best(st))
        done = st.done.all()
        if stop_on_first:
            done = done | st.has_sol.any()
        it += 1
        gdone = bool(done)                 # the one sync per superstep
    return Carry(st, gbest, gdone, it, pool_head)


def derive_result(cm: CompiledModel, best_obj, has_sol, best_sol,
                  incomplete, done: bool, n_nodes: int, n_fails: int,
                  n_sols: int, n_sweeps: int, n_supersteps: int,
                  wall_s: float,
                  improvements: Tuple[Improvement, ...] = (),
                  eps_s: float = 0.0) -> SolveResult:
    """Derive (status, objective, solution) from terminal lane state.

    ``done`` means *search exhausted* (every lane drained the pool), not
    "the loop stopped": an early stop or a timeout never yields
    OPTIMAL/UNSAT.
    """
    best_obj = np.asarray(best_obj).reshape(-1)
    has_sol = np.asarray(has_sol).reshape(-1)
    best_sol = np.asarray(best_sol).reshape(-1, cm.n_vars)
    complete = bool(done) and not bool(np.asarray(incomplete).any())

    if has_sol.any():
        if cm.obj_var >= 0:
            i = int(best_obj.argmin())
            obj = int(best_obj[i])
            status = OPTIMAL if complete else SAT
        else:
            i = int(has_sol.argmax())
            obj = None
            status = SAT
        sol = best_sol[i]
    else:
        sol, obj = None, None
        status = UNSAT if complete else UNKNOWN

    return SolveResult(status=status, objective=obj, solution=sol,
                       n_nodes=int(n_nodes), n_fails=int(n_fails),
                       n_sols=int(n_sols), n_sweeps=int(n_sweeps),
                       n_supersteps=int(n_supersteps), wall_s=wall_s,
                       complete=complete,
                       improvements=tuple(improvements), eps_s=eps_s)


class Solver:
    """A solving session: one `SolveConfig`, overridable per call.

        solver = Solver(SolveConfig.preset("prove", n_lanes=1024))
        res = solver.solve(cm)
        many = solver.solve_many(cms)       # N same-shape instances
        for ev in solver.solve_iter(cm):    # anytime incumbent stream
            ...
    """

    def __init__(self, config: Optional[SolveConfig] = None, **overrides):
        base = config if config is not None else SolveConfig.preset("prove")
        self.config = base.replace(**overrides) if overrides else base

    def _config_for(self, config: Optional[SolveConfig],
                    overrides: dict) -> SolveConfig:
        cfg = config if config is not None else self.config
        return cfg.replace(**overrides) if overrides else cfg

    @staticmethod
    def _pool_for(cm: CompiledModel, cfg: SolveConfig, subs,
                  opts: S.SearchOptions):
        if subs is None:
            subs_lb, subs_ub = eps.decompose(cm, cfg.resolved_eps_target(),
                                             opts)
        else:
            subs_lb, subs_ub = (np.asarray(a) for a in subs)
        size = subs_lb.shape[0]
        if cfg.pad_pool:
            size = _bucket(size)
        subs_lb, subs_ub = eps.pad_pool(subs_lb, subs_ub, size)
        return (torch.from_numpy(np.array(subs_lb)).to(cm.device),
                torch.from_numpy(np.array(subs_ub)).to(cm.device))

    def solve(self, cm: CompiledModel, *, subs: Optional[tuple] = None,
              config: Optional[SolveConfig] = None,
              **overrides) -> SolveResult:
        """Blocking solve; equals the last `solve_iter` event's result."""
        res = None
        for ev in self.solve_iter(cm, subs=subs, config=config, **overrides):
            if ev.final:
                res = ev.result
        return res

    def solve_iter(self, cm: CompiledModel, *,
                   subs: Optional[tuple] = None,
                   config: Optional[SolveConfig] = None,
                   **overrides) -> Iterator[Progress]:
        """Anytime solve: a `Progress` event after every host chunk; the
        final event carries the `SolveResult`."""
        cfg = self._config_for(config, overrides)
        cm = cm.to(cfg.device)
        opts = cfg.search_options()
        t0 = time.time()
        subs_lb, subs_ub = self._pool_for(cm, cfg, subs, opts)
        eps_s = time.time() - t0
        carry = _init_carry(cm, cfg.n_lanes, opts, _carry_heads(cfg, cm))

        improvements: List[Improvement] = []
        best_seen = torch.iinfo(cm.tdtype).max // 4
        while True:
            carry = _run_chunk(opts, cfg.stop_on_first, cfg.chunk, cm,
                               subs_lb, subs_ub, carry,
                               supersteps=cfg.resolved_supersteps(),
                               lane_tile=cfg.lane_tile or 0)
            st = carry.st
            wall = time.time() - t0
            superstep = carry.it
            n_nodes = int(st.n_nodes.sum())
            n_sols = int(st.n_sols.sum())
            has = bool(st.has_sol.any())
            obj = None
            incumbent = None
            if cm.obj_var >= 0 and has:
                flat = st.best_obj.cpu().numpy()
                i = int(flat.argmin())
                obj = int(flat[i])
                if obj < best_seen:
                    best_seen = obj
                    improvements.append(Improvement(superstep, wall, obj))
                    incumbent = st.best_sol[i].cpu().numpy()
            stop = carry.gdone
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
            totals = S.lane_totals(st)
            exhausted = bool(st.done.all())
            res = derive_result(
                cm, st.best_obj.cpu(), st.has_sol.cpu(), st.best_sol.cpu(),
                st.incomplete.cpu(), exhausted, totals["n_nodes"],
                totals["n_fails"], totals["n_sols"], totals["n_sweeps"],
                superstep, time.time() - t0, tuple(improvements), eps_s)
            yield Progress(superstep=superstep, best_objective=res.objective,
                           has_solution=has, incumbent=res.solution,
                           n_nodes=res.n_nodes, n_sols=res.n_sols,
                           wall_s=res.wall_s, final=True, result=res,
                           t_host=t0 + res.wall_s)
            return

    # -- solve_many --------------------------------------------------------

    def solve_many(self, cms: Sequence[CompiledModel], *,
                   config: Optional[SolveConfig] = None,
                   **overrides) -> List[SolveResult]:
        """Solve N same-shape instances as the N slots of one `LaneBatch`.

        Each instance gets its own ``n_lanes`` lane block, its own EPS
        pool (pools padded to a common bucket with explicitly failed
        stores, ``[N, S, V]``), its own bound and its own done flag, so
        statuses, objectives and counters equal N sequential `solve`
        calls.  Under ``cuda_resident`` a quantum is one launch over all
        N slots.  Returns one `SolveResult` per instance, in input order;
        ``wall_s`` is the shared batch wall clock and ``eps_s`` each
        instance's own decomposition time.

        The degenerate case of the lane-owning `LaneBatch`: splice every
        instance up front, step until every slot is done, retire each.
        The serving scheduler (`repro_torch.serve`) drives the same class
        with continuous admission instead.
        """
        cms = list(cms)
        if not cms:
            return []
        cfg = self._config_for(config, overrides)
        opts = cfg.search_options()
        t0 = time.time()
        cms = [cm.to(cfg.device) for cm in cms]
        sig = shape_signature(cms[0])
        for k, cm in enumerate(cms[1:], 1):
            if shape_signature(cm) != sig:
                raise ValueError(
                    f"solve_many needs same-shape instances: instance {k} "
                    f"has signature {shape_signature(cm)} != {sig}")
        pools, eps_s = [], []
        for cm in cms:
            t = time.time()
            pools.append(eps.decompose(cm, cfg.resolved_eps_target(), opts))
            eps_s.append(time.time() - t)
        smax = max(p[0].shape[0] for p in pools)
        size = _bucket(smax) if cfg.pad_pool else smax

        batch = LaneBatch(self, cms[0], cfg, width=len(cms), pool_size=size)
        for i, (cm, (pl, pu)) in enumerate(zip(cms, pools)):
            batch.splice(i, cm, pl, pu, request_id=i, eps_s=eps_s[i])
        while True:
            snap = batch.step()
            wall = time.time() - t0
            if snap.gdone.all():
                break
            if cfg.timeout_s is not None and wall > cfg.timeout_s:
                break
            if (cfg.max_supersteps is not None
                    and int(snap.superstep.max()) >= cfg.max_supersteps):
                break
        wall = time.time() - t0
        return [batch.retire(i, wall_s=wall) for i in range(len(cms))]

    # -- lane_batch: the continuous-batching scheduler core ----------------

    def lane_batch(self, cm: CompiledModel, *, width: int,
                   pool_size: Optional[int] = None,
                   config: Optional[SolveConfig] = None,
                   **overrides) -> "LaneBatch":
        """A `LaneBatch` of ``width`` slots shaped for instances whose
        signature equals ``cm``'s — the core the serving layer
        (`repro_torch.serve`) admits requests into.  ``pool_size``
        defaults to the bucket of the config's EPS target, which bounds
        any `eps.decompose` pool for that target, so every admitted
        request's pool fits."""
        cfg = self._config_for(config, overrides)
        if pool_size is None:
            tgt = cfg.resolved_eps_target()
            pool_size = _bucket(tgt) if cfg.pad_pool else tgt
        return LaneBatch(self, cm, cfg, width=width, pool_size=pool_size)


# --------------------------------------------------------------------------
# LaneBatch: the lane-owning continuous-batching core
# --------------------------------------------------------------------------

_IDLE = object()          # slot-empty sentinel (request ids may be None)

# the LaneState fields a retired slot's result and an incumbent read,
# fetched to the host once per quantum
_HOST_FIELDS = ("best_obj", "has_sol", "best_sol", "incomplete", "done",
                "n_nodes", "n_fails", "n_sols", "n_sweeps")


class BatchSnapshot(NamedTuple):
    """Host-visible per-slot view of a `LaneBatch` after one quantum."""
    superstep: np.ndarray    # i[B] per-slot cumulative superstep counters
    gdone: np.ndarray        # bool[B] per-slot global-done flags
    best_obj: np.ndarray     # [B] per-slot incumbent bound (min over lanes)
    has_sol: np.ndarray      # bool[B]
    n_nodes: np.ndarray      # i[B] per-slot node totals
    n_sols: np.ndarray       # i[B]
    t_host: float            # host wall clock (time.time()) at snapshot


class LaneBatch:
    """A fixed-width batch of same-shape instance *slots*: one
    `LaneState` over ``width · n_lanes`` lanes, slot i the rows ``[i·n,
    (i+1)·n)``, with per-slot pools ``[width, pool_size, V]``, bounds,
    superstep counts, done flags and pool cursor(s), and each slot's own
    `CompiledModel`.  The slot's ``request_id`` threads lane ownership
    back to a serving request.

    Slots join (`splice`) and leave (`retire`) at quantum boundaries at
    fixed shape.  An idle slot is frozen: its done flag is set, its lanes
    are all ``done`` and its pool rows are explicitly failed stores
    (`eps.failed_pool`), so it cannot explore phantom subproblems.  A
    retired or evicted slot derives its result from the live state
    before the freeze, so it claims OPTIMAL or UNSAT only when its search
    was exhausted.

    A quantum (`step`): under ``cuda_resident``, ONE launch of the
    resident search kernel over every slot (K supersteps; stopped and
    idle slots run identity supersteps); under ``gather`` and ``cuda``,
    `_run_chunk` on each live slot's rows in turn (up to ``chunk``
    supersteps each), which leaves a finished slot's state as the
    reference's vmapped loop does.  Each quantum ends with one
    device-to-host copy of the fields a result reads (`_HOST_FIELDS`),
    reused by `snapshot`, `retire` and `incumbent`.

    Nothing here compiles a runner.  ``n_builds`` and ``build_s`` count
    the kernel libraries the batch's quanta made `kernels/build.py`
    compile (`Built.seconds > 0`) and their seconds: 0 under ``gather``,
    and 0 for a bucket whose kernels an earlier batch built.
    """

    def __init__(self, session: Solver, cm0: CompiledModel,
                 cfg: SolveConfig, *, width: int, pool_size: int):
        if width < 1 or pool_size < 1:
            raise ValueError(f"LaneBatch needs width >= 1 and pool_size >= "
                             f"1, got {width}, {pool_size}")
        self.session = session
        self.cfg = cfg
        self.width = int(width)
        self.pool_size = int(pool_size)
        self.opts = cfg.search_options()
        cm0 = cm0.to(cfg.device)
        self.device = cm0.device
        self.signature = shape_signature(cm0)
        self._cm0 = cm0
        self._obj_var, self._n_vars = cm0.obj_var, cm0.n_vars
        B, n = self.width, cfg.n_lanes
        # the live-slot template: what a spliced slot's lanes are reset to
        self._st1 = S.init_lanes(cm0, n, self.opts)
        il, iu = eps.failed_pool(cm0.lb0.cpu().numpy(),
                                 cm0.ub0.cpu().numpy(), self.pool_size)
        self._idle_lb = torch.from_numpy(il).to(self.device)
        self._idle_ub = torch.from_numpy(iu).to(self.device)
        self.subs_lb = self._idle_lb.repeat(B, 1, 1)
        self.subs_ub = self._idle_ub.repeat(B, 1, 1)
        st = S.LaneState(*(None if a is None else
                           a.repeat(B, *(1,) * (a.dim() - 1))
                           for a in self._st1))
        self.st = st._replace(done=torch.ones_like(st.done),
                              fresh=torch.zeros_like(st.fresh))
        self._big = torch.iinfo(cm0.tdtype).max // 4
        self.gbest = torch.full((B,), self._big, dtype=cm0.tdtype,
                                device=self.device)
        self.heads = torch.zeros((B,) + _carry_heads(cfg, cm0),
                                 dtype=torch.int32, device=self.device)
        self.it = np.zeros(B, np.int64)
        self.gdone = np.ones(B, bool)
        self.request_ids: List[Any] = [_IDLE] * B
        self._cms: List[Optional[CompiledModel]] = [None] * B
        self._eps_s = [0.0] * B
        self._host: Optional[Dict[str, np.ndarray]] = None
        self.n_spliced = 0
        self.n_retired = 0
        self.n_builds = 0
        self.build_s = 0.0

    # -- occupancy ---------------------------------------------------------

    def idle_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.request_ids) if r is _IDLE]

    def live_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.request_ids) if r is not _IDLE]

    @property
    def occupancy(self) -> int:
        return self.width - len(self.idle_slots())

    @property
    def obj_var(self) -> int:
        """The bucket's objective column (``< 0`` for satisfaction
        models)."""
        return self._obj_var

    def request_id(self, i: int):
        rid = self.request_ids[i]
        return None if rid is _IDLE else rid

    def _rows(self, i: int) -> slice:
        n = self.cfg.n_lanes
        return slice(i * n, (i + 1) * n)

    # -- join / leave at quantum boundaries --------------------------------

    def splice(self, i: int, cm: CompiledModel, subs_lb, subs_ub, *,
               request_id=None, eps_s: float = 0.0) -> None:
        """Admit an instance into idle slot ``i`` at fixed shape: its
        model becomes the slot's, its pool is padded to the bucket
        (`eps.fit_pool`) and its lanes, bound, superstep count and
        cursor(s) are reset to a fresh live state.  Takes effect at the
        next `step`.  ``eps_s`` (the seconds its pool took) is carried
        into its result."""
        if self.request_ids[i] is not _IDLE:
            raise ValueError(f"slot {i} is occupied by request "
                             f"{self.request_ids[i]!r}")
        cm = cm.to(self.device)
        if shape_signature(cm) != self.signature:
            raise ValueError(
                f"instance signature {shape_signature(cm)} does not match "
                f"this batch's bucket {self.signature}")
        lb, ub = eps.fit_pool(np.asarray(subs_lb), np.asarray(subs_ub),
                              self.pool_size)
        self.subs_lb[i].copy_(torch.from_numpy(np.array(lb)))
        self.subs_ub[i].copy_(torch.from_numpy(np.array(ub)))
        rows = self._rows(i)
        for a, one in zip(self.st, self._st1):
            if a is not None:
                a[rows].copy_(one)
        self.gbest[i] = self._big
        self.heads[i] = 0
        self.it[i] = 0
        self.gdone[i] = False
        self.request_ids[i] = request_id
        self._cms[i] = cm
        self._eps_s[i] = float(eps_s)
        self._host = None
        self.n_spliced += 1

    def retire(self, i: int, *, wall_s: float,
               improvements: Tuple[Improvement, ...] = ()) -> SolveResult:
        """Retire slot ``i``: derive its `SolveResult` from the slot's
        lanes (per-slot exhaustion, per-slot superstep count), then
        freeze the slot idle.  Valid whether the slot finished or is
        being evicted early (a deadline miss): the result is derived
        before the freeze, so an incomplete search never claims OPTIMAL
        or UNSAT."""
        if self.request_ids[i] is _IDLE:
            raise ValueError(f"slot {i} is idle")
        h = self._host_state()
        rows = self._rows(i)
        f = {k: v[rows] for k, v in h.items()}
        res = derive_result(
            self._cms[i], f["best_obj"], f["has_sol"], f["best_sol"],
            f["incomplete"], bool(f["done"].all()), int(f["n_nodes"].sum()),
            int(f["n_fails"].sum()), int(f["n_sols"].sum()),
            int(f["n_sweeps"].sum()), int(self.it[i]), wall_s,
            tuple(improvements), self._eps_s[i])
        self._freeze(i)
        self.request_ids[i] = _IDLE
        self._cms[i] = None
        self.n_retired += 1
        return res

    def _freeze(self, i: int) -> None:
        """Park slot ``i``: done flag, all lanes done, all-failed pool —
        every later superstep on the slot is an identity."""
        rows = self._rows(i)
        self.st.done[rows] = True
        self.st.fresh[rows] = False
        self.gdone[i] = True
        self.subs_lb[i].copy_(self._idle_lb)
        self.subs_ub[i].copy_(self._idle_ub)
        self._host = None

    # -- stepping ----------------------------------------------------------

    def step(self) -> BatchSnapshot:
        """Run ONE quantum over the batch (one launch over every slot
        under ``cuda_resident``; up to ``cfg.chunk`` supersteps per live
        slot otherwise) and return the host-visible snapshot."""
        from repro_torch.kernels.build import build
        built0, built_s0 = build.compiled, build.compiled_s
        cfg = self.cfg
        extra = ()
        if cfg.backend == "cuda_resident":
            cms = [c if c is not None else self._cm0 for c in self._cms]
            st, gbest, it, heads, stopped = get_backend(
                cfg.backend, lane_tile=cfg.lane_tile).superstep_launch(
                    cms, self.subs_lb, self.subs_ub, self.st, self.gbest,
                    self.it.tolist(), self.heads, opts=self.opts,
                    supersteps=cfg.resolved_supersteps())
            self.st, self.gbest, self.heads = st, gbest, heads
            extra = (("it", it), ("stopped", stopped))
        else:
            for i in range(self.width):
                if self.request_ids[i] is _IDLE or self.gdone[i]:
                    continue
                rows = self._rows(i)
                carry = _run_chunk(
                    self.opts, cfg.stop_on_first, cfg.chunk, self._cms[i],
                    self.subs_lb[i], self.subs_ub[i],
                    Carry(S.LaneState(*(None if a is None else a[rows]
                                        for a in self.st)),
                          self.gbest[i], False, int(self.it[i]),
                          self.heads[i]))
                for a, new in zip(self.st, carry.st):
                    if a is not None:
                        a[rows].copy_(new)
                self.gbest[i] = carry.gbest
                self.heads[i] = carry.pool_head
                self.it[i] = carry.it
                self.gdone[i] = carry.gdone
        self._host = self._fetch(extra)
        if extra:
            self.it[:] = self._host.pop("it")
            self.gdone |= self._host.pop("stopped")
        self.n_builds += build.compiled - built0
        self.build_s += build.compiled_s - built_s0
        return self.snapshot()

    def _fetch(self, extra=()) -> Dict[str, np.ndarray]:
        """The `_HOST_FIELDS` of the state (and the named tensors of
        `extra`) on the host, in ONE device-to-host copy."""
        parts = [(k, getattr(self.st, k)) for k in _HOST_FIELDS]
        parts += list(extra)
        flat = torch.cat([t.reshape(-1).to(torch.int64) for _, t in parts])
        flat = flat.cpu().numpy()
        out, at = {}, 0
        for k, t in parts:
            n = t.numel()
            # each field back at its own dtype (int32 or int64, bool)
            out[k] = flat[at:at + n].reshape(tuple(t.shape)).astype(
                torch.empty(0, dtype=t.dtype).numpy().dtype)
            at += n
        return out

    def _host_state(self) -> Dict[str, np.ndarray]:
        if self._host is None:          # after a splice or a freeze
            self._host = self._fetch()
        return self._host

    def snapshot(self) -> BatchSnapshot:
        h = self._host_state()
        B = self.width

        def per_slot(k):
            return h[k].reshape(B, -1)
        return BatchSnapshot(
            superstep=self.it.copy(),
            gdone=self.gdone.copy(),
            best_obj=per_slot("best_obj").min(axis=1),
            has_sol=per_slot("has_sol").any(axis=1),
            n_nodes=per_slot("n_nodes").sum(axis=1),
            n_sols=per_slot("n_sols").sum(axis=1),
            t_host=time.time())

    def incumbent(self, i: int):
        """Slot ``i``'s current best ``(objective, solution)`` —
        ``(None, None)`` while no solution exists; the objective is None
        for satisfaction models.  The lane pick of `derive_result`."""
        h = self._host_state()
        rows = self._rows(i)
        has = h["has_sol"][rows]
        if not has.any():
            return None, None
        sols = h["best_sol"][rows]
        if self._obj_var >= 0:
            objs = h["best_obj"][rows]
            k = int(objs.argmin())
            return int(objs[k]), sols[k]
        return None, sols[int(has.argmax())]


# --------------------------------------------------------------------------
# Module-level convenience: one shared default session
# --------------------------------------------------------------------------

_default_solver: Optional[Solver] = None


def default_solver() -> Solver:
    """The process-wide session of the module-level `solve`,
    `solve_iter` and `solve_many`, built on first use with
    ``SolveConfig()`` (on the card: it raises without one)."""
    global _default_solver
    if _default_solver is None:
        _default_solver = Solver(SolveConfig())
    return _default_solver


def _session(config: Optional[SolveConfig]) -> Solver:
    """The default session, or, given a `config`, a session of it (a
    session holds nothing but its config, so it is the default session
    solving with ``config=``, without building the default config)."""
    return default_solver() if config is None else Solver(config)


def solve(cm: CompiledModel, *, subs=None, config=None,
          **overrides) -> SolveResult:
    return _session(config).solve(cm, subs=subs, **overrides)


def solve_many(cms: Sequence[CompiledModel], *, config=None,
               **overrides) -> List[SolveResult]:
    return _session(config).solve_many(cms, **overrides)


def solve_iter(cm: CompiledModel, *, subs=None, config=None,
               **overrides) -> Iterator[Progress]:
    return _session(config).solve_iter(cm, subs=subs, **overrides)
