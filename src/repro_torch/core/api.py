"""Session-oriented solver API — port of the single-instance part of
``repro/core/api.py``.

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
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

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
