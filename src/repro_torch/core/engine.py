"""Legacy blocking entry point — a thin shim over the session API (the
port of ``repro/core/engine.py``).

The solver proper lives in `repro_torch.core.api` (public façade
``repro_torch.solver``): `SolveConfig` presets, `Solver` sessions,
batched `solve_many` and the streaming `solve_iter`.  This module keeps
the reference's ``engine.solve(cm, n_lanes=..., ...)`` signature working:
it maps the keyword arguments onto a `SolveConfig` and delegates to the
module-level ``api.solve`` (the default session with that config), and
it re-exports the status constants and `SolveResult`.  The config's
device is the compiled model's (``cm.device``): the call runs where the
model lives, on the card unless the model was compiled for the CPU.

New code should use::

    from repro_torch import solver
    res = solver.solve(cm)                              # one-shot
    sess = solver.Solver(solver.SolveConfig.preset("prove"))
    res = sess.solve(cm)                                # session
"""

from __future__ import annotations

import warnings
from typing import Optional

from repro_torch.core import api as _api
from repro_torch.core import search as S
from repro_torch.core.compile import CompiledModel
from repro_torch.distributed.sharding import Mesh

# re-exports (the historical home of these names)
from repro_torch.core.api import (  # noqa: F401
    OPTIMAL, SAT, UNSAT, UNKNOWN, SolveResult, Improvement, SolveConfig,
    derive_result)


def solve(cm: CompiledModel,
          n_lanes: int = 64,
          n_subproblems: Optional[int] = None,
          opts: Optional[S.SearchOptions] = None,
          timeout_s: Optional[float] = None,
          max_supersteps: Optional[int] = None,
          chunk: int = 256,
          mesh: Optional[Mesh] = None,
          lane_axes: tuple = (),
          subs: Optional[tuple] = None,
          eps_target: Optional[int] = None,
          ) -> SolveResult:
    """Deprecated blocking solve — use ``repro_torch.solver``.

    Exactly equivalent to building a `SolveConfig` from these keyword
    arguments (on ``cm``'s device) and calling
    ``repro_torch.solver.solve(cm, config=cfg, subs=subs)``.  Warns
    `DeprecationWarning` once per call.
    """
    warnings.warn(
        "engine.solve is deprecated; use repro_torch.solver "
        "(Solver/SolveConfig sessions)", DeprecationWarning, stacklevel=2)
    o = opts or S.SearchOptions()
    cfg = SolveConfig(
        n_lanes=n_lanes,
        eps_target=(eps_target if eps_target is not None else n_subproblems),
        chunk=chunk, timeout_s=timeout_s, max_supersteps=max_supersteps,
        backend=o.backend, var_strategy=o.var_strategy,
        val_strategy=o.val_strategy, max_depth=o.max_depth,
        max_fixpoint_iters=o.max_fixpoint_iters,
        stop_on_first=o.stop_on_first, mesh=mesh,
        lane_axes=tuple(lane_axes), device=cm.device.type)
    return _api.solve(cm, subs=subs, config=cfg)
