"""Solve an RCPSP instance with the port, on the GPU by default.

  PYTHONPATH=src python -m repro_torch.launch.solve --n 60 --resources 4 \\
      --lanes 1024 --eps-target 4096
  PYTHONPATH=src python -m repro_torch.launch.solve --n 8 --device cpu

``--backend cuda`` (default) propagates with the Hopper fixpoint kernel,
one launch per superstep; ``--backend cuda_resident`` runs K whole
supersteps per launch of the resident search kernel (K from
``--supersteps-per-launch``, default 16), in lane tiles of N lanes with
``--lane-tile N`` (each tile with its own strided pool shard, cursor,
bound and done flag); ``--backend gather`` propagates with the plain
PyTorch sweep, ``--backend scatter`` with its scatter form (each
propagator joins its variables through ``scatter_reduce``; PyTorch ops
on the card).  ``--branch-value`` picks the value
branching: ``min`` (x ≤ lb), ``split`` (bisect at the midpoint) or
``middle_out`` (x = m | x ≠ m on the remaining value nearest the
midpoint; search then carries the bitset store).  ``--device cpu``
runs everything on the CPU (where the ``cuda`` backend's wrapper takes
the plain version).  Without a GPU and without ``--device cpu`` the
command fails instead of moving to the CPU.  ``--file`` reads a PSPLIB
``.sm`` or Patterson ``.rcp`` instance instead of generating one.
``--profile`` traces the EPS decomposition and the search apart with
``torch.profiler`` and prints, for each, the device time by kernel and
the device's busy share of its wall time, then its phases on the host
clock (`core/trace.py`): seconds, count and mean per phase.

``--mesh N`` runs distributed EPS (`core/dist_solve.py`): the pool in N
shards, every shard on ``--device`` (one card, or the CPU), each mesh
superstep one ``fixpoint_cuda`` launch per shard under ``cuda``, with a
bound sync per superstep, work stealing and the solve's
``distributed: shards=… chunks=… bound_syncs=… steals=… remeshes=…``
line at the end:

  PYTHONPATH=src python -m repro_torch.launch.solve --n 60 --lanes 1024 \
      --eps-target 4096 --mesh 4

``--subs N`` is the reference's pool size flag: the fallback of
``--eps-target`` (default 128, as the reference's).  ``--fast`` is the
reference's deprecated spelling of ``--preset fast`` (it warns
``DeprecationWarning``).

``--dryrun [--multi-pod]`` lays the solver out on the production mesh
(`launch/mesh.py`, 16×16 or 2×16×16 ``meta`` devices), as the
reference's solver dry-run: 8 lanes and a pool of 16 subproblems per
device, the lane state and the pool sharded over every mesh axis
(`sharding.dist_solve_specs`), the bound, flags and cursor replicated,
and one `solver_bound_sync` (three reductions: min of the bounds, AND of
the done flags, OR of the has-solution flags) per superstep.  It prints
the per-device argument bytes from the shard shapes of the lane state
and pool, built on the CPU at the model's shapes; nothing is solved.
The compile time, temp bytes and HLO all-reduce count of the
reference's line have no counterpart without XLA, and it says so.

  PYTHONPATH=src python -m repro_torch.launch.solve --dryrun --multi-pod
"""

import argparse
import contextlib
import time
import warnings

import torch

# CLI name -> SolveConfig preset name
_PRESETS = {"prove": "prove", "first": "first_solution", "fast": "fast"}


def main(argv=None):
    from repro_torch.core.backend import available_backends

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=10, help="RCPSP tasks")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resources", type=int, default=4)
    ap.add_argument("--lanes", type=int, default=32)
    ap.add_argument("--subs", type=int, default=128,
                    help="EPS pool size when --eps-target is not given")
    ap.add_argument("--eps-target", type=int, default=None,
                    help="EPS pool size: decompose the root into ~this many "
                         "subproblems (default --subs)")
    ap.add_argument("--timeout", type=float, default=120)
    ap.add_argument("--preset", choices=sorted(_PRESETS), default="prove")
    ap.add_argument("--fast", action="store_true",
                    help="DEPRECATED: use --preset fast")
    ap.add_argument("--backend", default="cuda", choices=available_backends())
    ap.add_argument("--supersteps-per-launch", type=int, default=None,
                    help="supersteps per resident kernel launch "
                         "(--backend cuda_resident only; default 16)")
    ap.add_argument("--lane-tile", type=int, default=None,
                    help="lanes per tile of the resident kernel, each tile "
                         "with its own strided pool shard (--backend "
                         "cuda_resident only; default: one pool queue)")
    ap.add_argument("--branch-value", default=None,
                    choices=("min", "split", "middle_out"),
                    help="value branching: min = x≤lb, split = bisect at "
                         "the midpoint, middle_out = x=m | x≠m on the "
                         "bitset-domain value nearest the midpoint "
                         "(default: the preset's, min)")
    ap.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="distributed EPS: the pool in N shards on --device, "
                         "a bound sync per superstep, work stealing")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--dryrun", action="store_true",
                    help="lay the solver out on the production mesh; "
                         "solve nothing")
    ap.add_argument("--multi-pod", action="store_true",
                    help="--dryrun on the 2x16x16 mesh")
    ap.add_argument("--file", default=None)
    ap.add_argument("--profile", action="store_true",
                    help="trace the solve; print device time by kernel")
    args = ap.parse_args(argv)
    if args.lane_tile is not None and args.backend != "cuda_resident":
        ap.error(f"--lane-tile needs --backend cuda_resident, not "
                 f"{args.backend}: the fixpoint kernel has no lane tile "
                 "(a CTA runs one lane), and the reference's pallas lane "
                 "tile changes no result")

    if args.fast:
        warnings.warn("--fast is deprecated; use --preset fast",
                      DeprecationWarning)
        args.preset = "fast"

    from repro_torch import solver
    from repro_torch.core.models import rcpsp
    from repro_torch.kernels.fixpoint_kernel import (fixpoint_cuda,
                                                     search_cuda)

    if args.file:
        inst = (rcpsp.parse_psplib_sm(args.file) if args.file.endswith(".sm")
                else rcpsp.parse_patterson(args.file))
    else:
        inst = rcpsp.generate(args.n, n_resources=args.resources,
                              seed=args.seed)
    m, handles = rcpsp.build_model(inst)
    if args.dryrun:
        # shapes only: the tables are built on the CPU, nothing is solved
        return _dryrun(m.compile(device="cpu"), args)
    cm = m.compile(device=args.device)
    value = ({} if args.branch_value is None
             else dict(val_strategy=args.branch_value))
    cfg = solver.SolveConfig.preset(
        _PRESETS[args.preset], n_lanes=args.lanes,
        eps_target=(args.eps_target if args.eps_target is not None
                    else args.subs), timeout_s=args.timeout,
        backend=args.backend, device=args.device,
        supersteps_per_launch=args.supersteps_per_launch,
        lane_tile=args.lane_tile, mesh_shards=args.mesh, **value)

    launches0 = fixpoint_cuda.launches
    search0 = search_cuda.launches
    subs = None
    t_eps = 0.0             # EPS time outside the solve (under --profile)
    if args.profile:
        # EPS traced apart from the search, so each gets its own breakdown
        from repro_torch.core import eps
        from repro_torch.core.trace import SolveTrace, active
        with _profiler(args.device) as prof:
            t_eps = time.time()
            eps_trace = SolveTrace("eps.host")
            with active(eps_trace):
                subs = eps.decompose(cm, cfg.resolved_eps_target(),
                                     cfg.search_options())
            eps_trace.pause()
            t_eps = time.time() - t_eps
        _profile_report(prof, t_eps, "eps")
        _phase_report(eps_trace, t_eps, "eps")
    res, trace = None, None
    sess = solver.Solver(cfg)
    if args.mesh is not None:
        # driven directly so the solve's DistTrace can be printed
        from repro_torch.core import dist_solve
        trace = dist_solve.DistTrace()
        events = dist_solve.solve_iter_dist(sess, cm, cfg, subs=subs,
                                            trace=trace)
    else:
        events = sess.solve_iter(cm, subs=subs)
    with (_profiler(args.device) if args.profile
          else contextlib.nullcontext()) as prof:
        for ev in events:
            if ev.final:
                res = ev.result
            elif ev.best_objective is not None and ev.incumbent is not None:
                print(f"  [{ev.wall_s:6.1f}s] superstep={ev.superstep:6d} "
                      f"incumbent={ev.best_objective} nodes={ev.n_nodes}")
    if prof is not None:
        _profile_report(prof, res.wall_s, "search")
        if res.trace is not None:
            _phase_report(res.trace, res.wall_s, "search")
    starts = ([int(res.solution[v.idx]) for v in handles["s"]]
              if res.solution is not None else None)
    check = None
    if starts:
        feasible, makespan = rcpsp.check_solution(inst, starts)
        check = "OK" if feasible and makespan == res.objective else "FAILED"
    # EPS and solve as timed inside the run (no profiler teardown)
    eps_s = res.eps_s + t_eps
    wall = res.wall_s + t_eps
    print(f"{inst.name}: {res.status} objective={res.objective} "
          f"nodes={res.n_nodes} ({res.n_nodes / max(wall, 1e-9):.0f}/s) "
          f"supersteps={res.n_supersteps} eps={eps_s:.2f}s "
          f"kernel_launches={fixpoint_cuda.launches - launches0} "
          f"search_launches={search_cuda.launches - search0} "
          f"wall={wall:.2f}s complete={res.complete} "
          f"ground_check={check}")
    if trace is not None:
        print(f"  distributed: shards={args.mesh} chunks={trace.n_chunks} "
              f"bound_syncs={trace.n_bound_syncs} steals={trace.n_steals} "
              f"remeshes={len(trace.remesh_events)}")


def _dryrun(cm, args):
    """The solver on the production mesh, shapes only: per-device bytes
    of a distributed chunk's arguments (8 lanes and 16 subproblems per
    device, the lane state and the pool sharded over every mesh axis;
    the bound, the done flag and the superstep count replicated, one
    pool cursor per device).  Returns the bytes."""
    import numpy as np

    from repro_torch import solver
    from repro_torch.core.api import _init_carry
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_production_mesh

    t0 = time.time()
    mesh = make_production_mesh(multi_pod=args.multi_pod)
    axes = tuple(mesh.axis_names)
    n_dev = int(np.prod(list(mesh.shape.values())))
    lanes, pool = 8, 16                          # per device
    opts = solver.SolveConfig.preset(_PRESETS[args.preset], device="cpu"
                                     ).search_options()
    carry = _init_carry(cm, lanes * n_dev, opts, heads=(n_dev,))
    pool_spec, (state_spec, _, _, _, heads_spec) = SH.dist_solve_specs(
        carry.st, pool * n_dev, mesh, {"lanes": axes, "pool": axes})

    def per_device(shape, dtype, spec):
        n = int(np.prod(SH.shard_shape(tuple(shape), spec, mesh)))
        return n * torch_bytes(dtype)

    state = sum(per_device(x.shape, x.dtype, sp)
                for x, sp in zip(carry.st, state_spec) if x is not None)
    pools = 2 * per_device((pool * n_dev, cm.n_vars), cm.tdtype, pool_spec)
    rest = (torch_bytes(cm.tdtype) + 1 + 4       # bound, done flag, count
            + per_device((n_dev,), torch.int32, heads_spec))
    total = state + pools + rest
    mesh_tag = "2x16x16" if args.multi_pod else "16x16"
    print(f"SOLVER dry-run OK on {mesh_tag} ({n_dev} devices): "
          f"trace={time.time() - t0:.1f}s args={total / 1e6:.3f}MB/dev "
          f"(lane state {state / 1e6:.3f}MB of {lanes} lanes, pool lb/ub "
          f"{pools / 1e6:.3f}MB of {pool} subproblems, bound, flags and "
          f"cursor {rest} B); per superstep 1 solver_bound_sync of 3 "
          f"reductions (min bound, AND done, OR has-solution); left out "
          f"(no XLA): compile time, temp bytes, HLO all-reduce ops")
    return total


def torch_bytes(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _profiler(device):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _profile_report(prof, wall_s, phase, top=8):
    """Device time by kernel over a traced phase, and the device's busy
    share of the phase's wall time (sum of device-side event times over
    the wall; host-side op rows are left out, so nothing counts twice)."""
    from torch.autograd import DeviceType
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type != DeviceType.CPU), reverse=True)
    busy_us = sum(r[0] for r in rows)
    print(f"profile {phase}: device busy {busy_us / 1e3:.1f} ms of "
          f"{wall_s * 1e3:.1f} ms wall "
          f"({100 * busy_us / 1e6 / max(wall_s, 1e-9):.1f}%), "
          f"{sum(r[1] for r in rows)} device ops")
    for us, n, key in rows[:top]:
        print(f"profile {phase}:   {us / 1e3:9.2f} ms {n:7d}x "
              f"{us / n:9.2f} us  {key[:70]}")


def _phase_report(tr, wall_s, phase):
    """A traced part's phases on the host clock (`core/trace.py`):
    seconds, count and mean per phase, and their sum against the wall."""
    print(f"profile {phase}: phases {tr.seconds():.3f} s of {wall_s:.3f} s "
          f"wall")
    for line in tr.table():
        print(f"profile {phase}:   {line}")


if __name__ == "__main__":
    main()
