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
PyTorch sweep.  ``--branch-value`` picks the value
branching: ``min`` (x ≤ lb), ``split`` (bisect at the midpoint) or
``middle_out`` (x = m | x ≠ m on the remaining value nearest the
midpoint; search then carries the bitset store).  ``--device cpu``
runs everything on the CPU (where the ``cuda`` backend's wrapper takes
the plain version).  Without a GPU and without ``--device cpu`` the
command fails instead of moving to the CPU.  ``--file`` reads a PSPLIB
``.sm`` or Patterson ``.rcp`` instance instead of generating one.
``--profile`` traces the EPS decomposition and the search apart with
``torch.profiler`` and prints, for each, the device time by kernel and
the device's busy share of its wall time.
"""

import argparse
import contextlib
import time

# CLI name -> SolveConfig preset name
_PRESETS = {"prove": "prove", "first": "first_solution", "fast": "fast"}


def main(argv=None):
    from repro_torch.core.backend import available_backends

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=10, help="RCPSP tasks")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resources", type=int, default=4)
    ap.add_argument("--lanes", type=int, default=32)
    ap.add_argument("--eps-target", type=int, default=None,
                    help="EPS pool size: decompose the root into ~this many "
                         "subproblems (default 4 × lanes)")
    ap.add_argument("--timeout", type=float, default=120)
    ap.add_argument("--preset", choices=sorted(_PRESETS), default="prove")
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
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--file", default=None)
    ap.add_argument("--profile", action="store_true",
                    help="trace the solve; print device time by kernel")
    args = ap.parse_args(argv)
    if args.lane_tile is not None and args.backend != "cuda_resident":
        ap.error(f"--lane-tile needs --backend cuda_resident, not "
                 f"{args.backend}: the fixpoint kernel has no lane tile "
                 "(a CTA runs one lane), and the reference's pallas lane "
                 "tile changes no result")

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
    cm = m.compile(device=args.device)
    value = ({} if args.branch_value is None
             else dict(val_strategy=args.branch_value))
    cfg = solver.SolveConfig.preset(
        _PRESETS[args.preset], n_lanes=args.lanes,
        eps_target=args.eps_target, timeout_s=args.timeout,
        backend=args.backend, device=args.device,
        supersteps_per_launch=args.supersteps_per_launch,
        lane_tile=args.lane_tile, **value)

    launches0 = fixpoint_cuda.launches
    search0 = search_cuda.launches
    subs = None
    t_eps = 0.0             # EPS time outside the solve (under --profile)
    if args.profile:
        # EPS traced apart from the search, so each gets its own breakdown
        from repro_torch.core import eps
        with _profiler(args.device) as prof:
            t_eps = time.time()
            subs = eps.decompose(cm, cfg.resolved_eps_target(),
                                 cfg.search_options())
            t_eps = time.time() - t_eps
        _profile_report(prof, t_eps, "eps")
    res = None
    with (_profiler(args.device) if args.profile
          else contextlib.nullcontext()) as prof:
        for ev in solver.Solver(cfg).solve_iter(cm, subs=subs):
            if ev.final:
                res = ev.result
            elif ev.best_objective is not None and ev.incumbent is not None:
                print(f"  [{ev.wall_s:6.1f}s] superstep={ev.superstep:6d} "
                      f"incumbent={ev.best_objective} nodes={ev.n_nodes}")
    if prof is not None:
        _profile_report(prof, res.wall_s, "search")
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


if __name__ == "__main__":
    main()
