"""Solver as a service: the continuous-batching scheduler under a seeded
open-loop load — port of ``repro/launch/serve_solver.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve_solver \\
      --requests 16 --rate 8 --lanes 1024 --eps-target 4096 --parity
  PYTHONPATH=src python -m repro_torch.launch.serve_solver --device cpu \\
      --backend gather --requests 6 --lanes 4 --eps-target 8 --parity

Draws a Poisson arrival trace over the default zoo mix (two seed-stable
shape buckets), drives a `SolverScheduler` on the host clock, and prints
the latency/occupancy summary and the buckets (with the kernel libraries
each bucket's batch had built, where the reference counts compiles).
With ``--parity`` every completed result is also checked against a
sequential `Solver.solve` (deadline evictions excepted).

The reference's flags, plus ``--device`` (``cuda`` unless asked; without
a GPU the command fails instead of moving to the CPU).  The default
``--backend`` is ``cuda_resident``, whose quantum is ONE launch of the
resident search kernel over every slot of a bucket; the reference's
default, ``gather``, is its plain path (``--backend gather`` here too).
Every other default is the reference's.

This serves the constraint solver; the language-model serving demo is
`repro_torch.launch.serve`.
"""

from __future__ import annotations

import argparse
import json


def build_config(args):
    from repro_torch.core.api import SolveConfig
    return SolveConfig.preset(
        args.preset, backend=args.backend, n_lanes=args.lanes,
        eps_target=args.eps_target, chunk=args.chunk,
        max_depth=args.max_depth, device=args.device)


def main(argv=None):
    from repro_torch.core.backend import available_backends

    ap = argparse.ArgumentParser(
        description="Serve the solver under open-loop Poisson load")
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--rate", type=float, default=50.0,
                    help="arrival rate (requests/s)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-batch", type=int, default=4,
                    help="lane-batch slots per bucket")
    ap.add_argument("--preset", default="prove")
    ap.add_argument("--backend", default="cuda_resident",
                    choices=available_backends())
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--eps-target", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--max-depth", type=int, default=256)
    ap.add_argument("--max-wall-s", type=float, default=600.0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--parity", action="store_true",
                    help="check results against sequential Solver.solve")
    ap.add_argument("--json", default=None,
                    help="also dump the metrics summary to this file")
    args = ap.parse_args(argv)

    from repro_torch.serve.loadgen import (poisson_trace, run_open_loop,
                                           sequential_reference)
    from repro_torch.serve.scheduler import SolverScheduler

    cfg = build_config(args)
    trace = poisson_trace(args.requests, args.rate, seed=args.seed)
    sched = SolverScheduler(cfg, max_batch=args.max_batch)
    handles = run_open_loop(sched, trace, max_wall_s=args.max_wall_s)

    summary = sched.recorder.summary()
    print(json.dumps(summary, indent=2, default=str))
    print("buckets:", json.dumps(sched.buckets(), indent=2))

    if args.parity:
        ref = sequential_reference(trace, build_config(args))
        n_bad = 0
        for _, h in handles:
            res = h.result()
            want = ref[h.request.request_id]
            got = (res.status, res.objective)
            if res.complete and got != want:
                n_bad += 1
                print(f"PARITY MISMATCH {h.request.request_id}: "
                      f"served={got} sequential={want}")
        print(f"parity: {'OK' if n_bad == 0 else f'{n_bad} MISMATCHES'} "
              f"over {len(handles)} requests")
        if n_bad:
            raise SystemExit(1)

    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(summary=summary, buckets=sched.buckets()), f,
                      indent=2, default=str)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
