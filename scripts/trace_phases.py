#!/usr/bin/env python3
"""The card's idle time split by the solver's own phases
(``src/repro_torch/core/trace.py``), one benchmark run at a time on this
machine's card:

    python3 scripts/trace_phases.py --workload j60-deadline \\
        --seed 2147483707 --seed 2147483713 --seconds 51

Each run is ``perfbench/run.py``'s (`harness.run_cell`), traced unless
``--trace 0``, and prints one JSON line: the per-layer metrics (the
end-to-end ones untraced) and ``correct``, each phase's count and
seconds and each count of work (``eps.splits``, ``eps.spec``) summed
over the window's solves, the least share of a solve's
``wall_s`` that its phases cover, each solve's ``eps_s``; traced, also
the clock of ``perfbench/spans.py`` (its segments, the launches matched,
the launches that bounded nothing, the share of the others in segments
no wider than 100 µs, the widest and the launch-weighted median width,
``T0`` less the window's ``t0``: where the profiler's zero lies against
the harness's assumption; with no clock, the launches stamped and
traced per kernel) and the card's idle seconds in the window by phase
(key ``None``: what no phase covers).
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "perfbench"), str(ROOT / "src")]


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()


def one_run(spec, seed, seconds, trace, log):
    """One run of the cell through `harness.run_cell`, the `Run` its
    metric readers get kept aside."""
    import harness
    import spans
    kept = []
    load_metric = harness.load_metric

    def keeping(name):
        mod = load_metric(name)

        def read(run):
            if not kept:
                kept.append(run)
            return mod.read(run)
        return type("Reader", (), {"read": staticmethod(read)})
    harness.load_metric = keeping
    try:
        out = harness.run_cell(spec, seed, seconds, trace, device="cuda",
                               t_process=time.perf_counter(), log=log)
    finally:
        harness.load_metric = load_metric
    line = dict(seed=seed, trace=trace, correct=out["correct"],
                metrics={k: v["value"] for k, v in out["metrics"].items()},
                device=out["device"])
    if not kept:
        return line
    run = kept[0]
    phases, tallies, cover = {}, {}, []
    for sv in run.solves:
        tr = spans.trace_of(sv)
        if tr is None:
            continue
        for k, (n, s) in tr.phases.items():
            c, t = phases.get(k, (0, 0.0))
            phases[k] = (c + n, t + s)
        for k, n in getattr(tr, "tallies", {}).items():
            tallies[k] = tallies.get(k, 0) + n
        cover.append(tr.seconds() / sv.result.wall_s)
    line.update(phases=phases, tallies=tallies,
                least_cover=min(cover) if cover else None,
                eps_s=[sv.result.eps_s for sv in run.solves
                       if sv.result is not None])
    if not trace:
        return line
    idle = spans.idle_by_phase(run)
    line.update(clock=clock_summary(run, spans.clock(run)),
                idle_s=None if idle is None else
                {str(k): v for k, v in idle.items()})
    return line


def clock_summary(run, ck):
    """`spans.clock`'s segments, launches, launches that bounded
    nothing, share of the launches in segments no wider than 100 µs,
    widest and launch-weighted median width (µs), and ``T0`` less the
    window's ``t0`` (µs: the first segment's, the least, the most); with
    no clock, the launches stamped and the operations traced per
    kernel."""
    import spans
    if ck is None:
        out = {}
        for sv in run.solves:
            tr = spans.trace_of(sv)
            if tr is None or tr.spans is None:
                continue
            for kernel, st in (spans.launch_stamps(tr) or {}).items():
                out.setdefault(kernel, dict(
                    stamped=0, traced=len(spans.kernel_ops(run, kernel))))
                out[kernel]["stamped"] += len(st)
        return out
    seen, median = 0, None
    for w, n in sorted(zip(ck.widths, ck.sizes)):
        seen += n
        if seen >= ck.n_launches / 2:
            median = w
            break
    off = [1e6 * (t - run.t0) for t in ck.t0s]
    return dict(segments=len(ck.t0s), launches=ck.n_launches,
                skipped=ck.skipped,
                share_within_100us=ck.share_within(100e-6),
                width_max_us=1e6 * ck.width_s, width_median_us=1e6 * median,
                t0_less_window_us=[off[0], min(off), max(off)])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", default=[])
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    import harness
    spec = harness.cell_spec(args.workload)
    print(json.dumps(dict(card=card(), workload=args.workload)), flush=True)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    for seed in args.seed:
        print(json.dumps(one_run(spec, seed, args.seconds, bool(args.trace),
                                 log)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
