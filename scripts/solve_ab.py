#!/usr/bin/env python3
"""Decompose and solve RCPSP instances from several checkouts of the
repository in turn on one GPU, to compare two versions of the solver's
EPS path on the same card:

    python3 scripts/solve_ab.py checkout/parent . . checkout/parent

Each root runs in a process of its own, which imports that root's
``src/repro_torch`` (and builds its kernels into its own ``build/``).
For J60, J120, J120 × 10⁷ (every duration scaled: an int64 model) and
N-queens 32 it traces `eps.decompose` to 4096 subproblems with
``torch.profiler`` and prints the device ms of one `fixpoint_cuda`
launch (the root's ``[1, V]`` and every batch of splits), its bound
and the traced EPS wall (``chip_smoke.time_eps_launches`` of the
repository this script is in); then it solves J60 and J120 through
``cuda_resident`` (1024 lanes, K = 16, preset ``prove``) and prints the
time to the proven optimum, the EPS share and the counters; then it
solves N-queens 32 through ``cuda_resident`` (first-fail and bisection,
as ``chip_smoke.py`` phase 10) to the proven optimum q0 = 0 in 338
supersteps, and replays every launch of that solve and times it on the
device (``chip_smoke.time_resident_solve``): the resident kernel's
largest term.  The card's name and power limit come first.  Host-bound
numbers (the EPS wall) vary from run to run, so give each root more
than once, in turns.
"""

import argparse
import dataclasses
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (tag, tasks, duration scale) of the RCPSP classes (rcpsp.generate, 4
# resources, seed 0) and the instances solved to the optimum
RCPSP = (("J60", 60, 1), ("J120", 120, 1), ("J120x1e7", 120, 10 ** 7))
SOLVED = ("J60", "J120")
# N-queens 32's resident solve: the supersteps every checkout must take
# to prove q0 = 0 (chip_smoke.py phase 10 since the zoo was ported)
NQ32_SUPERSTEPS = 338


def run(root):
    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
    import repro_torch      # this root's package, before chip_smoke's path
    sys.path.append(HERE)
    import chip_smoke as CS
    from repro_torch.core.models import nqueens, rcpsp
    from repro_torch.kernels.fixpoint_kernel import fixpoint_cuda
    if not hasattr(fixpoint_cuda, "few_lane_launches"):
        fixpoint_cuda.few_lane_launches = 0   # a checkout with one instance
    print(f"{root}: {os.path.dirname(repro_torch.__file__)}", flush=True)
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(CS.nvidia_smi("clocks.max.sm").split()[0])
    peak = sms * CS.INT32_LANES_PER_SM * mhz * 1e6
    card = CS.nvidia_smi("name,power.limit")
    cases = {}
    for tag, n, scale in RCPSP:
        inst = rcpsp.generate(n, n_resources=4, seed=CS.SEED)
        if scale > 1:
            inst = dataclasses.replace(inst, durations=inst.durations * scale)
        cases[tag] = CS.load("rcpsp", inst)
    cases["nqueens32"] = CS.load("nqueens", nqueens.generate(32,
                                                             seed=CS.SEED))
    for tag, c in cases.items():
        run = CS.time_eps_launches(card, peak, c.cm, root, tag,
                                   CS.ZOO_STRATEGY.get(tag))
        print(f"{root} {tag}: EPS launch {run.ms:.4f} ms on the device, "
              f"bound {run.bound_ms:.5f} ms, {run.launches} launches",
              flush=True)
    for tag in SOLVED:
        res, _ = CS.solve_case(root, tag, cases[tag],
                               CS.main_config("cuda_resident"))
        print(f"{root} {tag}: cuda_resident {res.status} {res.objective} "
              f"in {res.wall_s:.3f} s (EPS {res.eps_s:.3f} s), nodes "
              f"{res.n_nodes}, supersteps {res.n_supersteps}", flush=True)
    c = cases["nqueens32"]
    cfg = CS.main_config("cuda_resident", CS.ZOO_STRATEGY["nqueens32"],
                         max_supersteps=CS.ZOO_LONG_CAP)
    res, _ = CS.solve_case(root, "nqueens32", c, cfg,
                           CS.ZOO_OPTIMUM["nqueens32"])
    if res.n_supersteps != NQ32_SUPERSTEPS:
        CS.fail(f"{root} nqueens32: {res.n_supersteps} supersteps, not "
                f"{NQ32_SUPERSTEPS}")
    total, _ = CS.time_resident_solve(card, peak, "nqueens32", c, cfg, res,
                                      phase=root)
    print(f"{root} nqueens32: cuda_resident {res.status} {res.objective} "
          f"in {res.n_supersteps} supersteps, nodes {res.n_nodes}; "
          f"replayed launches {total:.2f} ms on the device", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+", help="repository checkouts, in turn")
    ap.add_argument("--one", action="store_true",
                    help="run the single root given, in this process")
    args = ap.parse_args()
    if args.one:
        run(args.roots[0])
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for root in args.roots:
        rc = subprocess.call([sys.executable, os.path.abspath(__file__),
                              "--one", root])
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
