"""Model zoo runner of the PyTorch port: solve every workload through
one `Solver` session and ground-check the solutions.

  PYTHONPATH=src python examples/torch_model_zoo.py              # all, GPU
  PYTHONPATH=src python examples/torch_model_zoo.py --model nqueens \\
      --backend cuda_resident --eps-target 32
  PYTHONPATH=src python examples/torch_model_zoo.py --model knapsack --many 4
  PYTHONPATH=src python examples/torch_model_zoo.py --device cpu

Without a usable GPU and without ``--device cpu`` it fails instead of
moving to the CPU.
"""

import argparse
import time

from repro_torch import solver
from repro_torch.core import models as zoo
from repro_torch.core.backend import available_backends


def _instance(name, seed, args):
    return (zoo.bench_instance(name, seed=seed) if args.bench
            else zoo.small_instance(name, seed=seed))


def solve_one(sess, name, args):
    mod = zoo.ZOO[name]
    inst = _instance(name, args.seed, args)
    m, h = mod.build_model(inst)
    cm = m.compile(device=args.device)
    t0 = time.time()
    res = sess.solve(cm)
    line = (f"{inst.name:24s} {res.status:8s} obj={res.objective} "
            f"nodes={res.n_nodes:6d} ({res.nodes_per_sec:7.0f}/s) "
            f"supersteps={res.n_supersteps:5d} {time.time() - t0:5.1f}s")
    checked = zoo.ground_check(mod, inst, h, res)
    if checked is not None:
        line += f" | ground-check {'OK' if checked else 'FAIL'}"
    print(line)
    assert checked is not False, f"{inst.name}: ground check failed"


def solve_many_demo(sess, name, count, args):
    """The throughput path: `count` same-shape instances of one model in
    one `LaneBatch` (under ``cuda_resident`` one launch per quantum)."""
    mod = zoo.ZOO[name]
    insts = [_instance(name, args.seed + k, args) for k in range(count)]
    built = [mod.build_model(i) for i in insts]
    cms = [m.compile(device=args.device) for m, _ in built]
    t0 = time.time()
    results = sess.solve_many(cms)
    wall = time.time() - t0
    for inst, (m, h), res in zip(insts, built, results):
        checked = zoo.ground_check(mod, inst, h, res)
        print(f"{inst.name:24s} {res.status:8s} obj={res.objective} "
              f"| ground-check {'OK' if checked else checked}")
        assert checked is not False, f"{inst.name}: ground check failed"
    print(f"solve_many: {count} instances in {wall:.1f}s "
          f"({count / max(wall, 1e-9):.1f} instances/s, one batch)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="all",
                    choices=["all"] + sorted(zoo.ZOO))
    ap.add_argument("--backend", default="cuda",
                    choices=available_backends())
    ap.add_argument("--lanes", type=int, default=16)
    ap.add_argument("--eps-target", type=int, default=64,
                    help="EPS pool size; 1 = single root")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=60)
    ap.add_argument("--bench", action="store_true",
                    help="larger benchmark-tier instances")
    ap.add_argument("--many", type=int, default=None, metavar="N",
                    help="solve N same-shape instances of --model in one "
                         "batch (solve_many; needs --model)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    sess = solver.Solver(solver.SolveConfig.preset(
        "prove", n_lanes=args.lanes, eps_target=args.eps_target,
        timeout_s=args.timeout, backend=args.backend, max_depth=512,
        device=args.device))
    if args.many:
        if args.model == "all":
            ap.error("--many needs a specific --model (same-shape batch)")
        solve_many_demo(sess, args.model, args.many, args)
        return
    names = sorted(zoo.ZOO) if args.model == "all" else [args.model]
    for name in names:
        solve_one(sess, name, args)


if __name__ == "__main__":
    main()
