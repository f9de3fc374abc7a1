"""The paper's experiment on the PyTorch port: solve an RCPSP suite with
the batched engine (one `Solver` session), cross-check every instance
against the sequential baseline on the host, and ground-verify every
solution (paper Table 1 workflow).

  PYTHONPATH=src python examples/torch_rcpsp_solve.py [--n 10] [--count 5]
  PYTHONPATH=src python examples/torch_rcpsp_solve.py --file path/to/file.rcp
  PYTHONPATH=src python examples/torch_rcpsp_solve.py --n 8 --device cpu

The engine runs on the GPU (``--backend cuda_resident`` by default: the
resident search kernel, K supersteps per launch) unless ``--device cpu``
is given; the baseline (`core/baseline.SequentialSolver`) always runs on
the host CPU.  Without a usable GPU and without ``--device cpu`` it
fails instead of moving to the CPU.
"""

import argparse

from repro_torch import solver
from repro_torch.core import baseline
from repro_torch.core.backend import available_backends
from repro_torch.core.models import rcpsp
from repro_torch.kernels.fixpoint_kernel import fixpoint_cuda, search_cuda


def solve_one(sess, inst, timeout, device):
    m, h = rcpsp.build_model(inst)
    cm = m.compile(device=device)
    launches = (fixpoint_cuda.launches, search_cuda.launches)
    par = sess.solve(cm)
    launches = (fixpoint_cuda.launches - launches[0],
                search_cuda.launches - launches[1])
    seq = baseline.SequentialSolver(cm, sess.config.search_options()) \
        .solve(timeout_s=timeout)
    line = (f"{inst.name:24s} turbo-torch: {par.status:8s} "
            f"mk={par.objective} nodes={par.n_nodes:7d} {par.wall_s:6.1f}s "
            f"launches={launches[0]}+{launches[1]} | seq: {seq.status:8s} "
            f"mk={seq.objective} nodes={seq.n_nodes:6d} {seq.wall_s:6.1f}s")
    if par.solution is not None:
        s_idx = [v.idx for v in h["s"]]
        ok, mk = rcpsp.check_solution(inst, par.solution[s_idx])
        good = ok and mk == par.objective
        line += f" | ground-check {'OK' if good else 'FAIL'}"
        assert good, "ground check failed"
    if par.objective is not None and seq.objective is not None:
        assert par.status != "OPTIMAL" or seq.status != "OPTIMAL" or \
            par.objective == seq.objective, "solvers disagree!"
    print(line)
    return par, seq


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=8, help="tasks per instance")
    ap.add_argument("--count", type=int, default=4)
    ap.add_argument("--resources", type=int, default=4)
    ap.add_argument("--lanes", type=int, default=16)
    ap.add_argument("--subs", type=int, default=64)
    ap.add_argument("--timeout", type=float, default=60)
    ap.add_argument("--file", default=None,
                    help="Patterson .rcp or PSPLIB .sm file")
    ap.add_argument("--backend", default="cuda_resident",
                    choices=available_backends(),
                    help="propagation backend (core/backend.py)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    sess = solver.Solver(solver.SolveConfig.preset(
        "prove", n_lanes=args.lanes, eps_target=args.subs,
        timeout_s=args.timeout, backend=args.backend, device=args.device))
    if args.file:
        inst = (rcpsp.parse_psplib_sm(args.file)
                if args.file.endswith(".sm")
                else rcpsp.parse_patterson(args.file))
        solve_one(sess, inst, args.timeout, args.device)
        return
    par_wall = seq_wall = 0.0
    for seed in range(args.count):
        inst = rcpsp.generate(args.n, n_resources=args.resources, seed=seed)
        par, seq = solve_one(sess, inst, args.timeout, args.device)
        par_wall += par.wall_s
        seq_wall += seq.wall_s
    print(f"suite: {args.count} instances, engine ({args.backend}, "
          f"{args.device}) {par_wall:.2f} s, baseline (host) "
          f"{seq_wall:.2f} s")


if __name__ == "__main__":
    main()
