"""Quickstart of the PyTorch port: model a problem in PCCP, solve it,
check the paper's determinism guarantee.

  PYTHONPATH=src python examples/torch_quickstart.py               # GPU
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu

On the GPU the ``cuda`` backends launch the Hopper fixpoint and search
kernels; with ``--device cpu`` their wrappers run the plain PyTorch
versions.  Without a usable GPU and without ``--device cpu`` it fails
instead of moving to the CPU.
"""

import argparse

import torch

from repro_torch import solver
from repro_torch.core.backend import available_backends, get_backend
from repro_torch.core.fixpoint import fixpoint, sequential_fixpoint
from repro_torch.core.model import Model


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    # -- a tiny scheduling model (paper §PCCP, in miniature) --------------
    m = Model("quickstart")
    # three jobs with durations 3, 4, 2 on one machine (disjunctive),
    # minimize the makespan
    d = [3, 4, 2]
    s = [m.int_var(0, 20, f"s{i}") for i in range(3)]
    mk = m.int_var(0, 30, "makespan")
    for i in range(3):
        m.add(s[i] + d[i] <= mk)
        for j in range(i + 1, 3):
            # i before j OR j before i (reified disjunction)
            bij = m.reify(s[i] + d[i] <= s[j], f"b{i}{j}")
            bji = m.reify(s[j] + d[j] <= s[i], f"b{j}{i}")
            m.add(bij + bji >= 1)
    m.minimize(mk)
    m.branch_on(s + [mk])
    cm = m.compile(device=args.device)

    # -- parallel == sequential fixpoint (Prop. 3) -------------------------
    lb_p, ub_p, it, _ = fixpoint(cm, cm.lb0, cm.ub0, stop_on_fail=False)
    lb_s, ub_s = sequential_fixpoint(cm, cm.lb0, cm.ub0)
    same = torch.equal(lb_p, lb_s) and torch.equal(ub_p, ub_s)
    print(f"parallel sweep fixpoint in {int(it)} sweeps; "
          f"== sequential chaotic iteration: {same}")
    assert same

    # -- every propagation backend computes the same fixpoint --------------
    lbs = cm.lb0[None].repeat(4, 1)
    ubs = cm.ub0[None].repeat(4, 1)
    stores = {name: get_backend(name).fixpoint_batch(cm, lbs, ubs)[:2]
              for name in available_backends()}
    ref = stores["gather"]
    agree = all(torch.equal(lb, ref[0]) and torch.equal(ub, ref[1])
                for lb, ub in stores.values())
    print(f"backends {available_backends()} agree on the batched "
          f"fixpoint: {agree}")
    assert agree

    # -- solve through the session API: a SolveConfig consolidates lanes,
    #    EPS, backend and strategy (eps_target=32 decomposes the root into
    #    ~32 subproblems that seed and replenish the 8 lanes) ------------
    sess = solver.Solver(solver.SolveConfig(n_lanes=8, eps_target=32,
                                            device=args.device))
    res = sess.solve(cm)
    print(f"status={res.status} makespan={res.objective} "
          f"nodes={res.n_nodes} ({res.nodes_per_sec:.0f} nodes/s)")
    starts = [int(res.solution[v.idx]) for v in s]
    print("starts:", starts)
    assert res.objective == sum(d)       # one machine => serial schedule

    # -- a second solve of the same model.  The reference asserts here that
    #    its session compiled one runner for both solves; the port compiles
    #    no runner (its kernels are built once per process, on first
    #    launch), so this checks the objective and prints both walls ----
    res2 = sess.solve(cm)
    print(f"second solve: {res2.wall_s * 1e3:.0f} ms (first "
          f"{res.wall_s * 1e3:.0f} ms)")
    assert res2.objective == res.objective


if __name__ == "__main__":
    main()
