"""The port's solver as a planning engine: partition 8 superlayers into 4
pipeline stages under a memory cap, then schedule microbatch rounds as an
RCPSP (the port of ``examples/planner_demo.py``).

  PYTHONPATH=src python examples/torch_planner_demo.py               # GPU
  PYTHONPATH=src python examples/torch_planner_demo.py --device cpu

Both solves go through `repro_torch.distributed.planner`; on the GPU the
``cuda`` backend launches the Hopper fixpoint kernel, with ``--device
cpu`` its wrapper runs the plain PyTorch version.  Without a usable GPU
and without ``--device cpu`` it fails instead of moving to the CPU.
``--timeout`` bounds each solve (120 s, the reference's): on the CPU the
microbatch schedule of 16 tasks does not prove its optimum within it,
and the demo prints its best schedule (SAT).
"""

import argparse

from repro_torch.distributed import planner


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="seconds per solve")
    args = ap.parse_args(argv)

    # per-layer cost proxy (uniform here); the first and the last layer
    # are heavier (embedding and unembedding co-located)
    L = 8                                # plan at 8-superlayer granularity
    costs = [10] * L
    costs[0] += 6                        # embed
    costs[-1] += 9                       # unembed + loss
    mems = [4] * L
    mems[0] += 2
    mems[-1] += 3

    stages, T = planner.plan_partition(costs, mems, n_stages=4, mem_cap=12,
                                       timeout_s=args.timeout,
                                       device=args.device)
    print(f"layer→stage: {stages}   bottleneck cost: {T}")
    for k in range(4):
        members = [i for i, s in enumerate(stages) if s == k]
        print(f"  stage {k}: layers {members} "
              f"cost={sum(costs[i] for i in members)} "
              f"mem={sum(mems[i] for i in members)}")

    stage_costs = [sum(costs[i] for i, s in enumerate(stages) if s == k)
                   for k in range(4)]
    starts, mk, res = planner.schedule_microbatches(
        stage_costs, 4, timeout_s=args.timeout, device=args.device)
    eff = planner.pipeline_efficiency(stage_costs, mk, 4)
    print(f"\nmicrobatch schedule ({res.status}): makespan={mk} "
          f"efficiency={eff:.2%}")
    horizon = mk
    for mb, row in enumerate(starts):
        lane = [" "] * horizon
        for st, t in enumerate(row):
            for u in range(stage_costs[st]):
                lane[t + u] = str(st)
        print(f"  mb{mb}: {''.join(lane)}")


if __name__ == "__main__":
    main()
