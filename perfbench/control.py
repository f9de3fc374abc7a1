"""The control of the comparison: a run of a cell with the program's own
lower-precision path switched on (``max_fixpoint_iters=4``, the ``fast``
preset's truncated fixpoint), which ``correct`` has to reject.

    python3 perfbench/control.py --workload <name> --seed <n> \
        --seconds <s> [--iters 4]

Prints the run's result line (the numbers compared are in ``checks``);
exits 0 when the comparison rejected the control, 1 when it passed it.
The benchmark's own runs never run this.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--iters", type=int, default=4)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(HERE.parent / "src")]
    import harness
    spec = copy.deepcopy(harness.cell_spec(args.workload))
    spec["traffic"]["max_fixpoint_iters"] = args.iters

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    out = harness.run_cell(spec, args.seed, args.seconds, False,
                           device="cuda", t_process=T_PROCESS, log=log)
    print(json.dumps(out), flush=True)
    return 0 if not out["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
