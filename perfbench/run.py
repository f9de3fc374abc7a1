"""The benchmark's one command: one run of one cell on this machine's
card.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Prints, as the last line of standard
output, one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared with its limit, which also close
standard error).  Exits non-zero, printing no result, without a CUDA
card, without the program beside it, or when the process has loaded
JAX, jaxlib, flax or the JAX package.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list:
    """The top-level names among `names` (by default the loaded modules)
    that are, compared whole, one of `FORBIDDEN`: ``repro_torch`` is not
    ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(ROOT / "src")]

    import harness
    spec = harness.cell_spec(args.workload)
    import torch
    need = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"perfbench: the cell needs {need} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    out = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace),
                           device="cuda", t_process=T_PROCESS, log=log)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the process loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
