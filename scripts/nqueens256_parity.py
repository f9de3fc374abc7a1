"""Solve N-queens 256 with the port and with the JAX package (both
``gather``, on the CPU: 8 lanes, eps_target 16, ``min_dom``/``split``,
``stop_on_first``) for N supersteps and compare status and every
counter (``tests/test_torch_nqueens256.py`` runs it at 32).

  PYTHONPATH=src python scripts/nqueens256_parity.py --supersteps 256
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--supersteps", type=int, default=256)
    args = ap.parse_args()
    from test_torch_nqueens256 import COUNTERS, compare
    t0 = time.time()
    ref, got = compare(args.supersteps)
    print(f"N-queens 256, {args.supersteps} supersteps: equal on "
          + ", ".join(f"{k}={getattr(got, k)}" for k in COUNTERS)
          + f" ({time.time() - t0:.1f} s for both)")


if __name__ == "__main__":
    main()
