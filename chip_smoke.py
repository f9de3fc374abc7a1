#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # from the repository root

Phases, in order; any error or mismatch ends the run with a non-zero
exit code and no result line:

1. card and build: the card line of ``nvidia-smi``, torch and CUDA
   versions; ``nvcc`` builds ``kernels/csrc/fixpoint.cu`` and
   ``kernels/csrc/search.cu`` for sm_90a, each at int32 and int64 and
   ``search.cu`` also in its lane-tiled mode, all six at once, and their
   ``-Xptxas -v`` reports (registers, shared memory) are printed;
2. kernel against plain version: ``fixpoint_cuda`` against the plain
   PyTorch ``fixpoint_batch``, on the card, on RCPSP J30- and J60-class
   models, for 1024 random stores (random tells on the root box, from a
   numpy seed) and the EPS pool, at ``max_sweeps`` 1, 4 and uncapped:
   failed masks, non-failed stores, per-lane sweeps and convergence
   flags must be equal;
3. main path: a J60-class instance solved end to end through
   ``Solver(SolveConfig.preset("prove", backend="cuda", n_lanes=1024,
   eps_target=4096))``, with the launch counters set to 0 just before
   and read just after; the solution is ground-checked and the optimum
   held against the JAX package's; a J30-class instance solved with
   ``backend="cuda"`` and ``backend="gather"`` on the card must give
   identical results, equal to the JAX package's;
4. times: the kernel and its plain version per launch (CUDA events) at
   the main path's shape ``[1024, 62]``, on phase 2's J60 random stores,
   beside the least time the card could take for that work;
5. resident kernel against plain version: ``search_cuda`` against
   ``search_plain`` on the card, on J30 (256 lanes) and J60 (1024 lanes)
   class models with phase 2's EPS pools, from fresh lanes, from the
   state after 5 plain supersteps (decision paths) and from the states 8
   supersteps before and after the first solution (incumbents, bound
   tells, ``stop_on_first`` tripping mid-launch and a stopped state),
   under the ``prove``, ``fast`` and ``first_solution`` presets, at K =
   1, 4 and 16 supersteps per launch: every LaneState field, the bound,
   the superstep count, the pool cursor and the stop flag must be
   equal;
6. resident main path: the J60-class instance solved end to end through
   ``Solver(SolveConfig.preset("prove", backend="cuda_resident",
   supersteps_per_launch=16, n_lanes=1024, eps_target=4096))``, with the
   launch counters set to 0 just before and read just after; status,
   objective and every counter must equal phase 3's ``cuda`` solve, and
   the solution is ground-checked;
7. times: ``search_cuda`` and ``search_plain`` per launch (CUDA events)
   at the main path's shape (1024 lanes, K=16, from phase 5's J60 state
   after 5 supersteps), beside the least time the card could take;
8. the dense AllDifferent bank, kernel against plain version: phase 2's
   comparison on N-queens 32, graph coloring 64
   (``large_instance("coloring")``) and N-queens 8, 1024 random stores
   each (the first 256 made overfull, which must fail by pigeonhole)
   and the EPS pools of the first two;
9. the same bank in the resident kernel: phase 5's comparison on
   N-queens 32 and coloring 64 (1024 lanes, their EPS pools of 4096)
   under ``prove``, ``fast`` and ``min_dom``/``split``, from fresh lanes
   and after 5 supersteps;
10. the main path on the zoo: N-queens 32 and coloring 64 solved through
   ``Solver.solve`` (1024 lanes, eps_target 4096, each instance with its
   strategy pair ``ZOO_STRATEGY``), with ``cuda`` and ``cuda_resident``
   (K=16) under a cap of 2048 supersteps (status, objective and every
   counter equal), then with ``cuda_resident`` under 100,000 supersteps,
   which must prove the optimum (N-queens q0 = 0, coloring cmax = 4);
   the launch counters are set to 0 just before each solve and read just
   after, and every solution is ground-checked;
11. the zoo's smoke tier (rcpsp, nqueens, coloring, knapsack, jobshop,
   ``small_instance(seed=0)``) through ``gather``, ``cuda`` and
   ``cuda_resident``: equal results and counters, equal to the JAX
   package's, ground-checked;
12. times of both kernels at the N-queens-32 shapes (``[1024, 33]``
   stores of phase 8; 1024 lanes, K=16, ``min_dom``/``split``, after 5
   supersteps), beside their plain versions and bounds; then every
   launch of phase 10's long N-queens-32 ``cuda_resident`` solve,
   replayed from the same options and pool and timed one by one (its
   supersteps and nodes must equal the solve's);
13. the sparse banks, kernel against plain version: phase 2's comparison
   on the J90 and J120 classes, jobshop 20 x 15 (sparse Cumulative),
   N-queens 64 and N-queens 256 (sparse AllDifferent; the first 256
   random stores overfull), 1024 random stores each and the EPS pools;
   then a J30-class instance compiled ``bank_layout="sparse"`` against
   its dense compile, both through ``fixpoint_cuda``: equal failed
   masks, non-failed stores, sweeps and convergence flags;
14. the sparse banks in the resident kernel: phase 5's comparison on the
   J120 class (``prove``) and N-queens 64 (``min_dom``/``split``) at K =
   1, 4 and 16, and on N-queens 256 at K = 4, 1024 lanes each, from
   fresh lanes and after 5 supersteps, and on J120 also 8 supersteps
   before and after its first solution;
15. the main path on the sparse banks (1024 lanes, eps_target 4096, the
   launch counters read around each solve, every solution
   ground-checked): the J120 and J90 classes and rcpsp-96
   (``large_instance("rcpsp")``) through ``cuda`` and ``cuda_resident``
   (K=16), which must prove the JAX package's optima 157, 88 and 55 with
   equal counters; N-queens 256 (``min_dom``/``split``) through both
   under 256 supersteps (equal counters), then ``cuda_resident`` under
   100,000 supersteps or a 10 s timeout, whichever comes first;
16. times of both kernels at the J120 (``[1024, 122]``) and N-queens-256
   (``[1024, 257]``) shapes of phases 13 and 14, beside their plain
   versions, their bounds and the sparse banks' own work (sort compares
   and scan steps);
17. the Compact-Table bank and the bitset store, kernel against plain
   version: phase 2's comparison on crossword and configuration at the
   small, bench and large tiers and a model whose tables hold more than
   32 tuples (two support words), in both modes — a carried bitset store
   (1024 random stores with 1024 random bitset stores, the first 256 of
   which wipe out a table's interior, and the EPS pool's range words)
   and the transient one (no store) — at ``max_sweeps`` 1, 4 and
   uncapped: failed masks, non-failed stores and words, sweeps and
   convergence flags must be equal;
18. the resident kernel with the bitset store: phase 5's comparison on
   crossword large and configuration large under ``prove`` and
   ``min_lb``/``middle_out``, fed their EPS pool (2 subproblems, as the
   main path) and a pool of phase 17's 1024 random stores (every lane
   searches; the second start is after 2 supersteps, as the search ends
   within 4; the compared states must hold failed nodes and lanes in a
   right branch, so backtracking through ``root_dom`` is checked), and
   on N-queens 32 and coloring 64 under ``min_dom``/``middle_out``, at K
   = 1, 4 and 16, 1024 lanes, from fresh lanes and after 5 supersteps:
   every LaneState field, ``dom`` and ``root_dom`` included, must be
   equal;
19. the main path on the table models and ``middle_out`` (the launch
   counters read around each solve, every solution ground-checked):
   crossword large and configuration large through ``cuda`` and
   ``cuda_resident`` (1024 lanes, eps_target 4096), which must prove the
   JAX package's optima 22 and 107 with equal counters; N-queens 32 under
   ``min_dom``/``middle_out`` through both under 2048 supersteps (equal
   counters); the J30 class under ``middle_out`` through both, whose
   counters must equal its ``split`` solve's (no start is tracked);
20. times of both kernels at the shapes of phases 17 and 18
   (``[1024, 50]`` configuration large and ``[1024, 65]`` crossword
   large, with and without a carried store; K=16 on both, from fresh
   lanes on the EPS pool and on the random pool, and
   on N-queens 32 under ``min_dom``/``middle_out``), beside their plain
   versions and bounds; the Compact-Table work of a bound is counted from
   the member values of the stores each sweep reads.

21. int64 models, ``fixpoint_cuda`` against its plain version (the int64
   library): the J120 class with every duration × 10⁷ (V=122, sparse
   Cumulative), the J60 class compiled ``force_dtype="int64"`` in the
   dense layout and a two-term row whose products pass 2³¹, 1024 random
   stores each and the first 1024 subproblems of the EPS pools, at
   ``max_sweeps`` 1, 4 and uncapped;
22. int64 in the resident kernel: phase 5's comparison on J120 × 10⁷ and
   J60 int64 (1024 lanes, ``prove``, K = 1, 4, 16), from fresh lanes and
   after 5 supersteps, and on J120 × 10⁷ 8 before and after the first
   solution (the compared states must hold failed nodes and backtracks);
23. the int64 main path (launch counters read around each solve,
   solutions ground-checked): J120 × 10⁷ through ``cuda`` and
   ``cuda_resident`` with equal counters, proving 157 × 10⁷; J60 int64
   through both, every counter equal to phase 3's int32 J60 solve;
24. lane tiles: phase 5's comparison in lane tiles of 256 (4 tiles) and
   384 (3, the last one short) on J60 (``prove``, in tiles of 256 also
   around its first solution) and N-queens 32 (``min_dom``/``split``),
   and of 256 on J60 int64, 1024 lanes, K = 1 and 16, from fresh lanes
   and after 5 supersteps (every field, the per-tile cursors included);
   then J60 through ``cuda_resident`` in tiles of 256, which must prove
   82 with a launch per K supersteps (its nodes and supersteps printed
   beside phase 6's one-queue solve), and J30 at 16 lanes in tiles of 4,
   whose counters must equal the plain version's on the CPU and differ
   from one queue's;
25. times: both kernels at int64 (J120 × 10⁷) against int32 (J120) at
   ``[1024, 122]``, and ``search_cuda`` at J60 in tiles of 256 against
   one queue, beside their plain versions and bounds (int64 bytes
   counted at 8, int64 operations against the int32 peak).

The last lines are the card line, a ``{"kernels": [...]}`` JSON line and
``{"ok": true, "device": {...}}``.  Without a usable GPU, or without the
repository around it, the script fails before it prints any result.
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import time
from collections import namedtuple

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SEED = 0
N_RANDOM = 1024            # random stores per model in phases 2 and 8
CAPS = (1, 4, None)        # max_sweeps of phases 2 and 8 (None: uncapped)
MAIN_LANES = 1024
MAIN_EPS = 4096
MAIN_TIMEOUT_S = 600.0
# Proven optima of the generated instances, from the JAX package
# (``repro.solver``, backend="gather", preset "prove", on the CPU).
J60_OPTIMUM = 82           # rcpsp.generate(60, n_resources=4, seed=0)
# phase 15, the sparse Cumulative layout: rcpsp.generate(n,
# n_resources=4, seed=0) for n = 90 and 120, and large_instance("rcpsp")
SPARSE_OPTIMUM = {"J90": 88, "J120": 157, "rcpsp96": 55}
# phase 19: the proven optima of the zoo's large table instances
# (large_instance(name, seed=0)), from the JAX package (backend="gather",
# preset "prove", 64 lanes, eps_target 64, on the CPU)
TABLE_OPTIMUM = {"crossword": 22, "configuration": 107}
# of phase 17's random bitset stores, those that wipe out the interior of
# one table row (all of its members' interior values cleared)
N_WIPE = 256
# the variants of phase 18: (name, preset, (var, val) pair or None)
TABLE_VARIANTS = (("prove", "prove", None),
                  ("min_lb/middle_out", "prove", ("min_lb", "middle_out")))
MIDDLE_OUT = ("min_dom", "middle_out")
# phase 15's N-queens 256 strategy pair (first-fail, bisection), the
# superstep cap of its cuda vs cuda_resident solves and the timeout of its
# long solve: no pair of four tried on the card found a solution within
# 20 s, and 2048 supersteps took 92 s and 161 s (PERF.md section 6); 10 s
# leaves room for phases 21-25 (the long solve found none in 30 s either)
NQ256_STRATEGY = ("min_dom", "split")
NQ256_CAP = 256
NQ256_LONG_TIMEOUT_S = 10.0
# rcpsp.generate(30, n_resources=4, seed=0), preset "prove", 32 lanes,
# default eps_target: the JAX package's SolveResult counters.
J30_LANES = 32
J30_REFERENCE = dict(status="OPTIMAL", objective=34, n_nodes=2038,
                     n_fails=1078, n_sols=5, n_sweeps=960,
                     n_supersteps=65)

# H100 SXM HBM rate (NVIDIA data sheet).  The int32 peak is not in the
# data sheet: it is the card's SM count x 64 INT32 lanes per SM (NVIDIA
# Hopper architecture whitepaper) x its maximum SM clock, one operation
# per lane per clock (phase 1 reads both from the card).
PEAK_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64
# every library the run launches, built at once in phase 1: both
# sources at int32 and int64, and search.cu's lane-tiled mode at both
BUILDS = (("fixpoint", ""), ("fixpoint", "i64"), ("search", ""),
          ("search", "i64"), ("search", "tiles"), ("search", "tiles_i64"))
# phases 21-25: every duration of an RCPSP class × INT64_SCALE compiles to
# int64 (sums pass the int32 headroom); scaling every duration scales the
# optimum, so J120 × 10⁷ must prove SPARSE_OPTIMUM["J120"] × 10⁷
INT64_SCALE = 10 ** 7
# phase 24's lane tiles on 1024 lanes: 4 tiles, and 3 with a short last
# one; the lane-tiled main path runs MAIN_TILE
TILES = (256, 384)
MAIN_TILE = 256
# (lanes, eps_target, lane tile) of phase 24's small tiled J30 solve, whose
# counters the tiles change (16 lanes: one queue 1680 nodes, tiles of 4
# 1654 in the plain version on the CPU)
J30_TILED = (16, 64, 4)
FIXPOINT_SOURCE = "src/repro_torch/kernels/csrc/fixpoint.cu"
FIXPOINT_REPLACES = "src/repro/kernels/fixpoint_kernel.py:285"
SEARCH_SOURCE = "src/repro_torch/kernels/csrc/search.cu"
SEARCH_REPLACES = "src/repro/kernels/fixpoint_kernel.py:520"
# the propagator banks both kernels cover (csrc/fixpoint_lane.cuh)
BANKS = ("ReifLinLe", "AllDifferent dense", "AllDifferent sparse",
         "Cumulative dense", "Cumulative sparse", "Compact-Table",
         "bitset store")
# phases 5-7 and 9: the resident search kernel
SEARCH_K = (1, 4, 16)
WARM_STEPS = 5             # plain supersteps before the second start
# phase 18's random pools: the large table models' searches from their
# 1024 random stores end within 4 supersteps (PR 16 chip run), so the
# second start is after 2, while lanes are mid-search
RANDOM_WARM = 2
FIRST_SOL_MAX = 512        # cap on the search for the first solution
MAIN_K = 16                # supersteps per launch on the main path
COUNTERS = ("status", "objective", "n_nodes", "n_fails", "n_sols",
            "n_sweeps", "n_supersteps")
# the variants phases 5 and 9 run: (name, preset, (var, val) strategy
# pair or None for the preset's own)
RCPSP_VARIANTS = tuple((p, p, None)
                       for p in ("prove", "fast", "first_solution"))
ZOO_VARIANTS = (("prove", "prove", None), ("fast", "fast", None),
                ("min_dom/split", "prove", ("min_dom", "split")))
# the bound's AllDifferent work per (upper endpoint, member) of a sorted
# Hall pass: a compare and an add for the count, a subtract and a compare
# for the width test, a compare and a max or min on each push side
ALLDIFF_OPS = 8
# the endpoint-pair algorithm of the kernel, per (endpoint pair, member):
# two compares, an AND and an add
PAIR_OPS = 4
N_PIGEONHOLE = 256         # of phase 8's 1024 random stores, made overfull
ZOO_CAP = 2048             # superstep cap of the cuda vs cuda_resident solves
ZOO_LONG_CAP = 100_000     # superstep cap of the long cuda_resident solves
# the strategy pair of each zoo main-path instance: first-fail (min_dom)
# on both; bisection for N-queens, smallest colour first for coloring
# (PERF.md section 4 has the trial on the card that chose them)
ZOO_STRATEGY = {"nqueens32": ("min_dom", "split"),
                "coloring64": ("min_dom", "min")}
# the optima the long solves prove on the card: N-queens' objective is
# q0 >= 0, and 0 is reached; coloring 64 needs five colours (cmax 4)
ZOO_OPTIMUM = {"nqueens32": 0, "coloring64": 4}
ZOO_SMOKE = ("rcpsp", "nqueens", "coloring", "knapsack", "jobshop",
             "crossword", "configuration")
ZOO_SMOKE_LANES = 16
ZOO_BACKENDS = ("gather", "cuda", "cuda_resident")
# small_instance(name, seed=0), preset "prove", 16 lanes, default
# eps_target: the JAX package's SolveResult (backend="gather", CPU)
ZOO_SMOKE_REFERENCE = {
    "rcpsp": dict(status="OPTIMAL", objective=13, n_nodes=200, n_fails=120,
                  n_sols=12, n_sweeps=90, n_supersteps=14),
    "nqueens": dict(status="OPTIMAL", objective=0, n_nodes=16, n_fails=6,
                    n_sols=10, n_sweeps=20, n_supersteps=2),
    "coloring": dict(status="OPTIMAL", objective=1, n_nodes=124, n_fails=92,
                     n_sols=2, n_sweeps=32, n_supersteps=9),
    "knapsack": dict(status="OPTIMAL", objective=-25, n_nodes=64,
                     n_fails=48, n_sols=16, n_sweeps=16, n_supersteps=5),
    "jobshop": dict(status="OPTIMAL", objective=6, n_nodes=64, n_fails=48,
                    n_sols=16, n_sweeps=16, n_supersteps=5),
    "crossword": dict(status="OPTIMAL", objective=22, n_nodes=2, n_fails=0,
                      n_sols=2, n_sweeps=18, n_supersteps=2),
    "configuration": dict(status="OPTIMAL", objective=18, n_nodes=8,
                          n_fails=3, n_sols=5, n_sweeps=18, n_supersteps=2),
}

# One model of the run: the zoo module, instance and handles (for the
# ground check), the compiled model on the card, its random stores, its
# EPS pool and, for a table model, its random bitset stores (None where
# no phase needs them).
Case = namedtuple("Case", "mod inst handles cm lbs ubs pool doms",
                  defaults=(None,))


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi(query):
    """First line of ``nvidia-smi --query-gpu=<query>`` (csv, no header)."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def load(name, inst, **compile_kw):
    """The Case of one zoo instance, compiled onto the card."""
    from repro_torch.core.models import ZOO
    mod = ZOO[name]
    m, handles = mod.build_model(inst)
    return Case(mod, inst, handles, m.compile(device="cuda", **compile_kw),
                None, None, None)


def describe(cm):
    s = f"V={cm.n_vars} P={cm.n_props} K={cm.k_terms} D={cm.d_occ}"
    if cm.n_cumulative:
        s += (f" C={cm.n_cumulative} T={cm.cu_width} Dcu={cm.cu_docc} "
              f"horizon={cm.horizon} cu_layout={cm.cu_layout}")
    if cm.n_alldiff:
        s += (f" A={cm.n_alldiff} N={cm.ad_width} Dad={cm.ad_docc} "
              f"ad_layout={cm.ad_layout}")
    if cm.n_table:
        s += (f" tables={cm.n_table} R={cm.ct_arity} W={cm.n_words} "
              f"TW={cm.ct_words} Dct={cm.ct_docc} ct_supp="
              f"{list(cm.ct_supp.shape)}")
    return f"{s} {cm.dtype}"


def prepare(phase, tag, case, eps_target=None):
    """`case` with N_RANDOM random stores (with an AllDifferent bank, the
    first N_PIGEONHOLE of them overfull) and, given `eps_target`, the EPS
    pool decomposed to it."""
    import numpy as np
    from repro_torch.core import eps
    from repro_torch.solver import SolveConfig
    from repro_torch.testing import (pigeonhole_stores, random_dom_stores,
                                     random_substores)
    cm = case.cm
    rng = np.random.default_rng(SEED)
    lbs, ubs = random_substores(rng, cm, N_RANDOM)
    if cm.n_alldiff:
        lbs[:N_PIGEONHOLE], ubs[:N_PIGEONHOLE] = pigeonhole_stores(
            rng, cm, lbs, ubs, N_PIGEONHOLE)
    doms = (random_dom_stores(rng, cm, lbs, ubs, n_wipe=N_WIPE)
            if cm.n_table else None)
    pool, msg = None, ""
    if eps_target:
        opts = SolveConfig.preset("prove", backend="cuda").search_options()
        t0 = time.perf_counter()
        pool = eps.decompose(cm, eps_target, opts)
        msg = (f"; EPS pool {pool[0].shape[0]} subproblems in "
               f"{time.perf_counter() - t0:.2f} s")
    print(f"[{phase}] {tag}: {describe(cm)}{msg}")
    return case._replace(lbs=lbs, ubs=ubs, pool=pool, doms=doms)


def rcpsp_cases():
    from repro_torch.core.models import rcpsp
    return {tag: prepare(2, tag, load("rcpsp", rcpsp.generate(
        n, n_resources=4, seed=SEED)), target)
        for tag, n, target in (("J30", 30, 1024), ("J60", 60, MAIN_EPS))}


def zoo_cases():
    from repro_torch.core.models import large_instance, nqueens
    return {
        "nqueens32": prepare(8, "nqueens32", load(
            "nqueens", nqueens.generate(32, seed=SEED)), MAIN_EPS),
        "coloring64": prepare(8, "coloring64", load(
            "coloring", large_instance("coloring", seed=SEED)), MAIN_EPS),
        "nqueens8": prepare(8, "nqueens8", load(
            "nqueens", nqueens.generate(8, seed=SEED)))}


# --------------------------------------------------------------------------
# phase 1: card and build
# --------------------------------------------------------------------------

def phase_card_and_build():
    """Returns the card line and the card's int32 peak (operations/s)."""
    import torch
    from repro_torch.kernels import build
    card = nvidia_smi("name,power.limit")
    print(f"[1] card: {card}")
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    peak_int32 = sms * INT32_LANES_PER_SM * mhz * 1e6
    print(f"[1] {sms} SMs x {INT32_LANES_PER_SM} INT32 lanes x {mhz:.0f} "
          f"MHz (max SM clock) = {peak_int32 / 1e12:.2f} T int32 op/s")
    for built in build.build_all(BUILDS):
        print(f"[1] built {os.path.relpath(built.path, ROOT)} in "
              f"{built.seconds:.1f} s")
        for line in built.log.splitlines():
            if any(k in line for k in ("registers", "spill", "stack frame",
                                       "Compiling entry")):
                print(f"[1]   ptxas: {line.strip()}")
    return card, peak_int32


# --------------------------------------------------------------------------
# phases 2 and 8: the fixpoint kernel against its plain version
# --------------------------------------------------------------------------

def compare(cm, lb, ub, cap, what, dom=None):
    """Kernel vs plain version on one batch (with `dom`, a carried bitset
    store); returns (max_abs_err over non-failed stores, whole-output
    equality, sweeps, failed mask)."""
    import torch
    from repro_torch.core import fixpoint as F
    from repro_torch.kernels.fixpoint_kernel import fixpoint_cuda
    ref = F.fixpoint_batch(cm, lb, ub, dom, max_iters=cap)
    got = fixpoint_cuda(cm, lb, ub, dom, max_sweeps=cap)
    torch.cuda.synchronize()
    rdom = gdom = None
    if dom is not None:
        rdom, gdom = ref[2], got[2]
        ref, got = ref[:2] + ref[3:], got[:2] + got[3:]
    rlb, rub, rsw, rconv = ref
    glb, gub, gsw, gconv = got
    rfail, gfail = (rlb > rub).any(1), (glb > gub).any(1)
    if not torch.equal(rfail, gfail):
        fail(f"{what}: failed masks differ on "
             f"{int((rfail != gfail).sum())} lanes")
    ok = ~rfail
    err = max(int((glb[ok].long() - rlb[ok].long()).abs().max().item()
                  if ok.any() else 0),
              int((gub[ok].long() - rub[ok].long()).abs().max().item()
                  if ok.any() else 0))
    if err:
        fail(f"{what}: non-failed stores differ (max |err| {err})")
    if not torch.equal(rsw, gsw):
        fail(f"{what}: sweep counts differ on "
             f"{int((rsw != gsw).sum())} lanes")
    if not torch.equal(rconv, gconv):
        fail(f"{what}: convergence flags differ")
    if dom is not None and not torch.equal(rdom[ok], gdom[ok]):
        fail(f"{what}: the non-failed stores' domain words differ")
    whole = (torch.equal(rlb, glb) and torch.equal(rub, gub)
             and (dom is None or torch.equal(rdom, gdom)))
    return err, whole, rsw, rfail


def phase_kernel_vs_plain(phase, cases, pool_batches=None):
    """`fixpoint_cuda` against `fixpoint_batch` on each case's random
    stores and EPS pool (its first `pool_batches` batches of N_RANDOM
    stores, or all) at every cap of CAPS; the overfull stores of an
    AllDifferent model must fail uncapped.  Returns the max |err|."""
    import torch
    max_err = 0
    for tag, c in cases.items():
        batches = [("random", c.lbs, c.ubs)]
        if c.pool is not None:
            plb, pub = c.pool
            batches += [(f"pool[{i}:{i + N_RANDOM}]", plb[i:i + N_RANDOM],
                         pub[i:i + N_RANDOM])
                        for i in range(0, plb.shape[0], N_RANDOM)
                        ][:pool_batches]
        n_over = N_PIGEONHOLE if c.cm.n_alldiff else 0
        for cap in CAPS:
            lanes = whole = over_failed = 0
            sweeps = []
            for name, bl, bu in batches:
                lb = torch.from_numpy(bl).cuda()
                ub = torch.from_numpy(bu).cuda()
                err, same, sw, failed = compare(
                    c.cm, lb, ub, cap, f"{tag} {name} max_sweeps={cap}")
                if name == "random":
                    over_failed = int(failed[:n_over].sum())
                max_err = max(max_err, err)
                lanes += lb.shape[0]
                whole += int(same)
                sweeps.append(sw)
            sw = torch.cat(sweeps)
            over = (f"; {over_failed}/{n_over} overfull stores failed"
                    if n_over else "")
            print(f"[{phase}] {tag} max_sweeps={cap}: {lanes} lanes equal "
                  f"(failed masks, stores, sweeps, converged); "
                  f"{whole}/{len(batches)} batches equal in every store; "
                  f"sweeps mean {sw.float().mean().item():.2f} "
                  f"max {int(sw.max())}{over}")
            if cap is None and over_failed != n_over:
                fail(f"{tag}: {n_over - over_failed} overfull stores did "
                     "not fail")
    return max_err


def checked_cases(phase, make, pool_batches=None):
    """The cases `make()` returns, held by `phase_kernel_vs_plain`."""
    cases = make()
    return cases, phase_kernel_vs_plain(phase, cases, pool_batches)


# --------------------------------------------------------------------------
# phases 3, 6, 10 and 11: solves through the main path
# --------------------------------------------------------------------------

def main_config(backend, strategy=None, **kw):
    """The main path's configuration: `prove`, 1024 lanes, eps_target
    4096, K=16 for `cuda_resident`, optionally a (var, val) pair."""
    from repro_torch.solver import SolveConfig
    if strategy:
        kw.update(var_strategy=strategy[0], val_strategy=strategy[1])
    if backend == "cuda_resident":
        kw.update(supersteps_per_launch=MAIN_K)
    kw.setdefault("timeout_s", MAIN_TIMEOUT_S)
    return SolveConfig.preset("prove", backend=backend, n_lanes=MAIN_LANES,
                              eps_target=MAIN_EPS, **kw)


def solve_case(phase, tag, c, cfg, optimum=None):
    """One solve through `Solver.solve` with the launch counters set to 0
    just before and read just after.  The solution is ground-checked, the
    backend's kernel must have run (`cuda`: a launch per superstep at
    least; `cuda_resident`: one per K supersteps), and with `optimum`
    the result must be OPTIMAL at it.  Returns (result, (fixpoint_cuda
    launches, search_cuda launches))."""
    from repro_torch.core.models import ground_check
    from repro_torch.kernels.fixpoint_kernel import fixpoint_cuda, search_cuda
    from repro_torch.solver import Solver
    fixpoint_cuda.launches = 0
    search_cuda.launches = 0
    res = Solver(cfg).solve(c.cm)
    launches = (fixpoint_cuda.launches, search_cuda.launches)
    checked = ground_check(c.mod, c.inst, c.handles, res)
    if checked is False:
        fail(f"{tag} ({cfg.backend}): the solution fails the ground check")
    steps = res.n_supersteps
    search_s = res.wall_s - res.eps_s
    print(f"[{phase}] {tag} ({cfg.backend}, {cfg.var_strategy}/"
          f"{cfg.val_strategy}, {cfg.n_lanes} lanes, eps_target "
          f"{cfg.resolved_eps_target()}, max_supersteps "
          f"{cfg.max_supersteps}): {res.status} objective={res.objective} "
          f"nodes={res.n_nodes} ({res.nodes_per_sec:.0f}/s) "
          f"fails={res.n_fails} sols={res.n_sols} sweeps={res.n_sweeps} "
          f"supersteps={steps} wall={res.wall_s:.2f} s "
          f"eps={res.eps_s:.2f} s ({res.eps_s / res.wall_s:.1%} of the "
          f"wall), search {search_s * 1e3:.1f} ms "
          f"({search_s / max(steps, 1) * 1e3:.4f} ms/superstep after EPS) "
          f"fixpoint_cuda launches={launches[0]} search_cuda "
          f"launches={launches[1]}; ground check "
          f"{'OK' if checked else 'n/a (no solution)'}")
    fix, srch = launches
    if cfg.backend == "cuda" and (fix == 0 or fix < steps):
        fail(f"{tag}: {fix} fixpoint_cuda launches for {steps} supersteps")
    if cfg.backend == "cuda_resident" and (
            srch == 0 or srch < -(-steps // cfg.resolved_supersteps())):
        fail(f"{tag}: {srch} search_cuda launches for {steps} supersteps")
    if optimum is not None and (res.status != "OPTIMAL"
                                or res.objective != optimum):
        fail(f"{tag} ({cfg.backend}): expected OPTIMAL {optimum} within "
             f"{cfg.max_supersteps} supersteps, got {res.status} "
             f"{res.objective} after {steps}")
    return res, launches


def same_counters(phase, what, results, reference=None):
    """Fails unless every result of `results` (backend -> SolveResult)
    has the same COUNTERS, equal to `reference` where given."""
    names = list(results)
    for k in COUNTERS:
        vals = [getattr(results[b], k) for b in names]
        if len(set(vals)) != 1:
            fail(f"{what}: {k} differs: "
                 + ", ".join(f"{b} {v}" for b, v in zip(names, vals)))
        if reference is not None and vals[0] != reference[k]:
            fail(f"{what}: {k} = {vals[0]}, the JAX package gives "
                 f"{reference[k]}")
    print(f"[{phase}] {what}: {' == '.join(names)}"
          f"{' == JAX reference' if reference else ''} on "
          + ", ".join(COUNTERS))


def phase_main_path(cases):
    import torch
    from repro_torch.solver import SolveConfig
    res, (launches, _) = solve_case(3, "J60", cases["J60"],
                                    main_config("cuda"), J60_OPTIMUM)

    # the cost of the per-superstep host read of the global done flag
    flag = torch.zeros(MAIN_LANES, dtype=torch.bool).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        bool(flag.all())
    sync_us = (time.perf_counter() - t0) / 200 * 1e6
    print(f"[3] host read of the done flag: {sync_us:.1f} us per superstep "
          f"(idle stream)")

    got = {b: solve_case(3, "J30", cases["J30"], SolveConfig.preset(
        "prove", backend=b, n_lanes=J30_LANES))[0] for b in ("cuda", "gather")}
    same_counters(3, "J30", got, J30_REFERENCE)
    return launches, res


def phase_resident_path(cases, ref):
    res, (_, launches) = solve_case(6, "J60", cases["J60"],
                                    main_config("cuda_resident"))
    same_counters(6, "J60", {"cuda": ref, "cuda_resident": res})
    return launches, res


def phase_zoo_main_path(cases):
    """N-queens 32 and coloring 64: `cuda` and `cuda_resident` under
    ZOO_CAP supersteps (equal results and counters), then
    `cuda_resident` under ZOO_LONG_CAP to the optimum.  Returns the
    launches by (tag, run) and the long runs' (config, result) by tag."""
    launches, long = {}, {}
    for tag, strategy in ZOO_STRATEGY.items():
        got = {}
        for backend in ("cuda", "cuda_resident"):
            got[backend], launches[(tag, backend)] = solve_case(
                10, tag, cases[tag],
                main_config(backend, strategy, max_supersteps=ZOO_CAP))
        same_counters(10, tag, got)
        cfg = main_config("cuda_resident", strategy,
                          max_supersteps=ZOO_LONG_CAP)
        res, launches[(tag, "long")] = solve_case(10, tag, cases[tag], cfg,
                                                  ZOO_OPTIMUM[tag])
        long[tag] = (cfg, res)
    return launches, long


def phase_zoo_smoke():
    from repro_torch.core.models import small_instance
    from repro_torch.solver import SolveConfig
    for name in ZOO_SMOKE:
        c = load(name, small_instance(name, seed=SEED))
        got = {b: solve_case(11, name, c, SolveConfig.preset(
            "prove", backend=b, n_lanes=ZOO_SMOKE_LANES))[0]
            for b in ZOO_BACKENDS}
        same_counters(11, f"{name} smoke", got, ZOO_SMOKE_REFERENCE[name])


# --------------------------------------------------------------------------
# phases 4, 7 and 12: times and bounds
# --------------------------------------------------------------------------

def cuda_ms(fn, reps, warmup):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def table_bytes(cm, dom=False):
    """Bytes of the propagator tables a sweep of this model reads: a
    bank's dense ``[rows, width]`` tables or its packed (sparse) ones,
    as the model compiled, and its occurrence lists; the Compact-Table
    bank's only with tables, the domain layout (offsets, tracked flags)
    only with tables or a carried store (`dom`)."""
    from repro_torch.kernels.fixpoint_kernel import kernel_tables
    unread = ((cm.ad_vars, cm.ad_offs, cm.ad_mask)
              if cm.ad_layout == "sparse" else
              (cm.ad_ptr, cm.ad_pk_var, cm.ad_pk_off, cm.ad_pk_seg))
    unread += ((cm.cu_svar, cm.cu_dur, cm.cu_dem)
               if cm.cu_layout == "sparse" else
               (cm.cu_ptr, cm.cu_pk_svar, cm.cu_pk_dur, cm.cu_pk_dem,
                cm.cu_pk_seg))
    if not cm.n_table:
        unread += (cm.ct_vars, cm.ct_mask, cm.ct_supp, cm.ct_occ_inst,
                   cm.ct_occ_pos)
        if not dom:
            unread += (cm.dom_off, cm.dom_track)
    return sum(t.numel() * t.element_size() for t in kernel_tables(cm)
               if not any(t.data_ptr() == u.data_ptr() for u in unread))


def row_sizes(cm):
    """Members of each real AllDifferent row."""
    return cm.ad_mask[:cm.n_alldiff].sum(1).tolist() if cm.n_alldiff else []


def ops_per_sweep(cm, dom=False):
    """The integer work one fixpoint sweep of one lane needs (at int64
    counted against the int32 peak, so a lower bound), apart from
    the Compact-Table bank's per-value work (`ct_ops_per_value`): 8·P1·K
    for the linear bank and 2·V·D for its join; with a Cumulative bank,
    4·C1·T for the tasks (each adds its compulsory part's two ends, and
    each task's first and last start take at least one operation each),
    per row of n tasks the lesser of two ways to build the profile — a
    prefix sum and a capacity compare per time point of the horizon
    (2·H), or a sort of its 2·n events and a sum and a compare per event
    (2·2n·⌈log2 2n⌉ + 4·n; the lesser at durations × 10⁷) — and
    2·V·Dcu for its join; with an AllDifferent bank, on each row of n
    members the lesser of two algorithms' work: a sorted Hall pass,
    2·n·⌈log2 n⌉ compares to sort the members by lower and by upper
    bound and ALLDIFF_OPS per (upper endpoint, member) for the counts,
    the width tests and the pushes, or the endpoint-pair pass, PAIR_OPS·n³ (cheaper for n = 2);
    and 2·V·Dad for its join; with a Compact-Table bank, r·TW per table
    row of r members to AND their support ORs into the current table and
    2·V·Dct for its join; with a carried bitset store (`dom`) also
    V·Dct·W to AND the tables' words in and 4·V·W to normalize."""
    P1, K = cm.vidx.shape
    V = cm.n_vars
    ops = 8 * P1 * K + 2 * V * cm.d_occ
    if cm.n_cumulative:
        C1, T = cm.cu_svar.shape
        C = cm.n_cumulative
        rows = (cm.cu_ptr[1:C + 1] - cm.cu_ptr[:C]).tolist()
        ops += (4 * C1 * T + 2 * V * cm.cu_docc
                + sum(min(2 * cm.horizon,
                          4 * n * math.ceil(math.log2(2 * n)) + 4 * n)
                      for n in rows if n))
    if cm.n_alldiff:
        ops += sum(min(2 * n * math.ceil(math.log2(n)) + ALLDIFF_OPS * n * n,
                       PAIR_OPS * n ** 3)
                   for n in row_sizes(cm) if n > 1) + 2 * V * cm.ad_docc
    W = cm.n_words
    if cm.n_table:
        TW = cm.ct_words
        ops += int(cm.ct_mask[:cm.n_table].ne(0).sum()) * TW
        ops += 2 * V * cm.ct_docc + (V * cm.ct_docc * W if dom else 0)
    if dom:
        ops += 4 * V * W
    return ops


def ct_ops_per_value(cm):
    """The Compact-Table bank's work per value a member holds in the
    store a sweep reads: a bit test and an OR per support word (2·TW) to
    OR the value's support into the member's, and three operations to
    test whether it survives and fold it into the hull."""
    return 2 * cm.ct_words + 3


def ct_values(cm, lb, ub, dom=None):
    """Per lane ``[L]``: the values the table rows' real members hold in
    the store a sweep reads — the carried words `dom`, or without them
    the range words of [lb, ub] (untracked variables all-ones), as the
    sweep builds them — summed over every member of every row."""
    import torch
    from repro_torch.core import bitset as B
    if dom is None:
        dom = B.from_bounds(lb, ub, cm.dom_off, cm.n_words,
                            track=cm.dom_track.view(torch.int32))
    T = cm.n_table
    members = cm.ct_vars[:T][cm.ct_mask[:T] != 0].long()
    return B.count(dom.index_select(1, members)).long().sum(1)


def ct_value_work(cm, lb, ub, dom, sweeps, plain_fixpoint):
    """The member values the Compact-Table bank walks in a fixpoint run
    from (lb, ub, dom) in which lane l made ``sweeps[l]`` sweeps: sweep k
    reads the store after k - 1 sweeps (Jacobi), which one-sweep calls of
    `plain_fixpoint` (`fixpoint_batch`) replay."""
    total = 0
    for k in range(int(sweeps.max()) if sweeps.numel() else 0):
        total += int(ct_values(cm, lb, ub, dom)[sweeps > k].sum())
        out = plain_fixpoint(cm, lb, ub, dom, max_iters=1)
        lb, ub = out[0], out[1]
        dom = out[2] if dom is not None else None
    return total


@contextlib.contextmanager
def counting_ct_values(cm):
    """Within the block, every plain fixpoint (`fixpoint_batch`, which
    `search_plain` runs through its gather backend) adds the member
    values its sweeps walk (`ct_value_work`) to the yielded list's one
    cell."""
    from repro_torch.core import fixpoint as F
    plain = F.fixpoint_batch
    acc = [0]

    def counted(cm_, lb, ub, dom=None, **kw):
        out = plain(cm_, lb, ub, dom, **kw)
        acc[0] += ct_value_work(cm_, lb, ub, dom, out[-2], plain)
        return out
    F.fixpoint_batch = counted
    try:
        yield acc
    finally:
        F.fixpoint_batch = plain


def sparse_work_per_sweep(cm):
    """The sparse banks' own work per lane-sweep, as the kernel does it:
    (sort compares, scan steps).  A sort of n keys counts n·⌈log2 n⌉
    compares (n = Mad members; n = 2·Mcu events); the scans count one
    step per (member, member of its row) in the Hall count and again in
    the push (2·n² per row of n), and one per (task, event of its row),
    forward and backward (2·n·2n per row of n tasks)."""
    def nlog(n):
        return n * math.ceil(math.log2(n)) if n > 1 else 0
    sort = scan = 0
    if cm.n_alldiff and cm.ad_layout == "sparse":
        sort += nlog(cm.ad_packed)
        scan += sum(2 * n * n for n in row_sizes(cm))
    if cm.n_cumulative and cm.cu_layout == "sparse":
        sort += nlog(2 * cm.cu_packed)
        rows = (cm.cu_ptr[1:cm.n_cumulative + 1]
                - cm.cu_ptr[:cm.n_cumulative]).tolist()
        scan += sum(4 * n * n for n in rows)
    return sort, scan


def pair_ops_per_sweep(cm):
    """The AllDifferent work of the kernel's own endpoint-pair algorithm
    per lane-sweep, every pair counted: PAIR_OPS·n³ per row."""
    return sum(PAIR_OPS * n ** 3 for n in row_sizes(cm))


def live_pair_share(cm, lb, ub):
    """Share of the endpoint pairs (i, j) of real members with
    yl_i <= yu_j in the stores `lb`/`ub`: the pairs the kernel does not
    skip in a sweep of them."""
    A = cm.n_alldiff
    msk = cm.ad_mask[:A] != 0
    idx, off = cm.ad_vars[:A].long(), cm.ad_offs[:A]
    yl, yu = lb[:, idx] + off, ub[:, idx] + off                # [L, A, N]
    live = ((yl[:, :, :, None] <= yu[:, :, None, :])
            & msk[:, :, None] & msk[:, None, :])
    return int(live.sum()) / (lb.shape[0] * sum(n * n
                                                 for n in row_sizes(cm)))


def bound(nbytes, ops, peak_int32):
    """(bound ms, what bounds it): the larger of bytes over the HBM rate
    and int32 operations over the int32 peak."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_int32 * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def pair_note(cm, lane_sweeps, peak_int32):
    """The kernel's own work where it differs from the bound's count: the
    dense AllDifferent bank's endpoint pairs, the sparse banks' sorts and
    scans."""
    if cm.n_alldiff and cm.ad_layout == "dense":
        ops = lane_sweeps * pair_ops_per_sweep(cm)
        return (f"; the endpoint-pair algorithm's own AllDifferent work, "
                f"every pair: {ops} int32 ops "
                f"({ops / peak_int32 * 1e3:.5f} ms)")
    sort, scan = sparse_work_per_sweep(cm)
    if not sort:
        return ""
    return (f"; the sparse banks' own work: {lane_sweeps * sort} sort "
            f"compares and {lane_sweeps * scan} scan steps ({sort} and "
            f"{scan} per lane-sweep)")


def time_fixpoint(card, peak_int32, cm, lbs, ubs, tag, what, plain_reps=5,
                  doms=None):
    """`fixpoint_cuda` and `fixpoint_batch` per launch (CUDA events) on
    ``[MAIN_LANES, V]`` stores (with `doms`, ``uint32 [L, V, W]``, a
    carried bitset store), uncapped, beside the bound: each table and
    store read once and each output written once, over the HBM rate;
    the sweeps this run needed times `ops_per_sweep`, over the int32
    peak.  Returns (kernel ms, plain ms, bound ms, bound_by)."""
    import torch
    from repro_torch.core import fixpoint as F
    from repro_torch.kernels.fixpoint_kernel import fixpoint_cuda
    lb = torch.from_numpy(lbs[:MAIN_LANES]).cuda()
    ub = torch.from_numpy(ubs[:MAIN_LANES]).cuda()
    dom = (None if doms is None else
           torch.from_numpy(doms[:MAIN_LANES].view("int32")).cuda())
    L, V = lb.shape
    n0 = fixpoint_cuda.launches
    ms = cuda_ms(lambda: fixpoint_cuda(cm, lb, ub, dom), reps=50, warmup=5)
    plain_ms = cuda_ms(lambda: F.fixpoint_batch(cm, lb, ub, dom),
                       reps=plain_reps, warmup=1)
    fixpoint_cuda.launches = n0            # timing launches are not counted
    lane_sweeps = F.fixpoint_batch(cm, lb, ub, dom)[-2]
    sweeps = int(lane_sweeps.sum())
    carried = dom is not None
    nbytes = (table_bytes(cm, carried) + 4 * L * V * lb.element_size()
              + 2 * L * 4 + (2 * dom.numel() * 4 if carried else 0))
    ops = sweeps * ops_per_sweep(cm, carried)
    live = ""
    if cm.n_table:
        values = ct_value_work(cm, lb, ub, dom, lane_sweeps,
                               F.fixpoint_batch)
        ops += values * ct_ops_per_value(cm)
        live = (f"; {values / sweeps:.1f} table-member values per "
                f"lane-sweep")
    bound_ms, bound_by = bound(nbytes, ops, peak_int32)
    if cm.n_alldiff and cm.ad_layout == "dense":
        live = (f"; {live_pair_share(cm, lb, ub):.1%} of the endpoint "
                f"pairs live in the input stores")
    print(f"[{tag}] fixpoint at [{L}, {V}] {cm.dtype} ({what}, uncapped, "
          f"{sweeps} lane-sweeps): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms, "
          f"bound {bound_ms:.5f} ms ({bound_by}: {nbytes} B, {ops} "
          f"ops at {peak_int32 / 1e12:.2f} T/s; kernel {ms / bound_ms:.0f}x "
          f"the bound){pair_note(cm, sweeps, peak_int32)}{live} on {card}")
    return ms, plain_ms, bound_ms, bound_by


def search_bound_ms(cm, start, out, peak_int32, launches=1, ct_vals=0):
    """Least time for the work of `launches` launches from `start` to
    `out`: the LaneState read once and written once per launch (bools one
    byte each) and the tables read once per launch, over the HBM rate;
    the sweeps they needed times `ops_per_sweep`, the `ct_vals` table-
    member values their sweeps walked times `ct_ops_per_value`, plus, per
    lane and live superstep, the commit's solved/failed checks (2·V) and
    branch selection (3·B), over the int32 peak.  Dispatch, the tells and
    backtracking are counted as nothing, so this is a lower bound."""
    st_in, st_out = start[0], out[0]
    L, V = st_in.lb.shape
    B = int(cm.branch_vars.shape[0])
    steps = int(out[2]) - int(start[2])
    sweeps = int(st_out.n_sweeps.long().sum() - st_in.n_sweeps.long().sum())
    state = sum(a.numel() * a.element_size() for a in st_in
                if a is not None)
    carried = st_in.dom is not None
    nbytes = launches * (2 * state + table_bytes(cm, carried))
    ops = (sweeps * ops_per_sweep(cm, carried)
           + (ct_vals * ct_ops_per_value(cm) if cm.n_table else 0)
           + steps * L * (2 * V + 3 * B))
    return (*bound(nbytes, ops, peak_int32), nbytes, ops, steps, sweeps)


def time_search(card, peak_int32, timing_state, tag, what, plain_reps=2,
                plain_warmup=1):
    """`search_cuda` and `search_plain` per launch (CUDA events) from one
    start, beside the bound; returns (kernel ms, plain ms, bound ms,
    bound_by)."""
    from repro_torch.kernels.fixpoint_kernel import search_cuda, search_plain
    cm, slb, sub, start, kw = timing_state
    n0 = search_cuda.launches
    out = search_cuda(cm, slb, sub, *start, supersteps=MAIN_K, **kw)
    ms = cuda_ms(lambda: search_cuda(cm, slb, sub, *start,
                                     supersteps=MAIN_K, **kw),
                 reps=20, warmup=3)
    plain_ms = cuda_ms(lambda: search_plain(cm, slb, sub, *start,
                                            supersteps=MAIN_K, **kw),
                       reps=plain_reps, warmup=plain_warmup)
    search_cuda.launches = n0             # timing launches are not counted
    ct_vals, note = 0, ""
    if cm.n_table:
        with counting_ct_values(cm) as acc:
            search_plain(cm, slb, sub, *start, supersteps=MAIN_K, **kw)
        ct_vals = acc[0]
    bound_ms, bound_by, nbytes, ops, steps, sweeps = search_bound_ms(
        cm, start, out, peak_int32, ct_vals=ct_vals)
    if cm.n_table:
        note = (f"; {ct_vals / max(sweeps, 1):.1f} table-member values per "
                f"lane-sweep")
    L = start[0].lb.shape[0]
    tile = kw.get("lane_tile") or 0
    mode = f"lane tiles of {tile}" if tile else "one queue"
    print(f"[{tag}] search at {L} lanes, {cm.dtype}, {mode}, K={MAIN_K} "
          f"({what}, from the state "
          f"after {int(start[2])}; {steps} live supersteps, {sweeps} "
          f"lane-sweeps): kernel {ms:.4f} ms per launch "
          f"({ms / max(steps, 1):.4f} ms per superstep), plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.5f} ms ({bound_by}: "
          f"{nbytes} B, {ops} ops at {peak_int32 / 1e12:.2f} T/s; "
          f"kernel {ms / bound_ms:.0f}x the bound)"
          f"{pair_note(cm, sweeps, peak_int32)}{note}; library: none "
          f"(no PyTorch call computes a superstep) on {card}")
    return ms, plain_ms, bound_ms, bound_by


def time_resident_solve(card, peak_int32, tag, c, cfg, res):
    """Every launch of one `cuda_resident` solve, replayed from the same
    options and a pool decomposed as the solve's (the split depends on
    the strategy pair) and timed one by one (CUDA events); the replay's
    supersteps and nodes must equal the solve's `res`."""
    import torch
    from repro_torch.kernels.fixpoint_kernel import search_cuda
    from repro_torch.testing import search_inputs
    opts = cfg.search_options()
    kw = dict(max_fixpoint_iters=opts.max_fixpoint_iters,
              var_strategy=opts.var_strategy,
              val_strategy=opts.val_strategy,
              stop_on_first=opts.stop_on_first)
    slb, sub, st, gbest, head = search_inputs(c.cm, cfg.n_lanes,
                                              cfg.resolved_eps_target(), opts)
    start = cur = (st, gbest, 0, head)
    n0 = search_cuda.launches
    times = []
    while True:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = search_cuda(c.cm, slb, sub, *cur,
                          supersteps=cfg.resolved_supersteps(), **kw)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
        cur = out[:4]
        if bool(out[4]) or int(out[2]) >= cfg.max_supersteps:
            break
    search_cuda.launches = n0             # replay launches are not counted
    nodes = int(out[0].n_nodes.long().sum())
    if (int(out[2]), nodes) != (res.n_supersteps, res.n_nodes):
        fail(f"{tag}: the replay reached {int(out[2])} supersteps and "
             f"{nodes} nodes, the solve {res.n_supersteps} and "
             f"{res.n_nodes}")
    bound_ms, bound_by, nbytes, ops, steps, sweeps = search_bound_ms(
        c.cm, start, out, peak_int32, launches=len(times))
    total = sum(times)
    mid = sorted(times)[len(times) // 2]
    print(f"[12] {tag} main-path replay ({cfg.backend}, K="
          f"{cfg.resolved_supersteps()}, {cfg.n_lanes} lanes): "
          f"{len(times)} launches, {steps} supersteps, {sweeps} lane-sweeps, "
          f"nodes {nodes} as the solve; device {total:.2f} ms in all "
          f"against the solve's {(res.wall_s - res.eps_s) * 1e3:.1f} ms of "
          f"search wall; per launch mean {total / len(times):.4f} ms, "
          f"median {mid:.4f}, min {min(times):.4f}, max {max(times):.4f}; "
          f"bound {bound_ms:.5f} ms in all ({bound_by}: {nbytes} B, {ops} "
          f"int32 ops; kernel {total / bound_ms:.0f}x the bound)"
          f"{pair_note(c.cm, sweeps, peak_int32)} on {card}")
    print("[12] per-launch ms: " + " ".join(f"{t:.3f}" for t in times))
    return total / len(times)


def phase_times(card, peak_int32, cases, launches, max_err):
    c = cases["J60"]
    ms, plain_ms, bound_ms, bound_by = time_fixpoint(
        card, peak_int32, c.cm, c.lbs, c.ubs, "4", "J60 random stores")
    print(f"kernels: fixpoint_cuda launches={launches}")
    return [dict(name="fixpoint_cuda", route="cuda", source=FIXPOINT_SOURCE,
                 replaces=FIXPOINT_REPLACES, launches=launches,
                 max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                 bound_ms=bound_ms, bound_by=bound_by, library_ms=None)]


def phase_search_times(card, peak_int32, timing_state, launches, max_err):
    ms, plain_ms, bound_ms, bound_by = time_search(
        card, peak_int32, timing_state, "7", "J60, prove")
    print(f"kernels: search_cuda launches={launches}")
    return dict(name="search_cuda", route="cuda", source=SEARCH_SOURCE,
                replaces=SEARCH_REPLACES, launches=launches,
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def phase_alldiff_times(card, peak_int32, cases, states, long):
    """Both kernels at the N-queens-32 shapes, then the long N-queens-32
    solve's launches replayed."""
    c = cases["nqueens32"]
    time_fixpoint(card, peak_int32, c.cm, c.lbs, c.ubs, "12",
                  "N-queens 32 stores of phase 8")
    time_search(card, peak_int32, states[("nqueens32", "min_dom/split")],
                "12", "N-queens 32, min_dom/split, early state")
    time_resident_solve(card, peak_int32, "nqueens32", c, *long["nqueens32"])


# --------------------------------------------------------------------------
# phases 5 and 9: the resident search kernel against its plain version
# --------------------------------------------------------------------------

def search_kwargs(preset, strategy=None):
    from repro_torch.solver import SolveConfig
    pair = (dict(var_strategy=strategy[0], val_strategy=strategy[1])
            if strategy else {})
    opts = SolveConfig.preset(preset, backend="cuda_resident",
                              **pair).search_options()
    return opts, dict(max_fixpoint_iters=opts.max_fixpoint_iters,
                      var_strategy=opts.var_strategy,
                      val_strategy=opts.val_strategy,
                      stop_on_first=opts.stop_on_first)


def right_branch_lanes(st):
    """Lanes whose decision path holds a flipped (right-branch) decision:
    each got there by a backtrack."""
    import torch
    md = st.dec_var.shape[1]
    on = (torch.arange(md, device=st.depth.device)[None, :]
          < st.depth[:, None])
    return int((st.dec_flip & on).any(1).sum())


def max_abs_diff(ref, got):
    """Largest |difference| over every LaneState field and the four
    scalars of two resident-launch results."""
    err = 0
    for a, b in zip(ref[0], got[0]):
        if a is not None and a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    for a, b in zip(ref[1:], got[1:]):
        err = max(err, int((a.long() - b.long()).abs().max()))
    return err


def phase_search_vs_plain(phase, cases, lanes, variants, around_first,
                          ks=SEARCH_K, must_search=False, warm=WARM_STEPS,
                          lane_tile=0):
    """`search_cuda` against `search_plain` on each case (`lanes[tag]`
    lanes, its EPS pool) under each variant, at every K of `ks`,
    from fresh lanes, after `warm` plain supersteps and, with
    `around_first`, 8 supersteps before and after the first solution;
    with `lane_tile`, in lane tiles of that many lanes (the cursors, one
    per tile, compared too).
    With `must_search`, each variant must have failed nodes and lanes
    in a right branch (a backtrack) in the states it compared.
    Returns the starts after `warm` supersteps by (tag, variant name),
    the fresh starts by (tag, variant name, 0), and the max |err|."""
    import torch
    from repro_torch.kernels.fixpoint_kernel import (search_cuda,
                                                     search_grid,
                                                     search_plain)
    from repro_torch.testing import search_diff, search_inputs
    n0 = search_cuda.launches
    max_err = 0
    states = {}
    for tag, c in cases.items():
        cm, L = c.cm, lanes[tag]
        starts, msg = [0, warm], ""
        if around_first:
            # the superstep that finds the first solution, from fresh lanes
            opts, kw = search_kwargs("first_solution")
            inputs = search_inputs(cm, L, None, opts, pool=c.pool)
            out = search_plain(cm, *inputs[:3], inputs[3], 0, inputs[4],
                               supersteps=FIRST_SOL_MAX, **kw)
            if not bool(out[4]):
                fail(f"{tag}: no solution in {FIRST_SOL_MAX} supersteps")
            first = int(out[2])
            starts = sorted({0, warm, max(first - 8, 0), first + 8})
            msg = f"; first solution at superstep {first}"
        print(f"[{phase}] {tag}: {L} lanes, EPS pool {c.pool[0].shape[0]}"
              f"{msg}; starts after {', '.join(map(str, starts))} plain "
              f"supersteps")
        for name, preset, strategy in variants:
            opts, kw = search_kwargs(preset, strategy)
            if lane_tile:
                kw["lane_tile"] = lane_tile
            slb, sub, st, gbest, head = search_inputs(cm, L, None, opts,
                                                      pool=c.pool)
            carried = st.dom is not None
            print(f"[{phase}] {tag} {name}: "
                  f"{search_grid(cm, L, carried, lane_tile)} "
                  f"CTAs (cooperative grid), bitset store "
                  f"{'carried' if carried else 'none'}, {cm.dtype}, "
                  + (f"lane tiles of {lane_tile}" if lane_tile
                     else "one queue"))
            cur, done_steps = (st, gbest, 0, head), 0
            fails = flipped = 0
            for n in starts:
                if n > done_steps:
                    cur = search_plain(cm, slb, sub, *cur,
                                       supersteps=n - done_steps, **kw)[:4]
                    done_steps = n
                if n == warm:
                    states[(tag, name)] = (cm, slb, sub, cur, kw)
                if n == 0:
                    states[(tag, name, 0)] = (cm, slb, sub, cur, kw)
                for k in ks:
                    ref = search_plain(cm, slb, sub, *cur, supersteps=k,
                                       **kw)
                    got = search_cuda(cm, slb, sub, *cur, supersteps=k,
                                      **kw)
                    torch.cuda.synchronize()
                    bad = search_diff(ref, got)
                    if bad:
                        fail(f"{tag} {name} from superstep {int(cur[2])}, "
                             f"K={k}: search_cuda differs from search_plain "
                             f"in {', '.join(bad)}")
                    max_err = max(max_err, max_abs_diff(ref, got))
                st0, stk = cur[0], ref[0]
                right = right_branch_lanes(stk)
                fails = max(fails, int(stk.n_fails.sum()))
                flipped = max(flipped, right)
                print(f"[{phase}] {tag} {name} from superstep {int(cur[2])} "
                      f"({int(st0.has_sol.sum())} lanes with a solution): "
                      f"K={','.join(map(str, ks))} equal on every "
                      f"field; after K={ks[-1]}: it={int(ref[2])} "
                      f"nodes={int(stk.n_nodes.sum())} "
                      f"fails={int(stk.n_fails.sum())} "
                      f"sols={int(stk.n_sols.sum())} gbest={int(ref[1])} "
                      f"head={ref[3].tolist()} stopped={bool(ref[4])} "
                      f"lanes in a right branch={right}")
            if must_search and not (fails and flipped):
                fail(f"{tag} {name}: the compared states hold {fails} "
                     f"failed nodes and {flipped} lanes in a right branch; "
                     f"this comparison needs both")
    search_cuda.launches = n0          # comparison launches are not counted
    return states, max_err


# --------------------------------------------------------------------------
# phases 13-16: the sparse AllDifferent and Cumulative banks
# --------------------------------------------------------------------------

def sparse_cases():
    """The sparse-layout models of phases 13-16 (the auto crossover picks
    the layout), each with its random stores and EPS pool."""
    from repro_torch.core.models import large_instance, nqueens, rcpsp

    def gen(n):
        return load("rcpsp", rcpsp.generate(n, n_resources=4, seed=SEED))
    made = {"J90": gen(90), "J120": gen(120),
            "jobshop20x15": load("jobshop",
                                 large_instance("jobshop", seed=SEED)),
            "nqueens64": load("nqueens", nqueens.generate(64, seed=SEED)),
            "nqueens256": load("nqueens",
                               large_instance("nqueens", seed=SEED))}
    out = {}
    for tag, c in made.items():
        if "sparse" not in (c.cm.ad_layout, c.cm.cu_layout):
            fail(f"{tag}: compiled to the dense layouts")
        out[tag] = prepare(13, tag, c, MAIN_EPS)
    return out


def phase_sparse_vs_dense():
    """A J30-class instance compiled sparse against its dense compile,
    both through `fixpoint_cuda`, on 1024 random stores at every cap:
    equal failed masks, non-failed stores, sweeps and convergence."""
    import numpy as np
    import torch
    from repro_torch.core.models import rcpsp
    from repro_torch.kernels.fixpoint_kernel import fixpoint_cuda
    from repro_torch.testing import random_substores
    m, _ = rcpsp.build_model(rcpsp.generate(30, n_resources=4, seed=SEED))
    dense, sparse = (m.compile(device="cuda", bank_layout=lay)
                     for lay in ("dense", "sparse"))
    print(f"[13] J30 dense: {describe(dense)}; sparse: {describe(sparse)}")
    lbs, ubs = random_substores(np.random.default_rng(SEED), dense,
                                N_RANDOM)
    lb, ub = torch.from_numpy(lbs).cuda(), torch.from_numpy(ubs).cuda()
    n0 = fixpoint_cuda.launches
    for cap in CAPS:
        dl, du, dsw, dconv = fixpoint_cuda(dense, lb, ub, max_sweeps=cap)
        sl, su, ssw, sconv = fixpoint_cuda(sparse, lb, ub, max_sweeps=cap)
        torch.cuda.synchronize()
        failed = (dl > du).any(1)
        ok = ~failed
        if not (torch.equal(failed, (sl > su).any(1))
                and torch.equal(dl[ok], sl[ok])
                and torch.equal(du[ok], su[ok])
                and torch.equal(dsw, ssw) and torch.equal(dconv, sconv)):
            fail(f"J30 max_sweeps={cap}: the sparse compile differs from "
                 "the dense one on the card")
        print(f"[13] J30 sparse == dense on the card, max_sweeps={cap}: "
              f"{int(ok.sum())} non-failed stores equal, "
              f"{int(failed.sum())} failed in both, sweeps and flags equal")
    fixpoint_cuda.launches = n0        # comparison launches are not counted


def phase_sparse_search(cases):
    """Phase 14: `search_cuda` against `search_plain` on J120 (prove; also
    around its first solution, where lanes fail and backtrack), N-queens
    64 at K = 1, 4, 16 and N-queens 256 at K = 4 (min_dom/split).
    Returns the starts after WARM_STEPS and the max |err|."""
    split = (("min_dom/split", "prove", ("min_dom", "split")),)
    states, err = {}, 0
    for tag, variants, around_first, ks in (
            ("J120", (("prove", "prove", None),), True, SEARCH_K),
            ("nqueens64", split, False, SEARCH_K),
            ("nqueens256", split, False, (4,))):
        st, e = phase_search_vs_plain(14, {tag: cases[tag]},
                                      {tag: MAIN_LANES}, variants,
                                      around_first, ks=ks)
        states.update(st)
        err = max(err, e)
    return states, err


def phase_sparse_main_path(cases):
    """Phase 15: J120, J90 and rcpsp-96 proved on both backends, N-queens
    256 on both under NQ256_CAP, then long on `cuda_resident`.  Returns
    the launches by (tag, run)."""
    from repro_torch.core.models import large_instance
    launches = {}
    rc96 = load("rcpsp", large_instance("rcpsp", seed=SEED))
    print(f"[15] rcpsp96: {describe(rc96.cm)}")
    for tag, c in (("J120", cases["J120"]), ("J90", cases["J90"]),
                   ("rcpsp96", rc96)):
        got = {}
        for backend in ("cuda", "cuda_resident"):
            got[backend], launches[(tag, backend)] = solve_case(
                15, tag, c, main_config(backend), SPARSE_OPTIMUM[tag])
        same_counters(15, tag, got)
    c = cases["nqueens256"]
    got = {}
    for backend in ("cuda", "cuda_resident"):
        got[backend], launches[("nqueens256", backend)] = solve_case(
            15, "nqueens256", c, main_config(backend, NQ256_STRATEGY,
                                             max_supersteps=NQ256_CAP))
    same_counters(15, "nqueens256", got)
    _, launches[("nqueens256", "long")] = solve_case(
        15, "nqueens256", c, main_config(
            "cuda_resident", NQ256_STRATEGY, max_supersteps=ZOO_LONG_CAP,
            timeout_s=NQ256_LONG_TIMEOUT_S))
    return launches


def phase_sparse_times(card, peak_int32, cases, states):
    """Phase 16: both kernels at the J120 and N-queens-256 shapes."""
    for tag, what in (("J120", "J120 random stores of phase 13"),
                      ("nqueens256", "N-queens 256 stores of phase 13")):
        c = cases[tag]
        time_fixpoint(card, peak_int32, c.cm, c.lbs, c.ubs, "16", what,
                      plain_reps=1)
    time_search(card, peak_int32, states[("J120", "prove")], "16",
                "J120, prove", plain_reps=1, plain_warmup=0)
    time_search(card, peak_int32, states[("nqueens256", "min_dom/split")],
                "16", "N-queens 256, min_dom/split", plain_reps=1,
                plain_warmup=0)


# --------------------------------------------------------------------------
# phases 17-20: the Compact-Table bank, the bitset store and middle_out
# --------------------------------------------------------------------------

def table_cases():
    """The table models of phases 17-20: crossword and configuration at
    the small, bench and large tiers and the wide-table model (tables of
    more than 32 tuples), each with its random stores and bitset stores
    and its EPS pool."""
    from repro_torch.core.model import Model
    from repro_torch.core.models import (bench_instance, large_instance,
                                         small_instance)
    from repro_torch.testing import wide_table_model
    out = {}
    for name in ("crossword", "configuration"):
        for tier, make in (("small", small_instance),
                           ("bench", bench_instance),
                           ("large", large_instance)):
            out[f"{name}_{tier}"] = prepare(
                17, f"{name} {tier}", load(name, make(name, seed=SEED)),
                MAIN_EPS)
    wide = wide_table_model(Model, seed=SEED).compile(device="cuda")
    if wide.ct_words != 2:
        fail(f"the wide-table model has ct_words {wide.ct_words}, not 2")
    out["wide_table"] = prepare(17, "wide table", Case(
        None, None, None, wide, None, None, None), MAIN_EPS)
    return out


def phase_table_vs_plain(cases):
    """`fixpoint_cuda` against `fixpoint_batch` on each table model's
    random stores and EPS pool, with the bitset store carried (random
    words; the pool's range words) and transient, at every cap of CAPS.
    Returns the max |err|."""
    import numpy as np
    import torch
    from repro_torch.core.bitset import np_from_bounds
    max_err = 0
    for tag, c in cases.items():
        cm = c.cm
        off = cm.dom_off.cpu().numpy()
        track = cm.dom_track.cpu().numpy()
        batches = [("random", c.lbs, c.ubs, c.doms)]
        plb, pub = c.pool
        for i in range(0, plb.shape[0], N_RANDOM):
            bl, bu = plb[i:i + N_RANDOM], pub[i:i + N_RANDOM]
            batches.append((f"pool[{i}:{i + N_RANDOM}]", bl, bu,
                            np_from_bounds(bl, bu, off, cm.n_words,
                                           track=track)))
        for cap in CAPS:
            for mode in ("carried", "transient"):
                lanes = whole = wiped = 0
                sweeps = []
                for name, bl, bu, bd in batches:
                    lb = torch.from_numpy(bl).cuda()
                    ub = torch.from_numpy(bu).cuda()
                    dom = (torch.from_numpy(bd.view(np.int32)).cuda()
                           if mode == "carried" else None)
                    err, same, sw, failed = compare(
                        cm, lb, ub, cap,
                        f"{tag} {name} {mode} max_sweeps={cap}", dom)
                    if name == "random":
                        wiped = int(failed[:N_WIPE].sum())
                    max_err = max(max_err, err)
                    lanes += lb.shape[0]
                    whole += int(same)
                    sweeps.append(sw)
                sw = torch.cat(sweeps)
                print(f"[17] {tag} {mode} max_sweeps={cap}: {lanes} lanes "
                      f"equal (failed masks, stores, words, sweeps, "
                      f"converged); {whole}/{len(batches)} batches equal in "
                      f"every output; sweeps mean "
                      f"{sw.float().mean().item():.2f} max {int(sw.max())};"
                      f" {wiped}/{N_WIPE} interior-wipe stores failed")
    return max_err


def phase_table_search(tcases, zoo):
    """Phase 18: `search_cuda` against `search_plain` with the bitset
    store on crossword and configuration large (prove, and
    min_lb/middle_out), from their EPS pool (the main path's 2
    subproblems) and from a pool of their N_RANDOM random stores, where
    every lane searches, fails and backtracks (the shared bound ends the
    search within 4 supersteps, so the second start is after
    RANDOM_WARM); and on N-queens 32 and coloring 64
    (min_dom/middle_out).  Returns the starts and the max |err|."""
    big = {t: tcases[t] for t in ("crossword_large", "configuration_large")}
    states, err = phase_search_vs_plain(
        18, big, dict.fromkeys(big, MAIN_LANES), TABLE_VARIANTS, False)
    rand = {f"{t} random pool": c._replace(pool=(c.lbs, c.ubs))
            for t, c in big.items()}
    more, err2 = phase_search_vs_plain(
        18, rand, dict.fromkeys(rand, MAIN_LANES), TABLE_VARIANTS, False,
        must_search=True, warm=RANDOM_WARM)
    states.update(more)
    mo = {t: zoo[t] for t in ("nqueens32", "coloring64")}
    more, err3 = phase_search_vs_plain(
        18, mo, dict.fromkeys(mo, MAIN_LANES),
        (("min_dom/middle_out", "prove", MIDDLE_OUT),), False)
    states.update(more)
    return states, max(err, err2, err3)


def phase_table_main_path(tcases, zoo, rcpsp):
    """Phase 19: crossword and configuration large proved through both
    backends; N-queens 32 under min_dom/middle_out through both under
    ZOO_CAP; J30 under middle_out through both equal to its split
    solve.  Returns the launches by (tag, run)."""
    from repro_torch.solver import SolveConfig
    launches = {}
    for name in ("crossword", "configuration"):
        tag = f"{name}_large"
        got = {}
        for backend in ("cuda", "cuda_resident"):
            got[backend], launches[(tag, backend)] = solve_case(
                19, tag, tcases[tag], main_config(backend),
                TABLE_OPTIMUM[name])
        same_counters(19, tag, got)
    got = {}
    for backend in ("cuda", "cuda_resident"):
        got[backend], launches[("nqueens32 middle_out", backend)] = \
            solve_case(19, "nqueens32", zoo["nqueens32"],
                       main_config(backend, MIDDLE_OUT,
                                   max_supersteps=ZOO_CAP))
    same_counters(19, "nqueens32 min_dom/middle_out", got)
    got = {}
    for backend, val in (("cuda", "split"), ("cuda", "middle_out"),
                         ("cuda_resident", "middle_out")):
        got[f"{backend} {val}"], launches[(f"J30 {val}", backend)] = \
            solve_case(19, "J30", rcpsp["J30"], SolveConfig.preset(
                "prove", backend=backend, n_lanes=J30_LANES,
                val_strategy=val))
    same_counters(19, "J30 middle_out against split", got)
    return launches


def phase_table_times(card, peak_int32, tcases, states):
    """Phase 20: both kernels at the large table models' shapes (the
    fixpoint with and without a carried store; the search from fresh
    lanes on the EPS pool, which solves within one launch, and on the
    random pool, where every lane searches) and on N-queens 32 under
    min_dom/middle_out (after WARM_STEPS)."""
    for name in ("configuration", "crossword"):
        tag = f"{name}_large"
        c = tcases[tag]
        time_fixpoint(card, peak_int32, c.cm, c.lbs, c.ubs, "20",
                      f"{name} large random stores, bitset store carried",
                      doms=c.doms)
        time_fixpoint(card, peak_int32, c.cm, c.lbs, c.ubs, "20",
                      f"{name} large random stores, transient")
        for variant, _, _ in TABLE_VARIANTS:
            time_search(card, peak_int32, states[(tag, variant, 0)], "20",
                        f"{name} large, {variant}, EPS pool, fresh lanes")
            time_search(card, peak_int32,
                        states[(f"{tag} random pool", variant, 0)], "20",
                        f"{name} large, {variant}, random pool, fresh lanes")
    time_search(card, peak_int32, states[("nqueens32", "min_dom/middle_out")],
                "20", "N-queens 32, min_dom/middle_out")


# --------------------------------------------------------------------------
# phases 21-25: int64 models in both kernels, and lane tiles
# --------------------------------------------------------------------------

def int64_cases():
    """The int64 models of phases 21-25: the J120 class with every
    duration × INT64_SCALE (sparse Cumulative by the crossover), the J60
    class compiled with force_dtype="int64" in the dense layout (the
    values of the int32 J60, so its search must be the same), and a
    two-term row whose products pass 2³¹; each with its random stores
    and, the first two, their EPS pools."""
    import dataclasses
    from repro_torch.core.model import Model
    from repro_torch.core.models import rcpsp
    inst = rcpsp.generate(120, n_resources=4, seed=SEED)
    wide = Model("wide")
    x, y = wide.int_var(0, 10 ** 8), wide.int_var(0, 10 ** 8)
    wide.add(1000 * x + 1000 * y <= 10 ** 9)
    made = {
        "J120x1e7": (load("rcpsp", dataclasses.replace(
            inst, durations=inst.durations * INT64_SCALE)), MAIN_EPS),
        "J60int64": (load("rcpsp", rcpsp.generate(60, n_resources=4,
                                                  seed=SEED),
                          force_dtype="int64", bank_layout="dense"),
                     MAIN_EPS),
        "wide": (Case(None, None, None, wide.compile(device="cuda"), None,
                      None, None), None)}
    out = {}
    for tag, (c, target) in made.items():
        if c.cm.dtype != "int64":
            fail(f"{tag}: compiled to {c.cm.dtype}, not int64")
        out[tag] = prepare(21, tag, c, target)
    return out


def phase_int64_search(cases):
    """Phase 22: `search_cuda` against `search_plain` at int64 on J120 ×
    10⁷ and J60 int64 (1024 lanes, prove, K = 1, 4, 16), from fresh lanes
    and after 5 supersteps, and on J120 × 10⁷ also 8 before and after the
    first solution (failed nodes and backtracks required).  Returns the
    starts and the max |err|."""
    prove = (("prove", "prove", None),)
    states, err = phase_search_vs_plain(
        22, {"J120x1e7": cases["J120x1e7"]}, {"J120x1e7": MAIN_LANES}, prove,
        True, must_search=True)
    st, e = phase_search_vs_plain(22, {"J60int64": cases["J60int64"]},
                                  {"J60int64": MAIN_LANES}, prove, False)
    states.update(st)
    return states, max(err, e)


def phase_int64_main_path(cases, j60):
    """Phase 23: J120 × 10⁷ and J60 int64 through `cuda` and
    `cuda_resident`: equal counters on both, J120 × 10⁷ at the scaled
    optimum, J60 int64 with every counter of the int32 J60 (`j60`, phase
    3).  Returns the launches by (tag, backend)."""
    launches = {}
    want = {"J120x1e7": SPARSE_OPTIMUM["J120"] * INT64_SCALE,
            "J60int64": J60_OPTIMUM}
    for tag in ("J120x1e7", "J60int64"):
        got = {}
        for backend in ("cuda", "cuda_resident"):
            got[backend], launches[(tag, backend)] = solve_case(
                23, tag, cases[tag], main_config(backend), want[tag])
        same_counters(23, tag, got, {k: getattr(j60, k) for k in COUNTERS}
                      if tag == "J60int64" else None)
    return launches


def phase_lane_tiles(rcpsp, zoo, int64, j60_resident):
    """Phase 24: `search_cuda` against `search_plain` in lane tiles of
    TILES on J60 (prove; in tiles of MAIN_TILE also 8 supersteps before
    and after the first solution, failed nodes and backtracks required)
    and N-queens 32
    (min_dom/split), 1024 lanes, K = 1 and 16, from fresh lanes and after
    5 supersteps, and in tiles of MAIN_TILE on J60 int64; then the J60 `cuda_resident` solve in tiles of
    MAIN_TILE, which must prove 82 with a launch per K supersteps.
    Returns the starts by (tag, variant, tile), the max |err| and the
    tiled solve's search_cuda launches."""
    states, err = {}, 0
    split = (("min_dom/split", "prove", ("min_dom", "split")),)
    prove = (("prove", "prove", None),)
    runs = [(t, "J60", rcpsp["J60"], prove, t == MAIN_TILE) for t in TILES]
    runs += [(t, "nqueens32", zoo["nqueens32"], split, False) for t in TILES]
    runs += [(MAIN_TILE, "J60int64", int64["J60int64"], prove, False)]
    for tile, tag, c, variants, around_first in runs:
        st, e = phase_search_vs_plain(24, {tag: c}, {tag: MAIN_LANES},
                                      variants, around_first,
                                      ks=(1, MAIN_K),
                                      must_search=around_first,
                                      lane_tile=tile)
        states.update({k + (tile,): v for k, v in st.items()})
        err = max(err, e)
    res, (_, launches) = solve_case(
        24, "J60", rcpsp["J60"], main_config("cuda_resident",
                                             lane_tile=MAIN_TILE),
        J60_OPTIMUM)
    print(f"[24] J60 cuda_resident, lane tiles of {MAIN_TILE}: "
          f"nodes={res.n_nodes} supersteps={res.n_supersteps} "
          f"launches={launches}; one queue (phase 6): "
          f"nodes={j60_resident.n_nodes} "
          f"supersteps={j60_resident.n_supersteps}")
    # a small solve whose trajectory the tiles change: the card's tiled
    # solve equals the plain one on the CPU and differs from one queue
    from repro_torch.solver import SolveConfig, Solver
    cfg = SolveConfig.preset("prove", backend="cuda_resident",
                             n_lanes=J30_TILED[0], eps_target=J30_TILED[1],
                             lane_tile=J30_TILED[2])
    c = rcpsp["J30"]
    card = solve_case(24, "J30", c, cfg, J30_REFERENCE["objective"])[0]
    cpu = Solver(cfg.replace(device="cpu")).solve(c.cm.to("cpu"))
    queue = solve_case(24, "J30", c, cfg.replace(lane_tile=None))[0]
    same_counters(24, f"J30 in lane tiles of {J30_TILED[2]}",
                  {"card": card, "plain on the CPU": cpu})
    if all(getattr(card, k) == getattr(queue, k) for k in COUNTERS):
        fail("J30: the lane-tiled solve's counters equal one queue's")
    print(f"[24] J30 one queue: nodes={queue.n_nodes} "
          f"supersteps={queue.n_supersteps}; tiles: nodes={card.n_nodes} "
          f"supersteps={card.n_supersteps}")
    return states, err, launches


def phase_int64_times(card, peak_int32, sparse, sp_states, int64,
                      i64_states, states, tile_states):
    """Phase 25: both kernels at int64 against int32 at the J120 shape
    ([1024, 122]: random stores of phases 13 and 21; K=16 after 5
    supersteps), and `search_cuda` at J60 in lane tiles of MAIN_TILE
    against one queue.  Returns the times of the int64 and lane-tile
    modes: (fixpoint int64, search int64, search tiles), each (ms, plain
    ms, bound ms, bound_by)."""
    c = sparse["J120"]
    time_fixpoint(card, peak_int32, c.cm, c.lbs, c.ubs, "25",
                  "J120 random stores", plain_reps=1)
    c = int64["J120x1e7"]
    fix64 = time_fixpoint(card, peak_int32, c.cm, c.lbs, c.ubs, "25",
                          "J120 x 1e7 random stores", plain_reps=1)
    time_search(card, peak_int32, sp_states[("J120", "prove")], "25",
                "J120, prove", plain_reps=1, plain_warmup=0)
    srch64 = time_search(card, peak_int32, i64_states[("J120x1e7", "prove")],
                         "25", "J120 x 1e7, prove", plain_reps=1,
                         plain_warmup=0)
    time_search(card, peak_int32, states[("J60", "prove")], "25",
                "J60, prove")
    tiles = time_search(card, peak_int32,
                        tile_states[("J60", "prove", MAIN_TILE)], "25",
                        "J60, prove")
    return fix64, srch64, tiles


def mode_entry(base, mode, launches, err, times):
    """A {"kernels": [...]} entry of one kernel mode: `base`'s name,
    route, source and bank list, this mode's launches, max |err| and
    times."""
    ms, plain_ms, bound_ms, bound_by = times
    return dict(base, name=f"{base['name']} ({mode})", mode=mode,
                launches=launches, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def main():
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run from the "
              "root of a checkout of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this run "
              "needs a CUDA GPU", file=sys.stderr)
        return 2
    t0 = time.time()

    def timed(phase, fn, *args):
        t = time.time()
        out = fn(*args)
        print(f"[{phase}] phase {phase} took {time.time() - t:.1f} s")
        return out

    card, peak_int32 = timed(1, phase_card_and_build)
    rcpsp, max_err = timed(2, checked_cases, 2, rcpsp_cases)
    launches, cuda_res = timed(3, phase_main_path, rcpsp)
    kernels = timed(4, phase_times, card, peak_int32, rcpsp, launches,
                    max_err)
    states, search_err = timed(5, phase_search_vs_plain, 5, rcpsp,
                               {"J30": 256, "J60": MAIN_LANES},
                               RCPSP_VARIANTS, True)
    search_launches, resident_res = timed(6, phase_resident_path, rcpsp,
                                          cuda_res)
    kernels.append(timed(7, phase_search_times, card, peak_int32,
                         states[("J60", "prove")], search_launches,
                         search_err))
    zoo, ad_err = timed(8, checked_cases, 8, zoo_cases)
    searched = {t: zoo[t] for t in ZOO_STRATEGY}
    ad_states, ad_search_err = timed(
        9, phase_search_vs_plain, 9, searched,
        dict.fromkeys(searched, MAIN_LANES), ZOO_VARIANTS, False)
    zoo_launches, long = timed(10, phase_zoo_main_path, zoo)
    timed(11, phase_zoo_smoke)
    timed(12, phase_alldiff_times, card, peak_int32, zoo, ad_states, long)
    sparse, sp_err = timed(13, checked_cases, 13, sparse_cases)
    timed(13, phase_sparse_vs_dense)
    sp_states, sp_search_err = timed(14, phase_sparse_search, sparse)
    sp_launches = timed(15, phase_sparse_main_path, sparse)
    timed(16, phase_sparse_times, card, peak_int32, sparse, sp_states)
    tables = timed(17, table_cases)
    ct_err = timed(17, phase_table_vs_plain, tables)
    ct_states, ct_search_err = timed(18, phase_table_search, tables, zoo)
    ct_launches = timed(19, phase_table_main_path, tables, zoo, rcpsp)
    timed(20, phase_table_times, card, peak_int32, tables, ct_states)
    int64, i64_err = timed(21, checked_cases, 21, int64_cases, 1)
    i64_states, i64_search_err = timed(22, phase_int64_search, int64)
    i64_launches = timed(23, phase_int64_main_path, int64, cuda_res)
    tile_states, tile_err, tile_launches = timed(
        24, phase_lane_tiles, rcpsp, zoo, int64, resident_res)
    fix64, srch64, tiled = timed(25, phase_int64_times, card, peak_int32,
                                 sparse, sp_states, int64, i64_states,
                                 states, tile_states)
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], ad_err,
                                    sp_err, ct_err)
    kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"],
                                    ad_search_err, sp_search_err,
                                    ct_search_err)
    for k in kernels:
        k["banks"] = list(BANKS)
    kernels[0]["mode"] = "int32"
    kernels[1]["mode"] = "int32, one queue"
    kernels += [
        mode_entry(kernels[0], "int64", i64_launches[("J120x1e7", "cuda")][0],
                   i64_err, fix64),
        mode_entry(kernels[1], "int64, one queue",
                   i64_launches[("J120x1e7", "cuda_resident")][1],
                   i64_search_err, srch64),
        mode_entry(kernels[1], f"int32, lane tiles of {MAIN_TILE}",
                   tile_launches, tile_err, tiled)]
    print("kernels: int64 main-path launches (fixpoint_cuda, search_cuda): "
          + ", ".join(f"{t} {b} {n}" for (t, b), n in i64_launches.items())
          + f"; lane-tiled J60 search_cuda launches {tile_launches}")
    print("kernels: zoo main-path launches (fixpoint_cuda, search_cuda): "
          + ", ".join(f"{t} {b} {n}" for (t, b), n in zoo_launches.items()))
    print("kernels: sparse main-path launches (fixpoint_cuda, "
          "search_cuda): " + ", ".join(
              f"{t} {b} {n}" for (t, b), n in sp_launches.items()))
    print("kernels: table and middle_out main-path launches (fixpoint_cuda,"
          " search_cuda): " + ", ".join(
              f"{t} {b} {n}" for (t, b), n in ct_launches.items()))
    print(f"chip_smoke: all phases passed in {time.time() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
