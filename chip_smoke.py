#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # from the repository root

Phases, in order; any error or mismatch ends the run with a non-zero
exit code and no result line:

1. card and build: the card line of ``nvidia-smi``, torch and CUDA
   versions; ``nvcc`` builds ``kernels/csrc/fixpoint.cu`` and
   ``kernels/csrc/search.cu`` for sm_90a, both at once, and their
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
   supersteps and nodes must equal the solve's).

The last lines are the card line, a ``{"kernels": [...]}`` JSON line and
``{"ok": true, "device": {...}}``.  Without a usable GPU, or without the
repository around it, the script fails before it prints any result.
"""

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
FIXPOINT_SOURCE = "src/repro_torch/kernels/csrc/fixpoint.cu"
FIXPOINT_REPLACES = "src/repro/kernels/fixpoint_kernel.py:285"
SEARCH_SOURCE = "src/repro_torch/kernels/csrc/search.cu"
SEARCH_REPLACES = "src/repro/kernels/fixpoint_kernel.py:520"
# phases 5-7 and 9: the resident search kernel
SEARCH_K = (1, 4, 16)
WARM_STEPS = 5             # plain supersteps before the second start
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
ZOO_SMOKE = ("rcpsp", "nqueens", "coloring", "knapsack", "jobshop")
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
}

# One model of the run: the zoo module, instance and handles (for the
# ground check), the compiled model on the card, its random stores and
# its EPS pool (None where no phase needs them).
Case = namedtuple("Case", "mod inst handles cm lbs ubs pool")


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi(query):
    """First line of ``nvidia-smi --query-gpu=<query>`` (csv, no header)."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def load(name, inst):
    """The Case of one zoo instance, compiled onto the card."""
    from repro_torch.core.models import ZOO
    mod = ZOO[name]
    m, handles = mod.build_model(inst)
    return Case(mod, inst, handles, m.compile(device="cuda"), None, None,
                None)


def describe(cm):
    s = f"V={cm.n_vars} P={cm.n_props} K={cm.k_terms} D={cm.d_occ}"
    if cm.n_cumulative:
        s += (f" C={cm.n_cumulative} T={cm.cu_width} Dcu={cm.cu_docc} "
              f"horizon={cm.horizon} cu_layout={cm.cu_layout}")
    if cm.n_alldiff:
        s += (f" A={cm.n_alldiff} N={cm.ad_width} Dad={cm.ad_docc} "
              f"ad_layout={cm.ad_layout}")
    return f"{s} {cm.dtype}"


def prepare(phase, tag, case, eps_target=None):
    """`case` with N_RANDOM random stores (with an AllDifferent bank, the
    first N_PIGEONHOLE of them overfull) and, given `eps_target`, the EPS
    pool decomposed to it."""
    import numpy as np
    from repro_torch.core import eps
    from repro_torch.solver import SolveConfig
    from repro_torch.testing import pigeonhole_stores, random_substores
    cm = case.cm
    rng = np.random.default_rng(SEED)
    lbs, ubs = random_substores(rng, cm, N_RANDOM)
    if cm.n_alldiff:
        lbs[:N_PIGEONHOLE], ubs[:N_PIGEONHOLE] = pigeonhole_stores(
            rng, cm, lbs, ubs, N_PIGEONHOLE)
    pool, msg = None, ""
    if eps_target:
        opts = SolveConfig.preset("prove", backend="cuda").search_options()
        t0 = time.perf_counter()
        pool = eps.decompose(cm, eps_target, opts)
        msg = (f"; EPS pool {pool[0].shape[0]} subproblems in "
               f"{time.perf_counter() - t0:.2f} s")
    print(f"[{phase}] {tag}: {describe(cm)}{msg}")
    return case._replace(lbs=lbs, ubs=ubs, pool=pool)


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
    for built in build.build_all(["fixpoint", "search"]):
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

def compare(cm, lb, ub, cap, what):
    """Kernel vs plain version on one batch; returns (max_abs_err over
    non-failed stores, whole-output equality, sweeps, failed mask)."""
    import torch
    from repro_torch.core import fixpoint as F
    from repro_torch.kernels.fixpoint_kernel import fixpoint_cuda
    ref = F.fixpoint_batch(cm, lb, ub, max_iters=cap)
    got = fixpoint_cuda(cm, lb, ub, max_sweeps=cap)
    torch.cuda.synchronize()
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
    whole = torch.equal(rlb, glb) and torch.equal(rub, gub)
    return err, whole, rsw, rfail


def phase_kernel_vs_plain(phase, cases):
    """`fixpoint_cuda` against `fixpoint_batch` on each case's random
    stores and EPS pool at every cap of CAPS; the overfull stores of an
    AllDifferent model must fail uncapped.  Returns the max |err|."""
    import torch
    max_err = 0
    for tag, c in cases.items():
        batches = [("random", c.lbs, c.ubs)]
        if c.pool is not None:
            plb, pub = c.pool
            batches += [(f"pool[{i}:{i + N_RANDOM}]", plb[i:i + N_RANDOM],
                         pub[i:i + N_RANDOM])
                        for i in range(0, plb.shape[0], N_RANDOM)]
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


def checked_cases(phase, make):
    """The cases `make()` returns, held by `phase_kernel_vs_plain`."""
    cases = make()
    return cases, phase_kernel_vs_plain(phase, cases)


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
    return SolveConfig.preset("prove", backend=backend, n_lanes=MAIN_LANES,
                              eps_target=MAIN_EPS, timeout_s=MAIN_TIMEOUT_S,
                              **kw)


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
    return launches


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


def table_bytes(cm):
    """Bytes of the propagator tables the kernels read."""
    from repro_torch.kernels.fixpoint_kernel import kernel_tables
    return sum(t.numel() * t.element_size() for t in kernel_tables(cm))


def row_sizes(cm):
    """Members of each real AllDifferent row."""
    return cm.ad_mask[:cm.n_alldiff].sum(1).tolist() if cm.n_alldiff else []


def ops_per_sweep(cm):
    """The int32 work one fixpoint sweep of one lane needs: 8·P1·K for
    the linear bank and 2·V·D for its join; with a Cumulative bank,
    4·C1·T + 2·C1·H for the time-table (each task adds its compulsory
    part's two ends to a difference array, a prefix sum and a capacity
    compare per time point build the profile, and each task's first and
    last start take at least one operation each) and 2·V·Dcu for its
    join; with an AllDifferent bank, on each row of n members the lesser
    of two algorithms' work: a sorted Hall pass, 2·n·⌈log2 n⌉ compares to
    sort the members by lower and by upper bound and ALLDIFF_OPS per
    (upper endpoint, member) for the counts, the width tests and the
    pushes, or the endpoint-pair pass, PAIR_OPS·n³ (cheaper for n = 2);
    and 2·V·Dad for its join."""
    P1, K = cm.vidx.shape
    V = cm.n_vars
    ops = 8 * P1 * K + 2 * V * cm.d_occ
    if cm.n_cumulative:
        C1, T = cm.cu_svar.shape
        ops += 4 * C1 * T + 2 * C1 * cm.horizon + 2 * V * cm.cu_docc
    if cm.n_alldiff:
        ops += sum(min(2 * n * math.ceil(math.log2(n)) + ALLDIFF_OPS * n * n,
                       PAIR_OPS * n ** 3)
                   for n in row_sizes(cm) if n > 1) + 2 * V * cm.ad_docc
    return ops


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
    """The endpoint-pair algorithm's own work beside the bound."""
    if not cm.n_alldiff:
        return ""
    ops = lane_sweeps * pair_ops_per_sweep(cm)
    return (f"; the endpoint-pair algorithm's own AllDifferent work, every "
            f"pair: {ops} int32 ops ({ops / peak_int32 * 1e3:.5f} ms)")


def time_fixpoint(card, peak_int32, cm, lbs, ubs, tag, what):
    """`fixpoint_cuda` and `fixpoint_batch` per launch (CUDA events) on
    ``[MAIN_LANES, V]`` stores, uncapped, beside the bound: each table
    and store read once and each output written once, over the HBM rate;
    the sweeps this run needed times `ops_per_sweep`, over the int32
    peak.  Returns (kernel ms, plain ms, bound ms, bound_by)."""
    import torch
    from repro_torch.core import fixpoint as F
    from repro_torch.kernels.fixpoint_kernel import fixpoint_cuda
    lb = torch.from_numpy(lbs[:MAIN_LANES]).cuda()
    ub = torch.from_numpy(ubs[:MAIN_LANES]).cuda()
    L, V = lb.shape
    n0 = fixpoint_cuda.launches
    ms = cuda_ms(lambda: fixpoint_cuda(cm, lb, ub), reps=50, warmup=5)
    plain_ms = cuda_ms(lambda: F.fixpoint_batch(cm, lb, ub), reps=5,
                       warmup=1)
    fixpoint_cuda.launches = n0            # timing launches are not counted
    sweeps = int(F.fixpoint_batch(cm, lb, ub)[2].sum())
    nbytes = table_bytes(cm) + 4 * L * V * 4 + 2 * L * 4
    ops = sweeps * ops_per_sweep(cm)
    bound_ms, bound_by = bound(nbytes, ops, peak_int32)
    live = (f"; {live_pair_share(cm, lb, ub):.1%} of the endpoint pairs "
            f"live in the input stores" if cm.n_alldiff else "")
    print(f"[{tag}] fixpoint at [{L}, {V}] ({what}, uncapped, {sweeps} "
          f"lane-sweeps): kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
          f"bound {bound_ms:.5f} ms ({bound_by}: {nbytes} B, {ops} int32 "
          f"ops at {peak_int32 / 1e12:.2f} T/s; kernel {ms / bound_ms:.0f}x "
          f"the bound){pair_note(cm, sweeps, peak_int32)}{live} on {card}")
    return ms, plain_ms, bound_ms, bound_by


def search_bound_ms(cm, start, out, peak_int32, launches=1):
    """Least time for the work of `launches` launches from `start` to
    `out`: the LaneState read once and written once per launch (bools one
    byte each) and the tables read once per launch, over the HBM rate;
    the sweeps they needed times `ops_per_sweep`, plus, per lane and live
    superstep, the commit's solved/failed checks (2·V) and branch
    selection (3·B), over the int32 peak.  Dispatch, the tells and
    backtracking are counted as nothing, so this is a lower bound."""
    st_in, st_out = start[0], out[0]
    L, V = st_in.lb.shape
    B = int(cm.branch_vars.shape[0])
    steps = int(out[2]) - int(start[2])
    sweeps = int(st_out.n_sweeps.long().sum() - st_in.n_sweeps.long().sum())
    state = sum(a.numel() * a.element_size() for a in st_in
                if a is not None)
    nbytes = launches * (2 * state + table_bytes(cm))
    ops = sweeps * ops_per_sweep(cm) + steps * L * (2 * V + 3 * B)
    return (*bound(nbytes, ops, peak_int32), nbytes, ops, steps, sweeps)


def time_search(card, peak_int32, timing_state, tag, what):
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
                       reps=2, warmup=1)
    search_cuda.launches = n0             # timing launches are not counted
    bound_ms, bound_by, nbytes, ops, steps, sweeps = search_bound_ms(
        cm, start, out, peak_int32)
    L = start[0].lb.shape[0]
    print(f"[{tag}] search at {L} lanes, K={MAIN_K} ({what}, from the state "
          f"after {WARM_STEPS}; {steps} live supersteps, {sweeps} "
          f"lane-sweeps): kernel {ms:.4f} ms per launch "
          f"({ms / max(steps, 1):.4f} ms per superstep), plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.5f} ms ({bound_by}: "
          f"{nbytes} B, {ops} int32 ops at {peak_int32 / 1e12:.2f} T/s; "
          f"kernel {ms / bound_ms:.0f}x the bound)"
          f"{pair_note(cm, sweeps, peak_int32)}; library: none "
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


def max_abs_diff(ref, got):
    """Largest |difference| over every LaneState field and the four
    scalars of two resident-launch results."""
    err = 0
    for a, b in zip(ref[0], got[0]):
        if a is not None and a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    for a, b in zip(ref[1:], got[1:]):
        err = max(err, abs(int(a) - int(b)))
    return err


def phase_search_vs_plain(phase, cases, lanes, variants, around_first):
    """`search_cuda` against `search_plain` on each case (`lanes[tag]`
    lanes, its EPS pool) under each variant, at every K of SEARCH_K,
    from fresh lanes, after WARM_STEPS plain supersteps and, with
    `around_first`, 8 supersteps before and after the first solution.
    Returns the starts after WARM_STEPS by (tag, variant name) and the
    max |err|."""
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
        starts, msg = [0, WARM_STEPS], ""
        if around_first:
            # the superstep that finds the first solution, from fresh lanes
            opts, kw = search_kwargs("first_solution")
            inputs = search_inputs(cm, L, None, opts, pool=c.pool)
            out = search_plain(cm, *inputs[:3], inputs[3], 0, inputs[4],
                               supersteps=FIRST_SOL_MAX, **kw)
            if not bool(out[4]):
                fail(f"{tag}: no solution in {FIRST_SOL_MAX} supersteps")
            first = int(out[2])
            starts = sorted({0, WARM_STEPS, max(first - 8, 0), first + 8})
            msg = f"; first solution at superstep {first}"
        print(f"[{phase}] {tag}: {L} lanes on {search_grid(cm, L)} CTAs "
              f"(cooperative grid), EPS pool {c.pool[0].shape[0]}{msg}; "
              f"starts after {', '.join(map(str, starts))} plain supersteps")
        for name, preset, strategy in variants:
            opts, kw = search_kwargs(preset, strategy)
            slb, sub, st, gbest, head = search_inputs(cm, L, None, opts,
                                                      pool=c.pool)
            cur, done_steps = (st, gbest, 0, head), 0
            for n in starts:
                if n > done_steps:
                    cur = search_plain(cm, slb, sub, *cur,
                                       supersteps=n - done_steps, **kw)[:4]
                    done_steps = n
                if n == WARM_STEPS:
                    states[(tag, name)] = (cm, slb, sub, cur, kw)
                for k in SEARCH_K:
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
                print(f"[{phase}] {tag} {name} from superstep {int(cur[2])} "
                      f"({int(st0.has_sol.sum())} lanes with a solution): "
                      f"K={','.join(map(str, SEARCH_K))} equal on every "
                      f"field; after K={SEARCH_K[-1]}: it={int(ref[2])} "
                      f"nodes={int(stk.n_nodes.sum())} "
                      f"fails={int(stk.n_fails.sum())} "
                      f"sols={int(stk.n_sols.sum())} gbest={int(ref[1])} "
                      f"head={int(ref[3])} stopped={bool(ref[4])}")
    search_cuda.launches = n0          # comparison launches are not counted
    return states, max_err


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
    search_launches = timed(6, phase_resident_path, rcpsp, cuda_res)
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
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], ad_err)
    kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"],
                                    ad_search_err)
    print("kernels: zoo main-path launches (fixpoint_cuda, search_cuda): "
          + ", ".join(f"{t} {b} {n}" for (t, b), n in zoo_launches.items()))
    print(f"chip_smoke: all phases passed in {time.time() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
