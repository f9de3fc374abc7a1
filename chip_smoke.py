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
   eps_target=4096))``, with the kernel's launch counter set to 0 just
   before and read just after; the solution is ground-checked and the
   optimum held against the JAX package's; a J30-class instance solved
   with ``backend="cuda"`` and ``backend="gather"`` on the card must give
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
   after 5 supersteps), beside the least time the card could take.

The last lines are the card line, a ``{"kernels": [...]}`` JSON line and
``{"ok": true, "device": {...}}``.  Without a usable GPU, or without the
repository around it, the script fails before it prints any result.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SEED = 0
N_RANDOM = 1024            # random stores per model in phase 2
CAPS = (1, 4, None)        # max_sweeps of phase 2 (None: uncapped)
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
# phases 5-7: the resident search kernel
SEARCH_PRESETS = ("prove", "fast", "first_solution")
SEARCH_K = (1, 4, 16)
WARM_STEPS = 5             # plain supersteps before the second start
FIRST_SOL_MAX = 512        # cap on the search for the first solution
J30_SEARCH_LANES = 256
MAIN_K = 16                # supersteps per launch on the main path
COUNTERS = ("status", "objective", "n_nodes", "n_fails", "n_sols",
            "n_sweeps", "n_supersteps")


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi(query):
    """First line of ``nvidia-smi --query-gpu=<query>`` (csv, no header)."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def rcpsp_model(n_tasks, device="cuda"):
    from repro_torch.core.models import rcpsp
    inst = rcpsp.generate(n_tasks, n_resources=4, seed=SEED)
    m, handles = rcpsp.build_model(inst)
    return inst, handles, m.compile(device=device)


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
# phase 2: kernel against its plain version
# --------------------------------------------------------------------------

def compare(cm, lb, ub, cap, what):
    """Kernel vs plain version on one batch; returns (max_abs_err over
    non-failed stores, whole-output equality)."""
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
    return err, whole, rsw


def phase_kernel_vs_plain():
    import numpy as np
    import torch
    from repro_torch.core import eps
    from repro_torch.solver import SolveConfig
    from repro_torch.testing import random_substores
    out = {}
    max_err = 0
    for tag, n_tasks, target in (("J30", 30, 1024), ("J60", 60, MAIN_EPS)):
        _, _, cm = rcpsp_model(n_tasks)
        lbs, ubs = random_substores(np.random.default_rng(SEED), cm,
                                    N_RANDOM)
        opts = SolveConfig.preset("prove", backend="cuda").search_options()
        t0 = time.perf_counter()
        plb, pub = eps.decompose(cm, target, opts)
        eps_s = time.perf_counter() - t0
        print(f"[2] {tag}: V={cm.n_vars} P={cm.n_props} K={cm.k_terms} "
              f"D={cm.d_occ} C={cm.n_cumulative} T={cm.cu_width} "
              f"Dcu={cm.cu_docc} horizon={cm.horizon} {cm.dtype} "
              f"cu_layout={cm.cu_layout}; EPS pool {plb.shape[0]} "
              f"subproblems in {eps_s:.2f} s")
        batches = [("random", lbs, ubs)] + [
            (f"pool[{i}:{i + N_RANDOM}]", plb[i:i + N_RANDOM],
             pub[i:i + N_RANDOM]) for i in range(0, plb.shape[0], N_RANDOM)]
        for cap in CAPS:
            lanes = whole = 0
            sweeps = []
            for name, bl, bu in batches:
                lb = torch.from_numpy(bl).cuda()
                ub = torch.from_numpy(bu).cuda()
                err, same, sw = compare(cm, lb, ub, cap,
                                        f"{tag} {name} max_sweeps={cap}")
                max_err = max(max_err, err)
                lanes += lb.shape[0]
                whole += int(same)
                sweeps.append(sw)
            sw = torch.cat(sweeps)
            print(f"[2] {tag} max_sweeps={cap}: {lanes} lanes equal "
                  f"(failed masks, stores, sweeps, converged); "
                  f"{whole}/{len(batches)} batches equal in every store; "
                  f"sweeps mean {sw.float().mean().item():.2f} "
                  f"max {int(sw.max())}")
        out[tag] = (cm, lbs, ubs, plb, pub)
    return out, max_err


# --------------------------------------------------------------------------
# phase 3: the main path
# --------------------------------------------------------------------------

def solve(n_tasks, cfg):
    from repro_torch.core.models import rcpsp
    from repro_torch.solver import Solver
    inst, handles, cm = rcpsp_model(n_tasks)
    res = Solver(cfg).solve(cm)
    if res.solution is None:
        fail(f"J{n_tasks} ({cfg.backend}): no solution, status {res.status}")
    starts = [int(res.solution[v.idx]) for v in handles["s"]]
    feasible, makespan = rcpsp.check_solution(inst, starts)
    if not feasible or makespan != res.objective:
        fail(f"J{n_tasks} ({cfg.backend}): solution fails the ground check "
             f"(feasible={feasible}, makespan {makespan}, objective "
             f"{res.objective})")
    return res


def phase_main_path():
    import torch
    from repro_torch.kernels.fixpoint_kernel import fixpoint_cuda
    from repro_torch.solver import SolveConfig
    cfg = SolveConfig.preset("prove", backend="cuda", n_lanes=MAIN_LANES,
                             eps_target=MAIN_EPS, timeout_s=MAIN_TIMEOUT_S)
    fixpoint_cuda.launches = 0
    res = solve(60, cfg)
    launches = fixpoint_cuda.launches
    steps = res.n_supersteps
    per_step = (res.wall_s - res.eps_s) / max(steps, 1) * 1e3
    print(f"[3] J60 main path (cuda, {MAIN_LANES} lanes, eps_target "
          f"{MAIN_EPS}): {res.status} objective={res.objective} "
          f"nodes={res.n_nodes} ({res.nodes_per_sec:.0f}/s) "
          f"fails={res.n_fails} sols={res.n_sols} sweeps={res.n_sweeps} "
          f"supersteps={steps} wall={res.wall_s:.2f} s "
          f"eps={res.eps_s:.2f} s, search "
          f"{(res.wall_s - res.eps_s) * 1e3:.1f} ms ({per_step:.3f} "
          f"ms/superstep after EPS) "
          f"kernel launches={launches} (EPS {launches - steps}, "
          f"supersteps {steps}); ground check OK")
    if res.status != "OPTIMAL" or res.objective != J60_OPTIMUM:
        fail(f"J60: expected OPTIMAL {J60_OPTIMUM}, got {res.status} "
             f"{res.objective}")
    if launches < steps or launches == 0:
        fail(f"J60: {launches} kernel launches for {steps} supersteps")

    # the cost of the per-superstep host read of the global done flag
    flag = torch.zeros(MAIN_LANES, dtype=torch.bool).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        bool(flag.all())
    sync_us = (time.perf_counter() - t0) / 200 * 1e6
    print(f"[3] host read of the done flag: {sync_us:.1f} us per superstep "
          f"(idle stream)")

    got = {}
    for backend in ("cuda", "gather"):
        c = SolveConfig.preset("prove", backend=backend, n_lanes=J30_LANES)
        r = solve(30, c)
        got[backend] = r
        print(f"[3] J30 ({backend}, {J30_LANES} lanes): {r.status} "
              f"objective={r.objective} nodes={r.n_nodes} fails={r.n_fails} "
              f"sols={r.n_sols} sweeps={r.n_sweeps} "
              f"supersteps={r.n_supersteps} wall={r.wall_s:.2f} s")
    for k, ref in J30_REFERENCE.items():
        a, b = getattr(got["cuda"], k), getattr(got["gather"], k)
        if a != b:
            fail(f"J30: cuda and gather differ in {k}: {a} vs {b}")
        if a != ref:
            fail(f"J30: {k} = {a}, the JAX package gives {ref}")
    print("[3] J30: cuda == gather == JAX reference on "
          + ", ".join(J30_REFERENCE))
    return launches, res


# --------------------------------------------------------------------------
# phase 4: times
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
    tables = (cm.vidx, cm.coef, cm.rhs, cm.bidx, cm.occ_prop, cm.occ_slot,
              cm.cu_svar, cm.cu_dur, cm.cu_dem, cm.cu_cap, cm.cu_occ_inst,
              cm.cu_occ_pos, cm.box_lo, cm.box_hi)
    return sum(t.numel() * t.element_size() for t in tables)


def ops_per_sweep(cm):
    """The int32 work one fixpoint sweep of one lane needs: 8·P1·K for
    the linear bank; 4·C1·T + 2·C1·H for the time-table (each task adds
    its compulsory part's two ends to a difference array, a prefix sum
    and a capacity compare per time point build the profile, and each
    task's first and last start take at least one operation each);
    2·V·(D+Dcu) for the gather join."""
    P1, K = cm.vidx.shape
    C1, T = cm.cu_svar.shape
    V, D, Dcu, H = cm.n_vars, cm.d_occ, cm.cu_docc, cm.horizon
    return 8 * P1 * K + 4 * C1 * T + 2 * C1 * H + 2 * V * (D + Dcu)


def fixpoint_bound_ms(cm, L, sweeps, peak_int32):
    """Least time for the same work: each table and store read once,
    each output written once, over the HBM rate; the sweeps this run
    needed times `ops_per_sweep`, over the int32 peak."""
    V = cm.n_vars
    nbytes = table_bytes(cm) + 4 * L * V * 4 + 2 * L * 4
    ops = int(sweeps.sum()) * ops_per_sweep(cm)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_int32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, ops


def phase_times(card, peak_int32, models, launches, max_err):
    import torch
    from repro_torch.core import fixpoint as F
    from repro_torch.kernels.fixpoint_kernel import fixpoint_cuda
    cm, lbs, ubs, _, _ = models["J60"]
    lb = torch.from_numpy(lbs[:MAIN_LANES]).cuda()
    ub = torch.from_numpy(ubs[:MAIN_LANES]).cuda()
    L = lb.shape[0]
    n0 = fixpoint_cuda.launches
    ms = cuda_ms(lambda: fixpoint_cuda(cm, lb, ub), reps=50, warmup=5)
    plain_ms = cuda_ms(lambda: F.fixpoint_batch(cm, lb, ub), reps=5,
                       warmup=1)
    fixpoint_cuda.launches = n0            # timing launches are not counted
    sweeps = F.fixpoint_batch(cm, lb, ub)[2]
    bound_ms, bound_by, nbytes, ops = fixpoint_bound_ms(cm, L, sweeps,
                                                        peak_int32)
    print(f"[4] fixpoint at [{L}, {cm.n_vars}] (J60 random stores, uncapped, "
          f"{int(sweeps.sum())} lane-sweeps): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.5f} ms ({bound_by}: "
          f"{nbytes} B, {ops} int32 ops at {peak_int32 / 1e12:.2f} T/s; "
          f"kernel {ms / bound_ms:.0f}x the bound) on {card}")
    print(f"kernels: fixpoint_cuda launches={launches}")
    return [dict(name="fixpoint_cuda", route="cuda", source=FIXPOINT_SOURCE,
                 replaces=FIXPOINT_REPLACES, launches=launches,
                 max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                 bound_ms=bound_ms, bound_by=bound_by, library_ms=None)]


# --------------------------------------------------------------------------
# phase 5: resident search kernel against plain version
# --------------------------------------------------------------------------

def search_kwargs(preset):
    from repro_torch.solver import SolveConfig
    opts = SolveConfig.preset(preset, backend="cuda_resident").search_options()
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


def phase_search_vs_plain(models):
    import torch
    from repro_torch.kernels.fixpoint_kernel import (search_cuda,
                                                     search_grid,
                                                     search_plain)
    from repro_torch.testing import search_diff, search_inputs
    n0 = search_cuda.launches
    max_err = 0
    timing_state = None
    for tag, lanes in (("J30", J30_SEARCH_LANES), ("J60", MAIN_LANES)):
        cm, _, _, plb, pub = models[tag]
        # the superstep that finds the first solution, from fresh lanes
        opts, kw = search_kwargs("first_solution")
        inputs = search_inputs(cm, lanes, None, opts, pool=(plb, pub))
        out = search_plain(cm, *inputs[:3], inputs[3], 0, inputs[4],
                           supersteps=FIRST_SOL_MAX, **kw)
        if not bool(out[4]):
            fail(f"{tag}: no solution in {FIRST_SOL_MAX} supersteps")
        first = int(out[2])
        starts = sorted({0, WARM_STEPS, max(first - 8, 0), first + 8})
        print(f"[5] {tag}: {lanes} lanes on {search_grid(cm, lanes)} CTAs "
              f"(cooperative grid), EPS pool {plb.shape[0]}; first solution "
              f"at superstep {first}; starts after "
              f"{', '.join(map(str, starts))} plain supersteps")
        for preset in SEARCH_PRESETS:
            opts, kw = search_kwargs(preset)
            slb, sub, st, gbest, head = search_inputs(cm, lanes, None, opts,
                                                      pool=(plb, pub))
            cur, done_steps = (st, gbest, 0, head), 0
            for n in starts:
                if n > done_steps:
                    cur = search_plain(cm, slb, sub, *cur,
                                       supersteps=n - done_steps, **kw)[:4]
                    done_steps = n
                if n == WARM_STEPS and tag == "J60" and preset == "prove":
                    timing_state = (cm, slb, sub, cur, kw)
                for k in SEARCH_K:
                    ref = search_plain(cm, slb, sub, *cur, supersteps=k,
                                       **kw)
                    got = search_cuda(cm, slb, sub, *cur, supersteps=k,
                                      **kw)
                    torch.cuda.synchronize()
                    bad = search_diff(ref, got)
                    if bad:
                        fail(f"{tag} {preset} from superstep {int(cur[2])}, "
                             f"K={k}: search_cuda differs from search_plain "
                             f"in {', '.join(bad)}")
                    max_err = max(max_err, max_abs_diff(ref, got))
                st0, st16 = cur[0], ref[0]
                print(f"[5] {tag} {preset} from superstep {int(cur[2])} "
                      f"({int(st0.has_sol.sum())} lanes with a solution): "
                      f"K={','.join(map(str, SEARCH_K))} equal on every "
                      f"field; after K={SEARCH_K[-1]}: it={int(ref[2])} "
                      f"nodes={int(st16.n_nodes.sum())} "
                      f"sols={int(st16.n_sols.sum())} gbest={int(ref[1])} "
                      f"head={int(ref[3])} stopped={bool(ref[4])}")
    search_cuda.launches = n0          # comparison launches are not counted
    return timing_state, max_err


# --------------------------------------------------------------------------
# phase 6: the resident main path
# --------------------------------------------------------------------------

def phase_resident_path(ref):
    from repro_torch.kernels.fixpoint_kernel import fixpoint_cuda, search_cuda
    from repro_torch.solver import SolveConfig
    cfg = SolveConfig.preset(
        "prove", backend="cuda_resident", supersteps_per_launch=MAIN_K,
        n_lanes=MAIN_LANES, eps_target=MAIN_EPS, timeout_s=MAIN_TIMEOUT_S)
    fixpoint_cuda.launches = 0
    search_cuda.launches = 0
    res = solve(60, cfg)
    launches = search_cuda.launches
    eps_launches = fixpoint_cuda.launches
    steps = res.n_supersteps
    per_step = (res.wall_s - res.eps_s) / max(steps, 1) * 1e3
    print(f"[6] J60 resident path (cuda_resident, K={MAIN_K}, {MAIN_LANES} "
          f"lanes, eps_target {MAIN_EPS}): {res.status} "
          f"objective={res.objective} nodes={res.n_nodes} "
          f"({res.nodes_per_sec:.0f}/s) fails={res.n_fails} "
          f"sols={res.n_sols} sweeps={res.n_sweeps} supersteps={steps} "
          f"wall={res.wall_s:.2f} s eps={res.eps_s:.2f} s, search "
          f"{(res.wall_s - res.eps_s) * 1e3:.1f} ms "
          f"({per_step:.3f} ms/superstep after EPS) search_cuda "
          f"launches={launches}, fixpoint_cuda launches={eps_launches} "
          f"(EPS); ground check OK")
    for k in COUNTERS:
        if getattr(res, k) != getattr(ref, k):
            fail(f"J60: cuda_resident {k} = {getattr(res, k)}, the cuda "
                 f"backend gives {getattr(ref, k)}")
    print("[6] J60: cuda_resident == cuda on " + ", ".join(COUNTERS))
    if launches == 0 or launches < -(-steps // MAIN_K):
        fail(f"J60: {launches} search_cuda launches for {steps} supersteps")
    return launches


# --------------------------------------------------------------------------
# phase 7: resident kernel times
# --------------------------------------------------------------------------

def search_bound_ms(cm, start, out, peak_int32):
    """Least time for one launch's work: the LaneState read once and
    written once (bools one byte each) and the tables read once, over
    the HBM rate; the sweeps this launch needed times `ops_per_sweep`,
    plus, per lane and live superstep, the commit's solved/failed checks
    (2·V) and branch selection (3·B), over the int32 peak.  Dispatch,
    the tells and backtracking are counted as nothing, so this is a
    lower bound."""
    st_in, st_out = start[0], out[0]
    L, V = st_in.lb.shape
    B = int(cm.branch_vars.shape[0])
    steps = int(out[2]) - int(start[2])
    sweeps = int(st_out.n_sweeps.long().sum() - st_in.n_sweeps.long().sum())
    state = sum(a.numel() * a.element_size() for a in st_in
                if a is not None)
    nbytes = 2 * state + table_bytes(cm)
    ops = sweeps * ops_per_sweep(cm) + steps * L * (2 * V + 3 * B)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_int32 * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops, steps, sweeps)


def phase_search_times(card, peak_int32, timing_state, launches, max_err):
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
    print(f"[7] search at {L} lanes, K={MAIN_K} (J60, prove, from the state "
          f"after {WARM_STEPS}; {steps} live supersteps, {sweeps} "
          f"lane-sweeps): kernel {ms:.4f} ms per launch "
          f"({ms / max(steps, 1):.4f} ms per superstep), plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.5f} ms ({bound_by}: "
          f"{nbytes} B, {ops} int32 ops at {peak_int32 / 1e12:.2f} T/s; "
          f"kernel {ms / bound_ms:.0f}x the bound); library: none "
          f"(no PyTorch call computes a superstep) on {card}")
    print(f"kernels: search_cuda launches={launches}")
    return dict(name="search_cuda", route="cuda", source=SEARCH_SOURCE,
                replaces=SEARCH_REPLACES, launches=launches,
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


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
    card, peak_int32 = phase_card_and_build()
    models, max_err = phase_kernel_vs_plain()
    launches, cuda_res = phase_main_path()
    kernels = phase_times(card, peak_int32, models, launches, max_err)
    timing_state, search_err = phase_search_vs_plain(models)
    search_launches = phase_resident_path(cuda_res)
    kernels.append(phase_search_times(card, peak_int32, timing_state,
                                      search_launches, search_err))
    print(f"chip_smoke: all phases passed in {time.time() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
