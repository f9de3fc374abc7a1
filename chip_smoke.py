#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # from the repository root

Phases, in order; any error or mismatch ends the run with a non-zero
exit code and no result line:

1. card and build: the card line of ``nvidia-smi``, torch and CUDA
   versions; ``nvcc`` builds ``kernels/csrc/fixpoint.cu`` for sm_90a and
   its ``-Xptxas -v`` report (registers, shared memory) is printed;
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
   beside the least time the card could take for that work.

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
    built = build.build("fixpoint")
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
        out[tag] = (cm, lbs, ubs)
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
          f"eps={res.eps_s:.2f} s ({per_step:.2f} ms/superstep after EPS) "
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
    return launches


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


def fixpoint_bound_ms(cm, L, sweeps, peak_int32):
    """Least time for the same work: each table and store read once,
    each output written once, over the HBM rate; the sweeps this run
    needed times the int32 work one sweep needs, over the int32 peak.
    A sweep needs 8·P1·K for the linear bank; 4·C1·T + 2·C1·H for the
    time-table (each task adds its compulsory part's two ends to a
    difference array, a prefix sum and a capacity compare per time
    point build the profile, and each task's first and last start take
    at least one operation each); 2·V·(D+Dcu) for the gather join."""
    P1, K = cm.vidx.shape
    C1, T = cm.cu_svar.shape
    V, D, Dcu, H = cm.n_vars, cm.d_occ, cm.cu_docc, cm.horizon
    tables = (cm.vidx, cm.coef, cm.rhs, cm.bidx, cm.occ_prop, cm.occ_slot,
              cm.cu_svar, cm.cu_dur, cm.cu_dem, cm.cu_cap, cm.cu_occ_inst,
              cm.cu_occ_pos, cm.box_lo, cm.box_hi)
    nbytes = (sum(t.numel() * t.element_size() for t in tables)
              + 4 * L * V * 4 + 2 * L * 4)
    per_sweep = (8 * P1 * K + 4 * C1 * T + 2 * C1 * H
                 + 2 * V * (D + Dcu))
    ops = int(sweeps.sum()) * per_sweep
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_int32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, ops


def phase_times(card, peak_int32, models, launches, max_err):
    import torch
    from repro_torch.core import fixpoint as F
    from repro_torch.kernels.fixpoint_kernel import fixpoint_cuda
    cm, lbs, ubs = models["J60"]
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
    launches = phase_main_path()
    kernels = phase_times(card, peak_int32, models, launches, max_err)
    print(f"chip_smoke: all phases passed in {time.time() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
