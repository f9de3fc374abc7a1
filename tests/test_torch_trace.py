"""The phases of a solve (`repro_torch/core/trace.py`): the leaf phases
tile a solve under every backend of the single-model path, they are kept
with or without a profiler, the timeline only while a profiler records
or inside `trace.recording()`, a consumer's time between the solve's
events is in no phase, and the calls that the benchmark's harness wraps
keep their signatures.

This file imports neither JAX nor the JAX package, so it also runs on a
machine with a CUDA card, where the card's tests run instead of
skipping:

    PYTHONPATH=src python -m pytest -q tests/test_torch_trace.py
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import solver
from repro_torch.core import trace
from repro_torch.core.models import rcpsp

ROOT = Path(__file__).resolve().parents[1]
EPS = {"eps.host", "eps.stage", "eps.wait"}
REST = {"pool", "init", "search.host", "search.read", "solve.loop",
        "solve.result"}
# the kernel wrappers' launch phases: no kernel under gather
LAUNCH = {"gather": set(), "cuda": {"eps.launch", "search.launch"},
          "cuda_resident": {"eps.launch", "search.launch"}}
BACKENDS = {"gather": {}, "cuda": {},
            "cuda_resident": {"supersteps_per_launch": 4}}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cm(device="cpu", n=8):
    m, _ = rcpsp.build_model(rcpsp.generate(n, 2, seed=0))
    return m.compile(device=device)


def _cfg(backend="gather", device="cpu", **kw):
    kw = {**BACKENDS[backend], "n_lanes": 8, "eps_target": 16, **kw}
    return solver.SolveConfig.preset("prove", backend=backend,
                                     device=device, **kw)


def _from_spans(spans):
    acc = {}
    for name, a, b in spans:
        n, ns = acc.get(name, (0, 0))
        acc[name] = (n + 1, ns + b - a)
    return {k: (n, ns / 1e9) for k, (n, ns) in acc.items()}


# ---- the trace itself ------------------------------------------------------

def test_a_switch_closes_the_open_phase():
    tr = trace.SolveTrace("a")
    tr.switch("a")                         # the open phase: no new count
    tr.switch("b")
    tr.pause()
    tr.pause()
    tr.switch("a")
    tr.switch("b")
    tr.pause()
    assert [k for k in tr.phases] == ["a", "b"]
    assert tr.count("a") == 2 and tr.count("b") == 2 and tr.count("c") == 0
    assert tr.seconds() == pytest.approx(tr.seconds("a", "b"))
    assert tr.seconds("c") == 0.0
    assert tr.spans is None
    assert [line.split()[0] for line in tr.table()] == ["a", "b"]


def test_mark_switches_only_the_active_trace():
    trace.mark("x")                        # no active trace: nothing
    tr = trace.SolveTrace("a")
    with trace.active(tr):
        trace.mark("b")
        with pytest.raises(KeyError):
            with trace.active(None):
                trace.mark("c")            # none active in here
                raise KeyError
        trace.mark("b")
    trace.mark("d")                        # the block is closed
    tr.pause()
    assert list(tr.phases) == ["a", "b"] and tr.count("b") == 1


def test_a_launch_opens_its_phase_only_from_the_mapped_one():
    with trace.recording():
        tr = trace.SolveTrace("init")
    with trace.active(tr):
        trace.launch("k0")                 # init has no launch phase
        trace.mark("search.host")
        trace.launch("k1")
        trace.launch("k2")                 # already in search.launch
        trace.mark("eps.stage")
        trace.launch("k3")
    tr.pause()
    assert list(tr.phases) == ["init", "search.host", "search.launch",
                               "eps.stage", "eps.launch"]
    assert tr.count("search.launch") == 1
    assert [k for k, _ in tr.launches] == ["k0", "k1", "k2", "k3"]
    ts = [t for _, t in tr.launches]
    assert ts == sorted(ts)
    off = trace.SolveTrace("search.host")
    with trace.active(off):
        trace.launch("k")
    off.pause()
    assert off.launches is None
    assert list(off.phases) == ["search.host", "search.launch"]


# ---- a solve's phases -------------------------------------------------------

@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_leaf_phases_tile_a_solve(backend):
    res = solver.Solver(_cfg(backend)).solve(_cm())
    tr = res.trace
    assert res.status == "OPTIMAL"
    assert tr.spans is None                # no profiler, no timeline
    assert set(tr.phases) == EPS | REST | LAUNCH[backend]
    assert tr.seconds() >= 0.99 * res.wall_s
    assert tr.seconds() <= res.wall_s + 0.01
    assert tr.count("eps.stage") == tr.count("eps.wait") \
        == tr.count("eps.host") - 1
    if LAUNCH[backend]:
        assert tr.count("eps.launch") == tr.count("eps.stage")
    assert tr.count("search.host") == tr.count("search.read")
    if backend == "cuda_resident":
        # one read per launch of 4 supersteps, one bookkeeping per launch
        assert tr.count("search.read") == tr.count("solve.loop") \
            == -(-res.n_supersteps // 4)
    else:
        assert tr.count("search.read") == res.n_supersteps
    assert tr.seconds(*EPS, "eps.launch") <= res.eps_s


def test_a_given_pool_starts_with_its_padding():
    cm = _cm()
    cfg = _cfg()
    from repro_torch.core import eps
    subs = eps.decompose(cm, 16, cfg.search_options())
    tr = solver.Solver(cfg).solve(cm, subs=subs).trace
    assert list(tr.phases)[:2] == ["pool", "init"]
    assert not EPS & set(tr.phases)


def test_a_consumers_work_is_in_no_phase():
    slept, events, res = 0.0, 0, None
    for ev in solver.Solver(_cfg(chunk=1)).solve_iter(_cm()):
        if ev.final:
            res = ev.result
            continue
        t = time.perf_counter()
        time.sleep(0.01)
        slept += time.perf_counter() - t
        events += 1
    assert events >= 3
    tr = res.trace
    assert tr.seconds() <= res.wall_s - 0.9 * slept
    assert tr.seconds() + slept >= 0.99 * res.wall_s


def test_the_mesh_path_keeps_its_phases():
    from repro_torch.distributed.sharding import make_mesh
    mesh = make_mesh((2,), ("lanes",), device="cpu")
    res = solver.Solver(_cfg(n_lanes=4, mesh=mesh, lane_axes=("lanes",))
                        ).solve(_cm())
    tr = res.trace
    assert set(tr.phases) == EPS | REST
    assert tr.count("search.read") == res.n_supersteps
    assert tr.seconds() >= 0.99 * res.wall_s


@pytest.mark.parametrize("how", ["recording", "cpu_profiler"])
def test_the_timeline_only_while_recorded(how):
    cm, cfg = _cm(), _cfg()
    assert not trace.timeline_on()
    ctx = (trace.recording() if how == "recording"
           else profile(activities=[ProfilerActivity.CPU]))
    with ctx:
        assert trace.timeline_on()
        res = solver.Solver(cfg).solve(cm)
    assert not trace.timeline_on()
    spans = res.trace.spans
    assert spans and _from_spans(spans) == res.trace.phases
    assert all(b >= a for _, a, b in spans)
    assert all(s[1] >= p[2] for p, s in zip(spans, spans[1:]))
    assert solver.Solver(cfg).solve(cm).trace.spans is None


@pytest.mark.parametrize("backend", ["cuda", "cuda_resident"])
def test_the_timeline_stamps_every_kernel_launch(backend):
    """On the CPU the wrappers stamp the plain functions that stand in
    for the kernels: one per EPS launch, and under ``cuda_resident`` one
    per quantum; under ``cuda`` a quantum's every fixpoint."""
    with trace.recording():
        tr = solver.Solver(_cfg(backend)).solve(_cm()).trace
    kernels = [k for k, _ in tr.launches]
    eps_launches = tr.count("eps.launch")
    if backend == "cuda_resident":
        assert kernels.count("search_plain") == tr.count("search.launch")
        assert kernels.count("fixpoint_batch") == eps_launches
    else:
        assert set(kernels) == {"fixpoint_batch"}
        assert len(kernels) >= eps_launches + tr.count("search.launch")


def test_other_paths_keep_no_phases():
    cm = _cm()
    many = solver.Solver(_cfg()).solve_many([cm, cm])
    assert all(r.trace is None for r in many)


def test_the_harness_hooks_still_hold():
    """The calls the benchmark wraps (``perfbench/harness.py`` HOOKS)
    keep the parameters its wrappers pass on."""
    sys.path[:0] = [str(ROOT / "perfbench")]
    try:
        import harness
        import reference
        harness.check_hooks(reference.LANE_FIELDS)
    finally:
        sys.path.remove(str(ROOT / "perfbench"))


def test_cli_profile_prints_the_phases():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.solve", "--n", "5",
         "--lanes", "4", "--device", "cpu", "--profile", "--backend",
         "cuda_resident", "--supersteps-per-launch", "4"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.splitlines()
    every = EPS | REST | LAUNCH["cuda_resident"]
    for part, names in (("eps", EPS | {"eps.launch"}),
                        ("search", REST - {"pool"} | {"search.launch"})):
        rows = [ln.split()[2] for ln in lines
                if ln.startswith(f"profile {part}:   ")
                and ln.split()[2] in every]
        assert names <= set(rows), (part, rows)
        assert any(ln.startswith(f"profile {part}: phases ")
                   for ln in lines)
    assert "ground_check=OK" in lines[-1]


# ---- on the card only ------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the resident launch and the "
                    "CUDA-only profiler have no CPU mode)")
    return torch.device("cuda")


def test_resident_phases_on_the_card_under_a_cuda_only_profiler(cuda):
    """The harness's profiler (CUDA activity alone) turns the timeline
    on; on the card every resident launch has its launch phase."""
    from repro_torch.kernels.fixpoint_kernel import search_cuda
    cm = _cm("cuda", n=30)
    cfg = _cfg("cuda_resident", device="cuda", n_lanes=64, eps_target=64)
    solver.Solver(cfg).solve(cm)                 # builds the kernels
    n0 = search_cuda.launches
    with profile(activities=[ProfilerActivity.CUDA]):
        assert trace.timeline_on()
        res = solver.Solver(cfg).solve(cm)
        torch.cuda.synchronize()
    tr = res.trace
    assert tr.spans and _from_spans(tr.spans) == tr.phases
    assert tr.count("search.launch") == tr.count("search.read") \
        == search_cuda.launches - n0
    assert [k for k, _ in tr.launches].count("search_kernel") \
        == search_cuda.launches - n0
    assert tr.seconds() >= 0.99 * res.wall_s
