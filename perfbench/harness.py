"""One run of one cell: set-up, the measured window, the metrics and the
comparison that decides ``correct``.

Everything that belongs to one configuration, traffic mix, problem
class, arrival process or metric is data or a module of its own, found
by name:

* ``perfbench/configs/<config>.json``: the deployment (instance class
  grid, solver settings, guarantees) and its ``problem``;
* ``perfbench/problems/<problem>.py``: a problem class (drawing an
  instance, the program's model of it, the check of an answer, the plain
  reference);
* ``perfbench/traffic/<mix>.json``: the traffic mix (which instances,
  which preset solves them, the deadline policy, what the comparison
  samples) and its ``loop``;
* ``perfbench/loops/<loop>.py``: the arrival process that drives the
  window (``run(window)``);
* ``perfbench/metrics/<metric>.py``: ``read(run) -> float | None`` for
  every metric of ``BENCHMARK.json``, end to end or per layer.

The program is driven through its public path (the problem's model →
``Model.compile`` → ``Solver.solve``).  To compare what the timed path
produced, `Recorder` wraps four of the program's internal calls; each
wrapper times spans and keeps references, and changes nothing.  Those
calls are not a public interface of the program, so `Recorder.install`
checks each against the signature and fields it relies on (`HOOKS`,
`LANE_FIELDS` of the reference) and stops the run with a `HookError`
that names the call where the program has changed.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import inspect
import json
import math
import time
import traceback
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

PB = Path(__file__).resolve().parent
ROOT = PB.parent
STREAM_WINDOW, STREAM_WARM, STREAM_SAMPLE, STREAM_DRAWN = 1, 2, 3, 4


# --------------------------------------------------------------------------
# finding things by name
# --------------------------------------------------------------------------

def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str) -> dict:
    path = PB / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no file {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def load_module(kind: str, name: str):
    """The module ``perfbench/<kind>/<name>.py`` (a metric's reader, a
    loop, a problem class)."""
    path = PB / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric(name: str):
    """The reader module of metric `name` (``metrics/<name>.py``)."""
    return load_module("metrics", name)


def problem_of(config: dict):
    """The problem class a configuration names."""
    return load_module("problems", config["problem"])


def loop_of(traffic: dict):
    """The arrival process a mix names."""
    return load_module("loops", traffic["loop"])


def cell_spec(name: str) -> dict:
    """A cell of ``BENCHMARK.json`` with its configuration, its traffic
    mix and the metrics it reports (``e2e`` and ``layer`` lists)."""
    bench = benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    cell = cells[name]
    confs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((ROOT / confs[cell["config"]]["file"]).read_text())

    def mine(metric):
        return name in metric.get("workloads", [name])

    return dict(cell=cell, config=config,
                traffic=load_json("traffic", cell["traffic"]),
                e2e=[m for m in bench["end_to_end"] if mine(m)],
                layer=[m for m in bench["per_layer"] if mine(m)])


# --------------------------------------------------------------------------
# traffic: the instance set and the order of a run
# --------------------------------------------------------------------------

def rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of one stream of a run, from `seed` alone (any whole
    number; negative ones are taken modulo 2**64)."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def instance_set(config: dict, traffic: dict) -> list:
    """The mix's instances: ``set_size`` of them, the k-th at its class
    point, all drawn from the mix's ``family_seed``, so that every run
    does the same work whatever its seed."""
    problem = problem_of(config)
    r = rng(traffic["family_seed"], STREAM_WINDOW)
    return [problem.draw(config, traffic, k, int(r.integers(1 << 62)))
            for k in range(traffic["set_size"])]


def drawn_instances(config: dict, traffic: dict, seed: int) -> list:
    """``check_drawn`` instances drawn from `seed` alone, each at the
    class point of a position drawn from `seed`: solved after the window
    and compared, so that every seed checks instances that no other seed
    shares."""
    problem = problem_of(config)
    r = rng(seed, STREAM_DRAWN)
    return [problem.draw(config, traffic, int(r.integers(1 << 30)),
                         int(r.integers(1 << 62)))
            for _ in range(traffic.get("check_drawn", 0))]


def visit_order(traffic: dict, seed: int):
    """Positions in the instance set in the order a run visits them: a
    permutation drawn from `seed`, then another, and so on."""
    r = rng(seed, STREAM_WINDOW)
    while True:
        yield from (int(i) for i in r.permutation(traffic["set_size"]))


# --------------------------------------------------------------------------
# what a run keeps
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Solve:
    """One instance of the window: when it was built, compiled and
    solved, what came back, and the columns of its store."""

    k: int
    inst: Any
    t_start: float
    t_built: float = math.nan
    t_compiled: float = math.nan
    t_done: float = math.nan
    result: Any = None
    cols: Optional[np.ndarray] = None     # program column of each ref column
    error: Optional[str] = None
    launches: int = 0                     # resident search launches
    fixpoint: Optional[list] = None       # traced: [sweeps, stores, launches]


@dataclasses.dataclass
class Run:
    """What metric readers see: the cell, the solves of the window, the
    set-up time, the card's peaks and, in a traced run, the device's
    events."""

    cell: dict
    config: dict
    traffic: dict
    seconds: float
    setup_s: float
    t0: float
    t_end: float
    solves: List[Solve]
    int_peak: float = math.nan
    device_ops: Optional[List[tuple]] = None     # (name, start_s, dur_s)
    window_s: float = math.nan
    busy_s: float = math.nan

    def in_window(self) -> List[Solve]:
        """Solves that returned by the close of the window."""
        return [s for s in self.solves
                if s.result is not None and s.t_done <= self.t_end]

    def device_seconds(self, key: str) -> float:
        """Device time of the events whose name contains `key`."""
        return sum(d for name, _, d in self.device_ops or ()
                   if key in name)


class HookError(RuntimeError):
    """The program no longer has a call, or a call's signature or fields,
    that the harness records through."""


# The program's internal calls the harness wraps: (module, attribute
# path, the parameters it passes on, what the wrapper keeps).  A program
# change that moves one of these stops the run with a HookError naming
# it, rather than a wrong comparison.
HOOKS = (
    ("repro_torch.core.eps", "decompose", ("cm", "target", "opts"),
     "each solve's EPS pool"),
    ("repro_torch.core.backend", "CudaResidentBackend.superstep_launch",
     ("self", "cm", "subs_lb", "subs_ub", "st", "gbest", "it",
      "pool_head", "opts", "supersteps"),
     "the input and output of a resident search launch"),
    ("repro_torch.core.search", "lanes_step",
     ("cm", "subs_lb", "subs_ub", "opts", "st", "gbest", "pool_head"),
     "the input and output of one superstep (other backends)"),
    ("repro_torch.core.backend", "CudaBackend.fixpoint_batch",
     ("self", "cm", "lb", "ub"),
     "the sweeps of each fixpoint launch (traced runs)"),
)


def hook_target(module: str, path: str):
    """(owner, attribute name, the callable) of a hook."""
    owner = importlib.import_module(module)
    *outer, name = path.split(".")
    for part in outer:
        owner = getattr(owner, part, None)
        if owner is None:
            raise HookError(f"{module}.{path}: the program has no {part}")
    fn = getattr(owner, name, None)
    if fn is None:
        raise HookError(f"{module}.{path}: the program has no {name}")
    return owner, name, fn


def check_hooks(lane_fields) -> None:
    """Every hook's call takes the parameters its wrapper passes on, in
    that order, and the program's lane state has every field that the
    comparison reads; a `HookError` names the first that does not."""
    for module, path, params, keeps in HOOKS:
        _, _, fn = hook_target(module, path)
        have = tuple(inspect.signature(fn).parameters)
        if have[:len(params)] != params:
            raise HookError(
                f"{module}.{path} (recorded for {keeps}) takes {have}; "
                f"the harness passes {params}")
    from repro_torch.core.search import LaneState
    missing = [f for f in lane_fields if f not in LaneState._fields]
    if missing:
        raise HookError(f"repro_torch.core.search.LaneState has no "
                        f"{missing}, which the comparison reads")


class Recorder:
    """Wrappers around the program's calls that keep what they return:
    `eps.decompose`'s pool, and the inputs and outputs of one quantum of
    the search per solve (the quantum `pick(k)` of solve k, or its last):
    a launch of the resident search (K supersteps), or under the other
    backends one `search.lanes_step` (one superstep), copied to the host
    so that it holds no memory of the card.  In a traced run, the sweeps
    and stores of every fixpoint call of the kernel backends as well."""

    def __init__(self, pick, traced: bool):
        self.pick = pick
        self.traced = traced
        self.k = -1
        self.spans: List[tuple] = []             # (name, t0, t1)
        self.pools: Dict[int, tuple] = {}
        self.launches: Dict[int, tuple] = {}
        self.n_launches: Dict[int, int] = {}
        self._last = None
        self._in_launch = False
        self.fx: Dict[int, list] = {}      # k: [sweeps, stores, launches]
        self._undo = []

    def install(self, lane_fields=()):
        check_hooks(lane_fields)
        from repro_torch.core import eps as E
        from repro_torch.core import backend as BK
        from repro_torch.core import search as S
        rec = self
        decompose = E.decompose

        def recorded_decompose(cm, target, opts=None):
            t = time.perf_counter()
            out = decompose(cm, target, opts)
            rec.spans.append(("eps", t, time.perf_counter()))
            rec.pools[rec.k] = out
            return out

        launch = BK.CudaResidentBackend.superstep_launch

        def keep(entry):
            j = rec.n_launches.get(rec.k, 0)
            rec.n_launches[rec.k] = j + 1
            if j == rec.pick(rec.k):
                rec.launches[rec.k] = _on_host(entry)
            rec._last = entry

        def recorded_launch(self_, cm, subs_lb, subs_ub, st, gbest, it,
                            pool_head, *, opts, supersteps):
            rec._in_launch = True          # its plain version steps lanes
            try:
                out = launch(self_, cm, subs_lb, subs_ub, st, gbest, it,
                             pool_head, opts=opts, supersteps=supersteps)
            finally:
                rec._in_launch = False
            keep(dict(subs=(subs_lb, subs_ub), st=st, gbest=gbest, it=it,
                      head=pool_head, supersteps=supersteps,
                      first=opts.stop_on_first, out=out))
            return out

        lanes_step = S.lanes_step

        def recorded_step(cm, subs_lb, subs_ub, opts, st, gbest, pool_head,
                          **kw):
            out = lanes_step(cm, subs_lb, subs_ub, opts, st, gbest,
                             pool_head, **kw)
            if rec._in_launch:
                return out
            keep(dict(subs=(subs_lb, subs_ub), st=st, gbest=gbest, it=0,
                      head=pool_head, supersteps=None,
                      first=opts.stop_on_first, out=out))
            return out

        E.decompose = recorded_decompose
        BK.CudaResidentBackend.superstep_launch = recorded_launch
        S.lanes_step = recorded_step
        self._undo += [(E, "decompose", decompose),
                       (BK.CudaResidentBackend, "superstep_launch", launch),
                       (S, "lanes_step", lanes_step)]
        if self.traced:
            import torch
            fixpoint_batch = BK.CudaBackend.fixpoint_batch

            def counted_fixpoint(self_, cm, lb, ub, **kw):
                out = fixpoint_batch(self_, cm, lb, ub, **kw)
                sweeps = out[-2]
                if (sweeps.shape != lb.shape[:1]
                        or sweeps.dtype.is_floating_point):
                    raise HookError(
                        "repro_torch.core.backend.CudaBackend.fixpoint_batch"
                        " no longer returns the sweeps of each store "
                        f"second from last (it returned {sweeps.dtype} "
                        f"{tuple(sweeps.shape)} for {lb.shape[0]} stores)")
                acc = rec.fx.setdefault(rec.k, [0, 0, 0])
                acc[0] = acc[0] + sweeps.sum(dtype=torch.int64)
                acc[1] += int(lb.shape[0])
                acc[2] += 1
                return out

            BK.CudaBackend.fixpoint_batch = counted_fixpoint
            self._undo.append((BK.CudaBackend, "fixpoint_batch",
                               fixpoint_batch))

    def uninstall(self):
        for obj, name, orig in reversed(self._undo):
            setattr(obj, name, orig)
        self._undo = []

    def reset(self):
        """Forget what the set-up's solves left."""
        for kept in (self.spans, self.pools, self.launches,
                     self.n_launches, self.fx):
            kept.clear()

    def begin(self, k: int):
        self.k = k
        self._last = None

    def end(self, k: int):
        if k not in self.launches and self._last is not None:
            self.launches[k] = _on_host(self._last)
        self._last = None


def _on_host(x):
    """`x` with every tensor in it copied to the host."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, dict):
        return {k: _on_host(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_on_host(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_on_host(v) for v in x)
    return x


# --------------------------------------------------------------------------
# the run
# --------------------------------------------------------------------------

def _solve_config(solver, config: dict, traffic: dict, device: str):
    s = config["solver"]
    return solver.SolveConfig.preset(
        traffic["preset"], backend=s["backend"], n_lanes=s["n_lanes"],
        supersteps_per_launch=s["supersteps_per_launch"],
        eps_target=s["eps_target"], device=device,
        **({"max_fixpoint_iters": traffic["max_fixpoint_iters"]}
           if traffic.get("max_fixpoint_iters") else {}))


@dataclasses.dataclass
class Window:
    """What a loop (``loops/<loop>.py``) gets: the mix, the window, the
    instance set and the order a run visits it, and `solve`; for a loop
    that drives the program another way (slots, a service), also the
    configuration, the problem class, the program's `Solver` and the
    `Recorder` (``begin(k)`` and ``end(k)`` around request k)."""

    traffic: dict
    seconds: float
    t0: float
    t_end: float
    instances: list
    order: Any
    solve: Any                    # solve(k, inst, t_stop) -> Solve
    config: dict
    problem: Any
    session: Any
    recorder: Any
    device: str


def _one(k, inst, sess, problem, device, t_stop, rec: Recorder) -> Solve:
    """Build, compile and solve one instance, the solve given what is
    left until `t_stop` (host clock) as its deadline; a raise is the
    instance's failure, recorded with its traceback."""
    sv = Solve(k=k, inst=inst, t_start=time.perf_counter())
    rec.begin(k)
    try:
        m, sv.cols = problem.model(inst)
        sv.t_built = time.perf_counter()
        cm = m.compile(device=device)
        sv.t_compiled = time.perf_counter()
        sv.result = sess.solve(
            cm, timeout_s=max(t_stop - time.perf_counter(), 1e-3))
        if device == "cuda":
            import torch
            torch.cuda.synchronize()
        sv.t_done = time.perf_counter()
    except Exception:                     # the instance fails, the run goes on
        sv.error = traceback.format_exc()
        sv.t_done = time.perf_counter()
    rec.spans += [("build", sv.t_start, sv.t_built),
                  ("compile", sv.t_built, sv.t_compiled),
                  ("solve", sv.t_compiled, sv.t_done)]
    rec.end(k)
    sv.launches = rec.n_launches.get(k, 0)
    if k in rec.fx:
        sv.fixpoint = rec.fx[k]
    return sv


def run_cell(spec: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_process: Optional[float] = None,
             log=print) -> dict:
    """One run of the cell `spec` (from `cell_spec`, or built alike);
    returns the result line's object."""
    import torch
    from repro_torch import solver

    t_process = time.perf_counter() if t_process is None else t_process
    config, traffic = spec["config"], spec["traffic"]
    problem, loop = problem_of(config), loop_of(traffic)
    sample = rng(seed, STREAM_SAMPLE)
    picks: Dict[int, int] = {}
    span = int(traffic["replay_launch_span"])

    def pick(k):
        if k not in picks:
            picks[k] = int(sample.integers(span))
        return picks[k]

    rec = Recorder(pick, traced=trace)
    rec.install(problem.reference.LANE_FIELDS)
    try:
        cfg = _solve_config(solver, config, traffic, device)
        sess = solver.Solver(cfg)

        def one(k, inst, t_stop):
            return _one(k, inst, sess, problem, device, t_stop, rec)

        # -- set-up: a warm solve at each of the mix's `warm_positions`, so
        # that every kernel instance the window meets is loaded (class
        # points of another bank layout), then the instance set
        warm_seeds = rng(seed, STREAM_WARM)
        warm_over = {"timeout_s": traffic["warm_timeout_s"]}
        if traffic["warm_supersteps"] is not None:
            warm_over["max_supersteps"] = traffic["warm_supersteps"]
        for k in traffic["warm_positions"]:
            warm = problem.draw(config, traffic, k,
                                int(warm_seeds.integers(1 << 62)))
            m, _ = problem.model(warm)
            sess.solve(m.compile(device=device), **warm_over)
        todo = instance_set(config, traffic)
        drawn = drawn_instances(config, traffic, seed)
        rec.reset()
        if device == "cuda":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_process
        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
        # -- the window: the mix's loop drives the program --------------
        t0 = time.perf_counter()
        t_end = t0 + seconds
        solves: List[Solve] = loop.run(Window(
            traffic=traffic, seconds=seconds, t0=t0, t_end=t_end,
            instances=todo, order=visit_order(traffic, seed), solve=one,
            config=config, problem=problem, session=sess, recorder=rec,
            device=device))
        t_last = max(s.t_done for s in solves)
        if prof is not None:
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
        for sv in solves:
            if sv.fixpoint is not None:
                sv.fixpoint = [int(x) for x in sv.fixpoint]
        mem = (torch.cuda.max_memory_allocated() if device == "cuda"
               else 0)
        # -- after the window: the instances drawn from the seed, through
        # the same path, for the comparison alone
        checked = [one(len(solves) + i, inst,
                       time.perf_counter() + traffic["check_drawn_s"])
                   for i, inst in enumerate(drawn)]
    finally:
        rec.uninstall()

    run = Run(cell=spec["cell"], config=config, traffic=traffic,
              seconds=seconds, setup_s=setup_s, t0=t0, t_end=t_end,
              solves=solves)
    dev_info = device_info(device, mem)
    if device == "cuda":
        run.int_peak = card_int_peak()
    if prof is not None:
        read_trace(run, prof, t0, t_last)
        dev_info.update(busy_s=run.busy_s, window_s=run.window_s)
    metrics = {}
    for m in (spec["layer"] if trace else spec["e2e"]):
        v = load_metric(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = dict(attempted=len(solves), metrics=metrics, device=dev_info)
    if prof is not None:
        out["breakdown"] = breakdown(run, rec.spans)
    for tag, group in (("", solves), (" (drawn)", checked)):
        for sv in group:
            res = sv.result
            log(f"solve {sv.k}{tag} {sv.inst.name}: "
                + (f"{res.status} {res.objective} in "
                   f"{sv.t_done - sv.t_start:.3f} s (eps {res.eps_s:.3f} s, "
                   f"{res.n_nodes} nodes, {res.n_supersteps} supersteps, "
                   f"{sv.launches} launches)"
                   if res is not None else "raised"))
    # -- the comparison, with the program's state let go ----------------
    del sess, prof
    if device == "cuda":
        torch.cuda.empty_cache()
    import checks
    verdict = checks.judge(run, checked, rec, problem, sample, device,
                           log=log)
    out.update(correct=verdict["correct"], failed=verdict["failed"],
               checks=verdict["checks"])
    order = ["correct", "attempted", "failed", "metrics", "device"]
    if "breakdown" in out:
        order.append("breakdown")
    order.append("checks")
    return {k: out[k] for k in order}


# --------------------------------------------------------------------------
# the card and its trace
# --------------------------------------------------------------------------

def device_info(device: str, mem: int) -> dict:
    import torch
    if device != "cuda":
        return dict(platform="cpu", kind="cpu", count=1,
                    memory_peak_bytes=int(mem))
    return dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                count=1, memory_peak_bytes=int(mem))


def card_int_peak() -> float:
    """The card's int32 peak: its SMs at their maximum clock
    (``nvidia-smi``; the data sheet's 1980 MHz where it cannot say)."""
    import subprocess
    import torch
    import roofline
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    try:
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30).stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        mhz = 1980.0
    return roofline.int32_peak(sms, mhz)


def device_events(prof):
    """(name, start s, seconds) of every operation on the card in a
    finished trace, relative to the trace's start: read from the
    profiler's raw results (building its per-event objects takes minutes
    for a window of some hundred thousand launches), or from its events
    where this torch has no such results."""
    from torch.autograd import DeviceType
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    try:
        t0 = raw.trace_start_ns()
        return [(e.name(), (e.start_ns() - t0) / 1e9,
                 (e.end_ns() - e.start_ns()) / 1e9)
                for e in raw.events() if e.device_type() == DeviceType.CUDA]
    except AttributeError:
        return [(e.name, e.time_range.start / 1e6,
                 (e.time_range.end - e.time_range.start) / 1e6)
                for e in prof.events() if e.device_type == DeviceType.CUDA]


def read_trace(run: Run, prof, t0: float, t_last: float):
    """The device's operations in the traced window, as (name, start s
    from the window's start, seconds), and its busy and window seconds.
    The trace's clock starts with the profiler, just before the window."""
    ops = sorted(device_events(prof), key=lambda o: o[1])
    run.device_ops = ops
    run.window_s = t_last - t0
    busy, reach = 0.0, 0.0
    for _, a, d in ops:
        b = a + d
        if b > reach:
            busy += b - max(a, reach)
            reach = b
    run.busy_s = busy


def breakdown(run: Run, spans) -> dict:
    """The ten device operations that took most time, and the ten
    longest idle gaps, each named by what the harness was doing then."""
    by_name: Dict[str, float] = {}
    for name, _, d in run.device_ops or ():
        by_name[name] = by_name.get(name, 0.0) + d
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    def doing(t):
        at = run.t0 + t
        inner = [s for s in spans if s[1] <= at < s[2]]
        return min(inner, key=lambda s: s[2] - s[1])[0] if inner else "harness"

    gaps, reach = [], 0.0
    for _, a, d in run.device_ops or ():
        if a > reach:
            gaps.append((a - reach, (a + reach) / 2))
        reach = max(reach, a + d)
    if run.window_s > reach:
        gaps.append((run.window_s - reach, (run.window_s + reach) / 2))
    gaps.sort(key=lambda g: -g[0])
    named = [[f"{doing(mid)} @{mid:.3f}s", g] for g, mid in gaps[:10]]
    return {"device_ops": [[n[:120], s] for n, s in top],
            "idle_gaps": named}
