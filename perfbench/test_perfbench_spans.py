"""The readers of the program's phases (`spans.py`): the clock's bracket
on synthetic runs with a known offset, a jump and a drift of the
device's clock, a launch whose own bounds are empty, several kernels
enqueued before one read, no clock where a kernel's stamps and its
device operations do not pair, the
card's idle time by phase on synthetic intervals, and ``eps_host_s`` and
``quantum_host_ms`` on the CPU cells of ``test_perfbench_run.py``."""

import sys
from pathlib import Path
from types import SimpleNamespace as NS
from typing import NamedTuple

import pytest

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import harness  # noqa: E402
import spans  # noqa: E402

T0 = 1000.0                      # the device's zero on the host clock
EPS_OP = "void (anonymous namespace)::fixpoint_few_kernel<false, true>(...)"
SEARCH_OP = "void (anonymous namespace)::search_kernel<false, true>(...)"
FIX_OP = "void (anonymous namespace)::fixpoint_kernel<false, true>(...)"


class FakeTrace:
    """What the readers read of ``SolveResult.trace``: spans and launch
    stamps in ns, and the phases the spans add up to."""

    def __init__(self, spans_ns, launches_ns=()):
        self.spans = spans_ns
        self.launches = list(launches_ns)
        self.phases = {}
        for name, a, b in spans_ns:
            n, s = self.phases.get(name, (0, 0.0))
            self.phases[name] = (n + 1, s + (b - a) / 1e9)

    def seconds(self, *names):
        return sum(self.phases[k][1] for k in names or self.phases
                   if k in self.phases)

    def count(self, name):
        return self.phases.get(name, (0, 0.0))[0]


def ns(t):
    return int(round(t * 1e9))


class Launch(NamedTuple):
    spans: list                  # the host's phases around it, ns
    stamps: list                 # (kernel, enqueue ns) of its kernels
    ops: list                    # (name, device start, duration)

    @property
    def op(self):
        return self.ops[0]


def launch(kind, at, head, dur, tail, host=0.0, kernels=1):
    """One launch enqueued at host time `at` (after `host` s of host
    work), its kernel starting `head` s after the enqueue and lasting
    `dur`, the read returning `tail` s after it ends.  Under
    ``kind="cuda"`` a search quantum of `kernels` fixpoint launches, 1 µs
    apart, each kernel `head` s after its enqueue and `dur` long, the
    next one not before the last has ended."""
    phase, read, op = {
        "eps": ("eps.launch", "eps.wait", EPS_OP),
        "search": ("search.launch", "search.read", SEARCH_OP),
        "cuda": ("search.launch", "search.read", FIX_OP)}[kind]
    kernel = op.split("::")[1].split("<")[0]
    pre = "eps.host" if kind == "eps" else "search.host"
    enq = [at + i * 1e-6 for i in range(kernels)]
    ops, end = [], 0.0
    for e in enq:
        start = max(e + head, end)
        ops.append((op, start - T0, dur))
        end = start + dur
    ret = end + tail
    return Launch([(pre, ns(at - host), ns(at)),
                   (phase, ns(at), ns(enq[-1] + 1e-6)),
                   (read, ns(enq[-1] + 1e-6), ns(ret))],
                  [(kernel, ns(e)) for e in enq], ops)


def solve(launches, t_start, t_built=None, t_compiled=None):
    sp = [s for ln in launches for s in ln.spans]
    st = [s for ln in launches for s in ln.stamps]
    t_built = t_start if t_built is None else t_built
    t_compiled = t_built if t_compiled is None else t_compiled
    return harness.Solve(k=0, inst=None, t_start=t_start, t_built=t_built,
                         t_compiled=t_compiled, t_done=sp[-1][2] / 1e9,
                         result=NS(trace=FakeTrace(sp, st)))


def ops_of(launches):
    return [o for ln in launches for o in ln.ops]


def make_run(solves, ops, t0=None, window_s=None):
    t0 = solves[0].t_start if t0 is None else t0
    t_last = max(s.t_done for s in solves)
    run = harness.Run(cell={}, config={}, traffic={}, seconds=1.0,
                      setup_s=1.0, t0=t0, t_end=t0 + 1.0, solves=solves)
    run.device_ops = sorted(ops, key=lambda o: o[1])
    run.window_s = t_last - t0 if window_s is None else window_s
    return run


def _launches(heads, tails, kind="eps", at=T0 + 0.5, gap=0.01):
    out = []
    for i, (h, t) in enumerate(zip(heads, tails)):
        out.append(launch(kind, at + i * gap, h, 0.002, t, host=0.001))
    return out


# ---- the clock --------------------------------------------------------------

def test_the_bracket_holds_the_known_offset():
    eps = _launches([40e-6, 25e-6, 60e-6], [30e-6, 12e-6, 20e-6])
    res = _launches([8e-6, 15e-6], [22e-6, 9e-6], kind="search",
                    at=T0 + 0.6, gap=0.02)
    sv = solve(eps + res, T0 + 0.49)
    run = make_run([sv], ops_of(eps + res))
    ck = spans.clock(run)
    # lo = T0 − the least head (8 µs), hi = T0 + the least tail (9 µs)
    assert len(ck.t0s) == 1 and ck.n_launches == 5
    assert ck.width_s == pytest.approx(17e-6, abs=1e-8)
    assert ck.t0s[0] == pytest.approx(T0 + 0.5e-6, abs=1e-8)
    assert ck.share_within(100e-6) == 1.0 and ck.share_within(1e-6) == 0.0
    assert ck.to_host(0.25) == pytest.approx(T0 + 0.25 + 0.5e-6, abs=1e-8)
    assert spans.clock(run) is ck              # once per run


def test_a_jump_of_the_device_clock_starts_a_segment():
    a = _launches([10e-6, 20e-6], [10e-6, 10e-6])
    b = _launches([10e-6, 20e-6], [10e-6, 10e-6], at=T0 + 5.0)
    ops_a = ops_of(a)
    # from the second solve on, the device's clock runs 100 µs behind
    ops_b = [(n, s - 100e-6, d) for n, s, d in ops_of(b)]
    run = make_run([solve(a, T0 + 0.49), solve(b, T0 + 4.99)],
                   ops_a + ops_b)
    ck = spans.clock(run)
    assert ck.sizes == [2, 2] and ck.dev_starts[0] == -float("inf")
    assert ck.t0s[1] - ck.t0s[0] == pytest.approx(100e-6, abs=1e-8)
    assert ck.width_s == pytest.approx(20e-6, abs=1e-8)
    for _, start, _ in ops_of(b):           # on the device's own clock
        assert ck.to_host(start - 100e-6) == pytest.approx(start + T0,
                                                           abs=1e-8)


def test_a_drifting_device_clock_is_followed_by_segments():
    """The device's clock gains 5 µs a launch over 30 launches, each
    bounding T0 to 20 µs: no bracket is empty or wider than a launch's,
    and each launch's kernel lands within its bracket of where it ran."""
    eps = _launches([10e-6] * 30, [10e-6] * 30)
    ops = [(n, s + 5e-6 * i, d) for i, (n, s, d) in enumerate(ops_of(eps))]
    run = make_run([solve(eps, T0 + 0.49)], ops)
    ck = spans.clock(run)
    assert len(ck.t0s) > 1 and ck.n_launches == 30
    assert ck.width_s <= 20e-6 + 1e-9
    for (_, start, _), (_, s, _) in zip(ops_of(eps), ops):
        assert abs(ck.to_host(s) - (start + T0)) <= 20e-6 + 1e-9


def test_a_launch_at_odds_with_itself_bounds_nothing():
    """A kernel that outlasts its launch's enqueue to its read (the two
    clocks ran apart during it) ends its segment, joins none and is
    counted; a run of nothing else has no clock."""
    eps = _launches([10e-6, 20e-6, 15e-6], [10e-6, 10e-6, 12e-6])
    ops = ops_of(eps)
    ops[1] = (ops[1][0], ops[1][1], 0.01)
    run = make_run([solve(eps, T0 + 0.49)], ops)
    ck = spans.clock(run)
    assert ck.skipped == 1 and ck.sizes == [1, 1] and ck.n_launches == 2
    assert ck.t0s == [pytest.approx(T0, abs=1e-8),
                      pytest.approx(T0 - 1.5e-6, abs=1e-8)]
    assert spans.idle_unnamed(run) is not None
    one = make_run([solve(eps[1:2], T0 + 0.49)], ops[1:2])
    assert spans.clock(one) is None and spans.idle_unnamed(one) is None


def test_a_count_mismatch_gives_no_clock():
    eps = _launches([10e-6, 20e-6, 30e-6], [10e-6] * 3)
    run = make_run([solve(eps, T0 + 0.49)], ops_of(eps)[:2])
    assert spans.clock(run) is None
    extra = ops_of(eps) + [(EPS_OP, 0.7, 0.001)]
    assert spans.clock(make_run([solve(eps, T0 + 0.49)], extra)) is None


def test_the_clock_follows_the_kernels_the_program_names():
    """Under the ``cuda`` backend a quantum enqueues several fixpoint
    launches before its one read: each stamp is paired with that
    kernel's operations alone (``fixpoint_kernel`` is not
    ``fixpoint_few_kernel``), a kernel the program never stamped
    changes nothing, and a stamp with no read after it gives no clock."""
    eps = _launches([40e-6, 25e-6], [30e-6, 12e-6])
    quantum = [launch("cuda", T0 + 0.6, 8e-6, 0.002, 9e-6, host=0.001,
                      kernels=3)]
    other = [(SEARCH_OP, 0.65, 0.001)]
    run = make_run([solve(eps + quantum, T0 + 0.49)],
                   ops_of(eps + quantum) + other)
    assert len(spans.kernel_ops(run, "fixpoint_kernel")) == 3
    assert len(spans.kernel_ops(run, "fixpoint_few_kernel")) == 2
    ck = spans.clock(run)
    # lo = T0 − the first kernel's 8 µs head, hi = T0 + the last's tail
    assert ck.n_launches == 5 and len(ck.t0s) == 1
    assert ck.width_s == pytest.approx(17e-6, abs=1e-8)
    assert ck.t0s[0] == pytest.approx(T0 + 0.5e-6, abs=1e-8)
    sv = solve(eps + quantum, T0 + 0.49)
    sv.result.trace.launches.append(("fixpoint_kernel", ns(T0 + 0.7)))
    late = make_run([sv], ops_of(eps + quantum) + [(FIX_OP, 0.7, 0.001)])
    assert spans.launch_stamps(sv.result.trace) is None
    assert spans.clock(late) is None


def test_no_timeline_or_no_program_trace_gives_nothing():
    eps = _launches([10e-6], [10e-6])
    sv = solve(eps, T0 + 0.49)
    sv.result.trace.spans = None               # phases without a timeline
    run = make_run([sv], ops_of(eps))
    assert spans.clock(run) is None
    sv.result = NS()                           # a program without phases
    run = make_run([sv], ops_of(eps))
    for read in (spans.clock, spans.idle_unnamed, spans.eps_host_s,
                 spans.quantum_host_ms):
        assert read(run) is None


# ---- the card's idle time by phase -----------------------------------------

def test_idle_by_phase_on_synthetic_intervals():
    """One solve: build 0.1 s and compile 0.05 s (no device work), then
    two EPS launches of 2 ms, each after 1 ms of host work; the window
    starts 0.02 s before the build."""
    t = T0 + 1.0
    eps = [launch("eps", t + 0.151, 10e-6, 0.002, 10e-6, host=0.001),
           launch("eps", t + 0.15402, 10e-6, 0.002, 10e-6, host=0.001)]
    sv = solve(eps, t, t + 0.1, t + 0.15)
    run = make_run([sv], ops_of(eps), t0=t - 0.02)
    by = spans.idle_by_phase(run)
    assert by["build"] == pytest.approx(0.1, abs=1e-7)
    assert by["compile"] == pytest.approx(0.05, abs=1e-7)
    # the host work before each launch, its enqueue (the first µs of the
    # kernel's 10 µs head), and the wait: the rest of the head and the
    # 10 µs tail
    assert by["eps.host"] == pytest.approx(0.002, abs=1e-8)
    assert by["eps.launch"] == pytest.approx(2e-6, abs=1e-8)
    assert by["eps.wait"] == pytest.approx(2 * 9e-6 + 2 * 10e-6, abs=1e-8)
    # what no phase covers: the 0.02 s before the build
    assert by[None] == pytest.approx(0.02, abs=1e-7)
    idle = sum(by.values())
    assert spans.idle_unnamed(run) == pytest.approx(100 * 0.02 / idle,
                                                    rel=1e-5)


# ---- the phases on the CPU cells -------------------------------------------

@pytest.mark.parametrize("cell,names", [
    ("j120-first", ("eps_host_s", "quantum_host_ms.j120")),
    ("j60-deadline", ("quantum_host_ms.j60",))])
def test_the_phase_readers_read_the_cpu_cells(cell, names):
    """The cells of ``test_perfbench_run.py`` (16 jobs, 8 lanes), their
    new per-layer metrics read in an untraced run: numbers from the
    phases alone, none from the device's trace."""
    import test_perfbench_run as T
    threads = T.torch.get_num_threads()
    spec = T.tiny(cell)
    new = names + (f"idle_unnamed.{cell.split('-')[0]}",)
    spec["e2e"] = spec["e2e"] + [{"name": n, "unit": "x"} for n in new]
    T.torch.set_num_threads(1)          # as test_perfbench_run's fixture
    try:
        out = T.run(spec)
    finally:
        T.torch.set_num_threads(threads)
    got = {k: v["value"] for k, v in out["metrics"].items()}
    for n in names:
        assert got[n] > 0, (n, got)
    assert not any(k.startswith("idle_unnamed") for k in got)
    if "eps_host_s" in got:
        # EPS's host phases are part of the program's own EPS clock
        assert got["eps_host_s"] < 1.0
