"""The benchmark's parts on the CPU: the generator against ProGen's
definitions, the reference against hand-made schedules and the program's
fixpoints, the roofline count against hand-computed values, and the
files that ``BENCHMARK.json`` names."""

import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import harness  # noqa: E402
import progen  # noqa: E402
import reference as R  # noqa: E402
import roofline  # noqa: E402

SEEDS = [0, 7, 2**31 + 11, 2**40 + 3]


def _ess_peak(d, arcs, q):
    """Peak demand per resource of the precedence-only earliest-start
    schedule, computed apart from the generator."""
    n = len(d)
    es = [0] * n
    for _ in range(n):
        for i, j in arcs:
            es[j] = max(es[j], es[i] + d[i])
    h = max(es[i] + d[i] for i in range(n))
    peak = []
    for k in range(q.shape[0]):
        peak.append(max(sum(q[k][i] for i in range(n)
                            if es[i] <= t < es[i] + d[i]) for t in range(h)))
    return np.asarray(peak)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n,nc,rf,rs", [(30, 1.5, 1.0, 0.2),
                                        (60, 2.1, 0.25, 0.7),
                                        (32, 1.8, 0.5, 0.5),
                                        (40, 1.5, 0.75, 1.0)])
def test_generator_meets_progen_definitions(n, nc, rf, rs, seed):
    inst = progen.generate(n, nc, rf, rs, seed)
    assert inst.n == n and inst.q.shape == (4, n)
    assert ((1 <= inst.d) & (inst.d <= 10)).all()
    used = inst.q > 0
    assert ((inst.q[used] >= 1) & (inst.q[used] <= 10)).all()
    # RF: the share of the 4 resources each job requests, exactly
    assert (used.sum(0) == round(rf * 4)).all()
    assert used.mean() == rf
    # NC: non-redundant arcs per job, degrees at most 3
    assert len(inst.arcs) == math.floor(nc * n + 0.5)
    assert len(set(inst.arcs)) == len(inst.arcs)
    assert all(i < j for i, j in inst.arcs)
    assert progen.redundant_arcs(n, inst.arcs) == []
    succ = np.bincount([i for i, _ in inst.arcs], minlength=n)
    pred = np.bincount([j for _, j in inst.arcs], minlength=n)
    assert succ.max() <= 3 and pred.max() <= 3
    # RS: capacity between the largest demand and the ESS peak
    k_min = inst.q.max(1)
    k_max = _ess_peak(inst.d, inst.arcs, inst.q)
    assert (inst.cap == k_min + np.floor(rs * (k_max - k_min) + 0.5)).all()


def test_generator_is_a_function_of_the_seed():
    a = progen.generate(60, 1.5, 1.0, 0.2, 2**31 + 5)
    b = progen.generate(60, 1.5, 1.0, 0.2, 2**31 + 5)
    c = progen.generate(60, 1.5, 1.0, 0.2, 2**31 + 6)
    assert a.arcs == b.arcs and (a.d == b.d).all() and (a.q == b.q).all()
    assert a.arcs != c.arcs or (a.d != c.d).any()


def _serial_schedule(inst):
    """A feasible schedule: jobs in index order, each at its first start
    after its predecessors where every resource has room."""
    n = inst.n
    h = inst.horizon
    use = np.zeros((inst.q.shape[0], h + 1), dtype=np.int64)
    s = np.zeros(n, dtype=np.int64)
    for j in range(n):
        t = max([s[i] + inst.d[i] for i, jj in inst.arcs if jj == j],
                default=0)
        while (use[:, t:t + inst.d[j]] + inst.q[:, j:j + 1]
               > inst.cap[:, None]).any():
            t += 1
        s[j] = t
        use[:, t:t + inst.d[j]] += inst.q[:, j:j + 1]
    return s


@pytest.mark.parametrize("seed", SEEDS)
def test_reference_rejects_broken_schedules(seed):
    inst = progen.generate(30, 1.5, 1.0, 0.2, seed)
    s = _serial_schedule(inst)
    ok, mk, _ = R.check_schedule(inst, s)
    assert ok and mk == int((s + inst.d).max()) >= R.lower_bound(inst)
    i, j = inst.arcs[0]
    early = s.copy()
    early[j] = s[i] + inst.d[i] - 1                 # j starts before i ends
    assert not R.check_schedule(inst, early)[0]
    crowd = np.zeros_like(s)                        # all at once
    ok, _, why = R.check_schedule(inst, crowd)
    assert not ok


def _program_fixpoints(inst, layout, lb, ub):
    from repro_torch.core import fixpoint as F
    from repro_torch.core.models import rcpsp
    m, handles = rcpsp.build_model(rcpsp.RCPSP(
        durations=inst.d, precedences=list(inst.arcs), usage=inst.q,
        capacity=inst.cap))
    cm = m.compile(device="cpu", bank_layout=layout)
    assert cm.cu_layout == layout
    cols = np.asarray([v.idx for v in handles["s"]] + [handles["mk"].idx, 0])
    V = cm.n_vars
    plb = torch.zeros((lb.shape[0], V), dtype=cm.tdtype)
    pub = torch.zeros((lb.shape[0], V), dtype=cm.tdtype)
    plb[:, cols] = torch.as_tensor(lb, dtype=cm.tdtype)
    pub[:, cols] = torch.as_tensor(ub, dtype=cm.tdtype)
    nlb, nub, _, _ = F.fixpoint_batch(cm, plb, pub)
    return nlb[:, cols].long(), nub[:, cols].long()


@pytest.mark.parametrize("layout", ["dense", "sparse"])
@pytest.mark.parametrize("seed", [1, 2**33 + 9])
def test_reference_fixpoints_equal_the_programs(layout, seed):
    """The greatest common fixpoint is one, whatever computes it: the
    reference's equals the program's plain sweep in both bank layouts,
    on random sub-boxes of the root."""
    inst = progen.generate(14, 1.5, 1.0, 0.2, seed)
    prop = R.Propagator(inst)
    lb, ub = prop.root()
    r = np.random.default_rng(seed)
    lbs, ubs = [lb[0].clone()], [ub[0].clone()]
    for _ in range(63):
        l, u = lb[0].clone(), ub[0].clone()
        for v in r.choice(inst.n + 1, size=3, replace=False):
            cut = int(r.integers(0, inst.horizon // 2 + 1))
            if r.random() < 0.5:
                l[v] = cut
            else:
                u[v] = inst.horizon - cut
        lbs.append(l)
        ubs.append(u)
    lb, ub = torch.stack(lbs), torch.stack(ubs)
    rl, ru, rf = prop.fixpoint(lb, ub)
    gl, gu = _program_fixpoints(inst, layout, lb, ub)
    gf = (gl > gu).any(1)
    assert (rf == gf).all()
    assert bool((~rf).any())
    assert (rl[~rf] == gl[~rf]).all() and (ru[~rf] == gu[~rf]).all()


def _tiny_instance():
    return progen.Instance(
        d=np.array([1, 2, 3]), arcs=((0, 1), (1, 2)),
        q=np.array([[1, 2, 0], [0, 1, 1]]), cap=np.array([2, 2]),
        nc=0.0, rf=0.0, rs=0.0, seed=0)


def test_roofline_count_by_hand():
    inst = _tiny_instance()
    # 5 precedence rows (2 arcs, 3 ends): 8·2·5 + 2·2·5; two resources of
    # two tasks: 4·2 + 2·2 and min(2·6, 4·2·2 + 8) each
    assert roofline.ops_per_sweep(inst) == 100 + 2 * (12 + 12)
    assert roofline.table_bytes(inst) == 4 * (5 * 5 + 3 * 4 + 2)
    assert roofline.lane_state_bytes(inst, 10) == 100 + 90 + 28 + 4
    assert roofline.search_work(inst, 2, 10, 7, 3, 1) == (
        2 * 2 * 222 + 156, 7 * 148 + 3 * 2 * (2 * 5 + 3 * 4))
    assert roofline.fixpoint_work(inst, 4, 3, 2) == (240 + 2 * 156, 4 * 148)
    peak = roofline.int32_peak(132, 1980)
    assert peak == pytest.approx(16.727e12, rel=1e-3)
    assert roofline.least_seconds(3.35e12, 1.0, peak) == pytest.approx(1.0)


def test_every_name_resolves_to_its_file():
    bench = harness.benchmark()
    for c in bench["configs"]:
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        problem = harness.problem_of(cfg)
        for part in ("draw", "model", "answer_ok"):
            assert callable(getattr(problem, part))
        assert problem.reference.LANE_FIELDS
    for w in bench["workloads"]:
        spec = harness.cell_spec(w["name"])
        assert spec["traffic"]["preset"] in ("prove", "first_solution")
        assert callable(harness.loop_of(spec["traffic"]).run)
        names = [m["name"] for m in spec["e2e"]]
        assert "setup_s" in names and len(names) >= 2
        assert spec["layer"]
        moved = {m["moves"] for m in spec["layer"]}
        assert moved <= set(names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.load_metric(m["name"]).read)
    with pytest.raises(FileNotFoundError):
        harness.load_metric("no_such_metric")
    with pytest.raises(FileNotFoundError):
        harness.loop_of({"loop": "no_such_loop"})
    with pytest.raises(FileNotFoundError):
        harness.problem_of({"problem": "no_such_problem"})
    with pytest.raises(KeyError):
        harness.cell_spec("no-such-cell")


def test_readers_return_nothing_without_their_data():
    run = harness.Run(cell={}, config={"solver": {}}, traffic={},
                      seconds=1.0, setup_s=2.0, t0=0.0, t_end=1.0,
                      solves=[])
    bench = harness.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        v = harness.load_metric(m["name"]).read(run)
        assert v is None or m["name"] == "setup_s"


def test_every_seed_visits_the_same_instances():
    spec = harness.cell_spec("j120-first")
    a = harness.instance_set(spec["config"], spec["traffic"])
    b = harness.instance_set(spec["config"], spec["traffic"])
    assert [i.name for i in a] == [i.name for i in b]
    M = spec["traffic"]["set_size"]
    for seed in (1, 2**31 + 9):
        order = harness.visit_order(spec["traffic"], seed)
        first = [next(order) for _ in range(M)]
        assert sorted(first) == list(range(M))


def test_class_points_follow_the_mix():
    cfg = json.loads((HERE / "configs" / "psplib-j120.json").read_text())
    P = harness.problem_of(cfg)
    hard = P.class_point(cfg, {"class_point": "hardest"}, 5)
    assert hard == (1.5, 1.0, 0.1)
    cyc = {P.class_point(cfg, {"class_point": "cycle"}, k)
           for k in range(60)}
    assert len(cyc) == 60                           # the whole J120 grid
    listed = {"class_point": [[1.8, 0.5, 0.2], [2.1, 1.0, 0.4]]}
    assert [P.class_point(cfg, listed, k) for k in range(3)] == [
        (1.8, 0.5, 0.2), (2.1, 1.0, 0.4), (1.8, 0.5, 0.2)]
    with pytest.raises(ValueError):
        P.class_point(cfg, {"class_point": "easiest"}, 0)


def test_drawn_instances_follow_the_seed():
    """The instances checked after the window are a function of the
    seed alone, and differ from seed to seed and from the window's set."""
    spec = harness.cell_spec("j60-deadline")
    cfg, mix = spec["config"], spec["traffic"]
    a = harness.drawn_instances(cfg, mix, 2**31 + 21)
    b = harness.drawn_instances(cfg, mix, 2**31 + 21)
    c = harness.drawn_instances(cfg, mix, 2**31 + 22)
    assert len(a) == mix["check_drawn"] >= 1
    assert [i.name for i in a] == [i.name for i in b]
    assert {i.name for i in a}.isdisjoint(i.name for i in c)
    window = {i.name for i in harness.instance_set(cfg, mix)}
    assert window.isdisjoint(i.name for i in a)
    assert all((i.nc, i.rf, i.rs) == (1.5, 1.0, 0.2) for i in a)


def _renamed(fn, old, new):
    """`fn` with its parameter `old` called `new`."""
    import inspect
    sig = inspect.signature(fn)
    params = [p.replace(name=new) if p.name == old else p
              for p in sig.parameters.values()]

    def wrapped(*a, **kw):
        return fn(*a, **kw)
    wrapped.__signature__ = sig.replace(parameters=params)
    return wrapped


@pytest.mark.parametrize("module,path,param", [
    ("repro_torch.core.eps", "decompose", "target"),
    ("repro_torch.core.backend", "CudaResidentBackend.superstep_launch",
     "pool_head"),
    ("repro_torch.core.search", "lanes_step", "gbest"),
    ("repro_torch.core.backend", "CudaBackend.fixpoint_batch", "lb"),
])
def test_a_changed_hook_stops_the_run_by_name(module, path, param,
                                              monkeypatch):
    """A program change to a call the harness records through stops the
    run with an error naming that call, not a wrong comparison."""
    harness.check_hooks(R.LANE_FIELDS)
    owner, name, fn = harness.hook_target(module, path)
    monkeypatch.setattr(owner, name, _renamed(fn, param, param + "_"))
    with pytest.raises(harness.HookError, match=path.replace(".", r"\.")):
        harness.check_hooks(R.LANE_FIELDS)


def test_a_missing_lane_field_stops_the_run_by_name():
    with pytest.raises(harness.HookError, match="no_such_field"):
        harness.check_hooks(R.LANE_FIELDS + ("no_such_field",))
