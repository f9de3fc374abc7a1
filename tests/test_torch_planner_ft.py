"""The port's planner, collectives, sharding rules and fault tolerance
(`distributed/{planner,collectives,sharding}.py`, `ft/fault_tolerance.py`)
against the JAX package's, and `chip_smoke.py`'s distributed J30
constants recomputed from the JAX package.

Host logic runs in-process on both sides (`plan_steal` on 50 random
inputs, the heartbeat and injector schedules, `solver_shard_loss`,
`rebalance_lanes`, `scaled_batch`, the planner's solves on the CPU).
What needs a JAX mesh (`solver_bound_sync` under ``shard_map``,
`spec_for` and `dist_solve_specs` over a real mesh, the distributed J30
solves) runs once for the file in the ``fake_devices`` subprocess.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from repro.distributed import planner as jplanner
from repro.ft import fault_tolerance as jft
from repro_torch.core import search as TS
from repro_torch.core.models import rcpsp as trcpsp
from repro_torch.distributed import planner as tplanner
from repro_torch.distributed import sharding as tsh
from repro_torch.distributed.collectives import (all_any, all_every, all_min,
                                                 solver_bound_sync)
from repro_torch.ft import fault_tolerance as tft
from repro_torch.solver import SolveConfig, Solver

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

# (shape, logical axes, rule table name) of the spec comparisons, over a
# ("pod", "data") mesh of 2 x 4 and the 1-D "solve" mesh of 4
SPEC_CASES = [
    ((64, 10), ("lanes", None), "solve"),
    ((6, 3), ("lanes", None), "solve"),          # 6 % 4: replicated
    ((0,), ("lanes",), "solve"),
    ((128, 7), ("pool", None), "solve"),
    ((16, 8, 4), ("batch", "embed", None), "custom"),
    ((16, 8), ("batch", "batch"), "custom"),     # an axis used once
    ((6, 8), ("batch", "embed"), "custom"),      # 6 % 8: dropped
    ((4,), ("model",), "custom"),
]
CUSTOM = {"batch": ("pod", "data"), "embed": ("data",), "model": ("pod",)}
BOUND_INPUTS = [  # (best per shard, done per shard, has-solution per shard)
    ([5, 3, 9, 3], [True, True, False, True], [False, True, False, False]),
    ([7, 7], [True, True], [False, False]),
    ([2**29, 11, 4, 12, 4, 90, 2**29, 8],
     [True] * 8, [False, False, True, False, True, False, False, True]),
]

_JAX_CODE = r"""
import json
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import solver
from repro.compat import make_mesh, shard_map
from repro.core import dist_solve
from repro.core import search as S
from repro.core.api import Solver
from repro.core.models import rcpsp
from repro.distributed import sharding as SH
from repro.distributed.collectives import solver_bound_sync

SPEC_CASES = %(spec_cases)r
CUSTOM = %(custom)r
BOUND_INPUTS = %(bound_inputs)r
out = {}
meshes = {"solve": make_mesh((4,), ("solve",)),
          "custom": make_mesh((2, 4), ("pod", "data"))}
rules = {"solve": SH.SOLVE_RULES, "custom": CUSTOM}
out["specs"] = [[list(e) if isinstance(e, tuple) else e
                 for e in SH.spec_for(tuple(shape), tuple(axes),
                                      rules[r], meshes[r])]
                for shape, axes, r in SPEC_CASES]
inst = rcpsp.generate(5, n_resources=2, seed=1, edge_prob=0.3)
cm = rcpsp.build_model(inst)[0].compile()
state = S.init_lanes(cm, 8, S.SearchOptions())
pool_spec, carry_spec = SH.dist_solve_specs(state, 32, meshes["solve"])
out["dist_specs"] = dict(
    pool=list(pool_spec),
    state=[list(s) for s in carry_spec[0] if s is not None],
    scalars=[list(s) for s in carry_spec[1:4]], heads=list(carry_spec[4]))

out["bound"] = []
for best, done, any_sol in BOUND_INPUTS:
    D = len(best)
    mesh = make_mesh((D,), ("x",))
    f = shard_map(lambda b, d, a: tuple(
        jnp.reshape(v, (1,)) for v in solver_bound_sync(b[0], d[0], a[0],
                                                        "x")),
        mesh=mesh, in_specs=(P("x"), P("x"), P("x")),
        out_specs=(P("x"), P("x"), P("x")), check_vma=False)
    r = f(jnp.asarray(best, jnp.int32), jnp.asarray(done), jnp.asarray(any_sol))
    out["bound"].append([np.asarray(v).tolist() for v in r])

inst = rcpsp.generate(30, n_resources=4, seed=0)
cm = rcpsp.build_model(inst)[0].compile()
cfg0 = solver.SolveConfig.preset("prove", n_lanes=16, eps_target=64)
out["j30"] = {}
for D in (1, 2, 4):
    cfg = cfg0.replace(mesh_shards=D)
    res, tr = dist_solve.solve_dist(cm, cfg, session=Solver(cfg))
    out["j30"][str(D)] = dict(
        status=res.status, objective=res.objective, n_nodes=res.n_nodes,
        n_fails=res.n_fails, n_sols=res.n_sols, n_sweeps=res.n_sweeps,
        n_supersteps=res.n_supersteps)
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref(fake_devices):
    out = fake_devices(_JAX_CODE % dict(spec_cases=SPEC_CASES, custom=CUSTOM,
                                        bound_inputs=BOUND_INPUTS))
    return json.loads(out.split("RESULT ", 1)[1])


def _plain(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------

def test_plan_steal_random_inputs_match():
    """The recipe and seed of ``tests/test_dist_solve.py``."""
    rng = np.random.default_rng(0)
    for _ in range(50):
        D = int(rng.integers(1, 6))
        owned = [list(map(int, rng.choice(1000, size=rng.integers(0, 20),
                                          replace=False) + 1000 * d))
                 for d in range(D)]
        n = int(rng.integers(1, 6))
        for shards in (D, n):
            got = tplanner.plan_steal(owned, shards)
            assert got == jplanner.plan_steal(owned, shards)
            sizes = [len(o) for o in got[0]]
            assert max(sizes) - min(sizes) <= 1
            assert (sorted(x for o in got[0] for x in o)
                    == sorted(x for o in owned for x in o))


def test_plan_steal_keeps_local_work_and_shrinks():
    for owned, n in (([[1, 2, 3, 4, 5, 6], []], 2), ([[1, 2], [3, 4]], 2),
                     ([[0, 1], [2, 3], [4, 5]], 2), ([[9], [], [7, 8]], 1)):
        assert tplanner.plan_steal(owned, n) == jplanner.plan_steal(owned, n)
    assert tplanner.plan_steal([[1, 2, 3, 4, 5, 6], []], 2) == (
        [[1, 2, 3], [4, 5, 6]], 3)
    assert tplanner.plan_steal([[1, 2], [3, 4]], 2) == ([[1, 2], [3, 4]], 0)


def test_plan_partition_matches():
    """The inputs of ``tests/test_planner.py``."""
    costs = [5, 5, 5, 8, 8, 8, 8, 5, 5, 5, 5, 9]
    mems = [2] * 12
    got = tplanner.plan_partition(costs, mems, 4, mem_cap=8, timeout_s=120,
                                  device="cpu")
    assert got == jplanner.plan_partition(costs, mems, 4, mem_cap=8,
                                          timeout_s=120)
    stages, T = got
    assert stages == sorted(stages) and set(stages) == {0, 1, 2, 3}
    assert max(sum(c for c, s in zip(costs, stages) if s == k)
               for k in range(4)) == T


def test_plan_partition_infeasible_raises():
    with pytest.raises(ValueError, match="no feasible partition"):
        tplanner.plan_partition([1, 1], [9, 9], 2, mem_cap=8, timeout_s=30,
                                device="cpu")


def test_schedule_microbatches_matches():
    starts, mk, res = tplanner.schedule_microbatches([3, 3, 3], 3,
                                                     timeout_s=120,
                                                     device="cpu")
    jstarts, jmk, jres = jplanner.schedule_microbatches([3, 3, 3], 3,
                                                        timeout_s=120)
    assert (starts, mk) == (jstarts, jmk) and mk == (3 + 3 - 1) * 3
    for k in ("status", "n_nodes", "n_fails", "n_sweeps", "n_supersteps"):
        assert getattr(res, k) == getattr(jres, k), k
    for s in range(3):
        times = sorted(row[s] for row in starts)
        assert all(a + 3 <= b for a, b in zip(times, times[1:]))


def test_pipeline_efficiency_matches():
    for args in (([3, 3, 3], 15, 3), ([3, 3, 3], 30, 3), ([4, 1], 0, 2),
                 ([5, 2, 7], 31, 4)):
        assert (tplanner.pipeline_efficiency(*args)
                == jplanner.pipeline_efficiency(*args))


def test_planner_needs_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tplanner.plan_partition([1, 2], [1, 1], 2, mem_cap=8)


# ---------------------------------------------------------------------------
# collectives and sharding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", range(len(BOUND_INPUTS)))
def test_solver_bound_sync_matches(ref, case):
    best, done, any_sol = BOUND_INPUTS[case]
    got = solver_bound_sync(
        [torch.tensor(b, dtype=torch.int32) for b in best],
        [torch.tensor(d) for d in done], [torch.tensor(a) for a in any_sol])
    want = ref["bound"][case]
    # the reference's reduced values, replicated on every shard
    for g, w in zip(got, want):
        assert g.dim() == 0 and all(g.item() == x for x in w)
    assert got[0].dtype == torch.int32
    assert all_min([torch.tensor(4)]).item() == 4
    assert all_any([torch.tensor(False)] * 3).item() is False
    assert all_every([torch.tensor(True), torch.tensor(False)]).item() is False


def test_spec_for_matches(ref):
    meshes = {"solve": tsh.make_mesh((4,), ("solve",), device="cpu"),
              "custom": tsh.make_mesh((2, 4), ("pod", "data"), device="cpu")}
    rules = {"solve": tsh.SOLVE_RULES, "custom": CUSTOM}
    got = [_plain(tsh.spec_for(shape, axes, rules[r], meshes[r]))
           for shape, axes, r in SPEC_CASES]
    assert got == ref["specs"]


def test_dist_solve_specs_match(ref):
    inst = trcpsp.generate(5, n_resources=2, seed=1, edge_prob=0.3)
    cm = trcpsp.build_model(inst)[0].compile(device="cpu")
    state = TS.init_lanes(cm, 8, TS.SearchOptions())
    mesh = tsh.make_mesh((4,), ("solve",), device="cpu")
    pool_spec, carry_spec = tsh.dist_solve_specs(state, 32, mesh)
    want = ref["dist_specs"]
    assert _plain(pool_spec) == want["pool"]
    # no leaf for the absent bitset store
    assert [_plain(s) for s in carry_spec[0] if s is not None] == \
        want["state"]
    assert [_plain(s) for s in carry_spec[1:4]] == want["scalars"]
    assert _plain(carry_spec[4]) == want["heads"]


def test_mesh_and_shard_tree():
    cpu = torch.device("cpu")
    mesh = tsh.make_mesh((2, 3), ("a", "b"), device="cpu")
    assert mesh.shape == {"a": 2, "b": 3}
    assert mesh == tsh.make_mesh((2, 3), ("a", "b"), devices=["cpu"] * 6)
    assert hash(mesh) == hash(tsh.make_mesh((2, 3), ("a", "b"),
                                            device="cpu"))
    with pytest.raises(ValueError, match="needs 6 devices"):
        tsh.make_mesh((2, 3), ("a", "b"), devices=["cpu"] * 5)
    x = np.arange(24).reshape(12, 2)
    tree = {"x": x, "s": np.int64(7), "none": None, "odd": np.arange(5)}
    rules = {"lanes": ("a", "b")}
    parts = tsh.shard_tree(tree, mesh, rules=rules)
    assert len(parts) == 6
    for d, p in enumerate(parts):
        assert torch.equal(p["x"], torch.as_tensor(x[2 * d:2 * d + 2]))
        assert p["s"].item() == 7 and p["none"] is None
        assert torch.equal(p["odd"], torch.arange(5))   # 5 % 6: replicated
        assert p["x"].device == cpu
    # split over "b" only: 3 shards, "a" index 0
    parts = tsh.shard_tree(tree, mesh, rules={"lanes": ("b",)})
    assert [p["x"].shape[0] for p in parts] == [4, 4, 4]
    assert tsh.shard_devices(mesh, ("b", "a")) == [cpu] * 6


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------

def test_heartbeat_and_injector_schedules_match():
    for timeout, schedule, steps in ((10, {3: ["h1"]}, 6),
                                     (1, {0: ["h0"], 2: ["h2"]}, 5),
                                     (30, {}, 4)):
        logs = []
        for ft in (tft, jft):
            t = {"now": 0.0}
            hb = ft.Heartbeat(["h0", "h1", "h2"], timeout_s=timeout,
                              clock=lambda: t["now"])
            inj = ft.FailureInjector(dict(schedule))
            log = []
            for step in range(steps):
                t["now"] += 5.0
                inj.advance(step, hb)
                log.append((hb.dead_hosts(), hb.all_alive(),
                            sorted(inj.failed)))
            logs.append(log)
        assert logs[0] == logs[1]


def test_solver_heartbeat_matches():
    for n, loss in ((4, (1, 1)), (3, None), (2, (0, 1))):
        seen = []
        for ft in (tft, jft):
            hb, inj = ft.solver_heartbeat(
                n, None if loss is None else ft.DeviceLoss(*loss))
            log = []
            for chunk in range(4):
                hb.clock.t = float(chunk)
                inj.advance(chunk, hb)
                log.append(hb.dead_hosts())
            seen.append((hb.hosts, hb.timeout_s, inj.schedule, log))
        assert seen[0] == seen[1]


def _snapshot(rng, D, L, V):
    fields = dict(done=rng.random((D, L)) < 0.4,
                  fresh=rng.random((D, L)) < 0.3,
                  root_lb=rng.integers(0, 9, (D, L, V)),
                  root_ub=rng.integers(9, 20, (D, L, V)),
                  n_nodes=rng.integers(0, 50, (D, L)))
    owned = [sorted(map(int, rng.choice(100, rng.integers(0, 6),
                                        replace=False))) for _ in range(D)]
    inflight = []
    for d in range(D):
        m = ~fields["done"][d] & ~fields["fresh"][d]
        inflight.append((fields["root_lb"][d][m], fields["root_ub"][d][m]))
    return fields, owned, inflight


def test_solver_shard_loss_matches():
    import jax
    rng = np.random.default_rng(3)
    for D, lost in ((4, 1), (3, 0), (2, 1)):
        fields, owned, inflight = _snapshot(rng, D, 5, 3)
        got = tft.solver_shard_loss(dict(state=fields, owned=owned,
                                         inflight=inflight), lost)
        want = jft.solver_shard_loss(dict(state=fields, owned=owned,
                                          inflight=inflight), lost)
        assert got["owned"] == want["owned"]
        assert got["requeue_ids"] == want["requeue_ids"]
        assert got["survivors"] == want["survivors"]
        for g, w in zip(got["requeue_roots"], want["requeue_roots"]):
            assert np.array_equal(g, w)
        flat = jax.tree.map(np.asarray, want["state"])
        for k in fields:
            assert np.array_equal(got["state"][k], flat[k]), k


def test_rebalance_lanes_matches():
    rng = np.random.default_rng(5)
    for _ in range(40):
        n_lanes = int(rng.integers(1, 9))
        n_subs = int(rng.integers(1, 60))
        next_sub = rng.integers(0, n_subs + 2 * n_lanes, n_lanes)
        done = rng.random(n_lanes) < 0.3
        got = tft.rebalance_lanes(next_sub.copy(), done.copy(), n_subs,
                                  n_lanes)
        want = jft.rebalance_lanes(next_sub.copy(), done.copy(), n_subs,
                                   n_lanes)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1]) and got[2] == want[2]


def test_scaled_batch_matches():
    for gb, n in ((256, 16), (256, 15), (7, 8), (1, 1), (100, 3)):
        assert tft.scaled_batch(gb, n) == jft.scaled_batch(gb, n)


def test_elastic_remesh_places_on_the_smaller_mesh():
    st = {"a": np.arange(24).reshape(8, 3), "b": np.arange(8) > 3}
    four = tft.elastic_remesh(st, tsh.make_mesh((4,), ("solve",),
                                                device="cpu"))
    two = tft.elastic_remesh(st, tsh.make_mesh((2,), ("solve",),
                                               device="cpu"))
    assert len(four) == 4 and len(two) == 2
    assert torch.equal(torch.cat([p["a"] for p in two]),
                       torch.as_tensor(st["a"]))
    assert torch.equal(torch.cat([p["b"] for p in four]),
                       torch.as_tensor(st["b"]))


# ---------------------------------------------------------------------------
# chip_smoke.py's constants
# ---------------------------------------------------------------------------

def test_chip_smoke_j30_constants_match_the_reference(ref):
    want = chip_smoke.DIST_J30_REFERENCE
    assert sorted(want) == [1, 2, 4]
    for D, counters in want.items():
        assert counters == ref["j30"][str(D)], D


def test_port_j30_mesh_two_matches_the_constants():
    inst = trcpsp.generate(30, n_resources=4, seed=0)
    cm = trcpsp.build_model(inst)[0].compile(device="cpu")
    cfg = SolveConfig.preset("prove", n_lanes=chip_smoke.DIST_J30_LANES,
                             eps_target=chip_smoke.DIST_J30_EPS,
                             mesh_shards=2, device="cpu")
    res = Solver(cfg).solve(cm)
    for k, v in chip_smoke.DIST_J30_REFERENCE[2].items():
        assert getattr(res, k) == v, k
