"""The port's distributed EPS (`core/dist_solve.py`, the mesh paths of
`core/api.py`, `launch/solve.py --mesh`) against the JAX package's.

The JAX side runs once for the file in a subprocess with 8 fake CPU
devices (the repo-root ``fake_devices`` fixture) and prints one JSON
record; the port runs in-process on the CPU (every shard on the CPU).
The stores are an integer lattice, so equality is exact:

* the parity matrix: knapsack, coloring and rcpsp (`small_instance`,
  seed 0), ``prove``, 4 lanes per shard, eps_target 16, mesh 1, 2, 4 and
  8 and ``chunk=2`` at mesh 4, the port's ``gather`` and ``cuda`` (the
  plain version on the CPU) against JAX ``gather``: status, objective,
  every counter, supersteps, chunks, bound syncs and the bound per chunk;
* work stealing (the scenario of ``tests/test_dist_solve.py``): the steal
  events, the per-chunk assignments and consumed ids, every id and the
  result, and the partition invariant at every boundary;
* device loss (``DeviceLoss(1, 1)`` at mesh 4): the remesh events, the
  bound per chunk, the result and every counter;
* the explicit-mesh path (``SolveConfig(mesh=..., lane_axes=...)``, the
  scenario of ``tests/test_solver.py``, on a 4-shard 1-D mesh and a 2 x 2
  mesh): every counter;
* the CLI's ``--mesh 4`` line against the JAX CLI's;
* ``first_solution`` at mesh 2 and 4 on N-queens (a satisfaction model)
  and knapsack;
* mesh 1 against the plain solve, and the config checks.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import solver as tsolver
from repro_torch.core import dist_solve, eps
from repro_torch.core import models as tzoo
from repro_torch.core.api import Solver
from repro_torch.core.models import rcpsp as trcpsp
from repro_torch.distributed.sharding import make_mesh
from repro_torch.ft.fault_tolerance import DeviceLoss

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COUNTERS = ("status", "objective", "n_nodes", "n_fails", "n_sols",
            "n_sweeps", "n_supersteps", "complete")
TRACE = ("n_chunks", "n_bound_syncs", "gbest_per_chunk")
MODELS = ("knapsack", "coloring", "rcpsp")
# (mesh shards, chunk) of the parity matrix
MESHES = ((1, 256), (2, 256), (4, 256), (8, 256), (4, 2))
# stop_on_first at mesh 2 and 4: a satisfaction model and an objective
FIRST_MODELS = ("nqueens", "knapsack")
CLI = ("--n", "5", "--lanes", "4", "--mesh", "4")

_JAX_CODE = r"""
import contextlib, io, json, runpy, sys
import numpy as np
from repro import solver
from repro.compat import make_mesh
from repro.core import dist_solve, eps
from repro.core import models as zoo
from repro.core.api import Solver
from repro.core.models import rcpsp
from repro.ft.fault_tolerance import DeviceLoss

MESHES = %(meshes)r
FIRST_MODELS = %(first)r
CLI = %(cli)r

def rec(res, tr=None):
    out = dict(status=res.status, objective=res.objective,
               n_nodes=res.n_nodes, n_fails=res.n_fails, n_sols=res.n_sols,
               n_sweeps=res.n_sweeps, n_supersteps=res.n_supersteps,
               complete=res.complete)
    if tr is not None:
        out.update(n_chunks=tr.n_chunks, n_bound_syncs=tr.n_bound_syncs,
                   gbest_per_chunk=[int(x) for x in tr.gbest_per_chunk],
                   steal_events=tr.steal_events,
                   remesh_events=tr.remesh_events,
                   assignments=tr.assignments,
                   consumed_per_chunk=tr.consumed_per_chunk,
                   all_ids=tr.all_ids)
    return out

def model(name):
    m, _ = zoo.ZOO[name].build_model(zoo.small_instance(name, seed=0))
    return m.compile()

out = {"parity": {}}
for name in ("knapsack", "coloring", "rcpsp"):
    cm = model(name)
    cfg0 = solver.SolveConfig.preset("prove", n_lanes=4, eps_target=16)
    for D, chunk in MESHES:
        cfg = cfg0.replace(mesh_shards=D, chunk=chunk)
        res, tr = dist_solve.solve_dist(cm, cfg, session=Solver(cfg))
        out["parity"]["%%s/%%d/%%d" %% (name, D, chunk)] = rec(res, tr)

out["first"] = {}
for name in FIRST_MODELS:
    cm = model(name)
    for D in (2, 4):
        cfg = solver.SolveConfig.preset("first_solution", n_lanes=4,
                                        eps_target=16, mesh_shards=D)
        res, tr = dist_solve.solve_dist(cm, cfg, session=Solver(cfg))
        out["first"]["%%s/%%d" %% (name, D)] = rec(res, tr)

cm = model("coloring")
cfg0 = solver.SolveConfig.preset("prove", n_lanes=2, eps_target=16)
lb, ub = map(np.array, eps.decompose(cm, 16, cfg0.search_options()))
half = (lb.shape[0] + 1) // 2
lb[half:, 0], ub[half:, 0] = 1, 0
cfg = cfg0.replace(chunk=1, mesh_shards=2)
res, tr = dist_solve.solve_dist(cm, cfg, subs=(lb, ub), session=Solver(cfg))
out["steal"] = rec(res, tr)
out["steal_single"] = rec(Solver(cfg0).solve(cm, subs=(lb, ub)))

cfg0 = solver.SolveConfig.preset("prove", n_lanes=2, eps_target=16, chunk=2)
cfg = cfg0.replace(mesh_shards=4)
res, tr = dist_solve.solve_dist(cm, cfg, session=Solver(cfg),
                                fault=DeviceLoss(at_chunk=1, shard=1))
out["loss"] = rec(res, tr)

inst = rcpsp.generate(5, n_resources=2, seed=1, edge_prob=0.3)
cm = rcpsp.build_model(inst)[0].compile()
for tag, shape, names, axes in (("1d", (4,), ("workers",), ("workers",)),
                                ("2x2", (2, 2), ("a", "b"), ("a", "b"))):
    mesh = make_mesh(shape, names)
    out["explicit_" + tag] = rec(solver.solve(cm, config=solver.SolveConfig(
        n_lanes=2, eps_target=16, mesh=mesh, lane_axes=axes)))

buf = io.StringIO()
sys.argv = ["solve", *CLI, "--subs", "16"]
with contextlib.redirect_stdout(buf):
    runpy.run_module("repro.launch.solve", run_name="__main__")
out["cli"] = buf.getvalue()
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref(fake_devices):
    out = fake_devices(_JAX_CODE % dict(meshes=MESHES, first=FIRST_MODELS,
                                        cli=CLI))
    return json.loads(out.split("RESULT ", 1)[1])


def _case(name):
    inst = tzoo.small_instance(name, seed=0)
    m, handles = tzoo.ZOO[name].build_model(inst)
    return tzoo.ZOO[name], inst, handles, m.compile(device="cpu")


def _cfg(backend="gather", **kw):
    kw.setdefault("n_lanes", 4)
    kw.setdefault("eps_target", 16)
    return tsolver.SolveConfig.preset("prove", backend=backend,
                                      device="cpu", **kw)


def _same(res, want, tr=None, what=""):
    for k in COUNTERS:
        assert getattr(res, k) == want[k], (what, k)
    for k in TRACE if tr is not None else ():
        assert getattr(tr, k) == want[k], (what, k)


def _partition_ok(tr):
    for owned, consumed in zip(tr.assignments, tr.consumed_per_chunk):
        flat = [i for o in owned for i in o]
        if (len(flat) != len(set(flat)) or not set(flat).isdisjoint(consumed)
                or set(flat) | set(consumed) != set(tr.all_ids)):
            return False
    return True


@pytest.mark.parametrize("backend", ["gather", "cuda"])
@pytest.mark.parametrize("mesh,chunk", MESHES,
                         ids=[f"mesh{d}-chunk{c}" for d, c in MESHES])
@pytest.mark.parametrize("name", MODELS)
def test_mesh_parity_matrix(ref, name, mesh, chunk, backend):
    mod, inst, handles, cm = _case(name)
    res, tr = dist_solve.solve_dist(cm, _cfg(backend, mesh_shards=mesh,
                                             chunk=chunk))
    want = ref["parity"][f"{name}/{mesh}/{chunk}"]
    _same(res, want, tr, f"{name} mesh {mesh} chunk {chunk} {backend}")
    assert res.status == "OPTIMAL" and tr.n_bound_syncs == tr.n_chunks
    assert mod.check_solution(inst, [int(res.solution[v.idx])
                                     for v in handles["check_vars"]])[0]


def test_solve_dist_defaults_to_one_shard(ref):
    """Without ``mesh_shards`` the solve runs one shard on the config's
    device: the reference's mesh-1 record, one id list per boundary."""
    cm = _case("knapsack")[3]
    res, tr = dist_solve.solve_dist(cm, _cfg("gather", chunk=256))
    _same(res, ref["parity"]["knapsack/1/256"], tr, "knapsack default")
    assert tr.assignments and all(len(a) == 1 for a in tr.assignments)


@pytest.mark.parametrize("mesh", [2, 4])
@pytest.mark.parametrize("name", FIRST_MODELS)
def test_first_solution_stops_every_shard_together(ref, name, mesh):
    """``stop_on_first``: the OR of the shards' has-solution flags stops
    every shard on the same superstep, as in the reference."""
    mod, inst, handles, cm = _case(name)
    cfg = tsolver.SolveConfig.preset("first_solution", n_lanes=4,
                                     eps_target=16, mesh_shards=mesh,
                                     device="cpu")
    res, tr = dist_solve.solve_dist(cm, cfg)
    _same(res, ref["first"][f"{name}/{mesh}"], tr, f"{name} mesh {mesh}")
    assert res.solution is not None and not res.complete
    assert mod.check_solution(inst, [int(res.solution[v.idx])
                                     for v in handles["check_vars"]])[0]


@pytest.mark.parametrize("name", ["knapsack", "nqueens"])
def test_mesh_one_equals_plain_solve(name):
    cm = _case(name)[3]
    cfg = _cfg()
    plain = Solver(cfg).solve(cm)
    sess = Solver(cfg.replace(mesh_shards=1))
    res = sess.solve(cm)                    # the session delegates
    _same(res, {k: getattr(plain, k) for k in COUNTERS})
    # it delegated: the distributed engine keeps no phases, where the
    # plain solve read the done flag once a superstep
    assert res.trace is None
    assert plain.trace.count("search.read") == plain.n_supersteps
    assert np.array_equal(res.solution, plain.solution)


def _steal_pool(cm, cfg):
    lb, ub = eps.decompose(cm, 16, cfg.search_options())
    lb, ub = np.array(lb), np.array(ub)
    half = (lb.shape[0] + 1) // 2
    lb[half:, 0], ub[half:, 0] = 1, 0
    return lb, ub


def test_steal_matches_and_keeps_the_partition(ref):
    cm = _case("coloring")[3]
    cfg0 = _cfg(n_lanes=2)
    pool = _steal_pool(cm, cfg0)
    res, tr = dist_solve.solve_dist(cm, cfg0.replace(chunk=1, mesh_shards=2),
                                    subs=pool)
    want = ref["steal"]
    _same(res, want, tr, "steal")
    assert tr.n_steals >= 1 and tr.steal_events == want["steal_events"]
    assert tr.assignments == want["assignments"]
    assert tr.consumed_per_chunk == want["consumed_per_chunk"]
    assert tr.all_ids == want["all_ids"]
    assert _partition_ok(tr)
    single = Solver(cfg0).solve(cm, subs=pool)
    _same(single, ref["steal_single"])
    assert res.objective == single.objective


def test_steal_off_runs_no_steal():
    cm = _case("coloring")[3]
    cfg0 = _cfg(n_lanes=2)
    pool = _steal_pool(cm, cfg0)
    res, tr = dist_solve.solve_dist(
        cm, cfg0.replace(chunk=1, mesh_shards=2, steal=False), subs=pool)
    assert tr.n_steals == 0 and _partition_ok(tr)
    assert res.objective == Solver(cfg0).solve(cm, subs=pool).objective


def test_device_loss_remeshes_like_the_reference(ref):
    cm = _case("coloring")[3]
    cfg = _cfg(n_lanes=2, chunk=2, mesh_shards=4)
    res, tr = dist_solve.solve_dist(cm, cfg,
                                    fault=DeviceLoss(at_chunk=1, shard=1))
    want = ref["loss"]
    _same(res, want, tr, "device loss")
    assert tr.remesh_events == want["remesh_events"]
    ev, = tr.remesh_events
    assert (ev["shards_before"], ev["shards_after"]) == (4, 3)
    assert ev["n_requeued"] >= 1 and res.complete
    g = tr.gbest_per_chunk
    assert all(a >= b for a, b in zip(g, g[1:]))


@pytest.mark.parametrize("tag,shape,names,axes", [
    ("1d", (4,), ("workers",), ("workers",)),
    ("2x2", (2, 2), ("a", "b"), ("a", "b"))])
def test_explicit_mesh_matches(ref, tag, shape, names, axes):
    inst = trcpsp.generate(5, n_resources=2, seed=1, edge_prob=0.3)
    cm = trcpsp.build_model(inst)[0].compile(device="cpu")
    cfg = tsolver.SolveConfig(n_lanes=2, eps_target=16, device="cpu",
                              mesh=make_mesh(shape, names, device="cpu"),
                              lane_axes=axes)
    res = tsolver.solve(cm, config=cfg)
    _same(res, ref["explicit_" + tag], what=tag)
    assert res.status == "OPTIMAL"


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.solve", *args],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=600)


def test_cli_mesh_matches_the_reference_cli(ref):
    r = _cli(*CLI, "--eps-target", "16", "--device", "cpu")
    assert r.returncode == 0, r.stderr[-2000:]

    def fields(text):
        head = next(ln for ln in text.splitlines()
                    if ln.startswith("gen-"))
        dist = next(ln for ln in text.splitlines()
                    if "distributed:" in ln)
        keep = [w for w in head.split() if w.startswith(
            ("objective=", "nodes=", "supersteps=", "complete="))]
        return head.split()[1], keep, dist.strip()
    assert fields(r.stdout) == fields(ref["cli"])
    assert "ground_check=OK" in r.stdout


def test_cli_mesh_without_a_gpu_fails():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    r = _cli(*CLI)
    assert r.returncode != 0
    assert "torch.cuda.is_available() is False" in r.stderr


def test_config_checks():
    cpu = make_mesh((2,), ("solve",), device="cpu")
    bad = [
        (dict(mesh_shards=0), "mesh_shards must be"),
        (dict(mesh_shards=2.0), "mesh_shards must be"),
        (dict(mesh_shards=2, backend="cuda_resident"), "cuda_resident"),
        (dict(mesh=cpu, lane_axes=("solve",), backend="cuda_resident"),
         "cuda_resident"),
        (dict(mesh=cpu, lane_axes=("solve",), mesh_shards=2),
         "mutually exclusive"),
        (dict(lane_axes=("solve",)), "lane_axes given without a mesh"),
        (dict(mesh=cpu), "mesh given without lane_axes"),
        (dict(mesh=cpu, lane_axes=("lanes",)), "not in mesh axes"),
    ]
    for kw, msg in bad:
        with pytest.raises(ValueError, match=msg):
            tsolver.SolveConfig(device="cpu", **kw)
    cfg = tsolver.SolveConfig(device="cpu", mesh=cpu, lane_axes=["solve"])
    assert cfg.lane_axes == ("solve",) and cfg.n_mesh_shards() == 2
    keys = {tsolver.SolveConfig(device="cpu", **kw).compile_key()
            for kw in ({}, dict(mesh_shards=2), dict(mesh_shards=4),
                       dict(mesh=cpu, lane_axes=("solve",)))}
    assert len(keys) == 4
    with pytest.raises(RuntimeError, match="only 2 device"):
        dist_solve._mesh_for(4, devices=["cpu", "cpu"])
    assert dist_solve._mesh_for(3, device="cpu").shape == {"solve": 3}


@pytest.mark.parametrize("kw", ["mesh_shards", "mesh"])
def test_batching_refuses_a_mesh(kw):
    cm = _case("knapsack")[3]
    extra = (dict(mesh_shards=1) if kw == "mesh_shards" else dict(
        mesh=make_mesh((1,), ("solve",), device="cpu"), lane_axes=("solve",)))
    sess = Solver(_cfg(**extra))
    with pytest.raises(ValueError, match="single-device"):
        sess.solve_many([cm])
    with pytest.raises(ValueError, match="single-device"):
        sess.lane_batch(cm, width=2)


def test_facade_runs_a_mesh_solve():
    cm = _case("knapsack")[3]
    res = tsolver.solve(cm, config=tsolver.SolveConfig(
        mesh_shards=2, n_lanes=4, eps_target=16, device="cpu"))
    ref = tsolver.solve(cm, config=tsolver.SolveConfig(
        n_lanes=4, eps_target=16, device="cpu"))
    assert (res.status, res.objective) == (ref.status, ref.objective)
