"""The port on models compiled to int64, against the JAX package's.

The JAX package compiles a model to int64 only under ``jax_enable_x64``
(its compile refuses otherwise), and the tier-1 run has x64 off.  So the
JAX side runs once, in a subprocess with ``JAX_ENABLE_X64=1``
(`_JAX_SIDE`), on inputs this process makes with seeded numpy, and hands
back its results in an ``.npz``:

* `fixpoint_batch` on `_int64_model` (a linear row whose products pass
  2³¹) and on the RCPSP J30 class with every duration × 10⁷ (int64, the
  sparse Cumulative layout), on random substores, capped at 1 and 4
  sweeps and uncapped: the port's stores, sweeps and flags are equal;
* `search_plain` against JAX `search_pallas(interpret=True)` at int64 on
  a tiny RCPSP (durations × 10⁸), one pool queue and lane tiles of 4:
  every LaneState field, the bound, the superstep count, the cursors and
  the stop flag (the reference's pool cursor widens to int64 under x64
  and breaks its trace, so the subprocess narrows it back: ROADMAP,
  reference notes);
* `Solver.solve` on J30 × 10⁷ (``prove``, 32 lanes, eps 64): the port's
  ``gather`` and ``cuda_resident`` (CPU tensors: the plain version)
  against JAX ``gather``: status, objective 340,000,000 and every
  counter.

Without JAX: a ``force_dtype="int64"`` compile of each smoke-tier zoo
model solves with every counter equal to its int32 compile (the values
are the same, so the trajectory is too).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import solver as tsolver
from repro_torch.core import fixpoint as TF
from repro_torch.core import models as tzoo
from repro_torch.core import search as TS
from repro_torch.core.model import Model
from repro_torch.core.models import rcpsp
from repro_torch.kernels import fixpoint_kernel as TFK
from repro_torch.testing import random_substores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

torch.set_num_threads(1)      # tiny tensors: thread hand-offs cost more

COUNTERS = ("status", "objective", "n_nodes", "n_fails", "n_sols",
            "n_sweeps", "n_supersteps", "complete")
CAPS = (1, 4, None)
STATE = TS.LaneState._fields
SOLVE = dict(n_lanes=32, eps_target=64)


def scaled_rcpsp(mod, n_tasks, scale, **kw):
    """An RCPSP class instance of `mod` (the port's or the JAX package's
    generator) with every duration × `scale`."""
    inst = mod.generate(n_tasks, seed=0, **kw)
    return dataclasses.replace(inst, durations=inst.durations * scale)


def int64_model(cls):
    """Two variables in [0, 10⁸] under 1000·x + 1000·y ≤ 10⁹: products
    pass 2³¹, so the compile picks int64."""
    m = cls("wide")
    x, y = m.int_var(0, 10 ** 8), m.int_var(0, 10 ** 8)
    m.add(1000 * x + 1000 * y <= 10 ** 9)
    return m


J30 = dict(n_tasks=30, scale=10 ** 7, n_resources=4)
TINY = dict(n_tasks=5, scale=10 ** 8, n_resources=2, edge_prob=0.3)

# the JAX side, run with JAX_ENABLE_X64=1: argv[1] the inputs, argv[2]
# the results (.npz)
_JAX_SIDE = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
from repro import solver
from repro.core import eps, search as S
from repro.core.fixpoint import fixpoint_batch
from repro.core.model import Model
from repro.core.models import rcpsp
from repro.kernels.fixpoint_kernel import search_pallas
from test_torch_int64 import CAPS, J30, SOLVE, STATE, TINY, int64_model
from test_torch_int64 import scaled_rcpsp

assert jax.config.jax_enable_x64
# Under x64 the reference's search_pallas does not trace: its pool cursor
# widens to int64 in dispatch_pool_tile (an int32 sum is int64 there) and
# the two branches of the superstep's lax.cond disagree.  The cursor is
# cast back to int32 around the call; no value changes.
_dispatch = S.dispatch_pool_tile
S.dispatch_pool_tile = lambda *a, **k: (lambda st, h: (st, h.astype(
    jnp.int32)))(*_dispatch(*a, **k))
inp = dict(np.load(sys.argv[1]))
out = {}
models = {"wide": int64_model(Model).compile(),
          "j30": rcpsp.build_model(scaled_rcpsp(rcpsp, **J30))[0].compile()}
for name, cm in models.items():
    out[f"{name}/dtype"] = np.array(cm.dtype)
    out[f"{name}/layout"] = np.array(cm.cu_layout)
    out[f"{name}/lb0"] = np.asarray(cm.lb0)
    for cap in CAPS:
        res = fixpoint_batch(cm, jnp.asarray(inp[f"{name}/lb"]),
                             jnp.asarray(inp[f"{name}/ub"]), max_iters=cap)
        for k, a in zip(("lb", "ub", "sweeps", "converged"), res):
            out[f"{name}/{cap}/{k}"] = np.asarray(a)

cm = rcpsp.build_model(scaled_rcpsp(rcpsp, **TINY))[0].compile()
opts = S.SearchOptions(var_strategy="min_lb", max_depth=64)
lb, ub = eps.decompose(cm, 8, opts)
out["tiny/dtype"] = np.array(cm.dtype)
out["tiny/pool_lb"], out["tiny/pool_ub"] = np.asarray(lb), np.asarray(ub)
big = jnp.asarray(np.iinfo(np.int64).max // 4, jnp.int64)
for tile in (0, 4):
    st = S.init_lanes(cm, 8, opts)
    res = search_pallas(cm, jnp.asarray(lb), jnp.asarray(ub), st, big,
                        jnp.asarray(0, jnp.int32), jnp.zeros((1,), jnp.int32),
                        supersteps=8, lane_tile=tile, interpret=True,
                        var_strategy="min_lb")
    for f in STATE:
        a = getattr(res[0], f)
        if a is not None:
            out[f"tiny/{tile}/st/{f}"] = np.asarray(a)
    for k, a in zip(("gbest", "it", "head", "stopped"), res[1:]):
        out[f"tiny/{tile}/{k}"] = np.asarray(a)

cm = models["j30"]
r = solver.Solver().solve(cm, config=solver.SolveConfig.preset(
    "prove", backend="gather", **SOLVE))
for k in ("n_nodes", "n_fails", "n_sols", "n_sweeps", "n_supersteps"):
    out[f"solve/{k}"] = np.array(getattr(r, k))
out["solve/status"] = np.array(r.status)
out["solve/objective"] = np.array(r.objective)
out["solve/complete"] = np.array(r.complete)
out["solve/solution"] = np.asarray(r.solution)
np.savez(sys.argv[2], **out)
"""


def _port_models():
    return {"wide": int64_model(Model).compile(device="cpu"),
            "j30": rcpsp.build_model(scaled_rcpsp(rcpsp, **J30))[0].compile(
                device="cpu")}


@pytest.fixture(scope="module")
def jax_x64(tmp_path_factory):
    """The JAX side's results on this file's inputs."""
    d = tmp_path_factory.mktemp("x64")
    inp = {}
    for name, cm in _port_models().items():
        lbs, ubs = random_substores(np.random.default_rng(7), cm, 64)
        inp[f"{name}/lb"], inp[f"{name}/ub"] = lbs, ubs
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests"),
                    os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_SIDE, str(d / "in.npz"),
         str(d / "out.npz")], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = dict(np.load(d / "out.npz"))
    return inp, out


@pytest.mark.parametrize("name", ["wide", "j30"])
def test_fixpoint_matches_jax_x64(jax_x64, name):
    inp, ref = jax_x64
    cm = _port_models()[name]
    assert cm.dtype == str(ref[f"{name}/dtype"]) == "int64"
    assert cm.cu_layout == str(ref[f"{name}/layout"])
    np.testing.assert_array_equal(cm.lb0.numpy(), ref[f"{name}/lb0"])
    if name == "j30":
        assert cm.cu_layout == "sparse" and cm.horizon > 10 ** 9
    lb, ub = (torch.from_numpy(inp[f"{name}/{k}"]) for k in ("lb", "ub"))
    for cap in CAPS:
        got = TF.fixpoint_batch(cm, lb, ub, max_iters=cap)
        got_k = TFK.fixpoint_cuda(cm, lb, ub, max_sweeps=cap)  # plain on CPU
        for k, g, gk in zip(("lb", "ub", "sweeps", "converged"), got, got_k):
            r = ref[f"{name}/{cap}/{k}"]
            assert g.numpy().dtype == r.dtype, (cap, k)
            np.testing.assert_array_equal(g.numpy(), r, err_msg=f"{cap} {k}")
            assert torch.equal(g, gk)


@pytest.mark.parametrize("tile", [0, 4])
def test_search_plain_matches_search_pallas_x64(jax_x64, tile):
    _, ref = jax_x64
    cm = rcpsp.build_model(scaled_rcpsp(rcpsp, **TINY))[0].compile(
        device="cpu")
    assert cm.dtype == str(ref["tiny/dtype"]) == "int64"
    slb = torch.from_numpy(ref["tiny/pool_lb"])
    sub = torch.from_numpy(ref["tiny/pool_ub"])
    st = TS.init_lanes(cm, 8, TS.SearchOptions(var_strategy="min_lb",
                                               max_depth=64))
    big = torch.tensor(torch.iinfo(torch.int64).max // 4)
    st, gbest, it, head, stop = TFK.search_plain(
        cm, slb, sub, st, big, 0, torch.zeros((), dtype=torch.int32),
        supersteps=8, lane_tile=tile, var_strategy="min_lb")
    for f in STATE:
        a = getattr(st, f)
        if a is None:
            assert f"tiny/{tile}/st/{f}" not in ref, f
            continue
        r = ref[f"tiny/{tile}/st/{f}"]
        assert a.numpy().dtype == r.dtype, f
        np.testing.assert_array_equal(a.numpy(), r, err_msg=f)
    assert gbest.dtype == torch.int64
    assert int(gbest) == int(ref[f"tiny/{tile}/gbest"])
    assert int(it) == int(ref[f"tiny/{tile}/it"])
    assert bool(stop) == bool(ref[f"tiny/{tile}/stopped"])
    np.testing.assert_array_equal(head.numpy().reshape(-1),
                                  ref[f"tiny/{tile}/head"])
    assert int(st.n_nodes.sum()) > 0


@pytest.mark.parametrize("backend", ["gather", "cuda_resident"])
def test_solve_matches_jax_x64(jax_x64, backend):
    _, ref = jax_x64
    inst = scaled_rcpsp(rcpsp, **J30)
    m, handles = rcpsp.build_model(inst)
    cm = m.compile(device="cpu")
    got = tsolver.Solver(tsolver.SolveConfig.preset(
        "prove", backend=backend, device="cpu", **SOLVE)).solve(cm)
    for k in COUNTERS:
        want = ref[f"solve/{k}"]
        assert getattr(got, k) == (str(want) if k == "status"
                                   else want.item()), k
    np.testing.assert_array_equal(got.solution, ref["solve/solution"])
    assert (got.status, got.objective) == ("OPTIMAL", 340_000_000)
    starts = [int(got.solution[v.idx]) for v in handles["s"]]
    assert rcpsp.check_solution(inst, starts) == (True, got.objective)


@pytest.mark.parametrize("name", chip_smoke.ZOO_SMOKE)
def test_forced_int64_solve_equals_int32(name):
    inst = tzoo.small_instance(name, seed=0)
    m, _ = tzoo.ZOO[name].build_model(inst)
    narrow = m.compile(device="cpu")
    wide = m.compile(device="cpu", force_dtype="int64")
    assert (narrow.dtype, wide.dtype) == ("int32", "int64")
    cfg = tsolver.SolveConfig.preset(
        "prove", n_lanes=chip_smoke.ZOO_SMOKE_LANES, backend="gather",
        device="cpu")
    ref = tsolver.Solver(cfg).solve(narrow)
    for backend in ("gather", "cuda_resident"):
        got = tsolver.Solver(cfg.replace(backend=backend)).solve(wide)
        for k in COUNTERS:
            assert getattr(got, k) == getattr(ref, k), (backend, k)
        np.testing.assert_array_equal(got.solution, ref.solution)
    assert {k: getattr(ref, k) for k in
            chip_smoke.ZOO_SMOKE_REFERENCE[name]} == \
        chip_smoke.ZOO_SMOKE_REFERENCE[name]


def test_ground_check_reads_the_start_points():
    """`rcpsp.check_solution` reads the profile at the start points only
    (fast at durations × 10⁷): the same verdict as reading every time
    point, on random start vectors of small instances."""
    rng = np.random.default_rng(3)
    for seed in range(4):
        inst = rcpsp.generate(6, n_resources=2, seed=seed, edge_prob=0.2)
        d = np.asarray(inst.durations)
        for _ in range(50):
            st = rng.integers(0, 12, size=len(d))
            ok = all(st[i] + d[i] <= st[j] for i, j in inst.precedences)
            mk = int((st + d).max())
            for t in range(mk):
                run = (st <= t) & (t < st + d)
                ok &= all(inst.usage[k][run].sum() <= inst.capacity[k]
                          for k in range(inst.n_resources))
            assert rcpsp.check_solution(inst, st) == ((True, mk) if ok
                                                      else (False, -1))
