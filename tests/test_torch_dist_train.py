"""Data-parallel training over ``torch.distributed`` (the port's
`train_step.sharded_train_step`, `launch/train.py --devices N`,
`distributed/collectives.py`'s training half) against the JAX package
on the CPU.

One 4-rank gloo group is spawned per module (`torch_dist_jobs`, a
``file://`` rendezvous in a temporary directory) and runs every job; the
JAX side runs here.  Params come from the reference's `init_params`
(numpy, f32 leaves perturbed), batches from its pipeline: two steps of
8 × 16 tokens on the qwen3-4b (dense) and dbrx-132b (MoE) smoke configs.

Each step starts from the reference's state before it (the first from
the initial params and zero moments), given to the ranks whole, which
shard it (so near-tie router picks stay comparable step after step;
``launch/train.py``'s test below runs the ranks' own three steps).

* Against the JAX package's `train_step` on the global batch (one
  device): ``loss`` and ``total`` within
  `test_torch_train.LOSS_RTOL`, ``grad_norm`` within ``GRAD_TOL``, ``lr``
  within ``LR_TOL``, ``mu`` within ``GRAD_TOL`` and ``nu`` within
  ``2·GRAD_TOL`` of the reference's norm per leaf, and the first update
  in the reference's sign on 99 % of every leaf's entries (the
  tolerances of `test_torch_train.test_train_step_matches_jax`), or on
  as many as the port's one-device step where that is fewer (qwen3
  smoke's ``blocks/norm1``: 126 of 128, the packages' bf16 noise).  The
  MoE router takes the reference's picks (`torch_dist_jobs._pinned_route`,
  as `test_torch_train_families`: near ties flip between the packages).
* Against the port's one-device `train_step` from the same state, each
  step: ``loss``, ``total``, ``lr`` and ``grad_norm`` within 1e-5
  relative, and the params after the step within 1e-5 of their norm
  (the ranks sum the products' weight gradients in f32 before their one
  bf16 rounding, as one device does: `nn.layers.unrounded_weight_grads`;
  measured at most 9.5e-7).  Each rank rounding its own part first
  (the stash off) moves ``grad_norm`` by 1e-4 and the params by 1e-3
  after one step, which fails these bounds.
* MoE routing under a capacity that drops tokens (capacity factor 0.25):
  the global routing (global ``C``, capacity ranks offset by the lower
  ranks' counts, global balance and drop share) matches the reference
  under the same bounds, and each rank routing only its own tokens fails
  them (`nn.moe._ranks` patched to local routing in the ranks).
* `int8_psum_mean` equals the reference's on 4 fake JAX devices
  (subprocess) bit for bit, and is lossy within ``max|x|/127``;
  `pod_sync_grads` on a (2, 2) ``("pod", "data")`` mesh averages over
  ``pod`` only (exactly, or within the int8 step), and a mesh without
  ``pod`` returns the grads themselves.
* ``launch/train.py --devices 4 --device cpu``: four gloo ranks (a spawn
  of the CLI's own), the losses of ``--devices 1`` within 1e-5
  relative.
"""

import dataclasses
import json
import os
import pickle
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp

from repro import configs as jconfigs
from repro.data import pipeline as JP
from repro.nn import moe as JMo
from repro.train import optimizer as JO
from repro.train import train_step as JT
from test_torch_families import carried_params
from test_torch_lm import jax_params
from test_torch_train import GRAD_TOL, LOSS_RTOL, LR_TOL, rel_norm
from util import run_fake_devices

import torch_dist_jobs

WORLD = 4
STEPS, SEQ, BATCH = 2, 16, 8
OPT = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10)
ONE_RANK_RTOL = 1e-5
DROPPING_CF = 0.25
CASES = {"dense": ("qwen3-4b", None),
         "dense_rounded_per_rank": ("qwen3-4b", None),
         "moe": ("dbrx-132b", None),
         "moe_dropping": ("dbrx-132b", DROPPING_CF),
         "moe_local_routing": ("dbrx-132b", DROPPING_CF)}


def _jcfg(arch, cf):
    cfg = jconfigs.get_smoke(arch)
    if cf is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
    return cfg


def _reference(arch, cf, npp, batches):
    """The JAX package's steps on the global batch from `npp`: each
    step's starting state and its result (metrics, params, moments), and
    every router call (logits, picks)."""
    jcfg = _jcfg(arch, cf)
    calls, route = [], JMo.topk_route

    def record(logits, k):
        probs, idx = route(logits, k)
        jax.debug.callback(lambda lg, ix: calls.append(
            (np.asarray(lg), np.asarray(ix))), logits, idx)
        return probs, idx

    JMo.topk_route = record
    try:
        step = jax.jit(lambda p, s, b: JT.train_step(
            p, s, b, jcfg, JO.OptConfig(**OPT), remat=True, chunks=(8, 8)))
        p = {k: jnp.asarray(v) for k, v in npp.items()}
        s = JO.init_opt_state(p)
        states, out = [], []
        for b in batches:
            states.append(_numpy_state(p, s))
            p, s, m = step(p, s, {k: jnp.asarray(v) for k, v in b.items()})
            out.append({"metrics": {k: float(v) for k, v in m.items()},
                        **_numpy_state(p, s)})
    finally:
        JMo.topk_route = route
    return states, out, calls


def _numpy_state(p, s):
    return {"params": {k: np.asarray(v) for k, v in p.items()},
            "mu": {k: np.asarray(v) for k, v in s["mu"].items()},
            "nu": {k: np.asarray(v) for k, v in s["nu"].items()},
            "step": int(s["step"])}


@pytest.fixture(scope="module")
def runs():
    """{case: (reference steps, the ranks' steps)} and the collectives'
    per-rank results, from one spawn of the 4-rank group."""
    jobs, refs = {}, {}
    for case, (arch, cf) in CASES.items():
        jcfg = _jcfg(arch, cf)
        npp = (jax_params(arch)[1] if jcfg.moe is None
               else carried_params(jcfg))
        data = JP.SyntheticLM(jcfg, SEQ, BATCH, seed=0)
        batches = [data.batch(s) for s in range(STEPS)]
        states, ref, calls = _reference(arch, cf, npp, batches)
        refs[case] = states, ref
        jobs[case] = ("train", dict(
            arch=arch, states=states, batches=batches, opt=OPT,
            capacity_factor=cf, pins=calls if jcfg.moe else None,
            local_routing=case == "moe_local_routing",
            rounded_per_rank=case == "dense_rounded_per_rank"))
    x = (np.random.default_rng(0).standard_normal((WORLD, 64, 32))
         * 0.01).astype(np.float32)
    jobs["collectives"] = ("collectives", dict(x=x))
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(torch_dist_jobs.worker, args=(WORLD, tmp, jobs),
                 nprocs=WORLD, join=True)
        ranks = []
        for r in range(WORLD):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    return refs, ranks, x


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _assert_matches_reference(got, ref):
    for g, r in zip(got, ref):
        gm, rm = g["metrics"], r["metrics"]
        assert sorted(gm) == sorted(rm)
        for k in ("loss", "total"):
            assert _rel(gm[k], rm[k]) <= LOSS_RTOL, (k, gm[k], rm[k])
        assert _rel(gm["grad_norm"], rm["grad_norm"]) <= GRAD_TOL
        assert abs(gm["lr"] - rm["lr"]) <= LR_TOL
        for k in r["mu"]:
            assert rel_norm(g["mu"][k], r["mu"][k]) <= GRAD_TOL, k
            assert rel_norm(g["nu"][k], r["nu"][k]) <= 2 * GRAD_TOL, k


@pytest.mark.parametrize("case", ["dense", "moe", "moe_dropping"])
def test_four_ranks_match_the_reference_global_batch(runs, case):
    refs, ranks, _ = runs
    got, (states, ref) = ranks[0][case], refs[case]
    _assert_matches_reference(got, ref)
    # Adam's first step is about lr·sign(g); the port's one-device step
    # itself flips 2 of qwen3 smoke's 128 norm1 entries (bf16 noise), so
    # the ranks are held to 99 % or to the one-device step's share
    for k, p0 in states[0]["params"].items():
        dr = np.sign(ref[0]["params"][k] - p0)
        agree = np.mean(np.sign(got[0]["params"][k] - p0) == dr)
        one = np.mean(np.sign(got[0]["one_rank_params"][k] - p0) == dr)
        assert agree >= min(0.99, one), (k, agree, one)
    # every rank holds the same global metrics
    for r in ranks[1:]:
        for a, b in zip(r[case], got):
            assert a["metrics"] == b["metrics"]


def _params_rel(rec):
    num = sum(float(np.sum((rec["params"][k].astype(np.float64)
                            - rec["one_rank_params"][k]) ** 2))
              for k in rec["params"])
    den = sum(float(np.sum(rec["one_rank_params"][k].astype(np.float64)
                           ** 2)) for k in rec["params"])
    return (num / den) ** 0.5


@pytest.mark.parametrize("case", ["dense", "moe", "moe_dropping"])
def test_four_ranks_match_the_ports_one_device_step(runs, case):
    _, ranks, _ = runs
    for rec in ranks[0][case]:
        g, o = rec["metrics"], rec["one_rank"]
        assert sorted(g) == sorted(o)
        for k in ("loss", "total", "lr", "grad_norm"):
            assert _rel(g[k], o[k]) <= ONE_RANK_RTOL, (k, g[k], o[k])
        assert _params_rel(rec) <= ONE_RANK_RTOL


def test_per_rank_rounding_fails_the_one_device_bounds(runs):
    """The same dense step with every rank rounding its own weight
    gradients to bf16 before the sum (the stash off): the bounds above
    see it."""
    _, ranks, _ = runs
    rec = ranks[0]["dense_rounded_per_rank"][0]
    assert _rel(rec["metrics"]["grad_norm"],
                rec["one_rank"]["grad_norm"]) > ONE_RANK_RTOL
    assert _params_rel(rec) > 10 * ONE_RANK_RTOL


def test_capacity_drops_need_global_routing(runs):
    """At capacity factor 0.25 experts drop tokens: the global routing
    drops what the reference drops; each rank routing its own tokens
    (a capacity of its own, ranks from 0) drops other tokens, and its
    step fails the reference's bounds."""
    refs, ranks, _ = runs
    good, bad = ranks[0]["moe_dropping"], ranks[0]["moe_local_routing"]
    ref = refs["moe_dropping"][1]
    assert ref[0]["metrics"]["moe_dropped"] > 0.1
    for g, r in zip(good, ref):
        assert abs(g["metrics"]["moe_dropped"]
                   - r["metrics"]["moe_dropped"]) <= 1e-6
        assert abs(g["metrics"]["moe_balance"]
                   - r["metrics"]["moe_balance"]) <= \
            LOSS_RTOL * r["metrics"]["moe_balance"]
    assert abs(bad[0]["metrics"]["moe_dropped"]
               - ref[0]["metrics"]["moe_dropped"]) > 0.05
    with pytest.raises(AssertionError):
        _assert_matches_reference(bad, ref)


INT8_REFERENCE = r"""
import json, numpy as np, jax
from functools import partial
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.distributed.collectives import int8_psum_mean
x = (np.random.default_rng(0).standard_normal((4, 64, 32))
     * 0.01).astype(np.float32)
mesh = make_mesh((4,), ("pod",))
f = jax.jit(shard_map(partial(int8_psum_mean, axis_name="pod"), mesh=mesh,
                      in_specs=P("pod"), out_specs=P("pod")))
print("REF" + json.dumps(np.asarray(f(x)).tolist()))
"""


def test_int8_psum_mean_matches_jax_and_is_lossy(runs):
    _, ranks, x = runs
    out = run_fake_devices(INT8_REFERENCE, n_devices=WORLD)
    ref = np.asarray(json.loads(next(
        ln for ln in out.splitlines() if ln.startswith("REF"))[3:]),
        np.float32)
    exact = x.mean(0)
    step = float(np.abs(x).max()) / 127
    for r in range(WORLD):
        got = ranks[r]["collectives"]["int8"]
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, ref[r])
        np.testing.assert_allclose(ranks[r]["collectives"]["exact"], exact,
                                   rtol=1e-6, atol=1e-9)
        err = np.abs(got - exact).max()
        assert 0 < err <= step


def test_pod_sync_grads_averages_over_pod_only(runs):
    _, ranks, _ = runs
    for r in range(WORLD):
        out = ranks[r]["collectives"]
        # ranks r and r ± 2 share a data coordinate: (1 + 3)/2, (2 + 4)/2
        mean = 2.0 if r % 2 == 0 else 3.0
        want = {"a/w": np.full((4, 4), mean, np.float32),
                "b/w": -np.arange(3.0, dtype=np.float32) * mean}
        for k, v in want.items():
            np.testing.assert_array_equal(out["pod_False"][k], v)
            step = np.abs(v).max() * 2 / mean / 127   # max|x|/127
            assert np.abs(out["pod_True"][k] - v).max() <= step
        assert out["no_pod_is_identity"]


def test_train_cli_four_ranks_match_one(capfd):
    """``--arch qwen3-4b --smoke --steps 3 --devices 4 --device cpu``
    (128 tokens × 8 sequences) against ``--devices 1``: the ranks' own
    three steps (measured within 8.7e-8 relative)."""
    from repro_torch.launch import train
    base = ["--arch", "qwen3-4b", "--smoke", "--steps", "3", "--device",
            "cpu", "--log-every", "1"]
    one = train.main(base + ["--devices", "1"])
    four = train.main(base + ["--devices", "4"])
    out = capfd.readouterr().out
    assert "ranks=4 backend=gloo (ranks on the CPU)" in out
    assert [r["step"] for r in four] == [0, 1, 2]
    for a, b in zip(four, one):
        assert _rel(a["loss"], b["loss"]) <= ONE_RANK_RTOL
        assert a["backend"] == "gloo" and len(a["peak_gb_ranks"]) == 4
