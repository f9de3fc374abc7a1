"""The port's dry-run (`launch/dryrun.py`), production mesh
(`launch/mesh.py`), sharding rules (`distributed/sharding.py`), remat
policy (`nn/scanctl.py`) and meta-safe MoE count, against the JAX
package on the CPU.

* Sharding rules: `shardings_for_specs` (train and serve rules) and
  `cache_shardings` (decode_32k caches), every arch on both production
  meshes, give the reference's ``PartitionSpec`` and
  ``NamedSharding.shard_shape`` for every leaf (the reference in a
  subprocess with 512 fake devices; nothing is compiled), and
  `batch_sharding` the reference's for every shape's inputs.
* Per-device argument bytes: `launch.dryrun.build_cell`'s arguments
  under their shardings equal the sum of the reference's shard-shape
  bytes, every arch's train_4k cell (the reference's dtypes, f32
  params) and decode_32k cell (the port's serving dtypes per leaf), on
  both meshes.
* The skip rule equals the reference's for every (arch, shape); a
  decode cell and a prefill cell trace on ``meta`` to an OK record.
* `nn.moe.expert_counts` equals ``bincount``, and `dispatch_indices`
  runs on ``meta``.
* ``remat_policy("dots")``: the loss and gradients equal
  ``"full"``'s bit for bit and JAX's ``remat_policy("dots")`` within
  `test_torch_train`'s tolerances, and the step counts fewer FLOPs
  (the products it keeps are not recomputed).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as jconfigs
from repro.configs import base as JB
from repro.nn import scanctl as jscanctl
from repro.train import optimizer as JO
from repro.train import train_step as JT
from repro_torch import configs
from repro_torch.configs import base as B
from repro_torch.data.pipeline import input_shapes
from repro_torch.distributed import sharding as SH
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.nn import layers as L
from repro_torch.nn import model as M
from repro_torch.nn import moe as Mo
from repro_torch.nn import scanctl
from repro_torch.train import optimizer as O
from repro_torch.train import train_step as T
from test_torch_lm import jax_params
from test_torch_train import GRAD_TOL, LOSS_RTOL, batches, rel_norm
from util import run_fake_devices

torch.set_num_threads(2)

# the reference's layout of every arch on both production meshes: per
# leaf [spec, shard_shape, dtype]
REFERENCE = r"""
import json
import jax
from repro import configs
from repro.data.pipeline import input_shapes
from repro.distributed import sharding as SH
from repro.launch.mesh import make_production_mesh
from repro.nn import model as MD

def spec(p):
    return [list(e) if isinstance(e, tuple) else e for e in p]

def layout(sh, shape, dtype):
    return [spec(sh.spec), list(sh.shard_shape(tuple(shape))), str(dtype)]

out = {}
for mp in (False, True):
    mesh = make_production_mesh(multi_pod=mp)
    for arch in configs.ARCH_IDS:
        cfg = configs.get(arch)
        specs = MD.param_specs(cfg)
        rec = {}
        for mode in ("train", "serve"):
            sh = SH.shardings_for_specs(specs, SH.rules_for(mode), mesh)
            rec[mode] = {k: layout(sh[k], s.shape, "float32")
                         for k, s in specs.items()}
        for shape in configs.ALL_SHAPES:
            b = input_shapes(cfg, shape)
            sh = SH.batch_sharding(b, SH.rules_for(
                "train" if shape.kind == "train" else "serve"), mesh)
            rec["batch_" + shape.name] = {
                k: layout(sh[k], v.shape, v.dtype) for k, v in b.items()}
        caches = jax.eval_shape(lambda: MD.init_cache(cfg, 128, 32768))
        csh = SH.cache_shardings(cfg, caches, mesh)
        leaves = jax.tree_util.tree_leaves_with_path(caches)
        shs = jax.tree_util.tree_leaves(csh)
        rec["cache"] = [[jax.tree_util.keystr(p)] + layout(s, x.shape,
                                                           x.dtype)
                        for (p, x), s in zip(leaves, shs)]
        out[f"{arch}|{mp}"] = rec
print("REF" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    out = run_fake_devices(REFERENCE, n_devices=512)
    line = next(ln for ln in out.splitlines() if ln.startswith("REF"))
    return json.loads(line[3:])


def _spec(p):
    return [list(e) if isinstance(e, tuple) else e for e in p]


def _layout(sh, dtype):
    return [_spec(sh.spec), list(sh.shard_shape),
            str(dtype).split(".")[-1]]


def _cache_leaves(tree, path=""):
    """(path, leaf) in the reference's ``tree_leaves_with_path`` order
    and ``keystr`` form."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields") and \
            not isinstance(tree, SH.Sharding):
        for f, x in zip(tree._fields, tree):
            yield from _cache_leaves(x, f"{path}.{f}")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _cache_leaves(tree[k], f"{path}['{k}']")
    else:
        yield path, tree


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
def test_sharding_rules_match_the_reference(reference, multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    assert mesh.devices.size == (512 if multi_pod else 256)
    assert {d.type for d in mesh.devices.reshape(-1)} == {"meta"}
    for arch in configs.ARCH_IDS:
        ref = reference[f"{arch}|{multi_pod}"]
        cfg = configs.get(arch)
        specs = M.param_specs(cfg)
        for mode in ("train", "serve"):
            sh = SH.shardings_for_specs(specs, SH.rules_for(mode), mesh)
            got = {k: _layout(sh[k], "float32") for k in specs}
            assert got == ref[mode], (arch, mode)
        for shape in B.ALL_SHAPES:
            b = input_shapes(cfg, shape)
            sh = SH.batch_sharding(b, SH.rules_for(
                "train" if shape.kind == "train" else "serve"), mesh)
            got = {k: _layout(sh[k], v[1]) for k, v in b.items()}
            assert got == ref["batch_" + shape.name], (arch, shape.name)
        caches = M.init_cache(cfg, 128, 32768, device="meta")
        csh = SH.cache_shardings(cfg, caches, mesh)
        got = [[p] + _layout(s, x.dtype) for (p, x), (_, s) in zip(
            _cache_leaves(caches), _cache_leaves(csh))]
        assert got == ref["cache"], arch


def _reference_bytes(layouts, dtypes=None):
    """Σ shard-shape bytes of reference layouts, each at its own dtype
    or at `dtypes[path]`."""
    total = 0
    for k, (_, shard, dt) in layouts.items():
        dt = dtypes[k] if dtypes else getattr(torch, dt)
        total += int(np.prod(shard, dtype=np.int64)) * \
            torch.empty((), dtype=dt).element_size()
    return total


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
def test_argument_bytes_equal_the_reference_shard_shapes(reference,
                                                         multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    for arch in configs.ARCH_IDS:
        ref = reference[f"{arch}|{multi_pod}"]
        _, args, shs, _ = dryrun.build_cell(arch, "train_4k", mesh)
        # params, mu and nu in f32, step int32 (replicated), the batch
        want = 3 * _reference_bytes(ref["train"]) + 4 + \
            _reference_bytes(ref["batch_train_4k"])
        assert dryrun.shard_bytes(args, shs) == want, arch
        _, args, shs, _ = dryrun.build_cell(arch, "decode_32k", mesh)
        dtypes = {k: L.storage_dtype(k) for k in ref["serve"]}
        want = (_reference_bytes(ref["serve"], dtypes)
                + _reference_bytes(ref["batch_decode_32k"])
                + _reference_bytes({p: (s, sh, dt) for p, s, sh, dt
                                    in ref["cache"]}))
        assert dryrun.shard_bytes(args, shs) == want, arch


def test_skip_rule_matches_the_reference():
    for arch in configs.ARCH_IDS:
        cfg, jcfg = configs.get(arch), jconfigs.get(arch)
        assert [s.name for s in B.applicable_shapes(cfg)] == \
            [s.name for s in JB.applicable_shapes(jcfg)]
        for s, js in zip(B.ALL_SHAPES, JB.ALL_SHAPES):
            assert B.skip_reason(cfg, s) == JB.skip_reason(jcfg, js)
            assert configs.get_shape(s.name) == s
    rec = dryrun.run_cell("llama3-8b", "long_500k")
    assert rec["status"] == "SKIP" and "full-attention" in rec["reason"]
    with pytest.raises(KeyError):
        configs.get_shape("train_8k")


@pytest.mark.parametrize("arch,shape,multi_pod",
                         [("mamba2-1.3b", "long_500k", True),
                          ("recurrentgemma-2b", "decode_32k", False),
                          ("seamless-m4t-large-v2", "prefill_32k", False)])
def test_cells_trace_on_meta(arch, shape, multi_pod):
    rec = dryrun.run_cell(arch, shape, multi_pod=multi_pod)
    assert rec["status"] == "OK" and rec["n_devices"] == \
        (512 if multi_pod else 256)
    pd = rec["per_device"]
    assert pd["argument_bytes"] > 0 and pd["output_bytes"] > 0
    assert pd["flops"] > 0 and rec["trace_s"] >= 0
    assert not set(dryrun.OMITTED) & (set(rec) | set(pd))


def test_dryrun_cli_names_what_it_leaves_out(capsys):
    recs = dryrun.main(["--arch", "mamba2-1.3b", "--shape", "long_500k",
                        "--both-meshes"])
    out = capsys.readouterr().out
    assert [r["mesh"] for r in recs] == ["single", "multi"]
    assert "temp_bytes, alias_bytes, bytes_accessed" in out
    assert out.count("OK   mamba2-1.3b × long_500k") == 2


def test_meshes_and_meta_refusal():
    mesh = make_host_mesh(4, device="cpu")
    assert mesh.shape == {"data": 4}
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).shape == \
        {"pod": 2, "data": 16, "model": 16}
    from repro_torch.core.device import resolve_device
    with pytest.raises(ValueError, match="meta"):
        resolve_device("meta")


def test_expert_counts_equal_bincount_and_run_on_meta():
    rng = np.random.default_rng(0)
    for E, n in ((4, 64), (16, 1000), (8, 3)):
        flat = torch.from_numpy(rng.integers(0, E, n))
        assert torch.equal(Mo.expert_counts(flat, E),
                           torch.bincount(flat, minlength=E))
    idx = torch.empty((32, 2), dtype=torch.int64, device="meta")
    slot, keep, pos = Mo.dispatch_indices(idx, 4, 24)
    assert slot.shape == (96,) and keep.shape == (32, 2)
    assert slot.is_meta and pos.is_meta


# ---- the remat policy ------------------------------------------------------

ARCH = "llama3-8b"
jax_loss_grad = jax.jit(
    jax.value_and_grad(JT.loss_fn, has_aux=True),
    static_argnames=("cfg", "opt_cfg", "remat", "chunks"))


def _port(npp, tb, policy):
    cfg = configs.get_smoke(ARCH)
    tp = L.params_from_numpy(npp, "cpu", dtype=torch.float32)
    with scanctl.remat_policy(policy), FlopCounterMode(display=False) as f:
        out = T.loss_and_grads(tp, cfg, tb, O.OptConfig(), remat=True,
                               chunks=(8, 8))
    return out, f.get_total_flops()


def test_remat_dots_matches_full_and_jax():
    jcfg, npp = jax_params(ARCH)
    jb, tb = batches(jcfg, 16, 2)
    ((ft, _), fg), full_flops = _port(npp, tb, "full")
    ((dt, dm), dg), dots_flops = _port(npp, tb, "dots")
    assert torch.equal(ft, dt)
    for k in fg:
        assert torch.equal(fg[k], dg[k]), k
    assert dots_flops < full_flops
    with jscanctl.remat_policy("dots"):
        (rt, rm), rg = jax_loss_grad(
            {k: jnp.asarray(v) for k, v in npp.items()}, cfg=jcfg,
            batch=jb, opt_cfg=JO.OptConfig(), remat=True, chunks=(8, 8))
    assert abs(float(dt) - float(rt)) <= LOSS_RTOL * abs(float(rt))
    for k in rg:
        assert rel_norm(dg[k].numpy(), np.asarray(rg[k])) <= GRAD_TOL, k
    with pytest.raises(ValueError):
        with scanctl.remat_policy("offload"):
            pass


def test_remat_dots_keeps_the_batch_free_products():
    """Under "dots" the backward recomputes fewer 2-D products (``mm``)
    and the same batched ones (``bmm``, the attention's)."""
    _, npp = jax_params(ARCH)
    tp = L.params_from_numpy(npp, "cpu", dtype=torch.float32)
    cfg = configs.get_smoke(ARCH)
    _, tb = batches(jconfigs.get_smoke(ARCH), 16, 2)
    counts = {}
    for policy in ("full", "dots"):
        with scanctl.remat_policy(policy), \
                FlopCounterMode(display=False) as f:
            T.loss_and_grads(tp, cfg, tb, O.OptConfig(), remat=True,
                             chunks=(8, 8))
        counts[policy] = f.get_flop_counts()["Global"]
    mm, bmm = torch.ops.aten.mm, torch.ops.aten.bmm
    assert counts["dots"][mm] < counts["full"][mm]
    assert counts["dots"][bmm] == counts["full"][bmm] > 0


def test_sharding_for_tree_equals_the_spec_shardings():
    mesh = make_production_mesh()
    specs = M.param_specs(configs.get("qwen3-4b"))
    rules = SH.rules_for("train")
    tree = SH.sharding_for_tree({k: s.shape for k, s in specs.items()},
                                {k: s.axes for k, s in specs.items()},
                                rules, mesh)
    assert tree == SH.shardings_for_specs(specs, rules, mesh)
    b = SH.batch_sharding({"tokens": torch.empty((256, 4096))}, rules, mesh)
    assert b["tokens"] == SH.Sharding(SH.P("data"), (16, 4096))
