"""The port's training path (`repro_torch.train`, `data/pipeline.py`,
`nn/model.forward_train`, the training route of `nn/attention.py`)
against the JAX package, on the CPU at the llama3-8b smoke config.

Params go from the reference's `init_params` (numpy, every f32 leaf of
its serving storage perturbed: norm scales and biases start at 1 and 0)
through `params_from_numpy(..., dtype=float32)`, the training storage.
Tolerances:

* Loss (and ``total``): within 1e-3 relative of the reference's.
* Each gradient leaf: ``‖g − g_ref‖ ≤ 2e-2 · ‖g_ref‖`` (bf16 compute:
  both packages round the same activations to bf16, their f32 sums in
  another order).
* `apply_updates` fed the same params, gradients and state: params and
  moments within 1e-6 relative elementwise (f32 elementwise arithmetic),
  ``lr`` and ``grad_norm`` the same.
* Schedules: within 1e-7 of the reference's, at every step.
* `cross_entropy`: within 1e-6 relative; pipeline batches and
  `input_shapes`: exactly equal.
* One `train_step` (microbatches 1 and 2): loss within 1e-3 relative,
  ``grad_norm`` within 2e-2, ``lr`` within 1e-7; ``mu`` within 2e-2 and
  ``nu`` (∝ g²) within 4e-2 of the reference's norm per leaf; the step's
  update of each param leaf in the reference's sign on at least 99 % of
  its entries (Adam's first step is about ``lr · sign(g)``, so an entry
  whose gradient is within the bf16 noise of zero may flip).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import base as JB
from repro.data import pipeline as JP
from repro.nn import model as JM
from repro.train import optimizer as JO
from repro.train import train_step as JT
from repro_torch import configs
from repro_torch.configs import base as B
from repro_torch.data import pipeline as P
from repro_torch.data.pipeline import SyntheticLM, to_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.nn import attention as A
from repro_torch.nn import layers as L
from repro_torch.nn import model as M
from repro_torch.nn import moe as Mo
from repro_torch.train import optimizer as O
from repro_torch.train import train_step as T
from test_torch_lm import bf16_pair, f32, jax_params

torch.set_num_threads(1)
ARCH = "llama3-8b"
LOSS_RTOL = 1e-3
GRAD_TOL = 2e-2
LR_TOL = 1e-7


def rel_norm(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def batches(jcfg, S, Bsz, step=0, seed=0):
    b = JP.SyntheticLM(jcfg, S, Bsz, seed=seed).batch(step)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            to_device(b, "cpu"))


# ---- loss -------------------------------------------------------------------------

def test_cross_entropy_masking():
    logits = torch.zeros((1, 4, 10))
    labels = torch.tensor([[1, 2, -1, -1]])
    # uniform logits: nll == ln(10) on the 2 valid positions
    assert abs(float(T.cross_entropy(logits, labels)) - np.log(10)) < 1e-6
    none = torch.full((1, 4), -1)
    assert float(T.cross_entropy(logits, none)) == 0.0


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((2, 9, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, (2, 9)).astype(np.int32)
    labels[0, -3:] = labels[1, :2] = -1
    ref = float(JT.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(T.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels)))
    assert abs(got - ref) <= 1e-6 * abs(ref)


# ---- schedules and the optimizer --------------------------------------------------

@pytest.mark.parametrize("schedule", ["cosine", "wsd", "const"])
def test_schedule_matches_jax(schedule):
    kw = dict(peak_lr=0.7, warmup_steps=10, total_steps=100,
              schedule=schedule, wsd_decay_frac=0.2, min_lr_frac=0.1)
    jcfg, cfg = JO.OptConfig(**kw), O.OptConfig(**kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for s in range(0, 111):
        got = O.learning_rate(s, cfg)
        assert got.dtype == torch.float32
        assert abs(float(got) - float(JO.learning_rate(s, jcfg))) <= LR_TOL
    step = torch.tensor(37, dtype=torch.int32)
    assert float(O.learning_rate(step, cfg)) == float(
        O.learning_rate(37, cfg))


def test_wsd_and_cosine_schedule_shapes():
    cfg = O.OptConfig(peak_lr=1.0, warmup_steps=10, total_steps=100,
                      schedule="wsd", wsd_decay_frac=0.2, min_lr_frac=0.1)
    lrs = [float(O.learning_rate(s, cfg)) for s in range(101)]
    assert lrs[0] < 0.2 and abs(lrs[10] - 1.0) < 1e-6
    assert abs(lrs[50] - 1.0) < 1e-6 and lrs[95] < 0.6
    assert abs(lrs[100] - 0.1) < 0.02
    cos = O.OptConfig(peak_lr=2.0, warmup_steps=10, total_steps=100,
                      schedule="cosine", min_lr_frac=0.1)
    assert abs(float(O.learning_rate(10, cos)) - 2.0) < 1e-6
    assert abs(float(O.learning_rate(100, cos)) - 0.2) < 1e-5
    with pytest.raises(ValueError):
        O.learning_rate(1, O.OptConfig(schedule="linear"))


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_decay_mask_matches_jax_on_every_param(arch):
    for cfg in (configs.get(arch), configs.get_smoke(arch)):
        paths = list(M.param_specs(cfg))
        assert [O._decay_mask(p) for p in paths] == \
            [JO._decay_mask(p) for p in paths]
    assert O._decay_mask("blocks/attn/wq")
    assert not O._decay_mask("blocks/norm1")
    assert not O._decay_mask("blocks/attn/wq_b")
    assert not O._decay_mask("blocks/ssm/A_log")


def test_grad_clipping_bounds_update():
    params = {"w": torch.ones(4)}
    grads = {"w": torch.full((4,), 1e6)}
    st = O.init_opt_state(params)
    cfg = O.OptConfig(peak_lr=1.0, warmup_steps=0, total_steps=10,
                      clip_norm=1.0, weight_decay=0.0, schedule="const")
    before = params["w"].clone()
    p2, st2, m = O.apply_updates(params, grads, st, cfg)
    assert float(m["grad_norm"]) > 1e5
    # post-clip Adam step magnitude is bounded by ~lr
    assert float((p2["w"] - before).abs().max()) < 3.5
    assert int(st2["step"]) == 1 and st2["step"].dtype == torch.int32


@pytest.mark.parametrize("clip_norm,weight_decay", [(1.0, 0.1), (0.0, 0.0),
                                                    (1e3, 0.1)],
                         ids=["clipped", "plain", "unclipped"])
def test_apply_updates_matches_jax(clip_norm, weight_decay):
    """Three AdamW steps from the same params, gradients and state."""
    rng = np.random.default_rng(5)
    shapes = {"blocks/attn/wq": (6, 8), "blocks/norm1": (8,),
              "blocks/ssm/A_log": (3,), "embed/tok": (11, 8)}
    npp = {k: rng.standard_normal(s).astype(np.float32)
           for k, s in shapes.items()}
    kw = dict(peak_lr=0.05, warmup_steps=2, total_steps=10,
              clip_norm=clip_norm, weight_decay=weight_decay)
    jcfg, cfg = JO.OptConfig(**kw), O.OptConfig(**kw)
    jp = {k: jnp.asarray(v) for k, v in npp.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in npp.items()}
    jst, tst = JO.init_opt_state(jp), O.init_opt_state(tp)
    for _ in range(3):
        g = {k: (rng.standard_normal(s) * 3).astype(np.float32)
             for k, s in shapes.items()}
        jp, jst, jm = JO.apply_updates(jp, {k: jnp.asarray(v) for k, v in
                                            g.items()}, jst, jcfg)
        tp, tst, tm = O.apply_updates(tp, {k: torch.from_numpy(v) for k, v
                                           in g.items()}, tst, cfg)
        for k in shapes:
            for got, ref in ((tp[k], jp[k]), (tst["mu"][k], jst["mu"][k]),
                             (tst["nu"][k], jst["nu"][k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                           rtol=1e-6, atol=1e-7)
        assert int(tst["step"]) == int(jst["step"])
        for name in ("lr", "grad_norm"):
            assert abs(float(tm[name]) - float(jm[name])) <= \
                1e-6 * abs(float(jm[name]))


def test_init_opt_state_matches_jax():
    jcfg, npp = jax_params(ARCH)
    tp = L.params_from_numpy(npp, "cpu", dtype=torch.float32)
    st = O.init_opt_state(tp)
    ref = JO.init_opt_state({k: jnp.asarray(v) for k, v in npp.items()})
    assert set(st) == set(ref) == {"mu", "nu", "step"}
    for part in ("mu", "nu"):
        assert set(st[part]) == set(ref[part])
        for k, v in st[part].items():
            assert v.dtype == torch.float32 and not v.any()
            assert tuple(v.shape) == tuple(ref[part][k].shape)
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 0


# ---- the data pipeline -------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3-8b", "pixtral-12b",
                                  "seamless-m4t-large-v2"])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_synthetic_batches_equal_jax(arch, n_shards):
    jcfg, cfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    ref = JP.SyntheticLM(jcfg, 12, 8, seed=3)
    got = SyntheticLM(cfg, 12, 8, seed=3)
    for step in (0, 7):
        for shard in range(n_shards):
            r = ref.batch(step, shard, n_shards)
            g = got.batch(step, shard, n_shards)
            assert sorted(g) == sorted(r)
            for k in r:
                assert g[k].dtype == r[k].dtype and np.array_equal(g[k], r[k])
    b = got.batch(7)
    assert (b["labels"][:, :-1] == b["tokens"][:, 1:]).all()
    assert not np.array_equal(b["tokens"], got.batch(8)["tokens"])


@pytest.mark.parametrize("arch", ["llama3-8b", "pixtral-12b",
                                  "seamless-m4t-large-v2"])
def test_input_shapes_match_jax(arch):
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    for shape, jshape in zip(B.ALL_SHAPES, JB.ALL_SHAPES):
        assert dataclasses.asdict(shape) == dataclasses.asdict(jshape)
        for per_device in (None, 4):
            got = P.input_shapes(cfg, shape, per_device)
            ref = JP.input_shapes(jcfg, jshape, per_device)
            assert sorted(got) == sorted(ref)
            for k, (shp, dt) in got.items():
                assert shp == tuple(ref[k].shape), k
                assert str(dt).split(".")[-1] == str(ref[k].dtype), k


# ---- loss and gradients against the reference --------------------------------------

jax_loss_grad = jax.jit(
    jax.value_and_grad(JT.loss_fn, has_aux=True),
    static_argnames=("cfg", "opt_cfg", "remat", "chunks"))


def loss_and_grads_pair(arch, npp, S=16, Bsz=2, remat=True,
                        chunks=(8, 8)):
    """(reference, port) of ((total, metrics), grads) on the pipeline's
    batch 0."""
    jcfg, cfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    jb, tb = batches(jcfg, S, Bsz)
    ref = jax_loss_grad({k: jnp.asarray(v) for k, v in npp.items()},
                        cfg=jcfg, batch=jb, opt_cfg=JO.OptConfig(),
                        remat=remat, chunks=chunks)
    tp = L.params_from_numpy(npp, "cpu", dtype=torch.float32)
    got = T.loss_and_grads(tp, cfg, tb, O.OptConfig(), remat=remat,
                           chunks=chunks)
    return ref, got


def assert_grads_close(got, ref, tol):
    assert sorted(got) == sorted(ref)
    for k in ref:
        g = got[k]
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), k
        assert rel_norm(g.numpy(), np.asarray(ref[k])) <= tol, \
            (k, rel_norm(g.numpy(), np.asarray(ref[k])))


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no remat"])
def test_loss_and_grads_match_jax(remat):
    _, npp = jax_params(ARCH)
    ((rt, rm), rg), ((gt, gm), gg) = loss_and_grads_pair(ARCH, npp,
                                                         remat=remat)
    assert abs(float(gt) - float(rt)) <= LOSS_RTOL * abs(float(rt))
    assert abs(float(gm["loss"]) - float(rm["loss"])) <= \
        LOSS_RTOL * abs(float(rm["loss"]))
    assert_grads_close(gg, rg, GRAD_TOL)


def test_remat_changes_nothing_in_the_port():
    """Remat recomputes the same layers: equal loss and gradients."""
    _, npp = jax_params(ARCH)
    cfg = configs.get_smoke(ARCH)
    _, tb = batches(jconfigs.get_smoke(ARCH), 16, 2)
    out = [T.loss_and_grads(L.params_from_numpy(npp, "cpu",
                                                dtype=torch.float32),
                            cfg, tb, O.OptConfig(), remat=r, chunks=(8, 8))
           for r in (True, False)]
    assert torch.equal(out[0][0][0], out[1][0][0])
    for k in out[0][1]:
        assert torch.equal(out[0][1][k], out[1][1][k]), k


jax_train_step = jax.jit(
    JT.train_step,
    static_argnames=("cfg", "opt_cfg", "remat", "chunks", "microbatches"))


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(microbatches):
    jcfg, npp = jax_params(ARCH)
    cfg = configs.get_smoke(ARCH)
    kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10)
    jb, tb = batches(jcfg, 16, 4)
    jp = {k: jnp.asarray(v) for k, v in npp.items()}
    jp2, jst, jm = jax_train_step(jp, JO.init_opt_state(jp), jb, cfg=jcfg,
                                  opt_cfg=JO.OptConfig(**kw), remat=True,
                                  chunks=(8, 8), microbatches=microbatches)
    tp = L.params_from_numpy(npp, "cpu", dtype=torch.float32)
    tp2, tst, tm = T.train_step(tp, O.init_opt_state(tp), tb, cfg,
                                O.OptConfig(**kw), remat=True, chunks=(8, 8),
                                microbatches=microbatches)
    assert sorted(tm) == sorted(jm)
    for k in ("loss", "total"):
        assert abs(float(tm[k]) - float(jm[k])) <= LOSS_RTOL * abs(
            float(jm[k]))
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
        GRAD_TOL * float(jm["grad_norm"])
    assert abs(float(tm["lr"]) - float(jm["lr"])) <= LR_TOL
    assert int(tst["step"]) == int(jst["step"]) == 1
    for k in npp:
        assert tp2[k].dtype == torch.float32
        assert rel_norm(tst["mu"][k].numpy(), jst["mu"][k]) <= GRAD_TOL, k
        assert rel_norm(tst["nu"][k].numpy(), jst["nu"][k]) <= 2 * GRAD_TOL
        du, dr = tp2[k].numpy() - npp[k], np.asarray(jp2[k]) - npp[k]
        assert np.mean(np.sign(du) == np.sign(dr)) >= 0.99, k


def test_microbatches_split_the_batch():
    """Two microbatches of equal token counts: the mean of their
    gradients is the whole batch's (up to f32 sums), and a batch that
    does not split raises."""
    _, npp = jax_params(ARCH)
    cfg = configs.get_smoke(ARCH)
    _, tb = batches(jconfigs.get_smoke(ARCH), 16, 4)
    kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10)
    out = []
    for mb in (1, 2):
        tp = L.params_from_numpy(npp, "cpu", dtype=torch.float32)
        out.append(T.train_step(tp, O.init_opt_state(tp), tb, cfg,
                                O.OptConfig(**kw), microbatches=mb,
                                chunks=(8, 8)))
    (_, s1, m1), (_, s2, m2) = out
    assert abs(float(m1["loss"]) - float(m2["loss"])) <= 1e-3
    for k in s1["mu"]:
        assert rel_norm(s2["mu"][k].numpy(), s1["mu"][k].numpy()) <= \
            GRAD_TOL, k
    tp = L.params_from_numpy(npp, "cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="microbatches"):
        T.train_step(tp, O.init_opt_state(tp), tb, cfg, O.OptConfig(),
                     microbatches=3)


def test_loss_decreases_on_learnable_task():
    cfg = configs.get_smoke(ARCH)
    data = SyntheticLM(cfg, seq_len=32, global_batch=8, seed=0)
    params = L.init_params(M.param_specs(cfg),
                           torch.Generator().manual_seed(0), "cpu",
                           dtype=torch.float32)
    opt = O.init_opt_state(params)
    ocfg = O.OptConfig(peak_lr=3e-3, warmup_steps=5, total_steps=60,
                       schedule="cosine")
    losses = []
    for s in range(60):
        params, opt, m = T.train_step(params, opt,
                                      to_device(data.batch(s), "cpu"), cfg,
                                      ocfg, remat=False, chunks=(8, 8))
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    # affine-recurrence task: must drop clearly below uniform (ln 256≈5.55)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 1.0, losses[-5:]


def test_training_storage_is_f32_and_serving_bf16():
    _, npp = jax_params(ARCH)
    train = L.params_from_numpy(npp, "cpu", dtype=torch.float32)
    serve = L.params_from_numpy(npp, "cpu")
    for k, v in npp.items():
        assert train[k].dtype == torch.float32
        assert np.array_equal(train[k].numpy(), v)
        assert serve[k].dtype == L.storage_dtype(k)
    cfg = configs.get_smoke(ARCH)
    drawn = L.init_params(M.param_specs(cfg), torch.Generator().manual_seed(0),
                          "cpu", dtype=torch.float32)
    assert all(v.dtype == torch.float32 for v in drawn.values())
    same = L.init_params(M.param_specs(cfg), torch.Generator().manual_seed(0),
                         "cpu")
    for k, v in same.items():
        assert torch.equal(v, drawn[k].to(v.dtype)), k


# ---- training never reaches the flash kernel ----------------------------------------

def qkv(rng, S=32, H=4, KV=2, hd=16):
    return (bf16_pair(rng, (2, S, H, hd))[1], bf16_pair(rng, (2, S, KV, hd))[1],
            bf16_pair(rng, (2, S, KV, hd))[1])


@pytest.mark.parametrize("which", [0, 1, 2], ids=["q", "k", "v"])
def test_flash_attention_raises_under_grad(which):
    q, k, v = qkv(np.random.default_rng(which))
    args = [q, k, v]
    args[which] = args[which].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(*args)
    with torch.no_grad():
        out = flash_attention(*args)
    assert out.grad_fn is None
    assert torch.equal(out, flash_attention(q, k, v))


def test_gqa_attention_trains_through_blocked_attention():
    """A cache-less call whose input requires grad takes
    `blocked_attention` (it has a grad_fn, reaches no flash launch, and
    equals the blocked function); without grad it takes the flash
    route."""
    cfg = configs.get_smoke(ARCH)
    _, npp = jax_params(ARCH)
    lp = {k[len("blocks/"):]: v[0] for k, v in L.params_from_numpy(
        npp, "cpu", dtype=torch.float32).items() if k.startswith("blocks/")}
    x = bf16_pair(np.random.default_rng(1), (2, 16, cfg.d_model))[1]
    pos = torch.arange(16, dtype=torch.int32)
    before = flash_attention.launches
    lp = {k: v.clone().requires_grad_(True) for k, v in lp.items()}
    out, _ = A.gqa_attention(lp, "attn", x, cfg, pos)
    assert out.grad_fn is not None
    out.float().sum().backward()
    assert lp["attn/wq"].grad is not None and lp["attn/wq"].grad.abs().sum() > 0
    q, k, v = A.gqa_project_qkv(lp, "attn", x, cfg)
    q = L.apply_rope(q, pos, cfg.rope_theta, seq_axis=1)
    k = L.apply_rope(k, pos, cfg.rope_theta, seq_axis=1)
    ref = L.dense(A.blocked_attention(q, k, v, pos, pos).reshape(2, 16, -1),
                  lp["attn/wo"])
    assert torch.equal(out, ref)
    with torch.no_grad():
        served, _ = A.gqa_attention(lp, "attn", x, cfg, pos)
    assert served.grad_fn is None
    assert np.abs(f32(served) - f32(out.detach())).max() <= 2 ** -6 * \
        np.abs(f32(out.detach())).max()
    assert flash_attention.launches == before


def test_expert_product_backward_is_the_widened_products():
    """`ExpertProductF32` (the MoE gate and up product, whose card GEMM
    autograd does not differentiate) against `einsum_f32` under
    autograd: the same f32 products of the bf16
    values, rounded to bf16, forward and backward (within one bf16 ulp
    of max|ref|: f32 sums in another order)."""
    rng = np.random.default_rng(4)
    xe = torch.from_numpy(rng.standard_normal((3, 8, 16), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 16, 24), dtype=np.float32))
    g = torch.from_numpy(rng.standard_normal((3, 8, 24), dtype=np.float32))
    outs = []
    for fn in (lambda a, b: Mo.ExpertProductF32.apply(L.cast_bf16(a),
                                                      L.cast_bf16(b)),
               lambda a, b: L.einsum_f32("ecd,edf->ecf", a, b)):
        a, b = xe.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y = fn(a, b)
        y.backward(g)
        outs.append((y.detach(), a.grad, b.grad))
    for got, ref in zip(*outs):
        assert got.dtype == ref.dtype == torch.float32
        bound = 2.0 ** (np.floor(np.log2(ref.abs().max().item())) - 7)
        assert (got - ref).abs().max().item() <= bound
