"""The port's MoE FFN (`repro_torch.nn.moe`) and MLA
(`repro_torch.nn.attention.mla_attention`) against the JAX package, on
the CPU at the dbrx and deepseek-v2 smoke configs.

Inputs are drawn with numpy from fixed seeds; the reference's params
(its spec functions, `init_params`, every f32 leaf perturbed) are
carried over with `params_from_numpy`.  Tolerances:

* `topk_route`'s indices, `dispatch_indices` (slot table, keep mask,
  ranks) on random and on skewed assignments (forced drops), and
  ``moe_dropped``: exactly equal.
* `topk_route`'s probs and ``moe_balance`` (f32): ``rtol 1e-6``.
* `moe_ffn`'s output (bf16): within one bf16 ulp of max|ref| — the same
  f32 products of bf16 operands, rounded at the same points, but the
  router's f32 sums round apart from the reference's (by about 2⁻²¹ of
  their size), so a routing weight near a bf16 rounding boundary can
  round the other way (exactly equal at the random router here).
* `mla_attention`: the prefill output within one bf16 ulp of max|ref|
  (its attention's online softmax runs over other chunks than the
  reference's here), its primed (c_kv, k_rope) and the absorbed decode's
  output and cache exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.nn import attention as JA
from repro.nn import layers as JL
from repro.nn import moe as JMo
from repro.nn import transformer as JT
from repro_torch import configs
from repro_torch.nn import attention as A
from repro_torch.nn import layers as L
from repro_torch.nn import moe as Mo
from test_torch_lm import bf16_pair, f32

torch.set_num_threads(1)
MOE_ARCHS = ("dbrx-132b", "deepseek-v2-236b")


def module_params(specs, seed, prefix):
    """A module's reference params under `prefix`, every f32 leaf
    perturbed, for both packages."""
    p = JL.init_params(specs, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    npp = {}
    for k, v in p.items():
        a, key = np.array(v), f"{prefix}/{k}"
        if L.storage_dtype(key) == torch.float32:
            a = (a + rng.normal(0, 0.1, a.shape)).astype(np.float32)
        npp[key] = a
    return ({k: jnp.asarray(v) for k, v in npp.items()},
            L.params_from_numpy(npp, "cpu"))


def ulp_of_max(ref):
    return 2.0 ** (np.floor(np.log2(np.abs(f32(ref)).max())) - 7)


# ---- routing and dispatch ------------------------------------------------------

@pytest.mark.parametrize("T,E,k", [(24, 4, 2), (40, 8, 2), (64, 16, 4)])
def test_topk_route_matches_jax(T, E, k):
    logits = np.random.default_rng(T + E).standard_normal(
        (T, E)).astype(np.float32)
    rp, ri = JMo.topk_route(jnp.asarray(logits), k)
    gp, gi = Mo.topk_route(torch.from_numpy(logits), k)
    assert gi.tolist() == np.asarray(ri).tolist()
    np.testing.assert_allclose(gp.numpy(), np.asarray(rp), rtol=1e-6)


@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("T,E,k,C", [(24, 4, 2, 16), (40, 8, 2, 8),
                                     (64, 16, 4, 24)])
def test_dispatch_indices_match_jax(T, E, k, C, skew):
    rng = np.random.default_rng(T * 7 + skew)
    if skew:          # most assignments on experts 0 and 1: over capacity
        p = np.full(E, 0.1 / (E - 2))
        p[:2] = 0.45
        idx = np.stack([rng.choice(E, k, replace=False, p=p)
                        for _ in range(T)])
    else:
        idx = np.stack([rng.choice(E, k, replace=False) for _ in range(T)])
    ref = JMo.dispatch_indices(jnp.asarray(idx, jnp.int32), E, C)
    got = Mo.dispatch_indices(torch.from_numpy(idx), E, C)
    for g, r in zip(got, ref):
        assert g.tolist() == np.asarray(r).tolist()
    if skew:                                  # the skew passes capacity
        assert not np.asarray(ref[1]).all()


# ---- the MoE FFN -----------------------------------------------------------------

@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe_case(request):
    arch = request.param
    jcfg, cfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    jp, tp = module_params(JT.moe_specs(jcfg), 1, "moe")
    jx, tx = bf16_pair(np.random.default_rng(2), (2, 12, cfg.d_model))
    return (JMo.moe_ffn(jp, "moe", jx, jcfg),
            Mo.moe_ffn(tp, "moe", tx, cfg))


def test_moe_ffn_matches_jax(moe_case):
    (ry, _), (gy, _) = moe_case
    assert gy.dtype == torch.bfloat16 and gy.shape == ry.shape
    assert np.abs(f32(gy) - f32(ry)).max() <= ulp_of_max(ry)


def test_moe_aux_matches_jax(moe_case):
    (_, raux), (_, gaux) = moe_case
    assert set(gaux) == set(raux) == {"moe_balance", "moe_dropped"}
    assert float(gaux["moe_dropped"]) == float(raux["moe_dropped"])
    np.testing.assert_allclose(float(gaux["moe_balance"]),
                               float(raux["moe_balance"]), rtol=1e-6)


def test_moe_ffn_drops_match_jax():
    """A router that sends every token to experts 0 and 1: most
    assignments pass capacity and contribute zero, on both sides."""
    jcfg, cfg = (jconfigs.get_smoke("dbrx-132b"),
                 configs.get_smoke("dbrx-132b"))
    jp, tp = module_params(JT.moe_specs(jcfg), 5, "moe")
    router = np.zeros((cfg.d_model, cfg.moe.n_experts), np.float32)
    router[:, :2] = np.random.default_rng(5).normal(
        0, 0.01, (cfg.d_model, 2)) + 1.0
    jp["moe/router"] = jnp.asarray(router)
    tp["moe/router"] = torch.from_numpy(router)
    jx, tx = bf16_pair(np.random.default_rng(6), (2, 20, cfg.d_model))
    jx, tx = jnp.abs(jx), tx.abs()          # positive: experts 0, 1 win
    ry, raux = JMo.moe_ffn(jp, "moe", jx, jcfg)
    gy, gaux = Mo.moe_ffn(tp, "moe", tx, cfg)
    assert float(raux["moe_dropped"]) > 0.1
    assert float(gaux["moe_dropped"]) == float(raux["moe_dropped"])
    assert np.abs(f32(gy) - f32(ry)).max() <= ulp_of_max(ry)


# ---- MLA --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mla_case():
    arch = "deepseek-v2-236b"
    jcfg, cfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    jp, tp = module_params(JT.mla_specs(jcfg), 2, "attn")
    rng = np.random.default_rng(3)
    jx, tx = bf16_pair(rng, (2, 12, cfg.d_model))
    pos = np.arange(12, dtype=np.int32)
    ref = JA.mla_attention(jp, "attn", jx, jcfg, jnp.asarray(pos),
                           return_kv=True, q_chunk=8, kv_chunk=8)
    got = A.mla_attention(tp, "attn", tx, cfg, torch.from_numpy(pos),
                          return_kv=True)
    return jcfg, cfg, jp, tp, rng, ref, got


def test_mla_prefill_matches_jax(mla_case):
    *_, (r, (rc, rk)), (g, (gc, gk)) = mla_case
    assert g.dtype == torch.bfloat16 and g.shape == r.shape
    assert np.abs(f32(g) - f32(r)).max() <= ulp_of_max(r)
    assert np.array_equal(f32(gc), f32(rc))
    assert np.array_equal(f32(gk), f32(rk))


def test_mla_absorbed_decode_matches_jax(mla_case):
    jcfg, cfg, jp, tp, rng, (_, (rc, rk)), _ = mla_case
    smax, S = 16, 12
    cc = np.zeros((2, smax, cfg.mla.kv_lora), np.float32)
    kr = np.zeros((2, smax, cfg.mla.rope_dim), np.float32)
    cc[:, :S], kr[:, :S] = f32(rc), f32(rk)
    jc = JA.MLACache(jnp.asarray(cc, jnp.bfloat16),
                     jnp.asarray(kr, jnp.bfloat16), jnp.asarray(S, jnp.int32))
    tc = A.MLACache(torch.from_numpy(cc).bfloat16(),
                    torch.from_numpy(kr).bfloat16(),
                    torch.tensor(S, dtype=torch.int32))
    for step in range(2):
        jx, tx = bf16_pair(rng, (2, 1, cfg.d_model))
        pos = np.array([S + step], np.int32)
        r, jc = JA.mla_attention(jp, "attn", jx, jcfg, jnp.asarray(pos),
                                 cache=jc, q_chunk=1, kv_chunk=8)
        g, tc = A.mla_attention(tp, "attn", tx, cfg, torch.from_numpy(pos),
                                cache=tc, q_chunk=1, kv_chunk=8)
        assert np.array_equal(f32(g), f32(r))
        assert np.array_equal(f32(tc.c_kv), f32(jc.c_kv))
        assert np.array_equal(f32(tc.k_rope), f32(jc.k_rope))
        assert int(tc.length) == int(jc.length) == S + step + 1
