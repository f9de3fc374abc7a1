"""The port's Mamba-2 SSD block (`repro_torch.nn.ssm`) against the JAX
package, on the CPU at the mamba2 smoke config.

Inputs are drawn with numpy from fixed seeds; the reference's params
(its `ssm_specs`, `init_params`, every f32 leaf perturbed) are carried
over with `params_from_numpy`.  Tolerances:

* `_segsum`: f32, ``atol 1e-6`` (cumulative sums of the same values in
  another order), the masked entries -inf on both sides.
* `_causal_conv`, prefill and streaming tail: the output (bf16) exactly
  equal, the new tail exactly equal.
* `ssd_chunked` at a ragged S (21 over chunks of 8: the last chunk
  padded with dt = 0): the output (bf16) within one bf16 ulp of max|ref|
  (exactly equal here), the final state (f32) within ``2⁻²⁰ · max|ref|``
  (its einsums and cumsums sum in another order).
* `ssm_block` prefill and O(1) decode: the output within one bf16 ulp of
  max|ref| (exactly equal here), the state as `ssd_chunked`'s, the conv
  tail exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.nn import ssm as JS
from repro.nn import transformer as JT
from repro_torch import configs
from repro_torch.nn import ssm as S
from test_torch_lm import bf16_pair, f32
from test_torch_moe import module_params, ulp_of_max

torch.set_num_threads(1)
ARCH = "mamba2-1.3b"


def assert_state(got, ref):
    r = f32(ref)
    assert np.abs(f32(got) - r).max() <= 2.0 ** -20 * np.abs(r).max()


@pytest.mark.parametrize("Q", [1, 5, 8])
def test_segsum_matches_jax(Q):
    x = np.random.default_rng(Q).standard_normal((2, 3, Q)).astype(
        np.float32)
    ref = np.asarray(JS._segsum(jnp.asarray(x)))
    got = S._segsum(torch.from_numpy(x)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], atol=1e-6)


@pytest.mark.parametrize("W,S_", [(4, 13), (4, 2), (1, 5)])
def test_causal_conv_matches_jax(W, S_):
    rng = np.random.default_rng(W * 10 + S_)
    w = (rng.standard_normal((W, 48)) * 0.5).astype(np.float32)
    b = (rng.standard_normal(48) * 0.1).astype(np.float32)
    jx, tx = bf16_pair(rng, (2, S_, 48))
    r, rt = JS._causal_conv(jx, jnp.asarray(w), jnp.asarray(b))
    g, gt = S._causal_conv(tx, torch.from_numpy(w), torch.from_numpy(b))
    assert g.dtype == torch.bfloat16
    assert np.array_equal(f32(g), f32(r)) and np.array_equal(f32(gt), f32(rt))
    if W > 1:                                   # streaming: one new step
        jx1, tx1 = bf16_pair(rng, (2, 1, 48))
        r, rt = JS._causal_conv(jx1, jnp.asarray(w), jnp.asarray(b), rt)
        g, gt = S._causal_conv(tx1, torch.from_numpy(w), torch.from_numpy(b),
                               gt)
        assert np.array_equal(f32(g), f32(r))
        assert np.array_equal(f32(gt), f32(rt))


@pytest.mark.parametrize("S_,chunk,G,H", [(21, 8, 1, 4), (16, 8, 1, 4),
                                          (21, 8, 2, 4)])
def test_ssd_chunked_matches_jax(S_, chunk, G, H):
    rng = np.random.default_rng(S_ + G)
    B, hd, N = 2, 8, 16
    jxh, txh = bf16_pair(rng, (B, S_, H, hd))
    dt = np.log1p(np.exp(rng.standard_normal((B, S_, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    jB, tB = bf16_pair(rng, (B, S_, G, N))
    jC, tC = bf16_pair(rng, (B, S_, G, N))
    r, rh = JS.ssd_chunked(jxh, jnp.asarray(dt), jnp.asarray(A), jB, jC,
                           chunk)
    g, gh = S.ssd_chunked(txh, torch.from_numpy(dt), torch.from_numpy(A),
                          tB, tC, chunk)
    assert g.dtype == torch.bfloat16 and g.shape == r.shape
    assert np.abs(f32(g) - f32(r)).max() <= ulp_of_max(r)
    assert gh.dtype == torch.float32
    assert_state(gh, rh)


@pytest.fixture(scope="module")
def block():
    jcfg, cfg = jconfigs.get_smoke(ARCH), configs.get_smoke(ARCH)
    jp, tp = module_params(JT.ssm_specs(jcfg), 3, "ssm")
    rng = np.random.default_rng(4)
    jx, tx = bf16_pair(rng, (2, 20, cfg.d_model))     # 20: a ragged chunk
    ref = JS.ssm_block(jp, "ssm", jx, jcfg, return_state=True)
    got = S.ssm_block(tp, "ssm", tx, cfg, return_state=True)
    return jcfg, cfg, jp, tp, rng, ref, got


def test_ssm_block_prefill_matches_jax(block):
    *_, (r, (rh, rt)), (g, (gh, gt)) = block
    assert g.dtype == torch.bfloat16 and g.shape == r.shape
    assert np.abs(f32(g) - f32(r)).max() <= ulp_of_max(r)
    assert_state(gh, rh)
    assert np.array_equal(f32(gt), f32(rt))


def test_ssm_block_decode_matches_jax(block):
    jcfg, cfg, jp, tp, rng, (_, (rh, rt)), _ = block
    jc = JS.SSMCache(rh, rt, jnp.asarray(20, jnp.int32))
    tc = S.SSMCache(torch.from_numpy(np.array(rh)),
                    torch.from_numpy(np.array(f32(rt))).bfloat16(),
                    torch.tensor(20, dtype=torch.int32))
    for step in range(3):
        jx, tx = bf16_pair(rng, (2, 1, cfg.d_model))
        r, jc = JS.ssm_block(jp, "ssm", jx, jcfg, cache=jc)
        g, tc = S.ssm_block(tp, "ssm", tx, cfg, cache=tc)
        assert np.abs(f32(g) - f32(r)).max() <= ulp_of_max(r)
        assert_state(tc.h, jc.h)
        assert np.array_equal(f32(tc.conv), f32(jc.conv))
        assert int(tc.length) == int(jc.length) == 21 + step
