"""The port's RG-LRU block (`repro_torch.nn.rglru`) and the windowed
ring-buffer KV cache (`repro_torch.nn.attention.gqa_attention` with
``window > 0``, `repro_torch.nn.model._place_ring`) against the JAX
package, on the CPU at the recurrentgemma smoke config.

Inputs are drawn with numpy from fixed seeds; the reference's params
(its spec functions, `init_params`, every f32 leaf perturbed) are
carried over with `params_from_numpy`.  Tolerances:

* `_rglru_scan` (f32): ``|Δh| ≤ 2⁻²⁰ · max|ref|``.  The port scans by
  recursive doubling, the reference by ``lax.associative_scan``: the
  same operator over another tree, so the products round apart.
* `rglru_step` (f32): ``|Δh| ≤ 2⁻²² · max|ref|`` (the same formula;
  ``log_sigmoid`` and ``exp`` may differ in their last bit).
* `recurrent_block` prefill and decode: the output (bf16) within one
  bf16 ulp of max|ref| (exactly equal here), the state as `rglru_step`'s
  bound, the conv tail exactly equal.
* `_place_ring` slots and the ring's contents: exactly equal.
* The windowed `gqa_attention` (prefill past the window, then decode
  steps that wrap the ring): the output within one bf16 ulp of max|ref|
  (the attention's online softmax runs over other chunks than the
  reference's here), the cache's keys, values and length exactly equal.
  On the ring's first lap (a 9-token prompt, 6 steps, 16 slots) the
  port departs from the reference's windowed decode, which attends to
  the slots never written (ROADMAP "Reference notes"): there it is held,
  at the same bound, to the reference's unwindowed decode over the same
  keys, and to plain causal attention over the written keys exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.nn import attention as JA
from repro.nn import model as JM
from repro.nn import rglru as JR
from repro.nn import transformer as JT
from repro_torch import configs
from repro_torch.nn import attention as A
from repro_torch.nn import layers as L
from repro_torch.nn import model as M
from repro_torch.nn import rglru as R
from test_torch_lm import bf16_pair, f32
from test_torch_moe import module_params, ulp_of_max

torch.set_num_threads(1)
ARCH = "recurrentgemma-2b"


def assert_close_f32(got, ref, rel):
    r = f32(ref)
    assert np.abs(f32(got) - r).max() <= rel * np.abs(r).max()


def gates(rng, shape):
    return (1 / (1 + np.exp(-rng.standard_normal(shape)))).astype(np.float32)


@pytest.mark.parametrize("S_", [1, 7, 40, 129])
def test_rglru_scan_matches_jax(S_):
    rng = np.random.default_rng(S_)
    W = 64
    x = rng.standard_normal((2, S_, W)).astype(np.float32)
    r, i = gates(rng, (2, S_, W)), gates(rng, (2, S_, W))
    a = (rng.standard_normal(W) + 1).astype(np.float32)
    ref, rl = JR._rglru_scan(*map(jnp.asarray, (x, r, i, a)), 8.0)
    got, gl = R._rglru_scan(*map(torch.from_numpy, (x, r, i, a)), 8.0)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert_close_f32(got, ref, 2.0 ** -20)
    assert_close_f32(gl, rl, 2.0 ** -20)


def test_rglru_step_matches_jax():
    rng = np.random.default_rng(1)
    W = 64
    x = rng.standard_normal((2, W)).astype(np.float32)
    r, i = gates(rng, (2, W)), gates(rng, (2, W))
    a = (rng.standard_normal(W) + 1).astype(np.float32)
    h = rng.standard_normal((2, W)).astype(np.float32)
    ref, _ = JR.rglru_step(*map(jnp.asarray, (x, r, i, a)), 8.0,
                           jnp.asarray(h))
    got, _ = R.rglru_step(*map(torch.from_numpy, (x, r, i, a)), 8.0,
                          torch.from_numpy(h))
    assert_close_f32(got, ref, 2.0 ** -22)


@pytest.fixture(scope="module")
def block():
    jcfg, cfg = jconfigs.get_smoke(ARCH), configs.get_smoke(ARCH)
    jp, tp = module_params(JT.rglru_specs(jcfg), 4, "rec")
    rng = np.random.default_rng(5)
    jx, tx = bf16_pair(rng, (2, 20, cfg.d_model))
    ref = JR.recurrent_block(jp, "rec", jx, jcfg, return_state=True)
    got = R.recurrent_block(tp, "rec", tx, cfg, return_state=True)
    return jcfg, cfg, jp, tp, rng, ref, got


def test_recurrent_block_prefill_matches_jax(block):
    *_, (r, (rh, rt)), (g, (gh, gt)) = block
    assert g.dtype == torch.bfloat16 and g.shape == r.shape
    assert np.abs(f32(g) - f32(r)).max() <= ulp_of_max(r)
    assert_close_f32(gh, rh, 2.0 ** -22)
    assert np.array_equal(f32(gt), f32(rt))


def test_recurrent_block_decode_matches_jax(block):
    jcfg, cfg, jp, tp, rng, (_, (rh, rt)), _ = block
    jc = JR.RGLRUCache(rh, rt, jnp.asarray(20, jnp.int32))
    tc = R.RGLRUCache(torch.from_numpy(np.array(rh)),
                      torch.from_numpy(np.array(f32(rt))).bfloat16(),
                      torch.tensor(20, dtype=torch.int32))
    for step in range(3):
        jx, tx = bf16_pair(rng, (2, 1, cfg.d_model))
        r, jc = JR.recurrent_block(jp, "rec", jx, jcfg, cache=jc)
        g, tc = R.recurrent_block(tp, "rec", tx, cfg, cache=tc)
        assert np.abs(f32(g) - f32(r)).max() <= ulp_of_max(r)
        assert_close_f32(tc.h, jc.h, 2.0 ** -22)
        assert np.array_equal(f32(tc.conv), f32(jc.conv))
        assert int(tc.length) == int(jc.length) == 21 + step


# ---- the windowed ring-buffer cache ---------------------------------------------

@pytest.mark.parametrize("S_,W", [(5, 8), (8, 8), (13, 8), (20, 16),
                                  (37, 16)])
def test_place_ring_matches_jax(S_, W):
    arr = np.arange(2 * S_ * 3, dtype=np.float32).reshape(2, S_, 3) + 1
    ref = np.asarray(JM._place_ring(jnp.asarray(arr), W))
    got = M._place_ring(torch.from_numpy(arr), W)
    assert np.array_equal(got.numpy(), ref)
    stacked = M._place_ring(torch.from_numpy(np.stack([arr, -arr])), W,
                            seq_axis=2)
    assert np.array_equal(stacked.numpy(), np.stack([ref, -ref]))


@pytest.mark.parametrize("S_", [20, 9])
def test_windowed_gqa_attention_matches_jax(S_):
    """Prefill of S_ tokens with window 16 (past it at 20), its ring
    primed with `_place_ring`, then 6 decode steps (that wrap the ring at
    20; at 9 all on its first lap, where the reference's unwindowed
    decode over a 16-slot cache is the reference)."""
    jcfg, cfg = jconfigs.get_smoke(ARCH), configs.get_smoke(ARCH)
    window = cfg.rglru.window
    first_lap = S_ + 6 <= window
    jwindow = 0 if first_lap else window
    jplace = JM._pad_prefix if first_lap else JM._place_ring
    jp, tp = module_params(JT.gqa_specs(jcfg), 6, "attn")
    rng = np.random.default_rng(S_)
    jx, tx = bf16_pair(rng, (2, S_, cfg.d_model))
    pos = np.arange(S_, dtype=np.int32)
    r, (rk, rv) = JA.gqa_attention(jp, "attn", jx, jcfg, jnp.asarray(pos),
                                   window=window, return_kv=True,
                                   q_chunk=8, kv_chunk=8)
    g, (gk, gv) = A.gqa_attention(tp, "attn", tx, cfg, torch.from_numpy(pos),
                                  window=window, return_kv=True)
    assert np.abs(f32(g) - f32(r)).max() <= ulp_of_max(r)
    assert np.array_equal(f32(gk), f32(rk)) and np.array_equal(f32(gv),
                                                                f32(rv))
    jc = JA.KVCache(jplace(rk, window), jplace(rv, window),
                    jnp.asarray(S_, jnp.int32))
    tc = A.KVCache(M._place_ring(gk, window), M._place_ring(gv, window),
                   torch.tensor(S_, dtype=torch.int32))
    for step in range(6):
        jx, tx = bf16_pair(rng, (2, 1, cfg.d_model))
        p = np.array([S_ + step], np.int32)
        r, jc = JA.gqa_attention(jp, "attn", jx, jcfg, jnp.asarray(p),
                                 window=jwindow, cache=jc, q_chunk=1,
                                 kv_chunk=8)
        g, tc = A.gqa_attention(tp, "attn", tx, cfg, torch.from_numpy(p),
                                window=window, cache=tc, q_chunk=1,
                                kv_chunk=8)
        assert np.abs(f32(g) - f32(r)).max() <= ulp_of_max(r)
        assert np.array_equal(f32(tc.k), f32(jc.k))
        assert np.array_equal(f32(tc.v), f32(jc.v))
        assert int(tc.length) == int(jc.length) == S_ + step + 1


def test_windowed_decode_on_the_first_lap_attends_to_the_written_keys():
    """On the ring's first lap (9 keys in 16 slots, then one decode step)
    the windowed decode gives the slots never written no weight: it
    equals plain causal attention over the 10 written keys
    (`blocked_attention` with no cache) and the unwindowed decode over
    the same keys, exactly.  The reference's windowed decode attends to
    the 6 unwritten slots too (their positions are negative, inside the
    window) and departs from both by more than 5 % of max|out|."""
    jcfg, cfg = jconfigs.get_smoke(ARCH), configs.get_smoke(ARCH)
    W, S_ = cfg.rglru.window, 9
    jp, tp = module_params(JT.gqa_specs(jcfg), 7, "attn")
    rng = np.random.default_rng(7)
    jx, tx = bf16_pair(rng, (2, S_, cfg.d_model))
    jx1, tx1 = bf16_pair(rng, (2, 1, cfg.d_model))
    pos = np.arange(S_, dtype=np.int32)
    _, (k, v) = A.gqa_attention(tp, "attn", tx, cfg, torch.from_numpy(pos),
                                window=W, return_kv=True)
    step = torch.tensor([S_], dtype=torch.int32)
    length = torch.tensor(S_, dtype=torch.int32)
    got = {}
    for window, place in ((W, lambda a: M._place_ring(a, W)),
                          (0, lambda a: M._pad_prefix(a, W))):
        cache = A.KVCache(place(k), place(v), length)
        got[window], cache = A.gqa_attention(tp, "attn", tx1, cfg, step,
                                             window=window, cache=cache)
    assert torch.equal(got[W], got[0])
    # plain causal attention of the new token over the 10 written keys
    q1, k1, v1 = A.gqa_project_qkv(tp, "attn", tx1, cfg)
    q1 = L.apply_rope(q1, step, cfg.rope_theta, seq_axis=1)
    k1 = L.apply_rope(k1, step, cfg.rope_theta, seq_axis=1)
    keys = torch.arange(S_ + 1, dtype=torch.int32)
    o = A.blocked_attention(q1, torch.cat([k, k1], 1), torch.cat([v, v1], 1),
                            step, keys, causal=True, kv_len=S_ + 1)
    plain = L.dense(o.reshape(2, 1, -1), tp["attn/wo"])
    assert torch.equal(got[W], plain)
    jk, jv = (jnp.asarray(np.array(f32(M._place_ring(t, W))), jnp.bfloat16)
              for t in (k, v))
    ref, _ = JA.gqa_attention(jp, "attn", jx1, jcfg,
                              jnp.asarray([S_], jnp.int32), window=W,
                              cache=JA.KVCache(jk, jv, jnp.asarray(
                                  S_, jnp.int32)))
    gap = np.abs(f32(ref) - f32(got[W])).max()
    assert gap > 0.05 * np.abs(f32(got[W])).max()
