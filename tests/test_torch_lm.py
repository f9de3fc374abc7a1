"""The port's LM serving path (`repro_torch.nn`, `train/serve_step.py`,
`launch/serve.py`) against the JAX package, on the CPU at the smoke
configs.

Inputs are drawn with numpy from fixed seeds and handed to both
packages; the reference's params are carried over with
`params_from_numpy`.  Each comparison states its tolerance:

* `flash_attention_plain` against JAX `flash_attention` (interpret
  mode): ``rtol 2⁻⁷, atol 1e-3`` on the bf16 outputs — both compute in
  f32 and round once, so they differ by at most about one bf16 ulp
  (relative 2⁻⁸…2⁻⁷) where their f32 sums round apart.
* `blocked_attention` against JAX's: ``atol 3e-2``, the bound the JAX
  package holds its own two attentions to
  (``tests/test_flash_attention.py``).
* `rms_norm`, `apply_rope`, `swiglu`, `dense`: one bf16 ulp of the
  larger magnitude — the same f32 arithmetic, summed in another order.
* Prefill logits and primed caches, and teacher-forced decode steps:
  ``0.08 · max|ref|``, the bound of the JAX package's own decode check
  (``tests/test_archs.py``); the port's prefill attention is the flash
  function, the reference's the blocked one.
"""

import subprocess
import sys
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels.flash_attention import flash_attention as jflash
from repro.nn import attention as JA
from repro.nn import layers as JL
from repro.nn import model as JM
from repro_torch import configs
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.nn import attention as A
from repro_torch.nn import layers as L
from repro_torch.nn import model as M
from repro_torch.train.serve_step import generate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("qwen3-4b", "llama3-8b", "qwen2.5-3b")
DECODE_TOL = 0.08                 # × max|ref logit|, as tests/test_archs.py
FLASH_RTOL, FLASH_ATOL = 2.0 ** -7, 1e-3

torch.set_num_threads(1)


def bf16_pair(rng, shape, scale=1.0):
    """The same bf16 values for both packages (rounded from f32 once)."""
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return (jnp.asarray(a).astype(jnp.bfloat16),
            torch.from_numpy(a).to(torch.bfloat16))


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_ulp(got, ref, ulps=1):
    """|got - ref| ≤ `ulps` bf16 ulps of max(|got|, |ref|) elementwise."""
    got, ref = f32(got), f32(ref)
    mag = np.maximum(np.abs(got), np.abs(ref))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    bad = np.abs(got - ref) > ulps * ulp
    assert not bad.any(), (int(bad.sum()), float(np.abs(got - ref).max()))


def jax_params(cfg_id, seed=0, perturb=True):
    """The reference's smoke params (numpy) with, given `perturb`, random
    norm scales and biases (their init is all ones/zeros)."""
    jcfg = jconfigs.get_smoke(cfg_id)
    p = {k: np.array(v) for k, v in
         JL.init_params(JM.param_specs(jcfg), jax.random.PRNGKey(seed)).items()}
    rng = np.random.default_rng(seed)
    if perturb:
        for k in p:
            if L.storage_dtype(k) == torch.float32:
                p[k] = (p[k] + rng.normal(0, 0.1, p[k].shape)
                        ).astype(np.float32)
    return jcfg, p


# ---- flash attention --------------------------------------------------------

FLASH_CASES = [
    (2, 64, 4, 4, 16, 16, 16, True),
    (1, 64, 4, 2, 32, 32, 16, True),     # GQA
    (2, 64, 2, 1, 16, 16, 32, True),     # MQA
    (1, 64, 2, 2, 16, 64, 64, False),    # single block, bidirectional
    (1, 48, 2, 2, 16, 16, 16, True),     # ragged-pad path
    (1, 80, 4, 2, 128, 32, 32, True),    # head_dim 128, ragged
]


@pytest.mark.parametrize("B,S,H,KV,hd,bq,bk,causal", FLASH_CASES)
def test_flash_plain_matches_jax_flash(B, S, H, KV, hd, bq, bk, causal):
    rng = np.random.default_rng(S + H + hd)
    jq, tq = bf16_pair(rng, (B, S, H, hd))
    jk, tk = bf16_pair(rng, (B, S, KV, hd))
    jv, tv = bf16_pair(rng, (B, S, KV, hd))
    ref = jflash(jq, jk, jv, causal=causal, bq=bq, bk=bk, interpret=True)
    got = flash_attention_plain(tq, tk, tv, causal=causal, bq=bq, bk=bk)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, H, hd)
    np.testing.assert_allclose(f32(got), f32(ref), rtol=FLASH_RTOL,
                               atol=FLASH_ATOL)


def test_flash_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(7)
    _, q = bf16_pair(rng, (2, 100, 4, 64))
    _, k = bf16_pair(rng, (2, 100, 2, 64))
    _, v = bf16_pair(rng, (2, 100, 2, 64))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=True, bq=64, bk=128)
    assert torch.equal(got, flash_attention_plain(q, k, v, causal=True,
                                                  bq=64, bk=128))
    assert flash_attention.launches == before


# ---- blocked attention -------------------------------------------------------

@pytest.mark.parametrize("Sq,Sk,qc,kc,causal,window,kv_len", [
    (8, 8, 4, 4, True, 0, None),
    (8, 8, 3, 5, True, 0, None),         # ragged chunks
    (8, 8, 8, 8, False, 0, None),
    (16, 16, 4, 4, True, 6, None),       # sliding window
    (1, 12, 1, 4, True, 0, 7),           # decode: valid prefix of 7
    (2, 24, 1, 8, True, 0, 13),          # two decode positions, ragged
])
def test_blocked_attention_matches_jax(Sq, Sk, qc, kc, causal, window,
                                       kv_len):
    rng = np.random.default_rng(Sq * 31 + Sk)
    B, H, KV, hd = 2, 4, 2, 8
    jq, tq = bf16_pair(rng, (B, Sq, H, hd))
    jk, tk = bf16_pair(rng, (B, Sk, KV, hd))
    jv, tv = bf16_pair(rng, (B, Sk, KV, hd))
    end = kv_len if kv_len is not None else Sk
    q_pos = np.arange(end - Sq, end, dtype=np.int32)
    kv_pos = np.arange(Sk, dtype=np.int32)
    ref = JA.blocked_attention(
        jq, jk, jv, jnp.asarray(q_pos), jnp.asarray(kv_pos), causal=causal,
        window=window, q_chunk=qc, kv_chunk=kc,
        kv_len=None if kv_len is None else jnp.asarray(kv_len, jnp.int32))
    got = A.blocked_attention(
        tq, tk, tv, torch.from_numpy(q_pos), torch.from_numpy(kv_pos),
        causal=causal, window=window, q_chunk=qc, kv_chunk=kc,
        kv_len=None if kv_len is None else torch.tensor(kv_len,
                                                        dtype=torch.int32))
    assert got.dtype == torch.bfloat16 and got.shape == (B, Sq, H, hd)
    np.testing.assert_allclose(f32(got), f32(ref), atol=3e-2)


# ---- layers --------------------------------------------------------------------

def test_rms_norm_rope_match_jax():
    rng = np.random.default_rng(1)
    jx, tx = bf16_pair(rng, (3, 10, 4, 16), scale=3.0)
    g = (1 + rng.normal(0, 0.2, 16)).astype(np.float32)
    assert_ulp(L.rms_norm(tx, torch.from_numpy(g), 1e-6),
               JL.rms_norm(jx, jnp.asarray(g), 1e-6))
    pos = np.arange(5, 15, dtype=np.int32)
    ref = jax.vmap(lambda a: JL.apply_rope(a, jnp.asarray(pos), 1e6))(jx)
    assert_ulp(L.apply_rope(tx, torch.from_numpy(pos), 1e6, seq_axis=1), ref)
    assert_ulp(L.apply_rope(tx[0], torch.from_numpy(pos), 1e6),
               JL.apply_rope(jx[0], jnp.asarray(pos), 1e6))


@pytest.mark.parametrize("with_bias", [False, True])
def test_dense_swiglu_match_jax(with_bias):
    rng = np.random.default_rng(2 + with_bias)
    jx, tx = bf16_pair(rng, (2, 7, 64))
    w = [(rng.standard_normal(s) / 8).astype(np.float32)
         for s in ((64, 96), (64, 96), (96, 64))]
    b = rng.standard_normal(96).astype(np.float32) if with_bias else None
    tw = [L.cast_bf16(torch.from_numpy(a)) for a in w]
    assert_ulp(L.dense(tx, tw[0], None if b is None else torch.from_numpy(b)),
               JL.dense(jx, jnp.asarray(w[0]),
                        None if b is None else jnp.asarray(b)))
    assert_ulp(L.swiglu(tx, *tw), JL.swiglu(jx, *map(jnp.asarray, w)))


def test_param_specs_and_init_match_jax():
    for arch in ARCHS:
        cfg, jcfg = configs.get(arch), jconfigs.get(arch)
        got, ref = M.param_specs(cfg), JM.param_specs(jcfg)
        assert {k: (v.shape, v.axes, v.init) for k, v in got.items()} == \
            {k: (v.shape, v.axes, v.init) for k, v in ref.items()}
        assert cfg.n_params() == jcfg.n_params()
    assert configs.get("qwen3-4b").n_params() == 4_411_424_256
    for arch in ARCHS:
        got = M.init_cache(configs.get_smoke(arch), 2, 24)["blocks"]
        ref = JM.init_cache(jconfigs.get_smoke(arch), 2, 24)["blocks"]
        assert got.k.shape == got.v.shape == ref.k.shape
        assert got.k.dtype == torch.bfloat16 and not got.k.any()
        assert got.length.tolist() == np.asarray(ref.length).tolist()
    cfg = configs.get_smoke("qwen2.5-3b")
    p = L.init_params(M.param_specs(cfg), torch.Generator().manual_seed(0),
                      "cpu")
    assert p["blocks/attn/wq"].dtype == torch.bfloat16
    assert p["blocks/attn/wq_b"].dtype == torch.float32
    assert p["blocks/norm1"].dtype == torch.float32
    std = p["blocks/ffn/w_down"].float().std().item()
    assert abs(std - 1 / np.sqrt(cfg.d_ff)) < 0.1 / np.sqrt(cfg.d_ff)
    assert abs(p["embed/tok"].float().std().item() - 0.02) < 0.002


# ---- the model: prefill and decode against the reference -----------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    jcfg, npp = jax_params(arch)
    cfg = configs.get_smoke(arch)
    jp = {k: jnp.asarray(v) for k, v in npp.items()}
    tp = L.params_from_numpy(npp, "cpu")
    rng = np.random.default_rng(11)
    B, S, smax = 2, 12, 24
    tok = rng.integers(0, cfg.vocab, (B, S))
    jl, jc = JM.forward_prefill(jp, jcfg, {"tokens": jnp.asarray(tok)},
                                smax=smax, chunks=(8, 8))
    before = flash_attention.launches
    tl, tc = M.forward_prefill(tp, cfg, {"tokens": torch.from_numpy(tok)},
                               smax=smax)
    assert flash_attention.launches == before       # the CPU: plain version
    ref = f32(jl)
    assert tl.dtype == torch.float32 and tl.shape == (B, cfg.vocab)
    assert np.abs(tl.numpy() - ref).max() < DECODE_TOL * np.abs(ref).max()
    for name in ("k", "v"):
        r, g = f32(getattr(jc["blocks"], name)), f32(getattr(tc["blocks"],
                                                             name))
        assert g.shape == r.shape == (cfg.n_layers, B, smax, cfg.n_kv_heads,
                                      cfg.hd)
        assert np.abs(g - r).max() < DECODE_TOL * np.abs(r).max()
        assert not g[:, :, S:].any()
    assert tc["blocks"].length.tolist() == np.asarray(jc["blocks"].length
                                                      ).tolist()
    for _ in range(4):                               # teacher-forced steps
        nt = rng.integers(0, cfg.vocab, (B, 1))
        jl, jc = JM.forward_decode(jp, jcfg, jnp.asarray(nt), jc,
                                   chunks=(1, 8))
        tl, tc = M.forward_decode(tp, cfg, torch.from_numpy(nt), tc,
                                  chunks=(1, 8))
        ref = f32(jl)
        assert np.abs(tl.numpy() - ref).max() < DECODE_TOL * np.abs(ref).max()
    assert int(M._cache_length(cfg, tc)) == S + 4


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing(arch):
    """Prefill on S-1 tokens then decode token S-1 against a prefill on
    all S tokens (the pattern of tests/test_archs.py)."""
    cfg = configs.get_smoke(arch)
    _, npp = jax_params(arch, seed=3)
    p = L.params_from_numpy(npp, "cpu")
    tok = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 16)))
    full, _ = M.forward_prefill(p, cfg, {"tokens": tok}, smax=32)
    _, caches = M.forward_prefill(p, cfg, {"tokens": tok[:, :15]}, smax=32)
    dec, caches = M.forward_decode(p, cfg, tok[:, 15:], caches)
    scale = max(full.abs().max().item(), 1.0)
    assert (dec - full).abs().max().item() < DECODE_TOL * scale
    assert caches["blocks"].length.tolist() == [16] * cfg.n_layers


def test_generate_greedy_matches_jax():
    jcfg, npp = jax_params("qwen3-4b", seed=4)
    cfg = configs.get_smoke("qwen3-4b")
    from repro.train.serve_step import generate as jgenerate
    tok = np.random.default_rng(9).integers(0, cfg.vocab, (2, 10))
    ref = jgenerate({k: jnp.asarray(v) for k, v in npp.items()}, jcfg,
                    {"tokens": jnp.asarray(tok)}, steps=4, smax=20,
                    chunks=(8, 8))
    stats = {}
    got = generate(L.params_from_numpy(npp, "cpu"), cfg,
                   {"tokens": torch.from_numpy(tok)}, steps=4, smax=20,
                   stats=stats)
    assert got.dtype == torch.int32 and got.shape == (2, 4)
    # greedy: the first token is the argmax of logits that agree within
    # the decode bound; the random smoke weights leave wide margins here
    assert got[:, 0].tolist() == np.asarray(ref)[:, 0].tolist()
    assert set(stats) == {"prefill_s", "decode_s"}
    sampled = generate(L.params_from_numpy(npp, "cpu"), cfg,
                       {"tokens": torch.from_numpy(tok)}, steps=4, smax=20,
                       temperature=1.0, seed=1)
    assert ((sampled >= 0) & (sampled < cfg.vocab)).all()


def test_serve_cli_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--prompt-len", "8", "--gen", "3"],
        capture_output=True, text=True, env=env, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "arch=qwen3-smoke device=cpu generated (4, 3)" in out.stdout
    assert "flash_attention launches 0" in out.stdout


def test_serve_cli_never_moves_to_the_cpu(monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        serve.main(["--smoke"])


# ---- what the port does not run raises ----------------------------------------

def test_unported_paths_raise():
    """Every architecture id of the reference resolves to its config (the
    MoE, MLA, SSM, RG-LRU, encoder-decoder and ViT-stub ones too); an
    unknown id raises `KeyError`, and a head_dim the flash kernel does not
    take raises rather than falling back."""
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    for arch in jconfigs.ARCH_IDS:
        assert configs.get(arch).name == jconfigs.get(arch).name
        assert configs.get_smoke(arch).name == jconfigs.get_smoke(arch).name
    for get in (configs.get, configs.get_smoke):
        with pytest.raises(KeyError):
            get("gpt-2")
    cfg = configs.get_smoke("qwen3-4b")
    # head_dim 24: the flash kernel takes 16, 32, 64 or 128
    odd = ArchConfig(**{**cfg.__dict__, "head_dim": 24})
    p = L.init_params(M.param_specs(odd), torch.Generator().manual_seed(0),
                      "cpu")
    with pytest.raises(ValueError, match="head_dim 24"):
        M.forward_prefill(p, odd, {"tokens": torch.zeros((1, 4), dtype=int)},
                          smax=8)

