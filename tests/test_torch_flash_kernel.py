"""The flash-attention kernel's wrapper and — on a machine with a CUDA
GPU — the kernel (`csrc/flash_attention.cu`) against its plain version
`flash_attention_plain`.

This file imports neither JAX nor the JAX package, so it also runs on
the GPU machine, where the kernel tests run instead of skipping:

    PYTHONPATH=src python -m pytest -q tests/test_torch_flash_kernel.py

Tolerance on the bf16 outputs: ``rtol 2⁻⁷, atol 1e-3``.  The plain
version computes in f32 and rounds once to bf16.  The kernel multiplies
bf16 q and k exactly and sums in f32, takes the softmax in f32 online
over 128-key tiles, and feeds p to the bf16 tensor cores as the pair
``p_hi = bf16(p)``, ``p_lo = bf16(p - p_hi)``, summing both products
with V in f32: p keeps 16 significant bits (relative error about 2⁻¹⁷),
and the output rounds once to bf16.  So the two differ by f32 sums in
other orders and that residue of p, and an output may round one bf16
ulp apart (relative at most 2⁻⁷).  ``test_split_p_keeps_the_tolerance``
emulates those rounding points on the CPU, and shows that p in bf16
alone leaves the bound.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)

RTOL, ATOL = 2.0 ** -7, 1e-3


def qkv(B, S, H, KV, hd, seed=0, device="cpu"):
    """bf16 q, k, v drawn with numpy."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(
        (B, S, h, hd)).astype(np.float32)).to(device, torch.bfloat16)
        for h in (H, KV, KV))


# ---- the wrapper's checks (on any device) ------------------------------------

def test_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v = qkv(1, 64, 4, 2, 64)
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError, match="head_dim 24"):
        flash_attention(*qkv(1, 64, 4, 2, 24))
    with pytest.raises(ValueError, match="head_dim 96"):
        flash_attention(*qkv(1, 64, 4, 2, 96))
    with pytest.raises(ValueError, match="blocks"):
        flash_attention(q, k, v, bq=32)
    with pytest.raises(ValueError, match="blocks"):
        flash_attention(q, k, v, bk=64)
    with pytest.raises(ValueError, match="head_dim 32"):
        flash_attention(*qkv(1, 64, 4, 2, 32))
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="KV heads"):
        flash_attention(*qkv(1, 64, 4, 3, 64))
    with pytest.raises(ValueError, match="k/v must be"):
        flash_attention(q, k[:, :32], v[:, :32])
    # a bidirectional call needs S % bk == 0, as the reference
    with pytest.raises(ValueError, match="non-causal flash requires"):
        flash_attention(*qkv(1, 200, 4, 2, 64), causal=False)
    with pytest.raises(ValueError, match="non-causal flash requires"):
        flash_attention_plain(*qkv(1, 200, 4, 2, 64), causal=False)
    # S below the block: the blocks clip to S (no padding), as the reference
    assert flash_attention(*qkv(1, 48, 4, 2, 64), causal=False).shape == \
        (1, 48, 4, 64)


@pytest.mark.parametrize("causal,S", [(True, 70), (False, 64)])
def test_plain_version_is_softmax_attention(causal, S):
    """The plain version (S = 70: the pad path) against a dense softmax
    in float64."""
    H, KV, hd = 4, 2, 32
    q, k, v = qkv(2, S, H, KV, hd, seed=1)
    got = flash_attention_plain(q, k, v, causal=causal, bq=64, bk=64)
    qd, kd, vd = (t.double() for t in (q, k, v))
    kd, vd = (t.repeat_interleave(H // KV, dim=2) for t in (kd, vd))
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) / hd ** 0.5
    if causal:
        s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(),
                          float("-inf"))
    ref = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), vd)
    torch.testing.assert_close(got.double(), ref, rtol=RTOL, atol=ATOL)


def test_wrapper_on_cpu_runs_the_plain_version():
    q, k, v = qkv(2, 130, 8, 2, 128, seed=2)
    before = flash_attention.launches
    assert torch.equal(flash_attention(q, k, v),
                       flash_attention_plain(q, k, v))
    assert flash_attention.launches == before


def emulate_kernel(q, k, v, *, split=True, bn=128):
    """The kernel's rounding points in PyTorch on the CPU (causal, one KV
    head per query head): bf16 operands, f32 scores, an f32 online
    softmax over `bn`-key tiles by exp2 with the scale folded in, p into
    the PV product as ``bf16(p) + bf16(p - bf16(p))`` (`split`) or as
    ``bf16(p)``, the products summed in f32, l from the f32 p."""
    B, S, H, hd = q.shape
    sl = (1.0 / hd ** 0.5) * 1.4426950408889634
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))  # [B,H,S,hd]
    m = torch.full((B, H, S, 1), -1e30)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, hd))
    pos = torch.arange(S)
    for k0 in range(0, S, bn):
        s = qf @ kf[:, :, k0:k0 + bn].transpose(-1, -2)
        s = s.masked_fill(pos[k0:k0 + bn][None, :] > pos[:, None], -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2((m - m_new) * sl)
        p = torch.exp2(s * sl - m_new * sl)
        p_hi = p.bfloat16().float()
        pv = p_hi @ vf[:, :, k0:k0 + bn]
        if split:
            pv = pv + (p - p_hi).bfloat16().float() @ vf[:, :, k0:k0 + bn]
        acc = acc * corr + pv
        l = l * corr + p.sum(-1, keepdim=True)
        m = m_new
    return (acc / l.clamp_min(1e-30)).transpose(1, 2).to(q.dtype)


def test_split_p_keeps_the_tolerance():
    """At the serving head_dim and a 2048-token causal prompt, the split p
    stays within the tolerance of the plain version, and bf16 p alone does
    not: the reason the kernel takes two PV products."""
    q, k, v = qkv(1, 2048, 4, 4, 128, seed=0)
    ref = flash_attention_plain(q, k, v).float()
    split = emulate_kernel(q, k, v).float()
    torch.testing.assert_close(split, ref, rtol=RTOL, atol=ATOL)
    single = emulate_kernel(q, k, v, split=False).float()
    outside = ((single - ref).abs() > ATOL + RTOL * ref.abs()).sum().item()
    assert outside > 0, "bf16 p alone stayed within the tolerance"


def test_build_target_is_keyed_by_the_source(tmp_path, monkeypatch):
    lib = build._target("flash_attention")
    assert lib.name.startswith("libflash_attention_")
    assert lib != build._target("fixpoint")
    # each library is keyed by the headers its source includes ...
    assert [h.name for h in build.headers("flash_attention")] == ["sm90.cuh"]
    for name in ("fixpoint", "search"):
        assert [h.name for h in build.headers(name)] == ["fixpoint_lane.cuh"]
    # ... and a source's own flags reach its libraries only
    assert set(build.SOURCE_FLAGS["flash_attention"]) <= set(
        build._flags("flash_attention", ""))
    for name in ("fixpoint", "search"):
        for variant in ("", "i64"):
            assert build._flags(name, variant) == (build.NVCC_FLAGS
                                                   + build.VARIANTS[variant])
    # an edited header rebuilds its includers and no other library
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in build.CSRC.iterdir():
        (csrc / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {(n, v): build._target(n, v) for n in ("fixpoint", "search")
              for v in ("", "i64")}
    before[("flash_attention", "")] = build._target("flash_attention")
    with open(csrc / "sm90.cuh", "a") as f:
        f.write("// edited\n")
    after = {nv: build._target(*nv) for nv in before}
    assert [nv for nv in before if before[nv] != after[nv]] == [
        ("flash_attention", "")]
    with open(csrc / "fixpoint_lane.cuh", "a") as f:
        f.write("// edited\n")
    again = {nv: build._target(*nv) for nv in before}
    assert [nv for nv in before if again[nv] != after[nv]] == [
        nv for nv in before if nv[0] != "flash_attention"]


# ---- on the card only: the kernel against its plain version -----------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


# (B, S, H, KV, hd, causal, bq, bk): the serving prefill shape, a ragged
# S (the pad path), bidirectional, MQA, head_dim 64 and 16 (the smoke
# configs; S below the blocks), at both q-blocks; then the tiling's edges:
# S = 1 and S = 65 (a q-block or a warpgroup of 64 rows past S, a KV tile
# mostly past S) at both q-blocks, head_dim 16 bidirectional at S = 128,
# and MQA at head_dim 64
CARD_CASES = [
    (4, 2048, 32, 8, 128, True, 128, 128),
    (4, 2048, 32, 8, 128, True, 64, 128),
    (2, 1000, 32, 8, 128, True, 128, 128),
    (2, 512, 32, 8, 128, False, 64, 128),
    (2, 1024, 32, 1, 128, True, 128, 128),
    (2, 1024, 16, 4, 64, True, 64, 128),
    (2, 100, 4, 2, 16, True, 128, 128),
    (1, 96, 4, 2, 16, False, 128, 128),
    (1, 1, 4, 2, 128, True, 128, 128),
    (1, 1, 4, 2, 128, True, 64, 128),
    (2, 65, 8, 2, 128, True, 128, 128),
    (2, 65, 8, 2, 128, True, 64, 128),
    (2, 128, 4, 2, 16, False, 64, 128),
    (2, 1024, 16, 1, 64, True, 128, 128),
]


@pytest.mark.parametrize("B,S,H,KV,hd,causal,bq,bk", CARD_CASES)
def test_kernel_matches_plain(cuda, B, S, H, KV, hd, causal, bq, bk):
    q, k, v = qkv(B, S, H, KV, hd, seed=S + hd, device=cuda)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, bq=bq, bk=bk)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = flash_attention_plain(q, k, v, causal=causal, bq=bq, bk=bk)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(got.float(), ref.float(), rtol=RTOL, atol=ATOL)
