"""The flash-attention kernel's wrapper and — on a machine with a CUDA
GPU — the kernel (`csrc/flash_attention.cu`) against its plain version
`flash_attention_plain`.

This file imports neither JAX nor the JAX package, so it also runs on
the GPU machine, where the kernel tests run instead of skipping:

    PYTHONPATH=src python -m pytest -q tests/test_torch_flash_kernel.py

Tolerance on the bf16 outputs: ``rtol 2⁻⁷, atol 1e-3``.  Both versions
compute in f32 and round once to bf16; their f32 sums run in other
orders, so an output may round one bf16 ulp apart (relative at most
2⁻⁷).
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


def test_build_target_is_keyed_by_the_source():
    lib = build._target("flash_attention")
    assert lib.name.startswith("libflash_attention_")
    assert lib != build._target("fixpoint")


# ---- on the card only: the kernel against its plain version -----------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


# (B, S, H, KV, hd, causal, bq, bk): the serving prefill shape, a ragged
# S (the pad path), bidirectional, MQA, head_dim 64 and 16 (the smoke
# configs; S below the blocks), at both q-blocks
CARD_CASES = [
    (4, 2048, 32, 8, 128, True, 128, 128),
    (4, 2048, 32, 8, 128, True, 64, 128),
    (2, 1000, 32, 8, 128, True, 128, 128),
    (2, 512, 32, 8, 128, False, 64, 128),
    (2, 1024, 32, 1, 128, True, 128, 128),
    (2, 1024, 16, 4, 64, True, 64, 128),
    (2, 100, 4, 2, 16, True, 128, 128),
    (1, 96, 4, 2, 16, False, 128, 128),
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
