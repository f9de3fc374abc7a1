"""qwen2.5-3b [dense] — 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936 — GQA + QKV bias. [hf:Qwen/Qwen2.5-3B family; hf]"""

from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2,
    d_ff=11008, vocab=151936, head_dim=128,
    qkv_bias=True, rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen2.5-3B config.json; hf-verified",
)

SMOKE = ArchConfig(
    name="qwen2.5-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, head_dim=16, qkv_bias=True,
    source="reduced config, same family",
)
