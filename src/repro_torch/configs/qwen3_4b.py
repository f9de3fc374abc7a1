"""qwen3-4b [dense] — 36L d_model=2560 32H (GQA kv=8) d_ff=9728
vocab=151936 — qk_norm. [hf:Qwen/Qwen3-4B family; hf]"""

from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=9728, vocab=151936, head_dim=128,
    qk_norm=True, rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-4B config.json; hf-verified",
)

SMOKE = ArchConfig(
    name="qwen3-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, head_dim=16, qk_norm=True,
    source="reduced config, same family",
)
