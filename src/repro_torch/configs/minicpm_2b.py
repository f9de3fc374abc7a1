"""minicpm-2b [dense] — 40L d_model=2304 36H (MHA kv=36) d_ff=5760
vocab=122753 — WSD learning-rate schedule (train/optimizer.py),
llama-like arch, tied embeddings. [arXiv:2404.06395; hf]"""

from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36,
    d_ff=5760, vocab=122753, head_dim=64,
    tie_embeddings=True, rope_theta=10_000.0,
    source="arXiv:2404.06395 + hf:openbmb/MiniCPM-2B; hf-verified",
)

SMOKE = ArchConfig(
    name="minicpm-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, head_dim=16, tie_embeddings=True,
    source="reduced config, same family",
)
