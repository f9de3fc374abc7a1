"""recurrentgemma-2b [hybrid] — 26L d_model=2560 10H (MQA kv=1)
d_ff=7680 vocab=256000 — RG-LRU + local attention, pattern
(rec, rec, attn), window 2048. [arXiv:2402.19427; hf]

26 layers = 8 full (rec,rec,attn) periods + 2 trailing rec layers.
Runs long_500k: bounded state (LRU hidden + 2048-token attention ring).
"""

from repro_torch.configs.base import ArchConfig, RGLRUConfig

FULL = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab=256000, head_dim=256,
    tie_embeddings=True,          # gemma family ties embeddings
    rope_theta=10_000.0,
    rglru=RGLRUConfig(pattern=("rec", "rec", "attn"), window=2048,
                      lru_width=2560, conv=4),
    source="arXiv:2402.19427 (griffin 2b table) + hf config; hf-verified",
)

SMOKE = ArchConfig(
    name="recurrentgemma-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=1,
    d_ff=128, vocab=256, head_dim=16,
    rglru=RGLRUConfig(pattern=("rec", "rec", "attn"), window=16,
                      lru_width=64, conv=4),
    source="reduced config, same family (1 period + 1 rec tail)",
)
