"""pixtral-12b [vlm] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072 — pixtral-ViT frontend (STUB: input_specs provides patch
embeddings) + mistral-nemo decoder.
[hf:mistralai/Pixtral-12B-2409; unverified]"""

from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=131072, head_dim=128,
    rope_theta=1_000_000.0,
    frontend="vit_stub", frontend_tokens=1024,
    source="hf:mistralai/Pixtral-12B-2409 config.json; unverified",
)

SMOKE = ArchConfig(
    name="pixtral-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, head_dim=16,
    frontend="vit_stub", frontend_tokens=8,
    source="reduced config, same family",
)
