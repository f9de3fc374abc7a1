"""seamless-m4t-large-v2 [audio] — enc-dec 24L+24L d_model=1024 16H
(MHA kv=16) d_ff=8192 vocab=256206 — multimodal; the w2v-BERT audio
frontend is a STUB (input_specs provides precomputed frame embeddings).
[arXiv:2308.11596; hf]"""

from repro_torch.configs.base import ArchConfig, EncDecConfig

FULL = ArchConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=48, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=256206, head_dim=64,
    rope_theta=10_000.0,
    encdec=EncDecConfig(enc_layers=24, dec_layers=24),
    frontend="audio_stub", frontend_tokens=1024,
    source="arXiv:2308.11596 + hf:facebook/seamless-m4t-v2-large; hf",
)

SMOKE = ArchConfig(
    name="seamless-smoke", family="audio",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, head_dim=16,
    encdec=EncDecConfig(enc_layers=2, dec_layers=2),
    frontend="audio_stub", frontend_tokens=8,
    source="reduced config, same family",
)
