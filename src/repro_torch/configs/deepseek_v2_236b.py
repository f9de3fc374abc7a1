"""deepseek-v2-236b [moe] — 60L d_model=5120 128H d_ff(expert)=1536
vocab=102400, MoE 160e top-6 (+2 shared), MLA kv_lora=512.
[arXiv:2405.04434; hf]"""

from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

FULL = ArchConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=1536, vocab=102400, head_dim=128,
    rope_theta=10_000.0,
    moe=MoEConfig(n_experts=160, top_k=6, d_expert=1536, n_shared=2,
                  first_dense=1, d_ff_dense=12288),
    mla=MLAConfig(kv_lora=512, q_lora=1536, rope_dim=64, nope_dim=128,
                  v_dim=128),
    source="arXiv:2405.04434 (table 1 + HF config); hf-verified",
)

SMOKE = ArchConfig(
    name="deepseek-v2-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=32, vocab=256, head_dim=16,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=32, n_shared=1,
                  first_dense=1, d_ff_dense=128),
    mla=MLAConfig(kv_lora=32, q_lora=48, rope_dim=8, nope_dim=16, v_dim=16),
    source="reduced config, same family",
)
