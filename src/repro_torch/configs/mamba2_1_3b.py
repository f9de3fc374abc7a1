"""mamba2-1.3b [ssm] — 48L d_model=2048 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality). [arXiv:2405.21060; unverified]

d_inner = 2·d_model = 4096, 64 heads × head_dim 64, n_groups=1.
Runs long_500k: O(1) recurrent decode state.
"""

from repro_torch.configs.base import ArchConfig, SSMConfig

FULL = ArchConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=50280,
    ssm=SSMConfig(state=128, head_dim=64, expand=2, conv=4, n_groups=1,
                  chunk=256),
    source="arXiv:2405.21060 + hf:state-spaces/mamba2-1.3b; unverified",
)

SMOKE = ArchConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=256,
    ssm=SSMConfig(state=16, head_dim=16, expand=2, conv=4, n_groups=1,
                  chunk=8),
    source="reduced config, same family",
)
