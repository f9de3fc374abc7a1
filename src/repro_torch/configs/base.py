"""Architecture configuration (the port's copy of ``repro/configs/base.py``).

One `ArchConfig` per architecture, with exact numbers from the public
sources cited in each config file, plus a ``SMOKE`` reduction of the
same family for CPU tests.  The sub-configs of the other families (MoE,
MLA, SSM, RG-LRU, encoder-decoder) are kept so that the fields of
`ArchConfig` mean what they mean in the reference; the port runs only
the dense GQA family (``nn/model.py``).  The reference's `ShapeConfig`
table belongs to its dry-run, which the port does not have.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN inner dim
    n_shared: int = 0             # shared (always-on) experts
    router_dtype: str = "float32"
    capacity_factor: float = 1.25
    first_dense: int = 0          # leading dense layers (deepseek style)
    d_ff_dense: int = 0           # FFN width of those dense layers


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora: int = 512
    q_lora: int = 1536
    rope_dim: int = 64
    nope_dim: int = 128
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:                  # mamba2 / SSD
    state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv: int = 4
    n_groups: int = 1
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:                # recurrentgemma / griffin
    pattern: Tuple[str, ...] = ("rec", "rec", "attn")
    window: int = 2048
    lru_width: int = 0            # 0 → d_model
    conv: int = 4
    c_exponent: float = 8.0


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    enc_layers: int
    dec_layers: int


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | vlm | hybrid | audio | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 → d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    encdec: Optional[EncDecConfig] = None
    frontend: Optional[str] = None    # "vit_stub" | "audio_stub"
    frontend_tokens: int = 0          # stub frontend sequence length
    source: str = ""                  # provenance note

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def n_params(self) -> int:
        """Exact parameter count from the spec tables."""
        from repro_torch.nn.model import param_specs
        return sum(int(np.prod(s.shape)) for s in param_specs(self).values())
