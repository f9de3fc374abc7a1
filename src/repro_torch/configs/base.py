"""Architecture configuration (the port's copy of ``repro/configs/base.py``).

One `ArchConfig` per architecture, with exact numbers from the public
sources cited in each config file, plus a ``SMOKE`` reduction of the
same family for CPU tests.  `ShapeConfig` and the reference's four
shapes name a (sequence, batch, kind) cell; `data.pipeline.input_shapes`
reads them, and `skip_reason` holds the reference's skip rule (the
dry-run's ``SKIP`` cells).
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

    @property
    def attn_free(self) -> bool:
        return self.ssm is not None

    @property
    def sub_quadratic(self) -> bool:
        """Can decode with O(1)/bounded per-token state at 500k context."""
        return self.ssm is not None or self.rglru is not None

    def n_params(self) -> int:
        """Exact parameter count from the spec tables."""
        from repro_torch.nn.model import param_specs
        return sum(int(np.prod(s.shape)) for s in param_specs(self).values())

    def n_active_params(self) -> int:
        """Active-per-token params (MoE: routed top-k + shared only)."""
        from repro_torch.nn.model import active_param_fraction, param_specs
        total = 0
        for path, s in param_specs(self).items():
            n = int(np.prod(s.shape))
            total += int(n * active_param_fraction(self, path))
        return total


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def applicable_shapes(cfg: ArchConfig) -> Tuple[ShapeConfig, ...]:
    """The reference's skip rules: long_500k only for sub-quadratic
    archs; decode applies to every arch (all have decoders)."""
    shapes = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.sub_quadratic:
        shapes.append(LONG_500K)
    return tuple(shapes)


def skip_reason(cfg: ArchConfig, shape: ShapeConfig) -> Optional[str]:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("full-attention arch: 500k dense KV/attention is what this "
                "shape excludes (DESIGN.md §5)")
    return None
