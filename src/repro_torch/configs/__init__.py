"""Architecture registry: ``--arch <id>`` resolution, the reference's ten
architectures in its order.  An unknown id raises `KeyError`."""

from repro_torch.configs import (dbrx_132b, deepseek_v2_236b, llama3_8b,
                                 mamba2_1_3b, minicpm_2b, pixtral_12b,
                                 qwen2_5_3b, qwen3_4b, recurrentgemma_2b,
                                 seamless_m4t_large_v2)
from repro_torch.configs.base import (ALL_SHAPES, ArchConfig,  # noqa: F401
                                      ShapeConfig, applicable_shapes,
                                      skip_reason)

_MODULES = {
    "deepseek-v2-236b": deepseek_v2_236b,
    "dbrx-132b": dbrx_132b,
    "pixtral-12b": pixtral_12b,
    "qwen3-4b": qwen3_4b,
    "minicpm-2b": minicpm_2b,
    "qwen2.5-3b": qwen2_5_3b,
    "llama3-8b": llama3_8b,
    "recurrentgemma-2b": recurrentgemma_2b,
    "seamless-m4t-large-v2": seamless_m4t_large_v2,
    "mamba2-1.3b": mamba2_1_3b,
}

ARCH_IDS = tuple(_MODULES)


def get(arch_id: str) -> ArchConfig:
    return _MODULES[arch_id].FULL


def get_smoke(arch_id: str) -> ArchConfig:
    return _MODULES[arch_id].SMOKE


def get_shape(name: str) -> ShapeConfig:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
