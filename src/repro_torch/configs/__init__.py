"""Architecture registry: ``--arch <id>`` resolution.

Only the architectures the port runs are listed: the dense GQA family
(``qwen3-4b`` with qk-norm, ``qwen2.5-3b`` with QKV bias, ``llama3-8b``
with neither).  The reference's other architectures (MoE, MLA, SSM,
RG-LRU, encoder-decoder, the ViT stub) wait for ROADMAP queue 1 item 9
and raise here.
"""

from repro_torch.configs import llama3_8b, qwen2_5_3b, qwen3_4b
from repro_torch.configs.base import ArchConfig

_MODULES = {
    "qwen3-4b": qwen3_4b,
    "qwen2.5-3b": qwen2_5_3b,
    "llama3-8b": llama3_8b,
}

ARCH_IDS = tuple(_MODULES)
# the reference's other architectures, not ported yet
PENDING_IDS = ("deepseek-v2-236b", "dbrx-132b", "pixtral-12b", "minicpm-2b",
               "recurrentgemma-2b", "seamless-m4t-large-v2", "mamba2-1.3b")


def _module(arch_id: str):
    if arch_id in _MODULES:
        return _MODULES[arch_id]
    if arch_id in PENDING_IDS:
        raise NotImplementedError(
            f"architecture {arch_id!r} is not ported yet (ROADMAP queue 1 "
            f"item 9: the port runs the dense GQA family {ARCH_IDS})")
    raise KeyError(arch_id)


def get(arch_id: str) -> ArchConfig:
    return _module(arch_id).FULL


def get_smoke(arch_id: str) -> ArchConfig:
    return _module(arch_id).SMOKE
