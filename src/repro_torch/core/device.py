"""Device selection for the port's entry points.

Every entry point (`compile_model`, `SolveConfig`, the CLI) runs on the
card unless the caller asks for the CPU.  There is no quiet move to the
CPU: asking for ``cuda`` on a machine without a usable GPU raises.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; a CUDA device raises when no GPU is usable."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is False (torch {torch.__version__}); pass device='cpu' to "
            "run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda' or "
                         "'cpu'")
    if dev.type == "cuda" and dev.index is None:
        # the index tensors report, so device comparisons match
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
