"""AdamW with global-norm clipping and cosine / WSD schedules (the port of
``repro/train/optimizer.py``).

WSD (warmup — stable — decay) is the MiniCPM schedule (arXiv:2404.06395):
linear warmup, long constant plateau, short exponential-ish decay tail.

Optimizer state is the reference's flat dict mirror of the params:
``{"mu": {path: f32}, "nu": {path: f32}, "step": int32 0-d}``.  The
schedule, the bias corrections and the clip scale are f32 0-d tensors
on the state's device, as the reference's are f32 scalars, so a step
reads nothing back to the host.

`apply_updates` computes the reference's arithmetic leaf by leaf, but
writes the params and moments in place and returns the same dicts: a
functional update would hold two copies of params, ``mu`` and ``nu`` at
once (65 GB at minicpm-2b's 2.72 B params in f32).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    min_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1000
    schedule: str = "cosine"          # "cosine" | "wsd" | "const"
    wsd_decay_frac: float = 0.1       # last 10% of steps decay (MiniCPM)
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moe_balance_weight: float = 0.01


def learning_rate(step, cfg: OptConfig) -> torch.Tensor:
    """The learning rate at `step` (an int or a 0-d tensor), as an f32 0-d
    tensor on the step's device."""
    step = torch.as_tensor(step).to(F32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    if cfg.schedule == "cosine":
        frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
            1 + torch.cos(math.pi * t))
    elif cfg.schedule == "wsd":
        decay_start = 1.0 - cfg.wsd_decay_frac
        d = (t - decay_start) / max(cfg.wsd_decay_frac, 1e-9)
        decayed = torch.pow(torch.tensor(cfg.min_lr_frac, dtype=F32,
                                         device=step.device),
                            torch.clamp(d, 0, 1))
        frac = torch.where(t > decay_start, decayed, torch.ones_like(t))
    elif cfg.schedule == "const":
        frac = torch.ones_like(t)
    else:
        raise ValueError(cfg.schedule)
    return cfg.peak_lr * warm * frac


def init_opt_state(params: Dict) -> Dict:
    """Zero f32 moments shaped as the params, on their devices, and step
    0 (int32) on the first param's device."""
    zeros = lambda: {k: torch.zeros(v.shape, dtype=F32,  # noqa: E731
                                    device=v.device)
                     for k, v in params.items()}
    device = next(iter(params.values())).device
    return {"mu": zeros(), "nu": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _global_norm(tree: Dict) -> torch.Tensor:
    """√(Σ x²) over every leaf, in f32, leaves in sorted path order (the
    reference's ``tree_leaves`` order)."""
    return torch.sqrt(sum(torch.sum(torch.square(tree[k].to(F32)))
                          for k in sorted(tree)))


def _decay_mask(path: str) -> bool:
    """No weight decay on norms/biases/scalars (standard)."""
    leaf = path.rsplit("/", 1)[-1]
    return not (("norm" in leaf) or leaf.endswith("_b")
                or leaf in ("b_a", "b_x", "a_param", "A_log", "D",
                            "dt_bias", "conv_b"))


@torch.no_grad()
def apply_updates(params: Dict, grads: Dict, state: Dict, cfg: OptConfig
                  ) -> Tuple[Dict, Dict, Dict]:
    """One AdamW step, written into `params` and `state` in place.
    Returns (params', state', metrics) — the same dicts, as the
    reference's return value."""
    step = state["step"] + 1
    lr = learning_rate(step, cfg)

    gnorm = _global_norm(grads)
    scale = (torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                         max=1.0)
             if cfg.clip_norm > 0 else None)

    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=F32, device=step.device),
                        step.to(F32))
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=F32, device=step.device),
                        step.to(F32))

    for k, p in params.items():
        g = grads[k].to(F32)
        g = g * scale if scale is not None else g
        mu, nu = state["mu"][k], state["nu"][k]
        mu.copy_(b1 * mu + (1 - b1) * g)
        nu.copy_(b2 * nu + (1 - b2) * g * g)
        upd = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        if cfg.weight_decay > 0 and _decay_mask(k):
            upd = upd + cfg.weight_decay * p.to(F32)
        p.copy_(p.to(F32) - lr * upd)
        del g, upd              # freed before the next leaf's temporaries
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}
