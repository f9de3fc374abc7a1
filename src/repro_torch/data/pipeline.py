"""Deterministic synthetic data pipeline (the port of
``repro/data/pipeline.py``; the same numpy generator, so every batch
equals the reference's bit for bit).

  * **deterministic & step-addressable**: `batch(step)` is a pure function
    of (seed, step), which is what makes checkpoint-restart exactly
    reproducible (no data state to checkpoint beyond the step counter);
  * **shard-aware**: `batch(step, shard, n_shards)` returns only that
    shard's rows;
  * **learnable structure**: tokens follow a per-sequence affine
    recurrence t_{i+1} = (a·t_i + c) mod V with (a, c) drawn from a small
    pool, so a model demonstrably learns (loss drops well below uniform).

Modality stubs: patch/frame embeddings are seeded Gaussians.  Batches are
numpy arrays; `to_device` moves one onto the model's device.  Nothing is
downloaded.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig


@dataclasses.dataclass
class SyntheticLM:
    cfg: ArchConfig
    seq_len: int
    global_batch: int
    seed: int = 0
    n_rules: int = 8          # size of the (a, c) pool

    def _rules(self):
        rng = np.random.default_rng(self.seed)
        a = rng.integers(1, self.cfg.vocab - 1, size=self.n_rules)
        c = rng.integers(0, self.cfg.vocab - 1, size=self.n_rules)
        return a, c

    def batch(self, step: int, shard: int = 0, n_shards: int = 1) -> Dict:
        if self.global_batch % n_shards:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split into {n_shards} shards")
        b = self.global_batch // n_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))
        a_pool, c_pool = self._rules()
        rule = rng.integers(0, self.n_rules, size=b)
        a = a_pool[rule][:, None]
        c = c_pool[rule][:, None]
        V = self.cfg.vocab
        toks = np.empty((b, self.seq_len + 1), dtype=np.int32)
        toks[:, 0] = rng.integers(0, V, size=b)
        for i in range(self.seq_len):
            toks[:, i + 1] = (a[:, 0] * toks[:, i] + c[:, 0]) % V
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
        if self.cfg.frontend == "vit_stub":
            # the image prefix carries no next-token target
            batch["patch_embeds"] = rng.standard_normal(
                (b, self.cfg.frontend_tokens, self.cfg.d_model)
            ).astype(np.float32)
        if self.cfg.encdec is not None:
            batch["frames"] = rng.standard_normal(
                (b, self.cfg.frontend_tokens, self.cfg.d_model)
            ).astype(np.float32)
        return batch


def to_device(batch: Dict, device) -> Dict:
    """A numpy batch as tensors on `device` (token ids int32, embeddings
    f32)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def input_shapes(cfg: ArchConfig, shape: ShapeConfig,
                 per_device_batch: Optional[int] = None) -> Dict:
    """The inputs of a (arch, shape) cell as ``{name: (shape, dtype)}``,
    the reference's ``ShapeDtypeStruct`` fields."""
    B = per_device_batch or shape.global_batch
    if shape.kind == "train":
        text = shape.seq_len
        if cfg.frontend == "vit_stub":
            text = shape.seq_len - cfg.frontend_tokens
        d = {"tokens": ((B, text), torch.int32),
             "labels": ((B, text), torch.int32)}
    elif shape.kind == "prefill":
        text = shape.seq_len
        if cfg.frontend == "vit_stub":
            text = shape.seq_len - cfg.frontend_tokens
        if cfg.encdec is not None:
            text = shape.seq_len - cfg.frontend_tokens
        d = {"tokens": ((B, text), torch.int32)}
    else:                                     # decode
        d = {"tokens": ((B, 1), torch.int32)}
    if cfg.frontend == "vit_stub" and shape.kind != "decode":
        d["patch_embeds"] = ((B, cfg.frontend_tokens, cfg.d_model),
                             torch.bfloat16)
    if cfg.encdec is not None and shape.kind != "decode":
        d["frames"] = ((B, cfg.frontend_tokens, cfg.d_model), torch.float32)
    return d
