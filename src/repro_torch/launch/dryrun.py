"""Dry-run of every (arch × shape × mesh) cell on the production mesh
(the port of ``repro/launch/dryrun.py``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
      --shape train_4k [--multi-pod] [--both-meshes] [--all] [--out r.json]

Each cell's step runs once on the ``meta`` device at the cell's global
shapes: nothing is allocated and nothing is launched, and a meta tensor
carries only its shape and dtype.  The mesh is `launch/mesh.py`'s
production mesh (16×16 ``("data", "model")``, or 2×16×16 with ``"pod"``)
over ``meta`` entries, and the layout is the reference's rule tables
(`distributed/sharding.py`: `TRAIN_RULES` for train cells, `SERVE_RULES`
and `CACHE_RULES_SERVE` for prefill and decode).  The cells and their
steps are the reference's: `train_step.loss_and_grads` and AdamW's
`apply_updates` (remat, chunks 1024), `serve_step.prefill_step`, and
`serve_step.decode_step` of one token on caches primed to the cell's
length.  Each record keeps the reference's keys that the port can fill:

* ``per_device.argument_bytes``: exact, the sum of the per-device shard
  shapes (`sharding.Sharding.shard_shape`) of the step's arguments: the
  params (f32 for training; the port's serving storage otherwise,
  `nn.layers.storage_dtype`), for train cells the AdamW moments and
  step, for decode cells the caches, and the batch
  (`data.pipeline.input_shapes`);
* ``per_device.output_bytes``: the meta outputs laid out by the same
  rules (train: params, moments, step and the 0-d metrics; prefill: the
  first tokens by batch and the caches; decode: the next tokens and
  logits by batch and vocab, and the caches);
* ``per_device.flops``: ``torch.utils.flop_counter.FlopCounterMode`` over
  the meta step of the global batch (matrix products and attention, as
  that counter counts), divided by the device count.  The reference's
  XLA ``cost_analysis`` counts a scan body once (its ``nn/scanctl.py``),
  so the two are not compared; the flash kernel's cells count the plain
  version's products (`kernels.flash_attention` on meta);
* ``trace_s``, the seconds of the meta trace, in place of ``lower_s``
  and ``compile_s``;
* ``status``: ``"SKIP"`` (with ``reason``) from `configs.skip_reason`.

Without XLA, ``temp_bytes``, ``alias_bytes``, ``bytes_accessed``,
``transcendentals``, ``collectives`` and ``hlo_ops`` have no counterpart:
they are left out of the record (`OMITTED`).  The dry-run checks the
layout; it does not claim that the port runs tensor parallelism (its
multi-rank training is data-parallel over ``data``, `launch/train.py`).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs.base import skip_reason
from repro_torch.data.pipeline import input_shapes
from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.nn import model as MD
from repro_torch.nn.layers import storage_dtype

META = torch.device("meta")
# the reference's record fields that only XLA's compiled artifact gives
OMITTED = ("temp_bytes", "alias_bytes", "bytes_accessed", "transcendentals",
           "collectives", "hlo_ops")


def _meta(shape, dtype, requires_grad: bool = False):
    return torch.empty(tuple(shape), dtype=dtype, device=META,
                       requires_grad=requires_grad)


def shard_bytes(tensors, shardings) -> int:
    """Σ per-device shard bytes of matching trees of meta tensors (or
    ``(shape, dtype)`` pairs) and `sharding.Sharding`s."""
    total = 0

    def walk(t, s):
        nonlocal total
        if isinstance(s, SH.Sharding):
            dtype = t[1] if isinstance(t, tuple) and len(t) == 2 and \
                isinstance(t[1], torch.dtype) else t.dtype
            total += int(np.prod(s.shard_shape, dtype=np.int64)) * \
                torch.empty((), dtype=dtype).element_size()
        elif isinstance(s, dict):
            for k in s:
                walk(t[k], s[k])
        else:
            for a, b in zip(t, s):
                walk(a, b)

    walk(tensors, shardings)
    return total


def build_cell(arch: str, shape_name: str, mesh, chunks=(1024, 1024),
               cfg=None, microbatches: int = 1):
    """(fn, args, arg_shardings, out_shardings_of): the cell's step,
    its meta arguments, their shardings, and a function from the step's
    outputs to theirs.  `cfg` overrides the registry config;
    `microbatches` enables gradient accumulation in train cells."""
    from repro_torch.train.optimizer import (OptConfig, apply_updates,
                                             init_opt_state)
    from repro_torch.train.serve_step import decode_step, prefill_step
    from repro_torch.train.train_step import _accumulated_grads

    cfg = cfg or configs.get(arch)
    shape = configs.get_shape(shape_name)
    mode = "train" if shape.kind == "train" else "serve"
    rules = SH.rules_for(mode)
    specs = MD.param_specs(cfg)
    p_shard = SH.shardings_for_specs(specs, rules, mesh)
    params = {k: _meta(s.shape, torch.float32 if mode == "train"
                       else storage_dtype(k))
              for k, s in specs.items()}
    batch_shapes = input_shapes(cfg, shape)
    b_shard = SH.batch_sharding(batch_shapes, rules, mesh)
    batch = {k: _meta(*v) for k, v in batch_shapes.items()}

    def by_batch(x, vocab=False):
        axes = ("batch",) + (("vocab",) if vocab else ()) \
            + (None,) * (x.ndim - 1 - vocab)
        return SH._sharding(tuple(x.shape), axes, rules, mesh)

    if shape.kind == "train":
        opt = init_opt_state(params)
        rep = SH.Sharding(SH.P(), ())
        o_shard = {"mu": p_shard, "nu": p_shard, "step": rep}
        opt_cfg = OptConfig()

        def fn(params, opt, batch):
            total, metrics, grads = _accumulated_grads(
                params, cfg, batch, opt_cfg, True, chunks, microbatches)
            params, opt, om = apply_updates(params, grads, opt, opt_cfg)
            return params, opt, {**metrics, **om, "total": total}

        def outs(out):
            return (p_shard, o_shard, {k: rep for k in out[2]})
        return fn, (params, opt, batch), (p_shard, o_shard, b_shard), outs

    smax = shape.seq_len
    if shape.kind == "prefill":
        def fn(params, batch):
            with torch.no_grad():
                return prefill_step(params, cfg, batch, smax, chunks=chunks)

        def outs(out):
            return (by_batch(out[0]), SH.cache_shardings(cfg, out[1], mesh))
        return fn, (params, batch), (p_shard, b_shard), outs

    # decode: a cache primed to smax - 1 tokens, a one-token step
    B = shape.global_batch
    caches = MD.init_cache(cfg, B, smax, device=META)
    c_shard = SH.cache_shardings(cfg, caches, mesh)
    tokens = _meta((B, 1), torch.int32)
    # q = 1: one KV chunk of the whole length, as the reference's
    kv_chunk = min(shape.seq_len, max(chunks))

    def fn(params, tokens, caches):
        with torch.no_grad():
            return decode_step(params, cfg, tokens, caches,
                               chunks=(1, kv_chunk))

    def outs(out):
        return (by_batch(out[0]), SH.cache_shardings(cfg, out[1], mesh),
                by_batch(out[2], vocab=True))
    return (fn, (params, tokens, caches),
            (p_shard, b_shard["tokens"], c_shard), outs)


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             chunks=(1024, 1024)) -> Dict:
    """Trace one cell on meta; return its record."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = configs.get(arch)
    shape = configs.get_shape(shape_name)
    mesh_tag = "multi" if multi_pod else "single"
    reason = skip_reason(cfg, shape)
    if reason:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                "status": "SKIP", "reason": reason}
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_dev = int(np.prod(list(mesh.shape.values())))
    fn, args, arg_shardings, out_shardings_of = build_cell(
        arch, shape_name, mesh, chunks)
    arg_bytes = shard_bytes(args, arg_shardings)
    t0 = time.time()
    with FlopCounterMode(display=False) as counter:
        out = fn(*args)
    trace_s = time.time() - t0
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_tag,
        "n_devices": n_dev, "status": "OK", "trace_s": round(trace_s, 2),
        "per_device": {
            "argument_bytes": arg_bytes,
            "output_bytes": shard_bytes(out, out_shardings_of(out)),
            "flops": float(counter.get_total_flops()) / n_dev,
        },
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=configs.ARCH_IDS)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every (arch × shape) cell")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not args.all and args.arch is None:
        ap.error("--arch is required without --all")

    if args.all:
        cells = [(a, s.name) for a in configs.ARCH_IDS
                 for s in configs.ALL_SHAPES]
    else:
        shapes = [args.shape] if args.shape else \
            [s.name for s in configs.ALL_SHAPES]
        cells = [(args.arch, s) for s in shapes]
    meshes = [False, True] if (args.both_meshes or args.all) else \
        [args.multi_pod]
    print("dry-run on meta: fields of the reference's record left out "
          f"(no XLA): {', '.join(OMITTED)}")
    reports = []
    for arch, shp in cells:
        for mp in meshes:
            rec = run_cell(arch, shp, multi_pod=mp)
            reports.append(rec)
            tag = f"{arch} × {shp} × {'2x16x16' if mp else '16x16'}"
            if rec["status"] == "SKIP":
                print(f"SKIP {tag}: {rec['reason']}")
            else:
                pd = rec["per_device"]
                print(f"OK   {tag}: trace={rec['trace_s']}s "
                      f"args={pd['argument_bytes'] / 1e9:.2f}GB "
                      f"out={pd['output_bytes'] / 1e9:.2f}GB "
                      f"flops={pd['flops']:.3g} per device")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(reports, f, indent=1)
        print(f"wrote {args.out}")
    return reports


if __name__ == "__main__":
    main()
