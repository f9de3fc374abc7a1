"""End-to-end training script of the port (the port of
``examples/train_lm.py``): a llama-family model of about 100M params (or
25M), a few hundred steps on the deterministic synthetic pipeline, with
checkpoint/resume, on the GPU unless ``--device cpu`` is given.

  PYTHONPATH=src python examples/torch_train_lm.py --steps 300
  PYTHONPATH=src python examples/torch_train_lm.py --steps 40 --preset 25m
  PYTHONPATH=src python examples/torch_train_lm.py --preset 25m --steps 2 \\
      --seq 32 --global-batch 2 --device cpu

A second run with the same ``--ckpt-dir`` resumes from its latest
checkpoint (default: a folder under the system's temporary directory).
"""

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import SyntheticLM, to_device
from repro_torch.ft.fault_tolerance import TrainSupervisor
from repro_torch.nn import model as MD
from repro_torch.nn.layers import init_params
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.train_step import train_step

PRESETS = {
    # ~104M params: llama3 family, reduced dims
    "100m": dict(n_layers=10, d_model=640, n_heads=10, n_kv_heads=5,
                 d_ff=2560, vocab=32768, head_dim=64),
    # ~25M: fast CI-scale variant
    "25m": dict(n_layers=6, d_model=384, n_heads=6, n_kv_heads=3,
                d_ff=1536, vocab=16384, head_dim=64),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="100m", choices=PRESETS)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    base = configs.get("llama3-8b")
    cfg = dataclasses.replace(base, name=f"llama-{args.preset}",
                              **PRESETS[args.preset])
    data = SyntheticLM(cfg, args.seq, args.global_batch, seed=0)
    params = init_params(MD.param_specs(cfg),
                         torch.Generator(device=dev).manual_seed(0), dev,
                         dtype=torch.float32)
    n = sum(int(np.prod(v.shape)) for v in params.values())
    print(f"model {cfg.name}: {n/1e6:.1f}M params, seq={args.seq}, "
          f"global_batch={args.global_batch}, steps={args.steps}")

    opt = init_opt_state(params)
    ocfg = OptConfig(peak_lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                     total_steps=args.steps, schedule="cosine")
    t0 = time.time()
    hist = []

    def step_fn(params, opt_state, step):
        batch = to_device(data.batch(step), dev)
        params, opt_state, m = train_step(params, opt_state, batch, cfg,
                                          ocfg, remat=True, chunks=(256, 256))
        loss = float(m["loss"])
        hist.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            tok_s = (step + 1) * args.seq * args.global_batch / \
                (time.time() - t0)
            print(f"step {step:4d}  loss {loss:7.4f}  "
                  f"lr {float(m['lr']):.2e}  {tok_s:,.0f} tok/s")
        return params, opt_state, m

    sup = TrainSupervisor(Checkpointer(args.ckpt_dir),
                          ckpt_every=max(args.steps // 4, 10))
    sup.run(params, opt, step_fn, args.steps)
    if not hist:
        print(f"nothing to do: {args.ckpt_dir} holds step {args.steps}")
        return
    print(f"done in {time.time()-t0:.0f}s; "
          f"loss {hist[0]:.4f} -> {min(hist[-10:]):.4f} "
          f"(uniform = {np.log(cfg.vocab):.3f})")


if __name__ == "__main__":
    main()
