"""Training launcher of the port: ``--arch`` (or its smoke dims),
checkpoint/resume, deterministic data, on the GPU by default.

  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
      --steps 4 --seq 512 --global-batch 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
      --smoke --steps 200 --ckpt-dir ckpt --device cpu

The reference's CLI (``repro/launch/train.py``) with ``--device`` added:
``cuda`` unless ``cpu`` is asked for, and without a usable GPU it fails
instead of moving to the CPU.  Params are f32 from ``--seed`` (a
``torch.Generator`` on the device: another stream than the reference's
``jax.random``), AdamW moments f32; every layer of a stacked group is
recomputed in the backward (remat).  minicpm-2b trains with WSD, as in
its paper.  With ``--ckpt-dir`` a `TrainSupervisor` checkpoints every
``--ckpt-every`` steps and resumes from the latest checkpoint there.
One device only: ``--devices`` above 1 (the reference's host mesh and
its sharding rules) is ROADMAP item 9.3.  ``--profile`` then traces one
more step with ``torch.profiler`` and prints the device time by kernel
and the device's busy share of its wall time.
"""

from __future__ import annotations

import argparse
import time


def build(arch: str, smoke: bool, seq: int, global_batch: int, opt_cfg,
          n_devices: int = 1, chunks=(256, 256), seed: int = 0,
          device=None):
    """(cfg, params, opt_state, one_step, device): the config, f32 params
    and zero AdamW state on the device, and ``one_step(params, opt,
    step)``, which trains on the pipeline's batch of that step."""
    import torch

    from repro_torch import configs
    from repro_torch.core.device import resolve_device
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.nn import model as MD
    from repro_torch.nn.layers import init_params
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import train_step

    if n_devices > 1:
        raise NotImplementedError(
            "--devices > 1 needs the host mesh and the training sharding "
            "rules (launch/mesh.py, distributed/sharding.py), ROADMAP item "
            "9.3; this launcher trains on one device")
    dev = resolve_device(device)
    cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    data = SyntheticLM(cfg, seq, global_batch, seed=seed)
    params = init_params(MD.param_specs(cfg),
                         torch.Generator(device=dev).manual_seed(seed), dev,
                         dtype=torch.float32)
    opt = init_opt_state(params)

    def one_step(params, opt_state, step):
        batch = to_device(data.batch(step), dev)
        return train_step(params, opt_state, batch, cfg, opt_cfg,
                          remat=True, chunks=chunks)

    return cfg, params, opt, one_step, dev


def main(argv=None):
    """Runs the CLI; returns one record per step: ``step``, ``ms`` (host
    wall clock of the step, ended by reading its loss), ``tokens_per_s``,
    ``peak_gb`` (``max_memory_allocated`` so far; 0 on the CPU),
    ``loss``, ``lr`` and ``grad_norm``."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.ckpt.checkpoint import Checkpointer
    from repro_torch.ft.fault_tolerance import TrainSupervisor
    from repro_torch.train.optimizer import OptConfig

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3-8b", choices=configs.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--schedule", default="cosine",
                    choices=["cosine", "wsd", "const"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--profile", action="store_true",
                    help="trace one more step after the run")
    args = ap.parse_args(argv)

    # minicpm trains with WSD per its paper; make that the arch default
    sched = args.schedule
    if args.arch == "minicpm-2b" and sched == "cosine":
        sched = "wsd"
    ocfg = OptConfig(peak_lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                     total_steps=args.steps, schedule=sched)
    cfg, params, opt, one_step, dev = build(
        args.arch, args.smoke, args.seq, args.global_batch, ocfg,
        n_devices=args.devices, seed=args.seed, device=args.device)
    print(f"arch={cfg.name} params="
          f"{sum(int(np.prod(v.shape)) for v in params.values()):,}")

    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    log = {"last": t0}
    records = []

    def step_fn(params, opt_state, step):
        t = time.perf_counter()
        params, opt_state, m = one_step(params, opt_state, step)
        loss = float(m["loss"])                    # waits for the step
        ms = (time.perf_counter() - t) * 1e3
        records.append({
            "step": step, "ms": ms,
            "tokens_per_s": args.seq * args.global_batch / ms * 1e3,
            "peak_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                        if cuda else 0.0),
            "loss": loss, "lr": float(m["lr"]),
            "grad_norm": float(m["grad_norm"])})
        if step % args.log_every == 0 or step == args.steps - 1:
            now = time.time()
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"lr {float(m['lr']):.2e} gnorm {float(m['grad_norm']):.3f} "
                  f"({now - log['last']:.1f}s)")
            log["last"] = now
        return params, opt_state, m

    if args.ckpt_dir:
        sup = TrainSupervisor(Checkpointer(args.ckpt_dir),
                              ckpt_every=args.ckpt_every)
        params, opt, hist = sup.run(params, opt, step_fn, args.steps)
        losses = [h["loss"] for h in hist]
    else:
        losses = []
        for s in range(args.steps):
            params, opt, m = step_fn(params, opt, s)
            losses.append(float(m["loss"]))
    if losses:
        print(f"done in {time.time() - t0:.1f}s  "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    if args.profile:
        _profile_step(one_step, params, opt, args.steps, dev)
    return records


def _profile_step(one_step, params, opt, step, dev):
    """Device time by kernel and busy share of one traced step."""
    from repro_torch.launch.solve import _profile_report, _profiler

    with _profiler(dev.type) as prof:
        t = time.perf_counter()
        _, _, m = one_step(params, opt, step)
        float(m["loss"])                           # waits for the step
        wall = time.perf_counter() - t
    _profile_report(prof, wall, f"train step {step}", top=12)


if __name__ == "__main__":
    main()
