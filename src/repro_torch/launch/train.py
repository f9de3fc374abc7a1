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
``--profile`` then traces one more step with ``torch.profiler`` and
prints the device time by kernel and the device's busy share of its
wall time.

``--devices N`` (N > 1) trains data-parallel over N ranks, the
reference's step under ``TRAIN_RULES`` on the host mesh
(`train_step.sharded_train_step`: params and moments sharded by their
``embed`` dim, the batch by rows).  The CLI spawns the N rank processes
itself (``torch.multiprocessing``, a ``file://`` rendezvous in a
temporary directory: no network, no ``torchrun``).  Rank r runs on
``cuda:(r % device_count)``, or on the CPU with ``--device cpu``.  The
backend: NCCL when each rank has a card of its own; gloo on the CPU or
when ranks share a card (NCCL refuses two ranks on one GPU); the run
prints which.  Every rank draws the same params from ``--seed`` and keeps
its shards, and reads its rows of the pipeline's global batch.  Rank 0
prints the step lines, and `main` returns rank 0's records.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
      --smoke --steps 3 --devices 4 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time


def build(arch: str, smoke: bool, seq: int, global_batch: int, opt_cfg,
          chunks=(256, 256), seed: int = 0, device=None, cfg=None):
    """(cfg, params, opt_state, one_step, device): the config (`cfg`, or
    the registry's), f32 params and zero AdamW state on the device, and
    ``one_step(params, opt, step)``, which trains on the pipeline's batch
    of that step."""
    import torch

    from repro_torch import configs
    from repro_torch.core.device import resolve_device
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.nn import model as MD
    from repro_torch.nn.layers import init_params
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import train_step

    dev = resolve_device(device)
    cfg = cfg or (configs.get_smoke(arch) if smoke else configs.get(arch))
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


def backend_for(n_ranks: int, device_type: str) -> tuple:
    """(backend, reason): NCCL when each of the `n_ranks` ranks has a
    card of its own, gloo on the CPU or when ranks share a card."""
    import torch
    if device_type == "cpu":
        return "gloo", "ranks on the CPU"
    n = torch.cuda.device_count()
    if n_ranks <= n:
        return "nccl", f"{n_ranks} ranks on {n} cards, one card each"
    return "gloo", (f"{n_ranks} ranks share {n} card(s): NCCL refuses two "
                    "ranks on one GPU")


def rank_device(rank: int, device_type: str):
    """Rank r's device: ``cuda:(r % device_count)`` or the CPU."""
    import torch
    from repro_torch.core.device import resolve_device
    if device_type == "cpu":
        return resolve_device("cpu")
    return resolve_device(f"cuda:{rank % max(torch.cuda.device_count(), 1)}")


def build_rank(arch: str, smoke: bool, seq: int, global_batch: int,
               opt_cfg, rank: int, world: int, group=None,
               chunks=(256, 256), seed: int = 0, device=None, cfg=None):
    """One rank's (cfg, params, opt_state, one_step, device, shardings) on
    `rank_device` (`device`: "cuda", the default, or "cpu"):
    every rank draws the full params from `seed` on its device (the same
    values as `build`'s), keeps its shards under ``TRAIN_RULES`` on the
    ``{"data": world}`` host mesh, and ``one_step`` trains on its rows of
    the pipeline's global batch of that step."""
    import torch

    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.nn import model as MD
    from repro_torch.nn.layers import init_params
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import (rank_rows, shard_params,
                                              sharded_train_step)

    dev = rank_device(rank, device or "cuda")
    cfg = cfg or (configs.get_smoke(arch) if smoke else configs.get(arch))
    data = SyntheticLM(cfg, seq, global_batch, seed=seed)
    specs = MD.param_specs(cfg)
    mesh = make_host_mesh(world, device=dev)
    shardings = SH.shardings_for_specs(specs, SH.rules_for("train"), mesh)
    full = init_params(specs, torch.Generator(device=dev).manual_seed(seed),
                       dev, dtype=torch.float32)
    params = shard_params(full, shardings, rank, world)
    del full
    opt = init_opt_state(params)

    def one_step(params, opt_state, step):
        batch = to_device(rank_rows(data.batch(step), rank, world), dev)
        return sharded_train_step(params, opt_state, batch, cfg, opt_cfg,
                                  shardings=shardings, group=group,
                                  remat=True, chunks=chunks)

    return cfg, params, opt, one_step, dev, shardings


def _parser():
    from repro_torch import configs
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
    ap.add_argument("--devices", type=int, default=1,
                    help="data-parallel ranks (spawned by the CLI)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--profile", action="store_true",
                    help="trace one more step after the run")
    return ap


def _opt_config(args):
    from repro_torch.train.optimizer import OptConfig
    # minicpm trains with WSD per its paper; make that the arch default
    sched = args.schedule
    if args.arch == "minicpm-2b" and sched == "cosine":
        sched = "wsd"
    return OptConfig(peak_lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                     total_steps=args.steps, schedule=sched)


def main(argv=None):
    """Runs the CLI; returns one record per step (rank 0's with
    ``--devices N``): ``step``, ``ms`` (host wall clock of the step,
    ended by reading its loss), ``tokens_per_s``, ``peak_gb``
    (``max_memory_allocated`` so far; 0 on the CPU), ``loss``, ``lr`` and
    ``grad_norm``; with ``--devices N`` also ``peak_gb_ranks`` (every
    rank's ``peak_gb``), ``backend`` and ``launches_ranks`` (every rank's
    kernel launch counters, `kernel_launches`, at its end)."""
    return run(argv)[0]


def run(argv=None, keep_params: bool = False, cfg=None):
    """`main`'s records, and with `keep_params` the trained params (whole,
    on the CPU; else None).  `cfg` (an `ArchConfig`, e.g. a config cut in
    depth) takes the place of ``--arch``'s."""
    args = _parser().parse_args(argv)
    args.cfg = cfg
    if args.devices > 1:
        if args.ckpt_dir or args.profile:
            raise SystemExit("--ckpt-dir and --profile train on one device;"
                             " --devices > 1 takes neither")
        return _spawn(args, keep_params)
    return _train(args, keep_params=keep_params)


def _train(args, rank: int = 0, world: int = 1, group=None,
           keep_params: bool = False, note: str = ""):
    """The training loop of one rank (or of the one device)."""
    import torch

    from repro_torch.ckpt.checkpoint import Checkpointer
    from repro_torch.ft.fault_tolerance import TrainSupervisor

    ocfg = _opt_config(args)
    lead = rank == 0
    if world > 1:
        from repro_torch.train.train_step import gather_params
        cfg, params, opt, one_step, dev, shardings = build_rank(
            args.arch, args.smoke, args.seq, args.global_batch, ocfg, rank,
            world, group, seed=args.seed, device=args.device,
            cfg=args.cfg)
    else:
        cfg, params, opt, one_step, dev = build(
            args.arch, args.smoke, args.seq, args.global_batch, ocfg,
            seed=args.seed, device=args.device,
            cfg=args.cfg)
    if lead:
        print(f"arch={cfg.name} params={cfg.n_params():,}{note}",
              flush=True)

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
        if lead and (step % args.log_every == 0 or step == args.steps - 1):
            now = time.time()
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"lr {float(m['lr']):.2e} gnorm {float(m['grad_norm']):.3f} "
                  f"({now - log['last']:.1f}s)", flush=True)
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
    if losses and lead:
        print(f"done in {time.time() - t0:.1f}s  "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
    if args.profile:
        _profile_step(one_step, params, opt, args.steps, dev)
    kept = None
    if keep_params:
        if world > 1:
            params = gather_params(params, shardings, group)
        kept = {k: v.detach().cpu() for k, v in params.items()} \
            if lead else None
    return records, kept


def _rank_main(rank: int, args, world: int, backend: str, tmp: str,
               keep_params: bool, reason: str):
    """One spawned rank: join the group, train, write the records (and
    rank 0 the params) into `tmp`."""
    import torch
    import torch.distributed as dist

    if args.device == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    else:
        torch.cuda.set_device(rank_device(rank, "cuda"))
    dist.init_process_group(backend,
                            init_method=f"file://{os.path.join(tmp, 'rdv')}",
                            rank=rank, world_size=world)
    try:
        note = (f" ranks={world} backend={backend} ({reason})"
                if rank == 0 else "")
        records, params = _train(args, rank, world, dist.group.WORLD,
                                 keep_params, note)
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump({"records": records, "launches": kernel_launches()},
                      f)
        if params is not None:
            torch.save(params, os.path.join(tmp, "params.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _spawn(args, keep_params: bool):
    """Train over `args.devices` spawned ranks; rank 0's records (with
    every rank's peak memory and the backend) and, with `keep_params`,
    the trained params."""
    import torch
    import torch.multiprocessing as mp

    world = args.devices
    dev_type = "cpu" if args.device == "cpu" else "cuda"
    rank_device(0, dev_type)                   # no GPU: raise here
    backend, reason = backend_for(world, dev_type)
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, args=(args, world, backend, tmp, keep_params,
                                   reason), nprocs=world, join=True)
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        params = (torch.load(os.path.join(tmp, "params.pt"))
                  if keep_params else None)
    records = ranks[0]["records"]
    for i, rec in enumerate(records):
        rec["peak_gb_ranks"] = [rr["records"][i]["peak_gb"] for rr in ranks]
        rec["backend"] = backend
        rec["launches_ranks"] = [rr["launches"] for rr in ranks]
    return records, params


def kernel_launches() -> dict:
    """This process's launch counters of the port's three kernels."""
    from repro_torch.kernels.fixpoint_kernel import fixpoint_cuda, search_cuda
    from repro_torch.kernels.flash_attention import flash_attention
    return {"fixpoint_cuda": fixpoint_cuda.launches,
            "search_cuda": search_cuda.launches,
            "flash_attention": flash_attention.launches}


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
