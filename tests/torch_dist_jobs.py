"""Jobs that `test_torch_dist_train.py` runs in each rank of one spawned
``torch.distributed`` gloo group on the CPU.  This module imports
neither JAX nor the JAX package: the parent passes every input (params,
batches, the reference's router picks) as numpy arrays and reads every
result back as numpy arrays, one pickle per rank.
"""

import contextlib
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist


def _pinned_route(calls):
    """A `topk_route` that takes the reference's picks: for logits of T
    tokens, the call (and, on a rank, its rows: rank · T onwards) whose
    logits are nearest."""
    from repro_torch.nn import moe as Mo

    def pin(logits, k):
        lg = logits.detach().numpy()
        T = lg.shape[0]

        def part(a):
            if a.shape[0] == T:
                return a
            off = dist.get_rank() * T
            return a[off:off + T]

        _, idx = min(((part(cl), part(ci)) for cl, ci in calls),
                     key=lambda c: np.abs(c[0] - lg).max())
        idx = torch.from_numpy(np.ascontiguousarray(idx)).long()
        return torch.softmax(torch.take_along_dim(logits, idx, -1), -1), idx

    return pin, Mo


def _cfg(arch, capacity_factor=None):
    import dataclasses
    from repro_torch import configs
    cfg = configs.get_smoke(arch)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return cfg


def _numpy(tree):
    """Copies (a gathered leaf that is whole on every rank is the live
    shard, which the next step updates in place)."""
    return {k: v.detach().cpu().numpy().copy() for k, v in tree.items()}


def train_job(rank, world, *, arch, states, batches, opt, pins=None,
              capacity_factor=None, local_routing=False,
              rounded_per_rank=False):
    """Step i of the sharded step over the group from ``states[i]``
    (whole params, ``mu``, ``nu`` and the step count, numpy) on
    ``batches[i]`` (global), and (rank 0) the port's one-device
    `train_step` from the same state on the same batch.  Optionally the
    MoE layers route each rank's tokens alone (`local_routing`), or each
    rank rounds its weight gradients before the sum
    (`rounded_per_rank`).  Returns, per
    step, both metrics, the one-device params after it, and the sharded
    step's params and moments after it (whole)."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.nn import model as M
    from repro_torch.nn import moe as Mo
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as T
    from repro_torch.data.pipeline import to_device

    cfg = _cfg(arch, capacity_factor)
    ocfg = O.OptConfig(**opt)
    shardings = SH.shardings_for_specs(
        M.param_specs(cfg), SH.rules_for("train"),
        make_host_mesh(world, device="cpu"))

    def state_of(st):
        """Whole (params, optimizer state) tensors of a numpy state."""
        def f32(tree):
            return {k: torch.tensor(v, dtype=torch.float32)
                    for k, v in tree.items()}
        return f32(st["params"]), {
            "mu": f32(st["mu"]), "nu": f32(st["nu"]),
            "step": torch.tensor(st["step"], dtype=torch.int32)}

    route, ranks = Mo.topk_route, Mo._ranks
    stash = T.unrounded_weight_grads
    if pins is not None:
        Mo.topk_route = _pinned_route(pins)[0]
    if local_routing:
        Mo._ranks = lambda: (None, 0, 1)
    if rounded_per_rank:
        # the stash off: each rank's weight gradients rounded to bf16
        T.unrounded_weight_grads = lambda s: contextlib.nullcontext()
    out = []
    try:
        for st, b in zip(states, batches):
            rec = {}
            if rank == 0:
                p1, s1 = state_of(st)
                _, _, m1 = T.train_step(p1, s1, to_device(b, "cpu"), cfg,
                                        ocfg, remat=True, chunks=(8, 8))
                rec["one_rank"] = {k: float(v) for k, v in m1.items()}
                rec["one_rank_params"] = _numpy(p1)
            full, s = state_of(st)
            shards = T.shard_params(full, shardings, rank, world)
            state = {"mu": T.shard_params(s["mu"], shardings, rank, world),
                     "nu": T.shard_params(s["nu"], shardings, rank, world),
                     "step": s["step"]}
            mine = to_device(T.rank_rows(b, rank, world), "cpu")
            shards, state, m = T.sharded_train_step(
                shards, state, mine, cfg, ocfg, shardings=shardings,
                remat=True, chunks=(8, 8))
            rec["metrics"] = {k: float(v) for k, v in m.items()}
            rec["params"] = _numpy(T.gather_params(shards, shardings))
            rec["mu"] = _numpy(T.gather_params(state["mu"], shardings))
            rec["nu"] = _numpy(T.gather_params(state["nu"], shardings))
            out.append(rec)
    finally:
        Mo.topk_route, Mo._ranks = route, ranks
        T.unrounded_weight_grads = stash
    return out


def collectives_job(rank, world, *, x):
    """`int8_psum_mean` and `psum_mean` of rank r's row of `x`, and
    `pod_sync_grads` on a (2, 2) ``("pod", "data")`` device mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed import collectives as C

    mine = torch.from_numpy(np.ascontiguousarray(x[rank]))
    out = {"int8": C.int8_psum_mean(mine).numpy(),
           "exact": C.psum_mean(mine).numpy()}
    mesh = init_device_mesh("cpu", (2, world // 2),
                            mesh_dim_names=("pod", "data"))
    grads = {"a/w": torch.full((4, 4), rank + 1.0),
             "b/w": -torch.arange(3.0) * (rank + 1)}
    for compress in (True, False):
        got = C.pod_sync_grads(grads, mesh, axis="pod", compress=compress)
        out[f"pod_{compress}"] = _numpy(got)
    flat = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    out["no_pod_is_identity"] = C.pod_sync_grads(grads, flat) is grads
    return out


JOBS = {"train": train_job, "collectives": collectives_job}


def worker(rank, world, tmp, jobs):
    """One rank: join the group through a file in `tmp`, run every job
    in order, write ``rank<r>.pkl``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        tmp, "rdv"), rank=rank, world_size=world)
    try:
        out = {name: JOBS[kind](rank, world, **kw)
               for name, (kind, kw) in jobs.items()}
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()
