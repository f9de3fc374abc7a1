"""Test inputs and comparisons for the port, without JAX: `chip_smoke.py`
and the kernel tests use them on the card as well as on the CPU."""

from __future__ import annotations

import numpy as np


def random_substores(rng: np.random.Generator, cm, n: int):
    """n stores made by random tells on the root box (consistent or not),
    as host arrays ``[n, V]``; the recipe of the JAX package's test helper
    of the same name, so one seed gives the same stores on both sides."""
    lb0, ub0 = cm.lb0.cpu().numpy(), cm.ub0.cpu().numpy()
    V = cm.n_vars
    lbs = np.tile(lb0, (n, 1))
    ubs = np.tile(ub0, (n, 1))
    for i in range(n):
        for _ in range(int(rng.integers(0, 8))):
            v = int(rng.integers(1, V))
            if lb0[v] >= ub0[v]:
                continue
            cut = int(rng.integers(lb0[v], ub0[v] + 1))
            if rng.random() < 0.5:
                lbs[i, v] = max(lbs[i, v], cut)
            else:
                ubs[i, v] = min(ubs[i, v], cut)
    return lbs, ubs


def search_inputs(cm, n_lanes: int, eps_target, opts, pool=None):
    """The inputs of one resident launch at the start of a solve, as
    `Solver` makes them: the EPS pool (`pool`, or decomposed to
    `eps_target`) padded to its bucket with failed stores, fresh lanes,
    the neutral bound and pool cursor 0 — on the model's device.
    Returns (subs_lb, subs_ub, st, gbest, pool_head)."""
    import torch

    from repro_torch.core import eps
    from repro_torch.core import search as S
    from repro_torch.core.api import _bucket
    lb, ub = pool if pool is not None else eps.decompose(cm, eps_target,
                                                         opts)
    lb, ub = eps.pad_pool(lb, ub, _bucket(lb.shape[0]))
    dev = cm.device
    big = torch.iinfo(cm.tdtype).max // 4
    return (torch.from_numpy(np.array(lb)).to(dev),
            torch.from_numpy(np.array(ub)).to(dev),
            S.init_lanes(cm, n_lanes, opts),
            torch.tensor(big, dtype=cm.tdtype, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev))


def search_diff(ref, got) -> list:
    """Names of what differs between two ``(st, gbest, it, pool_head,
    stopped)`` results of a resident launch: every LaneState field
    (values, dtypes and shapes), then the four scalars."""
    import torch
    ref_st, got_st = ref[0], got[0]
    bad = []
    for f in ref_st._fields:
        a, b = getattr(ref_st, f), getattr(got_st, f)
        if a is None or b is None:
            if (a is None) != (b is None):
                bad.append(f)
        elif a.dtype != b.dtype or not torch.equal(a.cpu(), b.cpu()):
            bad.append(f)
    for name, a, b in zip(("gbest", "it", "pool_head", "stopped"),
                          ref[1:], got[1:]):
        if int(a) != int(b):
            bad.append(name)
    return bad
