"""Test inputs for the port, without JAX: `chip_smoke.py` and the kernel
tests use them on the card as well as on the CPU."""

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
