"""The port's scatter join strategy against the JAX package.

The scatter join strategy (`sweep_scatter`, `sweep_scatter_batch`,
`fixpoint_batch(use_scatter=True)`, the ``scatter`` backend) on every
bank, from identical tables (a JAX compile carried across with
`port_from_jax`) and identical seeded stores, compared exactly:

* the dense and the sparse AllDifferent and Cumulative banks (N-queens,
  RCPSP, jobshop, compiled ``dense`` and ``sparse``) and Compact-Table
  (crossword, configuration, the hand cases of `repro_torch.testing`)
  with a carried bitset store (random words with holes, some wiping out
  a table's interior) and with the transient one: one scatter sweep and
  the scatter fixpoint, capped at 1 sweep and uncapped, equal to JAX's,
  and to the port's own gather form.

The backends' single-store ``fixpoint()``, the kernel façade, the
oracle and an int64 model are in ``test_torch_scatter_ops.py``; whole
solves through the ``scatter`` backend in
``test_torch_scatter_solve.py``.  The models and helpers here are shared
with both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fixpoint as JF
from repro.core import models as jzoo
from repro.core.model import Model as JModel
from repro_torch.core import fixpoint as TF
from repro_torch.testing import CT_HAND_MODELS, random_dom_stores
from test_torch_compile import port_from_jax
from util import random_substores

torch.set_num_threads(1)      # small tensors: thread hand-offs cost more

CAPS = (1, None)
# the reference's vmapped scatter sweep, compiled once per model (its
# op-by-op vmap takes seconds a call)
jsweep_scatter_batch = jax.jit(JF.sweep_scatter_batch)


def _zoo(name, inst, **kw):
    return jzoo.ZOO[name].build_model(inst)[0].compile(**kw)


# name: JAX compile; each bank in each layout
MODELS = {
    "nqueens8 dense": lambda: _zoo("nqueens", jzoo.nqueens.generate(8, seed=0),
                                   bank_layout="dense"),
    "nqueens8 sparse": lambda: _zoo(
        "nqueens", jzoo.nqueens.generate(8, seed=0), bank_layout="sparse"),
    "rcpsp j30 dense": lambda: _zoo(
        "rcpsp", jzoo.rcpsp.generate(30, n_resources=4, seed=0),
        bank_layout="dense"),
    "rcpsp j30 sparse": lambda: _zoo(
        "rcpsp", jzoo.rcpsp.generate(30, n_resources=4, seed=0),
        bank_layout="sparse"),
    "jobshop sparse": lambda: _zoo("jobshop", jzoo.small_instance("jobshop"),
                                   bank_layout="sparse"),
    "coloring": lambda: _zoo("coloring", jzoo.small_instance("coloring")),
}
TABLE_MODELS = {
    "crossword": lambda: _zoo("crossword", jzoo.small_instance("crossword")),
    "configuration": lambda: _zoo("configuration",
                                  jzoo.bench_instance("configuration")),
    "chain": lambda: CT_HAND_MODELS["chain"](JModel).compile(),
    "mixed": lambda: CT_HAND_MODELS["mixed"](JModel).compile(),
    "wide": lambda: CT_HAND_MODELS["wide"](JModel).compile(),
}
_CACHE = {}


def _model(name):
    if name not in _CACHE:
        jcm = {**MODELS, **TABLE_MODELS}[name]()
        _CACHE[name] = (jcm, port_from_jax(jcm))
    return _CACHE[name]


def _eq(got, ref, what):
    ref = np.asarray(ref)
    if ref.dtype == np.uint32:
        ref = ref.view(np.int32)
    got = got.numpy()
    assert got.dtype == ref.dtype, what
    np.testing.assert_array_equal(got, ref, err_msg=what)


def _stores(jcm, seed=5, n=16):
    return random_substores(np.random.default_rng(seed), jcm, n)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_interval_banks_match_jax(name):
    """One scatter sweep per store and the scatter fixpoint (capped and
    uncapped) equal JAX's and the port's gather form."""
    jcm, cm = _model(name)
    assert (cm.ad_layout, cm.cu_layout) == (jcm.ad_layout, jcm.cu_layout)
    lbs, ubs = _stores(jcm)
    lb, ub = torch.from_numpy(lbs), torch.from_numpy(ubs)
    got = TF.sweep_scatter_batch(cm, lb, ub)
    ref = jsweep_scatter_batch(jcm, jnp.asarray(lbs), jnp.asarray(ubs))
    for g, r, k, alt in zip(got, ref, ("lb", "ub"),
                            TF.sweep_batch(cm, lb, ub)):
        _eq(g, r, f"sweep {k}")
        assert torch.equal(g, alt), f"gather sweep {k}"
    for i in (0, 3):
        one = TF.sweep_scatter(cm, lb[i], ub[i])
        assert torch.equal(one[0], got[0][i]) and torch.equal(one[1],
                                                              got[1][i])
    for cap in CAPS:
        got = TF.fixpoint_batch(cm, lb, ub, max_iters=cap, use_scatter=True)
        ref = JF.fixpoint_batch(jcm, jnp.asarray(lbs), jnp.asarray(ubs),
                                max_iters=cap, use_scatter=True)
        alt = TF.fixpoint_batch(cm, lb, ub, max_iters=cap)
        for g, r, a, k in zip(got, ref, alt,
                              ("lb", "ub", "sweeps", "converged")):
            _eq(g, r, f"{cap} {k}")
            assert torch.equal(g, a), f"{cap} {k}: gather form"


@pytest.mark.parametrize("carried", [True, False], ids=["carried",
                                                        "transient"])
@pytest.mark.parametrize("name", sorted(TABLE_MODELS))
def test_table_bank_matches_jax(name, carried):
    """Compact-Table under the scatter strategy, the bitset store carried
    (its join stays in gather form) or transient."""
    jcm, cm = _model(name)
    lbs, ubs = _stores(jcm)
    doms = (random_dom_stores(np.random.default_rng(6), cm, lbs, ubs,
                              n_wipe=4) if carried else None)
    jd = None if doms is None else jnp.asarray(doms)
    td = None if doms is None else torch.from_numpy(doms.view(np.int32))
    lb, ub = torch.from_numpy(lbs), torch.from_numpy(ubs)
    names = ("lb", "ub", "dom") if carried else ("lb", "ub")
    got = TF.sweep_scatter_batch(cm, lb, ub, td)
    ref = jsweep_scatter_batch(jcm, jnp.asarray(lbs), jnp.asarray(ubs), jd)
    alt = TF.sweep_batch(cm, lb, ub, td)
    for g, r, a, k in zip(got, ref, alt, names):
        _eq(g, r, f"sweep {k}")
        assert torch.equal(g, a), f"gather sweep {k}"
    if carried:
        one = TF.sweep_scatter(cm, lb[1], ub[1], td[1])
        assert all(torch.equal(o, g[1]) for o, g in zip(one, got))
    for cap in CAPS:
        got = TF.fixpoint_batch(cm, lb, ub, td, max_iters=cap,
                                use_scatter=True)
        ref = JF.fixpoint_batch(jcm, jnp.asarray(lbs), jnp.asarray(ubs), jd,
                                max_iters=cap, use_scatter=True)
        alt = TF.fixpoint_batch(cm, lb, ub, td, max_iters=cap)
        for g, r, a, k in zip(got, ref, alt,
                              names + ("sweeps", "converged")):
            _eq(g, r, f"{cap} {k}")
            assert torch.equal(g, a), f"{cap} {k}: gather form"
