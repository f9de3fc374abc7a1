"""The port's dense AllDifferent bank against the JAX package's.

Identical tables (carried across with `from_arrays`), identical input
stores (seeded numpy) → identical results, compared exactly (the stores
are an integer lattice):

* `alldiff_candidates_tile` (the bank's candidate tells) on N-queens 5
  and 8 and coloring small/bench, on random stores and on stores with
  tied endpoints, fixed members and a pigeonhole overflow (three queens
  in two columns; both ends of an edge on one colour); N-queens 5 and
  the coloring rows also carry padded members;
* `fixpoint_batch` per sweep (capped at 1, 2, 4) and uncapped against
  JAX's gather `fixpoint_batch`, and on N-queens 5 against the Pallas
  kernel `fixpoint_pallas` in interpret mode;
* `search_plain` against JAX `search_pallas(..., lane_tile=0,
  interpret=True)` on N-queens small and coloring small;
* the banks still to port raise, naming their ROADMAP sub-item: the
  sparse AllDifferent layout (1d), the sparse Cumulative layout (1e),
  Compact-Table (1f).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fixpoint as JF
from repro.core import models as jzoo
from repro.kernels import fixpoint_kernel as JFK
from repro_torch.core import fixpoint as TF
from repro_torch.core import models as tzoo
from repro_torch.core.backend import get_backend
from repro_torch.kernels import fixpoint_kernel as TFK
from repro_torch.testing import pigeonhole_stores
from test_torch_compile import port_from_jax
from test_torch_resident import _both
from test_torch_search import _assert_state_equal
from util import random_substores

torch.set_num_threads(1)      # tiny tensors: thread hand-offs cost more

MODELS = {
    "nqueens5": lambda: jzoo.nqueens.generate(5),
    "nqueens8": lambda: jzoo.nqueens.generate(8),
    "coloring_small": lambda: jzoo.small_instance("coloring"),
    "coloring_bench": lambda: jzoo.bench_instance("coloring"),
}


def _jax_model(name):
    mod = jzoo.ZOO[name.split("_")[0].rstrip("0123456789")]
    return mod.build_model(MODELS[name]())[0].compile()


def _row_members(cm, rng):
    """(vars, offsets, lb0, ub0) of the real members of a random row."""
    a = int(rng.integers(0, cm.n_alldiff))
    k = np.flatnonzero(np.asarray(cm.ad_mask)[a])
    return (np.asarray(cm.ad_vars)[a, k], np.asarray(cm.ad_offs)[a, k],
            np.asarray(cm.lb0), np.asarray(cm.ub0))


def _tied_stores(rng, cm, lbs, ubs):
    """Two members of a random row told into one shifted interval of
    width 2: equal endpoints, and a Hall interval that pushes the
    other members."""
    lbs, ubs = lbs.copy(), ubs.copy()
    for i in range(lbs.shape[0]):
        v, off, lb0, ub0 = _row_members(cm, rng)
        pick = rng.choice(len(v), size=2, replace=False)
        v, off = v[pick], off[pick]
        lo = int((lb0[v] + off).max())
        if lo + 1 <= int((ub0[v] + off).min()):
            lbs[i, v], ubs[i, v] = lo - off, lo + 1 - off
    return lbs, ubs


def _fixed_stores(rng, cm, lbs, ubs):
    """Some members of a random row fixed (lb == ub) to values in their
    root domains, distinct or not."""
    lbs, ubs = lbs.copy(), ubs.copy()
    for i in range(lbs.shape[0]):
        v, _, lb0, ub0 = _row_members(cm, rng)
        for x in v[:int(rng.integers(1, len(v) + 1))]:
            lbs[i, x] = ubs[i, x] = int(rng.integers(lb0[x], ub0[x] + 1))
    return lbs, ubs


def _stores(jcm, seed):
    """Random stores, then tied, fixed and pigeonhole variants of them."""
    rng = np.random.default_rng(seed)
    lbs, ubs = random_substores(rng, jcm, 16)
    tcm = port_from_jax(jcm)
    parts = [(lbs, ubs), _tied_stores(rng, jcm, lbs, ubs),
             _fixed_stores(rng, jcm, lbs, ubs),
             pigeonhole_stores(rng, tcm, lbs, ubs, 16)]
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_alldiff_tile_matches_jax(name):
    jcm = _jax_model(name)
    tcm = port_from_jax(jcm)
    assert jcm.ad_layout == "dense" and jcm.n_alldiff > 0
    lbs, ubs = _stores(jcm, 7)
    ref = JF.alldiff_candidates_tile(jnp.asarray(lbs), jnp.asarray(ubs),
                                     jcm.ad_vars, jcm.ad_offs, jcm.ad_mask)
    got = TF.alldiff_candidates_tile(torch.from_numpy(lbs),
                                     torch.from_numpy(ubs), tcm.ad_vars,
                                     tcm.ad_offs, tcm.ad_mask)
    for what, r, g in zip(("cand_lb", "cand_ub"), ref, got):
        r = np.asarray(r)
        assert g.dtype == torch.int32 and g.numpy().dtype == r.dtype, what
        np.testing.assert_array_equal(g.numpy(), r, err_msg=what)
    # the cases the stores were built for all occur
    big = np.iinfo(np.int32).max // 4
    off = np.asarray(jcm.ad_offs)[None]
    clb, cub = np.asarray(ref[0]), np.asarray(ref[1])
    assert (clb == big - off).any(), "no pigeonhole failure"
    assert ((clb > -big - off) & (clb != big - off)).any(), "no lb push"
    assert (cub < big - off).any(), "no ub push"
    padded = (np.asarray(jcm.ad_mask)[:-1] == 0).any()
    assert padded == (name != "nqueens8")     # N = 8 needs no padding


def _assert_equal_runs(ref, got, what):
    for name, r, g in zip(("lb", "ub", "sweeps", "converged"), ref, got):
        r = np.asarray(r)
        g = g.numpy()
        assert g.dtype == r.dtype, (what, name)
        np.testing.assert_array_equal(g, r, err_msg=f"{what} {name}")


@pytest.mark.parametrize("max_iters", [1, 2, 4, None])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_fixpoint_matches_jax_gather(name, max_iters):
    jcm = _jax_model(name)
    tcm = port_from_jax(jcm)
    lbs, ubs = _stores(jcm, 3)
    ref = JF.fixpoint_batch(jcm, jnp.asarray(lbs), jnp.asarray(ubs),
                            max_iters=max_iters)
    got = TF.fixpoint_batch(tcm, torch.from_numpy(lbs),
                            torch.from_numpy(ubs), max_iters=max_iters)
    _assert_equal_runs(ref, got, name)
    failed = (got[0] > got[1]).any(1)
    assert failed.any() and not failed.all()
    if max_iters is None:
        assert bool(got[3].all())
    else:
        assert int(got[2].max()) <= max_iters


@pytest.mark.parametrize("max_sweeps", [1, 16384])
def test_fixpoint_matches_pallas_interpret(max_sweeps):
    jcm = _jax_model("nqueens5")
    lbs, ubs = _stores(jcm, 5)
    ref = JFK.fixpoint_pallas(jcm, jnp.asarray(lbs), jnp.asarray(ubs),
                              lane_tile=8, max_sweeps=max_sweeps,
                              interpret=True)
    got = TF.fixpoint_batch(port_from_jax(jcm), torch.from_numpy(lbs),
                            torch.from_numpy(ubs), max_iters=max_sweeps)
    _assert_equal_runs(ref, got, f"pallas max_sweeps={max_sweeps}")


# name: (model, lanes, eps, warm supersteps, K, options)
SEARCH_CASES = {
    "nqueens_k1": ("nqueens", 8, 16, 0, 1, {}),
    "nqueens_k4": ("nqueens", 8, 16, 0, 4, {}),
    "nqueens_min_dom_split_warm": ("nqueens", 8, 16, 2, 4,
                                   dict(var_strategy="min_dom",
                                        val_strategy="split")),
    "coloring_k4_capped": ("coloring", 8, 16, 0, 4,
                           dict(var_strategy="min_lb",
                                max_fixpoint_iters=1)),
}


@pytest.mark.parametrize("case", sorted(SEARCH_CASES))
def test_search_plain_matches_search_pallas(case):
    model, lanes, target, warm, k, opt_kw = SEARCH_CASES[case]
    inst = jzoo.small_instance(model, seed=0)
    jcm = jzoo.ZOO[model].build_model(inst)[0].compile()
    jargs, targs = _both(jcm, lanes, target, warm, False, opt_kw)
    kw = dict(supersteps=k,
              max_fixpoint_iters=opt_kw.get("max_fixpoint_iters"),
              var_strategy=opt_kw.get("var_strategy", "input_order"),
              val_strategy=opt_kw.get("val_strategy", "min"))
    jst, jg, jit, jh, jstop = JFK.search_pallas(
        jcm, *jargs, lane_tile=0, interpret=True, **kw)
    tst, tg, tit, th, tstop = TFK.search_plain(port_from_jax(jcm), *targs,
                                               **kw)
    _assert_state_equal(jst, tst, case)
    assert (int(tg), int(tit), int(th), bool(tstop)) == \
        (int(jg), int(jit), int(jh[0]), bool(jstop))
    assert int(np.asarray(jst.n_nodes).sum()) > 0


def _port_model(name, inst, **compile_kw):
    return tzoo.ZOO[name].build_model(inst)[0].compile(device="cpu",
                                                       **compile_kw)


def _assert_raises_everywhere(cm, match):
    lb, ub = cm.lb0[None], cm.ub0[None]
    for fn in (TF.fixpoint_batch, get_backend("cuda").fixpoint_batch,
               lambda c, l, u: TFK._check(c, l, u)):
        with pytest.raises(NotImplementedError, match=match):
            fn(cm, lb, ub)


def test_banks_still_to_port_raise():
    q36 = _port_model("nqueens", tzoo.nqueens.generate(36))
    assert q36.ad_layout == "sparse" and q36.n_alldiff == 3
    _assert_raises_everywhere(q36, r"sparse AllDifferent .*1d")
    js = _port_model("jobshop", tzoo.large_instance("jobshop"))
    assert js.cu_layout == "sparse" and js.ad_layout == "dense"
    _assert_raises_everywhere(js, r"sparse Cumulative .*1e")
    for name in ("crossword", "configuration"):
        cm = _port_model(name, tzoo.small_instance(name))
        assert cm.n_table > 0
        _assert_raises_everywhere(cm, r"Compact-Table .*1f")
    # the largest dense N-queens propagates
    q32 = _port_model("nqueens", tzoo.nqueens.generate(32))
    assert q32.ad_layout == "dense"
    TF.fixpoint_batch(q32, q32.lb0[None], q32.ub0[None])
