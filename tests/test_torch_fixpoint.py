"""The port's plain fixpoint (`repro_torch.core.fixpoint`) against JAX.

Identical tables (carried across with `from_arrays`), identical input
stores (`util.random_substores`, seeded numpy) → identical stores, per-lane
sweep counts and convergence flags, capped or not, against JAX's gather
`fixpoint_batch` and against the Pallas kernel run in interpret mode.
The stores are an integer lattice: equality is exact.

Also: the ``cuda`` backend takes the plain version on CPU tensors (and
counts no launch), and the sparse layouts, a Compact-Table model and a
carried bitset store propagate through both backends, equal to the
reference.  The kernel itself is held against the plain version in
``test_torch_kernel.py``; the Compact-Table bank in ``test_torch_table.py``.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import bitset as JB
from repro.core.fixpoint import fixpoint_batch as jfixpoint_batch
from repro.core.model import Model as JModel
from repro.core.models import rcpsp as jrcpsp
from repro.kernels.fixpoint_kernel import fixpoint_pallas
from repro_torch.core import bitset as TB
from repro_torch.core import fixpoint as TF
from repro_torch.core.backend import get_backend
from repro_torch.core.model import Model
from repro_torch.kernels import fixpoint_kernel as TK
from repro_torch.testing import random_substores as port_random_substores
from test_torch_compile import bench, j30, port_from_jax, small
from util import random_model, random_substores


def _jax_rcpsp(kw):
    m, _ = jrcpsp.build_model(jrcpsp.generate(**kw))
    return m.compile()


def _port_run(tcm, lbs, ubs, max_iters):
    out = TF.fixpoint_batch(tcm, torch.from_numpy(lbs),
                            torch.from_numpy(ubs), max_iters=max_iters)
    return [o.numpy() for o in out]


def _assert_equal_runs(ref, got):
    for name, r, g in zip(("lb", "ub", "sweeps", "converged"), ref, got):
        r = np.asarray(r)
        assert g.dtype == r.dtype, name
        np.testing.assert_array_equal(g, r, err_msg=name)


def _check_against_gather(jcm, lbs, ubs, max_iters):
    tcm = port_from_jax(jcm)
    ref = jfixpoint_batch(jcm, jnp.asarray(lbs), jnp.asarray(ubs),
                          max_iters=max_iters)
    got = _port_run(tcm, lbs, ubs, max_iters)
    _assert_equal_runs(ref, got)
    return got


RCPSP = [("small", small(1)), ("bench", bench(2)), ("j30", j30(0))]


@pytest.mark.parametrize("max_iters", [1, 2, None])
@pytest.mark.parametrize("tier,kw", RCPSP, ids=[t for t, _ in RCPSP])
def test_rcpsp_matches_jax_gather(tier, kw, max_iters):
    jcm = _jax_rcpsp(kw)
    lbs, ubs = random_substores(np.random.default_rng(11), jcm, 24)
    lb, ub, sweeps, conv = _check_against_gather(jcm, lbs, ubs, max_iters)
    if max_iters is not None:
        assert sweeps.max() <= max_iters
    else:
        assert conv.all()


@pytest.mark.parametrize("max_iters", [1, 2, None])
def test_random_linear_models_match_jax_gather(max_iters):
    for seed in range(6):
        rng = np.random.default_rng(seed)
        jcm = random_model(rng, n_vars=2 + seed, n_props=3 + 2 * seed) \
            .compile()
        lbs, ubs = random_substores(rng, jcm, 8)
        _check_against_gather(jcm, lbs, ubs, max_iters)


@pytest.mark.parametrize("max_sweeps", [1, 16384])
def test_rcpsp_matches_pallas_interpret(max_sweeps):
    """Per-lane sweep counts are what `fixpoint_pallas` returns in
    interpret mode (not tile-granular)."""
    jcm = _jax_rcpsp(small(0))
    lbs, ubs = random_substores(np.random.default_rng(5), jcm, 8)
    ref = fixpoint_pallas(jcm, jnp.asarray(lbs), jnp.asarray(ubs),
                          lane_tile=4, max_sweeps=max_sweeps, interpret=True)
    got = _port_run(port_from_jax(jcm), lbs, ubs, max_sweeps)
    _assert_equal_runs(ref, got)
    assert len(set(got[2].tolist())) > 1      # counts differ per lane


def test_port_random_substores_equals_the_test_helper():
    """`repro_torch.testing.random_substores` (what the card runs use)
    gives the same stores from the same seed as `util.random_substores`."""
    jcm = _jax_rcpsp(j30(0))
    tcm = port_from_jax(jcm)
    ref = random_substores(np.random.default_rng(4), jcm, 32)
    got = port_random_substores(np.random.default_rng(4), tcm, 32)
    for r, g in zip(ref, got):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


def test_single_store_fixpoint_is_one_lane_of_the_batch():
    tcm = port_from_jax(_jax_rcpsp(bench(0)))
    lbs, ubs = random_substores(np.random.default_rng(3), tcm, 4)
    blb, bub, bsw, bconv = _port_run(tcm, lbs, ubs, None)
    for i in range(4):
        lb, ub, sw, conv = TF.fixpoint(tcm, torch.from_numpy(lbs[i]),
                                       torch.from_numpy(ubs[i]))
        np.testing.assert_array_equal(lb.numpy(), blb[i])
        np.testing.assert_array_equal(ub.numpy(), bub[i])
        assert int(sw) == bsw[i] and bool(conv) == bconv[i]


def test_cuda_backend_on_cpu_tensors_takes_the_plain_version():
    tcm = port_from_jax(_jax_rcpsp(j30(1)))
    lbs, ubs = random_substores(np.random.default_rng(9), tcm, 16)
    before = TK.fixpoint_cuda.launches
    got = get_backend("cuda").fixpoint_batch(
        tcm, torch.from_numpy(lbs), torch.from_numpy(ubs), max_iters=4)
    assert TK.fixpoint_cuda.launches == before
    ref = _port_run(tcm, lbs, ubs, 4)
    _assert_equal_runs(ref, [o.numpy() for o in got])


def _alldiff_model():
    m = Model("ad")
    xs = [m.int_var(0, 3) for _ in range(4)]
    m.alldifferent(xs)
    return m


def test_unsupported_banks_raise():
    """Every bank propagates now (none is left to raise): the AllDifferent
    bank in both layouts, the sparse Cumulative layout, a Compact-Table
    model and a carried bitset store, on both backends, equal to the
    reference."""
    for layout in ("dense", "sparse"):
        cm = _alldiff_model().compile(device="cpu", bank_layout=layout)
        lb, ub = cm.lb0[None], cm.ub0[None]
        assert cm.ad_layout == layout
        for got in (TF.fixpoint_batch(cm, lb, ub),
                    get_backend("cuda").fixpoint_batch(cm, lb, ub)):
            assert torch.equal(got[0], lb) and torch.equal(got[1], ub)
    m, _ = jrcpsp.build_model(jrcpsp.generate(**small(0)))
    jcm = m.compile(bank_layout="sparse")
    sparse = port_from_jax(jcm)
    assert sparse.cu_layout == "sparse"
    lbs, ubs = random_substores(np.random.default_rng(2), jcm, 8)
    ref = jfixpoint_batch(jcm, jnp.asarray(lbs), jnp.asarray(ubs))
    for fn in (TF.fixpoint_batch, get_backend("cuda").fixpoint_batch):
        got = fn(sparse, torch.from_numpy(lbs), torch.from_numpy(ubs))
        _assert_equal_runs(ref, [o.numpy() for o in got])

    def table_model(cls):
        tm = cls("tab")
        ys = [tm.int_var(0, 3) for _ in range(2)]
        tm.table(ys, [(0, 1), (2, 3)])
        return tm

    jtab = table_model(JModel).compile()
    tcm = table_model(Model).compile(device="cpu")
    ref = jfixpoint_batch(jtab, jtab.lb0[None], jtab.ub0[None])
    for fn in (TF.fixpoint_batch, get_backend("cuda").fixpoint_batch):
        got = fn(tcm, tcm.lb0[None], tcm.ub0[None])
        _assert_equal_runs(ref, [o.numpy() for o in got])
    # a carried bitset store on a bounds-only model: normalize only
    jrc = m.compile()
    rc = port_from_jax(jrc)
    jdom = JB.from_bounds(jrc.lb0[None], jrc.ub0[None], jrc.dom_off,
                          jrc.n_words, track=jrc.dom_track)
    dom = TB.from_bounds(rc.lb0[None], rc.ub0[None], rc.dom_off, rc.n_words,
                         track=rc.dom_track.view(torch.int32))
    ref = jfixpoint_batch(jrc, jrc.lb0[None], jrc.ub0[None], dom=jdom)
    for fn in (TF.fixpoint_batch, get_backend("cuda").fixpoint_batch):
        got = fn(rc, rc.lb0[None], rc.ub0[None], dom=dom)
        assert len(got) == 5
        for r, g in zip(ref, got):
            r = np.asarray(r)
            np.testing.assert_array_equal(
                g.numpy(), r.view(np.int32) if r.dtype == np.uint32 else r)
