"""The port's compile (`repro_torch.core.compile`) against the JAX one.

Same model → identical table arrays (values and dtypes), statics and
`shape_signature`; `from_arrays` round-trips and carries a JAX compile
across unchanged.  The helpers here (`jax_arrays`, `port_from_jax`) are
shared by the other ``test_torch_*`` files.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core.models import bench_instance, small_instance
from repro.core.models import rcpsp as jrcpsp
from repro_torch.core import api as tapi
from repro_torch.core import compile as TC
from repro_torch.core.models import rcpsp as trcpsp

torch.set_num_threads(1)      # tiny tensors: thread hand-offs cost more


def jax_arrays(jcm):
    """A JAX `CompiledModel` as (host arrays, statics)."""
    arrays, statics = {}, {}
    for f in dataclasses.fields(jcm):
        v = getattr(jcm, f.name)
        if f.metadata.get("static"):
            statics[f.name] = v
        else:
            arrays[f.name] = np.asarray(v)
    return arrays, statics


def port_from_jax(jcm, device="cpu"):
    """The port's `CompiledModel` holding exactly the JAX tables."""
    arrays, statics = jax_arrays(jcm)
    return TC.from_arrays(arrays, statics, device)


def j30(seed=0):
    return dict(n_tasks=30, n_resources=4, seed=seed)


def j60(seed=0):
    return dict(n_tasks=60, n_resources=4, seed=seed)


def small(seed=0):
    return dict(n_tasks=5, n_resources=2, edge_prob=0.3, seed=seed)


def bench(seed=0):
    return dict(n_tasks=8, n_resources=3, edge_prob=0.25, seed=seed)


def both(kw, **compile_kw):
    """(JAX instance, JAX compile, port instance, port compile)."""
    ji = jrcpsp.generate(**kw)
    ti = trcpsp.generate(**kw)
    decompose = compile_kw.pop("decompose", False)
    jm, _ = jrcpsp.build_model(ji, decompose=decompose)
    tm, _ = trcpsp.build_model(ti, decompose=decompose)
    return ji, jm.compile(**compile_kw), ti, tm.compile(device="cpu",
                                                         **compile_kw)


def assert_same_compile(jcm, tcm):
    arrays, statics = jax_arrays(jcm)
    assert set(arrays) == set(TC.TENSOR_FIELDS)
    assert set(statics) == set(TC.STATIC_FIELDS)
    for name, ref in arrays.items():
        got = getattr(tcm, name).numpy()
        assert got.dtype == ref.dtype, name
        np.testing.assert_array_equal(got, ref, err_msg=name)
    for name, ref in statics.items():
        assert getattr(tcm, name) == ref, name
    assert tapi.shape_signature(tcm) == japi.shape_signature(jcm)


CASES = ([("small", small(s)) for s in range(3)]
         + [("bench", bench(s)) for s in range(3)]
         + [("j30", j30(s)) for s in range(3)]
         + [("j60", j60(s)) for s in range(3)])


@pytest.mark.parametrize("tier,kw", CASES,
                         ids=[f"{t}-s{kw['seed']}" for t, kw in CASES])
def test_compile_matches_jax(tier, kw):
    ji, jcm, ti, tcm = both(kw)
    np.testing.assert_array_equal(ji.durations, ti.durations)
    assert ji.precedences == ti.precedences
    assert tcm.device == torch.device("cpu")
    assert_same_compile(jcm, tcm)
    if tier in ("j30", "j60"):
        assert tcm.cu_layout == "dense" and tcm.dtype == "int32"


@pytest.mark.parametrize("layout", ["auto", "dense", "sparse"])
def test_compile_matches_jax_bank_layouts(layout):
    _, jcm, _, tcm = both(bench(1), bank_layout=layout)
    assert_same_compile(jcm, tcm)


def test_compile_matches_jax_decomposed():
    """The pre-native lowering (ReifLinLe rows only) compiles alike too."""
    _, jcm, _, tcm = both(small(2), decompose=True)
    assert tcm.n_cumulative == 0
    assert_same_compile(jcm, tcm)


def test_zoo_tiers_match_the_generator_kwargs():
    """The tier kwargs used above are the zoo's own small/bench tiers."""
    for tier, ref in ((small, small_instance), (bench, bench_instance)):
        for seed in range(3):
            a = jrcpsp.generate(**tier(seed))
            b = ref("rcpsp", seed=seed)
            np.testing.assert_array_equal(a.usage, b.usage)
            assert a.precedences == b.precedences


def test_from_arrays_round_trip():
    _, jcm, _, tcm = both(j30(1))
    carried = port_from_jax(jcm)
    assert_same_compile(jcm, carried)
    arrays, statics = TC.to_arrays(tcm)
    again = TC.from_arrays(arrays, statics, "cpu")
    assert_same_compile(jcm, again)
    assert again.to("cpu") is again
    with pytest.raises(ValueError, match="missing fields"):
        TC.from_arrays({k: v for k, v in arrays.items() if k != "vidx"},
                       statics, "cpu")


def test_bitset_host_helpers_match_jax():
    from repro.core import bitset as JB
    from repro_torch.core import bitset as TB
    assert TB.WORD_BITS == JB.WORD_BITS and TB.FULL == JB.FULL
    for w in (1, 31, 32, 33, 64, 100):
        assert TB.n_words_for(w) == JB.n_words_for(w)
    rng = np.random.default_rng(7)
    off = rng.integers(-5, 5, 6)
    lb = off + rng.integers(0, 40, 6)
    ub = lb + rng.integers(-1, 30, 6)
    track = rng.integers(0, 2, 6).astype(np.uint32)
    for n_words in (1, 2):
        dom = TB.np_from_bounds(lb, ub, off, n_words, track)
        np.testing.assert_array_equal(
            dom, JB.np_from_bounds(lb, ub, off, n_words, track))
        for fn in ("np_popcount", "np_count", "np_is_empty"):
            np.testing.assert_array_equal(getattr(TB, fn)(dom),
                                          getattr(JB, fn)(dom))
        for r, g in zip(JB.np_to_bounds(dom, off), TB.np_to_bounds(dom, off)):
            np.testing.assert_array_equal(g, r)
        for v in range(6):
            val = int(lb[v]) + 1
            assert TB.np_has_value(dom[v], val, int(off[v])) == \
                JB.np_has_value(dom[v], val, int(off[v]))
            np.testing.assert_array_equal(
                TB.np_clear_value(dom[v].copy(), val, int(off[v])),
                JB.np_clear_value(dom[v].copy(), val, int(off[v])))
