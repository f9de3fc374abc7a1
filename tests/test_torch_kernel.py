"""The Hopper kernels' wrappers, budgets and build, and — on a machine
with a CUDA GPU — each kernel against its plain version: `fixpoint_cuda`
against `fixpoint_batch`, `search_cuda` against `search_plain`.

Both kernels are also held to their plain versions on the Compact-Table
models (crossword, configuration, the hand cases of
`repro_torch.testing`) with and without a carried bitset store, and the
search kernel under ``middle_out``.

This file imports neither JAX nor the JAX package, so it also runs on the
GPU machine, where the kernel tests run instead of skipping:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernel.py

The stores are an integer lattice: each kernel must equal its plain
version exactly (stores, per-lane sweep counts and convergence flags;
for the search, every LaneState field, the bound, the superstep count,
the pool cursor and the stop flag), capped or not.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import fixpoint as F
from repro_torch.core import search as S
from repro_torch.core.backend import get_backend
from repro_torch.core.model import Model
from repro_torch.core.models import (ZOO, bench_instance, coloring, jobshop,
                                     large_instance, nqueens, rcpsp,
                                     small_instance)
from repro_torch.kernels import build
from repro_torch.kernels import fixpoint_kernel as K
from repro_torch.testing import (CT_HAND_MODELS, random_dom_stores,
                                 random_substores, search_diff,
                                 search_inputs)

torch.set_num_threads(1)      # tiny tensors: thread hand-offs cost more

SMALL = dict(n_tasks=5, n_resources=2, edge_prob=0.3)
BENCH = dict(n_tasks=8, n_resources=3, edge_prob=0.25)


def _rcpsp(kw, seed=0, device="cpu", **compile_kw):
    m, _ = rcpsp.build_model(rcpsp.generate(**kw, seed=seed))
    return m.compile(device=device, **compile_kw)


def _nqueens(n, device="cpu", **compile_kw):
    return nqueens.build_model(nqueens.generate(n))[0].compile(
        device=device, **compile_kw)


def _coloring_small(device="cpu"):
    inst = small_instance("coloring")
    return coloring.build_model(inst)[0].compile(device=device)


def _random_stores(cm, n, seed):
    """n stores made by random tells on the root box, on the model's
    device."""
    lbs, ubs = random_substores(np.random.default_rng(seed), cm, n)
    dev = cm.device
    return torch.from_numpy(lbs).to(dev), torch.from_numpy(ubs).to(dev)


def _alldiff_model():
    m = Model("ad")
    xs = [m.int_var(0, 3) for _ in range(4)]
    m.alldifferent(xs)
    return m


def _table_model():
    m = Model("tab")
    ys = [m.int_var(0, 3) for _ in range(2)]
    m.table(ys, [(0, 1), (2, 3)])
    return m


def _int64_model():
    m = Model("wide")
    x, y = m.int_var(0, 10 ** 8), m.int_var(0, 10 ** 8)
    m.add(1000 * x + 1000 * y <= 10 ** 9)
    return m


def test_shared_memory_budget():
    cm = _rcpsp(dict(n_tasks=60, n_resources=4))
    b = K.fit_smem(cm)
    P1, K1 = cm.vidx.shape
    C1, T = cm.cu_svar.shape
    assert b["total"] == 4 * (4 * cm.n_vars + 2 * P1 * (K1 + 1)
                              + C1 * cm.horizon + 5 * C1 * T + 2 * C1)
    assert b["total"] < K.SMEM_LIMIT_BYTES
    with pytest.raises(ValueError, match="shared memory per lane"):
        K.fit_smem(cm, limit_bytes=b["total"] - 1)


def test_alldiff_shared_memory_budget():
    """The AllDifferent part: yl, yu and the candidate pair ``[A+1, N]``
    and a fail flag per row (``alldiff_words`` in
    ``csrc/fixpoint_lane.cuh``); none for a model without the bank."""
    assert K.smem_budget(_rcpsp(SMALL))["alldiff"] == 0
    for cm in (_nqueens(32), _coloring_small()):
        A1, N = cm.ad_vars.shape
        b = K.fit_smem(cm)
        assert cm.n_alldiff == A1 - 1 > 0
        assert b["alldiff"] == 4 * (4 * A1 * N + A1)
        assert b["total"] == sum(v for k, v in b.items() if k != "total")
    assert K.smem_budget(_nqueens(32))["alldiff"] == 2064     # [4, 32]
    with pytest.raises(ValueError, match="alldiff 2,064"):
        K.fit_smem(_nqueens(32), limit_bytes=1024)


def test_sparse_shared_memory_budget():
    """A bank counts only what its layout uses (``alldiff_words`` and
    ``cumulative_words`` in ``csrc/fixpoint_lane.cuh``): pinned for the
    J120 class (sparse Cumulative, Mcu 408, 1024 event keys), N-queens
    256 (sparse AllDifferent, Mad 776, 1024 keys) and the dense J60 class
    (unchanged)."""
    j60 = _rcpsp(dict(n_tasks=60, n_resources=4))
    j120 = _rcpsp(dict(n_tasks=120, n_resources=4))
    q256 = _nqueens(256)
    assert (j60.cu_layout, j120.cu_layout, q256.ad_layout) == (
        "dense", "sparse", "sparse")
    assert (j120.cu_packed, q256.ad_packed) == (408, 776)
    assert K.sort_size(2 * 408) == K.sort_size(776) == 1024
    assert K.smem_budget(j60) == dict(stores=992, linear=23328, alldiff=0,
                                      cumulative=11000, table=0, dom=0,
                                      search=0, total=35320)
    # 3·1024 + 6·408 + 2·5 + 32 words
    assert K.smem_budget(j120) == dict(stores=1952, linear=89352,
                                       alldiff=0, cumulative=22248,
                                       table=0, dom=0, search=0,
                                       total=113552)
    # 3·1024 + 6·776 + 4 words; the dense Cumulative dummy stays
    assert K.smem_budget(q256) == dict(stores=4112, linear=72,
                                       alldiff=30928, cumulative=52,
                                       table=0, dom=0, search=0,
                                       total=35164)
    assert K.fit_smem(j120, resident=True)["total"] == 113552 + 4 * 304
    with pytest.raises(ValueError, match=r"cumulative 22,248 \(sparse: "
                       r"event keys 8,192, profile 4,096, task table"):
        K.fit_smem(j120, limit_bytes=100_000)
    with pytest.raises(ValueError, match=r"alldiff 30,928 \(sparse: "
                       r"sort keys 8,192, member indices 4,096"):
        K.fit_smem(q256, limit_bytes=30_000)


def _zoo(name, tier, device="cpu"):
    inst = tier(name, seed=0)
    return ZOO[name].build_model(inst)[0].compile(device=device)


def test_table_shared_memory_budget():
    """The Compact-Table part (``table_words`` in
    ``csrc/fixpoint_lane.cuh``: the members' support words ``[T+1, R,
    TW]``, the current tables ``[T+1, TW]``, the hull pair ``[T+1, R]``
    and the word candidates ``[T+1, R, W]``) and the carried store's
    ``2·V·W`` words (``dom_words``), pinned at the large tiers:
    crossword n=8 (T+1 17, R 8, W 1) and configuration k=24 (T+1 97, R
    2, W 6); a bounds-only model carrying a store pays only the store."""
    cw = _zoo("crossword", large_instance)
    cf = _zoo("configuration", large_instance)
    assert tuple(cw.ct_supp.shape) == (17, 8, 32, 1)
    assert tuple(cf.ct_supp.shape) == (97, 2, 192, 1)
    for cm in (cw, cf):
        T1, R, _, TW = cm.ct_supp.shape
        W = cm.n_words
        b = K.smem_budget(cm)
        assert b["table"] == 4 * (T1 * R * TW + T1 * TW + 2 * T1 * R
                                  + T1 * R * W)
        assert b["dom"] == 0
        assert K.smem_budget(cm, dom=True)["dom"] == 4 * 2 * cm.n_vars * W
    assert K.smem_budget(cw, dom=True) == dict(
        stores=1040, linear=72, alldiff=0, cumulative=52, table=2244,
        dom=520, search=0, total=3928)
    # 194 + 97 + 388 + 1164 words; 2·50·6 words carried
    assert K.smem_budget(cf, dom=True) == dict(
        stores=800, linear=792, alldiff=0, cumulative=52, table=7372,
        dom=2400, search=0, total=11416)
    assert K.fit_smem(cf, resident=True, dom=True)["total"] == 11416 + 1216
    with pytest.raises(ValueError, match=r"table 7,372 \(Compact-Table: "
                       r"member supports 776, current tables 388"):
        K.fit_smem(cf, limit_bytes=10_000, dom=True)
    q32 = _nqueens(32)
    assert K.smem_budget(q32, dom=True)["table"] == 0
    assert K.smem_budget(q32, dom=True)["dom"] == 4 * 2 * 33


def test_search_shared_memory_budget():
    cm = _rcpsp(dict(n_tasks=60, n_resources=4))
    plain = K.smem_budget(cm)
    b = K.fit_smem(cm, resident=True)
    assert plain["search"] == 0
    # csrc/search.cu: fixpoint words + THREADS + 32 + 16 scalars
    assert b["total"] == plain["total"] + 4 * (256 + 32 + 16)
    assert b["total"] < K.SMEM_LIMIT_BYTES
    with pytest.raises(ValueError, match="search_cuda: .* shared memory"):
        K.fit_smem(cm, limit_bytes=b["total"] - 1, resident=True)
    K.fit_smem(cm, limit_bytes=plain["total"])            # fixpoint fits


def _scaled_rcpsp(n_tasks, scale=10 ** 7, device="cpu", **compile_kw):
    """The RCPSP J-n class with every duration × `scale` (int64)."""
    inst = rcpsp.generate(n_tasks, n_resources=4, seed=0)
    inst = dataclasses.replace(inst, durations=inst.durations * scale)
    return rcpsp.build_model(inst)[0].compile(device=device, **compile_kw)


def test_int64_shared_memory_budget():
    """At int64 every value region takes 8 bytes and a sort key 16
    (``fixlane::smem_bytes``), int32 regions rounded up to 8: pinned for
    J120 × 10⁷ (sparse Cumulative, Mcu 408, 1024 event keys), which fits
    the 232,448-byte block with the resident scratch, and for the J60
    class forced to int64 in the dense layout (the formula)."""
    j120 = _scaled_rcpsp(120)
    assert (j120.dtype, j120.cu_layout, j120.cu_packed) == (
        "int64", "sparse", 408)
    # event keys 1024·16, profile 1024·8, task table 2·408·4 + 2·408·8,
    # candidates 2·408·8, row flags 5·8 + 24, scan 32·8
    assert K.bank_bytes(j120)["cumulative"] == {
        "event keys": 16384, "profile": 8192, "task table": 9792,
        "candidates": 6528, "row flags": 64, "scan": 256}
    assert K.smem_budget(j120) == dict(stores=3904, linear=178704,
                                       alldiff=0, cumulative=41216,
                                       table=0, dom=0, search=0,
                                       total=223824)
    assert K.fit_smem(j120, resident=True)["total"] == 223824 + 4 * 304
    assert K.fit_smem(j120, resident=True)["total"] < K.SMEM_LIMIT_BYTES
    j60 = _rcpsp(dict(n_tasks=60, n_resources=4), force_dtype="int64",
                 bank_layout="dense")
    P1, K1 = j60.vidx.shape
    C1, T = j60.cu_svar.shape
    assert j60.dtype == "int64" and j60.cu_layout == "dense"
    assert K.fit_smem(j60)["total"] == (
        8 * (4 * j60.n_vars + 2 * P1 * (K1 + 1) + C1 * j60.horizon
             + 4 * C1 * T + C1) + -(-4 * C1 * T // 8) * 8 + 8 * -(-C1 // 2))
    with pytest.raises(ValueError, match=r"\(int64\) needs 223,824 bytes"):
        K.fit_smem(j120, limit_bytes=200_000)


def _search_setup(kw, n_lanes, eps_target, device="cpu", seed=0, **opt_kw):
    cm = _rcpsp(kw, seed=seed, device=device)
    opts = S.SearchOptions(var_strategy="min_lb", max_depth=64, **opt_kw)
    return cm, search_inputs(cm, n_lanes, eps_target, opts)


def test_search_wrapper_checks():
    """What `search_cuda` refuses before it launches (checked on CPU
    tensors; on the card the same checks guard the launch)."""
    cm, (slb, sub, st, gbest, head) = _search_setup(SMALL, 4, 8)
    K._check_search(cm, slb, sub, st, "min_lb", "split")      # accepted
    tiled = K.search_cuda(cm, slb, sub, st, gbest, 0, head, lane_tile=2)
    assert search_diff(K.search_plain(cm, slb, sub, st, gbest, 0, head,
                                      lane_tile=2), tiled) == []
    assert tuple(tiled[3].shape) == (2,)                 # a cursor per tile
    wide = _int64_model().compile(device="cpu")
    wst = S.init_lanes(wide, 2, S.SearchOptions(max_depth=4))
    K._check_search(wide, wide.lb0[None], wide.ub0[None], wst,
                    "min_lb", "min")                       # int64 accepted
    with pytest.raises(TypeError, match="int64"):
        K._check_search(wide, wide.lb0[None], wide.ub0[None],
                        wst._replace(lb=wst.lb.int(), ub=wst.ub.int()),
                        "min_lb", "min")
    with pytest.raises(ValueError, match="pool must be int64"):
        K._check_search(wide, wide.lb0[None].int(), wide.ub0[None].int(),
                        wst, "min_lb", "min")
    meta = torch.device("meta")          # a device other than the state's
    with pytest.raises(ValueError, match="pool on meta"):
        K._check_search(cm, slb.to(meta), sub.to(meta), st, "min_lb",
                        "min")
    with pytest.raises(ValueError, match="LaneState.depth on meta"):
        K._check_search(cm, slb, sub, st._replace(depth=st.depth.to(meta)),
                        "min_lb", "min")
    with pytest.raises(ValueError, match="LaneState.done must be"):
        K._check_search(cm, slb, sub, st._replace(done=st.done.int()),
                        "min_lb", "min")
    with pytest.raises(ValueError, match="pool must be int32"):
        K._check_search(cm, slb.long(), sub.long(), st, "min_lb", "min")
    with pytest.raises(ValueError, match="var_strategy"):
        K._check_search(cm, slb, sub, st, "first_fail", "min")
    with pytest.raises(ValueError, match="middle_out needs the bitset"):
        K._check_search(cm, slb, sub, st, "min_lb", "middle_out")
    mo = S.init_lanes(cm, 4, S.SearchOptions(val_strategy="middle_out",
                                             max_depth=64))
    K._check_search(cm, slb, sub, mo, "min_lb", "middle_out")  # accepted
    with pytest.raises(ValueError, match="both given or both None"):
        K._check_search(cm, slb, sub, mo._replace(root_dom=None), "min_lb",
                        "middle_out")
    with pytest.raises(ValueError, match="LaneState.dom must be"):
        K._check_search(cm, slb, sub, mo._replace(dom=mo.dom.long()),
                        "min_lb", "middle_out")
    with pytest.raises(ValueError, match="no lanes"):
        K._check_search(cm, slb, sub, S.LaneState(
            *(None if a is None else a[:0] for a in st)), "min_lb", "min")


@pytest.mark.parametrize("supersteps", [1, 16])
def test_search_cpu_tensors_take_the_plain_version(supersteps):
    cm, (slb, sub, st, gbest, head) = _search_setup(BENCH, 8, 16, seed=3)
    before = K.search_cuda.launches
    got = K.search_cuda(cm, slb, sub, st, gbest, 0, head,
                        supersteps=supersteps, var_strategy="min_lb")
    ref = K.search_plain(cm, slb, sub, st, gbest, 0, head,
                         supersteps=supersteps, var_strategy="min_lb")
    assert search_diff(ref, got) == []
    assert K.search_cuda.launches == before
    assert int(got[2]) == supersteps and int(got[3]) > 0
    assert int(S.lane_totals(got[0])["n_nodes"]) > 0
    assert get_backend("cuda_resident").name == "cuda_resident"


def test_wrapper_checks():
    """What the wrapper refuses before it launches (checked here on CPU
    tensors; on the card the same checks guard the launch)."""
    cm = _rcpsp(SMALL)
    lb, ub = _random_stores(cm, 4, 0)
    K._check(cm, lb, ub)                                   # accepted
    with pytest.raises(TypeError, match="int32"):
        K._check(cm, lb.long(), ub.long())
    with pytest.raises(ValueError, match=r"\[L, "):
        K._check(cm, lb[:, :-1], ub[:, :-1])
    with pytest.raises(ValueError, match="contiguous"):
        K._check(cm, lb.t().contiguous().t(), ub.t().contiguous().t())
    wide = _int64_model().compile(device="cpu")
    assert wide.dtype == "int64"
    K._check(wide, wide.lb0[None], wide.ub0[None])       # int64 accepted
    with pytest.raises(TypeError, match="int64"):
        K._check(wide, wide.lb0[None].int(), wide.ub0[None].int())
    for layout in ("dense", "sparse"):                  # both accepted
        ad = _alldiff_model().compile(device="cpu", bank_layout=layout)
        K._check(ad, ad.lb0[None], ad.ub0[None])
    tab = _table_model().compile(device="cpu")
    K._check(tab, tab.lb0[None], tab.ub0[None])        # tables accepted
    dom = torch.zeros((1, tab.n_vars, tab.n_words), dtype=torch.int32)
    K._check(tab, tab.lb0[None], tab.ub0[None], dom)    # and a store
    with pytest.raises(ValueError, match="bitset store must be int32"):
        K._check(tab, tab.lb0[None], tab.ub0[None], dom.long())
    with pytest.raises(ValueError, match="bitset store must be int32"):
        K._check(tab, tab.lb0[None], tab.ub0[None], dom[:, :-1])


def test_cpu_tensors_take_the_plain_version():
    cm = _rcpsp(BENCH, seed=3)
    lb, ub = _random_stores(cm, 16, 1)
    before = K.fixpoint_cuda.launches
    for cap in (1, 4, None):
        got = K.fixpoint_cuda(cm, lb, ub, max_sweeps=cap)
        ref = F.fixpoint_batch(cm, lb, ub, max_iters=cap)
        for r, g in zip(ref, got):
            assert torch.equal(r, g)
    assert K.fixpoint_cuda.launches == before
    be = get_backend("cuda")
    assert be.name == "cuda"
    with pytest.raises(ValueError, match="unknown propagation backend"):
        get_backend("pallas")


def test_build_names_and_missing_nvcc(monkeypatch, tmp_path):
    for name in ("fixpoint", "search"):
        lib = build._target(name)
        assert lib.parent == build.BUILD_DIR and lib.suffix == ".so"
        assert lib.name.startswith(f"lib{name}_")
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    # each variant its own library: int64 and lane tiles, of either source
    assert build.variant("int32") == "" and build.variant("int64") == "i64"
    assert build.variant("int64", tiles=True) == "tiles_i64"
    names = {build._target(n, v).name for n in ("fixpoint", "search")
             for v in build.VARIANTS}
    assert len(names) == 8
    assert build._target("search", "tiles_i64").name.startswith(
        "libsearch_tiles_i64_")
    # the name covers the shared header: editing it rebuilds both
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in build.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    before = [build._target(n) for n in ("fixpoint", "search")]
    header = csrc / "fixpoint_lane.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = [build._target(n) for n in ("fixpoint", "search")]
    assert all(a != b for a, b in zip(before, after))
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()


# ---- on the card only: the kernel against its plain version ---------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _gpu_models(device):
    """(model, seed) of the card-only tests: RCPSP (ReifLinLe and dense
    Cumulative) and N-queens 8 and coloring small (dense AllDifferent);
    then forced-sparse compiles: RCPSP J30 class and jobshop small
    (sparse Cumulative), N-queens 9 (sparse AllDifferent), and N-queens
    36 (sparse by the crossover)."""
    for kw, seed in ((SMALL, 0), (BENCH, 1), (dict(n_tasks=30), 0),
                     (dict(n_tasks=60), 2)):
        yield _rcpsp(kw, seed=seed, device=device), seed
    yield _nqueens(8, device=device), 3
    yield _coloring_small(device=device), 4
    yield _rcpsp(dict(n_tasks=30), seed=0, device=device,
                 bank_layout="sparse"), 5
    yield _nqueens(9, device=device, bank_layout="sparse"), 6
    yield _nqueens(36, device=device), 7
    js = jobshop.build_model(small_instance("jobshop"))[0]
    yield js.compile(device=device, bank_layout="sparse"), 8


@pytest.mark.parametrize("max_sweeps", [1, 4, None])
def test_kernel_matches_plain_on_gpu(cuda, max_sweeps):
    for cm, seed in _gpu_models(cuda):
        lb, ub = _random_stores(cm, 256, seed)
        before = K.fixpoint_cuda.launches
        got = K.fixpoint_cuda(cm, lb, ub, max_sweeps=max_sweeps)
        torch.cuda.synchronize()
        assert K.fixpoint_cuda.launches == before + 1
        ref = F.fixpoint_batch(cm, lb, ub, max_iters=max_sweeps)
        for r, g in zip(ref, got):
            assert torch.equal(r, g)


def test_kernel_raises_on_unsupported_input_on_gpu(cuda):
    tab = _table_model().compile(device=cuda)
    with pytest.raises(ValueError):
        K.fixpoint_cuda(tab, tab.lb0[None], tab.ub0[None],
                        torch.zeros((1, tab.n_vars, tab.n_words + 1),
                                    dtype=torch.int32, device=cuda))
    wide = _int64_model().compile(device=cuda)
    lb, ub = _random_stores(wide, 64, 9)
    for r, g in zip(F.fixpoint_batch(wide, lb, ub),
                    K.fixpoint_cuda(wide, lb, ub)):     # the int64 kernel
        assert torch.equal(r, g)
    with pytest.raises(TypeError):
        K.fixpoint_cuda(wide, lb.int(), ub.int())
    cm = _rcpsp(SMALL, device=cuda)
    with pytest.raises(TypeError):
        K.fixpoint_cuda(cm, cm.lb0[None].long(), cm.ub0[None].long())
    with pytest.raises(ValueError):
        K.fixpoint_cuda(cm, cm.lb0[None], cm.ub0[None].cpu())
    lb, ub, sw, conv = K.fixpoint_cuda(cm, cm.lb0[None][:0],
                                       cm.ub0[None][:0])
    assert lb.shape[0] == 0 and sw.shape == (0,)


def _search_cases(device):
    """(what, cm, inputs, kwargs) at J30 class, and on N-queens 8 and
    coloring small, and on forced-sparse J30 and N-queens 9: from fresh
    lanes and from the state after 5 plain
    supersteps, under prove, the capped fixpoint and stop_on_first."""
    opts = S.SearchOptions(var_strategy="min_lb", max_depth=64)
    models = [("j30", _rcpsp(dict(n_tasks=30), device=device), 512),
              ("nqueens8", _nqueens(8, device=device), 256),
              ("coloring", _coloring_small(device=device), 64),
              ("j30 sparse", _rcpsp(dict(n_tasks=30), device=device,
                                    bank_layout="sparse"), 512),
              ("nqueens9 sparse", _nqueens(9, device=device,
                                           bank_layout="sparse"), 256)]
    for name, cm, target in models:
        slb, sub, st, gbest, head = search_inputs(cm, 128, target, opts)
        for what, kw in (("prove", {}),
                         ("capped", dict(max_fixpoint_iters=4)),
                         ("first", dict(stop_on_first=True))):
            kw = dict(var_strategy="min_lb", **kw)
            yield (f"{name} {what} fresh", cm,
                   (slb, sub, st, gbest, 0, head), kw)
            st5, g5, it5, h5, _ = K.search_plain(cm, slb, sub, st, gbest, 0,
                                                 head, supersteps=5, **kw)
            yield (f"{name} {what} after 5", cm,
                   (slb, sub, st5, g5, it5, h5), kw)


@pytest.mark.parametrize("supersteps", [1, 16])
def test_search_kernel_matches_plain_on_gpu(cuda, supersteps):
    for what, cm, args, kw in _search_cases(cuda):
        ref = K.search_plain(cm, *args, supersteps=supersteps, **kw)
        before = K.search_cuda.launches
        got = K.search_cuda(cm, *args, supersteps=supersteps, **kw)
        torch.cuda.synchronize()
        assert K.search_cuda.launches == before + 1
        assert search_diff(ref, got) == [], what


def test_search_kernel_raises_on_unsupported_input_on_gpu(cuda):
    cm, (slb, sub, st, gbest, head) = _search_setup(SMALL, 4, 8,
                                                    device=cuda)
    with pytest.raises(ValueError):
        K.search_cuda(cm, slb.cpu(), sub.cpu(), st, gbest, 0, head)
    assert search_diff(
        K.search_plain(cm, slb, sub, st, gbest, 0, head, lane_tile=2),
        K.search_cuda(cm, slb, sub, st, gbest, 0, head, lane_tile=2)) == []
    wide = _int64_model().compile(device=cuda)
    wst = S.init_lanes(wide, 2, S.SearchOptions(max_depth=4))
    args = (wide, wide.lb0[None], wide.ub0[None], wst,
            torch.tensor(2 ** 40, dtype=torch.int64, device=cuda), 0, head)
    assert search_diff(K.search_plain(*args), K.search_cuda(*args)) == []
    with pytest.raises(TypeError):
        K.search_cuda(wide, wide.lb0[None], wide.ub0[None],
                      wst._replace(lb=wst.lb.int(), ub=wst.ub.int()),
                      args[4], 0, head)
    assert K.search_grid(cm, 4) == 4


def _table_models(device):
    """(what, model, seed) of the card-only Compact-Table tests: the zoo's
    table models at the small and bench tiers, crossword large, and the
    hand cases (a chain, a hole bounds cannot see, a wipeout, a mixed
    model, tables of more than 32 tuples)."""
    for name in ("crossword", "configuration"):
        for tag, tier in (("small", small_instance),
                          ("bench", bench_instance)):
            yield f"{name} {tag}", _zoo(name, tier, device), 11
    yield "crossword large", _zoo("crossword", large_instance, device), 12
    for name, make in CT_HAND_MODELS.items():
        yield name, make(Model).compile(device=device), 13


def _dom_stores(cm, n, seed):
    """n random stores and their random bitset stores (the first quarter
    wiping out a table's interior), on the model's device."""
    rng = np.random.default_rng(seed)
    lbs, ubs = random_substores(rng, cm, n)
    doms = random_dom_stores(rng, cm, lbs, ubs, n_wipe=n // 4)
    dev = cm.device
    return (torch.from_numpy(lbs).to(dev), torch.from_numpy(ubs).to(dev),
            torch.from_numpy(doms.view(np.int32)).to(dev))


@pytest.mark.parametrize("max_sweeps", [1, 4, None])
def test_table_kernel_matches_plain_on_gpu(cuda, max_sweeps):
    """Both modes: the carried store (5-tuple) and the transient range
    words (no `dom`), on random stores with random words."""
    for what, cm, seed in _table_models(cuda):
        lb, ub, dom = _dom_stores(cm, 256, seed)
        for d in (dom, None):
            before = K.fixpoint_cuda.launches
            got = K.fixpoint_cuda(cm, lb, ub, d, max_sweeps=max_sweeps)
            torch.cuda.synchronize()
            assert K.fixpoint_cuda.launches == before + 1
            ref = F.fixpoint_batch(cm, lb, ub, d, max_iters=max_sweeps)
            assert len(got) == len(ref) == (4 if d is None else 5)
            for r, g in zip(ref, got):
                assert torch.equal(r, g), (what, d is None)


def test_dom_on_bounds_only_models_matches_plain_on_gpu(cuda):
    """A carried store on models without tables (middle_out's case):
    the kernel normalizes only, equal to the plain version."""
    for cm, seed in ((_nqueens(8, device=cuda), 3),
                     (_rcpsp(SMALL, device=cuda), 4),
                     (_nqueens(36, device=cuda), 5)):
        lb, ub, dom = _dom_stores(cm, 128, seed)
        for cap in (1, None):
            got = K.fixpoint_cuda(cm, lb, ub, dom, max_sweeps=cap)
            ref = F.fixpoint_batch(cm, lb, ub, dom, max_iters=cap)
            for r, g in zip(ref, got):
                assert torch.equal(r, g)


def _dom_search_cases(device):
    """(what, cm, inputs, kwargs) with the bitset store: crossword and
    configuration bench (prove), N-queens 8 and coloring small under
    middle_out, from fresh lanes and after 5 plain supersteps."""
    cases = [("crossword bench", _zoo("crossword", bench_instance, device),
              "min"),
             ("configuration bench",
              _zoo("configuration", bench_instance, device), "middle_out"),
             ("nqueens8", _nqueens(8, device=device), "middle_out"),
             ("coloring", _coloring_small(device=device), "middle_out")]
    for what, cm, val in cases:
        opts = S.SearchOptions(var_strategy="min_dom", val_strategy=val,
                               max_depth=64)
        slb, sub, st, gbest, head = search_inputs(cm, 64, 128, opts)
        assert st.dom is not None
        kw = dict(var_strategy="min_dom", val_strategy=val)
        yield f"{what} fresh", cm, (slb, sub, st, gbest, 0, head), kw
        st5, g5, it5, h5, _ = K.search_plain(cm, slb, sub, st, gbest, 0,
                                             head, supersteps=5, **kw)
        yield f"{what} after 5", cm, (slb, sub, st5, g5, it5, h5), kw


@pytest.mark.parametrize("supersteps", [1, 16])
def test_search_kernel_with_dom_matches_plain_on_gpu(cuda, supersteps):
    for what, cm, args, kw in _dom_search_cases(cuda):
        ref = K.search_plain(cm, *args, supersteps=supersteps, **kw)
        before = K.search_cuda.launches
        got = K.search_cuda(cm, *args, supersteps=supersteps, **kw)
        torch.cuda.synchronize()
        assert K.search_cuda.launches == before + 1
        assert search_diff(ref, got) == [], what


def _int64_models(device):
    """(what, model, seed) of the card-only int64 tests, every bank at
    int64: the two-term row whose products pass 2³¹, RCPSP J30 × 10⁷
    (sparse Cumulative by the crossover), the RCPSP small and N-queens 8
    and 36 classes and coloring small forced to int64 (dense Cumulative
    and AllDifferent, sparse AllDifferent), and the Compact-Table hand
    cases forced to int64."""
    yield "wide", _int64_model().compile(device=device), 1
    yield "j30 x 1e7", _scaled_rcpsp(30, device=device), 2
    yield "small int64 dense", _rcpsp(SMALL, device=device,
                                      force_dtype="int64",
                                      bank_layout="dense"), 3
    yield "nqueens8 int64", _nqueens(8, device=device,
                                     force_dtype="int64"), 4
    yield "nqueens36 int64", _nqueens(36, device=device,
                                      force_dtype="int64"), 5
    cs = coloring.build_model(small_instance("coloring"))[0]
    yield "coloring int64", cs.compile(device=device, force_dtype="int64"), 6
    for name in ("holes", "wide"):
        yield (f"{name} table int64", CT_HAND_MODELS[name](Model).compile(
            device=device, force_dtype="int64"), 7)


@pytest.mark.parametrize("max_sweeps", [1, 4, None])
def test_int64_kernel_matches_plain_on_gpu(cuda, max_sweeps):
    for what, cm, seed in _int64_models(cuda):
        assert cm.dtype == "int64", what
        lb, ub = _random_stores(cm, 256, seed)
        doms = (None,)
        if cm.n_table:
            doms += (_dom_stores(cm, 256, seed)[2],)
        for dom in doms:
            before = K.fixpoint_cuda.launches
            got = K.fixpoint_cuda(cm, lb, ub, dom, max_sweeps=max_sweeps)
            torch.cuda.synchronize()
            assert K.fixpoint_cuda.launches == before + 1
            ref = F.fixpoint_batch(cm, lb, ub, dom, max_iters=max_sweeps)
            for r, g in zip(ref, got):
                assert torch.equal(r, g), what


def _int64_search_cases(device):
    """(what, cm, inputs, kwargs) at int64: J30 × 10⁷ and N-queens 8 and
    the RCPSP small class forced to int64, from fresh lanes and after 5
    plain supersteps."""
    opts = S.SearchOptions(var_strategy="min_lb", max_depth=64)
    for what, cm, target in (
            ("j30 x 1e7", _scaled_rcpsp(30, device=device), 512),
            ("nqueens8 int64", _nqueens(8, device=device,
                                        force_dtype="int64"), 256),
            ("small int64", _rcpsp(SMALL, device=device,
                                   force_dtype="int64"), 64)):
        slb, sub, st, gbest, head = search_inputs(cm, 128, target, opts)
        kw = dict(var_strategy="min_lb")
        yield f"{what} fresh", cm, (slb, sub, st, gbest, 0, head), kw
        st5, g5, it5, h5, _ = K.search_plain(cm, slb, sub, st, gbest, 0,
                                             head, supersteps=5, **kw)
        yield f"{what} after 5", cm, (slb, sub, st5, g5, it5, h5), kw


@pytest.mark.parametrize("supersteps", [1, 16])
def test_int64_search_kernel_matches_plain_on_gpu(cuda, supersteps):
    for what, cm, args, kw in _int64_search_cases(cuda):
        ref = K.search_plain(cm, *args, supersteps=supersteps, **kw)
        before = K.search_cuda.launches
        got = K.search_cuda(cm, *args, supersteps=supersteps, **kw)
        torch.cuda.synchronize()
        assert K.search_cuda.launches == before + 1
        assert search_diff(ref, got) == [], what


@pytest.mark.parametrize("lane_tile", [32, 48, 1])
def test_tiled_search_kernel_matches_plain_on_gpu(cuda, lane_tile):
    """Lane tiles of 32 (4 tiles of 128 lanes) and 48 (a short last
    tile) on the int32 cases and J30 × 10⁷, after 1 and 16 supersteps,
    and tiles of one lane on the first 8 lanes of each: every field, the
    ``[NT]`` cursors included."""
    cases = [c for c in _search_cases(cuda) if "prove" in c[0]
             or "first" in c[0]]
    cases += [c for c in _int64_search_cases(cuda) if "j30" in c[0]]
    for what, cm, args, kw in cases:
        if lane_tile == 1:
            st = S.LaneState(*(None if a is None else a[:8]
                               for a in args[2]))
            args, ks, n = args[:2] + (st,) + args[3:], (4,), 8
        else:
            ks, n = (1, 16), 128
        for k in ks:
            ref = K.search_plain(cm, *args, supersteps=k,
                                 lane_tile=lane_tile, **kw)
            got = K.search_cuda(cm, *args, supersteps=k,
                                lane_tile=lane_tile, **kw)
            torch.cuda.synchronize()
            assert got[3].shape == (-(-n // lane_tile),)
            assert search_diff(ref, got) == [], (what, k)
