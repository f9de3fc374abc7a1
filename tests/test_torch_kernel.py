"""The Hopper kernels' wrappers, budgets and build, and — on a machine
with a CUDA GPU — each kernel against its plain version: `fixpoint_cuda`
against `fixpoint_batch`, `search_cuda` against `search_plain`.

This file imports neither JAX nor the JAX package, so it also runs on the
GPU machine, where the kernel tests run instead of skipping:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernel.py

The stores are an integer lattice: each kernel must equal its plain
version exactly (stores, per-lane sweep counts and convergence flags;
for the search, every LaneState field, the bound, the superstep count,
the pool cursor and the stop flag), capped or not.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import fixpoint as F
from repro_torch.core import search as S
from repro_torch.core.backend import get_backend
from repro_torch.core.model import Model
from repro_torch.core.models import coloring, nqueens, rcpsp, small_instance
from repro_torch.kernels import build
from repro_torch.kernels import fixpoint_kernel as K
from repro_torch.testing import random_substores, search_diff, search_inputs

torch.set_num_threads(1)      # tiny tensors: thread hand-offs cost more

SMALL = dict(n_tasks=5, n_resources=2, edge_prob=0.3)
BENCH = dict(n_tasks=8, n_resources=3, edge_prob=0.25)


def _rcpsp(kw, seed=0, device="cpu"):
    m, _ = rcpsp.build_model(rcpsp.generate(**kw, seed=seed))
    return m.compile(device=device)


def _nqueens(n, device="cpu"):
    return nqueens.build_model(nqueens.generate(n))[0].compile(device=device)


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


def _search_setup(kw, n_lanes, eps_target, device="cpu", seed=0, **opt_kw):
    cm = _rcpsp(kw, seed=seed, device=device)
    opts = S.SearchOptions(var_strategy="min_lb", max_depth=64, **opt_kw)
    return cm, search_inputs(cm, n_lanes, eps_target, opts)


def test_search_wrapper_checks():
    """What `search_cuda` refuses before it launches (checked on CPU
    tensors; on the card the same checks guard the launch)."""
    cm, (slb, sub, st, gbest, head) = _search_setup(SMALL, 4, 8)
    K._check_search(cm, slb, sub, st, "min_lb", "split")      # accepted
    with pytest.raises(NotImplementedError, match="lane_tile=0"):
        K.search_cuda(cm, slb, sub, st, gbest, 0, head, lane_tile=4)
    wide = _int64_model().compile(device="cpu")
    wst = S.init_lanes(wide, 2, S.SearchOptions(max_depth=4))
    with pytest.raises(NotImplementedError, match="int32-only"):
        K._check_search(wide, wide.lb0[None], wide.ub0[None], wst,
                        "min_lb", "min")
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
    with pytest.raises(NotImplementedError, match="middle_out"):
        K._check_search(cm, slb, sub, st, "min_lb", "middle_out")
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
    with pytest.raises(NotImplementedError, match="int32-only"):
        K._check(wide, wide.lb0[None], wide.ub0[None])
    ad = _alldiff_model().compile(device="cpu")
    K._check(ad, ad.lb0[None], ad.ub0[None])            # dense: accepted
    sparse = _alldiff_model().compile(device="cpu", bank_layout="sparse")
    with pytest.raises(NotImplementedError, match="sparse AllDifferent"):
        K._check(sparse, sparse.lb0[None], sparse.ub0[None])


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
    Cumulative) and N-queens 8 and coloring small (dense AllDifferent)."""
    for kw, seed in ((SMALL, 0), (BENCH, 1), (dict(n_tasks=30), 0),
                     (dict(n_tasks=60), 2)):
        yield _rcpsp(kw, seed=seed, device=device), seed
    yield _nqueens(8, device=device), 3
    yield _coloring_small(device=device), 4


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
    ad = _alldiff_model().compile(device=cuda, bank_layout="sparse")
    with pytest.raises(NotImplementedError):
        K.fixpoint_cuda(ad, ad.lb0[None], ad.ub0[None])
    wide = _int64_model().compile(device=cuda)
    with pytest.raises(NotImplementedError):
        K.fixpoint_cuda(wide, wide.lb0[None], wide.ub0[None])
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
    coloring small: from fresh lanes and from the state after 5 plain
    supersteps, under prove, the capped fixpoint and stop_on_first."""
    opts = S.SearchOptions(var_strategy="min_lb", max_depth=64)
    models = [("j30", _rcpsp(dict(n_tasks=30), device=device), 512),
              ("nqueens8", _nqueens(8, device=device), 256),
              ("coloring", _coloring_small(device=device), 64)]
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
    with pytest.raises(NotImplementedError):
        K.search_cuda(cm, slb, sub, st, gbest, 0, head, lane_tile=2)
    wide = _int64_model().compile(device=cuda)
    wst = S.init_lanes(wide, 2, S.SearchOptions(max_depth=4))
    with pytest.raises(NotImplementedError):
        K.search_cuda(wide, wide.lb0[None], wide.ub0[None], wst,
                      torch.zeros((), dtype=torch.int64, device=cuda), 0,
                      head)
    assert K.search_grid(cm, 4) == 4
