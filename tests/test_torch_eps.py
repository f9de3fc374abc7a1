"""`eps.decompose` in batches (`repro_torch/core/eps.py`): the pool it
returns equals, row for row, that of the widest-first loop that splits
one subproblem per propagation (`list_decompose`, kept here as the
reference), at every batch size, on RCPSP at J30 and J60, N-queens, an
int64 model, table models and an UNSAT root, under every variable and
value strategy; the trace's counts of splits taken and propagated; and on
the card, every batch of a J120 decomposition one few-lane launch.

This file imports neither JAX nor the JAX package, so it also runs on a
machine with a CUDA card, where the card's test runs instead of
skipping:

    PYTHONPATH=src python -m pytest -q tests/test_torch_eps.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import eps
from repro_torch.core import search as S
from repro_torch.core import trace
from repro_torch.core.backend import get_backend
from repro_torch.core.model import Model
from repro_torch.core.models import ZOO, nqueens, rcpsp, small_instance

BATCHES = (1, 2, 7, 66)
VARS = (S.INPUT_ORDER, S.MIN_DOM, S.MIN_LB)
VALS = (S.VAL_MIN, S.VAL_SPLIT, S.VAL_MIDDLE_OUT)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def list_decompose(cm, target, opts):
    """The widest-first loop one split per propagation, as `decompose`
    ran before its batches, the stores on the model's device: the pool
    and the number of splits."""
    backend = get_backend(opts.backend)

    def prop(lbs, ubs):
        nlb, nub, _, _ = backend.fixpoint_batch(
            cm, torch.from_numpy(lbs).to(cm.device),
            torch.from_numpy(ubs).to(cm.device))
        return nlb.cpu().numpy(), nub.cpu().numpy()

    lb, ub = prop(cm.lb0.cpu().numpy()[None], cm.ub0.cpu().numpy()[None])
    lb, ub = lb[0], ub[0]
    if (lb > ub).any():
        return (lb[None], ub[None]), 0
    bv = cm.branch_vars.cpu().numpy()

    def width(l, u):
        return int((u - l)[bv].clip(min=0).sum())

    frontier, widths, leaves, splits = [(lb, ub)], [width(lb, ub)], [], 0
    while frontier and len(frontier) + len(leaves) < target:
        i = int(np.argmax(widths))
        l, u = frontier.pop(i)
        widths.pop(i)
        unf = l[bv] < u[bv]
        if not unf.any():
            leaves.append((l, u))
            continue
        big = np.iinfo(l.dtype).max // 4
        if opts.var_strategy == S.MIN_DOM:
            v = int(bv[int(np.argmin(np.where(unf, u[bv] - l[bv], big)))])
        elif opts.var_strategy == S.MIN_LB:
            v = int(bv[int(np.argmin(np.where(unf, l[bv], big)))])
        else:
            v = int(bv[int(np.argmax(unf))])
        m = int(l[v]) if opts.val_strategy == S.VAL_MIN \
            else int((l[v] + u[v]) // 2)
        cl, cu = np.stack([l, l]), np.stack([u, u])
        cu[0, v] = min(cu[0, v], m)
        cl[1, v] = max(cl[1, v], m + 1)
        nlb, nub = prop(cl, cu)
        splits += 1
        for k in range(2):
            if not (nlb[k] > nub[k]).any():
                frontier.append((nlb[k], nub[k]))
                widths.append(width(nlb[k], nub[k]))
    pool = frontier + leaves
    if not pool:
        bad_l, bad_u = lb.copy(), ub.copy()
        bad_l[0], bad_u[0] = 1, 0
        pool = [(bad_l, bad_u)]
    return (np.stack([p[0] for p in pool]),
            np.stack([p[1] for p in pool])), splits


def _unsat():
    """x = y and x + y = 1 over {0, 1}: the root propagates, both of its
    children fail."""
    m = Model("unsat")
    x, y = m.int_var(0, 1), m.int_var(0, 1)
    m.add(x - y <= 0)
    m.add(y - x <= 0)
    m.add(x + y <= 1)
    m.add(x + y >= 1)
    return m


def _rcpsp(n, seed, scale=1):
    inst = rcpsp.generate(n, 4, seed=seed)
    inst = dataclasses.replace(inst, durations=inst.durations * scale)
    return rcpsp.build_model(inst)[0]


def _zoo(name):
    return ZOO[name].build_model(small_instance(name))[0]


# name: (model, target); what each brings: J30 and J60 the two Cumulative
# banks' widths, N-queens 8 failed children, N-queens 6 failed children
# and leaves until the frontier empties, J30 × 10⁷ int64 stores, the
# configuration model (Compact-Table) and knapsack leaves, `unsat` an
# UNSAT root
MODELS = {
    "j30": (lambda: _rcpsp(30, 0), 48),
    "j60": (lambda: _rcpsp(60, 1), 12),
    "nqueens8": (lambda: nqueens.build_model(nqueens.generate(8))[0], 128),
    "nqueens6": (lambda: nqueens.build_model(nqueens.generate(6))[0], 64),
    "int64": (lambda: _rcpsp(30, 0, scale=10 ** 7), 8),
    "configuration": (lambda: _zoo("configuration"), 64),
    "knapsack": (lambda: _zoo("knapsack"), 64),
    "unsat": (_unsat, 8),
}


def _decompose(cm, target, opts, batch):
    """`eps._decompose` at `batch` under a trace of its own: the pool and
    the trace."""
    tr = trace.SolveTrace("eps.host")
    with trace.active(tr):
        pool = eps._decompose(cm, target, opts, batch)
    tr.pause()
    return pool, tr


@pytest.mark.parametrize("val", VALS)
@pytest.mark.parametrize("var", VARS)
@pytest.mark.parametrize("name", sorted(MODELS))
def test_batched_pool_equals_the_one_split_loop(name, var, val):
    """Every batch size gives the one-split loop's pool row for row
    (dtype too) and takes its splits; the batches propagate no fewer."""
    build, target = MODELS[name]
    cm = build().compile(device="cpu")
    if name == "int64":
        assert cm.dtype == "int64"
    opts = S.SearchOptions(backend="gather", var_strategy=var,
                           val_strategy=val)
    ref, splits = list_decompose(cm, target, opts)
    for batch in BATCHES:
        got, tr = _decompose(cm, target, opts, batch)
        for r, g in zip(ref, got):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r, err_msg=f"batch {batch}")
        assert tr.tallies["eps.splits"] == splits, batch
        assert tr.tallies["eps.spec"] >= splits
        if batch == 1:
            assert tr.tallies["eps.spec"] == splits


def test_the_cases_cover_failures_leaves_and_an_unsat_root():
    """The models above split into failed children (fewer rows than a
    pool of no failure, one more than the splits), reach leaves (every
    branch variable fixed), and one fails at every child of its root."""
    opts = S.SearchOptions(backend="gather")
    for name in ("nqueens8", "nqueens6", "knapsack", "unsat"):
        build, target = MODELS[name]
        cm = build().compile(device="cpu")
        (lb, ub), splits = list_decompose(cm, target, opts)
        fixed = (lb == ub)[:, cm.branch_vars.numpy()].all(axis=1)
        if name != "knapsack":
            assert lb.shape[0] < splits + 1, name
        if name in ("nqueens6", "knapsack"):
            assert fixed.any(), name
    assert lb.shape[0] == 1 and lb[0, 0] > ub[0, 0]     # the UNSAT root


@pytest.mark.parametrize("batch", [1, 7])
def test_counts_and_launches_of_a_solve(batch, monkeypatch):
    """Under ``cuda`` on the CPU (the kernel wrapper's plain version) a
    solve's trace holds the splits of the one-split loop; one launch
    for the root and one per batch, each with its staging and its wait;
    at a batch of one, one launch per split."""
    from repro_torch import solver
    cm = _rcpsp(16, 0).compile(device="cpu")
    cfg = solver.SolveConfig.preset("prove", backend="cuda", device="cpu",
                                    n_lanes=8, eps_target=64)
    _, splits = list_decompose(cm, 64, cfg.search_options())
    monkeypatch.setattr(eps, "batch_size", lambda device: batch)
    res = solver.Solver(cfg).solve(cm)
    tr = res.trace
    assert tr.tallies["eps.splits"] == splits > 8
    launches = tr.count("eps.launch")
    assert tr.count("eps.stage") == tr.count("eps.wait") == launches
    assert tr.count("eps.host") == launches + 1
    if batch == 1:
        assert tr.tallies["eps.spec"] == splits == launches - 1
    else:
        assert tr.tallies["eps.spec"] >= splits > launches - 1


def test_batch_size_by_device():
    assert eps.batch_size("cpu") == eps.batch_size(torch.device("cpu")) \
        == eps.CPU_BATCH


# ---- on the card only ------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the few-lane instance has no CPU "
                    "mode)")
    return torch.device("cuda")


def test_a_j120_decomposition_launches_few_lane_batches(cuda):
    """Every EPS launch of a J120 decomposition takes the few-lane
    instance, one per batch of up to half the SMs' splits, fewer than
    the splits; the pool equals the one-split loop's on the card."""
    from repro_torch.kernels import fixpoint_kernel as K
    cm = _rcpsp(120, 0).compile(device=cuda)
    opts = S.SearchOptions(backend="cuda", var_strategy=S.MIN_LB)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert eps.batch_size(cuda) == sms // 2
    eps.decompose(cm, 64, opts)                  # builds the kernel
    before = (K.fixpoint_cuda.launches, K.fixpoint_cuda.few_lane_launches)
    tr = trace.SolveTrace("eps.host")
    with trace.active(tr):
        got = eps.decompose(cm, 4096, opts)
    launches = K.fixpoint_cuda.launches - before[0]
    assert K.fixpoint_cuda.few_lane_launches - before[1] == launches
    assert launches == tr.count("eps.wait")
    splits = tr.tallies["eps.splits"]
    assert launches - 1 < splits
    assert splits <= tr.tallies["eps.spec"] <= (launches - 1) * (sms // 2)
    ref, ref_splits = list_decompose(cm, 4096, opts)
    assert ref_splits == splits
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)

