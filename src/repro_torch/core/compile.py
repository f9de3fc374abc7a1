"""⟦.⟧ — lower a Model to dense guarded-command tables (paper Prop. 4).

Port of ``repro/core/compile.py``.  The lowering itself is numpy and is
kept line for line: the same typed propagator banks (ReifLinLe,
AllDifferent, Cumulative, Compact-Table), the same CSR packed views, the
same dense/sparse crossover (`_resolve_layout` and the tile-byte
estimators) and the same int32/int64 headroom choice.  Only the last step
differs: every table becomes a ``torch.Tensor`` on one explicit device
(`CompiledModel.device`).  JAX's ``jax_enable_x64`` gate has no torch
counterpart and is dropped.

Tables keep the model's integer dtype (the index tables included, as in
the reference), so the port and the JAX package hold identical arrays;
the plain sweep indexes with ``index_select``, which takes int32 indices,
and the CUDA kernel reads them as ``int32_t``.  `from_arrays` builds a
`CompiledModel` from numpy arrays plus statics — the way the tests carry
a JAX compile across so that both sides run on the very same tables.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.bitset import WORD_BITS, n_words_for
from repro_torch.core.device import resolve_device
from repro_torch.core.model import Model, ReifLinLe, TRUE_VAR


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---- dense-tile scratch estimates & layout crossover (DESIGN.md §16) ----
# Per-lane sweep scratch of the *dense* tiles, in bytes.  These are the
# allocations that explode with instance size (the bank tables themselves
# are O(model) and always emitted).  Above DENSE_TILE_MAX_BYTES the auto
# crossover flips the bank to the packed/segmented tile; a *forced* dense
# bank above DENSE_TILE_HARD_BYTES raises instead of OOMing inside
# the tensor library.  The same estimators feed the kernel's
# shared-memory budget (`kernels.fixpoint_kernel.smem_budget`).
DENSE_TILE_MAX_BYTES = 2 * 1024 * 1024
DENSE_TILE_HARD_BYTES = 64 * 1024 * 1024


def alldiff_dense_tile_bytes(n_alldiff: int, ad_width: int,
                             itemsize: int) -> int:
    """Per-lane scratch of `alldiff_candidates_tile`: the [A+1, N, N, N]
    `inside` tensor plus the cnt/width reductions (~3 live copies)."""
    if not n_alldiff:
        return 0
    return 3 * (n_alldiff + 1) * ad_width ** 3 * itemsize


def cumulative_dense_tile_bytes(n_cumulative: int, cu_width: int,
                                horizon: int, itemsize: int) -> int:
    """Per-lane scratch of `cumulative_candidates_tile`: the
    [C+1, T, horizon] run/contrib/feas grids (~4 live copies)."""
    if not n_cumulative:
        return 0
    return 4 * (n_cumulative + 1) * cu_width * horizon * itemsize


def alldiff_sparse_tile_bytes(ad_packed: int, itemsize: int) -> int:
    """Per-lane scratch of `alldiff_candidates_sparse_tile`: a handful of
    [M, M] pairwise tensors over the packed member axis (~6 live)."""
    return 6 * ad_packed ** 2 * itemsize


def cumulative_sparse_tile_bytes(cu_packed: int, itemsize: int) -> int:
    """Per-lane scratch of `cumulative_candidates_sparse_tile`: event
    arrays linear in M plus one [M, 2M] boolean overload reduction."""
    return (2 * cu_packed ** 2) + 16 * cu_packed * itemsize


def ct_tile_bytes(n_table: int, ct_arity: int, n_words: int,
                  ct_words: int) -> int:
    """Per-lane sweep scratch of `ct_candidates_tile` (DESIGN.md §17):
    the [T+1, R, 32W] member-value bits, the [T+1, R, 32W, TW] survivor
    intersection, and the OR-reduced support words (~3 live u32 copies).
    """
    if not n_table:
        return 0
    return 3 * (n_table + 1) * ct_arity * (32 * n_words) * ct_words * 4


def _resolve_layout(bank_layout: str, dense_bytes: int, kind: str,
                    name: str) -> str:
    """Pick this bank's tile layout; guard forced-dense explosions."""
    if dense_bytes == 0:        # bank absent — layout is inert
        return "dense"
    if bank_layout == "sparse":
        return "sparse"
    if bank_layout == "auto" and dense_bytes > DENSE_TILE_MAX_BYTES:
        return "sparse"
    # dense selected (forced, or auto under the crossover)
    if dense_bytes > DENSE_TILE_HARD_BYTES:
        raise ValueError(
            f"model '{name}': dense {kind} tile needs ~{dense_bytes:,} "
            f"bytes of per-lane sweep scratch (> {DENSE_TILE_HARD_BYTES:,}"
            " hard cap) — compile with bank_layout='sparse' (or 'auto') "
            "to use the packed segmented tile instead (DESIGN.md §16)")
    return "dense"


_TORCH_DTYPES = {"int32": torch.int32, "int64": torch.int64}


@dataclasses.dataclass
class CompiledModel:
    """Dense, fixed-shape program; every tensor lives on `device`.

    Shapes: V vars, P props (+1 trailing dummy row), K padded terms,
    D padded occurrences per var, B branch vars.  Fields, shapes and
    dtypes are those of ``repro/core/compile.py::CompiledModel``.
    """

    # store init
    lb0: torch.Tensor          # i[V]
    ub0: torch.Tensor          # i[V]
    box_lo: torch.Tensor       # i[V]  = lb0 - 1 (clamp floor)
    box_hi: torch.Tensor       # i[V]  = ub0 + 1 (clamp ceil)
    # propagator-centric tables (row P is the neutral dummy)
    vidx: torch.Tensor         # i[P+1, K] var index per term (0 for padding)
    coef: torch.Tensor         # i[P+1, K] coefficient (0 for padding)
    rhs: torch.Tensor          # i[P+1]
    bidx: torch.Tensor         # i[P+1]   reif bool var (TRUE_VAR for plain)
    # variable-centric occurrence tables (padding points at dummy row, slot 0)
    occ_prop: torch.Tensor     # i[V, D]
    occ_slot: torch.Tensor     # i[V, D]  in [0, K]; K == reif-entailment slot
    # alldifferent bank (row A is the neutral dummy)
    ad_vars: torch.Tensor      # i[A+1, N]
    ad_offs: torch.Tensor      # i[A+1, N]
    ad_mask: torch.Tensor      # i[A+1, N]
    ad_occ_inst: torch.Tensor  # i[V, Dad]
    ad_occ_pos: torch.Tensor   # i[V, Dad]
    # cumulative bank (row C is the neutral dummy)
    cu_svar: torch.Tensor      # i[C+1, T]  start var per task (0 for padding)
    cu_dur: torch.Tensor       # i[C+1, T]  duration (0 for padding)
    cu_dem: torch.Tensor       # i[C+1, T]  demand   (0 for padding)
    cu_cap: torch.Tensor       # i[C+1]     capacity
    cu_occ_inst: torch.Tensor  # i[V, Dcu]
    cu_occ_pos: torch.Tensor   # i[V, Dcu]
    # CSR-style packed views of the native banks
    ad_ptr: torch.Tensor       # i[A+2]
    ad_pk_var: torch.Tensor    # i[Mad]
    ad_pk_off: torch.Tensor    # i[Mad]
    ad_pk_seg: torch.Tensor    # i[Mad]
    cu_ptr: torch.Tensor       # i[C+2]
    cu_pk_svar: torch.Tensor   # i[Mcu]
    cu_pk_dur: torch.Tensor    # i[Mcu]
    cu_pk_dem: torch.Tensor    # i[Mcu]
    cu_pk_seg: torch.Tensor    # i[Mcu]
    # compact-table bank (row T is the neutral dummy)
    ct_vars: torch.Tensor      # i[T+1, R]
    ct_mask: torch.Tensor      # i[T+1, R]
    ct_supp: torch.Tensor      # u32[T+1, R, 32W, TW]
    ct_occ_inst: torch.Tensor  # i[V, Dct]
    ct_occ_pos: torch.Tensor   # i[V, Dct]
    # bitset domain layout
    dom_off: torch.Tensor      # i[V]
    dom_track: torch.Tensor    # u32[V]
    # search
    branch_vars: torch.Tensor  # i[B] decision vars in branching order
    # static metadata
    n_vars: int
    n_props: int
    k_terms: int
    d_occ: int
    n_alldiff: int
    ad_width: int
    ad_docc: int
    n_cumulative: int
    cu_width: int
    cu_docc: int
    horizon: int
    ad_layout: str
    cu_layout: str
    ad_packed: int
    cu_packed: int
    n_table: int
    ct_arity: int
    ct_words: int
    ct_docc: int
    n_words: int
    obj_var: int                # -1 if satisfaction
    dtype: str
    name: str

    @property
    def jdtype(self):
        return np.dtype(self.dtype)

    @property
    def tdtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.dtype]

    @property
    def device(self) -> torch.device:
        return self.lb0.device

    @property
    def total_props(self) -> int:
        return self.n_props + self.n_alldiff + self.n_cumulative + self.n_table

    def to(self, device) -> "CompiledModel":
        """The same model with every table on `device` (a no-op when the
        tables already live there)."""
        dev = resolve_device(device)
        if self.device == dev:
            return self
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(dev) for f in TENSOR_FIELDS})


TENSOR_FIELDS: Tuple[str, ...] = tuple(
    f.name for f in dataclasses.fields(CompiledModel)
    if f.type == "torch.Tensor")
STATIC_FIELDS: Tuple[str, ...] = tuple(
    f.name for f in dataclasses.fields(CompiledModel)
    if f.type != "torch.Tensor")


def from_arrays(arrays: Dict[str, np.ndarray], statics: dict,
                device=None) -> CompiledModel:
    """Build a `CompiledModel` from host arrays (every name in
    `TENSOR_FIELDS`) and statics (every name in `STATIC_FIELDS`), with
    the tensors on `device`.  The arrays keep their dtypes, so a JAX
    compile carried across as numpy gives the port identical tables."""
    dev = resolve_device(device)
    missing = ([f for f in TENSOR_FIELDS if f not in arrays]
               + [f for f in STATIC_FIELDS if f not in statics])
    if missing:
        raise ValueError(f"from_arrays: missing fields {missing}")
    return CompiledModel(
        **{f: torch.from_numpy(np.array(arrays[f])).to(dev)
           for f in TENSOR_FIELDS},
        **{f: statics[f] for f in STATIC_FIELDS})


def to_arrays(cm: CompiledModel) -> Tuple[Dict[str, np.ndarray], dict]:
    """Inverse of `from_arrays`: (host arrays, statics)."""
    return ({f: getattr(cm, f).cpu().numpy() for f in TENSOR_FIELDS},
            {f: getattr(cm, f) for f in STATIC_FIELDS})


def compile_model(
    m: Model,
    pad_terms_to: int = 8,
    pad_occ_to: int = 8,
    pad_horizon_to: int = 32,
    force_dtype: str | None = None,
    bank_layout: str = "auto",
    device=None,
) -> CompiledModel:
    """Lower `m` to a `CompiledModel` whose tensors live on `device`
    (``None`` → ``cuda``; pass ``"cpu"`` for the CPU)."""
    dev = resolve_device(device)
    if bank_layout not in ("auto", "dense", "sparse"):
        raise ValueError(
            f"bank_layout must be 'auto', 'dense' or 'sparse', "
            f"got {bank_layout!r}")
    V = m.n_vars
    props: List[ReifLinLe] = m.props
    P = len(props)
    if P == 0 and not (m.alldiffs or m.cumulatives or m.tables):
        raise ValueError("model has no constraints")

    K = max((len(p.lin.terms) for p in props), default=1)
    K = max(_round_up(K, pad_terms_to), pad_terms_to)

    lb0 = np.asarray(m.lb0, dtype=np.int64)
    ub0 = np.asarray(m.ub0, dtype=np.int64)

    vidx = np.zeros((P + 1, K), dtype=np.int64)
    coef = np.zeros((P + 1, K), dtype=np.int64)
    rhs = np.zeros((P + 1,), dtype=np.int64)
    bidx = np.full((P + 1,), TRUE_VAR, dtype=np.int64)

    occs: List[List[Tuple[int, int]]] = [[] for _ in range(V)]
    for p, rp in enumerate(props):
        terms = rp.lin.terms
        if len(terms) > K:
            raise ValueError("term overflow")
        for k, (v, a) in enumerate(terms):
            vidx[p, k] = v
            coef[p, k] = a
            occs[v].append((p, k))
        rhs[p] = rp.lin.rhs
        bidx[p] = rp.bvar
        if rp.bvar != TRUE_VAR:
            # genuinely reified: b can be tightened by (dis)entailment.
            occs[rp.bvar].append((p, K))
        # plain props (b == TRUE) fail through term tightening alone; we
        # skip their reif occurrence so the TRUE var's degree stays 0.

    # dummy row P: coef 0 everywhere -> all candidates neutral; rhs huge so
    # it is "entailed" but its reif slot is never gathered.
    rhs[P] = int(np.iinfo(np.int32).max // 4)

    D = max(max((len(o) for o in occs), default=1), 1)
    D = max(_round_up(D, pad_occ_to), pad_occ_to)
    occ_prop = np.full((V, D), P, dtype=np.int64)   # pad -> dummy row
    occ_slot = np.zeros((V, D), dtype=np.int64)     # pad -> term slot 0 (coef 0)
    for v, o in enumerate(occs):
        for d, (p, k) in enumerate(o):
            occ_prop[v, d] = p
            occ_slot[v, d] = k

    # ---- alldifferent bank (DESIGN.md §12) -----------------------------
    A = len(m.alldiffs)
    N = max((len(ad.vars) for ad in m.alldiffs), default=2)
    N = max(_round_up(N, 4), 2) if A else 2
    ad_vars = np.zeros((A + 1, N), dtype=np.int64)
    ad_offs = np.zeros((A + 1, N), dtype=np.int64)
    ad_mask = np.zeros((A + 1, N), dtype=np.int64)
    ad_occs: List[List[Tuple[int, int]]] = [[] for _ in range(V)]
    for a, ad in enumerate(m.alldiffs):
        for n, (v, off) in enumerate(zip(ad.vars, ad.offsets)):
            ad_vars[a, n] = v
            ad_offs[a, n] = off
            ad_mask[a, n] = 1
            ad_occs[v].append((a, n))
    Dad = max(max((len(o) for o in ad_occs), default=1), 1)
    Dad = _round_up(Dad, 4) if A else 1
    ad_occ_inst = np.full((V, Dad), A, dtype=np.int64)   # pad -> dummy row
    ad_occ_pos = np.zeros((V, Dad), dtype=np.int64)
    for v, o in enumerate(ad_occs):
        for d, (a, n) in enumerate(o):
            ad_occ_inst[v, d] = a
            ad_occ_pos[v, d] = n

    # packed (CSR) view: row-contiguous members; always ≥ 1 padding slot
    # so the dummy occurrence (inst=A, pos=0) lands at flat ad_ptr[A]
    mad_real = sum(len(ad.vars) for ad in m.alldiffs)
    Mad = max(_round_up(mad_real + 1, 8), 8)
    ad_ptr = np.zeros((A + 2,), dtype=np.int64)
    ad_pk_var = np.zeros((Mad,), dtype=np.int64)
    ad_pk_off = np.zeros((Mad,), dtype=np.int64)
    ad_pk_seg = np.full((Mad,), A, dtype=np.int64)
    k_ = 0
    for a, ad in enumerate(m.alldiffs):
        ad_ptr[a] = k_
        for v, off in zip(ad.vars, ad.offsets):
            ad_pk_var[k_] = v
            ad_pk_off[k_] = off
            ad_pk_seg[k_] = a
            k_ += 1
    ad_ptr[A] = k_          # padding region start
    ad_ptr[A + 1] = Mad

    # ---- cumulative bank (DESIGN.md §12) -------------------------------
    C = len(m.cumulatives)
    T = max((len(cu.starts) for cu in m.cumulatives), default=2)
    T = max(_round_up(T, 4), 2) if C else 2
    cu_svar = np.zeros((C + 1, T), dtype=np.int64)
    cu_dur = np.zeros((C + 1, T), dtype=np.int64)
    cu_dem = np.zeros((C + 1, T), dtype=np.int64)
    cu_cap = np.zeros((C + 1,), dtype=np.int64)
    cu_occs: List[List[Tuple[int, int]]] = [[] for _ in range(V)]
    horizon = 1
    for c, cu in enumerate(m.cumulatives):
        if cu.capacity < 0:
            # the segmented profile only inspects event intervals, so a
            # negative cap (0 > cap on empty time) would need the whole
            # grid; dense fails everywhere — reject the degenerate model
            raise ValueError(
                f"cumulative row {c} has negative capacity "
                f"{cu.capacity}; capacities must be >= 0")
        cu_cap[c] = cu.capacity
        for t, (v, d_, r_) in enumerate(zip(cu.starts, cu.durations,
                                            cu.demands)):
            cu_svar[c, t] = v
            cu_dur[c, t] = d_
            cu_dem[c, t] = r_
            if d_ > 0 and r_ > 0:
                if int(lb0[v]) < 0:
                    # the time-table grid is [0, horizon); a negative
                    # feasible start would be silently pruned (wrong
                    # UNSAT) — demand a shifted model instead
                    raise ValueError(
                        f"cumulative start var {v} has negative domain "
                        f"({int(lb0[v])}, {int(ub0[v])}); native time-table "
                        "filtering needs nonnegative starts — shift the "
                        "model (or use decompose=True)")
                # only effective tasks are ever tightened by the row
                cu_occs[v].append((c, t))
                horizon = max(horizon, int(ub0[v]) + d_ + 2)
    Dcu = max(max((len(o) for o in cu_occs), default=1), 1)
    Dcu = _round_up(Dcu, 4) if C else 1
    # bucket the (static, trace-shaping) time grid so same-family
    # instances across seeds keep one shape signature (api.py cache /
    # solve_many; same spirit as the pool pow2 buckets, DESIGN.md §11)
    if C:
        horizon = _round_up(horizon, pad_horizon_to)
    cu_occ_inst = np.full((V, Dcu), C, dtype=np.int64)   # pad -> dummy row
    cu_occ_pos = np.zeros((V, Dcu), dtype=np.int64)
    for v, o in enumerate(cu_occs):
        for d, (c, t) in enumerate(o):
            cu_occ_inst[v, d] = c
            cu_occ_pos[v, d] = t

    # packed (CSR) view of the cumulative bank (same invariants as ad_*)
    mcu_real = sum(len(cu.starts) for cu in m.cumulatives)
    Mcu = max(_round_up(mcu_real + 1, 8), 8)
    cu_ptr = np.zeros((C + 2,), dtype=np.int64)
    cu_pk_svar = np.zeros((Mcu,), dtype=np.int64)
    cu_pk_dur = np.zeros((Mcu,), dtype=np.int64)
    cu_pk_dem = np.zeros((Mcu,), dtype=np.int64)
    cu_pk_seg = np.full((Mcu,), C, dtype=np.int64)
    k_ = 0
    for c, cu in enumerate(m.cumulatives):
        cu_ptr[c] = k_
        for v, d_, r_ in zip(cu.starts, cu.durations, cu.demands):
            cu_pk_svar[k_] = v
            cu_pk_dur[k_] = d_
            cu_pk_dem[k_] = r_
            cu_pk_seg[k_] = c
            k_ += 1
    cu_ptr[C] = k_
    cu_ptr[C + 1] = Mcu

    # ---- compact-table bank + bitset domain layout (DESIGN.md §17) ------
    branch = list(m.branch_order) if m.branch_order else list(range(1, V))
    # ensure every non-fixed var is ultimately branchable: append leftovers
    missing = [v for v in range(1, V) if v not in set(branch)]
    branch = branch + missing

    Tn = len(m.tables)
    R = max((len(t.vars) for t in m.tables), default=1)
    widths = ub0 - lb0 + 1
    # With tables, n_words covers every table member AND every branch
    # var (tables need the member domains as bitsets; covering the
    # branch vars too lets middle-out track them for free — table
    # models' bank shapes are instance-dependent anyway).  WITHOUT
    # tables n_words is pinned to 1 so same-shaped instances keep
    # hitting the compiled-runner cache regardless of their bounds;
    # middle-out leaves vars wider than 32 values untracked, where its
    # selection and branching degrade per-var to exactly VAL_SPLIT
    # (pinned all-ones words put the nearest remaining value at the
    # interval midpoint, and apply_path_tile tells x ≥ m+1 instead of
    # a bit clear).
    if Tn:
        dom_vars = sorted({v for t in m.tables for v in t.vars}
                          | set(branch))
        n_words = n_words_for(int(widths[dom_vars].max()))
    else:
        n_words = 1
    K32 = WORD_BITS * n_words
    maxT = max((len(t.tuples) for t in m.tables), default=1)
    TW = max(1, -(-maxT // WORD_BITS))
    ct_vars = np.zeros((Tn + 1, R), dtype=np.int64)
    ct_mask = np.zeros((Tn + 1, R), dtype=np.int64)
    ct_supp = np.zeros((Tn + 1, R, K32, TW), dtype=np.uint32)
    ct_occs: List[List[Tuple[int, int]]] = [[] for _ in range(V)]
    for ti, tb in enumerate(m.tables):
        for r, v in enumerate(tb.vars):
            ct_vars[ti, r] = v
            ct_mask[ti, r] = 1
            ct_occs[v].append((ti, r))
        for j, tup in enumerate(tb.tuples):
            for r, (v, val) in enumerate(zip(tb.vars, tup)):
                k = int(val) - int(lb0[v])  # in [0, width) by Model.table
                ct_supp[ti, r, k, j // WORD_BITS] |= (
                    np.uint32(1) << np.uint32(j % WORD_BITS))
    Dct = max(max((len(o) for o in ct_occs), default=1), 1)
    Dct = _round_up(Dct, 4) if Tn else 1
    ct_occ_inst = np.full((V, Dct), Tn, dtype=np.int64)  # pad -> dummy row
    ct_occ_pos = np.zeros((V, Dct), dtype=np.int64)
    for v, o in enumerate(ct_occs):
        for d, (ti, r) in enumerate(o):
            ct_occ_inst[v, d] = ti
            ct_occ_pos[v, d] = r
    dom_track = (widths <= K32).astype(np.uint32)

    # ---- dtype selection with overflow headroom ------------------------
    absmax = np.maximum(np.abs(lb0), np.abs(ub0)) + 1           # per var
    worst = int((np.abs(coef[:P]) * absmax[vidx[:P]]).sum(axis=1).max()) \
        if P else 0
    worst = max(worst, int(np.abs(rhs[:P]).max()) if P else 0)
    # native banks: shifted alldiff values x+off (±1 Hall push), cumulative
    # time points up to `horizon` and per-row demand sums
    if A:
        worst = max(worst, int((absmax[ad_vars[:A]] + np.abs(ad_offs[:A])
                                ).max()) + 2)
    if C:
        worst = max(worst, horizon + 2,
                    int(cu_dem[:C].sum(axis=1).max()), int(cu_cap[:C].max()))
    # sparse tiles compare member *counts* against interval widths
    worst = max(worst, Mad, Mcu)
    # bitset hull bridge: an empty tracked domain reads back as
    # (off + 32·n_words, off - 1)
    worst = max(worst, int(np.abs(lb0).max()) + K32 + 2)
    if force_dtype is not None:
        dtype = force_dtype
    elif worst * 4 < np.iinfo(np.int32).max:
        dtype = "int32"
    else:
        dtype = "int64"
    if worst * 4 >= np.iinfo(np.int64).max:
        raise OverflowError("model exceeds int64 headroom")


    # ---- per-bank tile layout (decided after dtype: bytes need itemsize)
    itemsize = np.dtype(dtype).itemsize
    ad_layout = _resolve_layout(
        bank_layout, alldiff_dense_tile_bytes(A, N, itemsize),
        "AllDifferent", m.name)
    cu_layout = _resolve_layout(
        bank_layout, cumulative_dense_tile_bytes(C, T, horizon, itemsize),
        "Cumulative", m.name)
    arrays = dict(
        lb0=lb0, ub0=ub0, box_lo=lb0 - 1, box_hi=ub0 + 1,
        vidx=vidx, coef=coef, rhs=rhs, bidx=bidx,
        occ_prop=occ_prop, occ_slot=occ_slot,
        ad_vars=ad_vars, ad_offs=ad_offs, ad_mask=ad_mask,
        ad_occ_inst=ad_occ_inst, ad_occ_pos=ad_occ_pos,
        cu_svar=cu_svar, cu_dur=cu_dur, cu_dem=cu_dem, cu_cap=cu_cap,
        cu_occ_inst=cu_occ_inst, cu_occ_pos=cu_occ_pos,
        ad_ptr=ad_ptr, ad_pk_var=ad_pk_var, ad_pk_off=ad_pk_off,
        ad_pk_seg=ad_pk_seg, cu_ptr=cu_ptr, cu_pk_svar=cu_pk_svar,
        cu_pk_dur=cu_pk_dur, cu_pk_dem=cu_pk_dem, cu_pk_seg=cu_pk_seg,
        ct_vars=ct_vars, ct_mask=ct_mask, ct_occ_inst=ct_occ_inst,
        ct_occ_pos=ct_occ_pos, dom_off=lb0, branch_vars=np.asarray(branch))
    arrays = {k: np.asarray(a, dtype=dtype) for k, a in arrays.items()}
    arrays.update(ct_supp=ct_supp, dom_track=dom_track)   # u32 stays u32
    statics = dict(
        n_vars=V, n_props=P, k_terms=K, d_occ=D,
        n_alldiff=A, ad_width=N, ad_docc=Dad,
        n_cumulative=C, cu_width=T, cu_docc=Dcu, horizon=horizon,
        ad_layout=ad_layout, cu_layout=cu_layout,
        ad_packed=Mad, cu_packed=Mcu,
        n_table=Tn, ct_arity=R, ct_words=TW, ct_docc=Dct, n_words=n_words,
        obj_var=(m.objective if m.objective is not None else -1),
        dtype=dtype, name=m.name)
    return from_arrays(arrays, statics, dev)
