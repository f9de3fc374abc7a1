"""The propagation fixpoint and resident search kernels for Hopper, and
their wrappers.

* `fixpoint_cuda` replaces the Pallas TPU kernel ``fixpoint_pallas``
  (``src/repro/kernels/fixpoint_kernel.py``).  Source
  ``csrc/fixpoint.cu``: one CTA per lane, both stores double-buffered in
  shared memory, the sweep loop driven by ``__syncthreads_or`` on the
  per-lane rule of the reference (changed ∧ it < max_sweeps ∧ ¬failed).
* `search_cuda` replaces ``search_pallas`` (``lane_tile=0``): K whole
  supersteps of the search per launch.  Source ``csrc/search.cu``: a
  cooperative persistent grid whose CTAs run their lanes through the
  same per-lane fixpoint (``csrc/fixpoint_lane.cuh``) and meet at two
  grid barriers per superstep.  Its plain version is `search_plain`.

Both cover the ReifLinLe bank, the dense AllDifferent bank and the
dense Cumulative bank (``csrc/fixpoint_lane.cuh``) — what RCPSP,
N-queens, graph coloring, knapsack and jobshop lower to at their smoke
and bench tiers.  The sparse AllDifferent and Cumulative layouts and
Compact-Table raise.  On a CPU tensor a wrapper runs its plain version; on a
CUDA tensor it launches the kernel or raises (unsupported bank, int64
model, wrong dtype/shape/device, failed build, refused launch).  It
never falls back.

``fixpoint_cuda.launches`` and ``search_cuda.launches`` count kernel
launches (and nothing else), so a run can show that the main path went
through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import fixpoint as F
from repro_torch.core import search as S

# shared memory one H100 block may use (232,448 bytes = 227 KB)
SMEM_LIMIT_BYTES = 227 * 1024
UNCAPPED = 2 ** 31 - 1
# threads per CTA (fixlane::THREADS in csrc/fixpoint_lane.cuh)
THREADS = 256
# csrc/search.cu EXTRA_WORDS: the scan's per-thread prefixes, its 32
# per-warp sums and 16 lane scalars
SEARCH_EXTRA_WORDS = THREADS + 32 + 16


def smem_budget(cm, resident: bool = False) -> dict:
    """Shared-memory bytes of one CTA, by part — the formula of
    ``fixpoint_smem_bytes`` in ``csrc/fixpoint.cu`` or, with
    ``resident=True``, of ``search_smem_bytes`` in ``csrc/search.cu``
    (the counterpart of the reference's ``vmem_budget(resident=True)``;
    the LaneState stays in device memory, so only one lane's fixpoint
    and the search's scratch count):

    * ``stores``     — current and next lb/ub, ``4·V`` int32;
    * ``linear``     — the ``[P+1, K+1]`` candidate pair;
    * ``alldiff``    — the shifted member bounds and the candidate pair,
      four ``[A+1, N]`` arrays, and a fail flag per row; nothing for a
      model without AllDifferent rows (the counterpart of the
      reference's ``vmem_budget`` alldiff term);
    * ``cumulative`` — the ``[C+1, horizon]`` profile, the ``[C+1, T]``
      candidate pair, the staged task table and per-row flags;
    * ``search``     — resident only: the dispatch scan and the lane
      scalars.
    """
    P1, K = cm.vidx.shape
    A1, N = cm.ad_vars.shape
    C1, T = cm.cu_svar.shape
    parts = dict(
        stores=4 * cm.n_vars * 4,
        linear=2 * P1 * (K + 1) * 4,
        alldiff=(4 * A1 * N + A1) * 4 if cm.n_alldiff else 0,
        cumulative=(C1 * cm.horizon + 5 * C1 * T + 2 * C1) * 4,
        search=SEARCH_EXTRA_WORDS * 4 if resident else 0)
    parts["total"] = sum(parts.values())
    return parts


def fit_smem(cm, limit_bytes: int = SMEM_LIMIT_BYTES,
             resident: bool = False) -> dict:
    """The budget of `smem_budget`, or a clear ``ValueError`` when one
    lane does not fit a block.  (The reference halves its lane tile
    before it gives up; a CTA here holds one lane at a time, so there is
    nothing to halve.)"""
    b = smem_budget(cm, resident=resident)
    if b["total"] > limit_bytes:
        kernel = "search_cuda" if resident else "fixpoint_cuda"
        raise ValueError(
            f"{kernel}: model {cm.name or '<unnamed>'} needs "
            f"{b['total']:,} bytes of shared memory per lane (stores "
            f"{b['stores']:,}, linear candidates {b['linear']:,}, "
            f"alldiff {b['alldiff']:,}, cumulative {b['cumulative']:,}, "
            f"search {b['search']:,}) > {limit_bytes:,} per H100 block; "
            "shrink the horizon or the banks, or use the gather backend")
    return b


def kernel_tables(cm) -> tuple:
    """The model tables the kernels read, in ``fixlane::Tables`` order
    (``csrc/fixpoint_lane.cuh``)."""
    return (cm.vidx, cm.coef, cm.rhs, cm.bidx, cm.occ_prop, cm.occ_slot,
            cm.ad_vars, cm.ad_offs, cm.ad_mask, cm.ad_occ_inst,
            cm.ad_occ_pos, cm.cu_svar, cm.cu_dur, cm.cu_dem, cm.cu_cap,
            cm.cu_occ_inst, cm.cu_occ_pos, cm.box_lo, cm.box_hi)


def _c_tables(cm):
    """`kernel_tables` and their sizes (in ``fixlane::Tables`` order: V,
    P1, K, D, A1, N, Dad, n_alldiff, C1, T, Dcu, horizon, n_cumulative)
    as the C arrays the launch functions take."""
    tables = kernel_tables(cm)
    P1, K = cm.vidx.shape
    A1, N = cm.ad_vars.shape
    C1, T = cm.cu_svar.shape
    dims = (cm.n_vars, P1, K, cm.occ_prop.shape[1], A1, N,
            cm.ad_occ_inst.shape[1], cm.n_alldiff, C1, T,
            cm.cu_occ_inst.shape[1], cm.horizon, cm.n_cumulative)
    return ((ctypes.c_void_p * len(tables))(*(t.data_ptr() for t in tables)),
            (ctypes.c_int * len(dims))(*dims))


def _lib():
    from repro_torch.kernels.build import load
    lib = load("fixpoint")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.fixpoint_launch.argtypes = [ptr] * 8 + [i32] * 2 + [ptr]
        lib.fixpoint_launch.restype = i32
        lib.fixpoint_error_string.argtypes = [i32]
        lib.fixpoint_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(cm, lb, ub):
    F.check_supported(**F.model_statics(cm))
    if cm.dtype != "int32":
        raise NotImplementedError(
            f"fixpoint_cuda: model {cm.name or '<unnamed>'} compiled to "
            f"{cm.dtype}; the kernel is int32-only")
    if lb.dtype != torch.int32 or ub.dtype != torch.int32:
        raise TypeError(f"fixpoint_cuda: stores must be int32, got "
                        f"{lb.dtype}/{ub.dtype}")
    if lb.dim() != 2 or lb.shape != ub.shape or lb.shape[1] != cm.n_vars:
        raise ValueError(f"fixpoint_cuda: stores must be [L, {cm.n_vars}], "
                         f"got {tuple(lb.shape)}/{tuple(ub.shape)}")
    if not (lb.is_contiguous() and ub.is_contiguous()):
        raise ValueError("fixpoint_cuda: stores must be contiguous")
    if lb.device != ub.device or cm.device != lb.device:
        raise ValueError(f"fixpoint_cuda: stores on {lb.device}/{ub.device}"
                         f", model tables on {cm.device}")


def fixpoint_cuda(cm, lb, ub, *, max_sweeps=None):
    """Run every lane of ``[L, V]`` stores to its fixed point.

    Returns (lb', ub', sweeps i32[L], converged bool[L]), equal to
    `fixpoint_batch(cm, lb, ub, max_iters=max_sweeps)`.  ``max_sweeps``
    None is uncapped.
    """
    if lb.device.type == "cpu":
        return F.fixpoint_batch(cm, lb, ub, max_iters=max_sweeps)
    if lb.device.type != "cuda":
        raise ValueError(f"fixpoint_cuda: unsupported device {lb.device}")
    _check(cm, lb, ub)
    fit_smem(cm)
    L = lb.shape[0]
    lb_out, ub_out = torch.empty_like(lb), torch.empty_like(ub)
    sweeps = torch.empty(L, dtype=torch.int32, device=lb.device)
    conv = torch.empty(L, dtype=torch.int32, device=lb.device)
    if L == 0:
        return lb_out, ub_out, sweeps, conv.bool()
    cap = UNCAPPED if max_sweeps is None else int(max_sweeps)
    if cap < 0:
        raise ValueError(f"fixpoint_cuda: max_sweeps must be >= 0, got {cap}")
    lib = _lib()
    err = lib.fixpoint_launch(
        *_c_tables(cm), lb.data_ptr(), ub.data_ptr(), lb_out.data_ptr(),
        ub_out.data_ptr(), sweeps.data_ptr(), conv.data_ptr(), L, cap,
        torch.cuda.current_stream(lb.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            "fixpoint_cuda: launch failed: "
            + lib.fixpoint_error_string(err).decode())
    fixpoint_cuda.launches += 1
    return lb_out, ub_out, sweeps, conv.bool()


fixpoint_cuda.launches = 0


# --------------------------------------------------------------------------
# Resident search: K supersteps per launch
# --------------------------------------------------------------------------

_VAR_CODES = {S.INPUT_ORDER: 0, S.MIN_DOM: 1, S.MIN_LB: 2}
_VAL_CODES = {S.VAL_MIN: 0, S.VAL_SPLIT: 1}
_BOOL_FIELDS = ("dec_flip", "fresh", "done", "incomplete", "has_sol")
# the LaneState fields the kernel carries, in csrc/search.cu State order
_STATE_FIELDS = tuple(f for f in S.LaneState._fields
                      if f not in ("dom", "root_dom"))


def _gdone(st: S.LaneState, stop_on_first: bool) -> bool:
    g = bool(st.done.all())
    if stop_on_first:
        g = g or bool(st.has_sol.any())
    return g


def search_plain(cm, subs_lb, subs_ub, st: S.LaneState, gbest, it,
                 pool_head, *, supersteps: int = 16,
                 max_sweeps: int = 16384, max_fixpoint_iters=None,
                 var_strategy: str = S.INPUT_ORDER,
                 val_strategy: str = S.VAL_MIN,
                 stop_on_first: bool = False):
    """The plain version of `search_cuda`: K = `supersteps` guarded
    `search.lanes_step` iterations with the gather fixpoint, capped at
    ``max_fixpoint_iters`` sweeps or else `max_sweeps` (as the
    reference's kernel).  A superstep that starts with the global done
    flag set is skipped, so ``it`` counts only the live ones.

    Returns ``(st', gbest', it', pool_head', stopped)``: the bound, the
    superstep count and the pool cursor as 0-d tensors, `stopped` the
    global done flag of ``st'`` as a 0-d bool tensor.
    """
    dev = st.lb.device
    cap = max_sweeps if max_fixpoint_iters is None else max_fixpoint_iters
    opts = S.SearchOptions(var_strategy=var_strategy,
                           val_strategy=val_strategy,
                           max_depth=st.dec_var.shape[1],
                           max_fixpoint_iters=cap,
                           stop_on_first=stop_on_first, backend="gather")
    gbest = torch.as_tensor(gbest, dtype=st.best_obj.dtype, device=dev)
    head = torch.as_tensor(pool_head, dtype=torch.int32, device=dev)
    it = int(it)
    for _ in range(supersteps):
        if _gdone(st, stop_on_first):
            break
        st, head = S.lanes_step(cm, subs_lb, subs_ub, opts, st, gbest,
                                head)
        gbest = torch.minimum(gbest, S.lanes_best(st))
        it += 1
    return (st, gbest, torch.tensor(it, dtype=torch.int32, device=dev),
            head, torch.tensor(_gdone(st, stop_on_first), device=dev))


def _search_lib():
    from repro_torch.kernels.build import load
    lib = load("search")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.search_launch.argtypes = [ptr] * 6
        lib.search_launch.restype = i32
        lib.search_grid.argtypes = [i32, ptr, ptr]
        lib.search_grid.restype = i32
        lib.search_error_string.argtypes = [i32]
        lib.search_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_search(cm, subs_lb, subs_ub, st, var_strategy, val_strategy):
    _check(cm, st.lb, st.ub)
    if st.dom is not None or st.root_dom is not None:
        raise NotImplementedError("search_cuda: bitset stores come with "
                                  "the Compact-Table slice of the port")
    if var_strategy not in _VAR_CODES:
        raise ValueError(f"search_cuda: var_strategy {var_strategy!r} not "
                         f"in {tuple(_VAR_CODES)}")
    S._no_middle_out(val_strategy)
    if val_strategy not in _VAL_CODES:
        raise ValueError(f"search_cuda: val_strategy {val_strategy!r} not "
                         f"in {tuple(_VAL_CODES)}")
    L, V = st.lb.shape
    MD = st.dec_var.shape[1]
    if L == 0:
        raise ValueError("search_cuda: no lanes")
    shapes = {f: (L, V) for f in ("lb", "ub", "root_lb", "root_ub",
                                  "best_sol")}
    shapes.update({f: (L, MD) for f in ("dec_var", "dec_val", "dec_flip")})
    for f in _STATE_FIELDS:
        a = getattr(st, f)
        dt = torch.bool if f in _BOOL_FIELDS else torch.int32
        if a.dtype != dt or tuple(a.shape) != shapes.get(f, (L,)):
            raise ValueError(
                f"search_cuda: LaneState.{f} must be {dt} "
                f"{shapes.get(f, (L,))}, got {a.dtype} {tuple(a.shape)}")
        if a.device != st.lb.device:
            raise ValueError(f"search_cuda: LaneState.{f} on {a.device}, "
                             f"stores on {st.lb.device}")
    for a in (subs_lb, subs_ub):
        if a.dtype != torch.int32 or a.dim() != 2 or a.shape[1] != V \
                or a.shape[0] < 1:
            raise ValueError(f"search_cuda: the pool must be int32 "
                             f"[S >= 1, {V}], got {a.dtype} "
                             f"{tuple(a.shape)}")
        if a.device != st.lb.device:
            raise ValueError(f"search_cuda: pool on {a.device}, stores on "
                             f"{st.lb.device}")


def search_cuda(cm, subs_lb, subs_ub, st: S.LaneState, gbest, it,
                pool_head, *, supersteps: int = 16, lane_tile: int = 0,
                max_sweeps: int = 16384, max_fixpoint_iters=None,
                var_strategy: str = S.INPUT_ORDER,
                val_strategy: str = S.VAL_MIN,
                stop_on_first: bool = False):
    """K = `supersteps` whole supersteps of the search in one launch of
    ``csrc/search.cu`` (the counterpart of the reference's
    ``search_pallas``).

    Arguments mirror one host-loop carry: the `LaneState`, the 0-d bound
    `gbest`, the superstep count `it` (int or 0-d tensor) and the 0-d
    pool cursor.  Returns ``(st', gbest', it', pool_head', stopped)``,
    equal to `search_plain` on the same inputs.  Only the one-queue mode
    (``lane_tile=0``) is ported; the reference's strided multi-cell mode
    raises.  The inputs are left untouched.
    """
    if lane_tile not in (0, None):
        raise NotImplementedError(
            "search_cuda: only lane_tile=0 (one shared pool queue) is "
            "ported; the strided multi-cell mode is queued (ROADMAP)")
    if supersteps < 0:
        raise ValueError(f"search_cuda: supersteps must be >= 0, got "
                         f"{supersteps}")
    kw = dict(supersteps=supersteps, max_sweeps=max_sweeps,
              max_fixpoint_iters=max_fixpoint_iters,
              var_strategy=var_strategy, val_strategy=val_strategy,
              stop_on_first=stop_on_first)
    dev = st.lb.device
    if dev.type == "cpu":
        return search_plain(cm, subs_lb, subs_ub, st, gbest, it,
                            pool_head, **kw)
    if dev.type != "cuda":
        raise ValueError(f"search_cuda: unsupported device {dev}")
    _check_search(cm, subs_lb, subs_ub, st, var_strategy, val_strategy)
    fit_smem(cm, resident=True)
    cap = max_sweeps if max_fixpoint_iters is None else max_fixpoint_iters
    if cap < 0:
        raise ValueError(f"search_cuda: the sweep cap must be >= 0, got "
                         f"{cap}")
    L = st.lb.shape[0]
    # the kernel updates copies in place; bools travel as int32 0/1
    out = {f: (getattr(st, f).to(torch.int32) if f in _BOOL_FIELDS
               else getattr(st, f).clone(memory_format=torch.contiguous_format))
           for f in _STATE_FIELDS}
    gbest_in = torch.as_tensor(gbest, device=dev).to(torch.int32).reshape(1)
    head_in = torch.as_tensor(pool_head, device=dev).to(torch.int32).reshape(1)
    want = torch.empty(L, dtype=torch.int32, device=dev)
    cells = torch.empty(5, dtype=torch.int32, device=dev)
    res = torch.empty(4, dtype=torch.int32, device=dev)
    subs_lb, subs_ub = subs_lb.contiguous(), subs_ub.contiguous()
    bv = cm.branch_vars.to(torch.int32).contiguous()
    io = (bv, subs_lb, subs_ub, gbest_in, head_in, want, cells, res)
    ints = (L, bv.shape[0], subs_lb.shape[0], st.dec_var.shape[1],
            cm.obj_var, supersteps, cap, _VAR_CODES[var_strategy],
            _VAL_CODES[val_strategy], int(stop_on_first), int(it))

    def ptrs(ts):
        return (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))

    lib = _search_lib()
    err = lib.search_launch(
        *_c_tables(cm), ptrs([out[f] for f in _STATE_FIELDS]), ptrs(io),
        (ctypes.c_int * len(ints))(*ints),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("search_cuda: launch failed: "
                           + lib.search_error_string(err).decode())
    search_cuda.launches += 1
    st_out = S.LaneState(**{f: (out[f] != 0 if f in _BOOL_FIELDS
                                else out[f]) for f in _STATE_FIELDS})
    return st_out, res[0], res[1], res[2], res[3] != 0


search_cuda.launches = 0


def search_grid(cm, n_lanes: int) -> int:
    """CTAs one `search_cuda` launch over `n_lanes` lanes uses on this
    card: min(lanes, co-resident CTAs).  Builds the kernel."""
    lib = _search_lib()
    g = lib.search_grid(n_lanes, *_c_tables(cm))
    if g < 0:
        raise RuntimeError("search_cuda: no grid: "
                           + lib.search_error_string(-g).decode())
    return g
