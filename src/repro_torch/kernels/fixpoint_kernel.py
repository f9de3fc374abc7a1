"""The propagation fixpoint and resident search kernels for Hopper, and
their wrappers.

* `fixpoint_cuda` replaces the Pallas TPU kernel ``fixpoint_pallas``
  (``src/repro/kernels/fixpoint_kernel.py``).  Source
  ``csrc/fixpoint.cu``: one CTA per lane, both stores double-buffered in
  shared memory, the sweep loop driven by ``__syncthreads_or`` on the
  per-lane rule of the reference (changed ∧ it < max_sweeps ∧ ¬failed).
  Two instances of one body (`instance_threads` picks per launch): the
  few-lane one, 1024 threads and an SM per lane, for launches over no
  more lanes than the card has SMs (EPS), and the 256-thread one beyond.
* `search_cuda` replaces ``search_pallas`` in both of its modes, one
  pool queue (``lane_tile=0``) and lane tiles (``lane_tile=N``, the
  reference's ``n_tiles > 1``): K whole supersteps of the search per
  launch.  Source ``csrc/search.cu``: a cooperative persistent grid whose
  CTAs claim lanes one at a time and run each through the same per-lane
  fixpoint (``csrc/fixpoint_lane.cuh``), and meet at two grid barriers
  per superstep.  Its plain version is `search_plain`.
  `search_slots_cuda` is the reference's third mode, ``search_pallas``
  vmapped over a `LaneBatch`'s slots: one launch over B independent
  searches (plain version `search_slots_plain`).

Both cover every bank (``csrc/fixpoint_lane.cuh``): ReifLinLe, the
AllDifferent and Cumulative banks in both layouts, dense and sparse, and
Compact-Table, with or without a carried ``[L, V, W]`` bitset store
(int32 bit patterns; `search_cuda` also under ``middle_out``) — all
seven zoo models at every tier — and models compiled to int32 or to
int64 (each source is built once per width, ``kernels/build.py``).  On
a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises (wrong dtype/shape/device, failed build,
refused launch).  It never falls back.

``fixpoint_cuda.launches`` and ``search_cuda.launches`` count kernel
launches (and nothing else), so a run can show that the main path went
through the kernels; ``fixpoint_cuda.few_lane_launches`` counts those of
the few-lane instance among the first, ``search_cuda.slot_launches``
those over slots among the second.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import fixpoint as F
from repro_torch.core import search as S
from repro_torch.core import trace

# shared memory one H100 block may use (232,448 bytes = 227 KB)
SMEM_LIMIT_BYTES = 227 * 1024
UNCAPPED = 2 ** 31 - 1
# threads per CTA of fixpoint_cuda's two instances (csrc/fixpoint_lane.cuh):
# the many-lane instance (fixlane::THREADS), which search.cu's CTA shares,
# and the few-lane instance (fixlane::FEW_THREADS), one lane on a CTA
# built for latency; `instance_threads` picks one per launch
THREADS = 256
FEW_THREADS = 1024
# a block scan's per-warp sums (fixlane::SCAN_WORDS)
SCAN_WORDS = 32
# csrc/search.cu EXTRA_WORDS: the scan's per-thread prefixes (one per
# thread of its 256-thread CTA), its per-warp sums and 32 words of lane
# and CTA scalars
SEARCH_EXTRA_WORDS = THREADS + SCAN_WORDS + 32


def instance_threads(n_lanes: int, n_sms: int) -> int:
    """Threads per CTA of the `fixpoint_cuda` instance a launch over
    `n_lanes` lanes takes on a card of `n_sms` SMs: the few-lane
    instance (FEW_THREADS, one CTA per SM) while every lane has an SM of
    its own, the many-lane one (THREADS) beyond.  EPS's root ``[1, V]``
    and its batches of splits (two stores a split, up to one store per
    SM: `eps.batch_size`) take the first, the ``cuda`` backend's
    supersteps over 1024 lanes the second."""
    return FEW_THREADS if n_lanes <= n_sms else THREADS


def sort_size(n: int) -> int:
    """Keys a sparse bank sorts for `n` events: the next power of two
    (``fixlane::pow2_at_least``)."""
    return 1 << max(n - 1, 0).bit_length()


def _region(n: int, item: int, width: int) -> int:
    """Bytes of a region of `n` items of `item` bytes, rounded up to the
    value width (``fixlane::region``)."""
    return -(-n * item // width) * width


def ad_mask_words(A1: int, N: int) -> int:
    """Words of the dense AllDifferent bank's member bitmasks
    (``fixlane::ad_mask_words``): four sets per member of each of the A1
    rows of N members and one per row, each ceil(N / 32) words."""
    return (4 * N + 1) * A1 * -(-N // 32)


def bank_bytes(cm, dom: bool = False) -> dict:
    """The bytes of shared memory each bank of one lane's fixpoint uses,
    by part, for the layout and the value width the model compiled to
    (``fixlane::alldiff_bytes``/``cumulative_bytes``/``table_bytes``/
    ``dom_bytes``).  Values (stores, candidates, bounds, durations,
    demands, capacities, profiles) take the model's width, 4 or 8 bytes;
    indices, flags and bitset words 4, each region rounded up to the
    value width; sort keys take two values (a 64-bit key at int32, 128
    bits at int64).  A bank counts only what its layout uses, a model
    without AllDifferent rows gets no AllDifferent part, one without
    tables no Compact-Table part, and the bitset store counts only when
    it is carried (`dom`)."""
    vb = cm.jdtype.itemsize
    kb = 2 * vb

    def i32(n):
        return _region(n, 4, vb)

    A1, N = cm.ad_vars.shape
    C1, T = cm.cu_svar.shape
    if not cm.n_alldiff:
        ad = {}
    elif cm.ad_layout == "sparse":
        n, M = sort_size(cm.ad_packed), cm.ad_packed
        ad = {"sort keys": kb * n, "member indices": i32(n),
              "sorted bounds and Hall folds": 4 * M * vb,
              "candidates": 2 * M * vb, "row flags": i32(A1)}
    else:
        ad = {"member bounds": 2 * A1 * N * vb,
              "candidates": 2 * A1 * N * vb, "row flags": i32(A1),
              "member bitmasks": i32(ad_mask_words(A1, N))}
    if cm.cu_layout == "sparse":
        n, M = sort_size(2 * cm.cu_packed), cm.cu_packed
        cu = {"event keys": kb * n, "profile": vb * n,
              "task table": 2 * i32(M) + 2 * M * vb,
              "candidates": 2 * M * vb, "row flags": C1 * vb + i32(C1),
              "scan": SCAN_WORDS * vb}
    else:
        cu = {"profile": C1 * cm.horizon * vb, "candidates": 2 * C1 * T * vb,
              "task table": i32(C1 * T) + 2 * C1 * T * vb,
              "row flags": C1 * vb + i32(C1)}
    T1, R, K32, TW = cm.ct_supp.shape
    TR, W = T1 * R, cm.n_words
    table = ({"member supports": i32(TR * TW), "current tables": i32(T1 * TW),
              "candidates": 2 * TR * vb, "candidate words": i32(TR * W)}
             if cm.n_table else {})
    words = {"stores": i32(2 * cm.n_vars * W)} if dom else {}
    return {"alldiff": ad, "cumulative": cu, "table": table, "dom": words}


def smem_budget(cm, resident: bool = False, dom: bool = False) -> dict:
    """Shared-memory bytes of one CTA, by part — the formula of
    ``fixlane::smem_bytes`` in ``csrc/fixpoint_lane.cuh`` or, with
    ``resident=True``, of ``search_smem_bytes`` in ``csrc/search.cu``
    (the counterpart of the reference's ``vmem_budget(resident=True)``;
    the LaneState stays in device memory, so only one lane's fixpoint
    and the search's scratch count).  Each part is counted at the width
    the kernel uses (`bank_bytes`): an int64 model's values take 8 bytes.

    * ``stores``     — current and next lb/ub, ``4·V`` values;
    * ``linear``     — the ``[P+1, K+1]`` candidate pair (values);
    * ``alldiff``    — dense layout: the shifted member bounds and the
      candidate pair, four ``[A+1, N]`` arrays, a fail flag per row and
      the Hall pass's member bitmasks (`ad_mask_words`);
      sparse layout: the sort keys and member indices over the next
      power of two of the Mad packed slots, the sorted bounds, the two
      Hall folds and the candidate pair over Mad, a fail flag per row;
      nothing for a model without AllDifferent rows;
    * ``cumulative`` — dense layout: the ``[C+1, horizon]`` profile, the
      ``[C+1, T]`` candidate pair, the staged task table and per-row
      flags; sparse layout: the event keys and the deltas, then the
      profile, over the next power of two of 2·Mcu, the staged task table
      and candidate pair over Mcu, per-row flags and the prefix sum's
      warp sums;
    * ``table``      — with tables: each member's OR of supports
      ``[T+1, R, TW]``, the current tables ``[T+1, TW]``, the hull
      candidate pair ``[T+1, R]`` and the domain-word candidates
      ``[T+1, R, W]`` (the counterpart of the reference's
      ``ct_tile_bytes``); nothing for a model without tables;
    * ``dom``        — with a carried bitset store (`dom`): the current
      and next words, ``2·V·W``;
    * ``search``     — resident only: the dispatch scan and the lane
      scalars (int32 words).
    """
    P1, K = cm.vidx.shape
    vb = cm.jdtype.itemsize
    parts = bank_bytes(cm, dom)
    b = dict(
        stores=4 * cm.n_vars * vb,
        linear=2 * P1 * (K + 1) * vb,
        alldiff=sum(parts["alldiff"].values()),
        cumulative=sum(parts["cumulative"].values()),
        table=sum(parts["table"].values()),
        dom=sum(parts["dom"].values()),
        search=SEARCH_EXTRA_WORDS * 4 if resident else 0)
    b["total"] = sum(b.values())
    return b


def fit_smem(cm, limit_bytes: int = SMEM_LIMIT_BYTES,
             resident: bool = False, dom: bool = False) -> dict:
    """The budget of `smem_budget`, or a clear ``ValueError`` when one
    lane does not fit a block.  The reference halves its lane tile
    (``fit_lane_tile``) before it gives up; a CTA here holds one lane at
    a time, whatever the lane tile of `search_cuda`, so there is nothing
    to halve."""
    b = smem_budget(cm, resident=resident, dom=dom)
    if b["total"] > limit_bytes:
        kernel = "search_cuda" if resident else "fixpoint_cuda"
        parts = bank_bytes(cm, dom)

        def bank(name, layout):
            inner = ", ".join(f"{k} {n:,}" for k, n in parts[name].items())
            return f"{name} {b[name]:,} ({layout}: {inner})"
        raise ValueError(
            f"{kernel}: model {cm.name or '<unnamed>'} ({cm.dtype}) needs "
            f"{b['total']:,} bytes of shared memory per lane (stores "
            f"{b['stores']:,}, linear candidates {b['linear']:,}, "
            f"{bank('alldiff', cm.ad_layout)}, "
            f"{bank('cumulative', cm.cu_layout)}, "
            f"{bank('table', 'Compact-Table')}, "
            f"{bank('dom', 'bitset store')}, search {b['search']:,})"
            f" > {limit_bytes:,} per H100 block; shrink the horizon or "
            "the banks, or use the gather backend")
    return b


# kernel_tables positions of the value tables (``const Val*`` in
# fixlane::Tables): coef, rhs, ad_offs, ad_pk_off, cu_dur, cu_dem, cu_cap,
# cu_pk_dur, cu_pk_dem, dom_off, box_lo, box_hi; every other table is an
# index, a mask or a bitset word (int32)
_VALUE_TABLES = frozenset((1, 2, 7, 13, 16, 17, 18, 23, 24, 31, 33, 34))


def kernel_tables(cm) -> tuple:
    """The model tables the kernels read, in ``fixlane::Tables`` order
    (``csrc/fixpoint_lane.cuh``): the 35 of `fixpoint.model_tables`, the
    ``uint32`` ones (`ct_supp`, `dom_track`) as their int32 views.  An
    int64 model keeps its value tables at int64 and has its index tables
    narrowed to int32 once (kept on the model)."""
    tables = F.model_tables(cm)
    if cm.dtype == "int32":
        return tables
    cached = cm.__dict__.get("_kernel_tables")
    if cached is None or cached[0].device != cm.device:
        cached = tuple(t if i in _VALUE_TABLES or t.dtype == torch.int32
                       else t.to(torch.int32).contiguous()
                       for i, t in enumerate(tables))
        cm.__dict__["_kernel_tables"] = cached
    return cached


def _c_tables(cm):
    """`kernel_tables` and their sizes (in ``fixlane::Tables`` order: V,
    P1, K, D, A1, N, Dad, n_alldiff, C1, T, Dcu, horizon, n_cumulative,
    Mad, Mcu, the two layouts (1 for sparse), n_table, T1, R, W, TW and
    Dct) as the C arrays the launch functions take.  The horizon is read
    only by the dense Cumulative layout; a sparse one passes 0 (an int64
    model's horizon may pass 2³¹)."""
    tables = kernel_tables(cm)
    P1, K = cm.vidx.shape
    A1, N = cm.ad_vars.shape
    C1, T = cm.cu_svar.shape
    T1, R, _, TW = cm.ct_supp.shape
    horizon = cm.horizon if cm.cu_layout == "dense" else 0
    dims = (cm.n_vars, P1, K, cm.occ_prop.shape[1], A1, N,
            cm.ad_occ_inst.shape[1], cm.n_alldiff, C1, T,
            cm.cu_occ_inst.shape[1], horizon, cm.n_cumulative,
            cm.ad_packed, cm.cu_packed, int(cm.ad_layout == "sparse"),
            int(cm.cu_layout == "sparse"), cm.n_table, T1, R, cm.n_words,
            TW, cm.ct_occ_inst.shape[1])
    if max(dims) >= 2 ** 31:
        raise ValueError(f"model {cm.name or '<unnamed>'}: a size passes "
                         f"int32 ({dims})")
    return ((ctypes.c_void_p * len(tables))(*(t.data_ptr() for t in tables)),
            (ctypes.c_int * len(dims))(*dims))


def _lib(dtype: str, clocks: bool = False):
    """The fixpoint library of a model's width, or with `clocks` the one
    whose sweeps stamp every phase (``fixpoint_clocks``)."""
    from repro_torch.kernels.build import load, variant
    lib = load("fixpoint", variant(dtype, clocks=clocks))
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.fixpoint_launch.argtypes = [ptr] * 10 + [i32] * 3 + [ptr]
        lib.fixpoint_launch.restype = i32
        lib.fixpoint_error_string.argtypes = [i32]
        lib.fixpoint_error_string.restype = ctypes.c_char_p
        lib.fixpoint_occupancy.argtypes = [i32] * 5
        lib.fixpoint_occupancy.restype = i32
        if clocks:
            lib.fixpoint_clocks.argtypes = [ptr]
            lib.fixpoint_clocks.restype = i32
        lib._typed = True
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(cm, lb, ub, dom=None):
    if cm.dtype not in ("int32", "int64"):
        raise TypeError(f"fixpoint_cuda: model {cm.name or '<unnamed>'} "
                        f"compiled to {cm.dtype}, not int32 or int64")
    if lb.dtype != cm.tdtype or ub.dtype != cm.tdtype:
        raise TypeError(f"fixpoint_cuda: stores must be {cm.dtype} (the "
                        f"model's width), got {lb.dtype}/{ub.dtype}")
    if lb.dim() != 2 or lb.shape != ub.shape or lb.shape[1] != cm.n_vars:
        raise ValueError(f"fixpoint_cuda: stores must be [L, {cm.n_vars}], "
                         f"got {tuple(lb.shape)}/{tuple(ub.shape)}")
    if not (lb.is_contiguous() and ub.is_contiguous()):
        raise ValueError("fixpoint_cuda: stores must be contiguous")
    if lb.device != ub.device or cm.device != lb.device:
        raise ValueError(f"fixpoint_cuda: stores on {lb.device}/{ub.device}"
                         f", model tables on {cm.device}")
    if dom is not None:
        want = (lb.shape[0], cm.n_vars, cm.n_words)
        if dom.dtype != torch.int32 or tuple(dom.shape) != want:
            raise ValueError(f"fixpoint_cuda: the bitset store must be "
                             f"int32 {want}, got {dom.dtype} "
                             f"{tuple(dom.shape)}")
        if not dom.is_contiguous() or dom.device != lb.device:
            raise ValueError(f"fixpoint_cuda: the bitset store must be "
                             f"contiguous on {lb.device}")


def fixpoint_cuda(cm, lb, ub, dom=None, *, max_sweeps=None):
    """Run every lane of ``[L, V]`` stores at the model's width (and,
    given, their ``[L, V, W]`` int32 bitset store) to its fixed point.

    Returns (lb', ub', sweeps i32[L], converged bool[L]), with dom'
    before the counters when `dom` is given, equal to
    `fixpoint_batch(cm, lb, ub, dom, max_iters=max_sweeps)`.
    ``max_sweeps`` None is uncapped.  On the card the launch runs the
    instance `instance_threads` picks for L lanes.
    """
    if lb.device.type == "cpu":
        trace.launch("fixpoint_batch")
        return F.fixpoint_batch(cm, lb, ub, dom, max_iters=max_sweeps)
    if lb.device.type != "cuda":
        raise ValueError(f"fixpoint_cuda: unsupported device {lb.device}")
    threads = instance_threads(lb.shape[0], _sm_count(lb.device.index
                                                       or 0))
    out, launched = launch_fixpoint(_lib(cm.dtype), cm, lb, ub, dom,
                                    max_sweeps, threads)
    if launched:
        fixpoint_cuda.launches += 1
        if threads == FEW_THREADS:
            fixpoint_cuda.few_lane_launches += 1
    return out


# every launch, and those of the few-lane instance among them
fixpoint_cuda.launches = 0
fixpoint_cuda.few_lane_launches = 0


def launch_fixpoint(lib, cm, lb, ub, dom, max_sweeps, threads):
    """One launch of `lib`'s fixpoint kernel (`_lib`) on CUDA tensors at
    `threads` per CTA (THREADS or FEW_THREADS), counted nowhere: the
    body of `fixpoint_cuda`, and of the clock breakdown of
    ``chip_smoke.py`` on the ``clocks`` library.  Returns (the outputs
    of `fixpoint_cuda`, whether a kernel was launched: not for 0
    lanes)."""
    _check(cm, lb, ub, dom)
    fit_smem(cm, dom=dom is not None)
    L = lb.shape[0]
    lb_out, ub_out = torch.empty_like(lb), torch.empty_like(ub)
    dom_out = None if dom is None else torch.empty_like(dom)
    sweeps = torch.empty(L, dtype=torch.int32, device=lb.device)
    conv = torch.empty(L, dtype=torch.int32, device=lb.device)
    out = (lb_out, ub_out) + (() if dom is None else (dom_out,))
    if L == 0:
        return out + (sweeps, conv.bool()), False
    cap = UNCAPPED if max_sweeps is None else int(max_sweeps)
    if cap < 0:
        raise ValueError(f"fixpoint_cuda: max_sweeps must be >= 0, got {cap}")
    tables = _c_tables(cm)
    trace.launch("fixpoint_few_kernel" if threads == FEW_THREADS
                 else "fixpoint_kernel")
    err = lib.fixpoint_launch(
        *tables, lb.data_ptr(), ub.data_ptr(), lb_out.data_ptr(),
        ub_out.data_ptr(), sweeps.data_ptr(), conv.data_ptr(),
        None if dom is None else dom.data_ptr(),
        None if dom is None else dom_out.data_ptr(), L, cap, threads,
        torch.cuda.current_stream(lb.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"fixpoint_cuda: launch failed ({threads} threads per CTA): "
            + lib.fixpoint_error_string(err).decode())
    return out + (sweeps, conv.bool()), True


# --------------------------------------------------------------------------
# Resident search: K supersteps per launch
# --------------------------------------------------------------------------

_VAR_CODES = {S.INPUT_ORDER: 0, S.MIN_DOM: 1, S.MIN_LB: 2}
_VAL_CODES = {S.VAL_MIN: 0, S.VAL_SPLIT: 1, S.VAL_MIDDLE_OUT: 2}
_BOOL_FIELDS = ("dec_flip", "fresh", "done", "incomplete", "has_sol")
_DOM_FIELDS = ("dom", "root_dom")
# the LaneState fields the kernel carries, in csrc/search.cu State order
_STATE_FIELDS = S.LaneState._fields


def _gdone(st: S.LaneState, stop_on_first: bool) -> bool:
    g = bool(st.done.all())
    if stop_on_first:
        g = g or bool(st.has_sol.any())
    return g


def lane_tiles(n_lanes: int, lane_tile) -> tuple:
    """(tile, NT) of a lane-tiled launch: ``tile = max(1, min(lane_tile,
    L))`` lanes per tile and ``NT = ceil(L / tile)`` tiles, the last one
    short when ``tile`` does not divide L (the reference pads it with
    inert lanes, which change nothing).  The reference also halves its
    tile until the tile's VMEM budget fits (``fit_lane_tile``); here a
    CTA holds one lane whatever the tile, so the tile is never halved and
    `fit_smem` raises when one lane does not fit."""
    tile = max(1, min(int(lane_tile), n_lanes))
    return tile, -(-n_lanes // tile)


def _search_steps(cm, subs_lb, subs_ub, st, gbest, it, head, opts,
                  supersteps, stop_on_first, tile_id=0, n_tiles=1):
    it = int(it)
    for _ in range(supersteps):
        if _gdone(st, stop_on_first):
            break
        st, head = S.lanes_step(cm, subs_lb, subs_ub, opts, st, gbest,
                                head, tile_id=tile_id, n_tiles=n_tiles)
        gbest = torch.minimum(gbest, S.lanes_best(st))
        it += 1
    return st, gbest, it, head


def search_plain(cm, subs_lb, subs_ub, st: S.LaneState, gbest, it,
                 pool_head, *, supersteps: int = 16, lane_tile: int = 0,
                 max_sweeps: int = 16384, max_fixpoint_iters=None,
                 var_strategy: str = S.INPUT_ORDER,
                 val_strategy: str = S.VAL_MIN,
                 stop_on_first: bool = False):
    """The plain version of `search_cuda`: K = `supersteps` guarded
    `search.lanes_step` iterations with the gather fixpoint, capped at
    ``max_fixpoint_iters`` sweeps or else `max_sweeps` (as the
    reference's kernel).  A superstep that starts with the global done
    flag set is skipped, so ``it`` counts only the live ones.

    ``lane_tile=0`` (or None): one pool queue over all lanes.  Returns
    ``(st', gbest', it', pool_head', stopped)``: the bound, the superstep
    count and the pool cursor as 0-d tensors, `stopped` the global done
    flag of ``st'`` as a 0-d bool tensor.

    ``lane_tile=N``: the reference's lane tiles (`lane_tiles`).  Tile t
    runs the supersteps on lanes ``[t·tile, min(L, (t+1)·tile))`` on its
    own: it draws pool indices t, t+NT, … (`search.dispatch_pool_tile`)
    with its own cursor ``pool_head[t]`` (a scalar `pool_head` is given
    to every tile), and keeps its own bound (from `gbest`), superstep
    count and done flag.  Returns heads ``[NT]``, the least bound, the
    largest superstep count and whether every tile stopped.
    """
    dev = st.lb.device
    cap = max_sweeps if max_fixpoint_iters is None else max_fixpoint_iters
    opts = S.SearchOptions(var_strategy=var_strategy,
                           val_strategy=val_strategy,
                           max_depth=st.dec_var.shape[1],
                           max_fixpoint_iters=cap,
                           stop_on_first=stop_on_first, backend="gather")
    gbest = torch.as_tensor(gbest, dtype=st.best_obj.dtype, device=dev)
    if lane_tile in (0, None):
        head = torch.as_tensor(pool_head, dtype=torch.int32, device=dev)
        st, gbest, it, head = _search_steps(
            cm, subs_lb, subs_ub, st, gbest, it, head, opts, supersteps,
            stop_on_first)
        return (st, gbest, torch.tensor(it, dtype=torch.int32, device=dev),
                head, torch.tensor(_gdone(st, stop_on_first), device=dev))
    L = st.lb.shape[0]
    tile, NT = lane_tiles(L, lane_tile)
    heads = torch.as_tensor(pool_head, dtype=torch.int32,
                            device=dev).reshape(-1).expand(NT)
    parts, bests, its, heads_out, stops = [], [], [], [], []
    for t in range(NT):
        lanes = slice(t * tile, min(L, (t + 1) * tile))
        st_t = S.LaneState(*(None if a is None else a[lanes] for a in st))
        st_t, g, n, h = _search_steps(
            cm, subs_lb, subs_ub, st_t, gbest, it, heads[t], opts,
            supersteps, stop_on_first, tile_id=t, n_tiles=NT)
        parts.append(st_t)
        bests.append(g)
        its.append(n)
        heads_out.append(h)
        stops.append(_gdone(st_t, stop_on_first))
    st = S.LaneState(*(None if f[0] is None else torch.cat(f)
                       for f in zip(*parts)))
    return (st, torch.stack(bests).min(),
            torch.tensor(max(its), dtype=torch.int32, device=dev),
            torch.stack(heads_out).to(torch.int32),
            torch.tensor(all(stops), device=dev))


def _search_lib(dtype: str, tiles: bool, clocks: bool = False):
    """The search library of a model's width and mode, or with `clocks`
    the one whose supersteps and sweeps stamp every phase
    (``search_clocks``)."""
    from repro_torch.kernels.build import load, variant
    lib = load("search", variant(dtype, tiles, clocks))
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.search_launch.argtypes = [ptr] * 6
        lib.search_launch.restype = i32
        lib.search_grid.argtypes = [i32, ptr, ptr, i32]
        lib.search_grid.restype = i32
        lib.search_occupancy.argtypes = [i32] * 4
        lib.search_occupancy.restype = i32
        if clocks:
            lib.search_clocks.argtypes = [ptr]
            lib.search_clocks.restype = i32
        lib.search_error_string.argtypes = [i32]
        lib.search_error_string.restype = ctypes.c_char_p
        lib.search_max_slots.argtypes = []
        lib.search_max_slots.restype = i32
        lib._typed = True
    return lib


# LaneState fields at the model's width; the others are int32 (or bool,
# or the int32 bitset words)
_VALUE_FIELDS = ("lb", "ub", "root_lb", "root_ub", "dec_val", "best_obj",
                 "best_sol")


def _check_search(cm, subs_lb, subs_ub, st, var_strategy, val_strategy):
    _check(cm, st.lb, st.ub)
    if var_strategy not in _VAR_CODES:
        raise ValueError(f"search_cuda: var_strategy {var_strategy!r} not "
                         f"in {tuple(_VAR_CODES)}")
    if val_strategy not in _VAL_CODES:
        raise ValueError(f"search_cuda: val_strategy {val_strategy!r} not "
                         f"in {tuple(_VAL_CODES)}")
    if (st.dom is None) != (st.root_dom is None):
        raise ValueError("search_cuda: LaneState.dom and root_dom must be "
                         "both given or both None")
    if val_strategy == S.VAL_MIDDLE_OUT and st.dom is None:
        raise ValueError("search_cuda: middle_out needs the bitset store "
                         "(LaneState.dom); init_lanes carries it")
    L, V = st.lb.shape
    MD = st.dec_var.shape[1]
    if L == 0:
        raise ValueError("search_cuda: no lanes")
    shapes = {f: (L, V) for f in ("lb", "ub", "root_lb", "root_ub",
                                  "best_sol")}
    shapes.update({f: (L, MD) for f in ("dec_var", "dec_val", "dec_flip")})
    shapes.update({f: (L, V, cm.n_words) for f in _DOM_FIELDS})
    for f in _STATE_FIELDS:
        a = getattr(st, f)
        if a is None and f in _DOM_FIELDS:
            continue
        dt = (torch.bool if f in _BOOL_FIELDS
              else cm.tdtype if f in _VALUE_FIELDS else torch.int32)
        if a.dtype != dt or tuple(a.shape) != shapes.get(f, (L,)):
            raise ValueError(
                f"search_cuda: LaneState.{f} must be {dt} "
                f"{shapes.get(f, (L,))}, got {a.dtype} {tuple(a.shape)}")
        if a.device != st.lb.device:
            raise ValueError(f"search_cuda: LaneState.{f} on {a.device}, "
                             f"stores on {st.lb.device}")
    for a in (subs_lb, subs_ub):
        if a.dtype != cm.tdtype or a.dim() != 2 or a.shape[1] != V \
                or a.shape[0] < 1:
            raise ValueError(f"search_cuda: the pool must be {cm.dtype} "
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
    ``search_pallas``), for int32 and int64 models (the library of the
    model's width).

    Arguments mirror one host-loop carry: the `LaneState`, the 0-d bound
    `gbest`, the superstep count `it` (int or 0-d tensor) and the pool
    cursor.  ``lane_tile=0`` (or None) runs one pool queue over all lanes
    (0-d cursor); ``lane_tile=N`` runs the reference's lane tiles
    (`lane_tiles`, `search_plain`): one cursor per tile (``[NT]``, or a
    scalar given to every tile) and its own bound, superstep count and
    done flag, in the ``tiles`` library.  Returns ``(st', gbest', it',
    pool_head', stopped)``, equal to `search_plain` on the same inputs.
    The inputs are left untouched.
    """
    if supersteps < 0:
        raise ValueError(f"search_cuda: supersteps must be >= 0, got "
                         f"{supersteps}")
    kw = dict(supersteps=supersteps, lane_tile=lane_tile,
              max_sweeps=max_sweeps, max_fixpoint_iters=max_fixpoint_iters,
              var_strategy=var_strategy, val_strategy=val_strategy,
              stop_on_first=stop_on_first)
    dev = st.lb.device
    if dev.type == "cpu":
        trace.launch("search_plain")
        return search_plain(cm, subs_lb, subs_ub, st, gbest, it,
                            pool_head, **kw)
    if dev.type != "cuda":
        raise ValueError(f"search_cuda: unsupported device {dev}")
    out = launch_search(_search_lib(cm.dtype, lane_tile not in (0, None)),
                        cm, subs_lb, subs_ub, st, gbest, it, pool_head, **kw)
    search_cuda.launches += 1
    return out


# every launch, and those over a batch of slots among them
# (`search_slots_cuda`)
search_cuda.launches = 0
search_cuda.slot_launches = 0


def _check_slots(cms, subs_lb, subs_ub, st, gbest, var_strategy,
                 val_strategy):
    """What a launch over slots needs besides `_check_search`'s checks on
    the whole state and slot 0's model: one model per slot, all of one
    shape signature (so every size of the launch is one value), the
    lanes split evenly, a pool ``[NB, S, V]`` and a bound per slot."""
    from repro_torch.core.api import shape_signature
    NB = len(cms)
    if NB < 1:
        raise ValueError("search_cuda: no slots")
    sig = shape_signature(cms[0])
    for i, c in enumerate(cms[1:], 1):
        if shape_signature(c) != sig:
            raise ValueError(
                f"search_cuda: slot {i}'s shape signature "
                f"{shape_signature(c)} differs from slot 0's {sig}")
        if c.device != cms[0].device:
            raise ValueError(f"search_cuda: slot {i}'s model on {c.device}, "
                             f"slot 0's on {cms[0].device}")
    if subs_lb.dim() != 3 or subs_lb.shape[0] != NB \
            or subs_ub.shape != subs_lb.shape:
        raise ValueError(f"search_cuda: the pools must be [{NB}, S, V], got "
                         f"{tuple(subs_lb.shape)}/{tuple(subs_ub.shape)}")
    _check_search(cms[0], subs_lb[0], subs_ub[0], st, var_strategy,
                  val_strategy)
    L = st.lb.shape[0]
    if L % NB:
        raise ValueError(f"search_cuda: {L} lanes do not split into {NB} "
                         "slots")
    if tuple(torch.as_tensor(gbest).shape) != (NB,):
        raise ValueError(f"search_cuda: the bounds must be [{NB}], got "
                         f"{tuple(torch.as_tensor(gbest).shape)}")


def _slot_heads(pool_head, NB, TPS, dev):
    """The cursors ``[NB]`` (one queue per slot) or ``[NB, TPS]`` (lane
    tiles; ``[NB]`` gives each slot's cursor to every tile of it)."""
    h = torch.as_tensor(pool_head, device=dev).to(torch.int32)
    if TPS == 0:
        return h.reshape(NB)
    return h.reshape(NB, -1).expand(NB, TPS)


def search_slots_plain(cms, subs_lb, subs_ub, st: S.LaneState, gbest, it,
                       pool_head, *, supersteps: int = 16,
                       lane_tile: int = 0, max_sweeps: int = 16384,
                       max_fixpoint_iters=None,
                       var_strategy: str = S.INPUT_ORDER,
                       val_strategy: str = S.VAL_MIN,
                       stop_on_first: bool = False):
    """The plain version of `search_slots_cuda`: `search_plain` run slot
    by slot, on slot i's rows ``[i·n, (i+1)·n)`` of the state (n = L /
    NB), its model ``cms[i]``, its pool ``subs_lb[i]``, bound
    ``gbest[i]``, superstep count ``it[i]`` and cursor(s)
    ``pool_head[i]``.  Returns ``(st', gbest' [NB], it' [NB], pool_head'
    ([NB], or [NB, TPS] with lane tiles), stopped [NB])``."""
    NB, dev = len(cms), st.lb.device
    n = st.lb.shape[0] // NB
    its = torch.as_tensor(it).reshape(NB).tolist()
    TPS = lane_tiles(n, lane_tile)[1] if lane_tile not in (0, None) else 0
    heads = _slot_heads(pool_head, NB, TPS, dev)
    kw = dict(supersteps=supersteps, lane_tile=lane_tile,
              max_sweeps=max_sweeps, max_fixpoint_iters=max_fixpoint_iters,
              var_strategy=var_strategy, val_strategy=val_strategy,
              stop_on_first=stop_on_first)
    outs = []
    for i, cm in enumerate(cms):
        rows = slice(i * n, (i + 1) * n)
        st_i = S.LaneState(*(None if a is None else a[rows] for a in st))
        outs.append(search_plain(cm, subs_lb[i], subs_ub[i], st_i,
                                 torch.as_tensor(gbest)[i], its[i],
                                 heads[i], **kw))
    st_out = S.LaneState(*(None if f[0] is None else torch.cat(f)
                           for f in zip(*(o[0] for o in outs))))
    return (st_out, torch.stack([o[1] for o in outs]),
            torch.stack([o[2] for o in outs]).to(torch.int32),
            torch.stack([o[3] for o in outs]).to(torch.int32),
            torch.stack([o[4] for o in outs]))


def search_slots_cuda(cms, subs_lb, subs_ub, st: S.LaneState, gbest, it,
                      pool_head, *, supersteps: int = 16,
                      lane_tile: int = 0, max_sweeps: int = 16384,
                      max_fixpoint_iters=None,
                      var_strategy: str = S.INPUT_ORDER,
                      val_strategy: str = S.VAL_MIN,
                      stop_on_first: bool = False):
    """K = `supersteps` supersteps of NB = len(cms) independent searches
    in ONE launch of ``csrc/search.cu``'s lane-tiled library (one per 8
    slots of a wider batch: the slots' tables ride in the kernel's
    parameters, ``search_max_slots``): the counterpart of the
    reference's ``search_pallas`` under ``jax.vmap`` over a
    `LaneBatch`'s slots.  Slot i holds lanes ``[i·n, (i+1)·n)`` of
    `st` (n = L / NB) and has its own model ``cms[i]`` (every slot of one
    shape signature), pool ``subs_lb[i]`` (``[NB, S, V]``), bound
    ``gbest[i]``, superstep count ``it[i]``, cursor ``pool_head[i]`` (with
    ``lane_tile=N`` one per tile of the slot, ``[NB, TPS]``) and stop
    flag; one queue per slot without `lane_tile`.  A stopped or idle
    slot (every lane done) runs identity supersteps.

    Returns `search_slots_plain`'s outputs, equal to them on the same
    inputs, and each slot's equal to a `search_cuda` launch on that slot
    alone.  On CPU tensors it runs `search_slots_plain`; on CUDA tensors
    it launches or raises.  The inputs are left untouched."""
    if supersteps < 0:
        raise ValueError(f"search_cuda: supersteps must be >= 0, got "
                         f"{supersteps}")
    _check_slots(cms, subs_lb, subs_ub, st, gbest, var_strategy,
                 val_strategy)
    kw = dict(supersteps=supersteps, lane_tile=lane_tile,
              max_sweeps=max_sweeps, max_fixpoint_iters=max_fixpoint_iters,
              var_strategy=var_strategy, val_strategy=val_strategy,
              stop_on_first=stop_on_first)
    dev = st.lb.device
    if dev.type == "cpu":
        return search_slots_plain(cms, subs_lb, subs_ub, st, gbest, it,
                                  pool_head, **kw)
    if dev.type != "cuda":
        raise ValueError(f"search_cuda: unsupported device {dev}")
    NB, L = len(cms), st.lb.shape[0]
    n = L // NB
    tiled = lane_tile not in (0, None)
    tile, TPS = lane_tiles(n, lane_tile) if tiled else (n, 1)
    heads = _slot_heads(pool_head, NB, TPS if tiled else 0, dev)
    heads = heads.reshape(NB, TPS)
    its = torch.as_tensor(it).reshape(NB).tolist()
    gbest = torch.as_tensor(gbest, device=dev)
    lib = _search_lib(cms[0].dtype, True)
    # a launch takes at most `m` slots (their tables ride in the kernel's
    # parameters): a wider batch takes one launch per `m` slots
    m = lib.search_max_slots()
    parts, outs = [], []
    for a in range(0, NB, m):
        b = min(NB, a + m)
        rows = slice(a * n, b * n)
        st_ab = S.LaneState(*(None if x is None else x[rows] for x in st))
        st_out, res = _launch(
            lib, True, list(cms[a:b]), subs_lb[a:b], subs_ub[a:b], st_ab,
            gbest[a:b], its[a:b], heads[a:b].reshape(-1), tile,
            (b - a) * TPS, supersteps, max_sweeps, max_fixpoint_iters,
            var_strategy, val_strategy, stop_on_first)
        search_cuda.launches += 1
        search_cuda.slot_launches += 1
        parts.append(st_out)
        outs.append(res.reshape(4, b - a, TPS))
    st_out = (parts[0] if len(parts) == 1 else
              S.LaneState(*(None if f[0] is None else torch.cat(f)
                            for f in zip(*parts))))
    res = torch.cat(outs, dim=1)
    heads_out = res[2].to(torch.int32)
    return (st_out, res[0].min(1).values, res[1].max(1).values.to(torch.int32),
            heads_out if tiled else heads_out[:, 0],
            (res[3] != 0).all(1))


def launch_search(lib, cm, subs_lb, subs_ub, st: S.LaneState, gbest, it,
                  pool_head, *, supersteps: int = 16, lane_tile: int = 0,
                  max_sweeps: int = 16384, max_fixpoint_iters=None,
                  var_strategy: str = S.INPUT_ORDER,
                  val_strategy: str = S.VAL_MIN,
                  stop_on_first: bool = False):
    """One launch of `lib`'s search kernel (`_search_lib`) on CUDA
    tensors, with `search_cuda`'s arguments, counted nowhere: the body of
    `search_cuda`, and of the superstep clock breakdown of
    ``chip_smoke.py`` on the ``clocks`` library.  Returns `search_cuda`'s
    outputs."""
    _check_search(cm, subs_lb, subs_ub, st, var_strategy, val_strategy)
    tiled = lane_tile not in (0, None)
    L = st.lb.shape[0]
    tile, NT = lane_tiles(L, lane_tile) if tiled else (L, 1)
    dev = st.lb.device
    head = torch.as_tensor(pool_head, device=dev).to(torch.int32)
    head = head.reshape(-1).expand(NT) if tiled else head.reshape(1)
    st_out, res = _launch(lib, tiled, [cm], subs_lb[None], subs_ub[None],
                          st, torch.as_tensor(gbest, device=dev).reshape(1),
                          [int(it)], head, tile, NT, supersteps, max_sweeps,
                          max_fixpoint_iters, var_strategy, val_strategy,
                          stop_on_first)
    if tiled:
        return (st_out, res[0].min(), res[1].max().to(torch.int32),
                res[2].to(torch.int32), (res[3] != 0).all())
    return (st_out, res[0, 0], res[1, 0].to(torch.int32),
            res[2, 0].to(torch.int32), res[3, 0] != 0)


def _launch(lib, tiled, cms, subs_lb, subs_ub, st, gbest, its, heads,
            tile, NT, supersteps, max_sweeps, max_fixpoint_iters,
            var_strategy, val_strategy, stop_on_first):
    """One launch of `lib` (the lane-tiled library if `tiled`) over
    NB = len(cms) slots of L / NB lanes each (at most
    ``lib.search_max_slots()``: one in the one-queue library), every slot
    in NT / NB tiles of `tile` lanes: the pools ``[NB, S, V]``, the bounds ``[NB]``, the superstep
    counts `its` (NB ints) and the cursors ``[NT]`` on the card.  Returns
    (the LaneState after the launch, the ``[4, NT]`` outputs: bound,
    superstep count, cursor and stop flag of each tile)."""
    cm = cms[0]
    fit_smem(cm, resident=True, dom=st.dom is not None)
    cap = max_sweeps if max_fixpoint_iters is None else max_fixpoint_iters
    if cap < 0:
        raise ValueError(f"search_cuda: the sweep cap must be >= 0, got "
                         f"{cap}")
    dev, L = st.lb.device, st.lb.shape[0]
    NB = len(cms)
    vt = cm.tdtype
    # the kernel updates copies in place; bools travel as int32 0/1
    out = {f: (None if getattr(st, f) is None
               else getattr(st, f).to(torch.int32) if f in _BOOL_FIELDS
               else getattr(st, f).clone(memory_format=torch.contiguous_format))
           for f in _STATE_FIELDS}
    gbest_in = gbest.to(device=dev, dtype=vt).contiguous()
    heads = heads.to(device=dev, dtype=torch.int32).contiguous()
    # the want flags, then a lane-claim counter per superstep parity
    want = torch.empty(L + 2, dtype=torch.int32, device=dev)
    # one queue: 5 cells; lane tiles: 5 kinds x 2 parities x NT
    cells = torch.empty(10 * NT if tiled else 5, dtype=vt, device=dev)
    res = torch.empty((4, NT), dtype=vt, device=dev)
    subs_lb, subs_ub = subs_lb.contiguous(), subs_ub.contiguous()
    bv = torch.stack([c.branch_vars.to(torch.int32) for c in cms]) \
        .contiguous()
    io = (bv, subs_lb, subs_ub, gbest_in, heads, want, cells, res)
    ints = (L, bv.shape[1], subs_lb.shape[1], st.dec_var.shape[1],
            cm.obj_var, supersteps, cap, _VAR_CODES[var_strategy],
            _VAL_CODES[val_strategy], int(stop_on_first), int(its[0]), tile,
            NT, NB, L // NB, NT // NB, *map(int, its[1:]))
    ctab = [_c_tables(c) for c in cms]
    tables = (ctypes.c_void_p * (NB * len(ctab[0][0])))(
        *(p for c, _ in ctab for p in c))

    def ptrs(ts):
        return (ctypes.c_void_p * len(ts))(
            *(None if t is None else t.data_ptr() for t in ts))

    trace.launch("search_kernel")
    err = lib.search_launch(
        tables, ctab[0][1], ptrs([out[f] for f in _STATE_FIELDS]), ptrs(io),
        (ctypes.c_int * len(ints))(*ints),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("search_cuda: launch failed: "
                           + lib.search_error_string(err).decode())
    st_out = S.LaneState(**{f: (out[f] != 0 if f in _BOOL_FIELDS
                                else out[f]) for f in _STATE_FIELDS})
    return st_out, res


def search_grid(cm, n_lanes: int, dom: bool = False,
                lane_tile: int = 0) -> int:
    """CTAs one `search_cuda` launch over `n_lanes` lanes uses on this
    card (with a carried bitset store if `dom`): min(lanes, co-resident
    CTAs).  Builds the kernel of the model's width and mode."""
    lib = _search_lib(cm.dtype, lane_tile not in (0, None))
    g = lib.search_grid(n_lanes, *_c_tables(cm), int(dom))
    if g < 0:
        raise RuntimeError("search_cuda: no grid: "
                           + lib.search_error_string(-g).decode())
    return g
