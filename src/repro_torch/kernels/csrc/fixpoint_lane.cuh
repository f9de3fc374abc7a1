// One lane's propagation fixpoint, run by one CTA: the device code that
// `fixpoint.cu` (one launch per fixpoint) and `search.cu` (K supersteps
// per launch) share.
//
// It covers every bank of the reference: ReifLinLe
// (`fixpoint.candidates_tile`), AllDifferent in both layouts
// (`alldiff_candidates_tile`, `alldiff_candidates_sparse_tile`),
// Cumulative in both layouts (`cumulative_candidates_tile`,
// `cumulative_candidates_sparse_tile`) and Compact-Table over the bitset
// domain store (`ct_candidates_tile`, `_gather_join_dom`,
// `dom_normalize_tile`).  The plain PyTorch version is
// repro_torch/core/fixpoint.py::fixpoint_batch; results (stores, domain
// words, sweep counts, convergence flags) are equal bit for bit, capped
// or not.
//
// Design (TURBO's block-per-subproblem mapping), for a CTA of NT threads
// (a template parameter: 256 in the many-lane instances and in search.cu,
// 1024 in fixpoint.cu's few-lane ones; every phase is written once):
//   * the lane's current and next lb/ub live in shared memory,
//     double-buffered, so every sweep reads only the old store (Jacobi,
//     as the reference: capped stores and sweep counts match);
//   * per sweep: (1) the linear rows by (row, term): a group of GL lanes
//     per row, a term each (GL the next power of two of K, at most 32 and
//     at most NT / P1, so 1 when the rows alone fill the CTA: then a
//     thread's terms are independent loads, as today's one-row loop);
//     smin/smax are integer sums reduced in the group by __shfl_xor, each
//     lane writes its own term's candidates and the group's first lane
//     the entailment pair; threads over AllDifferent members stage the
//     shifted bounds yl/yu [A1, N]; threads over (row, task) add ±q at
//     the ends of each compulsory part to the [C1, H] difference array
//     (shared-memory atomicAdd: integer sums commute); (2) a warp per
//     Cumulative row prefix-sums the difference array into the profile
//     and flags overload; threads over AllDifferent members build their
//     bitmasks, then threads over upper endpoints count the members
//     inside each [yl_i, yu_j] by popc and push (below), threads over
//     (row, task) find the first and last feasible start; (3) the join
//     by lane groups: GJ lanes per variable (the largest power of two
//     with GJ·V <= NT, at most 32) stride its occurrence lists and
//     max/min-reduce by __shfl_xor (max and min commute, so the result
//     is the serial one); the group's first lane clamps to the box and
//     writes the next store (a sparse bank writes its sort keys in (1)
//     and sorts and scans in (2), below);
//     The many-lane instance keeps GL = GJ = 1 (a thread per row and per
//     variable) and the shared-memory sort, and its bitset-store
//     instances the C1·H·T profile loop: its CTAs share an SM, and those
//     phases' registers would cost it CTAs per SM;
//   * `__syncthreads_or` ends the loop on the per-lane rule
//     changed ∧ it < max_sweeps ∧ ¬failed, so every thread leaves with
//     the same sweep count, flags and result buffer.
// The tables stay read-only in global memory (they sit in L2); only the
// cumulative task table is staged in shared memory, once per CTA.
//
// Dense AllDifferent (the reference's [L, A1, N, N, N] tensor is its
// specification, not carried over): every endpoint pair (i, j) of a row
// tests I = [yl_i, yu_j] against the row's members as bitmasks.  Each
// sweep first builds, per member, W = ceil(N / 32) words of four sets —
// GEL_i = {k : yl_k >= yl_i} and GEU_i = {k : yu_k >= yl_i} by its lower
// bound, LEU_j = {k : yu_k <= yu_j} and LEL_j = {k : yl_k <= yu_j} by its
// upper bound — and NE = {k : yl_k <= yu_k} per row (`ad_dense_masks`, a
// thread per member and word; 5·N²·W compares per row).  Then a thread
// per upper endpoint j walks the lower endpoints i (`ad_dense_hall`): the
// members inside I are GEL_i & LEU_j & NE, counted by popc (N²·W ANDs and
// popcs per row, where a count per pair over the members took 4·N³).
// More than the width of I fails the row (a per-row flag); exactly as
// many makes I a Hall interval, and the members outside I with their
// lower bound in it (GEL_i & LEL_j) or their upper bound in it (GEU_i &
// LEU_j) are pushed out with a shared-memory atomicMax/atomicMin on the
// row's candidate pair.  Those commute, so the pair equals the
// reference's max/min over (i, j).  Spare threads (a CTA wider than the
// rows' members) split each member's or endpoint's loop (`slices`).  The
// few-lane instance at int64 keeps the form the bitmask pass replaced, a
// thread per pair counting over the members (`ad_dense_pairs`): there the
// bitmask pass does not fit its 64 registers a thread.
// Padded members are staged as the empty interval yl = BIG > yu = -BIG:
// no pair starts or ends at one, it is never inside (not in NE; a real
// member of a store that is swept has yl <= yu) and never pushed (not in
// LEL_j nor GEU_i: real bounds stay inside the box, far from ±BIG).  The
// join reads the pair through ad_occ_inst/ad_occ_pos, with a failed
// row's lb candidates at -NEU_LB, shifted back by the member's offset, as
// the reference.
//
// The sparse layouts (packed/CSR rows: members or tasks of every row on
// one axis of M slots with a segment id each, padding in segment A or C)
// share a bitonic sort of 64-bit keys in shared memory (`block_sort`; at
// n <= NT each thread holds a key in registers and the in-warp steps
// exchange by __shfl_xor, so n = 1024 takes 21 barriers for 55 steps).
// Signed values are biased (x ^ 0x80000000) before they are packed, so
// the key order equals the reference's lexsort on every int32.
//   * Cumulative: each packed task writes two events, (seg, lst, 1) with
//     +q and (seg, ect, 0) with -q (delta 0 without a compulsory part,
//     and every slot writes both: the interval bounds depend on all of
//     them).  After the sort a block prefix sum gives the profile; an
//     event owns [u, v) up to the next event of its segment.  Under the
//     seg-major sort segment c's events are sorted positions
//     [2·cu_ptr[c], 2·cu_ptr[c+1]), so two threads per task run the
//     forward and the backward monotone-jump scan over its own segment
//     only (the reference scans all events under a same-segment mask),
//     each from a binary-searched start to the first event that can no
//     longer move it (`cu_sparse_starts`).  Keys
//     that tie only span empty intervals, and the group's last event
//     carries the group's whole sum, so the order among ties changes
//     nothing.
//   * AllDifferent: members sort by (seg, yl).  One thread per upper
//     endpoint j walks its segment from the end, keeping the suffix count
//     of members with yu <= yu_j; at the first sorted position of each
//     yl value that count is cnt(i, j) for every i of that value (so ties
//     are harmless).  Overflow fails the row; a Hall interval folds into
//     min_inf[j] (the thread's own) and max_sup at the value's first
//     position (shared-memory atomicMax, which commutes).  One thread per
//     member then pushes over its segment, O(n) each: O(n^2) per row,
//     where the dense bank's endpoint-pair loop is O(n^3).
//
// Compact-Table and the bitset store (template flag DOM, so models
// without tables and without a carried store compile none of it).  The
// domain words of a carried store, [V, W] u32 per lane, are double-
// buffered in shared memory beside lb/ub.  Per sweep, for each table row:
// (1) one thread per (row, member, support word) ORs the supports of the
// member's live values (the set bits of its words, walked with __ffs);
// (2) one thread per (row, support word) ANDs the members' words into
// the current table; (2') one thread per (row, member) tests each value's
// support against the current table: the survivors give the member's
// hull candidates and its domain-word candidates, and an all-zero
// current table fails the row (every real member's lb at -NEU_LB, which
// the box clamp turns into a crossing).  In (3) each variable also joins
// its table occurrences: max/min into lb/ub, AND into its words; then
// `dom_normalize_tile`: a tracked variable loses the bits outside
// [lb, ub] and its bounds tighten to the words' hull (an empty domain
// reads (off + 32·W, off - 1)); an untracked one passes through.  A sweep
// counts as changed when any word moved.  Without a carried store (EPS,
// `fixpoint_cuda` without `dom`) the member words are the transient range
// words of the current bounds (all-ones for an untracked variable), the
// domain candidates are dropped and nothing is normalized.  Tables stay
// in global memory (L2), as the other banks'.
//
// Arithmetic: every value of the store, every candidate and every value
// table is of the model's width, `Val` (int32_t, or int64_t for a model
// compiled to int64); index tables are int32 (the wrappers narrow an
// int64 model's index tables once).  Each kernel source is built once
// per width (FIXLANE_VAL, kernels/build.py).  Floor and ceil division
// follow `_fdiv`/`_cdiv` (C++ `/` truncates toward zero).  The
// compile-time headroom (compile.py) keeps every intermediate the
// reference computes in range, linear products included; this code
// computes no others.  The sparse banks' keys pack (segment, biased
// value, kind) into 64 bits at int32 and into 128 bits at int64
// (`SortKey`), so the key order is the reference's lexsort at both
// widths.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// The value width a library is built for: -DFIXLANE_VAL=int64_t gives the
// int64 instances (kernels/build.py), int32_t is the default.
#ifndef FIXLANE_VAL
#define FIXLANE_VAL int32_t
#endif

namespace fixlane {

// Threads per CTA of the two instances of the fixpoint: the many-lane one
// (fixpoint.cu over more lanes than the card has SMs, and every CTA of
// search.cu), built for throughput, and the few-lane one (fixpoint.cu
// over at most one lane per SM: EPS's root and splits), built for one
// lane's latency.  Every phase is written once, templated on the CTA's
// thread count NT.
constexpr int THREADS = 256;
constexpr int FEW_THREADS = 1024;

// iinfo(Val).max // 4 and the neutral candidates of the model's width
template <typename Val> struct Lim;
template <> struct Lim<int32_t> {
  static constexpr int32_t BIG = 0x7fffffff / 4;
};
template <> struct Lim<int64_t> {
  static constexpr int64_t BIG = 0x7fffffffffffffffLL / 4;
};

template <typename Val>
__device__ __forceinline__ Val fdiv(Val p, Val q) {
  Val r = p / q;
  if ((p % q != 0) && ((p < 0) != (q < 0))) r -= 1;
  return r;
}

template <typename Val>
__device__ __forceinline__ Val cdiv(Val p, Val q) {
  return -fdiv<Val>(-p, q);
}

// Shared-memory atomics at the value's width (sm_90 has the 64-bit ones).
__device__ __forceinline__ void atomic_max(int32_t* a, int32_t v) {
  atomicMax(a, v);
}
__device__ __forceinline__ void atomic_min(int32_t* a, int32_t v) {
  atomicMin(a, v);
}
__device__ __forceinline__ void atomic_add(int32_t* a, int32_t v) {
  atomicAdd(a, v);
}
__device__ __forceinline__ void atomic_add(int64_t* a, int64_t v) {
  atomicAdd((unsigned long long*)a, (unsigned long long)v);   // two's complement
}
__device__ __forceinline__ void atomic_max(int64_t* a, int64_t v) {
  atomicMax((long long*)a, (long long)v);
}
__device__ __forceinline__ void atomic_min(int64_t* a, int64_t v) {
  atomicMin((long long*)a, (long long)v);
}

// The model's propagator tables (global memory, read-only) and shapes.
// The wrappers pass the N_TABLES pointers and N_DIMS sizes in this order
// (kernels/fixpoint_kernel.py::kernel_tables, _c_tables).  Value tables
// are `const Val*`; index tables int32.
template <typename Val>
struct Tables {
  const int32_t* vidx;        // [P1, K]
  const Val* coef;            // [P1, K]
  const Val* rhs;             // [P1]
  const int32_t* bidx;        // [P1]
  const int32_t* occ_prop;    // [V, D]
  const int32_t* occ_slot;    // [V, D]
  const int32_t* ad_vars;     // [A1, N]
  const Val* ad_offs;         // [A1, N]
  const int32_t* ad_mask;     // [A1, N]
  const int32_t* ad_occ_inst; // [V, Dad]
  const int32_t* ad_occ_pos;  // [V, Dad]
  const int32_t* ad_ptr;      // [A+2] packed row starts (CSR)
  const int32_t* ad_pk_var;   // [Mad]
  const Val* ad_pk_off;       // [Mad]
  const int32_t* ad_pk_seg;   // [Mad] row of each slot, A for padding
  const int32_t* cu_svar;     // [C1, T]
  const Val* cu_dur;          // [C1, T]
  const Val* cu_dem;          // [C1, T]
  const Val* cu_cap;          // [C1]
  const int32_t* cu_occ_inst; // [V, Dcu]
  const int32_t* cu_occ_pos;  // [V, Dcu]
  const int32_t* cu_ptr;      // [C+2] packed row starts (CSR)
  const int32_t* cu_pk_svar;  // [Mcu]
  const Val* cu_pk_dur;       // [Mcu]
  const Val* cu_pk_dem;       // [Mcu]
  const int32_t* cu_pk_seg;   // [Mcu] row of each slot, C for padding
  const int32_t* ct_vars;     // [T1, R]
  const int32_t* ct_mask;     // [T1, R]
  const uint32_t* ct_supp;    // [T1, R, 32·W, TW] support bitsets
  const int32_t* ct_occ_inst; // [V, Dct]
  const int32_t* ct_occ_pos;  // [V, Dct]
  const Val* dom_off;         // [V] value of bit 0 (the initial lb)
  const uint32_t* dom_track;  // [V] nonzero: the var has domain words
  const Val* box_lo;          // [V]
  const Val* box_hi;          // [V]
  int V, P1, K, D, A1, N, Dad, n_alldiff, C1, T, Dcu, H, n_cumulative;
  int Mad, Mcu;               // packed slots
  int ad_sparse, cu_sparse;   // layouts: 1 = packed (sparse), 0 = dense
  int n_table, T1, R, W, TW, Dct;   // Compact-Table bank, W = n_words
  int carry_dom;              // set by the launch: a [V, W] store rides
};

constexpr int N_TABLES = 35;
constexpr int N_DIMS = 23;

template <typename Val>
inline Tables<Val> tables_from(const void* const* tb, const int* d,
                               int carry_dom) {
  const int32_t* const* t = (const int32_t* const*)tb;
  const Val* const* v = (const Val* const*)tb;
  return Tables<Val>{t[0],  v[1],  v[2],  t[3],  t[4],  t[5],  t[6],
                     v[7],  t[8],  t[9],  t[10], t[11], t[12], v[13],
                     t[14], t[15], v[16], v[17], v[18], t[19], t[20],
                     t[21], t[22], v[23], v[24], t[25], t[26], t[27],
                     (const uint32_t*)t[28], t[29], t[30], v[31],
                     (const uint32_t*)t[32], v[33], v[34],
                     d[0],  d[1],  d[2],  d[3],  d[4],  d[5],  d[6],
                     d[7],  d[8],  d[9],  d[10], d[11], d[12], d[13],
                     d[14], d[15], d[16], d[17], d[18], d[19], d[20],
                     d[21], d[22], carry_dom};
}

// The kernel instance of a model: Compact-Table or a carried store.
template <typename Val>
__host__ __device__ inline bool uses_dom(const Tables<Val>& p) {
  return p.n_table > 0 || p.carry_dom;
}

// Keys a sparse bank sorts: the next power of two of its events.
__host__ __device__ inline int pow2_at_least(int n) {
  int q = 1;
  while (q < n) q <<= 1;
  return q;
}
template <typename Val>
__host__ __device__ inline int ad_sort_n(const Tables<Val>& p) {
  return pow2_at_least(p.Mad);
}
template <typename Val>
__host__ __device__ inline int cu_sort_n(const Tables<Val>& p) {
  return pow2_at_least(2 * p.Mcu);
}

constexpr int SCAN_WORDS = 32;   // a block scan's per-warp sums

// ---- the per-phase clock breakdown (the `clocks` library only) -----------

// The phases of a sweep that FIXLANE_STAMP times, in sweep order; slot
// N_PHASES counts lane-sweeps.  Built with -DFIXLANE_CLOCKS
// (kernels/build.py variant `clocks`), a barrier ends every phase and
// thread 0 adds the SM clocks since the previous stamp to the phase's
// slot of `clocks`, summed over CTAs and launches (fixpoint.cu
// `fixpoint_clocks` reads and clears it).  The last stamp is kept in
// shared memory, so the stamps hold no register through the sweep (a
// few-lane instance has 64 a thread).  The phases of one step run
// concurrently in the other builds, which have no stamps.
enum Phase {
  PH_LINEAR,      // (1a) ReifLinLe candidates
  PH_AD_STAGE,    // (1b) AllDifferent member bounds or sort keys
  PH_CT_SUPP,     // (1d) Compact-Table supports
  PH_CU_EVENTS,   // (1c) Cumulative events or difference array
  PH_AD_SORT,     // (2a) sparse AllDifferent sort
  PH_AD_MASKS,    // (2a) dense AllDifferent member bitmasks
  PH_AD_HALL,     // (2a) AllDifferent Hall intervals and pushes
  PH_CT_CUR,      // (2c) Compact-Table current tables
  PH_CU_SORT,     // (2b) sparse Cumulative event sort
  PH_CU_PROFILE,  // (2b) profile prefix sum and overload flags
  PH_CU_STARTS,   // (2b) first and last feasible starts
  PH_CT_SURV,     // (2d) Compact-Table survivors
  PH_JOIN,        // (3) join, box clamp, next store, loop flags
  N_PHASES
};

#ifdef FIXLANE_CLOCKS
__device__ unsigned long long clocks[N_PHASES + 1];
#define FIXLANE_STAMP(ph)                                                  \
  do {                                                                     \
    __syncthreads();                                                       \
    if (threadIdx.x == 0) {                                                \
      const long long now_ = clock64();                                    \
      atomicAdd(&fixlane::clocks[ph], (unsigned long long)(now_ - stamp_)); \
      stamp_ = now_;                                                       \
    }                                                                      \
  } while (0)
#else
#define FIXLANE_STAMP(ph) \
  do {                    \
  } while (0)
#endif

// ---- sort keys ------------------------------------------------------------

// Signed values in unsigned order (the bias that makes packed keys sort
// as lexsort does), and back.
__device__ __forceinline__ uint32_t biased(int32_t x) {
  return (uint32_t)x ^ 0x80000000u;
}
__device__ __forceinline__ int32_t unbiased(uint32_t x) {
  return (int32_t)(x ^ 0x80000000u);
}
__device__ __forceinline__ uint64_t biased(int64_t x) {
  return (uint64_t)x ^ 0x8000000000000000ull;
}
__device__ __forceinline__ int64_t unbiased(uint64_t x) {
  return (int64_t)(x ^ 0x8000000000000000ull);
}

// A 128-bit key, compared as (hi, lo).
struct Key128 {
  uint64_t hi, lo;
};
__device__ __forceinline__ bool operator>(const Key128& a, const Key128& b) {
  return a.hi != b.hi ? a.hi > b.hi : a.lo > b.lo;
}
__device__ __forceinline__ bool operator<(const Key128& a, const Key128& b) {
  return b > a;
}

// The sparse banks' packed keys at the model's width.  Cumulative event:
// (segment, time, kind), kind 0 = end at ect, 1 = start at lst, so ends
// sort before starts at equal times.  AllDifferent member: (segment, yl).
// The last key sorts after every real one.
template <typename Val> struct SortKey;
template <> struct SortKey<int32_t> {
  using T = uint64_t;
  static __device__ __forceinline__ T last() { return ~0ull; }
  static __device__ __forceinline__ T event(int seg, int32_t t, int kind) {
    return ((uint64_t)(uint32_t)seg << 33) | ((uint64_t)biased(t) << 1) |
           (uint64_t)kind;
  }
  static __device__ __forceinline__ int event_seg(T k) {
    return (int)(k >> 33);
  }
  static __device__ __forceinline__ int32_t event_time(T k) {
    return unbiased((uint32_t)(k >> 1));
  }
  static __device__ __forceinline__ T member(int seg, int32_t y) {
    return ((uint64_t)(uint32_t)seg << 32) | (uint64_t)biased(y);
  }
  static __device__ __forceinline__ int member_seg(T k) {
    return (int)(k >> 32);
  }
  static __device__ __forceinline__ int32_t member_value(T k) {
    return unbiased((uint32_t)k);
  }
};
// int64: the 65-bit (biased time, kind) spills one bit into hi.
template <> struct SortKey<int64_t> {
  using T = Key128;
  static __device__ __forceinline__ T last() { return Key128{~0ull, ~0ull}; }
  static __device__ __forceinline__ T event(int seg, int64_t t, int kind) {
    const uint64_t b = biased(t);
    return Key128{((uint64_t)(uint32_t)seg << 1) | (b >> 63),
                  (b << 1) | (uint64_t)kind};
  }
  static __device__ __forceinline__ int event_seg(T k) {
    return (int)(k.hi >> 1);
  }
  static __device__ __forceinline__ int64_t event_time(T k) {
    return unbiased((uint64_t)(((k.hi & 1ull) << 63) | (k.lo >> 1)));
  }
  static __device__ __forceinline__ T member(int seg, int64_t y) {
    return Key128{(uint64_t)(uint32_t)seg, biased(y)};
  }
  static __device__ __forceinline__ int member_seg(T k) {
    return (int)k.hi;
  }
  static __device__ __forceinline__ int64_t member_value(T k) {
    return unbiased(k.lo);
  }
};

// ---- the shared-memory budget ----------------------------------------------

// Bytes of a region of n items of T, rounded up to the value width, so
// that every region starts aligned for a value (a no-op at int32).
template <typename Val, typename T>
__host__ __device__ inline size_t region(size_t n) {
  if constexpr (sizeof(T) % sizeof(Val) == 0) return n * sizeof(T);
  return (n * sizeof(T) + sizeof(Val) - 1) / sizeof(Val) * sizeof(Val);
}

// Bytes of shared memory one lane's fixpoint needs, by bank; the
// wrappers' budget (kernels/fixpoint_kernel.py::smem_budget) uses the
// same formula.  A bank counts only what its layout uses; a model
// without AllDifferent rows gets no AllDifferent part.  V = value width,
// K = key width (8 at int32, 16 at int64), I = an int32 region, each
// region rounded up to V bytes:
//   AllDifferent, dense:  yl, yu, candidate pair [A1, N] (V), a fail
//     flag per row (I) and the member bitmasks of the Hall pass (I,
//     `ad_mask_words`);
//   AllDifferent, sparse: sort keys (K) and member indices (I) over
//     ad_sort_n, then syl, syu, min_inf, max_sup and the candidate pair
//     over Mad (V), and a fail flag per row (I);
//   Cumulative, dense:  profile [C1, H], candidate pair, durations and
//     demands [C1, T] (V), start vars [C1, T] (I), capacity (V) and
//     overload (I) per row;
//   Cumulative, sparse: event keys (K) and deltas, then the profile (V),
//     over cu_sort_n; the task table: start vars (I), durations and
//     demands (V), segments (I); the candidate pair over Mcu (V);
//     capacity (V) and overload (I) per row; the scan's warp sums (V).
// Words of the dense AllDifferent bank's member bitmasks: four sets per
// member of each of the A1 rows of N members (GEL, GEU by the member's
// lower bound, LEU, LEL by its upper bound) and NE per row, each set W =
// ceil(N / 32) words (`ad_dense_masks`).
__host__ __device__ inline size_t ad_mask_words(int A1, int N) {
  return (size_t)(4 * N + 1) * A1 * ((N + 31) / 32);
}

template <typename Val>
__host__ __device__ inline size_t alldiff_bytes(const Tables<Val>& p) {
  using Key = typename SortKey<Val>::T;
  if (p.n_alldiff <= 0) return 0;
  if (p.ad_sparse) {
    const size_t n = ad_sort_n(p);
    return region<Val, Key>(n) + region<Val, int32_t>(n) +
           6 * region<Val, Val>(p.Mad) + region<Val, int32_t>(p.A1);
  }
  return 4 * region<Val, Val>((size_t)p.A1 * p.N) +
         region<Val, int32_t>(p.A1) +
         region<Val, uint32_t>(ad_mask_words(p.A1, p.N));
}

template <typename Val>
__host__ __device__ inline size_t cumulative_bytes(const Tables<Val>& p) {
  using Key = typename SortKey<Val>::T;
  if (p.cu_sparse) {
    const size_t n = cu_sort_n(p), M = p.Mcu;
    return region<Val, Key>(n) + region<Val, Val>(n) +
           2 * region<Val, int32_t>(M) + 4 * region<Val, Val>(M) +
           region<Val, Val>(p.C1) + region<Val, int32_t>(p.C1) +
           region<Val, Val>(SCAN_WORDS);
  }
  const size_t CT = (size_t)p.C1 * p.T;
  return region<Val, Val>((size_t)p.C1 * p.H) + 4 * region<Val, Val>(CT) +
         region<Val, int32_t>(CT) + region<Val, Val>(p.C1) +
         region<Val, int32_t>(p.C1);
}

//   Compact-Table (tables only): the members' support words [T1, R, TW]
//     and the current tables [T1, TW] (I), the hull candidate pair
//     [T1, R] (V) and the domain-word candidates [T1, R, W] (I);
//   bitset store (carried only): current and next words, 2·V·W (I).
template <typename Val>
__host__ __device__ inline size_t table_bytes(const Tables<Val>& p) {
  if (p.n_table <= 0) return 0;
  const size_t TR = (size_t)p.T1 * p.R;
  return region<Val, uint32_t>(TR * p.TW) +
         region<Val, uint32_t>((size_t)p.T1 * p.TW) +
         2 * region<Val, Val>(TR) + region<Val, uint32_t>(TR * p.W);
}

template <typename Val>
__host__ __device__ inline size_t dom_bytes(const Tables<Val>& p) {
  return p.carry_dom ? region<Val, uint32_t>((size_t)2 * p.V * p.W) : 0;
}

// Stores (current and next lb/ub, 4·V values), the linear candidate pair
// [P1, K+1] and the banks.
template <typename Val>
__host__ __device__ inline size_t smem_bytes(const Tables<Val>& p) {
  return sizeof(Val) * ((size_t)4 * p.V + (size_t)2 * p.P1 * (p.K + 1)) +
         cumulative_bytes(p) + alldiff_bytes(p) + table_bytes(p) +
         dom_bytes(p);
}

// The fixpoint's view of a CTA's shared memory.  Store buffer c (0 or
// 1) is lb(c), ub(c): [lb0 | ub0 | lb1 | ub1], V values each (computed
// addresses, so no pointer array lands on the stack).
template <typename Val>
struct Smem {
  using Key = typename SortKey<Val>::T;
  Val* store;
  int V;
  __device__ __forceinline__ Val* lb(int c) const {
    return store + 2 * c * V;
  }
  __device__ __forceinline__ Val* ub(int c) const {
    return store + 2 * c * V + V;
  }
  Val* clb;         // [P1, K+1]
  Val* cub;         // [P1, K+1]
  // Cumulative; dense: [C1, H] profile, [C1, T] pair and task table;
  // sparse: [Mcu] pair and task table, [cu_sort_n] keys and deltas
  Val* prof;        // dense only
  Val* ulb;
  Val* uub;
  int32_t* t_svar;
  Val* t_dur;
  Val* t_dem;
  int32_t* t_seg;   // sparse only
  Val* t_cap;       // [C1]
  int32_t* ovl;     // [C1]
  Key* ckey;        // sparse: event keys (seg, time, kind)
  Val* cval;        // sparse: event deltas, then the profile
  Val* wsum;        // sparse: the prefix sum's per-warp sums
  // AllDifferent; dense: [A1, N] shifted member bounds and pair (shifted);
  // sparse: [Mad] sorted bounds, Hall folds and the pair in packed order
  // (unshifted), [ad_sort_n] keys (seg, yl) and member indices
  Val* yl;          // dense only
  Val* yu;          // dense only
  Val* syl;         // sparse only
  Val* syu;         // sparse only
  Val* minf;        // sparse only
  Val* msup;        // sparse only
  Val* alb;
  Val* aub;
  int32_t* afail;   // [A1] pigeonhole failure per row (dense: the member
                    // bitmasks follow, `ad_masks`)
  Key* akey;        // sparse only
  int32_t* aval;    // sparse only
  // Compact-Table and the bitset store (DOM instances only)
  uint32_t* domst;  // [dom0 | dom1], V·W words each (carried only)
  uint32_t* ctor;   // [T1, R, TW] OR of each member's supports
  uint32_t* ctcur;  // [T1, TW] current tables
  Val* ctlb;        // [T1, R]
  Val* ctub;        // [T1, R]
  uint32_t* ctdom;  // [T1, R, W]
  __device__ __forceinline__ uint32_t* dom(int c) const {
    return domst + (size_t)c * V * W;
  }
  int W;
};

// Hands out the regions of a CTA's shared memory in order, each rounded
// up to the value width (`region`).
template <typename Val>
struct Carver {
  unsigned char* at;
  template <typename T>
  __host__ __device__ __forceinline__ T* take(size_t n) {
    T* r = (T*)at;
    at += region<Val, T>(n);
    return r;
  }
};

// The sort keys come right after the stores and the linear pair (at
// int32 an even number of words, so they are 8-byte aligned; at int64
// every region is), the other regions follow, the Compact-Table and
// bitset regions last.  The total is smem_bytes'.  The layouts and DOM
// are template parameters (equal to p.ad_sparse, p.cu_sparse,
// uses_dom(p)), so each kernel instance computes its own layout's
// addresses only.  fixpoint.cu's launch carves on the host at
// LAYOUT_BASE and its many-lane kernels move the layout to their shared
// memory (`rebase`); its few-lane kernels and search.cu carve in the
// kernel.
template <typename Val, bool AD_SPARSE, bool CU_SPARSE, bool DOM>
__host__ __device__ __forceinline__ Smem<Val> carve(const Tables<Val>& p,
                                                    unsigned char* base) {
  using Key = typename SortKey<Val>::T;
  const int V = p.V, K1 = p.K + 1, C1 = p.C1;
  Smem<Val> s = {};
  Carver<Val> c{base};
  s.store = c.template take<Val>(4 * V);
  s.V = V;
  s.clb = c.template take<Val>(p.P1 * K1);
  s.cub = c.template take<Val>(p.P1 * K1);
  const bool ad_sparse = AD_SPARSE && p.n_alldiff > 0;
  if (ad_sparse) s.akey = c.template take<Key>(ad_sort_n(p));
  if (CU_SPARSE) s.ckey = c.template take<Key>(cu_sort_n(p));
  if (CU_SPARSE) {
    const int M = p.Mcu;
    s.cval = c.template take<Val>(cu_sort_n(p));
    s.t_svar = c.template take<int32_t>(M);
    s.t_dur = c.template take<Val>(M);
    s.t_dem = c.template take<Val>(M);
    s.t_seg = c.template take<int32_t>(M);
    s.ulb = c.template take<Val>(M);
    s.uub = c.template take<Val>(M);
    s.t_cap = c.template take<Val>(C1);
    s.ovl = c.template take<int32_t>(C1);
    s.wsum = c.template take<Val>(SCAN_WORDS);
  } else {
    const int CT = C1 * p.T;
    s.prof = c.template take<Val>(C1 * p.H);
    s.ulb = c.template take<Val>(CT);
    s.uub = c.template take<Val>(CT);
    s.t_svar = c.template take<int32_t>(CT);
    s.t_dur = c.template take<Val>(CT);
    s.t_dem = c.template take<Val>(CT);
    s.t_cap = c.template take<Val>(C1);
    s.ovl = c.template take<int32_t>(C1);
  }
  if (ad_sparse) {
    const int M = p.Mad;
    s.aval = c.template take<int32_t>(ad_sort_n(p));
    s.syl = c.template take<Val>(M);
    s.syu = c.template take<Val>(M);
    s.minf = c.template take<Val>(M);
    s.msup = c.template take<Val>(M);
    s.alb = c.template take<Val>(M);
    s.aub = c.template take<Val>(M);
    s.afail = c.template take<int32_t>(p.A1);
  } else if (p.n_alldiff > 0) {
    const int AN = p.A1 * p.N;
    s.yl = c.template take<Val>(AN);
    s.yu = c.template take<Val>(AN);
    s.alb = c.template take<Val>(AN);
    s.aub = c.template take<Val>(AN);
    s.afail = c.template take<int32_t>(p.A1);
    c.template take<uint32_t>(ad_mask_words(p.A1, p.N));   // `ad_masks`
  }
  if (DOM) {
    s.W = p.W;
    if (p.n_table > 0) {
      const int TR = p.T1 * p.R;
      s.ctor = c.template take<uint32_t>(TR * p.TW);
      s.ctcur = c.template take<uint32_t>(p.T1 * p.TW);
      s.ctlb = c.template take<Val>(TR);
      s.ctub = c.template take<Val>(TR);
      s.ctdom = c.template take<uint32_t>(TR * p.W);
    }
    if (p.carry_dom) s.domst = c.template take<uint32_t>(2 * V * p.W);
  }
  return s;
}

// The base the launches carve a layout at (a kernel parameter; no region
// lies at address 0, so the offsets need no null pointer).
constexpr uintptr_t LAYOUT_BASE = 4096;

__host__ inline unsigned char* layout_base() {
  return reinterpret_cast<unsigned char*>(LAYOUT_BASE);
}

// A layout carved at LAYOUT_BASE moved to `base`, a CTA's shared memory:
// each region's address is one add of a kernel parameter to `base`,
// where the kernel would otherwise carve sums of region sizes, which
// ptxas keeps in registers through the sweep loop (fixpoint.cu's
// many-lane instances need fewer registers so, and none spills: PERF.md
// §6).
// Regions a layout does not use come out as unused garbage, as their
// null pointers before.
template <typename Val>
__device__ __forceinline__ Smem<Val> rebase(Smem<Val> s, unsigned char* base) {
#define FIXLANE_REBASE(f) \
  s.f = (decltype(s.f))(base + ((uintptr_t)s.f - LAYOUT_BASE))
  FIXLANE_REBASE(store);
  FIXLANE_REBASE(clb);
  FIXLANE_REBASE(cub);
  FIXLANE_REBASE(prof);
  FIXLANE_REBASE(ulb);
  FIXLANE_REBASE(uub);
  FIXLANE_REBASE(t_svar);
  FIXLANE_REBASE(t_dur);
  FIXLANE_REBASE(t_dem);
  FIXLANE_REBASE(t_seg);
  FIXLANE_REBASE(t_cap);
  FIXLANE_REBASE(ovl);
  FIXLANE_REBASE(ckey);
  FIXLANE_REBASE(cval);
  FIXLANE_REBASE(wsum);
  FIXLANE_REBASE(yl);
  FIXLANE_REBASE(yu);
  FIXLANE_REBASE(syl);
  FIXLANE_REBASE(syu);
  FIXLANE_REBASE(minf);
  FIXLANE_REBASE(msup);
  FIXLANE_REBASE(alb);
  FIXLANE_REBASE(aub);
  FIXLANE_REBASE(afail);
  FIXLANE_REBASE(akey);
  FIXLANE_REBASE(aval);
  FIXLANE_REBASE(domst);
  FIXLANE_REBASE(ctor);
  FIXLANE_REBASE(ctcur);
  FIXLANE_REBASE(ctlb);
  FIXLANE_REBASE(ctub);
  FIXLANE_REBASE(ctdom);
#undef FIXLANE_REBASE
  return s;
}

// Stage the cumulative task table in shared memory and clear the
// overload flags (and the dense profile); once per CTA, before its first
// fixpoint.  The caller
// synchronises (fixpoint_lane starts with a barrier).
template <int NT, typename Val, bool CU_SPARSE>
__device__ __forceinline__ void stage_tables(const Tables<Val>& p,
                                             const Smem<Val>& s) {
  if (p.n_cumulative <= 0) return;
  const int tid = threadIdx.x;
  if (CU_SPARSE) {
    for (int i = tid; i < p.Mcu; i += NT) {
      s.t_svar[i] = p.cu_pk_svar[i];
      s.t_dur[i] = p.cu_pk_dur[i];
      s.t_dem[i] = p.cu_pk_dem[i];
      s.t_seg[i] = p.cu_pk_seg[i];
    }
  } else {
    for (int i = tid; i < p.C1 * p.T; i += NT) {
      s.t_svar[i] = p.cu_svar[i];
      s.t_dur[i] = p.cu_dur[i];
      s.t_dem[i] = p.cu_dem[i];
    }
    // the difference array the profile is built in starts at zero
    for (int i = tid; i < p.C1 * p.H; i += NT) s.prof[i] = 0;
  }
  for (int c = tid; c < p.C1; c += NT) {
    s.t_cap[c] = p.cu_cap[c];
    s.ovl[c] = 0;
  }
}

// ---- block-wide building blocks (every thread of the CTA calls them) ----

__device__ __forceinline__ int32_t shfl_up(int32_t x, int o) {
  return __shfl_up_sync(0xffffffffu, x, o);
}
__device__ __forceinline__ int64_t shfl_up(int64_t x, int o) {
  return (int64_t)__shfl_up_sync(0xffffffffu, (long long)x, o);
}
__device__ __forceinline__ int32_t shfl_idx(int32_t x, int src) {
  return __shfl_sync(0xffffffffu, x, src);
}
__device__ __forceinline__ int64_t shfl_idx(int64_t x, int src) {
  return (int64_t)__shfl_sync(0xffffffffu, (long long)x, src);
}
__device__ __forceinline__ int32_t shfl_xor(int32_t x, int o) {
  return __shfl_xor_sync(0xffffffffu, x, o);
}
__device__ __forceinline__ int64_t shfl_xor(int64_t x, int o) {
  return (int64_t)__shfl_xor_sync(0xffffffffu, (long long)x, o);
}
__device__ __forceinline__ uint64_t shfl_xor(uint64_t x, int o) {
  return (uint64_t)__shfl_xor_sync(0xffffffffu, (unsigned long long)x, o);
}
__device__ __forceinline__ Key128 shfl_xor(Key128 x, int o) {
  return Key128{shfl_xor(x.hi, o), shfl_xor(x.lo, o)};
}

// Lanes of a group that shares one row (linear: n = K terms, fit =
// NT / P1) or one variable (join: n = 32, fit = NT / V): the least power
// of two >= n, at most 32 and at most `fit` (1 when n <= 1 or fit < 2).
// A power of two that divides 32, so a group never straddles two warps
// and reduces by __shfl_xor.
__device__ __forceinline__ int lane_group(int n, int fit) {
  int g = 1;
  while (g < n && g < 32 && 2 * g <= fit) g <<= 1;
  return g;
}

// Exclusive prefix sum of one value per thread over the CTA; `wsum` holds
// 32 values (NT / 32 <= 32 warps).  Returns the thread's prefix and
// writes the total.
template <int NT, typename T>
__device__ T block_exclusive_scan(T v, T* wsum, T* total) {
  constexpr int WARPS = NT / 32;
  static_assert(WARPS <= SCAN_WORDS, "one scan word per warp");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const T y = shfl_up(x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T w = lane < WARPS ? wsum[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const T y = shfl_up(w, o);
      if (lane >= o) w += y;
    }
    if (lane < WARPS) wsum[lane] = w;
  }
  __syncthreads();
  const T before = warp ? wsum[warp - 1] : 0;
  *total = wsum[WARPS - 1];
  __syncthreads();                       // wsum may be reused
  return before + x - v;
}

// In-place inclusive prefix sum of x[0, n): a run per thread, the runs'
// offsets by block_exclusive_scan.  Ends with a barrier.
template <int NT, typename Val>
__device__ void block_inclusive_scan(Val* x, int n, Val* wsum) {
  const int per = (n + NT - 1) / NT;
  const int lo = min(n, (int)threadIdx.x * per), hi = min(n, lo + per);
  Val sum = 0;
  for (int i = lo; i < hi; ++i) sum += x[i];
  Val total;
  Val run = block_exclusive_scan<NT, Val>(sum, wsum, &total);
  for (int i = lo; i < hi; ++i) {
    run += x[i];
    x[i] = run;
  }
  __syncthreads();
}

// One step (k, j) of the bitonic network in shared memory: n/2
// compare-exchanges of the pairs (i, i + j), i with bit j clear, spread
// over the CTA; ascending where bit k of i is clear.  Equal keys are never
// swapped.  Ends with a barrier.
template <int NT, typename Key, typename P>
__device__ __forceinline__ void sort_step(Key* key, P* val, int n, int k,
                                          int j) {
  for (int t = threadIdx.x; t < (n >> 1); t += NT) {
    // t with a zero inserted at bit j (j is a power of two)
    const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
    const int l = i + j;
    const Key a = key[i], b = key[l];
    if ((i & k) == 0 ? a > b : a < b) {
      key[i] = b;
      key[l] = a;
      const P x = val[i];
      val[i] = val[l];
      val[l] = x;
    }
  }
  __syncthreads();
}

// Sort n (a power of two) keys ascending in shared memory, each with its
// payload: a bitonic network; equal keys are never swapped, so the result
// (payloads included) is the network's whatever the thread count.  In the
// few-lane instance at n <= NT, thread t holds key t in registers and the
// steps whose partner t ^ j lies in its warp (j < 32) exchange through
// __shfl_xor, with no barrier: the 55 steps of n = 1024 take 21 barriers
// (15 shared-memory steps, 5 stores of the registers before them and the
// final store).  Otherwise every step is a shared-memory step
// (`sort_step`; the many-lane instance keeps that form, and its
// registers).  The caller synchronises before (the keys are written); it
// ends with a barrier.
template <int NT, typename Key, typename P>
__device__ void block_sort(Key* key, P* val, int n) {
  if (NT == THREADS || n > NT) {
    for (int k = 2; k <= n; k <<= 1)
      for (int j = k >> 1; j > 0; j >>= 1)
        sort_step<NT, Key, P>(key, val, n, k, j);
    return;
  }
  // threads t >= n hold no key: their partners t ^ j (j < n) are >= n
  // too, so they only ever exchange among themselves and store nothing
  const int t = threadIdx.x;
  Key a{};
  P x{};
  if (t < n) {
    a = key[t];
    x = val[t];
  }
  for (int k = 2; k <= n; k <<= 1) {
    if (k > 32) {                        // j >= 32: in shared memory
      if (t < n) {
        key[t] = a;
        val[t] = x;
      }
      __syncthreads();
      for (int j = k >> 1; j >= 32; j >>= 1)
        sort_step<NT, Key, P>(key, val, n, k, j);
      if (t < n) {
        a = key[t];
        x = val[t];
      }
    }
    const bool up = (t & k) == 0;       // bit k of the pair's lower index
    for (int j = min(k >> 1, 16); j > 0; j >>= 1) {
      const Key b = shfl_xor(a, j);
      const P y = shfl_xor(x, j);
      const bool lower = (t & j) == 0;
      const bool swap = up ? (lower ? a > b : b > a) : (lower ? a < b : b < a);
      if (swap) {
        a = b;
        x = y;
      }
    }
  }
  if (t < n) {
    key[t] = a;
    val[t] = x;
  }
  __syncthreads();
}

// ---- the sparse Cumulative bank ------------------------------------------

// Step (1): one thread per event slot writes its key (segment, time,
// kind) and delta; the power-of-two tail gets keys that sort last.
template <int NT, typename Val>
__device__ void cu_sparse_events(const Tables<Val>& p, const Smem<Val>& s,
                                 const Val* lb, const Val* ub) {
  using SK = SortKey<Val>;
  const int M = p.Mcu, n = cu_sort_n(p);
  for (int e = threadIdx.x; e < n; e += NT) {
    if (e >= 2 * M) {
      s.ckey[e] = SK::last();
      s.cval[e] = 0;
      continue;
    }
    const bool start = e < M;
    const int m = start ? e : e - M;
    const Val d = s.t_dur[m], q = s.t_dem[m];
    const int c = s.t_seg[m];
    const int v = s.t_svar[m];
    const Val est = lb[v], lst = ub[v];
    const bool cp = c < p.n_cumulative && d > 0 && q > 0 && lst < est + d;
    const Val t = start ? lst : est + d;
    s.ckey[e] = SK::event(c, t, start);
    s.cval[e] = cp ? (start ? q : -q) : 0;
  }
}

// Step (2), after the sort (`block_sort` on the event keys and deltas):
// the profile (a block prefix sum of the deltas) and the per-row
// overload flags.  Ends with a barrier.
template <int NT, typename Val>
__device__ void cu_sparse_profile(const Tables<Val>& p, const Smem<Val>& s) {
  using SK = SortKey<Val>;
  const int E = 2 * p.Mcu;
  block_inclusive_scan<NT, Val>(s.cval, cu_sort_n(p), s.wsum);
  // an overloaded non-empty interval [u, v) fails its row
  for (int e = threadIdx.x; e < E; e += NT) {
    const auto k = s.ckey[e];
    const int c = SK::event_seg(k);
    const Val u = SK::event_time(k);
    const Val v = (e + 1 < E && SK::event_seg(s.ckey[e + 1]) == c)
                      ? SK::event_time(s.ckey[e + 1]) : u;
    if (u < v && s.cval[e] > s.t_cap[c]) s.ovl[c] = 1;  // benign race
  }
  __syncthreads();
}

// Step (2), last: the first and last feasible start of each task over its
// own segment of the profile, two threads per task (x = 2m: forward, x =
// 2m + 1: backward).  Under the seg-major sort the segment's events are
// sorted by time, so each scan skips what provably changes nothing:
//   * forward (jump past each forbidden interval [u, v)): an interval
//     with v <= est cannot move st (>= est), so the scan starts at the
//     first event whose successor lies after est (binary search); it
//     stops at the first u >= st + d, since later intervals start later
//     and st moves only past an interval that starts before st + d;
//   * backward (jump before each forbidden interval): an interval with
//     u >= lst + d cannot move sl (<= lst), so the scan starts below the
//     first event at or after lst + d; it stops at the first v <= sl.
// The caller synchronises after it.
template <typename Val>
__device__ __forceinline__ Val event_time(const Smem<Val>& s, int e) {
  return SortKey<Val>::event_time(s.ckey[e]);
}

// First index f in [lo, hi) whose event time is > t (`strict`) or >= t,
// or hi when there is none; the times of [lo, hi) are sorted.
template <typename Val>
__device__ __forceinline__ int first_after(const Smem<Val>& s, int lo,
                                           int hi, Val t, bool strict) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const Val x = event_time<Val>(s, mid);
    if (strict ? x > t : x >= t) hi = mid;
    else lo = mid + 1;
  }
  return lo;
}

template <int NT, typename Val>
__device__ void cu_sparse_starts(const Tables<Val>& p, const Smem<Val>& s,
                                 const Val* lb, const Val* ub) {
  constexpr Val NEU_UB = Lim<Val>::BIG, NEU_LB = -Lim<Val>::BIG;
  const int M = p.Mcu;
  for (int x = threadIdx.x; x < 2 * M; x += NT) {
    const int m = x >> 1;
    const bool fwd = (x & 1) == 0;
    const Val d = s.t_dur[m], q = s.t_dem[m];
    const int c = s.t_seg[m];
    if (!(c < p.n_cumulative && d > 0 && q > 0)) {
      if (fwd) s.ulb[m] = NEU_LB;
      else s.uub[m] = NEU_UB;
      continue;
    }
    const Val cap = s.t_cap[c];
    if (q > cap) {                 // a lone task over capacity
      if (fwd) s.ulb[m] = -NEU_LB;
      else s.uub[m] = -NEU_UB;
      continue;
    }
    const int v = s.t_svar[m];
    const Val est = lb[v], lst = ub[v], ect = est + d;
    const bool cp = lst < ect;
    const int e0 = 2 * __ldg(p.cu_ptr + c), e1 = 2 * __ldg(p.cu_ptr + c + 1);
    if (fwd) {
      // first feasible start >= est: jump past each forbidden interval
      Val st = est;
      for (int e = first_after<Val>(s, e0 + 1, e1, est, true) - 1;
           e + 1 < e1; ++e) {
        const Val u = event_time<Val>(s, e), v_ = event_time<Val>(s, e + 1);
        if (u >= st + d) break;
        if (u < v_) {
          const bool own = cp && u >= lst && u < ect;
          if (s.cval[e] + (own ? 0 : q) > cap && st < v_) st = v_;
        }
      }
      s.ulb[m] = s.ovl[c] ? -NEU_LB : st;     // overload fails the row
    } else {
      // last feasible start <= lst: jump before each forbidden interval
      Val sl = lst;
      for (int e = min(first_after<Val>(s, e0, e1, lst + d, false),
                       e1 - 1) - 1;
           e >= e0; --e) {
        const Val u_ = event_time<Val>(s, e), v_ = event_time<Val>(s, e + 1);
        if (v_ <= sl) break;
        if (u_ < v_) {
          const bool own = cp && u_ >= lst && u_ < ect;
          if (s.cval[e] + (own ? 0 : q) > cap && sl + d > u_) sl = u_ - d;
        }
      }
      s.uub[m] = sl >= 0 ? sl : -NEU_UB;
    }
  }
}

// ---- the sparse AllDifferent bank ----------------------------------------

// Step (1): one thread per key slot writes (seg, yl) and the member
// index; the Hall folds and fail flags are cleared.
template <int NT, typename Val>
__device__ void ad_sparse_keys(const Tables<Val>& p, const Smem<Val>& s,
                               const Val* lb) {
  using SK = SortKey<Val>;
  const int M = p.Mad, n = ad_sort_n(p);
  for (int i = threadIdx.x; i < n; i += NT) {
    if (i >= M) {
      s.akey[i] = SK::last();
      s.aval[i] = 0;
      continue;
    }
    const Val yl = lb[__ldg(p.ad_pk_var + i)] + __ldg(p.ad_pk_off + i);
    s.akey[i] = SK::member(__ldg(p.ad_pk_seg + i), yl);
    s.aval[i] = i;
    s.msup[i] = -Lim<Val>::BIG;
  }
  for (int a = threadIdx.x; a < p.A1; a += NT) s.afail[a] = 0;
}

// Step (2), after the sort (`block_sort` on the keys and member indices):
// Hall counts and folds, pushes.  Writes the candidate pair in packed
// order, unshifted (a failed row's lb at -NEU_LB - off).  Barriers
// separate its passes; the caller synchronises after the last.
template <int NT, typename Val>
__device__ void ad_sparse_hall(const Tables<Val>& p, const Smem<Val>& s,
                               const Val* ub) {
  using SK = SortKey<Val>;
  constexpr Val NEU_UB = Lim<Val>::BIG, NEU_LB = -Lim<Val>::BIG;
  const int M = p.Mad, A = p.n_alldiff;
  for (int i = threadIdx.x; i < M; i += NT) {
    const int m = s.aval[i];
    s.syl[i] = SK::member_value(s.akey[i]);
    s.syu[i] = ub[__ldg(p.ad_pk_var + m)] + __ldg(p.ad_pk_off + m);
  }
  __syncthreads();
  // one thread per upper endpoint j: cnt(i, j) by the suffix count
  for (int j = threadIdx.x; j < M; j += NT) {
    const int c = SK::member_seg(s.akey[j]);
    if (c >= A) continue;                       // padding
    const int s0 = __ldg(p.ad_ptr + c), s1 = __ldg(p.ad_ptr + c + 1);
    const Val b = s.syu[j];
    Val cnt = 0, mi = NEU_UB;
    bool fail = false;
    for (int x = s1 - 1; x >= s0; --x) {
      cnt += s.syu[x] <= b;
      const Val a = s.syl[x];
      if ((x == s0 || s.syl[x - 1] != a) && a <= b) {  // first of its key
        const Val width = b - a + 1;
        if (cnt > width) {
          fail = true;
        } else if (cnt == width) {              // Hall interval [a, b]
          mi = min(mi, a);
          atomic_max(s.msup + x, b);
        }
      }
    }
    s.minf[j] = mi;
    if (fail) s.afail[c] = 1;                   // benign race: all write 1
  }
  __syncthreads();
  // one thread per member k: push out of the Hall intervals of its row
  for (int k = threadIdx.x; k < M; k += NT) {
    const int c = SK::member_seg(s.akey[k]);
    const int m = s.aval[k];
    const Val off = __ldg(p.ad_pk_off + m);
    Val slb = NEU_LB, sub = NEU_UB;
    if (c < A) {
      const int s0 = __ldg(p.ad_ptr + c), s1 = __ldg(p.ad_ptr + c + 1);
      const Val yl = s.syl[k], yu = s.syu[k];
      for (int x = s0; x < s1; ++x) {
        const Val b = s.syu[x], a = s.syl[x];
        if (s.minf[x] <= yl && yl <= b && b < yu) slb = max(slb, b + 1);
        if (yl < a && a <= yu && yu <= s.msup[x]) sub = min(sub, a - 1);
      }
      if (s.afail[c]) slb = -NEU_LB;
    }
    s.alb[m] = slb - off;
    s.aub[m] = sub - off;
  }
}

// ---- the dense AllDifferent bank ------------------------------------------

// The dense bank's member bitmasks, the region after the fail flags (an
// address computed where a phase needs it, not one more kept through the
// sweep).
template <typename Val>
__device__ __forceinline__ uint32_t* ad_masks(const Tables<Val>& p,
                                              const Smem<Val>& s) {
  return (uint32_t*)((unsigned char*)s.afail + region<Val, int32_t>(p.A1));
}

// Threads that share one item of `items` (a member, or an upper endpoint)
// when the CTA has more threads than items: each takes every S-th step of
// the item's loop.  At most `steps`, and 1 when the items fill the CTA.
template <int NT>
__device__ __forceinline__ int slices(int items, int steps) {
  return items >= NT ? 1 : min(steps, NT / max(items, 1));
}

// Step (2), first: the member bitmasks of each row a of N members, W =
// ceil(N / 32) words per set, bit k of word w for member 32·w + k:
//   GEL_i = {k : yl_k >= yl_i},  GEU_i = {k : yu_k >= yl_i}  (by i's lower
//   bound), LEU_i = {k : yu_k <= yu_i},  LEL_i = {k : yl_k <= yu_i}  (by
//   i's upper bound), and NE = {k : yl_k <= yu_k}.
// One thread per (member i, word w) walks the word's members k (loads the
// threads of a warp share), S threads per word when the CTA has threads
// to spare, each OR-ing its bits (atomicOr; the words were cleared in
// step (1b)).  Bits past N stay clear.  The caller synchronises after it.
template <int NT, typename Val>
__device__ void ad_dense_masks(const Tables<Val>& p, const Smem<Val>& s) {
  const int N = p.N, W = (N + 31) >> 5, AN = p.n_alldiff * N;
  const size_t set = (size_t)p.A1 * N * W;
#ifdef FIXLANE_CLOCKS    // the few-lane stamped build: one thread per word
  const int S = NT == FEW_THREADS ? 1 : slices<NT>(AN * W, min(N, 32));
#else                    // (with slices it spills; PERF.md §6)
  const int S = slices<NT>(AN * W, min(N, 32));
#endif
  for (int x = threadIdx.x; x < AN * W * S; x += NT) {
    const int sl = x / (AN * W), iw = x - sl * AN * W;
    const int w = iw / AN, ai = iw - w * AN, i = ai % N, a0 = ai - i;
    const Val li = s.yl[ai], ui = s.yu[ai];
    const int k0 = 32 * w, k1 = min(N, k0 + 32);
    uint32_t gel = 0, geu = 0, leu = 0, lel = 0, ne = 0;
    for (int k = k0 + sl; k < k1; k += S) {
      const Val lk = s.yl[a0 + k], uk = s.yu[a0 + k];
      const uint32_t bit = 1u << (k - k0);
      gel |= lk >= li ? bit : 0u;
      geu |= uk >= li ? bit : 0u;
      leu |= uk <= ui ? bit : 0u;
      lel |= lk <= ui ? bit : 0u;
      ne |= lk <= uk ? bit : 0u;
    }
    uint32_t* m = ad_masks<Val>(p, s) + (size_t)ai * W + w;
    uint32_t* mne = ad_masks<Val>(p, s) + 4 * set + (size_t)(a0 / N) * W + w;
    if (S == 1) {
      m[0] = gel;
      m[set] = geu;
      m[2 * set] = leu;
      m[3 * set] = lel;
      if (i == 0) *mne = ne;
    } else {
      atomicOr(m, gel);
      atomicOr(m + set, geu);
      atomicOr(m + 2 * set, leu);
      atomicOr(m + 3 * set, lel);
      if (i == 0) atomicOr(mne, ne);
    }
  }
}

// Step (2) for the few-lane instance at int64, whose 64 registers a
// thread do not hold the bitmask pass (it spills): one thread per
// endpoint pair (row, i, j) counts the members inside [yl_i, yu_j] by a
// loop over the row and pushes, the same counts and candidates as the
// bitmask pass.
template <int NT, typename Val>
__device__ void ad_dense_pairs(const Tables<Val>& p, const Smem<Val>& s) {
  const int N = p.N, NN = N * N;
  for (int q = threadIdx.x; q < p.n_alldiff * NN; q += NT) {
    const int a = q / NN, i = (q - a * NN) / N, j = q - a * NN - i * N;
    const Val* ylr = s.yl + a * N;
    const Val* yur = s.yu + a * N;
    const Val lo = ylr[i], hi = yur[j];
    if (lo > hi) continue;              // empty interval or padding
    Val cnt = 0;
    for (int k = 0; k < N; ++k) {
      const Val kl = ylr[k], ku = yur[k];
      cnt += (kl >= lo) & (ku <= hi) & (kl <= ku);
    }
    const Val width = hi - lo + 1;
    if (cnt > width) {
      s.afail[a] = 1;                   // benign race: all write 1
    } else if (cnt == width) {          // Hall interval: push the others
      for (int k = 0; k < N; ++k) {
        const Val kl = ylr[k], ku = yur[k];
        if (kl >= lo && ku <= hi && kl <= ku) continue;   // inside I
        if (kl >= lo && kl <= hi) atomic_max(s.alb + a * N + k, hi + 1);
        if (ku >= lo && ku <= hi) atomic_min(s.aub + a * N + k, lo - 1);
      }
    }
  }
}

// Push member k of row a0 / N out of the Hall interval [lo, hi]: the set
// bits of `lbm` have their lower bound in it, those of `ubm` their upper.
template <typename Val>
__device__ __forceinline__ void ad_push(const Smem<Val>& s, int base,
                                        uint32_t lbm, uint32_t ubm, Val lo,
                                        Val hi) {
  for (; lbm; lbm &= lbm - 1)
    atomic_max(s.alb + base + __ffs(lbm) - 1, hi + 1);
  for (; ubm; ubm &= ubm - 1)
    atomic_min(s.aub + base + __ffs(ubm) - 1, lo - 1);
}

// Step (2): every endpoint pair (row, i, j) with yl_i <= yu_j, one thread
// per upper endpoint j walking the lower endpoints i (S threads per j when
// the CTA has threads to spare): the members inside I = [yl_i, yu_j] are
// GEL_i & LEU_j & NE (the loop's yl_k >= yl_i, yu_k <= yu_j, yl_k <=
// yu_k), counted by popc.  More than the width fails the row; exactly as
// many makes I a Hall interval, and every member outside it with its
// lower bound in I (GEL_i & LEL_j) is pushed to yu_j + 1, with its upper
// bound in I (GEU_i & LEU_j) to yl_i - 1, by shared-memory atomicMax /
// atomicMin, which commute.  Rows of one word keep j's words in registers.
template <int NT, typename Val>
__device__ void ad_dense_hall(const Tables<Val>& p, const Smem<Val>& s) {
  const int N = p.N, W = (N + 31) >> 5, AN = p.n_alldiff * N;
  const size_t set = (size_t)p.A1 * N * W;
  const int S = slices<NT>(AN, N);
  for (int x = threadIdx.x; x < AN * S; x += NT) {
    const int sl = x / AN, aj = x - sl * AN, a = aj / N, a0 = a * N;
    const Val hi = s.yu[aj];
    const uint32_t* gel = ad_masks<Val>(p, s) + (size_t)a0 * W;
    const uint32_t* geu = gel + set;
    const uint32_t* leu = ad_masks<Val>(p, s) + 2 * set + (size_t)aj * W;
    const uint32_t* lel = leu + set;
    const uint32_t* ne = ad_masks<Val>(p, s) + 4 * set + (size_t)a * W;
    if (W == 1) {
      const uint32_t lu = leu[0], ll = lel[0], nn = ne[0];
      for (int i = sl; i < N; i += S) {
        const Val lo = s.yl[a0 + i];
        if (lo > hi) continue;          // empty interval or padding
        const uint32_t in = gel[i] & lu & nn;
        const Val cnt = __popc(in), width = hi - lo + 1;
        if (cnt > width) s.afail[a] = 1;          // benign race
        else if (cnt == width)          // Hall interval: push the others
          ad_push<Val>(s, a0, gel[i] & ll & ~in, geu[i] & lu & ~in, lo, hi);
      }
      continue;
    }
    for (int i = sl; i < N; i += S) {
      const Val lo = s.yl[a0 + i];
      if (lo > hi) continue;
      Val cnt = 0;
      for (int w = 0; w < W; ++w)
        cnt += __popc(gel[i * W + w] & leu[w] & ne[w]);
      const Val width = hi - lo + 1;
      if (cnt > width) {
        s.afail[a] = 1;
      } else if (cnt == width) {
        for (int w = 0; w < W; ++w) {
          const uint32_t in = gel[i * W + w] & leu[w] & ne[w];
          ad_push<Val>(s, a0 + 32 * w, gel[i * W + w] & lel[w] & ~in,
                       geu[i * W + w] & leu[w] & ~in, lo, hi);
        }
      }
    }
  }
}

// Is time point tau forbidden for task (c, t)?  The profile without the
// task's own compulsory part, plus its demand, exceeds the capacity.
template <typename Val>
__device__ __forceinline__ bool bad_at(const Val* prof_c, Val tau, Val est,
                                       Val lst, Val d, Val q, Val cap) {
  Val own = (lst <= tau && tau < est + d) ? q : 0;
  return prof_c[tau] - own + q > cap;
}

// ---- Compact-Table and the bitset store -----------------------------------

// Word with bits [0, n) set, n clipped into [0, 32] (bitset.low_mask).
template <typename Val>
__device__ __forceinline__ uint32_t low_mask(Val n) {
  return n >= 32 ? 0xffffffffu : (n <= 0 ? 0u : (1u << n) - 1u);
}

// Word w of the interval [lo, hi] as domain bits from `off`
// (bitset.from_bounds).
template <typename Val>
__device__ __forceinline__ uint32_t range_word(Val lo, Val hi, Val off,
                                               int w) {
  const Val base = 32 * w;
  return low_mask<Val>(hi - off + 1 - base) & ~low_mask<Val>(lo - off - base);
}

// Step (1): one thread per (row, member, support word) ORs the supports of
// the member's live values; a padded slot gets all-ones.  The member's
// words are the carried store's or, without one, the range words of the
// current bounds (all-ones for an untracked variable).
template <int NT, typename Val>
__device__ void ct_supports(const Tables<Val>& p, const Smem<Val>& s,
                            int cur, const Val* lb, const Val* ub) {
  const int TW = p.TW, W = p.W, K32 = 32 * p.W;
  for (int i = threadIdx.x; i < p.T1 * p.R * TW; i += NT) {
    const int tr = i / TW, tw = i - tr * TW;
    uint32_t acc = 0xffffffffu;
    if (__ldg(p.ct_mask + tr)) {
      const int v = __ldg(p.ct_vars + tr);
      const uint32_t* sp = p.ct_supp + (size_t)tr * K32 * TW + tw;
      const bool trk = __ldg(p.dom_track + v) != 0;
      const Val off = __ldg(p.dom_off + v);
      acc = 0;
      for (int w = 0; w < W; ++w) {
        uint32_t word = p.carry_dom ? s.dom(cur)[v * W + w]
                        : trk       ? range_word<Val>(lb[v], ub[v], off, w)
                                    : 0xffffffffu;
        while (word) {
          const int b = __ffs(word) - 1;
          word &= word - 1;
          acc |= __ldg(sp + (size_t)(32 * w + b) * TW);
        }
      }
    }
    s.ctor[i] = acc;
  }
}

// Step (2): one thread per (row, support word) ANDs the members' words
// into the current table.
template <int NT, typename Val>
__device__ void ct_current(const Tables<Val>& p, const Smem<Val>& s) {
  const int R = p.R, TW = p.TW;
  for (int i = threadIdx.x; i < p.T1 * TW; i += NT) {
    const int t = i / TW, tw = i - t * TW;
    uint32_t c = 0xffffffffu;
    for (int r = 0; r < R; ++r) c &= s.ctor[(t * R + r) * TW + tw];
    s.ctcur[i] = c;
  }
}

// Step (2'): one thread per (row, member) keeps the values whose support
// meets the current table: hull candidates (a failed row's lb at
// -NEU_LB) and, with a carried store, domain-word candidates.  Padded
// slots are neutral.
template <int NT, typename Val>
__device__ void ct_survivors(const Tables<Val>& p, const Smem<Val>& s) {
  constexpr Val NEU_UB = Lim<Val>::BIG, NEU_LB = -Lim<Val>::BIG;
  const int R = p.R, TW = p.TW, W = p.W, K32 = 32 * p.W;
  for (int i = threadIdx.x; i < p.T1 * R; i += NT) {
    if (!__ldg(p.ct_mask + i)) {
      s.ctlb[i] = NEU_LB;
      s.ctub[i] = NEU_UB;
      if (p.carry_dom)
        for (int w = 0; w < W; ++w) s.ctdom[i * W + w] = 0xffffffffu;
      continue;
    }
    const uint32_t* cur = s.ctcur + (i / R) * TW;
    bool fail = true;
    for (int tw = 0; tw < TW; ++tw) fail &= cur[tw] == 0;
    const uint32_t* sp = p.ct_supp + (size_t)i * K32 * TW;
    Val kmin = NEU_UB, kmax = NEU_LB;
    for (int w = 0; w < W; ++w) {
      uint32_t word = 0;
      for (int b = 0; b < 32; ++b) {
        const int k = 32 * w + b;
        uint32_t hit = 0;
        for (int tw = 0; tw < TW; ++tw)
          hit |= __ldg(sp + (size_t)k * TW + tw) & cur[tw];
        if (hit) {
          word |= 1u << b;
          kmin = min(kmin, (Val)k);
          kmax = k;
        }
      }
      if (p.carry_dom) s.ctdom[i * W + w] = word;
    }
    const Val omem = __ldg(p.dom_off + __ldg(p.ct_vars + i));
    s.ctlb[i] = fail ? -NEU_LB : omem + kmin;
    s.ctub[i] = omem + kmax;
  }
}

struct LaneResult {
  int cur;      // buffer (0 or 1) that holds the final store
  int sweeps;
  int conv;     // converged: ¬changed ∨ failed
};

// Run the store in s.lb(0) / s.ub(0) (and, carried, s.dom(0)), written by
// the caller, by any thread, to its fixed point, at most `max_sweeps`
// sweeps, on a CTA of NT threads.  Every thread of the CTA calls it and
// gets the same result; the overload flags (and the dense profile) are
// clear again on return.  AD_SPARSE, CU_SPARSE and DOM must equal the
// model's layouts and uses_dom(p) (each kernel is instantiated for the
// eight triples and the launch picks the one that matches): compiled
// apart, a dense model's kernel carries none of the sparse code, a
// bounds-only one none of the bitset code, and each keeps its registers.
template <int NT, typename Val, bool AD_SPARSE, bool CU_SPARSE, bool DOM>
__device__ LaneResult fixpoint_lane(const Tables<Val>& p, const Smem<Val>& s,
                                    int max_sweeps) {
  constexpr Val BIG = Lim<Val>::BIG, NEU_UB = BIG, NEU_LB = -BIG;
  constexpr int WARPS = NT / 32;
  const int V = p.V, P1 = p.P1, K = p.K, K1 = p.K + 1, C1 = p.C1,
            T = p.T, H = p.H, N = p.N, A = p.n_alldiff;
  const bool cumul = p.n_cumulative > 0;
  const bool alldiff = A > 0;
  const bool cu_sparse = cumul && CU_SPARSE, cu_dense = cumul && !CU_SPARSE;
  const bool ad_sparse = alldiff && AD_SPARSE, ad_dense = alldiff && !AD_SPARSE;
  const bool table = DOM && p.n_table > 0;
  const bool carry = DOM && p.carry_dom;
  const int tid = threadIdx.x, nth = NT;
  const int lane = tid & 31, warp = tid >> 5;
  // (1a): GL lanes per row, a term each (strided when K > GL), as many
  // as one pass over the rows leaves threads for (1 when P1 >= NT);
  // (3): GJ lanes per variable, striding its occurrence slots.  The
  // many-lane instance keeps one thread per row and per variable: its
  // CTAs share an SM, and the groups' registers cost it more CTAs per SM
  // than their shuffles save (PERF.md)
  const int GL = NT == THREADS ? 1 : lane_group(K, NT / max(P1, 1));
  const int GJ = NT == THREADS ? 1 : lane_group(32, NT / max(V, 1));
  // The bitset-store instances of the 256-thread body keep the C1·H·T
  // compare loop for the dense profile: the difference array's code took
  // them from 80 to 126 registers in search.cu (two co-resident CTAs per
  // SM instead of three; PERF.md), and their models (tables,
  // middle_out) seldom carry Cumulative rows
  constexpr bool PROFILE_LOOP = NT == THREADS && DOM;
  // The few-lane instance keeps the dense AllDifferent bank's
  // endpoint-pair loop at int64: there the bitmask pass needs more than
  // its 64 registers a thread, while at int32 it is the pair loop that
  // spills (PERF.md §6)
  constexpr bool PAIR_LOOP = NT == FEW_THREADS && sizeof(Val) == 8;

  __syncthreads();
  int my_failed = 0;
  for (int v = tid; v < V; v += nth)
    my_failed |= (s.lb(0)[v] > s.ub(0)[v]);
  int failed = __syncthreads_or(my_failed);
  int changed = 1;
  int it = 0;
  int cur = 0;
#ifdef FIXLANE_CLOCKS
  __shared__ long long stamp_;
  if (tid == 0) stamp_ = clock64();
#endif

  while (changed && it < max_sweeps && !failed) {
    const Val* lb = s.lb(cur);
    const Val* ub = s.ub(cur);

    // -- (1a) ReifLinLe candidates: GL lanes per row, a term each -----------
    // smin/smax are integer sums (any order gives the same value), reduced
    // over the group by __shfl_xor; each lane writes its own terms'
    // candidates and the group's first lane the entailment pair.
    {
      const int g = tid & (GL - 1);
      for (int r0 = 0; r0 < P1; r0 += NT / GL) {     // uniform over the CTA
        const int r = r0 + tid / GL;
        const bool act = r < P1;
        const Val* a_row = p.coef + (size_t)r * K;
        const int32_t* v_row = p.vidx + (size_t)r * K;
        Val smin = 0, smax = 0;
        if (act)
          for (int k = g; k < K; k += GL) {
            const Val a = __ldg(a_row + k);
            const int32_t v = __ldg(v_row + k);
            const Val xl = lb[v], xu = ub[v];
            smin += a > 0 ? a * xl : a * xu;
            smax += a > 0 ? a * xu : a * xl;
          }
        for (int o = 1; o < GL; o <<= 1) {
          smin += shfl_xor(smin, o);
          smax += shfl_xor(smax, o);
        }
        if (!act) continue;
        const Val c = __ldg(p.rhs + r);
        const int32_t b = __ldg(p.bidx + r);
        const bool btrue = lb[b] >= 1;
        const bool bfalse = ub[b] <= 0;
        Val* cl = s.clb + (size_t)r * K1;
        Val* cu = s.cub + (size_t)r * K1;
        for (int k = g; k < K; k += GL) {
          const Val a = __ldg(a_row + k);
          const int32_t v = __ldg(v_row + k);
          const Val xl = lb[v], xu = ub[v];
          const Val tl = a > 0 ? a * xl : a * xu;
          const Val tu = a > 0 ? a * xu : a * xl;
          Val ub1 = NEU_UB, lb1 = NEU_LB, ub2 = NEU_UB, lb2 = NEU_LB;
          if (btrue) {                    // Σ a x ≤ c
            const Val slack1 = c - (smin - tl);
            if (a > 0) ub1 = fdiv<Val>(slack1, a);
            else if (a < 0) lb1 = cdiv<Val>(slack1, a);
          }
          if (bfalse) {                   // Σ -a x ≤ -c-1
            const Val slack2 = (-c - 1) - (-smax + tu);
            if (a < 0) ub2 = fdiv<Val>(slack2, -a);
            else if (a > 0) lb2 = cdiv<Val>(slack2, -a);
          }
          cl[k] = lb1 > lb2 ? lb1 : lb2;
          cu[k] = ub1 < ub2 ? ub1 : ub2;
        }
        if (g == 0) {
          cl[K] = smax <= c ? 1 : NEU_LB;   // entailed → b ≥ 1
          cu[K] = smin > c ? 0 : NEU_UB;    // disentailed → b ≤ 0
        }
      }
    }
    FIXLANE_STAMP(PH_LINEAR);

    // -- (1b) AllDifferent: shifted member bounds, neutral candidates -------
    if (ad_sparse) ad_sparse_keys<NT, Val>(p, s, lb);
    if (ad_dense) {
      for (int i = tid; i < p.A1 * N; i += nth) {
        if (__ldg(p.ad_mask + i)) {
          const int32_t v = __ldg(p.ad_vars + i);
          const Val off = __ldg(p.ad_offs + i);
          s.yl[i] = lb[v] + off;
          s.yu[i] = ub[v] + off;
        } else {                          // padding: inside no interval
          s.yl[i] = BIG;
          s.yu[i] = -BIG;
        }
        s.alb[i] = NEU_LB;
        s.aub[i] = NEU_UB;
      }
      for (int a = tid; a < p.A1; a += nth) s.afail[a] = 0;
      if (!PAIR_LOOP)                   // step (2)'s words, OR-ed in
        for (int i = tid; i < (int)ad_mask_words(p.A1, N); i += nth)
          ad_masks<Val>(p, s)[i] = 0;
    }
    FIXLANE_STAMP(PH_AD_STAGE);

    // -- (1d) Compact-Table: each member's OR of supports ----------------
    if (table) ct_supports<NT, Val>(p, s, cur, lb, ub);
    FIXLANE_STAMP(PH_CT_SUPP);

    // -- (1c) Cumulative: events (sparse) or the profile's difference
    // array (dense): +q where a task's compulsory part [lst, est + d)
    // starts and -q where it ends, clipped to [0, H), by shared-memory
    // atomicAdd (integer: any order gives the same sums); with
    // PROFILE_LOOP one thread per (row, time) sums the tasks over it ----
    if (cu_sparse) cu_sparse_events<NT, Val>(p, s, lb, ub);
    if (cu_dense && PROFILE_LOOP) {
      for (int i = tid; i < C1 * H; i += nth) {
        const int c = i / H, tau = i - c * H;
        Val acc = 0;
        for (int t = 0; t < T; ++t) {
          const int j = c * T + t;
          const Val d = s.t_dur[j], q = s.t_dem[j];
          if (d > 0 && q > 0) {
            const int32_t v = s.t_svar[j];
            if (ub[v] <= tau && tau < lb[v] + d) acc += q;
          }
        }
        s.prof[i] = acc;
        if (acc > s.t_cap[c]) s.ovl[c] = 1;   // benign race: all write 1
      }
    }
    if (cu_dense && !PROFILE_LOOP) {
      for (int j = tid; j < C1 * T; j += nth) {
        const Val d = s.t_dur[j], q = s.t_dem[j];
        if (!(d > 0 && q > 0)) continue;
        const int32_t v = s.t_svar[j];
        const Val lst = ub[v], ect = lb[v] + d;
        const Val lo = lst > 0 ? lst : 0, hi = ect < H ? ect : (Val)H;
        if (lo >= hi) continue;
        Val* pc = s.prof + (size_t)(j / T) * H;
        atomic_add(pc + lo, q);
        if (hi < H) atomic_add(pc + hi, -q);
      }
    }
    __syncthreads();
    FIXLANE_STAMP(PH_CU_EVENTS);

    // -- (2a) AllDifferent Hall intervals: the sparse sort and suffix
    // counts, or the dense member bitmasks and one thread per (row, i, j)
    if (ad_sparse) block_sort<NT>(s.akey, s.aval, ad_sort_n(p));
    FIXLANE_STAMP(PH_AD_SORT);
    if (ad_dense && !PAIR_LOOP) {
      ad_dense_masks<NT, Val>(p, s);
      __syncthreads();
    }
    FIXLANE_STAMP(PH_AD_MASKS);
    if (ad_sparse) ad_sparse_hall<NT, Val>(p, s, ub);
    if (ad_dense && !PAIR_LOOP) ad_dense_hall<NT, Val>(p, s);
    if (ad_dense && PAIR_LOOP) ad_dense_pairs<NT, Val>(p, s);
    FIXLANE_STAMP(PH_AD_HALL);

    // -- (2c) Compact-Table: current tables --------------------------------
    if (table) ct_current<NT, Val>(p, s);
    FIXLANE_STAMP(PH_CT_CUR);

    // -- (2b) Cumulative: sort and profile (sparse), the prefix sum of
    // each row's difference array (dense, a warp per row), the overload
    // flags, then the first/last feasible starts ------------------------
    if (cu_sparse) block_sort<NT>(s.ckey, s.cval, cu_sort_n(p));
    FIXLANE_STAMP(PH_CU_SORT);
    if (cu_sparse) cu_sparse_profile<NT, Val>(p, s);
    if (cu_dense && !PROFILE_LOOP) {
      for (int c = warp; c < C1; c += WARPS) {
        Val* pc = s.prof + (size_t)c * H;
        const Val cap = s.t_cap[c];
        Val run = 0;
        bool over = false;
        for (int t0 = 0; t0 < H; t0 += 32) {         // uniform over the warp
          const int tau = t0 + lane;
          Val x = tau < H ? pc[tau] : 0;
          for (int o = 1; o < 32; o <<= 1) {
            const Val y = shfl_up(x, o);
            if (lane >= o) x += y;
          }
          x += run;
          if (tau < H) {
            pc[tau] = x;
            over |= x > cap;
          }
          run = shfl_idx(x, 31);
        }
        if (__any_sync(0xffffffffu, over) && lane == 0) s.ovl[c] = 1;
      }
      __syncthreads();
    }
    FIXLANE_STAMP(PH_CU_PROFILE);
    if (cu_sparse) cu_sparse_starts<NT, Val>(p, s, lb, ub);
    if (cu_dense) {
      for (int j = tid; j < C1 * T; j += nth) {
        const int c = j / T;
        const Val d = s.t_dur[j], q = s.t_dem[j];
        if (!(d > 0 && q > 0)) {
          s.ulb[j] = NEU_LB;
          s.uub[j] = NEU_UB;
          continue;
        }
        const int32_t v = s.t_svar[j];
        const Val est = lb[v], lst = ub[v], cap = s.t_cap[c];
        const Val* pc = s.prof + (size_t)c * H;
        // first s ≥ max(est, 0) with no bad point in [s, min(s + d, H))
        Val first = -NEU_LB;
        {
          Val st = est > 0 ? est : 0;
          Val tau = st;
          while (st < H) {
            const Val e = st + d < H ? st + d : H;
            if (tau >= e) { first = st; break; }
            if (bad_at<Val>(pc, tau, est, lst, d, q, cap)) {
              st = tau + 1;
              tau = st;
            } else {
              ++tau;
            }
          }
        }
        // last s ≤ min(lst, H - 1) with no bad point in [s, min(s + d, H))
        Val last = -NEU_UB;
        {
          const Val s_hi = lst < H - 1 ? lst : H - 1;
          if (s_hi >= 0) {
            Val nb = 0x7fffffff;            // nearest bad point ≥ s
            const Val e_hi = s_hi + d < H ? s_hi + d : H;
            for (Val tau = e_hi - 1; tau > s_hi; --tau)
              if (bad_at<Val>(pc, tau, est, lst, d, q, cap)) nb = tau;
            for (Val st = s_hi; st >= 0; --st) {
              if (bad_at<Val>(pc, st, est, lst, d, q, cap)) nb = st;
              const Val e = st + d < H ? st + d : H;
              if (nb >= e) { last = st; break; }
            }
          }
        }
        s.ulb[j] = s.ovl[c] ? -NEU_LB : first;   // overload fails the row
        s.uub[j] = last;
      }
    }
    __syncthreads();
    FIXLANE_STAMP(PH_CU_STARTS);
    // -- (2d) Compact-Table: survivors, hull and word candidates ----------
    if (table) {
      ct_survivors<NT, Val>(p, s);
      __syncthreads();
    }
    FIXLANE_STAMP(PH_CT_SURV);

    // -- (3) join: GJ lanes per variable stride its occurrence slots and
    // max/min-reduce them by __shfl_xor (max and min commute); the group's
    // first lane clamps to the box, ANDs and normalizes the carried words
    // and writes the next store ------------------------------------------
    Val* nlb_s = s.lb(cur ^ 1);
    Val* nub_s = s.ub(cur ^ 1);
    int my_changed = 0;
    my_failed = 0;
    const int g = tid & (GJ - 1);
    for (int v0 = 0; v0 < V; v0 += NT / GJ) {         // uniform over the CTA
      const int v = v0 + tid / GJ;
      const bool act = v < V;
      Val glb = NEU_LB, gub = NEU_UB;
      if (act) {
        const int32_t* op = p.occ_prop + (size_t)v * p.D;
        const int32_t* os = p.occ_slot + (size_t)v * p.D;
        #pragma unroll (NT == THREADS ? 1 : 4)
        for (int d = g; d < p.D; d += GJ) {
          const int idx = __ldg(op + d) * K1 + __ldg(os + d);
          glb = max(glb, s.clb[idx]);
          gub = min(gub, s.cub[idx]);
        }
        if (ad_sparse) {                // flat: ad_ptr[inst] + pos
          const int32_t* oi = p.ad_occ_inst + (size_t)v * p.Dad;
          const int32_t* opos = p.ad_occ_pos + (size_t)v * p.Dad;
          #pragma unroll (NT == THREADS ? 1 : 4)
          for (int d = g; d < p.Dad; d += GJ) {
            const int idx = __ldg(p.ad_ptr + __ldg(oi + d)) + __ldg(opos + d);
            glb = max(glb, s.alb[idx]);
            gub = min(gub, s.aub[idx]);
          }
        }
        if (ad_dense) {
          const int32_t* oi = p.ad_occ_inst + (size_t)v * p.Dad;
          const int32_t* opos = p.ad_occ_pos + (size_t)v * p.Dad;
          #pragma unroll (NT == THREADS ? 1 : 4)
          for (int d = g; d < p.Dad; d += GJ) {
            const int a = __ldg(oi + d);
            const int idx = a * N + __ldg(opos + d);
            const Val off = __ldg(p.ad_offs + idx);
            glb = max(glb, (s.afail[a] ? -NEU_LB : s.alb[idx]) - off);
            gub = min(gub, s.aub[idx] - off);
          }
        }
        if (cumul) {                    // sparse: flat cu_ptr[inst] + pos
          const int32_t* oi = p.cu_occ_inst + (size_t)v * p.Dcu;
          const int32_t* opos = p.cu_occ_pos + (size_t)v * p.Dcu;
          #pragma unroll (NT == THREADS ? 1 : 4)
          for (int d = g; d < p.Dcu; d += GJ) {
            const int idx =
                CU_SPARSE ? __ldg(p.cu_ptr + __ldg(oi + d)) + __ldg(opos + d)
                          : __ldg(oi + d) * T + __ldg(opos + d);
            glb = max(glb, s.ulb[idx]);
            gub = min(gub, s.uub[idx]);
          }
        }
        if (table) {
          const int32_t* oi = p.ct_occ_inst + (size_t)v * p.Dct;
          const int32_t* opos = p.ct_occ_pos + (size_t)v * p.Dct;
          #pragma unroll (NT == THREADS ? 1 : 4)
          for (int d = g; d < p.Dct; d += GJ) {
            const int idx = __ldg(oi + d) * p.R + __ldg(opos + d);
            glb = max(glb, s.ctlb[idx]);
            gub = min(gub, s.ctub[idx]);
          }
        }
      }
      for (int o = 1; o < GJ; o <<= 1) {
        glb = max(glb, shfl_xor(glb, o));
        gub = min(gub, shfl_xor(gub, o));
      }
      if (!act || g != 0) continue;
      gub = max(gub, __ldg(p.box_lo + v));
      glb = min(glb, __ldg(p.box_hi + v));
      Val l = max(lb[v], glb);
      Val u = min(ub[v], gub);
      if (carry) {
        // AND the table occurrences into the words, then normalize
        const int W = p.W;
        const uint32_t* dc = s.dom(cur) + (size_t)v * W;
        uint32_t* dn = s.dom(cur ^ 1) + (size_t)v * W;
        const bool trk = __ldg(p.dom_track + v) != 0;
        const Val off = __ldg(p.dom_off + v);
        int32_t lo_pos = 32 * W, hi_pos = -1;
        for (int w = 0; w < W; ++w) {
          uint32_t word = dc[w];
          if (table) {
            const int32_t* oi = p.ct_occ_inst + (size_t)v * p.Dct;
            const int32_t* opos = p.ct_occ_pos + (size_t)v * p.Dct;
            for (int d = 0; d < p.Dct; ++d)
              word &= s.ctdom[(__ldg(oi + d) * p.R + __ldg(opos + d)) * W + w];
          }
          if (trk) {
            word &= range_word<Val>(l, u, off, w);
            if (word) {
              lo_pos = min(lo_pos, 32 * w + __ffs(word) - 1);
              hi_pos = 32 * w + 31 - __clz(word);
            }
          }
          dn[w] = word;
          my_changed |= word != dc[w];
        }
        if (trk) {
          l = max(l, min((Val)(off + lo_pos), __ldg(p.box_hi + v)));
          u = min(u, max((Val)(off + hi_pos), __ldg(p.box_lo + v)));
        }
      }
      nlb_s[v] = l;
      nub_s[v] = u;
      my_changed |= (l != lb[v]) | (u != ub[v]);
      my_failed |= (l > u);
    }
    if (cumul)
      for (int c = tid; c < C1; c += nth) s.ovl[c] = 0;   // for the next sweep
    if (cu_dense && !PROFILE_LOOP)      // the next sweep's difference array
      for (int i = tid; i < C1 * H; i += nth) s.prof[i] = 0;
    changed = __syncthreads_or(my_changed);
    failed = __syncthreads_or(my_failed);
    FIXLANE_STAMP(PH_JOIN);
#ifdef FIXLANE_CLOCKS
    if (tid == 0) atomicAdd(&fixlane::clocks[N_PHASES], 1ull);
#endif
    cur ^= 1;
    ++it;
  }
  return LaneResult{cur, it, (!changed) || failed};
}

}  // namespace fixlane
