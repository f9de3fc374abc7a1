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
// Design (TURBO's block-per-subproblem mapping):
//   * the lane's current and next lb/ub live in shared memory,
//     double-buffered, so every sweep reads only the old store (Jacobi,
//     as the reference: capped stores and sweep counts match);
//   * per sweep: (1) threads over linear rows write the [P1, K+1]
//     candidates, threads over AllDifferent members stage the shifted
//     bounds yl/yu [A1, N], threads over (row, time) build the
//     compulsory-part profile [C1, H]; (2) threads over AllDifferent
//     endpoint pairs (row, i, j) count the members inside [yl_i, yu_j]
//     and push, threads over (row, task) find the first and last
//     feasible start; (3) threads over variables min/max-reduce their
//     occurrence lists, clamp to the box and write the next store (a
//     sparse bank writes its sort keys in (1) and sorts and scans in
//     (2), below);
//   * `__syncthreads_or` ends the loop on the per-lane rule
//     changed ∧ it < max_sweeps ∧ ¬failed, so every thread leaves with
//     the same sweep count, flags and result buffer.
// The tables stay read-only in global memory (they sit in L2); only the
// cumulative task table is staged in shared memory, once per CTA.
//
// Dense AllDifferent (the reference's [L, A1, N, N, N] tensor is its
// specification, not carried over): one thread per endpoint pair (i, j)
// of a row tests I = [yl_i, yu_j] by a loop over the row's N members.
// More members inside I than its width fails the row (a per-row flag);
// exactly as many makes I a Hall interval, and each member outside I
// with a bound inside it is pushed out with a shared-memory
// atomicMax/atomicMin on the row's candidate pair.  Those commute, so
// the pair equals the reference's max/min over (i, j).  Padded members
// are staged as the empty interval yl = BIG > yu = -BIG: no pair starts
// or ends at one, it is never inside (a real member of a store that is
// swept has yl <= yu) and never pushed (real bounds stay inside the
// box, far from ±BIG).  The join reads the pair
// through ad_occ_inst/ad_occ_pos, with a failed row's lb candidates at
// -NEU_LB, shifted back by the member's offset, as the reference.
//
// The sparse layouts (packed/CSR rows: members or tasks of every row on
// one axis of M slots with a segment id each, padding in segment A or C)
// share a bitonic sort of 64-bit keys in shared memory (`block_sort`).
// Signed values are biased (x ^ 0x80000000) before they are packed, so
// the key order equals the reference's lexsort on every int32.
//   * Cumulative: each packed task writes two events, (seg, lst, 1) with
//     +q and (seg, ect, 0) with -q (delta 0 without a compulsory part,
//     and every slot writes both: the interval bounds depend on all of
//     them).  After the sort a block prefix sum gives the profile; an
//     event owns [u, v) up to the next event of its segment.  Under the
//     seg-major sort segment c's events are sorted positions
//     [2·cu_ptr[c], 2·cu_ptr[c+1]), so one thread per task runs the
//     forward and backward monotone-jump scans over its own segment only
//     (the reference scans all events under a same-segment mask).  Keys
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

constexpr int THREADS = 256;              // threads per CTA (one lane at a time)

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
//   AllDifferent, dense:  yl, yu, candidate pair [A1, N] (V) and a fail
//     flag per row (I);
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
         region<Val, int32_t>(p.A1);
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
  int32_t* afail;   // [A1] pigeonhole failure per row
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
  __device__ __forceinline__ T* take(size_t n) {
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
// addresses only.
template <typename Val, bool AD_SPARSE, bool CU_SPARSE, bool DOM>
__device__ __forceinline__ Smem<Val> carve(const Tables<Val>& p,
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

// Stage the cumulative task table in shared memory and clear the
// overload flags; once per CTA, before its first fixpoint.  The caller
// synchronises (fixpoint_lane starts with a barrier).
template <typename Val, bool CU_SPARSE>
__device__ __forceinline__ void stage_tables(const Tables<Val>& p,
                                             const Smem<Val>& s) {
  if (p.n_cumulative <= 0) return;
  const int tid = threadIdx.x;
  if (CU_SPARSE) {
    for (int i = tid; i < p.Mcu; i += THREADS) {
      s.t_svar[i] = p.cu_pk_svar[i];
      s.t_dur[i] = p.cu_pk_dur[i];
      s.t_dem[i] = p.cu_pk_dem[i];
      s.t_seg[i] = p.cu_pk_seg[i];
    }
  } else {
    for (int i = tid; i < p.C1 * p.T; i += THREADS) {
      s.t_svar[i] = p.cu_svar[i];
      s.t_dur[i] = p.cu_dur[i];
      s.t_dem[i] = p.cu_dem[i];
    }
  }
  for (int c = tid; c < p.C1; c += THREADS) {
    s.t_cap[c] = p.cu_cap[c];
    s.ovl[c] = 0;
  }
}

// ---- block-wide building blocks (every thread of the CTA calls them) ----

constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ int32_t shfl_up(int32_t x, int o) {
  return __shfl_up_sync(0xffffffffu, x, o);
}
__device__ __forceinline__ int64_t shfl_up(int64_t x, int o) {
  return (int64_t)__shfl_up_sync(0xffffffffu, (long long)x, o);
}

// Exclusive prefix sum of one value per thread over the CTA; `wsum` holds
// 32 values.  Returns the thread's prefix and writes the total.
template <typename T>
__device__ T block_exclusive_scan(T v, T* wsum, T* total) {
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
template <typename Val>
__device__ void block_inclusive_scan(Val* x, int n, Val* wsum) {
  const int per = (n + THREADS - 1) / THREADS;
  const int lo = min(n, (int)threadIdx.x * per), hi = min(n, lo + per);
  Val sum = 0;
  for (int i = lo; i < hi; ++i) sum += x[i];
  Val total;
  Val run = block_exclusive_scan<Val>(sum, wsum, &total);
  for (int i = lo; i < hi; ++i) {
    run += x[i];
    x[i] = run;
  }
  __syncthreads();
}

// Sort n (a power of two) keys ascending in shared memory, each with its
// payload: a bitonic network, n/2 compare-exchanges per step spread over
// the CTA.  Equal keys are never swapped.  The caller synchronises before
// (the keys are written); it ends with a barrier.
template <typename Key, typename P>
__device__ void block_sort(Key* key, P* val, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < (n >> 1); t += THREADS) {
        const int i = 2 * j * (t / j) + (t % j);   // bit j of i is clear
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
  }
}

// ---- the sparse Cumulative bank ------------------------------------------

// Step (1): one thread per event slot writes its key (segment, time,
// kind) and delta; the power-of-two tail gets keys that sort last.
template <typename Val>
__device__ void cu_sparse_events(const Tables<Val>& p, const Smem<Val>& s,
                                 const Val* lb, const Val* ub) {
  using SK = SortKey<Val>;
  const int M = p.Mcu, n = cu_sort_n(p);
  for (int e = threadIdx.x; e < n; e += THREADS) {
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

// Step (2): sort, profile, per-row overload, then one thread per task
// finds its first and last feasible start.  Barriers separate its
// passes; the caller synchronises after the last.
template <typename Val>
__device__ void cu_sparse_scan(const Tables<Val>& p, const Smem<Val>& s,
                               const Val* lb, const Val* ub) {
  using SK = SortKey<Val>;
  constexpr Val NEU_UB = Lim<Val>::BIG, NEU_LB = -Lim<Val>::BIG;
  const int M = p.Mcu, E = 2 * M;
  block_sort(s.ckey, s.cval, cu_sort_n(p));
  block_inclusive_scan<Val>(s.cval, cu_sort_n(p), s.wsum);
  // an overloaded non-empty interval [u, v) fails its row
  for (int e = threadIdx.x; e < E; e += THREADS) {
    const auto k = s.ckey[e];
    const int c = SK::event_seg(k);
    const Val u = SK::event_time(k);
    const Val v = (e + 1 < E && SK::event_seg(s.ckey[e + 1]) == c)
                      ? SK::event_time(s.ckey[e + 1]) : u;
    if (u < v && s.cval[e] > s.t_cap[c]) s.ovl[c] = 1;  // benign race
  }
  __syncthreads();
  for (int m = threadIdx.x; m < M; m += THREADS) {
    const Val d = s.t_dur[m], q = s.t_dem[m];
    const int c = s.t_seg[m];
    if (!(c < p.n_cumulative && d > 0 && q > 0)) {
      s.ulb[m] = NEU_LB;
      s.uub[m] = NEU_UB;
      continue;
    }
    const Val cap = s.t_cap[c];
    if (q > cap) {                 // a lone task over capacity
      s.ulb[m] = -NEU_LB;
      s.uub[m] = -NEU_UB;
      continue;
    }
    const int v = s.t_svar[m];
    const Val est = lb[v], lst = ub[v], ect = est + d;
    const bool cp = lst < ect;
    const int e0 = 2 * __ldg(p.cu_ptr + c), e1 = 2 * __ldg(p.cu_ptr + c + 1);
    // first feasible start >= est: jump past each forbidden interval
    Val st = est;
    Val u = e0 < e1 ? SK::event_time(s.ckey[e0]) : 0;
    for (int e = e0; e < e1; ++e) {
      const Val v_ = e + 1 < e1 ? SK::event_time(s.ckey[e + 1]) : u;
      if (u < v_) {
        const bool own = cp && u >= lst && u < ect;
        if (s.cval[e] + (own ? 0 : q) > cap && st < v_ && st + d > u)
          st = v_;
      }
      u = v_;
    }
    // last feasible start <= lst: jump before each forbidden interval
    Val sl = lst;
    Val v_ = e1 > e0 ? SK::event_time(s.ckey[e1 - 1]) : 0;
    for (int e = e1 - 1; e >= e0; --e) {
      const Val u_ = SK::event_time(s.ckey[e]);
      if (u_ < v_) {
        const bool own = cp && u_ >= lst && u_ < ect;
        if (s.cval[e] + (own ? 0 : q) > cap && sl < v_ && sl + d > u_)
          sl = u_ - d;
      }
      v_ = u_;
    }
    s.ulb[m] = s.ovl[c] ? -NEU_LB : st;     // overload fails the row
    s.uub[m] = sl >= 0 ? sl : -NEU_UB;
  }
}

// ---- the sparse AllDifferent bank ----------------------------------------

// Step (1): one thread per key slot writes (seg, yl) and the member
// index; the Hall folds and fail flags are cleared.
template <typename Val>
__device__ void ad_sparse_keys(const Tables<Val>& p, const Smem<Val>& s,
                               const Val* lb) {
  using SK = SortKey<Val>;
  const int M = p.Mad, n = ad_sort_n(p);
  for (int i = threadIdx.x; i < n; i += THREADS) {
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
  for (int a = threadIdx.x; a < p.A1; a += THREADS) s.afail[a] = 0;
}

// Step (2): sort, Hall counts and folds, pushes.  Writes the candidate
// pair in packed order, unshifted (a failed row's lb at -NEU_LB - off).
// Barriers separate its passes; the caller synchronises after the last.
template <typename Val>
__device__ void ad_sparse_hall(const Tables<Val>& p, const Smem<Val>& s,
                               const Val* ub) {
  using SK = SortKey<Val>;
  constexpr Val NEU_UB = Lim<Val>::BIG, NEU_LB = -Lim<Val>::BIG;
  const int M = p.Mad, A = p.n_alldiff;
  block_sort(s.akey, s.aval, ad_sort_n(p));
  for (int i = threadIdx.x; i < M; i += THREADS) {
    const int m = s.aval[i];
    s.syl[i] = SK::member_value(s.akey[i]);
    s.syu[i] = ub[__ldg(p.ad_pk_var + m)] + __ldg(p.ad_pk_off + m);
  }
  __syncthreads();
  // one thread per upper endpoint j: cnt(i, j) by the suffix count
  for (int j = threadIdx.x; j < M; j += THREADS) {
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
  for (int k = threadIdx.x; k < M; k += THREADS) {
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
template <typename Val>
__device__ void ct_supports(const Tables<Val>& p, const Smem<Val>& s,
                            int cur, const Val* lb, const Val* ub) {
  const int TW = p.TW, W = p.W, K32 = 32 * p.W;
  for (int i = threadIdx.x; i < p.T1 * p.R * TW; i += THREADS) {
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
template <typename Val>
__device__ void ct_current(const Tables<Val>& p, const Smem<Val>& s) {
  const int R = p.R, TW = p.TW;
  for (int i = threadIdx.x; i < p.T1 * TW; i += THREADS) {
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
template <typename Val>
__device__ void ct_survivors(const Tables<Val>& p, const Smem<Val>& s) {
  constexpr Val NEU_UB = Lim<Val>::BIG, NEU_LB = -Lim<Val>::BIG;
  const int R = p.R, TW = p.TW, W = p.W, K32 = 32 * p.W;
  for (int i = threadIdx.x; i < p.T1 * R; i += THREADS) {
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
// sweeps.  Every thread of the CTA calls it and gets the same result; the
// overload flags are clear again on return.  AD_SPARSE, CU_SPARSE and DOM
// must equal the model's layouts and uses_dom(p) (each kernel is
// instantiated for the eight triples and the launch picks the one that
// matches): compiled apart, a dense model's kernel carries none of the
// sparse code, a bounds-only one none of the bitset code, and each keeps
// its registers.
template <typename Val, bool AD_SPARSE, bool CU_SPARSE, bool DOM>
__device__ LaneResult fixpoint_lane(const Tables<Val>& p, const Smem<Val>& s,
                                    int max_sweeps) {
  constexpr Val BIG = Lim<Val>::BIG, NEU_UB = BIG, NEU_LB = -BIG;
  const int V = p.V, P1 = p.P1, K = p.K, K1 = p.K + 1, C1 = p.C1,
            T = p.T, H = p.H, N = p.N, A = p.n_alldiff;
  const bool cumul = p.n_cumulative > 0;
  const bool alldiff = A > 0;
  const bool cu_sparse = cumul && CU_SPARSE, cu_dense = cumul && !CU_SPARSE;
  const bool ad_sparse = alldiff && AD_SPARSE, ad_dense = alldiff && !AD_SPARSE;
  const bool table = DOM && p.n_table > 0;
  const bool carry = DOM && p.carry_dom;
  const int tid = threadIdx.x, nth = THREADS;

  __syncthreads();
  int my_failed = 0;
  for (int v = tid; v < V; v += nth)
    my_failed |= (s.lb(0)[v] > s.ub(0)[v]);
  int failed = __syncthreads_or(my_failed);
  int changed = 1;
  int it = 0;
  int cur = 0;

  while (changed && it < max_sweeps && !failed) {
    const Val* lb = s.lb(cur);
    const Val* ub = s.ub(cur);

    // -- (1a) ReifLinLe candidates, one thread per row ---------------------
    for (int r = tid; r < P1; r += nth) {
      const Val* a_row = p.coef + (size_t)r * K;
      const int32_t* v_row = p.vidx + (size_t)r * K;
      Val smin = 0, smax = 0;
      for (int k = 0; k < K; ++k) {
        Val a = __ldg(a_row + k);
        int32_t v = __ldg(v_row + k);
        Val xl = lb[v], xu = ub[v];
        smin += a > 0 ? a * xl : a * xu;
        smax += a > 0 ? a * xu : a * xl;
      }
      const Val c = __ldg(p.rhs + r);
      const int32_t b = __ldg(p.bidx + r);
      const bool btrue = lb[b] >= 1;
      const bool bfalse = ub[b] <= 0;
      Val* cl = s.clb + (size_t)r * K1;
      Val* cu = s.cub + (size_t)r * K1;
      for (int k = 0; k < K; ++k) {
        Val a = __ldg(a_row + k);
        int32_t v = __ldg(v_row + k);
        Val xl = lb[v], xu = ub[v];
        Val tl = a > 0 ? a * xl : a * xu;
        Val tu = a > 0 ? a * xu : a * xl;
        Val ub1 = NEU_UB, lb1 = NEU_LB, ub2 = NEU_UB, lb2 = NEU_LB;
        if (btrue) {                      // Σ a x ≤ c
          Val slack1 = c - (smin - tl);
          if (a > 0) ub1 = fdiv<Val>(slack1, a);
          else if (a < 0) lb1 = cdiv<Val>(slack1, a);
        }
        if (bfalse) {                     // Σ -a x ≤ -c-1
          Val slack2 = (-c - 1) - (-smax + tu);
          if (a < 0) ub2 = fdiv<Val>(slack2, -a);
          else if (a > 0) lb2 = cdiv<Val>(slack2, -a);
        }
        cl[k] = lb1 > lb2 ? lb1 : lb2;
        cu[k] = ub1 < ub2 ? ub1 : ub2;
      }
      cl[K] = smax <= c ? 1 : NEU_LB;     // entailed → b ≥ 1
      cu[K] = smin > c ? 0 : NEU_UB;      // disentailed → b ≤ 0
    }

    // -- (1b) AllDifferent: shifted member bounds, neutral candidates -------
    if (ad_sparse) ad_sparse_keys<Val>(p, s, lb);
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
    }

    // -- (1d) Compact-Table: each member's OR of supports ----------------
    if (table) ct_supports<Val>(p, s, cur, lb, ub);

    // -- (1c) compulsory-part profile, one thread per (row, time) ----------
    if (cu_sparse) cu_sparse_events<Val>(p, s, lb, ub);
    if (cu_dense) {
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
    __syncthreads();

    // -- (2a) AllDifferent Hall intervals, one thread per (row, i, j) -------
    if (ad_sparse) ad_sparse_hall<Val>(p, s, ub);
    if (ad_dense) {
      const int NN = N * N;
      for (int q = tid; q < A * NN; q += nth) {
        const int a = q / NN, i = (q - a * NN) / N, j = q - a * NN - i * N;
        const Val* ylr = s.yl + a * N;
        const Val* yur = s.yu + a * N;
        const Val lo = ylr[i], hi = yur[j];
        if (lo > hi) continue;            // empty interval or padding
        Val cnt = 0;
        for (int k = 0; k < N; ++k) {
          const Val kl = ylr[k], ku = yur[k];
          cnt += (kl >= lo) & (ku <= hi) & (kl <= ku);
        }
        const Val width = hi - lo + 1;
        if (cnt > width) {
          s.afail[a] = 1;                 // benign race: all write 1
        } else if (cnt == width) {        // Hall interval: push the others
          for (int k = 0; k < N; ++k) {
            const Val kl = ylr[k], ku = yur[k];
            if (kl >= lo && ku <= hi && kl <= ku) continue;   // inside I
            if (kl >= lo && kl <= hi) atomic_max(s.alb + a * N + k, hi + 1);
            if (ku >= lo && ku <= hi) atomic_min(s.aub + a * N + k, lo - 1);
          }
        }
      }
    }

    // -- (2c) Compact-Table: current tables --------------------------------
    if (table) ct_current<Val>(p, s);

    // -- (2b) first/last feasible start, one thread per (row, task) --------
    if (cu_sparse) cu_sparse_scan<Val>(p, s, lb, ub);
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
    // -- (2d) Compact-Table: survivors, hull and word candidates ----------
    if (table) {
      ct_survivors<Val>(p, s);
      __syncthreads();
    }

    // -- (3) per-variable gather join, box clamp, next store ---------------
    Val* nlb_s = s.lb(cur ^ 1);
    Val* nub_s = s.ub(cur ^ 1);
    int my_changed = 0;
    my_failed = 0;
    for (int v = tid; v < V; v += nth) {
      Val glb = NEU_LB, gub = NEU_UB;
      const int32_t* op = p.occ_prop + (size_t)v * p.D;
      const int32_t* os = p.occ_slot + (size_t)v * p.D;
      for (int d = 0; d < p.D; ++d) {
        const int idx = __ldg(op + d) * K1 + __ldg(os + d);
        glb = max(glb, s.clb[idx]);
        gub = min(gub, s.cub[idx]);
      }
      if (ad_sparse) {                  // flat: ad_ptr[inst] + pos
        const int32_t* oi = p.ad_occ_inst + (size_t)v * p.Dad;
        const int32_t* opos = p.ad_occ_pos + (size_t)v * p.Dad;
        for (int d = 0; d < p.Dad; ++d) {
          const int idx = __ldg(p.ad_ptr + __ldg(oi + d)) + __ldg(opos + d);
          glb = max(glb, s.alb[idx]);
          gub = min(gub, s.aub[idx]);
        }
      }
      if (ad_dense) {
        const int32_t* oi = p.ad_occ_inst + (size_t)v * p.Dad;
        const int32_t* opos = p.ad_occ_pos + (size_t)v * p.Dad;
        for (int d = 0; d < p.Dad; ++d) {
          const int a = __ldg(oi + d);
          const int idx = a * N + __ldg(opos + d);
          const Val off = __ldg(p.ad_offs + idx);
          glb = max(glb, (s.afail[a] ? -NEU_LB : s.alb[idx]) - off);
          gub = min(gub, s.aub[idx] - off);
        }
      }
      if (cumul) {                      // sparse: flat cu_ptr[inst] + pos
        const int32_t* oi = p.cu_occ_inst + (size_t)v * p.Dcu;
        const int32_t* opos = p.cu_occ_pos + (size_t)v * p.Dcu;
        for (int d = 0; d < p.Dcu; ++d) {
          const int idx = CU_SPARSE
                              ? __ldg(p.cu_ptr + __ldg(oi + d)) + __ldg(opos + d)
                              : __ldg(oi + d) * T + __ldg(opos + d);
          glb = max(glb, s.ulb[idx]);
          gub = min(gub, s.uub[idx]);
        }
      }
      if (table) {
        const int32_t* oi = p.ct_occ_inst + (size_t)v * p.Dct;
        const int32_t* opos = p.ct_occ_pos + (size_t)v * p.Dct;
        for (int d = 0; d < p.Dct; ++d) {
          const int idx = __ldg(oi + d) * p.R + __ldg(opos + d);
          glb = max(glb, s.ctlb[idx]);
          gub = min(gub, s.ctub[idx]);
        }
      }
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
    changed = __syncthreads_or(my_changed);
    failed = __syncthreads_or(my_failed);
    cur ^= 1;
    ++it;
  }
  return LaneResult{cur, it, (!changed) || failed};
}

}  // namespace fixlane
