// One lane's propagation fixpoint, run by one CTA: the device code that
// `fixpoint.cu` (one launch per fixpoint) and `search.cu` (K supersteps
// per launch) share.
//
// It covers the ReifLinLe bank (`fixpoint.candidates_tile`), the dense
// AllDifferent bank (`fixpoint.alldiff_candidates_tile`) and the dense
// Cumulative bank (`fixpoint.cumulative_candidates_tile`): what RCPSP,
// N-queens, graph coloring, knapsack and jobshop lower to.  The plain
// PyTorch version is repro_torch/core/fixpoint.py::fixpoint_batch;
// results (stores, sweep counts, convergence flags) are equal bit for
// bit, capped or not.
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
//     occurrence lists, clamp to the box and write the next store;
//   * `__syncthreads_or` ends the loop on the per-lane rule
//     changed ∧ it < max_sweeps ∧ ¬failed, so every thread leaves with
//     the same sweep count, flags and result buffer.
// The tables stay read-only in global memory (they sit in L2); only the
// cumulative task table is staged in shared memory, once per CTA.
//
// AllDifferent (the reference's [L, A1, N, N, N] tensor is its
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
// Arithmetic: int32 only (the wrappers reject int64 models).  Floor and
// ceil division follow `_fdiv`/`_cdiv` (C++ `/` truncates toward zero).
// The compile-time headroom (compile.py) keeps every intermediate the
// reference computes in range; this code computes no others.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fixlane {

constexpr int THREADS = 256;              // threads per CTA (one lane at a time)
constexpr int32_t BIG = 0x7fffffff / 4;   // iinfo(int32).max // 4
constexpr int32_t NEU_UB = BIG;
constexpr int32_t NEU_LB = -BIG;

__device__ __forceinline__ int32_t fdiv(int32_t p, int32_t q) {
  int32_t r = p / q;
  if ((p % q != 0) && ((p < 0) != (q < 0))) r -= 1;
  return r;
}

__device__ __forceinline__ int32_t cdiv(int32_t p, int32_t q) {
  return -fdiv(-p, q);
}

// The model's propagator tables (global memory, read-only) and shapes.
// The wrappers pass the N_TABLES pointers and N_DIMS sizes in this order
// (kernels/fixpoint_kernel.py::kernel_tables, _c_tables).
struct Tables {
  const int32_t* vidx;        // [P1, K]
  const int32_t* coef;        // [P1, K]
  const int32_t* rhs;         // [P1]
  const int32_t* bidx;        // [P1]
  const int32_t* occ_prop;    // [V, D]
  const int32_t* occ_slot;    // [V, D]
  const int32_t* ad_vars;     // [A1, N]
  const int32_t* ad_offs;     // [A1, N]
  const int32_t* ad_mask;     // [A1, N]
  const int32_t* ad_occ_inst; // [V, Dad]
  const int32_t* ad_occ_pos;  // [V, Dad]
  const int32_t* cu_svar;     // [C1, T]
  const int32_t* cu_dur;      // [C1, T]
  const int32_t* cu_dem;      // [C1, T]
  const int32_t* cu_cap;      // [C1]
  const int32_t* cu_occ_inst; // [V, Dcu]
  const int32_t* cu_occ_pos;  // [V, Dcu]
  const int32_t* box_lo;      // [V]
  const int32_t* box_hi;      // [V]
  int V, P1, K, D, A1, N, Dad, n_alldiff, C1, T, Dcu, H, n_cumulative;
};

constexpr int N_TABLES = 19;
constexpr int N_DIMS = 13;

inline Tables tables_from(const void* const* tb, const int* d) {
  const int32_t* const* t = (const int32_t* const*)tb;
  return Tables{t[0],  t[1],  t[2],  t[3],  t[4],  t[5],  t[6],
                t[7],  t[8],  t[9],  t[10], t[11], t[12], t[13],
                t[14], t[15], t[16], t[17], t[18],
                d[0],  d[1],  d[2],  d[3],  d[4],  d[5],  d[6],
                d[7],  d[8],  d[9],  d[10], d[11], d[12]};
}

// 32-bit words of shared memory one lane's fixpoint needs; the wrappers'
// budget (kernels/fixpoint_kernel.py::smem_budget) uses the same formula.
// A model without AllDifferent rows gets no AllDifferent part.
__host__ __device__ inline size_t alldiff_words(const Tables& p) {
  return p.n_alldiff > 0 ? (size_t)4 * p.A1 * p.N + (size_t)p.A1 : 0;
}

__host__ __device__ inline size_t smem_words(const Tables& p) {
  return (size_t)4 * p.V + (size_t)2 * p.P1 * (p.K + 1) +
         (size_t)p.C1 * p.H + (size_t)5 * p.C1 * p.T + (size_t)2 * p.C1 +
         alldiff_words(p);
}

// The fixpoint's view of a CTA's shared memory.  Store buffer c (0 or
// 1) is lb(c), ub(c): [lb0 | ub0 | lb1 | ub1], V words each (computed
// addresses, so no pointer array lands on the stack).
struct Smem {
  int32_t* store;
  int V;
  __device__ __forceinline__ int32_t* lb(int c) const {
    return store + 2 * c * V;
  }
  __device__ __forceinline__ int32_t* ub(int c) const {
    return store + 2 * c * V + V;
  }
  int32_t* clb;     // [P1, K+1]
  int32_t* cub;     // [P1, K+1]
  int32_t* prof;    // [C1, H]
  int32_t* ulb;     // [C1, T]
  int32_t* uub;     // [C1, T]
  int32_t* t_svar;  // [C1, T]
  int32_t* t_dur;   // [C1, T]
  int32_t* t_dem;   // [C1, T]
  int32_t* t_cap;   // [C1]
  int32_t* ovl;     // [C1]
  int32_t* yl;      // [A1, N] shifted member bounds (AllDifferent)
  int32_t* yu;      // [A1, N]
  int32_t* alb;     // [A1, N] AllDifferent candidate pair (shifted)
  int32_t* aub;     // [A1, N]
  int32_t* afail;   // [A1] pigeonhole failure per row
};

__device__ __forceinline__ Smem carve(const Tables& p, int32_t* base) {
  const int V = p.V, K1 = p.K + 1, C1 = p.C1, T = p.T;
  Smem s;
  s.store = base;
  s.V = V;
  s.clb = base + 4 * V;
  s.cub = s.clb + p.P1 * K1;
  s.prof = s.cub + p.P1 * K1;
  s.ulb = s.prof + C1 * p.H;
  s.uub = s.ulb + C1 * T;
  s.t_svar = s.uub + C1 * T;
  s.t_dur = s.t_svar + C1 * T;
  s.t_dem = s.t_dur + C1 * T;
  s.t_cap = s.t_dem + C1 * T;
  s.ovl = s.t_cap + C1;
  const int AN = p.n_alldiff > 0 ? p.A1 * p.N : 0;
  s.yl = s.ovl + C1;
  s.yu = s.yl + AN;
  s.alb = s.yu + AN;
  s.aub = s.alb + AN;
  s.afail = s.aub + AN;
  return s;
}

// Stage the cumulative task table in shared memory and clear the
// overload flags; once per CTA, before its first fixpoint.  The caller
// synchronises (fixpoint_lane starts with a barrier).
__device__ __forceinline__ void stage_tables(const Tables& p, const Smem& s) {
  if (p.n_cumulative <= 0) return;
  const int tid = threadIdx.x;
  for (int i = tid; i < p.C1 * p.T; i += THREADS) {
    s.t_svar[i] = p.cu_svar[i];
    s.t_dur[i] = p.cu_dur[i];
    s.t_dem[i] = p.cu_dem[i];
  }
  for (int c = tid; c < p.C1; c += THREADS) {
    s.t_cap[c] = p.cu_cap[c];
    s.ovl[c] = 0;
  }
}

// Is time point tau forbidden for task (c, t)?  The profile without the
// task's own compulsory part, plus its demand, exceeds the capacity.
__device__ __forceinline__ bool bad_at(const int32_t* prof_c, int tau,
                                       int32_t est, int32_t lst, int32_t d,
                                       int32_t q, int32_t cap) {
  int32_t own = (lst <= tau && tau < est + d) ? q : 0;
  return prof_c[tau] - own + q > cap;
}

struct LaneResult {
  int cur;      // buffer (0 or 1) that holds the final store
  int sweeps;
  int conv;     // converged: ¬changed ∨ failed
};

// Run the store in s.lb(0) / s.ub(0) (written by the caller, by
// any thread) to its fixed point, at most `max_sweeps` sweeps.  Every
// thread of the CTA calls it and gets the same result; the overload
// flags are clear again on return.
__device__ LaneResult fixpoint_lane(const Tables& p, const Smem& s,
                                    int max_sweeps) {
  const int V = p.V, P1 = p.P1, K = p.K, K1 = p.K + 1, C1 = p.C1,
            T = p.T, H = p.H, N = p.N, A = p.n_alldiff;
  const bool cumul = p.n_cumulative > 0;
  const bool alldiff = A > 0;
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
    const int32_t* lb = s.lb(cur);
    const int32_t* ub = s.ub(cur);

    // -- (1a) ReifLinLe candidates, one thread per row ---------------------
    for (int r = tid; r < P1; r += nth) {
      const int32_t* a_row = p.coef + (size_t)r * K;
      const int32_t* v_row = p.vidx + (size_t)r * K;
      int32_t smin = 0, smax = 0;
      for (int k = 0; k < K; ++k) {
        int32_t a = __ldg(a_row + k);
        int32_t v = __ldg(v_row + k);
        int32_t xl = lb[v], xu = ub[v];
        smin += a > 0 ? a * xl : a * xu;
        smax += a > 0 ? a * xu : a * xl;
      }
      const int32_t c = __ldg(p.rhs + r);
      const int32_t b = __ldg(p.bidx + r);
      const bool btrue = lb[b] >= 1;
      const bool bfalse = ub[b] <= 0;
      int32_t* cl = s.clb + (size_t)r * K1;
      int32_t* cu = s.cub + (size_t)r * K1;
      for (int k = 0; k < K; ++k) {
        int32_t a = __ldg(a_row + k);
        int32_t v = __ldg(v_row + k);
        int32_t xl = lb[v], xu = ub[v];
        int32_t tl = a > 0 ? a * xl : a * xu;
        int32_t tu = a > 0 ? a * xu : a * xl;
        int32_t ub1 = NEU_UB, lb1 = NEU_LB, ub2 = NEU_UB, lb2 = NEU_LB;
        if (btrue) {                      // Σ a x ≤ c
          int32_t slack1 = c - (smin - tl);
          if (a > 0) ub1 = fdiv(slack1, a);
          else if (a < 0) lb1 = cdiv(slack1, a);
        }
        if (bfalse) {                     // Σ -a x ≤ -c-1
          int32_t slack2 = (-c - 1) - (-smax + tu);
          if (a < 0) ub2 = fdiv(slack2, -a);
          else if (a > 0) lb2 = cdiv(slack2, -a);
        }
        cl[k] = lb1 > lb2 ? lb1 : lb2;
        cu[k] = ub1 < ub2 ? ub1 : ub2;
      }
      cl[K] = smax <= c ? 1 : NEU_LB;     // entailed → b ≥ 1
      cu[K] = smin > c ? 0 : NEU_UB;      // disentailed → b ≤ 0
    }

    // -- (1b) AllDifferent: shifted member bounds, neutral candidates -------
    if (alldiff) {
      for (int i = tid; i < p.A1 * N; i += nth) {
        if (__ldg(p.ad_mask + i)) {
          const int32_t v = __ldg(p.ad_vars + i);
          const int32_t off = __ldg(p.ad_offs + i);
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

    // -- (1c) compulsory-part profile, one thread per (row, time) ----------
    if (cumul) {
      for (int i = tid; i < C1 * H; i += nth) {
        const int c = i / H, tau = i - c * H;
        int32_t acc = 0;
        for (int t = 0; t < T; ++t) {
          const int j = c * T + t;
          const int32_t d = s.t_dur[j], q = s.t_dem[j];
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
    if (alldiff) {
      const int NN = N * N;
      for (int q = tid; q < A * NN; q += nth) {
        const int a = q / NN, i = (q - a * NN) / N, j = q - a * NN - i * N;
        const int32_t* ylr = s.yl + a * N;
        const int32_t* yur = s.yu + a * N;
        const int32_t lo = ylr[i], hi = yur[j];
        if (lo > hi) continue;            // empty interval or padding
        int32_t cnt = 0;
        for (int k = 0; k < N; ++k) {
          const int32_t kl = ylr[k], ku = yur[k];
          cnt += (kl >= lo) & (ku <= hi) & (kl <= ku);
        }
        const int32_t width = hi - lo + 1;
        if (cnt > width) {
          s.afail[a] = 1;                 // benign race: all write 1
        } else if (cnt == width) {        // Hall interval: push the others
          for (int k = 0; k < N; ++k) {
            const int32_t kl = ylr[k], ku = yur[k];
            if (kl >= lo && ku <= hi && kl <= ku) continue;   // inside I
            if (kl >= lo && kl <= hi) atomicMax(s.alb + a * N + k, hi + 1);
            if (ku >= lo && ku <= hi) atomicMin(s.aub + a * N + k, lo - 1);
          }
        }
      }
    }

    // -- (2b) first/last feasible start, one thread per (row, task) --------
    if (cumul) {
      for (int j = tid; j < C1 * T; j += nth) {
        const int c = j / T;
        const int32_t d = s.t_dur[j], q = s.t_dem[j];
        if (!(d > 0 && q > 0)) {
          s.ulb[j] = NEU_LB;
          s.uub[j] = NEU_UB;
          continue;
        }
        const int32_t v = s.t_svar[j];
        const int32_t est = lb[v], lst = ub[v], cap = s.t_cap[c];
        const int32_t* pc = s.prof + (size_t)c * H;
        // first s ≥ max(est, 0) with no bad point in [s, min(s + d, H))
        int32_t first = -NEU_LB;
        {
          int32_t st = est > 0 ? est : 0;
          int32_t tau = st;
          while (st < H) {
            const int32_t e = st + d < H ? st + d : H;
            if (tau >= e) { first = st; break; }
            if (bad_at(pc, tau, est, lst, d, q, cap)) { st = tau + 1; tau = st; }
            else ++tau;
          }
        }
        // last s ≤ min(lst, H - 1) with no bad point in [s, min(s + d, H))
        int32_t last = -NEU_UB;
        {
          const int32_t s_hi = lst < H - 1 ? lst : H - 1;
          if (s_hi >= 0) {
            int32_t nb = 0x7fffffff;        // nearest bad point ≥ s
            const int32_t e_hi = s_hi + d < H ? s_hi + d : H;
            for (int32_t tau = e_hi - 1; tau > s_hi; --tau)
              if (bad_at(pc, tau, est, lst, d, q, cap)) nb = tau;
            for (int32_t st = s_hi; st >= 0; --st) {
              if (bad_at(pc, st, est, lst, d, q, cap)) nb = st;
              const int32_t e = st + d < H ? st + d : H;
              if (nb >= e) { last = st; break; }
            }
          }
        }
        s.ulb[j] = s.ovl[c] ? -NEU_LB : first;   // overload fails the row
        s.uub[j] = last;
      }
    }
    __syncthreads();

    // -- (3) per-variable gather join, box clamp, next store ---------------
    int32_t* nlb_s = s.lb(cur ^ 1);
    int32_t* nub_s = s.ub(cur ^ 1);
    int my_changed = 0;
    my_failed = 0;
    for (int v = tid; v < V; v += nth) {
      int32_t glb = NEU_LB, gub = NEU_UB;
      const int32_t* op = p.occ_prop + (size_t)v * p.D;
      const int32_t* os = p.occ_slot + (size_t)v * p.D;
      for (int d = 0; d < p.D; ++d) {
        const int idx = __ldg(op + d) * K1 + __ldg(os + d);
        glb = max(glb, s.clb[idx]);
        gub = min(gub, s.cub[idx]);
      }
      if (alldiff) {
        const int32_t* oi = p.ad_occ_inst + (size_t)v * p.Dad;
        const int32_t* opos = p.ad_occ_pos + (size_t)v * p.Dad;
        for (int d = 0; d < p.Dad; ++d) {
          const int a = __ldg(oi + d);
          const int idx = a * N + __ldg(opos + d);
          const int32_t off = __ldg(p.ad_offs + idx);
          glb = max(glb, (s.afail[a] ? -NEU_LB : s.alb[idx]) - off);
          gub = min(gub, s.aub[idx] - off);
        }
      }
      if (cumul) {
        const int32_t* oi = p.cu_occ_inst + (size_t)v * p.Dcu;
        const int32_t* opos = p.cu_occ_pos + (size_t)v * p.Dcu;
        for (int d = 0; d < p.Dcu; ++d) {
          const int idx = __ldg(oi + d) * T + __ldg(opos + d);
          glb = max(glb, s.ulb[idx]);
          gub = min(gub, s.uub[idx]);
        }
      }
      gub = max(gub, __ldg(p.box_lo + v));
      glb = min(glb, __ldg(p.box_hi + v));
      const int32_t l = max(lb[v], glb);
      const int32_t u = min(ub[v], gub);
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
