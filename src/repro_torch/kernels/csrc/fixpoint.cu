// Per-lane propagation fixpoint for Hopper (sm_90a), one CTA per lane.
//
// Replaces the Pallas TPU kernel `fixpoint_pallas` /
// `_fixpoint_kernel` of src/repro/kernels/fixpoint_kernel.py for the banks
// RCPSP lowers to: the ReifLinLe bank (`fixpoint.candidates_tile`) and the
// dense Cumulative bank (`fixpoint.cumulative_candidates_tile`).  The
// plain PyTorch version is repro_torch/core/fixpoint.py::fixpoint_batch;
// results (stores, per-lane sweep counts, convergence flags) are equal bit
// for bit, capped or not.
//
// Design (TURBO's block-per-subproblem mapping):
//   * one CTA owns one lane; its current and next lb/ub live in shared
//     memory, double-buffered, so every sweep reads only the old store
//     (Jacobi, as the reference: capped stores and sweep counts match);
//   * per sweep: (1) threads over linear rows write the [P1, K+1]
//     candidates, threads over (row, time) build the compulsory-part
//     profile [C1, H]; (2) threads over (row, task) find the first and
//     last feasible start; (3) threads over variables min/max-reduce
//     their occurrence lists, clamp to the box and write the next store;
//   * `__syncthreads_or` ends the loop on the per-lane rule
//     changed ∧ it < max_sweeps ∧ ¬failed.
// The tables stay read-only in global memory (they sit in L2); only the
// cumulative task table is staged in shared memory.
//
// Bound: at the RCPSP J60 shape the work per sweep is integer ALU and
// shared-memory traffic, not device-memory bytes: the stores and tables
// are read once per launch, so int32 operations bound it.  This kernel
// builds the profile with C1·H·T compares where a difference array and a
// prefix sum need C1·(T+H); a CTA runs its lane's sweeps one after the
// other, each a chain of dependent shared-memory and L2 loads with at
// most a few hundred threads busy.  So it runs well above that bound
// (PERF.md has the times); nothing in this design addresses that yet.
// The kernel allocates nothing and launches on the caller's stream.
//
// Arithmetic: int32 only (the wrapper rejects int64 models).  Floor and
// ceil division follow `_fdiv`/`_cdiv` (C++ `/` truncates toward zero).
// The compile-time headroom (compile.py) keeps every intermediate the
// reference computes in range; the kernel computes no others.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;              // threads per CTA (one lane)
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

struct Params {
  const int32_t* vidx;        // [P1, K]
  const int32_t* coef;        // [P1, K]
  const int32_t* rhs;         // [P1]
  const int32_t* bidx;        // [P1]
  const int32_t* occ_prop;    // [V, D]
  const int32_t* occ_slot;    // [V, D]
  const int32_t* cu_svar;     // [C1, T]
  const int32_t* cu_dur;      // [C1, T]
  const int32_t* cu_dem;      // [C1, T]
  const int32_t* cu_cap;      // [C1]
  const int32_t* cu_occ_inst; // [V, Dcu]
  const int32_t* cu_occ_pos;  // [V, Dcu]
  const int32_t* box_lo;      // [V]
  const int32_t* box_hi;      // [V]
  const int32_t* lb_in;       // [L, V]
  const int32_t* ub_in;       // [L, V]
  int32_t* lb_out;            // [L, V]
  int32_t* ub_out;            // [L, V]
  int32_t* sweeps;            // [L]
  int32_t* conv;              // [L]
  int V, P1, K, D, C1, T, Dcu, H, n_cumulative, max_sweeps;
};

// Is time point tau forbidden for task (c, t)?  The profile without the
// task's own compulsory part, plus its demand, exceeds the capacity.
__device__ __forceinline__ bool bad_at(const int32_t* prof_c, int tau,
                                       int32_t est, int32_t lst, int32_t d,
                                       int32_t q, int32_t cap) {
  int32_t own = (lst <= tau && tau < est + d) ? q : 0;
  return prof_c[tau] - own + q > cap;
}

__global__ void __launch_bounds__(THREADS) fixpoint_kernel(Params p) {
  extern __shared__ int32_t smem[];
  const int V = p.V, P1 = p.P1, K = p.K, K1 = p.K + 1, C1 = p.C1,
            T = p.T, H = p.H;
  const bool cumul = p.n_cumulative > 0;
  int32_t* buf_lb[2];
  int32_t* buf_ub[2];
  buf_lb[0] = smem;
  buf_ub[0] = buf_lb[0] + V;
  buf_lb[1] = buf_ub[0] + V;
  buf_ub[1] = buf_lb[1] + V;
  int32_t* clb = buf_ub[1] + V;          // [P1, K1]
  int32_t* cub = clb + P1 * K1;          // [P1, K1]
  int32_t* prof = cub + P1 * K1;         // [C1, H]
  int32_t* ulb = prof + C1 * H;          // [C1, T]
  int32_t* uub = ulb + C1 * T;           // [C1, T]
  int32_t* t_svar = uub + C1 * T;        // [C1, T]
  int32_t* t_dur = t_svar + C1 * T;      // [C1, T]
  int32_t* t_dem = t_dur + C1 * T;       // [C1, T]
  int32_t* t_cap = t_dem + C1 * T;       // [C1]
  int32_t* ovl = t_cap + C1;             // [C1]

  const int lane = blockIdx.x;
  const int tid = threadIdx.x, nth = THREADS;
  const size_t row = (size_t)lane * V;

  int my_failed = 0;
  for (int v = tid; v < V; v += nth) {
    int32_t l = p.lb_in[row + v], u = p.ub_in[row + v];
    buf_lb[0][v] = l;
    buf_ub[0][v] = u;
    my_failed |= (l > u);
  }
  if (cumul) {
    for (int i = tid; i < C1 * T; i += nth) {
      t_svar[i] = p.cu_svar[i];
      t_dur[i] = p.cu_dur[i];
      t_dem[i] = p.cu_dem[i];
    }
    for (int c = tid; c < C1; c += nth) {
      t_cap[c] = p.cu_cap[c];
      ovl[c] = 0;
    }
  }
  int failed = __syncthreads_or(my_failed);
  int changed = 1;
  int it = 0;
  int cur = 0;

  while (changed && it < p.max_sweeps && !failed) {
    const int32_t* lb = buf_lb[cur];
    const int32_t* ub = buf_ub[cur];

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
      int32_t* cl = clb + (size_t)r * K1;
      int32_t* cu = cub + (size_t)r * K1;
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

    // -- (1b) compulsory-part profile, one thread per (row, time) ----------
    if (cumul) {
      for (int i = tid; i < C1 * H; i += nth) {
        const int c = i / H, tau = i - c * H;
        int32_t s = 0;
        for (int t = 0; t < T; ++t) {
          const int j = c * T + t;
          const int32_t d = t_dur[j], q = t_dem[j];
          if (d > 0 && q > 0) {
            const int32_t v = t_svar[j];
            if (ub[v] <= tau && tau < lb[v] + d) s += q;
          }
        }
        prof[i] = s;
        if (s > t_cap[c]) ovl[c] = 1;     // benign race: all write 1
      }
    }
    __syncthreads();

    // -- (2) first/last feasible start, one thread per (row, task) ---------
    if (cumul) {
      for (int j = tid; j < C1 * T; j += nth) {
        const int c = j / T;
        const int32_t d = t_dur[j], q = t_dem[j];
        if (!(d > 0 && q > 0)) {
          ulb[j] = NEU_LB;
          uub[j] = NEU_UB;
          continue;
        }
        const int32_t v = t_svar[j];
        const int32_t est = lb[v], lst = ub[v], cap = t_cap[c];
        const int32_t* pc = prof + (size_t)c * H;
        // first s ≥ max(est, 0) with no bad point in [s, min(s + d, H))
        int32_t first = -NEU_LB;
        {
          int32_t s = est > 0 ? est : 0;
          int32_t tau = s;
          while (s < H) {
            const int32_t e = s + d < H ? s + d : H;
            if (tau >= e) { first = s; break; }
            if (bad_at(pc, tau, est, lst, d, q, cap)) { s = tau + 1; tau = s; }
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
            for (int32_t s = s_hi; s >= 0; --s) {
              if (bad_at(pc, s, est, lst, d, q, cap)) nb = s;
              const int32_t e = s + d < H ? s + d : H;
              if (nb >= e) { last = s; break; }
            }
          }
        }
        ulb[j] = ovl[c] ? -NEU_LB : first;   // overload fails the row
        uub[j] = last;
      }
    }
    __syncthreads();

    // -- (3) per-variable gather join, box clamp, next store ---------------
    int32_t* nlb_s = buf_lb[cur ^ 1];
    int32_t* nub_s = buf_ub[cur ^ 1];
    int my_changed = 0;
    my_failed = 0;
    for (int v = tid; v < V; v += nth) {
      int32_t glb = NEU_LB, gub = NEU_UB;
      const int32_t* op = p.occ_prop + (size_t)v * p.D;
      const int32_t* os = p.occ_slot + (size_t)v * p.D;
      for (int d = 0; d < p.D; ++d) {
        const int idx = __ldg(op + d) * K1 + __ldg(os + d);
        glb = max(glb, clb[idx]);
        gub = min(gub, cub[idx]);
      }
      if (cumul) {
        const int32_t* oi = p.cu_occ_inst + (size_t)v * p.Dcu;
        const int32_t* opos = p.cu_occ_pos + (size_t)v * p.Dcu;
        for (int d = 0; d < p.Dcu; ++d) {
          const int idx = __ldg(oi + d) * T + __ldg(opos + d);
          glb = max(glb, ulb[idx]);
          gub = min(gub, uub[idx]);
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
      for (int c = tid; c < C1; c += nth) ovl[c] = 0;   // for the next sweep
    changed = __syncthreads_or(my_changed);
    failed = __syncthreads_or(my_failed);
    cur ^= 1;
    ++it;
  }

  for (int v = tid; v < V; v += nth) {
    p.lb_out[row + v] = buf_lb[cur][v];
    p.ub_out[row + v] = buf_ub[cur][v];
  }
  if (tid == 0) {
    p.sweeps[lane] = it;
    p.conv[lane] = (!changed) || failed;
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes one CTA needs (the wrapper's budget uses the same
// formula, kernels/fixpoint_kernel.py::smem_budget).
size_t fixpoint_smem_bytes(int V, int P1, int K, int C1, int T, int H) {
  return sizeof(int32_t) * ((size_t)4 * V + (size_t)2 * P1 * (K + 1) +
                            (size_t)C1 * H + (size_t)5 * C1 * T +
                            (size_t)2 * C1);
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
int fixpoint_launch(const int32_t* vidx, const int32_t* coef,
                    const int32_t* rhs, const int32_t* bidx,
                    const int32_t* occ_prop, const int32_t* occ_slot,
                    const int32_t* cu_svar, const int32_t* cu_dur,
                    const int32_t* cu_dem, const int32_t* cu_cap,
                    const int32_t* cu_occ_inst, const int32_t* cu_occ_pos,
                    const int32_t* box_lo, const int32_t* box_hi,
                    const int32_t* lb_in, const int32_t* ub_in,
                    int32_t* lb_out, int32_t* ub_out, int32_t* sweeps,
                    int32_t* conv, int L, int V, int P1, int K, int D,
                    int C1, int T, int Dcu, int H, int n_cumulative,
                    int max_sweeps, void* stream) {
  Params p{vidx, coef, rhs, bidx, occ_prop, occ_slot, cu_svar, cu_dur,
           cu_dem, cu_cap, cu_occ_inst, cu_occ_pos, box_lo, box_hi,
           lb_in, ub_in, lb_out, ub_out, sweeps, conv,
           V, P1, K, D, C1, T, Dcu, H, n_cumulative, max_sweeps};
  const size_t smem = fixpoint_smem_bytes(V, P1, K, C1, T, H);
  cudaError_t err = cudaFuncSetAttribute(
      fixpoint_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fixpoint_kernel<<<L, THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

const char* fixpoint_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
