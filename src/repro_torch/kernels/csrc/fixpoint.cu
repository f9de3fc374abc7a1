// Per-lane propagation fixpoint for Hopper (sm_90a), one CTA per lane.
//
// Replaces the Pallas TPU kernel `fixpoint_pallas` /
// `_fixpoint_kernel` of src/repro/kernels/fixpoint_kernel.py for every
// bank: ReifLinLe, AllDifferent and Cumulative in both layouts, dense and
// sparse, and Compact-Table, with or without a carried [V, W] bitset
// store; one instance per (layout pair, bitset code), picked at launch.
// The per-lane body is `fixlane::fixpoint_lane` (fixpoint_lane.cuh),
// shared with the resident search kernel (search.cu); this file only
// loads lane `blockIdx.x` into shared memory, runs it and writes the
// result back.  The plain PyTorch version is
// repro_torch/core/fixpoint.py::fixpoint_batch; results (stores, domain
// words, per-lane sweep counts, convergence flags) are equal bit for
// bit, capped or not.
//
// Two instances of every kernel, by the CTA's thread count (the caller
// picks one per launch, kernels/fixpoint_kernel.py::instance_threads):
// the many-lane instance, 256 threads, for launches over more lanes than
// the card has SMs (the `cuda` backend's supersteps over 1024 lanes),
// built for throughput; and the few-lane instance, 1024 threads and one
// CTA per SM, for EPS's root and its batches of splits, built for one lane's
// latency: 32 warps hide shared-memory latency, and every phase maps its
// work to more threads (fixpoint_lane.cuh has the mapping).
//
// Bound: the work per sweep is integer ALU and shared-memory traffic,
// not device-memory bytes: the stores and tables are read once per
// launch, so int32 operations bound it.  A CTA still runs its lane's
// sweeps one after the other, each a chain of barrier-separated phases,
// so a launch over 1 or 2 lanes stays far above that bound (PERF.md has
// the times): its cost is the latency of the longest per-thread chain of
// each phase and of the barriers between them.  The dense Cumulative
// profile is a difference array and a prefix sum (C1·(T+H) work); the
// sparse banks sort (bitonic, the in-warp steps in registers) and scan
// their own segment of events; the AllDifferent bank's dense layout
// tests A·N² endpoint pairs against per-member bitmasks (AND and popc);
// the Compact-Table models OR each member's supports from L2 and test
// every value's support against the current table (bitwise operations).
// An int64 model runs the same code at 64 bits (the library built with
// -DFIXLANE_VAL=int64_t): the stores, candidates and value tables double
// in width, and the sparse banks sort 128-bit keys.
// The kernel allocates nothing and launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fixpoint_lane.cuh"

namespace {

using fixlane::FEW_THREADS;
using fixlane::THREADS;
using Val = FIXLANE_VAL;

struct Params {
  fixlane::Tables<Val> t;
  const Val* lb_in;           // [L, V]
  const Val* ub_in;           // [L, V]
  Val* lb_out;                // [L, V]
  Val* ub_out;                // [L, V]
  int32_t* sweeps;            // [L]
  int32_t* conv;              // [L]
  const uint32_t* dom_in;     // [L, V, W] when p.t.carry_dom
  uint32_t* dom_out;          // [L, V, W] when p.t.carry_dom
  int max_sweeps;
  fixlane::Smem<Val> layout;  // the instance's regions, carved at
                              // fixlane::LAYOUT_BASE by the launch (read
                              // by the many-lane instances)
};

// One CTA of NT threads per lane.
template <int NT, bool AD_SPARSE, bool CU_SPARSE, bool DOM>
__device__ __forceinline__ void fixpoint_body(const Params& p) {
  extern __shared__ __align__(16) unsigned char smem[];
  // the many-lane instances take the layout the launch carved (fewer
  // registers through the sweep loop, no spills); the few-lane ones carve
  // their own, as with a passed layout one of them spills
  const fixlane::Smem<Val> s =
      NT == THREADS
          ? fixlane::rebase(p.layout, smem)
          : fixlane::carve<Val, AD_SPARSE, CU_SPARSE, DOM>(p.t, smem);
  const int V = p.t.V;
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t row = (size_t)lane * V;
  const bool carry = DOM && p.t.carry_dom;
  const int VW = V * p.t.W;

  for (int v = tid; v < V; v += NT) {
    s.lb(0)[v] = p.lb_in[row + v];
    s.ub(0)[v] = p.ub_in[row + v];
  }
  if (carry)
    for (int i = tid; i < VW; i += NT)
      s.dom(0)[i] = p.dom_in[(size_t)lane * VW + i];
  fixlane::stage_tables<NT, Val, CU_SPARSE>(p.t, s);
  const fixlane::LaneResult r =
      fixlane::fixpoint_lane<NT, Val, AD_SPARSE, CU_SPARSE, DOM>(
          p.t, s, p.max_sweeps);

  for (int v = tid; v < V; v += NT) {
    p.lb_out[row + v] = s.lb(r.cur)[v];
    p.ub_out[row + v] = s.ub(r.cur)[v];
  }
  if (carry)
    for (int i = tid; i < VW; i += NT)
      p.dom_out[(size_t)lane * VW + i] = s.dom(r.cur)[i];
  if (tid == 0) {
    p.sweeps[lane] = r.sweeps;
    p.conv[lane] = r.conv;
  }
}

// Co-resident CTAs per SM each many-lane instance is built for (its
// minimum-blocks launch bound: ptxas keeps it within 65536 / (THREADS ·
// n) registers): the CTAs per SM ptxas gave each instance before the
// bound existed, so that no change to the shared body loses an instance
// a CTA per SM.  PERF.md §6 lists each instance's registers.
template <bool AD_SPARSE, bool CU_SPARSE, bool DOM>
constexpr int min_ctas() {
  if constexpr (DOM && !AD_SPARSE) return 2;
  if constexpr (sizeof(Val) == 8) return AD_SPARSE && CU_SPARSE && !DOM ? 3 : 4;
  if constexpr (AD_SPARSE && !CU_SPARSE && !DOM) return 6;
  if constexpr ((!AD_SPARSE && CU_SPARSE) || (AD_SPARSE && CU_SPARSE && DOM))
    return 4;
  return 5;
}

// The many-lane instance: a 256-thread CTA with the registers of
// min_ctas() CTAs per SM.
template <bool AD_SPARSE, bool CU_SPARSE, bool DOM>
__global__ void __launch_bounds__(THREADS,
                                  min_ctas<AD_SPARSE, CU_SPARSE, DOM>())
    fixpoint_kernel(Params p) {
  fixpoint_body<THREADS, AD_SPARSE, CU_SPARSE, DOM>(p);
}

// The few-lane instance: one 1024-thread CTA per SM, so ptxas may use
// all of the 64 registers a thread that leaves (without the minimum of
// one block it aims at two CTAs per SM, 32 registers, and spills).
template <bool AD_SPARSE, bool CU_SPARSE, bool DOM>
__global__ void __launch_bounds__(FEW_THREADS, 1)
    fixpoint_few_kernel(Params p) {
  fixpoint_body<FEW_THREADS, AD_SPARSE, CU_SPARSE, DOM>(p);
}

template <int NT, bool AD_SPARSE, bool CU_SPARSE, bool DOM>
auto kernel_of() {
  if constexpr (NT == FEW_THREADS)
    return fixpoint_few_kernel<AD_SPARSE, CU_SPARSE, DOM>;
  else
    return fixpoint_kernel<AD_SPARSE, CU_SPARSE, DOM>;
}

template <int NT, bool AD_SPARSE, bool CU_SPARSE, bool DOM>
int launch(const Params& p, int L, size_t smem, cudaStream_t stream) {
  const auto kernel = kernel_of<NT, AD_SPARSE, CU_SPARSE, DOM>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  Params q = p;
  q.layout = fixlane::carve<Val, AD_SPARSE, CU_SPARSE, DOM>(
      p.t, fixlane::layout_base());
  kernel<<<L, NT, smem, stream>>>(q);
  return (int)cudaGetLastError();
}

// The instance of the model's layouts and bitset code.
template <int NT, bool DOM>
int launch_dom(const Params& p, int L, size_t smem, cudaStream_t st) {
  if (p.t.ad_sparse)
    return p.t.cu_sparse ? launch<NT, true, true, DOM>(p, L, smem, st)
                         : launch<NT, true, false, DOM>(p, L, smem, st);
  return p.t.cu_sparse ? launch<NT, false, true, DOM>(p, L, smem, st)
                       : launch<NT, false, false, DOM>(p, L, smem, st);
}

template <int NT>
int launch_nt(const Params& p, int L, size_t smem, cudaStream_t st) {
  return fixlane::uses_dom(p.t) ? launch_dom<NT, true>(p, L, smem, st)
                                : launch_dom<NT, false>(p, L, smem, st);
}

// Co-resident CTAs per SM of one instance at `smem` bytes of dynamic
// shared memory, or a negative cudaError_t.
template <int NT, bool AD_SPARSE, bool CU_SPARSE, bool DOM>
int occupancy(int smem) {
  const auto kernel = kernel_of<NT, AD_SPARSE, CU_SPARSE, DOM>();
  int per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                        smem);
  return err == cudaSuccess ? per_sm : -(int)err;
}

template <int NT, bool DOM>
int occupancy_dom(int ad_sparse, int cu_sparse, int smem) {
  if (ad_sparse)
    return cu_sparse ? occupancy<NT, true, true, DOM>(smem)
                     : occupancy<NT, true, false, DOM>(smem);
  return cu_sparse ? occupancy<NT, false, true, DOM>(smem)
                   : occupancy<NT, false, false, DOM>(smem);
}

}  // namespace

extern "C" {

// Co-resident CTAs per SM of the instance (threads, ad_sparse, cu_sparse,
// dom) at `smem` bytes of dynamic shared memory, or a negative
// cudaError_t (cudaErrorInvalidValue for another thread count).
int fixpoint_occupancy(int threads, int ad_sparse, int cu_sparse, int dom,
                       int smem) {
  if (threads == THREADS)
    return dom ? occupancy_dom<THREADS, true>(ad_sparse, cu_sparse, smem)
               : occupancy_dom<THREADS, false>(ad_sparse, cu_sparse, smem);
  if (threads == FEW_THREADS)
    return dom ? occupancy_dom<FEW_THREADS, true>(ad_sparse, cu_sparse, smem)
               : occupancy_dom<FEW_THREADS, false>(ad_sparse, cu_sparse,
                                                   smem);
  return -(int)cudaErrorInvalidValue;
}

// Launch on `stream` at `threads` per CTA (THREADS, the many-lane
// instance, or FEW_THREADS, the few-lane one; the caller picks:
// kernels/fixpoint_kernel.py::instance_threads); returns the cudaError_t
// of the launch (0 = success, cudaErrorInvalidValue for another count).
// `tables`: the fixlane::N_TABLES tables and `dims`: the fixlane::N_DIMS
// sizes, both in fixlane::Tables order; `dom_in`/`dom_out`: the [L, V, W]
// bitset store in and out, or both null when none is carried.  The
// stores and the value tables are of the library's width (Val).
int fixpoint_launch(const void* const* tables, const int* dims,
                    const Val* lb_in, const Val* ub_in,
                    Val* lb_out, Val* ub_out, int32_t* sweeps,
                    int32_t* conv, const uint32_t* dom_in,
                    uint32_t* dom_out, int L, int max_sweeps, int threads,
                    void* stream) {
  Params p{fixlane::tables_from<Val>(tables, dims, dom_in != nullptr),
           lb_in, ub_in, lb_out, ub_out, sweeps, conv, dom_in, dom_out,
           max_sweeps, {}};
  // shared-memory bytes of one CTA (kernels/fixpoint_kernel.py::
  // smem_budget uses the same formula)
  const size_t smem = fixlane::smem_bytes(p.t);
  cudaStream_t st = (cudaStream_t)stream;
  if (threads == THREADS) return launch_nt<THREADS>(p, L, smem, st);
  if (threads == FEW_THREADS) return launch_nt<FEW_THREADS>(p, L, smem, st);
  return (int)cudaErrorInvalidValue;
}

#ifdef FIXLANE_CLOCKS
// The `clocks` library only: copy the per-phase clock sums and the
// lane-sweep count (fixlane::Phase order, N_PHASES + 1 values) to host
// memory `out` and clear them.  Synchronises the device first.
int fixpoint_clocks(unsigned long long* out) {
  const size_t n = sizeof(unsigned long long) * (fixlane::N_PHASES + 1);
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out, fixlane::clocks, n);
  static const unsigned long long zeros[fixlane::N_PHASES + 1] = {};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(fixlane::clocks, zeros, n);
  return (int)err;
}
#endif

const char* fixpoint_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
