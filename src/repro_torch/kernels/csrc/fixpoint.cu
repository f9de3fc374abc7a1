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
// Bound: at the RCPSP J60 shape the work per sweep is integer ALU and
// shared-memory traffic, not device-memory bytes: the stores and tables
// are read once per launch, so int32 operations bound it.  This kernel
// builds the profile with C1·H·T compares where a difference array and a
// prefix sum need C1·(T+H); a CTA runs its lane's sweeps one after the
// other, each a chain of dependent shared-memory and L2 loads with at
// most a few hundred threads busy.  So it runs well above that bound
// (PERF.md has the times); nothing in this design addresses that yet.
// At the N-queens-32 shape the AllDifferent bank dominates a sweep: A·N²
// endpoint pairs, each a loop over the row's N members, from shared
// memory; int32 operations bound it too.  At the J120 and N-queens-256
// shapes (sparse banks) a sweep adds a bitonic sort of 1024 keys (55
// barrier steps) and O(n²) scans per row, all in shared memory: int32
// operations again.  On the Compact-Table models (crossword,
// configuration) a sweep ORs the supports of each member's live values
// and tests every value's support against the current table, from the
// support table in L2: int32 (bitwise) operations.
// An int64 model runs the same code at 64 bits (the library built with
// -DFIXLANE_VAL=int64_t): the stores, candidates and value tables double
// in width, and the sparse banks sort 128-bit keys.
// The kernel allocates nothing and launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fixpoint_lane.cuh"

namespace {

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
};

template <bool AD_SPARSE, bool CU_SPARSE, bool DOM>
__global__ void __launch_bounds__(THREADS) fixpoint_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const fixlane::Smem<Val> s =
      fixlane::carve<Val, AD_SPARSE, CU_SPARSE, DOM>(p.t, smem);
  const int V = p.t.V;
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t row = (size_t)lane * V;
  const bool carry = DOM && p.t.carry_dom;
  const int VW = V * p.t.W;

  for (int v = tid; v < V; v += THREADS) {
    s.lb(0)[v] = p.lb_in[row + v];
    s.ub(0)[v] = p.ub_in[row + v];
  }
  if (carry)
    for (int i = tid; i < VW; i += THREADS)
      s.dom(0)[i] = p.dom_in[(size_t)lane * VW + i];
  fixlane::stage_tables<Val, CU_SPARSE>(p.t, s);
  const fixlane::LaneResult r =
      fixlane::fixpoint_lane<Val, AD_SPARSE, CU_SPARSE, DOM>(p.t, s,
                                                            p.max_sweeps);

  for (int v = tid; v < V; v += THREADS) {
    p.lb_out[row + v] = s.lb(r.cur)[v];
    p.ub_out[row + v] = s.ub(r.cur)[v];
  }
  if (carry)
    for (int i = tid; i < VW; i += THREADS)
      p.dom_out[(size_t)lane * VW + i] = s.dom(r.cur)[i];
  if (tid == 0) {
    p.sweeps[lane] = r.sweeps;
    p.conv[lane] = r.conv;
  }
}

template <bool AD_SPARSE, bool CU_SPARSE, bool DOM>
int launch(const Params& p, int L, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fixpoint_kernel<AD_SPARSE, CU_SPARSE, DOM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fixpoint_kernel<AD_SPARSE, CU_SPARSE, DOM>
      <<<L, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The instance of the model's layouts and bitset code.
template <bool DOM>
int launch_dom(const Params& p, int L, size_t smem, cudaStream_t st) {
  if (p.t.ad_sparse)
    return p.t.cu_sparse ? launch<true, true, DOM>(p, L, smem, st)
                         : launch<true, false, DOM>(p, L, smem, st);
  return p.t.cu_sparse ? launch<false, true, DOM>(p, L, smem, st)
                       : launch<false, false, DOM>(p, L, smem, st);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// `tables`: the fixlane::N_TABLES tables and `dims`: the fixlane::N_DIMS
// sizes, both in fixlane::Tables order; `dom_in`/`dom_out`: the [L, V, W]
// bitset store in and out, or both null when none is carried.  The
// stores and the value tables are of the library's width (Val).
int fixpoint_launch(const void* const* tables, const int* dims,
                    const Val* lb_in, const Val* ub_in,
                    Val* lb_out, Val* ub_out, int32_t* sweeps,
                    int32_t* conv, const uint32_t* dom_in,
                    uint32_t* dom_out, int L, int max_sweeps,
                    void* stream) {
  Params p{fixlane::tables_from<Val>(tables, dims, dom_in != nullptr),
           lb_in, ub_in, lb_out, ub_out, sweeps, conv, dom_in, dom_out,
           max_sweeps};
  // shared-memory bytes of one CTA (kernels/fixpoint_kernel.py::
  // smem_budget uses the same formula)
  const size_t smem = fixlane::smem_bytes(p.t);
  cudaStream_t st = (cudaStream_t)stream;
  return fixlane::uses_dom(p.t) ? launch_dom<true>(p, L, smem, st)
                                : launch_dom<false>(p, L, smem, st);
}

const char* fixpoint_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
