// Per-lane propagation fixpoint for Hopper (sm_90a), one CTA per lane.
//
// Replaces the Pallas TPU kernel `fixpoint_pallas` /
// `_fixpoint_kernel` of src/repro/kernels/fixpoint_kernel.py for the banks
// RCPSP lowers to: the ReifLinLe bank and the dense Cumulative bank.  The
// per-lane body is `fixlane::fixpoint_lane` (fixpoint_lane.cuh), shared
// with the resident search kernel (search.cu); this file only loads lane
// `blockIdx.x` into shared memory, runs it and writes the result back.
// The plain PyTorch version is repro_torch/core/fixpoint.py::
// fixpoint_batch; results (stores, per-lane sweep counts, convergence
// flags) are equal bit for bit, capped or not.
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

#include <cuda_runtime.h>
#include <stdint.h>

#include "fixpoint_lane.cuh"

namespace {

using fixlane::THREADS;

struct Params {
  fixlane::Tables t;
  const int32_t* lb_in;       // [L, V]
  const int32_t* ub_in;       // [L, V]
  int32_t* lb_out;            // [L, V]
  int32_t* ub_out;            // [L, V]
  int32_t* sweeps;            // [L]
  int32_t* conv;              // [L]
  int max_sweeps;
};

__global__ void __launch_bounds__(THREADS) fixpoint_kernel(Params p) {
  extern __shared__ int32_t smem[];
  const fixlane::Smem s = fixlane::carve(p.t, smem);
  const int V = p.t.V;
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t row = (size_t)lane * V;

  for (int v = tid; v < V; v += THREADS) {
    s.lb(0)[v] = p.lb_in[row + v];
    s.ub(0)[v] = p.ub_in[row + v];
  }
  fixlane::stage_tables(p.t, s);
  const fixlane::LaneResult r = fixlane::fixpoint_lane(p.t, s, p.max_sweeps);

  for (int v = tid; v < V; v += THREADS) {
    p.lb_out[row + v] = s.lb(r.cur)[v];
    p.ub_out[row + v] = s.ub(r.cur)[v];
  }
  if (tid == 0) {
    p.sweeps[lane] = r.sweeps;
    p.conv[lane] = r.conv;
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes one CTA needs (the wrapper's budget uses the same
// formula, kernels/fixpoint_kernel.py::smem_budget).
size_t fixpoint_smem_bytes(int V, int P1, int K, int C1, int T, int H) {
  return sizeof(int32_t) * fixlane::smem_words(V, P1, K, C1, T, H);
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
  Params p{{vidx, coef, rhs, bidx, occ_prop, occ_slot, cu_svar, cu_dur,
            cu_dem, cu_cap, cu_occ_inst, cu_occ_pos, box_lo, box_hi,
            V, P1, K, D, C1, T, Dcu, H, n_cumulative},
           lb_in, ub_in, lb_out, ub_out, sweeps, conv, max_sweeps};
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
