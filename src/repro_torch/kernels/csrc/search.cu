// Resident search kernel for Hopper (sm_90a): K whole supersteps of the
// lane-batched search per launch.
//
// Replaces the Pallas TPU kernel `search_pallas` / `_search_kernel` of
// src/repro/kernels/fixpoint_kernel.py in its `lane_tile=0` mode (every
// lane in one shared pool queue, the mode whose trajectory equals the
// unfused loop).  The plain PyTorch version is
// repro_torch/kernels/fixpoint_kernel.py::search_plain: K guarded
// `search.lanes_step` supersteps.  Every LaneState field, the bound, the
// superstep count, the pool cursor and the stop flag are equal bit for
// bit.
//
// One superstep, as `lanes_step`: dispatch_pool → lane_load_tile (load +
// branch & bound tell with the previous superstep's bound) → the lane's
// fixpoint → lane_commit_tile (record, backtrack by recomputation from
// the root, branch); then gbest = min(gbest, min best_obj).
//
// The bitset store (`LaneState.dom`/`root_dom`, [L, V, W] u32, carried
// for table models and under `middle_out`): the working words live in the
// fixpoint's shared-memory buffers (fixpoint_lane.cuh), `root_dom` in
// device memory.  A loaded lane's root words are its subproblem's range
// words (all-ones for an untracked variable).  Backtracking recomputes
// the words from `root_dom`: the one-hot masks of the flipped
// `middle_out` decisions on tracked variables are summed (shared-memory
// atomicAdd, as the reference's uint32 scatter-add; the masks of a
// well-formed path are disjoint, so the sum is their OR) and cleared.
// `middle_out` branches x = m / x ≠ m on the live value nearest the
// floor midpoint, ties to the lower value; on an untracked variable it
// takes the midpoint and tells x ≤ m / x ≥ m+1, as `split`.  A superstep
// that starts with the global done flag set (every lane done, or any
// solution under stop_on_first) is the identity.
//
// Design: a cooperative persistent grid.  The superstep has three
// cross-lane dependencies (dispatch ranks are an exclusive prefix sum of
// the wanting lanes in lane order; the load reads the previous bound; the
// done flag is over all lanes), so the launch is cooperative
// (cudaLaunchCooperativeKernel) and the grid, min(L, co-resident CTAs),
// meets at two grid.sync() per superstep:
//   1. each CTA writes the `want` flags of its lanes l = blockIdx.x +
//      k·gridDim.x; grid.sync();
//   2. every CTA scans all L flags itself (a block scan; L is a few
//      thousand at most), so each knows its lanes' ranks and the new pool
//      head without a second barrier; then it runs its lanes one after the
//      other: load, `fixlane::fixpoint_lane` (fixpoint_lane.cuh, the body
//      of fixpoint.cu) and commit, with the store in shared memory;
//      it folds its lanes' best objective into a global cell with
//      atomicMin and their done/solution flags into per-parity cells;
//      grid.sync(); every CTA reads the new bound and done flag.
// The LaneState stays in device memory (the decision paths are [L, MD]);
// only the lane's current store, the fixpoint scratch and a few scalars
// live in shared memory.  Cross-CTA values are read with __ldcg (L2), and
// each parity's flag cells are cleared one superstep ahead of their use.
//
// Parity hazards, each held to the reference: every lane is propagated
// every live superstep (done and fresh lanes too, their sweeps counted);
// branch selection breaks ties by the lowest position in branch_vars;
// `split` floors; backtracking flips the deepest open level, clears every
// deeper flip flag and recomputes the store from the root over the
// decisions up to it; depth overflow marks the lane fresh and incomplete.
// The reference's neutral tells (±iinfo.max // 4 at levels past the
// path) are left out: int32 models keep every bound inside that range
// (compile.py headroom), so they change nothing.
//
// Bound: per superstep the work is the lanes' fixpoint sweeps (int32 ALU
// and shared-memory traffic, as fixpoint.cu) plus a commit of O(V + B +
// depth) per lane; the LaneState is read and written once per launch.
// So int32 operations bound it, and a CTA that owns several lanes runs
// them in sequence.  On N-queens 32 the AllDifferent bank's endpoint
// pairs take most of each sweep; on J120 and N-queens 256 the sparse
// banks' sorts and scans.  The kernel is instantiated per layout pair of
// the AllDifferent and Cumulative banks (dense or sparse), picked at
// launch.  PERF.md has the times.  The kernel allocates nothing and
// launches on the caller's stream.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fixpoint_lane.cuh"

namespace cg = cooperative_groups;

namespace {

using fixlane::BIG;
using fixlane::block_exclusive_scan;
using fixlane::THREADS;

constexpr int32_t UNASSIGNED = 0x7fffffff / 2;   // search.UNASSIGNED

// variable and value strategies (the wrapper maps the names)
enum { INPUT_ORDER = 0, MIN_DOM = 1, MIN_LB = 2 };
enum { VAL_MIN = 0, VAL_SPLIT = 1, VAL_MIDDLE_OUT = 2 };

// global cells: the running bound, then "some lane not done" and "some
// lane has a solution", one cell per superstep parity
enum { CELL_GBEST = 0, CELL_NOTDONE = 1, CELL_SOL = 3, N_CELLS = 5 };
// outputs
enum { OUT_GBEST = 0, OUT_IT = 1, OUT_HEAD = 2, OUT_STOP = 3 };
// per-lane scalars shared by the CTA's threads
enum {
  SC_LOAD, SC_SUB, SC_FRESH, SC_ACTIVE, SC_DEPTH, SC_BTL, SC_POS, SC_ANY,
  SC_BETTER, SC_TELL, N_SCALARS = 16
};

// The LaneState, updated in place (the wrapper passes copies); the bool
// fields are int32 0/1.
struct State {
  int32_t *lb, *ub, *root_lb, *root_ub;          // [L, V]
  int32_t *dec_var, *dec_val, *dec_flip;         // [L, MD]
  int32_t *depth, *next_sub, *fresh, *done, *incomplete;   // [L]
  int32_t *best_obj;                             // [L]
  int32_t *best_sol;                             // [L, V]
  int32_t *has_sol, *n_nodes, *n_fails, *n_sols, *n_sweeps;  // [L]
  uint32_t *dom, *root_dom;                      // [L, V, W] or null
};

struct Params {
  fixlane::Tables t;
  State st;
  const int32_t* branch_vars;   // [B]
  const int32_t* subs_lb;       // [S, V]
  const int32_t* subs_ub;       // [S, V]
  const int32_t* gbest_in;      // [1]
  const int32_t* head_in;       // [1]
  int32_t* want;                // [L] scratch
  int32_t* cells;               // [N_CELLS] scratch
  int32_t* out;                 // [4]
  int L, B, S, MD, obj_var, supersteps, cap, var_strategy, val_strategy,
      stop_on_first, it_in;
};

// Words of shared memory past the fixpoint's: the scan's per-thread
// prefixes, its per-warp sums and the lane scalars.
constexpr int EXTRA_WORDS = THREADS + fixlane::SCAN_WORDS + N_SCALARS;


template <bool AD_SPARSE, bool CU_SPARSE, bool DOM>
__global__ void __launch_bounds__(THREADS) search_kernel(Params p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ int32_t smem[];
  const fixlane::Tables& t = p.t;
  const fixlane::Smem s =
      fixlane::carve<AD_SPARSE, CU_SPARSE, DOM>(t, smem);
  const bool carry = DOM && t.carry_dom;
  const bool middle_out = DOM && p.val_strategy == VAL_MIDDLE_OUT;
  int32_t* scan = smem + fixlane::smem_words(t);
  int32_t* wsum = scan + THREADS;
  int32_t* sc = wsum + 32;
  const State& st = p.st;
  const int tid = threadIdx.x, b = blockIdx.x, G = gridDim.x;
  const int L = p.L, V = t.V, S = p.S, MD = p.MD;

  fixlane::stage_tables<CU_SPARSE>(t, s);

  // The incoming done flag, reduced by every CTA over all lanes (nothing
  // writes the state before the first grid.sync).
  int my_nd = 0, my_sol = 0;
  for (int l = tid; l < L; l += THREADS) {
    my_nd |= !st.done[l];
    my_sol |= st.has_sol[l] != 0;
  }
  const int nd0 = __syncthreads_or(my_nd);
  const int sol0 = __syncthreads_or(my_sol);
  bool gdone = !nd0 || (p.stop_on_first && sol0);
  int32_t gbest = *p.gbest_in;
  int32_t head = *p.head_in;
  int it = p.it_in;
  if (b == 0 && tid == 0) {
    p.cells[CELL_GBEST] = gbest;
    for (int i = CELL_NOTDONE; i < N_CELLS; ++i) p.cells[i] = 0;
  }
  grid.sync();

  for (int k = 0; k < p.supersteps && !gdone; ++k) {
    const int par = k & 1;

    // -- dispatch_pool: want flags, then ranks in lane order -------------
    for (int j = tid; b + j * G < L; j += THREADS) {
      const int l = b + j * G;
      p.want[l] = st.fresh[l] && !st.done[l] && st.next_sub[l] >= S;
    }
    grid.sync();
    const int per = (L + THREADS - 1) / THREADS;
    int cnt = 0;
    for (int i = tid * per; i < min(L, (tid + 1) * per); ++i)
      cnt += __ldcg(p.want + i);
    int total;
    scan[tid] = block_exclusive_scan(cnt, wsum, &total);
    __syncthreads();
    for (int j = tid; b + j * G < L; j += THREADS) {
      const int l = b + j * G;
      if (!__ldcg(p.want + l)) continue;
      const int c = l / per;
      int rank = scan[c];
      for (int i = c * per; i < l; ++i) rank += __ldcg(p.want + i);
      const int slot = head + rank;
      if (slot < S) st.next_sub[l] = slot;
      else st.done[l] = 1;
    }
    head = min(head + total, S);
    if (b == 0 && tid == 0) {          // the other parity's flags, for k+1
      p.cells[CELL_NOTDONE + (par ^ 1)] = 0;
      p.cells[CELL_SOL + (par ^ 1)] = 0;
    }
    __syncthreads();

    // -- this CTA's lanes: load, fixpoint, commit ---------------------------
    int blk_nd = 0, blk_sol = 0;
    int32_t blk_best = BIG;
    for (int l = b; l < L; l += G) {
      const size_t row = (size_t)l * V;
      const size_t drow = (size_t)l * MD;
      if (tid == 0) {
        const int fresh = st.fresh[l], done = st.done[l];
        const int nxt = st.next_sub[l];
        const int load = fresh && nxt < S;
        const int fresh2 = fresh && !load && !done;
        const int active = !done && !fresh2;
        const int32_t best = st.best_obj[l];
        const int32_t inc = min(gbest, best);
        const int32_t bound = inc < BIG ? inc - 1 : BIG;
        sc[SC_LOAD] = load;
        sc[SC_SUB] = min(max(nxt, 0), S - 1);
        sc[SC_FRESH] = fresh2;
        sc[SC_ACTIVE] = active;
        sc[SC_DEPTH] = load ? 0 : st.depth[l];
        sc[SC_BTL] = -1;
        sc[SC_ANY] = 0;
        sc[SC_BETTER] = 0;
        if (load) st.next_sub[l] = UNASSIGNED;      // consumed
        sc[SC_TELL] = active ? bound : BIG;         // the B&B tell
      }
      __syncthreads();
      const int load = sc[SC_LOAD];
      const size_t srow = (size_t)sc[SC_SUB] * V;
      const int32_t tell = sc[SC_TELL];
      for (int v = tid; v < V; v += THREADS) {
        int32_t lo, hi;
        if (load) {
          lo = p.subs_lb[srow + v];
          hi = p.subs_ub[srow + v];
          st.root_lb[row + v] = lo;
          st.root_ub[row + v] = hi;
        } else {
          lo = st.lb[row + v];
          hi = st.ub[row + v];
        }
        if (v == p.obj_var) hi = min(hi, tell);
        s.lb(0)[v] = lo;
        s.ub(0)[v] = hi;
      }
      const int W = t.W;
      const size_t dw0 = (size_t)l * V * W;
      if (carry) {                     // a loaded lane's root words
        for (int i = tid; i < V * W; i += THREADS) {
          const int v = i / W;
          uint32_t word;
          if (load) {
            word = __ldg(t.dom_track + v)
                       ? fixlane::range_word(p.subs_lb[srow + v],
                                             p.subs_ub[srow + v],
                                             __ldg(t.dom_off + v), i - v * W)
                       : 0xffffffffu;
            st.root_dom[dw0 + i] = word;
          } else {
            word = st.dom[dw0 + i];
          }
          s.dom(0)[i] = word;
        }
      }
      const fixlane::LaneResult r =
          fixlane::fixpoint_lane<AD_SPARSE, CU_SPARSE, DOM>(t, s, p.cap);
      int32_t* flb = s.lb(r.cur);
      int32_t* fub = s.ub(r.cur);

      // record
      int my_fail = 0, my_neq = 0;
      for (int v = tid; v < V; v += THREADS) {
        my_fail |= flb[v] > fub[v];
        my_neq |= flb[v] != fub[v];
      }
      const int fail_store = __syncthreads_or(my_fail);
      const int neq = __syncthreads_or(my_neq);
      const int active = sc[SC_ACTIVE];
      const int depth = sc[SC_DEPTH];
      const int solved = active && r.conv && !fail_store && !neq;
      const int failed = active && fail_store;
      const int bt = failed || solved;
      if (tid == 0) {
        st.n_nodes[l] += failed || (active && r.conv);
        st.n_fails[l] += failed;
        st.n_sols[l] += solved;
        st.n_sweeps[l] += r.sweeps;
        int32_t best = st.best_obj[l];
        const int had = st.has_sol[l];
        int better;
        if (p.obj_var >= 0) {
          better = solved && flb[p.obj_var] < best;
          if (better) best = flb[p.obj_var];
        } else {
          better = solved && !had;
          if (better) best = BIG;
        }
        st.best_obj[l] = best;
        st.has_sol[l] = had || solved;
        sc[SC_BETTER] = better;
        blk_nd |= !st.done[l];
        blk_sol |= had || solved;
        blk_best = min(blk_best, best);
      }
      // the deepest open level (unflipped, below depth), for backtracking
      if (active && bt) {
        int my_lvl = -1;
        for (int i = tid; i < depth; i += THREADS)
          if (!st.dec_flip[drow + i]) my_lvl = i;
        if (my_lvl >= 0) atomicMax(&sc[SC_BTL], my_lvl);
      }
      __syncthreads();
      if (sc[SC_BETTER])
        for (int v = tid; v < V; v += THREADS) st.best_sol[row + v] = flb[v];

      int new_depth = depth;
      int fresh = sc[SC_FRESH];
      int overflow = 0;
      const int32_t* out_lb = flb;
      const int32_t* out_ub = fub;
      const uint32_t* out_dom = carry ? s.dom(r.cur) : nullptr;
      const int btl = sc[SC_BTL];
      if (active && bt && btl < 0) {
        fresh = 1;                                  // exhausted
      } else if (active && bt) {
        // flip the deepest open level, pop (clear) every deeper one
        for (int i = btl + tid; i < MD; i += THREADS)
          st.dec_flip[drow + i] = (i == btl);
        // recompute from the root over the decisions up to btl, in the
        // spare buffers: left x ≤ m, right x ≥ m + 1 (min/max commute);
        // under middle_out, on a tracked variable, left x = m and right
        // x ≠ m (a bit summed into the spare words, then cleared)
        int32_t* nlb = s.lb(r.cur ^ 1);
        int32_t* nub = s.ub(r.cur ^ 1);
        uint32_t* nd = carry ? s.dom(r.cur ^ 1) : nullptr;
        for (int v = tid; v < V; v += THREADS) {
          nlb[v] = st.root_lb[row + v];
          nub[v] = st.root_ub[row + v];
        }
        if (carry)
          for (int i = tid; i < V * W; i += THREADS) nd[i] = 0;
        __syncthreads();
        for (int i = tid; i <= btl; i += THREADS) {
          const int v = st.dec_var[drow + i];
          const int32_t m = st.dec_val[drow + i];
          const bool flip = i == btl || st.dec_flip[drow + i];
          if (middle_out && __ldg(t.dom_track + v)) {
            if (!flip) {
              atomicMin(&nub[v], m);
              atomicMax(&nlb[v], m);
            } else {
              const int32_t bit = m - __ldg(t.dom_off + v);
              if (bit >= 0 && bit < 32 * W)
                atomicAdd(&nd[v * W + (bit >> 5)], 1u << (bit & 31));
            }
          } else if (flip) {
            atomicMax(&nlb[v], m + 1);
          } else {
            atomicMin(&nub[v], m);
          }
        }
        if (carry) {
          __syncthreads();
          for (int i = tid; i < V * W; i += THREADS)
            nd[i] = st.root_dom[dw0 + i] & ~nd[i];
        }
        out_lb = nlb;
        out_ub = nub;
        out_dom = nd;
        new_depth = btl + 1;
      } else if (active && r.conv) {
        // select_branch: min over (key, position) breaks ties by position
        if (tid < 32) {
          long long best = 0x7fffffffffffffffLL;
          int any = 0;
          for (int pos = tid; pos < p.B; pos += 32) {
            const int v = p.branch_vars[pos];
            const int32_t lo = flb[v], hi = fub[v];
            const int unf = lo < hi;
            any |= unf;
            int32_t key;
            if (p.var_strategy == INPUT_ORDER) key = unf ? 0 : 1;
            else if (p.var_strategy == MIN_DOM) key = unf ? hi - lo : BIG;
            else key = unf ? lo : BIG;
            const long long k64 = (long long)key * 4294967296LL + pos;
            if (k64 < best) best = k64;
          }
          for (int o = 16; o; o >>= 1) {
            const long long other = __shfl_down_sync(0xffffffffu, best, o);
            if (other < best) best = other;
          }
          any = __any_sync(0xffffffffu, any);
          if (tid == 0) {
            sc[SC_POS] = (int)(best & 0xffffffffLL);
            sc[SC_ANY] = any;
          }
        }
        __syncthreads();
        if (sc[SC_ANY]) {
          if (depth >= MD) {
            overflow = 1;
          } else {
            if (tid == 0) {
              const int var = p.branch_vars[sc[SC_POS]];
              const int32_t vlb = flb[var], vub = fub[var];
              const int32_t mid = fixlane::fdiv(vlb + vub, 2);
              int32_t m = p.val_strategy == VAL_MIN ? vlb : mid;
              const bool tracked = middle_out && __ldg(t.dom_track + var);
              if (tracked) {
                // the live value nearest mid: score 2·|v − mid| + (v > mid),
                // the first (lowest) of equal scores; none live: bit 0
                const uint32_t* dw = s.dom(r.cur) + var * W;
                const int32_t off = __ldg(t.dom_off + var);
                int32_t best = BIG;
                int pos = 0;
                for (int k = 0; k < 32 * W; ++k) {
                  const int32_t v = off + k;
                  if (((dw[k >> 5] >> (k & 31)) & 1u) && v >= vlb &&
                      v <= vub) {
                    const int32_t sc_ = 2 * abs(v - mid) + (v > mid);
                    if (sc_ < best) {
                      best = sc_;
                      pos = k;
                    }
                  }
                }
                m = off + pos;
              }
              st.dec_var[drow + depth] = var;
              st.dec_val[drow + depth] = m;
              st.dec_flip[drow + depth] = 0;
              fub[var] = min(fub[var], m);          // left branch: x ≤ m
              if (tracked) flb[var] = max(flb[var], m);   // (x = m)
            }
            new_depth = depth + 1;
          }
        }
      }
      __syncthreads();
      for (int v = tid; v < V; v += THREADS) {
        st.lb[row + v] = out_lb[v];
        st.ub[row + v] = out_ub[v];
      }
      if (carry)
        for (int i = tid; i < V * W; i += THREADS) st.dom[dw0 + i] = out_dom[i];
      if (tid == 0) {
        st.depth[l] = new_depth;
        st.fresh[l] = fresh || overflow;
        if (overflow) st.incomplete[l] = 1;
      }
      __syncthreads();                 // shared buffers and scalars reused
    }
    if (tid == 0) {
      if (blk_nd) atomicOr(&p.cells[CELL_NOTDONE + par], 1);
      if (blk_sol) atomicOr(&p.cells[CELL_SOL + par], 1);
      if (blk_best < gbest) atomicMin(&p.cells[CELL_GBEST], blk_best);
    }
    grid.sync();
    gbest = __ldcg(p.cells + CELL_GBEST);
    const int nd = __ldcg(p.cells + CELL_NOTDONE + par);
    const int sol = __ldcg(p.cells + CELL_SOL + par);
    gdone = !nd || (p.stop_on_first && sol);
    ++it;
  }
  if (b == 0 && tid == 0) {
    p.out[OUT_GBEST] = gbest;
    p.out[OUT_IT] = it;
    p.out[OUT_HEAD] = head;
    p.out[OUT_STOP] = gdone;
  }
}

// Shared-memory bytes one CTA needs (the wrapper's budget uses the same
// formula, kernels/fixpoint_kernel.py::smem_budget(resident=True)).
size_t search_smem_bytes(const fixlane::Tables& t) {
  return sizeof(int32_t) * (fixlane::smem_words(t) + EXTRA_WORDS);
}

// Grid size: min(L, co-resident CTAs), or a negative cudaError_t.
template <bool AD_SPARSE, bool CU_SPARSE, bool DOM>
int grid_for(int L, size_t smem) {
  const auto kernel = search_kernel<AD_SPARSE, CU_SPARSE, DOM>;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return -(int)err;
  if (!coop) return -(int)cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return -(int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, smem);
  if (err != cudaSuccess) return -(int)err;
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  return L < per_sm * sms ? L : per_sm * sms;
}

template <bool DOM>
int grid_dom(const fixlane::Tables& t, int L, size_t smem) {
  if (t.ad_sparse)
    return t.cu_sparse ? grid_for<true, true, DOM>(L, smem)
                       : grid_for<true, false, DOM>(L, smem);
  return t.cu_sparse ? grid_for<false, true, DOM>(L, smem)
                     : grid_for<false, false, DOM>(L, smem);
}

// grid_for for the instance of the model's layouts and bitset code.
int grid_of(const fixlane::Tables& t, int L, size_t smem) {
  return fixlane::uses_dom(t) ? grid_dom<true>(t, L, smem)
                              : grid_dom<false>(t, L, smem);
}

template <bool AD_SPARSE, bool CU_SPARSE, bool DOM>
int launch(Params& p, size_t smem, cudaStream_t stream) {
  const int grid = grid_for<AD_SPARSE, CU_SPARSE, DOM>(p.L, smem);
  if (grid < 0) return -grid;
  void* args[] = {&p};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)search_kernel<AD_SPARSE, CU_SPARSE, DOM>, dim3(grid),
      dim3(THREADS), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool DOM>
int launch_dom(Params& p, size_t smem, cudaStream_t st) {
  if (p.t.ad_sparse)
    return p.t.cu_sparse ? launch<true, true, DOM>(p, smem, st)
                         : launch<true, false, DOM>(p, smem, st);
  return p.t.cu_sparse ? launch<false, true, DOM>(p, smem, st)
                       : launch<false, false, DOM>(p, smem, st);
}

}  // namespace

extern "C" {

// CTAs of a launch over L lanes, or a negative cudaError_t (no
// cooperative launch on this device, the kernel does not fit an SM).
// `tables`, `dims`: as search_launch; `carry_dom`: a bitset store rides.
int search_grid(int L, const void* const* tables, const int* dims,
                int carry_dom) {
  const fixlane::Tables t = fixlane::tables_from(tables, dims, carry_dom);
  return grid_of(t, L, search_smem_bytes(t));
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// `tables`: the fixlane::N_TABLES fixpoint tables and `dims`: the
// fixlane::N_DIMS sizes, both in fixlane::Tables order; `state`: the 21
// LaneState fields in State order (dom and root_dom null when no bitset
// store is carried); `io`: branch_vars, subs_lb, subs_ub,
// gbest_in, head_in, want, cells, out; `ints`: L, B, S, MD, obj_var,
// supersteps, cap, var_strategy, val_strategy, stop_on_first, it_in.
int search_launch(const void* const* tables, const int* dims,
                  void* const* state, void* const* io, const int* ints,
                  void* stream) {
  Params p;
  p.t = fixlane::tables_from(tables, dims, state[19] != nullptr);
  int32_t* const* sf = (int32_t* const*)state;
  p.st = State{sf[0],  sf[1],  sf[2],  sf[3],  sf[4],  sf[5],  sf[6],
               sf[7],  sf[8],  sf[9],  sf[10], sf[11], sf[12], sf[13],
               sf[14], sf[15], sf[16], sf[17], sf[18],
               (uint32_t*)state[19], (uint32_t*)state[20]};
  p.branch_vars = (const int32_t*)io[0];
  p.subs_lb = (const int32_t*)io[1];
  p.subs_ub = (const int32_t*)io[2];
  p.gbest_in = (const int32_t*)io[3];
  p.head_in = (const int32_t*)io[4];
  p.want = (int32_t*)io[5];
  p.cells = (int32_t*)io[6];
  p.out = (int32_t*)io[7];
  p.L = ints[0];
  p.B = ints[1];
  p.S = ints[2];
  p.MD = ints[3];
  p.obj_var = ints[4];
  p.supersteps = ints[5];
  p.cap = ints[6];
  p.var_strategy = ints[7];
  p.val_strategy = ints[8];
  p.stop_on_first = ints[9];
  p.it_in = ints[10];
  const size_t smem = search_smem_bytes(p.t);
  cudaStream_t st = (cudaStream_t)stream;
  return fixlane::uses_dom(p.t) ? launch_dom<true>(p, smem, st)
                                : launch_dom<false>(p, smem, st);
}

const char* search_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
