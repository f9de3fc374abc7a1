// Resident search kernel for Hopper (sm_90a): K whole supersteps of the
// lane-batched search per launch.
//
// Replaces the Pallas TPU kernel `search_pallas` / `_search_kernel` of
// src/repro/kernels/fixpoint_kernel.py in both of its modes: every lane in
// one shared pool queue (`lane_tile=0`, the mode whose trajectory equals
// the unfused loop), and lane tiles (`lane_tile=N`, the reference's
// n_tiles > 1 grid): tile t holds lanes [t·N, (t+1)·N), owns pool indices
// t, t+NT, … and keeps its own cursor, bound, superstep count and done
// flag; a stopped tile runs identity supersteps, as the reference's
// `lax.cond`.  The plain PyTorch version is
// repro_torch/kernels/fixpoint_kernel.py::search_plain: K guarded
// `search.lanes_step` supersteps (per tile).  Every LaneState field, the
// bound(s), the superstep count(s), the pool cursor(s) and the stop
// flag(s) are equal bit for bit.  Each library is built for one value
// width (FIXLANE_VAL: int32_t or int64_t, the model's) and one mode
// (SEARCH_LANE_TILES), so the one-queue int32 instances are what they
// were before either existed (kernels/build.py).
//
// One superstep, as `lanes_step`: dispatch_pool_tile → lane_load_tile
// (load + branch & bound tell with the previous superstep's bound) → the
// lane's fixpoint → lane_commit_tile (record, backtrack by recomputation
// from the root, branch); then gbest = min(gbest, min best_obj).
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
// path) are left out: a model keeps every bound inside that range
// (compile.py headroom) at either width, so they change nothing.
//
// Lane tiles: the same two grid.sync() per superstep, every tile in
// lockstep.  The per-tile state lives in device memory, double-buffered
// by superstep parity ([2][NT] each: bound, cursor, superstep count, "some
// lane not done", "some lane has a solution"): a superstep reads parity
// `cur` and writes parity `cur ^ 1`, whose cells the owner CTA of each
// tile (t mod gridDim) seeds before the first barrier.  The want flags of
// a stopped tile's lanes are 0, so one global scan gives every tile's
// ranks (a lane's rank is the prefix at the lane minus the prefix at its
// tile's first lane) and totals.
//
// Bound: per superstep the work is the lanes' fixpoint sweeps (integer ALU
// and shared-memory traffic, as fixpoint.cu) plus a commit of O(V + B +
// depth) per lane; the LaneState is read and written once per launch.
// So integer operations bound it, and a CTA that owns several lanes runs
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

#ifndef SEARCH_LANE_TILES
#define SEARCH_LANE_TILES 0
#endif

namespace cg = cooperative_groups;

namespace {

using fixlane::block_exclusive_scan;
using fixlane::THREADS;
using Val = FIXLANE_VAL;

constexpr bool TILED = SEARCH_LANE_TILES != 0;
constexpr Val BIG = fixlane::Lim<Val>::BIG;
constexpr int32_t UNASSIGNED = 0x7fffffff / 2;   // search.UNASSIGNED

// variable and value strategies (the wrapper maps the names)
enum { INPUT_ORDER = 0, MIN_DOM = 1, MIN_LB = 2 };
enum { VAL_MIN = 0, VAL_SPLIT = 1, VAL_MIDDLE_OUT = 2 };

// One queue: global cells, the running bound, then "some lane not done"
// and "some lane has a solution", one cell per superstep parity.
enum { CELL_GBEST = 0, CELL_NOTDONE = 1, CELL_SOL = 3, N_CELLS = 5 };
// Lane tiles: per-tile cells [TC_N][2][NT], the second index the parity.
enum { TC_GBEST, TC_HEAD, TC_IT, TC_NOTDONE, TC_SOL, TC_N };
// outputs, [4][NT] (NT = 1 for one queue)
enum { OUT_GBEST = 0, OUT_IT = 1, OUT_HEAD = 2, OUT_STOP = 3 };
// per-lane scalars shared by the CTA's threads; SC_TELL holds a Val (two
// words at int64, at an even index so it is 8-byte aligned)
enum {
  SC_LOAD, SC_SUB, SC_FRESH, SC_ACTIVE, SC_DEPTH, SC_BTL, SC_POS, SC_ANY,
  SC_BETTER, SC_TELL = 10, N_SCALARS = 16
};

__device__ __forceinline__ void flag_or(int32_t* a) { atomicOr(a, 1); }
__device__ __forceinline__ void flag_or(int64_t* a) {
  atomicOr((unsigned long long*)a, 1ull);
}
__device__ __forceinline__ int32_t vabs(int32_t x) { return abs(x); }
__device__ __forceinline__ int64_t vabs(int64_t x) { return x < 0 ? -x : x; }

// The LaneState, updated in place (the wrapper passes copies); the bool
// fields are int32 0/1.
struct State {
  Val *lb, *ub, *root_lb, *root_ub;              // [L, V]
  int32_t *dec_var;                              // [L, MD]
  Val *dec_val;                                  // [L, MD]
  int32_t *dec_flip;                             // [L, MD]
  int32_t *depth, *next_sub, *fresh, *done, *incomplete;   // [L]
  Val *best_obj;                                 // [L]
  Val *best_sol;                                 // [L, V]
  int32_t *has_sol, *n_nodes, *n_fails, *n_sols, *n_sweeps;  // [L]
  uint32_t *dom, *root_dom;                      // [L, V, W] or null
};

struct Params {
  fixlane::Tables<Val> t;
  State st;
  const int32_t* branch_vars;   // [B]
  const Val* subs_lb;           // [S, V]
  const Val* subs_ub;           // [S, V]
  const Val* gbest_in;          // [1]
  const int32_t* head_in;       // [NT]
  int32_t* want;                // [L] scratch
  Val* cells;                   // [N_CELLS], lane tiles [TC_N][2][NT]
  Val* out;                     // [4][NT]
  int L, B, S, MD, obj_var, supersteps, cap, var_strategy, val_strategy,
      stop_on_first, it_in, tile, NT;
};

// Words of shared memory past the fixpoint's: the scan's per-thread
// prefixes, its per-warp sums and the lane scalars.
constexpr int EXTRA_WORDS = THREADS + fixlane::SCAN_WORDS + N_SCALARS;

// Lane tiles: cell (kind, parity, tile).
__device__ __forceinline__ Val* tcell(const Params& p, int kind, int par,
                                      int t) {
  return p.cells + ((size_t)kind * 2 + par) * p.NT + t;
}
// Lane tiles: whether tile t runs the superstep that reads parity `par`
// (some lane not done, and no solution under stop_on_first).
__device__ __forceinline__ bool tile_live(const Params& p, int par, int t) {
  return __ldcg(tcell(p, TC_NOTDONE, par, t)) &&
         !(p.stop_on_first && __ldcg(tcell(p, TC_SOL, par, t)));
}
// Lane tiles: whether any tile runs the superstep that reads `par`
// (every thread of the CTA calls it).
__device__ __forceinline__ int any_tile_live(const Params& p, int par) {
  int live = 0;
  for (int t = threadIdx.x; t < p.NT && !live; t += THREADS)
    live = tile_live(p, par, t);
  return __syncthreads_or(live);
}

template <bool AD_SPARSE, bool CU_SPARSE, bool DOM>
__global__ void __launch_bounds__(THREADS) search_kernel(Params p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const fixlane::Tables<Val>& t = p.t;
  const fixlane::Smem<Val> s =
      fixlane::carve<Val, AD_SPARSE, CU_SPARSE, DOM>(t, smem);
  const bool carry = DOM && t.carry_dom;
  const bool middle_out = DOM && p.val_strategy == VAL_MIDDLE_OUT;
  int32_t* scan = (int32_t*)(smem + fixlane::smem_bytes(t));
  int32_t* wsum = scan + THREADS;
  int32_t* sc = wsum + 32;
  Val* sc_tell = (Val*)(sc + SC_TELL);
  const State& st = p.st;
  const int tid = threadIdx.x, b = blockIdx.x, G = gridDim.x;
  const int L = p.L, V = t.V, S = p.S, MD = p.MD;

  fixlane::stage_tables<THREADS, Val, CU_SPARSE>(t, s);

  bool gdone;
  Val gbest = 0;
  int32_t head = 0;
  int it = 0, cur = 0;
  if constexpr (TILED) {
    // Each owner CTA seeds its tiles' parity-0 cells from the incoming
    // state (nothing writes the state before the first grid.sync).
    for (int tt = b; tt < p.NT; tt += G) {
      const int l0 = tt * p.tile, l1 = min(L, l0 + p.tile);
      int my_nd = 0, my_sol = 0;
      for (int l = l0 + tid; l < l1; l += THREADS) {
        my_nd |= !st.done[l];
        my_sol |= st.has_sol[l] != 0;
      }
      const int nd0 = __syncthreads_or(my_nd);
      const int sol0 = __syncthreads_or(my_sol);
      if (tid == 0) {
        *tcell(p, TC_GBEST, 0, tt) = *p.gbest_in;
        *tcell(p, TC_HEAD, 0, tt) = p.head_in[tt];
        *tcell(p, TC_IT, 0, tt) = p.it_in;
        *tcell(p, TC_NOTDONE, 0, tt) = nd0;
        *tcell(p, TC_SOL, 0, tt) = sol0;
      }
    }
    grid.sync();
    gdone = !any_tile_live(p, 0);
  } else {
    // The incoming done flag, reduced by every CTA over all lanes
    // (nothing writes the state before the first grid.sync).
    int my_nd = 0, my_sol = 0;
    for (int l = tid; l < L; l += THREADS) {
      my_nd |= !st.done[l];
      my_sol |= st.has_sol[l] != 0;
    }
    const int nd0 = __syncthreads_or(my_nd);
    const int sol0 = __syncthreads_or(my_sol);
    gdone = !nd0 || (p.stop_on_first && sol0);
    gbest = *p.gbest_in;
    head = *p.head_in;
    it = p.it_in;
    if (b == 0 && tid == 0) {
      p.cells[CELL_GBEST] = gbest;
      for (int i = CELL_NOTDONE; i < N_CELLS; ++i) p.cells[i] = 0;
    }
    grid.sync();
  }

  for (int k = 0; k < p.supersteps && !gdone; ++k) {
    const int par = k & 1, nxt = cur ^ 1;

    // -- dispatch_pool_tile: want flags, then ranks in lane order --------
    for (int j = tid; b + j * G < L; j += THREADS) {
      const int l = b + j * G;
      bool live = true;
      if constexpr (TILED) live = tile_live(p, cur, l / p.tile);
      p.want[l] = live && st.fresh[l] && !st.done[l] && st.next_sub[l] >= S;
    }
    if constexpr (TILED) {
      // seed the next parity: the bound carries over, the flags clear
      for (int tt = b + tid * G; tt < p.NT; tt += THREADS * G) {
        *tcell(p, TC_GBEST, nxt, tt) = __ldcg(tcell(p, TC_GBEST, cur, tt));
        *tcell(p, TC_NOTDONE, nxt, tt) = 0;
        *tcell(p, TC_SOL, nxt, tt) = 0;
      }
    }
    grid.sync();
    const int per = (L + THREADS - 1) / THREADS;
    int cnt = 0;
    for (int i = tid * per; i < min(L, (tid + 1) * per); ++i)
      cnt += __ldcg(p.want + i);
    int total;
    scan[tid] = block_exclusive_scan<THREADS>(cnt, wsum, &total);
    __syncthreads();
    // wanting lanes before lane x (x <= L)
    auto prefix = [&](int x) {
      if (x >= L) return total;
      const int c = x / per;
      int r = scan[c];
      for (int i = c * per; i < x; ++i) r += __ldcg(p.want + i);
      return r;
    };
    for (int j = tid; b + j * G < L; j += THREADS) {
      const int l = b + j * G;
      if (!__ldcg(p.want + l)) continue;
      if constexpr (TILED) {
        const int tt = l / p.tile;
        const int slot = (int)__ldcg(tcell(p, TC_HEAD, cur, tt)) + prefix(l) -
                         prefix(tt * p.tile);
        const int idx = p.NT > 1 ? tt + p.NT * slot : slot;
        if (idx < S) st.next_sub[l] = idx;
        else st.done[l] = 1;
      } else {
        const int c = l / per;
        int rank = scan[c];
        for (int i = c * per; i < l; ++i) rank += __ldcg(p.want + i);
        const int slot = head + rank;
        if (slot < S) st.next_sub[l] = slot;
        else st.done[l] = 1;
      }
    }
    if constexpr (TILED) {
      // each owner moves its tiles' cursor and superstep count
      for (int tt = b + tid * G; tt < p.NT; tt += THREADS * G) {
        const int h = (int)__ldcg(tcell(p, TC_HEAD, cur, tt));
        const int n = (int)__ldcg(tcell(p, TC_IT, cur, tt));
        if (tile_live(p, cur, tt)) {
          const int l0 = tt * p.tile, l1 = min(L, l0 + p.tile);
          const int shard = p.NT > 1 ? (S - tt + p.NT - 1) / p.NT : S;
          *tcell(p, TC_HEAD, nxt, tt) =
              min(h + prefix(l1) - prefix(l0), shard);
          *tcell(p, TC_IT, nxt, tt) = n + 1;
        } else {
          *tcell(p, TC_HEAD, nxt, tt) = h;
          *tcell(p, TC_IT, nxt, tt) = n;
        }
      }
    } else {
      head = min(head + total, S);
      if (b == 0 && tid == 0) {        // the other parity's flags, for k+1
        p.cells[CELL_NOTDONE + (par ^ 1)] = 0;
        p.cells[CELL_SOL + (par ^ 1)] = 0;
      }
    }
    __syncthreads();

    // -- this CTA's lanes: load, fixpoint, commit ---------------------------
    int blk_nd = 0, blk_sol = 0;
    Val blk_best = BIG;
    for (int l = b; l < L; l += G) {
      Val lane_gbest = gbest;
      if constexpr (TILED) {
        const int tt = l / p.tile;
        if (!tile_live(p, cur, tt)) continue;   // a stopped tile: identity
        lane_gbest = __ldcg(tcell(p, TC_GBEST, cur, tt));
      }
      const size_t row = (size_t)l * V;
      const size_t drow = (size_t)l * MD;
      if (tid == 0) {
        const int fresh = st.fresh[l], done = st.done[l];
        const int nxt_sub = st.next_sub[l];
        const int load = fresh && nxt_sub < S;
        const int fresh2 = fresh && !load && !done;
        const int active = !done && !fresh2;
        const Val best = st.best_obj[l];
        const Val inc = min(lane_gbest, best);
        const Val bound = inc < BIG ? inc - 1 : BIG;
        sc[SC_LOAD] = load;
        sc[SC_SUB] = min(max(nxt_sub, 0), S - 1);
        sc[SC_FRESH] = fresh2;
        sc[SC_ACTIVE] = active;
        sc[SC_DEPTH] = load ? 0 : st.depth[l];
        sc[SC_BTL] = -1;
        sc[SC_ANY] = 0;
        sc[SC_BETTER] = 0;
        if (load) st.next_sub[l] = UNASSIGNED;      // consumed
        *sc_tell = active ? bound : BIG;            // the B&B tell
      }
      __syncthreads();
      const int load = sc[SC_LOAD];
      const size_t srow = (size_t)sc[SC_SUB] * V;
      const Val tell = *sc_tell;
      for (int v = tid; v < V; v += THREADS) {
        Val lo, hi;
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
                       ? fixlane::range_word<Val>(p.subs_lb[srow + v],
                                                  p.subs_ub[srow + v],
                                                  __ldg(t.dom_off + v),
                                                  i - v * W)
                       : 0xffffffffu;
            st.root_dom[dw0 + i] = word;
          } else {
            word = st.dom[dw0 + i];
          }
          s.dom(0)[i] = word;
        }
      }
      const fixlane::LaneResult r =
          fixlane::fixpoint_lane<THREADS, Val, AD_SPARSE, CU_SPARSE, DOM>(
              t, s, p.cap);
      Val* flb = s.lb(r.cur);
      Val* fub = s.ub(r.cur);

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
        Val best = st.best_obj[l];
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
        if constexpr (TILED) {
          const int tt = l / p.tile;
          if (!st.done[l]) flag_or(tcell(p, TC_NOTDONE, nxt, tt));
          if (had || solved) flag_or(tcell(p, TC_SOL, nxt, tt));
          if (best < lane_gbest)
            fixlane::atomic_min(tcell(p, TC_GBEST, nxt, tt), best);
        } else {
          blk_nd |= !st.done[l];
          blk_sol |= had || solved;
          blk_best = min(blk_best, best);
        }
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
      const Val* out_lb = flb;
      const Val* out_ub = fub;
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
        Val* nlb = s.lb(r.cur ^ 1);
        Val* nub = s.ub(r.cur ^ 1);
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
          const Val m = st.dec_val[drow + i];
          const bool flip = i == btl || st.dec_flip[drow + i];
          if (middle_out && __ldg(t.dom_track + v)) {
            if (!flip) {
              fixlane::atomic_min(&nub[v], m);
              fixlane::atomic_max(&nlb[v], m);
            } else {
              const Val bit = m - __ldg(t.dom_off + v);
              if (bit >= 0 && bit < 32 * W)
                atomicAdd(&nd[v * W + (bit >> 5)], 1u << (bit & 31));
            }
          } else if (flip) {
            fixlane::atomic_max(&nlb[v], m + 1);
          } else {
            fixlane::atomic_min(&nub[v], m);
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
          int any = 0;
          if constexpr (sizeof(Val) == 4) {
            long long best = 0x7fffffffffffffffLL;
            for (int pos = tid; pos < p.B; pos += 32) {
              const int v = p.branch_vars[pos];
              const Val lo = flb[v], hi = fub[v];
              const int unf = lo < hi;
              any |= unf;
              Val key;
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
            if (tid == 0) sc[SC_POS] = (int)(best & 0xffffffffLL);
          } else {
            // a 64-bit key leaves no room for the position: (key, pos)
            long long bkey = 0x7fffffffffffffffLL;
            int bpos = 0x7fffffff;
            for (int pos = tid; pos < p.B; pos += 32) {
              const int v = p.branch_vars[pos];
              const Val lo = flb[v], hi = fub[v];
              const int unf = lo < hi;
              any |= unf;
              Val key;
              if (p.var_strategy == INPUT_ORDER) key = unf ? 0 : 1;
              else if (p.var_strategy == MIN_DOM) key = unf ? hi - lo : BIG;
              else key = unf ? lo : BIG;
              if (key < bkey) {          // pos rises: the first one wins
                bkey = key;
                bpos = pos;
              }
            }
            for (int o = 16; o; o >>= 1) {
              const long long ok = __shfl_down_sync(0xffffffffu, bkey, o);
              const int op = __shfl_down_sync(0xffffffffu, bpos, o);
              if (ok < bkey || (ok == bkey && op < bpos)) {
                bkey = ok;
                bpos = op;
              }
            }
            if (tid == 0) sc[SC_POS] = bpos;
          }
          any = __any_sync(0xffffffffu, any);
          if (tid == 0) sc[SC_ANY] = any;
        }
        __syncthreads();
        if (sc[SC_ANY]) {
          if (depth >= MD) {
            overflow = 1;
          } else {
            if (tid == 0) {
              const int var = p.branch_vars[sc[SC_POS]];
              const Val vlb = flb[var], vub = fub[var];
              const Val mid = fixlane::fdiv<Val>(vlb + vub, 2);
              Val m = p.val_strategy == VAL_MIN ? vlb : mid;
              const bool tracked = middle_out && __ldg(t.dom_track + var);
              if (tracked) {
                // the live value nearest mid: score 2·|v − mid| + (v > mid),
                // the first (lowest) of equal scores; none live: bit 0
                const uint32_t* dw = s.dom(r.cur) + var * W;
                const Val off = __ldg(t.dom_off + var);
                Val best = BIG;
                int pos = 0;
                for (int k = 0; k < 32 * W; ++k) {
                  const Val v = off + k;
                  if (((dw[k >> 5] >> (k & 31)) & 1u) && v >= vlb &&
                      v <= vub) {
                    const Val sc_ = 2 * vabs(v - mid) + (v > mid);
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
    if constexpr (TILED) {
      grid.sync();
      cur = nxt;
      gdone = !any_tile_live(p, cur);
    } else {
      if (tid == 0) {
        if (blk_nd) flag_or(&p.cells[CELL_NOTDONE + par]);
        if (blk_sol) flag_or(&p.cells[CELL_SOL + par]);
        if (blk_best < gbest)
          fixlane::atomic_min(&p.cells[CELL_GBEST], blk_best);
      }
      grid.sync();
      gbest = __ldcg(p.cells + CELL_GBEST);
      const int nd = __ldcg(p.cells + CELL_NOTDONE + par);
      const int sol = __ldcg(p.cells + CELL_SOL + par);
      gdone = !nd || (p.stop_on_first && sol);
      ++it;
    }
  }
  if constexpr (TILED) {
    for (int tt = b + tid * G; tt < p.NT; tt += THREADS * G) {
      p.out[OUT_GBEST * p.NT + tt] = __ldcg(tcell(p, TC_GBEST, cur, tt));
      p.out[OUT_IT * p.NT + tt] = __ldcg(tcell(p, TC_IT, cur, tt));
      p.out[OUT_HEAD * p.NT + tt] = __ldcg(tcell(p, TC_HEAD, cur, tt));
      p.out[OUT_STOP * p.NT + tt] = !tile_live(p, cur, tt);
    }
  } else if (b == 0 && tid == 0) {
    p.out[OUT_GBEST] = gbest;
    p.out[OUT_IT] = it;
    p.out[OUT_HEAD] = head;
    p.out[OUT_STOP] = gdone;
  }
}

// Shared-memory bytes one CTA needs (the wrapper's budget uses the same
// formula, kernels/fixpoint_kernel.py::smem_budget(resident=True)).
size_t search_smem_bytes(const fixlane::Tables<Val>& t) {
  return fixlane::smem_bytes(t) + sizeof(int32_t) * EXTRA_WORDS;
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
int grid_dom(const fixlane::Tables<Val>& t, int L, size_t smem) {
  if (t.ad_sparse)
    return t.cu_sparse ? grid_for<true, true, DOM>(L, smem)
                       : grid_for<true, false, DOM>(L, smem);
  return t.cu_sparse ? grid_for<false, true, DOM>(L, smem)
                     : grid_for<false, false, DOM>(L, smem);
}

// grid_for for the instance of the model's layouts and bitset code.
int grid_of(const fixlane::Tables<Val>& t, int L, size_t smem) {
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
  const fixlane::Tables<Val> t =
      fixlane::tables_from<Val>(tables, dims, carry_dom);
  return grid_of(t, L, search_smem_bytes(t));
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// `tables`: the fixlane::N_TABLES fixpoint tables and `dims`: the
// fixlane::N_DIMS sizes, both in fixlane::Tables order; `state`: the 21
// LaneState fields in State order (dom and root_dom null when no bitset
// store is carried); `io`: branch_vars, subs_lb, subs_ub,
// gbest_in, head_in, want, cells, out; `ints`: L, B, S, MD, obj_var,
// supersteps, cap, var_strategy, val_strategy, stop_on_first, it_in,
// tile, NT (lane tiles; L and 1 for one queue).  Values (stores, pool,
// bound, cells, out) are of the library's width.
int search_launch(const void* const* tables, const int* dims,
                  void* const* state, void* const* io, const int* ints,
                  void* stream) {
  Params p;
  p.t = fixlane::tables_from<Val>(tables, dims, state[19] != nullptr);
  int32_t* const* sf = (int32_t* const*)state;
  Val* const* sv = (Val* const*)state;
  p.st = State{sv[0],  sv[1],  sv[2],  sv[3],  sf[4],  sv[5],  sf[6],
               sf[7],  sf[8],  sf[9],  sf[10], sf[11], sv[12], sv[13],
               sf[14], sf[15], sf[16], sf[17], sf[18],
               (uint32_t*)state[19], (uint32_t*)state[20]};
  p.branch_vars = (const int32_t*)io[0];
  p.subs_lb = (const Val*)io[1];
  p.subs_ub = (const Val*)io[2];
  p.gbest_in = (const Val*)io[3];
  p.head_in = (const int32_t*)io[4];
  p.want = (int32_t*)io[5];
  p.cells = (Val*)io[6];
  p.out = (Val*)io[7];
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
  p.tile = ints[11];
  p.NT = ints[12];
  const size_t smem = search_smem_bytes(p.t);
  cudaStream_t st = (cudaStream_t)stream;
  return fixlane::uses_dom(p.t) ? launch_dom<true>(p, smem, st)
                                : launch_dom<false>(p, smem, st);
}

const char* search_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
