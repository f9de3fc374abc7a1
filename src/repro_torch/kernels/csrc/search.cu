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
//   1. each CTA writes the `want` flags of lanes l = blockIdx.x +
//      k·gridDim.x; grid.sync();
//   2. every CTA scans all L flags itself (a block scan; L is a few
//      thousand at most) and knows the new pool head without a second
//      barrier; then the CTAs claim lanes one at a time from a per-parity
//      atomic counter (cleared one superstep ahead, as the flag cells)
//      until none is left, and run each: the claiming CTA computes the
//      lane's rank from its own copy of the scan (dispatch folds into the
//      claim, so no CTA reads another's next_sub), then load,
//      `fixlane::fixpoint_lane` (fixpoint_lane.cuh, the body of
//      fixpoint.cu) and commit, with the store in shared memory; it folds
//      its lanes' best objective into a global cell with atomicMin and
//      their done/solution flags into per-parity cells; grid.sync(); every
//      CTA reads the new bound and done flag.
// Claiming, not a fixed lane-to-CTA map, because a lane's sweeps per
// superstep vary (1 to 64 on N-queens 32 mid-solve): a CTA whose lanes
// converge early takes more, and the superstep ends when the work runs
// out rather than when the CTA with the most sweeps does.  Which CTA runs
// which lane changes nothing: a lane's work reads only its own state, the
// pool and the previous superstep's bound, and every cross-lane fold (OR
// of flags, min of the bound) commutes; the state a lane's CTA writes is
// read by any CTA only after the next grid.sync.
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
// Slots (the lane-tiled library only): the lanes are NB slots of LS lanes
// each, slot s rows [s·LS, (s+1)·LS), one request of a LaneBatch each: the
// counterpart of the reference's `search_pallas` under `jax.vmap` over the
// batch axis (src/repro/core/api.py, LaneBatch).  Each slot has its own
// model tables (NB fixlane::Tables in the kernel's parameters, read per
// claimed lane; every slot has the dims of the launch, `shape_signature`;
// a launch takes at most MAX_SLOTS slots), branch
// variables, pool ([NB, S, V]), bound, superstep count and TPS tiles (one
// for one queue per slot), whose cursors stride over the slot's pool only.
// A slot is a run of tiles, so a slot's outputs are those of a launch on
// the slot alone; a launch without slots is one slot of all L lanes.
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
// So integer operations bound it, and a CTA runs the lanes it claims in
// sequence.  A superstep lasts at least as long as its longest lane's
// sweeps: on N-queens 32 mid-solve one lane runs 36 to 64 sweeps while
// the mean is 2 to 6 (PERF.md, the `clocks` breakdown), so the time there
// goes into the sweep itself, whose dense AllDifferent pass works on
// member bitmasks (fixpoint_lane.cuh); on J120 and N-queens 256 the
// sparse banks' sorts and scans take most of it.  The kernel is
// instantiated per layout pair of the AllDifferent and Cumulative banks
// (dense or sparse) and bitset code, picked at launch.  PERF.md has the
// times.  The kernel allocates nothing and launches on the caller's
// stream.

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
// Slots of one lane-tiled launch: their tables ride in the kernel's
// parameters (read with constant-bank loads, which ptxas may repeat
// rather than hold a table's dims in registers through the fixpoint, as
// for one queue's tables; a device array of them cost the tiled
// instances up to 52 more spill bytes), and 8 fit the 4 KB of them.
constexpr int MAX_SLOTS = TILED ? 8 : 1;
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
// Scalars shared by the CTA's threads, in shared memory so that no
// register holds them across a lane's fixpoint: the claimed lane's, then
// the CTA's superstep state (the superstep of the launch, the lane tiles'
// cell parity, ...); from SC_VALS, the Val slots (two words each at
// int64, from an even index, so 8-byte aligned).
enum {
  SC_LOAD, SC_SUB, SC_FRESH, SC_ACTIVE, SC_DEPTH, SC_BTL, SC_POS, SC_ANY,
  SC_BETTER, SC_LANE,
  SC_K, SC_CUR, SC_HEAD, SC_HEAD0, SC_TOTAL, SC_IT, SC_BLK_ND, SC_BLK_SOL,
  SC_SLOT, SC_STAGED,
  SC_VALS = 20, N_SCALARS = 32
};
// the Val slots: the lane's B&B tell, the running bound (one queue), the
// CTA's least best objective of the superstep
enum { SV_TELL, SV_GBEST, SV_BLK_BEST };

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
  fixlane::Tables<Val> t;       // slot 0's (the dims of every slot)
  State st;
  const int32_t* branch_vars;   // [NB, B]
  const Val* subs_lb;           // [NB, S, V]
  const Val* subs_ub;           // [NB, S, V]
  const Val* gbest_in;          // [NB]
  const int32_t* head_in;       // [NT]
  int32_t* want;                // [L + 2] scratch: flags, claim counters
  Val* cells;                   // [N_CELLS], lane tiles [TC_N][2][NT]
  Val* out;                     // [4][NT]
  int L, B, S, MD, obj_var, supersteps, cap, var_strategy, val_strategy,
      stop_on_first, it_in, tile, NT, LS, TPS;
  int its_in[MAX_SLOTS];                    // lane tiles: superstep counts
  fixlane::Tables<Val> tabs[MAX_SLOTS];     // lane tiles: each slot's tables
};
static_assert(sizeof(Params) <= 4096, "kernel parameters above 4 KB");

// The kernel's parameters: lane tiles index their slots' tables with the
// claimed lane's slot, so they stay in the parameter space (no local copy)
#if SEARCH_LANE_TILES
#define SEARCH_PARAMS const __grid_constant__ Params
#else
#define SEARCH_PARAMS Params
#endif

// Words of shared memory before the fixpoint's: the scan's per-thread
// prefixes, its per-warp sums and the scalars (fixed offsets).
constexpr int EXTRA_WORDS = THREADS + fixlane::SCAN_WORDS + N_SCALARS;

// ---- the per-superstep clock breakdown (the `clocks` library only) ------
//
// Built with -DFIXLANE_CLOCKS (kernels/build.py variant `clocks`), a
// barrier ends every phase of a superstep and thread 0 adds the SM clocks
// since the previous stamp to the phase's slot of `search_clk`, summed
// over CTAs (the lane's fixpoint also stamps its own phases into
// fixlane::clocks).  Per superstep k of the launch (k < CLOCK_STEPS),
// `search_steps[k]` gathers over CTAs the busy clocks (every phase but the
// two grid-barrier waits: sum and max) and the largest sum of lane sweeps
// of one CTA, and over lanes the sweeps (sum and max) and the lane count.
// `search_clocks` reads and clears them all.
enum SPhase {
  SP_DISPATCH,    // want flags (lane tiles: the next parity's cells)
  SP_SYNC_WANT,   // the wait at the first grid.sync
  SP_RANKS,       // the scan, the lanes' pool indices and the cursor
  SP_LOAD,        // the lane's store (and words) into shared memory
  SP_FIXPOINT,    // the lane's fixpoint (its sweeps' own stamps inside)
  SP_COMMIT,      // record, backtrack or branch, the store back
  SP_SYNC_BOUND,  // the flag folds and the wait at the second grid.sync
  N_SPHASES
};
enum {
  ST_BUSY_SUM, ST_BUSY_MAX, ST_CTA_SWEEPS_MAX, ST_SWEEPS_SUM,
  ST_SWEEPS_MAX, ST_LANES, N_STEP_STATS
};
constexpr int CLOCK_STEPS = 64;

#ifdef FIXLANE_CLOCKS
__device__ unsigned long long search_clk[N_SPHASES];
__device__ unsigned long long search_steps[CLOCK_STEPS][N_STEP_STATS];
#define SEARCH_STAMP(ph)                                                  \
  do {                                                                    \
    __syncthreads();                                                      \
    if (threadIdx.x == 0) {                                               \
      const long long now_ = clock64();                                   \
      atomicAdd(&search_clk[ph], (unsigned long long)(now_ - sstamp_));   \
      if ((ph) != SP_SYNC_WANT && (ph) != SP_SYNC_BOUND)                  \
        busy_ += now_ - sstamp_;                                          \
      sstamp_ = now_;                                                     \
    }                                                                     \
  } while (0)
#else
#define SEARCH_STAMP(ph) \
  do {                   \
  } while (0)
#endif

// Lane tiles: cell (kind, parity, tile).
__device__ __forceinline__ Val* tcell(const Params& p, int kind, int par,
                                      int t) {
  return p.cells + ((size_t)kind * 2 + par) * p.NT + t;
}
// Lane tiles: the tile of lane l, and the lanes [first, end) of tile tt
// (slot tt / TPS, the slot's tile tt % TPS; a slot's last tile is short
// when `tile` does not divide LS).
__device__ __forceinline__ int tile_of(const Params& p, int l) {
  const int s = l / p.LS;
  return s * p.TPS + (l - s * p.LS) / p.tile;
}
__device__ __forceinline__ int tile_first(const Params& p, int tt) {
  const int s = tt / p.TPS;
  return s * p.LS + (tt - s * p.TPS) * p.tile;
}
__device__ __forceinline__ int tile_end(const Params& p, int tt) {
  return min((tt / p.TPS + 1) * p.LS, tile_first(p, tt) + p.tile);
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

// The tables of the claimed lane's slot (sc[SC_SLOT]): lane tiles read
// them from the kernel parameters' array of the slots' tables, one queue
// has p.t.
__device__ __forceinline__ const fixlane::Tables<Val>& lane_t(
    const Params& p, const int32_t* sc) {
  if constexpr (TILED) return p.tabs[sc[SC_SLOT]];
  else return p.t;
}

// Co-resident CTAs per SM each instance is built for (its minimum-blocks
// launch bound: ptxas keeps it within 65536 / (THREADS · n) registers):
// the CTAs per SM ptxas gave each instance before the bound existed, so
// that no body change loses an instance a CTA per SM (a lost CTA costs
// more than the change saves).  Without the bound ptxas picks an
// occupancy per instance itself, differently with every change to the
// shared body.  PERF.md §6 lists each instance's registers and spills.
template <bool AD_SPARSE, bool CU_SPARSE, bool DOM>
constexpr int min_ctas() {
  if constexpr (sizeof(Val) == 8) {
    if (AD_SPARSE && CU_SPARSE && !DOM) return 3;
    if (TILED ? AD_SPARSE && !CU_SPARSE && DOM
              : !AD_SPARSE && CU_SPARSE && DOM)
      return 3;
    return 2;
  }
  return CU_SPARSE && !AD_SPARSE ? 2 : 3;
}

template <bool AD_SPARSE, bool CU_SPARSE, bool DOM>
__global__ void __launch_bounds__(THREADS,
                                  min_ctas<AD_SPARSE, CU_SPARSE, DOM>())
    search_kernel(SEARCH_PARAMS p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  // the dims of every slot; lane tiles read a claimed lane's own tables
  // from p.tabs (`lane_t` below), one queue p.t
  const fixlane::Tables<Val>& t = p.t;
  int32_t* const scan = (int32_t*)smem;
  int32_t* const wsum = scan + THREADS;
  int32_t* const sc = wsum + fixlane::SCAN_WORDS;
  Val* const sv = (Val*)(sc + SC_VALS);
  // carved here, not passed as fixpoint.cu's layout is: in this kernel
  // ptxas spills more of the lane-tiled and int64 instances with a
  // passed layout (PERF.md §6)
  const fixlane::Smem<Val> s = fixlane::carve<Val, AD_SPARSE, CU_SPARSE, DOM>(
      t, smem + sizeof(int32_t) * EXTRA_WORDS);
  const bool carry = DOM && t.carry_dom;
  const bool middle_out = DOM && p.val_strategy == VAL_MIDDLE_OUT;
  const State& st = p.st;
  const int tid = threadIdx.x, b = blockIdx.x, G = gridDim.x;
  const int L = p.L, V = t.V, S = p.S, MD = p.MD;

  // one queue stages its tables now; lane tiles at each CTA's first lane
  // of a slot (SC_STAGED)
  if constexpr (!TILED) fixlane::stage_tables<THREADS, Val, CU_SPARSE>(t, s);

  bool gdone;
  if (tid == 0) {
    sc[SC_K] = sc[SC_CUR] = 0;
    sc[SC_STAGED] = -1;
  }
  if constexpr (TILED) {
    // Each owner CTA seeds its tiles' parity-0 cells from the incoming
    // state (nothing writes the state before the first grid.sync).
    for (int tt = b; tt < p.NT; tt += G) {
      const int l0 = tile_first(p, tt), l1 = tile_end(p, tt);
      int my_nd = 0, my_sol = 0;
      for (int l = l0 + tid; l < l1; l += THREADS) {
        my_nd |= !st.done[l];
        my_sol |= st.has_sol[l] != 0;
      }
      const int nd0 = __syncthreads_or(my_nd);
      const int sol0 = __syncthreads_or(my_sol);
      if (tid == 0) {
        *tcell(p, TC_GBEST, 0, tt) = p.gbest_in[tt / p.TPS];
        *tcell(p, TC_HEAD, 0, tt) = p.head_in[tt];
        *tcell(p, TC_IT, 0, tt) = p.its_in[tt / p.TPS];
        *tcell(p, TC_NOTDONE, 0, tt) = nd0;
        *tcell(p, TC_SOL, 0, tt) = sol0;
      }
    }
    if (b == 0 && tid == 0) p.want[L] = 0;   // the first superstep's claims
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
    if (tid == 0) {
      sv[SV_GBEST] = *p.gbest_in;
      sc[SC_HEAD] = *p.head_in;
      sc[SC_IT] = p.it_in;
    }
    if (b == 0 && tid == 0) {
      p.cells[CELL_GBEST] = *p.gbest_in;
      for (int i = CELL_NOTDONE; i < N_CELLS; ++i) p.cells[i] = 0;
      p.want[L] = 0;                   // the first superstep's claims
    }
    grid.sync();
  }
#ifdef FIXLANE_CLOCKS
  long long sstamp_ = clock64(), busy_ = 0, cta_sweeps_ = 0;
#endif

  // the superstep k = sc[SC_K], its parity and (lane tiles) the cells'
  // parity cur = sc[SC_CUR] are read again after every lane's fixpoint
  while (!gdone && sc[SC_K] < p.supersteps) {
    const int par = sc[SC_K] & 1, cur = sc[SC_CUR], nxt = cur ^ 1;

    // -- dispatch_pool_tile: want flags, then ranks in lane order --------
    for (int j = tid; b + j * G < L; j += THREADS) {
      const int l = b + j * G;
      bool live = true;
      if constexpr (TILED) live = tile_live(p, cur, tile_of(p, l));
      p.want[l] = live && st.fresh[l] && !st.done[l] && st.next_sub[l] >= S;
    }
    if (b == 0 && tid == 0) p.want[L + (par ^ 1)] = 0;   // k+1's claims
    if constexpr (TILED) {
      // seed the next parity: the bound carries over, the flags clear
      for (int tt = b + tid * G; tt < p.NT; tt += THREADS * G) {
        *tcell(p, TC_GBEST, nxt, tt) = __ldcg(tcell(p, TC_GBEST, cur, tt));
        *tcell(p, TC_NOTDONE, nxt, tt) = 0;
        *tcell(p, TC_SOL, nxt, tt) = 0;
      }
    }
    SEARCH_STAMP(SP_DISPATCH);
    grid.sync();
    SEARCH_STAMP(SP_SYNC_WANT);
    const int per = (L + THREADS - 1) / THREADS;
    int cnt = 0;
    for (int i = tid * per; i < min(L, (tid + 1) * per); ++i)
      cnt += __ldcg(p.want + i);
    int total;
    scan[tid] = block_exclusive_scan<THREADS>(cnt, wsum, &total);
    if (tid == 0) {
      sc[SC_TOTAL] = total;
      if constexpr (!TILED) {
        sc[SC_HEAD0] = sc[SC_HEAD];     // this superstep's pool cursor
        sc[SC_HEAD] = min(sc[SC_HEAD] + total, S);
      }
      sc[SC_BLK_ND] = sc[SC_BLK_SOL] = 0;
      sv[SV_BLK_BEST] = BIG;
    }
    __syncthreads();
    // wanting lanes before lane x (x <= L)
    auto prefix = [&](int x) {
      if (x >= L) return sc[SC_TOTAL];
      const int per_ = (L + THREADS - 1) / THREADS, c = x / per_;
      int r = scan[c];
      for (int i = c * per_; i < x; ++i) r += __ldcg(p.want + i);
      return r;
    };
    if constexpr (TILED) {
      // each owner moves its tiles' cursor and superstep count
      for (int tt = b + tid * G; tt < p.NT; tt += THREADS * G) {
        const int h = (int)__ldcg(tcell(p, TC_HEAD, cur, tt));
        const int n = (int)__ldcg(tcell(p, TC_IT, cur, tt));
        if (tile_live(p, cur, tt)) {
          const int l0 = tile_first(p, tt), l1 = tile_end(p, tt);
          // the slot's pool indices tile tt % TPS owns
          const int st_ = tt % p.TPS;
          const int shard = p.TPS > 1 ? (S - st_ + p.TPS - 1) / p.TPS : S;
          *tcell(p, TC_HEAD, nxt, tt) =
              min(h + prefix(l1) - prefix(l0), shard);
          *tcell(p, TC_IT, nxt, tt) = n + 1;
        } else {
          *tcell(p, TC_HEAD, nxt, tt) = h;
          *tcell(p, TC_IT, nxt, tt) = n;
        }
      }
    } else {
      if (b == 0 && tid == 0) {        // the other parity's flags, for k+1
        p.cells[CELL_NOTDONE + (par ^ 1)] = 0;
        p.cells[CELL_SOL + (par ^ 1)] = 0;
      }
    }
    __syncthreads();
    SEARCH_STAMP(SP_RANKS);

    // -- lanes claimed one at a time: dispatch, load, fixpoint, commit ------
    // (what a lane needs after its sweeps is read back from the scalars or
    // recomputed, so no register holds it across them)
    for (;;) {
      __syncthreads();                 // the last lane's scalars are read
      if (tid == 0) sc[SC_LANE] = atomicAdd(p.want + L + (sc[SC_K] & 1), 1);
      __syncthreads();
      if (sc[SC_LANE] >= L) break;
      if constexpr (TILED) {           // a stopped tile: identity
        if (!tile_live(p, sc[SC_CUR], tile_of(p, sc[SC_LANE]))) continue;
        // a lane of another slot than the CTA's last: stage its tables
        // (the previous lane's fixpoint is over: the barrier above)
        const int slot = sc[SC_LANE] / p.LS;
        if (slot != sc[SC_STAGED]) {
          fixlane::stage_tables<THREADS, Val, CU_SPARSE>(p.tabs[slot], s);
          __syncthreads();
          if (tid == 0) sc[SC_STAGED] = slot;
        }
      }
      if (tid == 0) {
        const int l = sc[SC_LANE];
        Val lane_gbest;
        if constexpr (TILED)
          lane_gbest = __ldcg(tcell(p, TC_GBEST, sc[SC_CUR], tile_of(p, l)));
        else
          lane_gbest = sv[SV_GBEST];
        int done = st.done[l], nxt_sub = st.next_sub[l];
        if (__ldcg(p.want + l)) {      // dispatch_pool_tile: the lane's rank
          int idx;
          if constexpr (TILED) {
            const int tt = tile_of(p, l);
            idx = (int)__ldcg(tcell(p, TC_HEAD, sc[SC_CUR], tt)) + prefix(l) -
                  prefix(tile_first(p, tt));
            if (p.TPS > 1) idx = tt % p.TPS + p.TPS * idx;
          } else {
            idx = sc[SC_HEAD0] + prefix(l);
          }
          if (idx < S) nxt_sub = idx;
          else st.done[l] = done = 1;
        }
        const int fresh = st.fresh[l];
        const int load = fresh && nxt_sub < S;
        const int fresh2 = fresh && !load && !done;
        const int active = !done && !fresh2;
        const Val best = st.best_obj[l];
        const Val inc = min(lane_gbest, best);
        const Val bound = inc < BIG ? inc - 1 : BIG;
        sc[SC_LOAD] = load;
        sc[SC_SUB] = min(max(nxt_sub, 0), S - 1);
        if constexpr (TILED) sc[SC_SLOT] = l / p.LS;
        sc[SC_FRESH] = fresh2;
        sc[SC_ACTIVE] = active;
        sc[SC_DEPTH] = load ? 0 : st.depth[l];
        sc[SC_BTL] = -1;
        sc[SC_ANY] = 0;
        sc[SC_BETTER] = 0;
        if (load) st.next_sub[l] = UNASSIGNED;      // consumed
        sv[SV_TELL] = active ? bound : BIG;         // the B&B tell
      }
      __syncthreads();
      {
        const fixlane::Tables<Val>& lt = lane_t(p, sc);
        const int l = sc[SC_LANE];
        const size_t row = (size_t)l * V;
        const int load = sc[SC_LOAD];
        // the slot's pool row (its subproblem index is slot-local)
        size_t srow = (size_t)sc[SC_SUB] * V;
        if constexpr (TILED) srow += (size_t)sc[SC_SLOT] * S * V;
        const Val tell = sv[SV_TELL];
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
              word = __ldg(lt.dom_track + v)
                         ? fixlane::range_word<Val>(p.subs_lb[srow + v],
                                                    p.subs_ub[srow + v],
                                                    __ldg(lt.dom_off + v),
                                                    i - v * W)
                         : 0xffffffffu;
              st.root_dom[dw0 + i] = word;
            } else {
              word = st.dom[dw0 + i];
            }
            s.dom(0)[i] = word;
          }
        }
      }
      SEARCH_STAMP(SP_LOAD);
      const fixlane::LaneResult r =
          fixlane::fixpoint_lane<THREADS, Val, AD_SPARSE, CU_SPARSE, DOM>(
              lane_t(p, sc), s, p.cap);
      SEARCH_STAMP(SP_FIXPOINT);
#ifdef FIXLANE_CLOCKS
      if (tid == 0 && sc[SC_K] < CLOCK_STEPS) {
        unsigned long long* cs = search_steps[sc[SC_K]];
        atomicAdd(cs + ST_SWEEPS_SUM, (unsigned long long)r.sweeps);
        atomicMax(cs + ST_SWEEPS_MAX, (unsigned long long)r.sweeps);
        atomicAdd(cs + ST_LANES, 1ull);
        cta_sweeps_ += r.sweeps;
      }
#endif
      const int l = sc[SC_LANE];
      const size_t row = (size_t)l * V;
      const size_t drow = (size_t)l * MD;
      const int W = t.W;
      const size_t dw0 = (size_t)l * V * W;
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
          const int tt = tile_of(p, l), cur_ = sc[SC_CUR];
          if (!st.done[l]) flag_or(tcell(p, TC_NOTDONE, cur_ ^ 1, tt));
          if (had || solved) flag_or(tcell(p, TC_SOL, cur_ ^ 1, tt));
          if (best < __ldcg(tcell(p, TC_GBEST, cur_, tt)))
            fixlane::atomic_min(tcell(p, TC_GBEST, cur_ ^ 1, tt), best);
        } else {
          sc[SC_BLK_ND] |= !st.done[l];
          sc[SC_BLK_SOL] |= had || solved;
          sv[SV_BLK_BEST] = min(sv[SV_BLK_BEST], best);
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
        const fixlane::Tables<Val>& lt = lane_t(p, sc);
        for (int i = tid; i <= btl; i += THREADS) {
          const int v = st.dec_var[drow + i];
          const Val m = st.dec_val[drow + i];
          const bool flip = i == btl || st.dec_flip[drow + i];
          if (middle_out && __ldg(lt.dom_track + v)) {
            if (!flip) {
              fixlane::atomic_min(&nub[v], m);
              fixlane::atomic_max(&nlb[v], m);
            } else {
              const Val bit = m - __ldg(lt.dom_off + v);
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
        const int32_t* bvars = p.branch_vars;
        if constexpr (TILED) bvars += (size_t)sc[SC_SLOT] * p.B;
        if (tid < 32) {
          int any = 0;
          if constexpr (sizeof(Val) == 4) {
            long long best = 0x7fffffffffffffffLL;
            for (int pos = tid; pos < p.B; pos += 32) {
              const int v = bvars[pos];
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
              const int v = bvars[pos];
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
              const int var = bvars[sc[SC_POS]];
              const Val vlb = flb[var], vub = fub[var];
              const Val mid = fixlane::fdiv<Val>(vlb + vub, 2);
              Val m = p.val_strategy == VAL_MIN ? vlb : mid;
              const fixlane::Tables<Val>& lt = lane_t(p, sc);
              const bool tracked = middle_out && __ldg(lt.dom_track + var);
              if (tracked) {
                // the live value nearest mid: score 2·|v − mid| + (v > mid),
                // the first (lowest) of equal scores; none live: bit 0
                const uint32_t* dw = s.dom(r.cur) + var * W;
                const Val off = __ldg(lt.dom_off + var);
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
      SEARCH_STAMP(SP_COMMIT);
    }
#ifdef FIXLANE_CLOCKS
    if (tid == 0 && sc[SC_K] < CLOCK_STEPS) {
      unsigned long long* cs = search_steps[sc[SC_K]];
      atomicAdd(cs + ST_BUSY_SUM, (unsigned long long)busy_);
      atomicMax(cs + ST_BUSY_MAX, (unsigned long long)busy_);
      atomicMax(cs + ST_CTA_SWEEPS_MAX, (unsigned long long)cta_sweeps_);
    }
    busy_ = cta_sweeps_ = 0;
#endif
    // every thread reads the superstep's parity before the grid barrier;
    // thread 0 moves the superstep on after it
    if constexpr (TILED) {
      grid.sync();
      if (tid == 0) {
        sc[SC_CUR] ^= 1;
        ++sc[SC_K];
      }
      __syncthreads();
      gdone = !any_tile_live(p, sc[SC_CUR]);
      SEARCH_STAMP(SP_SYNC_BOUND);
    } else {
      const int par = sc[SC_K] & 1;
      if (tid == 0) {
        if (sc[SC_BLK_ND]) flag_or(&p.cells[CELL_NOTDONE + par]);
        if (sc[SC_BLK_SOL]) flag_or(&p.cells[CELL_SOL + par]);
        if (sv[SV_BLK_BEST] < sv[SV_GBEST])
          fixlane::atomic_min(&p.cells[CELL_GBEST], sv[SV_BLK_BEST]);
      }
      grid.sync();
      const int nd = __ldcg(p.cells + CELL_NOTDONE + par);
      const int sol = __ldcg(p.cells + CELL_SOL + par);
      gdone = !nd || (p.stop_on_first && sol);
      if (tid == 0) {
        sv[SV_GBEST] = __ldcg(p.cells + CELL_GBEST);
        ++sc[SC_IT];
        ++sc[SC_K];
      }
      __syncthreads();
      SEARCH_STAMP(SP_SYNC_BOUND);
    }
  }
  if constexpr (TILED) {
    const int cur = sc[SC_CUR];
    for (int tt = b + tid * G; tt < p.NT; tt += THREADS * G) {
      p.out[OUT_GBEST * p.NT + tt] = __ldcg(tcell(p, TC_GBEST, cur, tt));
      p.out[OUT_IT * p.NT + tt] = __ldcg(tcell(p, TC_IT, cur, tt));
      p.out[OUT_HEAD * p.NT + tt] = __ldcg(tcell(p, TC_HEAD, cur, tt));
      p.out[OUT_STOP * p.NT + tt] = !tile_live(p, cur, tt);
    }
  } else if (b == 0 && tid == 0) {
    p.out[OUT_GBEST] = sv[SV_GBEST];
    p.out[OUT_IT] = sc[SC_IT];
    p.out[OUT_HEAD] = sc[SC_HEAD];
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

// Co-resident CTAs per SM of the instance (ad_sparse, cu_sparse, dom) at
// `smem` bytes of dynamic shared memory (grid_for's occupancy query), or
// a negative cudaError_t.
int search_occupancy(int ad_sparse, int cu_sparse, int dom, int smem) {
  fixlane::Tables<Val> t = {};
  t.ad_sparse = ad_sparse;
  t.cu_sparse = cu_sparse;
  t.carry_dom = dom;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  const int g = grid_of(t, 0x7fffffff, smem);
  return g < 0 ? g : g / sms;
}

// Slots one launch of this library takes (`search_launch`'s NB).
int search_max_slots() { return MAX_SLOTS; }

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// `tables`: the fixlane::N_TABLES fixpoint tables of each of the NB slots
// (NB · N_TABLES pointers, slot by slot) and `dims`: the fixlane::N_DIMS
// sizes, equal for every slot, both in fixlane::Tables order; `state`: the
// 21 LaneState fields in State order over all NB · LS lanes (dom and
// root_dom null when no bitset store is carried); `io`: branch_vars
// [NB, B], subs_lb and subs_ub [NB, S, V], gbest_in [NB], head_in [NT],
// want, cells, out; `ints`: L, B, S, MD, obj_var, supersteps, cap,
// var_strategy, val_strategy, stop_on_first, it_in (slot 0's superstep
// count), tile, NT (lane tiles; L and 1 for one queue), NB, LS, TPS
// (tiles per slot; one queue: 1, L, 1), then the superstep counts of
// slots 1 to NB - 1.  Values (stores, pool, bound, cells, out) are of the
// library's width.  NB is at most search_max_slots(): 1 for the one-queue
// library.
int search_launch(const void* const* tables, const int* dims,
                  void* const* state, void* const* io, const int* ints,
                  void* stream) {
  Params p;
  const int carry_dom = state[19] != nullptr;
  p.t = fixlane::tables_from<Val>(tables, dims, carry_dom);
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
  const int NB = ints[13];
  p.LS = ints[14];
  p.TPS = ints[15];
  if (NB < 1 || NB > MAX_SLOTS || p.LS * NB != p.L || p.TPS * NB != p.NT)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < NB; ++i) {
    p.tabs[i] = fixlane::tables_from<Val>(
        tables + (size_t)i * fixlane::N_TABLES, dims, carry_dom);
    p.its_in[i] = i ? ints[15 + i] : p.it_in;
  }
  const size_t smem = search_smem_bytes(p.t);
  cudaStream_t st = (cudaStream_t)stream;
  return fixlane::uses_dom(p.t) ? launch_dom<true>(p, smem, st)
                                : launch_dom<false>(p, smem, st);
}

#ifdef FIXLANE_CLOCKS
// The `clocks` library only: copy to host memory `out` the sweep phases'
// clock sums and lane-sweep count (fixlane::Phase order, N_PHASES + 1
// values), the superstep phases' clock sums (SPhase order, N_SPHASES) and
// the per-superstep records (CLOCK_STEPS x N_STEP_STATS), and clear them
// all.  Synchronises the device first.
int search_clocks(unsigned long long* out) {
  const size_t n0 = sizeof(unsigned long long) * (fixlane::N_PHASES + 1);
  const size_t n1 = sizeof(search_clk), n2 = sizeof(search_steps);
  static const unsigned long long zeros[CLOCK_STEPS * N_STEP_STATS] = {};
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out, fixlane::clocks, n0);
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol((char*)out + n0, search_clk, n1);
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol((char*)out + n0 + n1, search_steps, n2);
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(fixlane::clocks, zeros, n0);
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(search_clk, zeros, n1);
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(search_steps, zeros, n2);
  return (int)err;
}
#endif

const char* search_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
