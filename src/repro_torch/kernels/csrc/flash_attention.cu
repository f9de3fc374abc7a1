// Flash attention for Hopper (sm_90a): causal or bidirectional GQA
// self-attention over aligned positions, one CTA per (head, batch, q-block).
//
// Replaces the Pallas TPU kernel `flash_attention` / `_flash_kernel` of
// src/repro/kernels/flash_attention.py.  It computes the same function,
// not a block-by-block copy: q [B,S,H,hd], k/v [B,S,KV,hd] in bf16 (head
// h reads KV head h / (H/KV)) → o [B,S,H,hd] in bf16.  Scores are f32 at
// scale 1/sqrt(hd), masked by absolute position with NEG_INF = -1e30
// (causal: key > query; and keys at or past S, which stand for the
// reference's zero padding, which its causal mask hides); the softmax is
// online over 128-key tiles with m, l and acc in f32, and the output is
// acc / max(l, 1e-30) rounded once to bf16.  A causal q-block stops at the
// tile holding its last query's diagonal: the reference also visits the
// tile after it at bq == bk, whose every score is masked and adds
// exp(-1e30 - m) = 0.  The plain PyTorch version is
// repro_torch/kernels/flash_attention.py::flash_attention_plain.
//
// Rounding points.  QKᵀ multiplies bf16 operands, whose products are exact
// in f32, and sums them in f32, as the plain version does.  p stays at f32
// precision in the PV product, as in the reference kernel: it enters the
// bf16 tensor cores as a pair, p_hi = bf16(p) and p_lo = bf16(p - p_hi)
// (p - p_hi is exact), and O += p_hi·V + p_lo·V sums in f32, so p carries
// 16 significant bits (relative error about 2^-17) where bf16 p alone
// carries 8 and leaves the rtol 2^-7, atol 1e-3 bound of the tests
// (tests/test_torch_flash_kernel.py has the emulation that shows both).
// l sums the f32 p.
//
// Bound: at the serving shape [4, 2048, 32, 128] with 8 KV heads, causal,
// the causal pairs need 137.5 GFLOP of function (4·hd per pair) and the
// inputs and output 167.8 MB, so operations bound it: 0.139 ms at the
// 989 TFLOP/s bf16 tensor-core peak.  The p split makes the kernel's own
// work 6·hd per pair, 206 GFLOP (0.21 ms at that peak).
//
// Design, for the tensor cores:
// - Warps: at bq = 128 two consumer warpgroups of 64 query rows each, at
//   bq = 64 one; then a producer warpgroup whose first thread issues every
//   copy.  The producer gives up registers (setmaxnreg.dec); with two
//   consumer warpgroups they take them (setmaxnreg.inc).
// - Copies by TMA over 4-D tensor maps [B, S, heads, hd]; the sequence
//   dimension ends at S, so rows at or past S arrive as zeros, which is
//   the reference's zero padding, with no per-row test.  Swizzle 128 B for
//   hd >= 64 (hd = 128 as two 64-column panels), 32 B for hd = 16; the
//   wgmma descriptors read the same layouts.  Q is loaded once; K and V
//   go through a ring of STAGES stages with full and empty mbarriers.
// - S = QKᵀ: wgmma m64n128k16, both operands in shared memory (K-major),
//   hd/16 steps, f32 accumulators.
// - Softmax on the accumulator fragments in registers: row max across the
//   four threads that share a row, exp2 with scale·log2(e) folded into one
//   FMA, masks only in the tiles that hold the diagonal or S; l is kept per
//   thread and summed across the four at the end.
// - O += P·V: the S accumulator layout is the A-fragment layout of
//   m64nNk16, so p_hi and p_lo go to wgmma from registers and P never
//   touches shared memory; V is read in its [keys, hd] layout with the
//   B-transpose bit.  exp2(m - m_new) rescales O in registers.
// - Epilogue: O / max(l, 1e-30) in bf16 into the warpgroup's own Q rows of
//   shared memory (swizzled, so the writes hit 32 banks), then one TMA store
//   per panel, which writes no row at or past S.
// - Causal q-blocks run heaviest first: the q-block is the slowest grid
//   dimension, counted down.
// The kernel allocates nothing and launches on the caller's stream.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int BN = 128;                 // keys per KV tile
constexpr int STAGES = 2;               // K/V ring depth
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int HD, int BQ>
struct Cfg {
  static constexpr int NWG = BQ / 64;             // consumer warpgroups
  static constexpr int THREADS = 128 * (NWG + 1);  // + the producer's
  static constexpr int SWB = HD >= 64 ? 128 : 32;  // bytes per smem row
  static constexpr int CW = SWB / 2;               // columns per panel
  static constexpr int PANELS = HD / CW;
  static constexpr uint64_t SWIZZLE =
      SWB == 128 ? sm90::SWIZZLE_128B : sm90::SWIZZLE_32B;
  // shared memory: each consumer warpgroup's 64 q rows, then the K and V
  // rings (each tile PANELS panels of rows × SWB bytes), then barriers;
  // every panel is a multiple of 1024 bytes, so swizzle atoms stay aligned
  static constexpr int Q_PANEL = 64 * SWB;
  static constexpr int Q_BYTES = 64 * HD * 2;
  static constexpr int KV_PANEL = BN * SWB;
  static constexpr int KV_BYTES = BN * HD * 2;
  static constexpr int K_OFF = NWG * Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (2 * STAGES + 1) + 1024;
  // registers a thread after setmaxnreg: with two consumer warpgroups
  // 128 × 40 + 256 × 232 = 384 × 168, what a CTA of 384 threads starts
  // with; with one (256 threads) the CTA starts at 255, all a consumer can
  // use, and the consumers keep them (0: no increase)
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = NWG > 1 ? 232 : 0;
};

struct Params {
  int S, H, KV, causal;
  float scale_log2;                     // log2(e) / sqrt(hd)
};

// O[64 x HD] += P[64 x 16] · V[16 x HD], P from registers.
template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t dv) {
  if constexpr (HD == 128) sm90::wgmma_rs_n128(o, a, dv);
  else if constexpr (HD == 64) sm90::wgmma_rs_n64(o, a, dv);
  else sm90::wgmma_rs_n16(o, a, dv);
}

template <int HD, int BQ>
__global__ void __launch_bounds__(Cfg<HD, BQ>::THREADS, 1)
    flash_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_o, const Params p) {
  using C = Cfg<HD, BQ>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t bar_full = base + C::BAR_OFF;          // [STAGES]
  const uint32_t bar_empty = bar_full + 8 * STAGES;     // [STAGES]
  const uint32_t bar_q = bar_empty + 8 * STAGES;

  const int S = p.S;
  const int h = blockIdx.x, b = blockIdx.y;
  const int qb = p.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qb * BQ;
  const int n_tiles = (S + BN - 1) / BN;
  const int n_visit =
      p.causal ? min(n_tiles, (min(q0 + BQ, S) - 1) / BN + 1) : n_tiles;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(bar_full + 8 * s, 1);
      sm90::mbar_init(bar_empty + 8 * s, 4 * C::NWG);   // one per warp
    }
    sm90::mbar_init(bar_q, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == C::NWG) {
    // ---- producer: Q once, then K and V through the ring ----
    sm90::regs_dec<C::PRODUCER_REGS>();
    if (threadIdx.x == 128 * C::NWG) {
      const int kvh = h / (p.H / p.KV);
      sm90::mbar_expect_tx(bar_q, C::NWG * C::Q_BYTES);
      for (int w = 0; w < C::NWG; ++w)
        for (int pn = 0; pn < C::PANELS; ++pn)
          sm90::tma_load_4d(base + w * C::Q_BYTES + pn * C::Q_PANEL, &tm_q,
                            bar_q, pn * C::CW, h, q0 + 64 * w, b);
      for (int t = 0; t < n_visit; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES)
          sm90::mbar_wait(bar_empty + 8 * s, (t / STAGES - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        sm90::mbar_expect_tx(full, 2 * C::KV_BYTES);
        for (int pn = 0; pn < C::PANELS; ++pn) {
          const uint32_t off = s * C::KV_BYTES + pn * C::KV_PANEL;
          sm90::tma_load_4d(base + C::K_OFF + off, &tm_k, full, pn * C::CW,
                            kvh, t * BN, b);
          sm90::tma_load_4d(base + C::V_OFF + off, &tm_v, full, pn * C::CW,
                            kvh, t * BN, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroup `wg`: 64 query rows ----
    if constexpr (C::CONSUMER_REGS > 0) sm90::regs_inc<C::CONSUMER_REGS>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int qw0 = q0 + 64 * wg;
    // this thread's rows r and r + 8 of the warpgroup's 64, and its first
    // column within each 8-column group of an accumulator
    const int r = 16 * warp + lane / 4;
    const int qpos0 = qw0 + r, qpos1 = qpos0 + 8;
    const int cq = 2 * (lane % 4);
    const uint32_t sq = base + wg * C::Q_BYTES;
    const float sl = p.scale_log2;

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

    sm90::mbar_wait(bar_q, 0);
    for (int t = 0; t < n_visit; ++t) {
      const int s = t % STAGES, k0 = t * BN;
      sm90::mbar_wait(bar_full + 8 * s, (t / STAGES) & 1);
      __syncwarp();                     // wgmma needs the warp converged
      const uint32_t sk = base + C::K_OFF + s * C::KV_BYTES;
      const uint32_t sv = base + C::V_OFF + s * C::KV_BYTES;

      // S = Q Kᵀ: accumulator element 4j + e (e < 2) is (row r, key
      // 8j + cq + e), element 4j + 2 + e is (row r + 8, the same key)
      float sc[64];
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        const int pn = ks * 32 / C::SWB, off = ks * 32 % C::SWB;
        const uint64_t da = sm90::smem_desc(sq + pn * C::Q_PANEL + off, 16,
                                            8 * C::SWB, C::SWIZZLE);
        const uint64_t db = sm90::smem_desc(sk + pn * C::KV_PANEL + off, 16,
                                            8 * C::SWB, C::SWIZZLE);
        sm90::wgmma_ss_n128(sc, da, db, ks > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);

      if (k0 + BN > S || (p.causal && k0 + BN - 1 > qw0)) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kpos = k0 + 8 * j + cq + e;
            const bool out = kpos >= S;
            if (out || (p.causal && kpos > qpos0)) sc[4 * j + e] = NEG_INF;
            if (out || (p.causal && kpos > qpos1))
              sc[4 * j + 2 + e] = NEG_INF;
          }
      }

      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int x = 1; x < 4; x <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
      }
      const float corr0 = exp2f((m0 - mx0) * sl);
      const float corr1 = exp2f((m1 - mx1) * sl);
      m0 = mx0;
      m1 = mx1;
      const float neg0 = -mx0 * sl, neg1 = -mx1 * sl;

      // p = exp2(s·sl - m·sl), split into bf16 hi and lo A fragments:
      // fragment ks holds keys 16ks..16ks+15, its words 2·half and
      // 2·half + 1 the pairs of accumulator group j = 2ks + half
      uint32_t hi[8][4], lo[8][4];
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float p00 = exp2f(fmaf(sc[4 * j], sl, neg0));
        const float p01 = exp2f(fmaf(sc[4 * j + 1], sl, neg0));
        const float p10 = exp2f(fmaf(sc[4 * j + 2], sl, neg1));
        const float p11 = exp2f(fmaf(sc[4 * j + 3], sl, neg1));
        sum0 += p00 + p01;
        sum1 += p10 + p11;
        const uint32_t h0 = sm90::pack_bf16(p00, p01);
        const uint32_t h1 = sm90::pack_bf16(p10, p11);
        hi[j / 2][2 * (j % 2)] = h0;
        hi[j / 2][2 * (j % 2) + 1] = h1;
        lo[j / 2][2 * (j % 2)] = sm90::pack_bf16(p00 - sm90::bf16_lo(h0),
                                                 p01 - sm90::bf16_hi(h0));
        lo[j / 2][2 * (j % 2) + 1] = sm90::pack_bf16(
            p10 - sm90::bf16_lo(h1), p11 - sm90::bf16_hi(h1));
      }
      l0 = l0 * corr0 + sum0;
      l1 = l1 * corr1 + sum1;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j] *= corr0;
        o[4 * j + 1] *= corr0;
        o[4 * j + 2] *= corr1;
        o[4 * j + 3] *= corr1;
      }

      // O += p_hi·V + p_lo·V; V tile [keys, hd] is MN-major for this product
      sm90::fence_regs(o);
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BN / 16; ++ks) {
        const uint64_t dv = sm90::smem_desc(sv + ks * 16 * C::SWB,
                                            C::KV_PANEL, 8 * C::SWB,
                                            C::SWIZZLE);
        wgmma_pv<HD>(o, hi[ks], dv);
        wgmma_pv<HD>(o, lo[ks], dv);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      sm90::fence_regs(hi);
      sm90::fence_regs(lo);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(bar_empty + 8 * s);
    }

#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, x);
      l1 += __shfl_xor_sync(0xffffffffu, l1, x);
    }
    if (qw0 < S) {
      const float inv0 = 1.f / fmaxf(l0, 1e-30f);
      const float inv1 = 1.f / fmaxf(l1, 1e-30f);
      // O into this warpgroup's q rows, in the layout the TMA map swizzles:
      // the 16-byte chunk c of row x sits at chunk c ^ ((x·SWB >> 7) mod
      // SWB/16)
      uint8_t* dst = smem + wg * C::Q_BYTES;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int col = 8 * j + cq, pn = col / C::CW, cc = col % C::CW;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int x = r + 8 * half;
          const int chunk = (cc / 8) ^ ((x * C::SWB >> 7) & (C::SWB / 16 - 1));
          const float inv = half ? inv1 : inv0;
          *reinterpret_cast<uint32_t*>(dst + pn * C::Q_PANEL + x * C::SWB
                                       + chunk * 16 + (cc % 8) * 2) =
              sm90::pack_bf16(o[4 * j + 2 * half] * inv,
                              o[4 * j + 2 * half + 1] * inv);
        }
      }
      sm90::fence_proxy_async();
      sm90::named_barrier(1 + wg, 128);
      if (threadIdx.x % 128 == 0) {
        for (int pn = 0; pn < C::PANELS; ++pn)
          sm90::tma_store_4d(&tm_o, sq + pn * C::Q_PANEL, pn * C::CW, h, qw0,
                             b);
        sm90::tma_store_wait();
      }
    }
  }
}

// cuTensorMapEncodeTiled, taken from the driver through the runtime, so the
// library needs no -lcuda.
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// A 4-D map over a contiguous bf16 tensor [B, S, heads, hd] whose boxes are
// `rows` sequence rows × `cw` columns of one head.
int make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
             int hd, int rows, int cw, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cw, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int HD, int BQ>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int KV, int causal, cudaStream_t stream) {
  using C = Cfg<HD, BQ>;
  const CUtensorMapSwizzle sw = C::SWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                              : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap tq, tk, tv, to;
  int err;
  if ((err = make_map(&tq, q, B, S, H, HD, 64, C::CW, sw)) ||
      (err = make_map(&tk, k, B, S, KV, HD, BN, C::CW, sw)) ||
      (err = make_map(&tv, v, B, S, KV, HD, BN, C::CW, sw)) ||
      (err = make_map(&to, o, B, S, H, HD, 64, C::CW, sw)))
    return err;
  cudaError_t cerr = cudaFuncSetAttribute(
      flash_kernel<HD, BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (cerr != cudaSuccess) return (int)cerr;
  const Params p{S, H, KV, causal, LOG2E / sqrtf((float)HD)};
  const dim3 grid(H, B, (S + BQ - 1) / BQ);
  flash_kernel<HD, BQ><<<grid, C::THREADS, C::SMEM, stream>>>(tq, tk, tv,
                                                                to, p);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_blocks(const void* q, const void* k, const void* v, void* o,
                  int B, int S, int H, int KV, int bq, int bk, int causal,
                  cudaStream_t st) {
  if (bk != BN) return (int)cudaErrorInvalidValue;
  if (bq == 128) return launch<HD, 128>(q, k, v, o, B, S, H, KV, causal, st);
  if (bq == 64) return launch<HD, 64>(q, k, v, o, B, S, H, KV, causal, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success),
// cudaErrorInvalidValue for a head_dim outside {16, 64, 128}, a q-block
// outside {64, 128} or a KV block other than 128.  q/o are [B, S, H, hd], k/v [B, S, KV,
// hd], bf16, contiguous and 16-byte aligned; H % KV == 0.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int S, int H, int KV, int hd,
                           int bq, int bk, int causal, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 16:
      return launch_blocks<16>(q, k, v, o, B, S, H, KV, bq, bk, causal, st);
    case 64:
      return launch_blocks<64>(q, k, v, o, B, S, H, KV, bq, bk, causal, st);
    case 128:
      return launch_blocks<128>(q, k, v, o, B, S, H, KV, bq, bk, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
