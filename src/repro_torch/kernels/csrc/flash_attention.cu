// Flash attention for Hopper (sm_90a): causal or bidirectional GQA
// self-attention over aligned positions, one CTA per (q-block, head,
// batch).
//
// Replaces the Pallas TPU kernel `flash_attention` / `_flash_kernel` of
// src/repro/kernels/flash_attention.py.  It computes the same function,
// not a block-by-block copy: q [B,S,H,hd], k/v [B,S,KV,hd] in bf16 (head
// h reads KV head h / (H/KV)) → o [B,S,H,hd] in bf16.  Scores are f32 at
// scale 1/sqrt(hd), masked by absolute position with NEG_INF = -1e30
// (causal: key > query; and keys at or past S, which stand for the
// reference's zero padding, which its causal mask hides); the softmax is
// online over BK-key tiles with m, l and acc in f32, p stays f32 for the
// PV product as in the reference kernel, and the output is
// acc / max(l, 1e-30) rounded once to bf16.  A causal q-block stops at
// the tile holding its last query's diagonal: the reference also visits
// the tile after it at bq == bk, whose every score is masked and adds
// exp(-1e30 - m) = 0.  The plain PyTorch version is
// repro_torch/kernels/flash_attention.py::flash_attention_plain.
//
// Design (simple first): the CTA stages its q-block once and then each
// K/V tile in shared memory as bf16 (q and k rows padded to an odd word
// count, so the 16 threads that read 16 different rows hit 16 banks);
// 256 threads as a 16 x 16 grid, thread (ty, tx) owns rows ty + 16r and
// score columns tx + 16c (an RQ x CK register tile) and output columns
// tx + 16c'.  Both products are f32 FMAs off the tensor cores; the row
// max and sum are shuffles across the 16 threads of a row (one half
// warp); p goes through shared memory in f32 to the PV product.  Causal
// q-blocks run heaviest first (block x = 0 is the last q-block).
//
// Bound: at the serving shape [4, 2048, 32, 128] with 8 KV heads, causal,
// the causal pairs need 137.5 GFLOP and the inputs and output 167.8 MB,
// so operations bound it: 0.139 ms at the bf16 tensor-core peak, 2.05 ms
// at the f32 peak off the tensor cores that this design uses.  Tensor
// cores (wgmma with bf16 p), TMA and warp specialisation are the later
// redesign (PERF.md has the times).
// The kernel allocates nothing and launches on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int TX = 16;                  // threads across a tile row
constexpr float NEG_INF = -1e30f;

struct Params {
  const bf16* q;        // [B, S, H, HD]
  const bf16* k;        // [B, S, KV, HD]
  const bf16* v;        // [B, S, KV, HD]
  bf16* o;              // [B, S, H, HD]
  int S, H, KV;
  int causal;
  float scale;
};

__host__ __device__ constexpr size_t round16(size_t n) {
  return (n + 15) / 16 * 16;
}

// Shared memory of one CTA: q and k tiles with rows of HD + 2 elements
// (an odd number of 32-bit words), the v tile unpadded, p in f32 with
// rows of BK + 1.
template <int HD, int BQ, int BK>
struct Smem {
  static constexpr int QK_STRIDE = HD + 2;
  static constexpr int P_STRIDE = BK + 1;
  static constexpr size_t K_OFF = round16(sizeof(bf16) * BQ * QK_STRIDE);
  static constexpr size_t V_OFF =
      K_OFF + round16(sizeof(bf16) * BK * QK_STRIDE);
  static constexpr size_t P_OFF = V_OFF + round16(sizeof(bf16) * BK * HD);
  static constexpr size_t BYTES = P_OFF + sizeof(float) * BQ * P_STRIDE;
};

// ROWS rows of HD bf16 starting at sequence row `row0` (row stride
// `stride` elements in device memory) into shared memory with rows of
// DST_STRIDE elements; rows at or past S are zero.  16-byte loads.
template <int HD, int ROWS, int DST_STRIDE>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          size_t stride, int row0, int S) {
  constexpr int CHUNKS = HD / 8;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * stride
                                            + c * 8);
    uint32_t* d = reinterpret_cast<uint32_t*>(dst + r * DST_STRIDE + c * 8);
    d[0] = val.x;
    d[1] = val.y;
    d[2] = val.z;
    d[3] = val.w;
  }
}

// max / sum over the 16 threads of one tile row (one half warp)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = TX / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = TX / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int HD, int BQ, int BK>
__global__ void __launch_bounds__(THREADS, 1) flash_kernel(Params p) {
  using L = Smem<HD, BQ, BK>;
  constexpr int RQ = BQ / TX;           // rows per thread
  constexpr int CK = BK / TX;           // score columns per thread
  constexpr int CD = HD / TX;           // output columns per thread
  constexpr int QKS = L::QK_STRIDE;
  constexpr int PS = L::P_STRIDE;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::K_OFF);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::V_OFF);
  float* sP = reinterpret_cast<float*>(smem + L::P_OFF);

  const int S = p.S;
  const int qb = gridDim.x - 1 - blockIdx.x;      // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int q0 = qb * BQ;
  const size_t q_stride = (size_t)p.H * HD;
  const size_t kv_stride = (size_t)p.KV * HD;
  const bf16* qg = p.q + (size_t)b * S * q_stride + (size_t)h * HD;
  const bf16* kg = p.k + (size_t)b * S * kv_stride + (size_t)kvh * HD;
  const bf16* vg = p.v + (size_t)b * S * kv_stride + (size_t)kvh * HD;

  load_rows<HD, BQ, QKS>(sQ, qg, q_stride, q0, S);

  float m[RQ], l[RQ], acc[RQ][CD];
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[r][c] = 0.f;
  }

  const int n_tiles = (S + BK - 1) / BK;
  const int n_visit =
      p.causal ? min(n_tiles, (min(q0 + BQ, S) - 1) / BK + 1) : n_tiles;
  for (int t = 0; t < n_visit; ++t) {
    const int k0 = t * BK;
    __syncthreads();                    // the last tile's readers are done
    load_rows<HD, BK, QKS>(sK, kg, kv_stride, k0, S);
    load_rows<HD, BK, HD>(sV, vg, kv_stride, k0, S);
    __syncthreads();

    float s[RQ][CK];
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
      for (int c = 0; c < CK; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[RQ], kv[CK];
#pragma unroll
      for (int r = 0; r < RQ; ++r)
        qv[r] = __bfloat162float(sQ[(ty + TX * r) * QKS + d]);
#pragma unroll
      for (int c = 0; c < CK; ++c)
        kv[c] = __bfloat162float(sK[(tx + TX * c) * QKS + d]);
#pragma unroll
      for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int c = 0; c < CK; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      const int qpos = q0 + ty + TX * r;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const int kpos = k0 + tx + TX * c;
        const bool masked = kpos >= S || (p.causal && kpos > qpos);
        s[r][c] = masked ? NEG_INF : s[r][c] * p.scale;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        s[r][c] = expf(s[r][c] - m_new);
        sum += s[r][c];
        sP[(ty + TX * r) * PS + tx + TX * c] = s[r][c];
      }
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + row_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[r][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float vv[CD];
#pragma unroll
      for (int c = 0; c < CD; ++c)
        vv[c] = __bfloat162float(sV[j * HD + tx + TX * c]);
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        const float pr = sP[(ty + TX * r) * PS + j];
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[r][c] = fmaf(pr, vv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int qpos = q0 + ty + TX * r;
    if (qpos >= S) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    bf16* orow = p.o + ((size_t)b * S + qpos) * q_stride + (size_t)h * HD;
#pragma unroll
    for (int c = 0; c < CD; ++c)
      orow[tx + TX * c] = __float2bfloat16(acc[r][c] * inv);
  }
}

template <int HD, int BQ, int BK>
int launch(const Params& p, int B, cudaStream_t stream) {
  using L = Smem<HD, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<HD, BQ, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.S + BQ - 1) / BQ, p.H, B);
  flash_kernel<HD, BQ, BK><<<grid, THREADS, L::BYTES, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_blocks(const Params& p, int B, int bq, int bk, cudaStream_t st) {
  if (bk != 128) return (int)cudaErrorInvalidValue;
  if (bq == 128) return launch<HD, 128, 128>(p, B, st);
  if (bq == 64) return launch<HD, 64, 128>(p, B, st);
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
  Params p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
           static_cast<const bf16*>(v), static_cast<bf16*>(o), S, H, KV,
           causal, 1.0f / sqrtf((float)hd)};
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 16: return launch_blocks<16>(p, B, bq, bk, st);
    case 64: return launch_blocks<64>(p, B, bq, bk, st);
    case 128: return launch_blocks<128>(p, B, bq, bk, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
