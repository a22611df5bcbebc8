// Shared pieces of the fused decoder-layer kernels K7 (fused_decode.cu)
// and K8 (fused_ragged.cu).
//
// A TPU grid runs its cells in order, so the Pallas kernels run a whole
// decoder layer as one program whose phases follow each other.  On the
// GPU the phases need a barrier across the whole grid; here each C entry
// enqueues a fixed chain of hand-written phase kernels on the caller's
// stream (a single persistent launch with grid barriers is later work):
//
//   1. RMSNorm of the residual stream, then the qkv projection tiles;
//   2. RoPE (q in place, fresh k/v rounded to the activation dtype; in the
//      qkv epilogue on the DECODE route), then the attention kernel of K7
//      or K8;
//   3. the o-projection and the residual add;
//   4. RMSNorm, then the gate/up projection and SiLU(gate) * up;
//   5. the down projection and the second residual add.
//
// Phase buffers (the Pallas kernels' VMEM scratch): qkv [rows, Cq] and
// h [rows, D] in f32; the projections' activations xn [rows, D], ao
// [rows, H*hd] and act [rows, M] in the activation dtype, rounded once
// where they are written (the Pallas kernels round them to the dot dtype
// as each projection reads them: the same values); and the CUDA-core
// route's f32 partial sums.
//
// Rounding follows the Pallas kernels, not the unfused path: the norm is
// f32 to the end; a projection takes its activation and its weight in the
// activation dtype (exact for int8 weights), accumulates in f32 and
// multiplies the RESULT by the per-column scale; qkv and h stay f32; only
// the activations, x_out, k_new and v_new are rounded.
//
// Projections (what bounds them: at decode widths the weight bytes, at
// the ragged step's 264 rows the operations): weights are read in place,
// row-major [K, cols], int8, bf16 or f32, one f32 scale per output column
// (or per column of one head, tiled across heads).  Separate q/k/v or
// gate/up leaves are up to three column segments of one projection, never
// concatenated.  Three routes (Proj::route, chosen by the wrapper):
//
//  - DECODE (int8 weights, bf16 activations, at most 64 tokens, columns in
//    tiles of 256): see proj_decode below.  A persistent grid streams the
//    weights in equal shares of (column tile, K step) units, A from
//    registers.
//  - WGMMA (bf16 activations, int8 or bf16 weights, segments of 64-column
//    multiples; the serving path): the product is swapped, out^T = W^T .
//    x^T, so 64 output columns are wgmma's M and the tokens its N (up to
//    2 x 136), and every token of the call shares each weight byte: each
//    weight byte leaves HBM once per call (once per 272 tokens past
//    that).  A CTA of 3 warpgroups owns 128 output columns (SwiGLU: 64
//    gate columns and the same 64 up columns) of every token: one thread
//    of the first issues TMA loads of 64-row K steps (the tokens' bf16
//    activations and the weight tiles) into a ring, and each of the two
//    consumer warpgroups converts its int8 weight tile to bf16 in the
//    128-byte swizzle (bf16 weights land there directly) while its
//    previous step's products run, then issues wgmma with A MN-major (the
//    weight tile) and B K-major (the activations).  K splits across a
//    cluster of up to 8 CTAs: each CTA puts its f32 sums in its own shared
//    memory, and after a cluster barrier each CTA sums its share of the
//    tile over the ranks in rank order (distributed shared memory;
//    deterministic) and runs the epilogue there: scale, residual, SwiGLU,
//    rounding.
//  - CUDA_CORES (f32 activations: exact f32 products, as the reference's
//    f32 dots; and bf16 activations with f32 weights or segments off 64
//    columns, as tiny test models have): a CTA of 128 threads owns 512
//    consecutive output columns (4 per thread) and 16 activation rows in
//    registers, rounding its operands to the activation dtype.  K splits
//    across CTAs until about two CTAs per SM are in flight, and the
//    partial sums go to an f32 buffer that the epilogue kernel sums in a
//    fixed order (deterministic) before the scale, the residual or SiLU.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace rtt {
namespace fused {

enum TypeCode { F32 = 0, BF16 = 1, I8 = 2 };
enum Epilogue {
  EPI_STORE = 0,
  EPI_RESID = 1,
  EPI_OUT = 2,
  EPI_SWIGLU = 3,
  EPI_QKV = 4  // DECODE route, head_dim 128: q, k rotated (RoPE), v copied
};

constexpr int MAX_SEGS = 3;

// One column segment of a projection: a row-major [K, cols] weight and
// its f32 scale (null: all ones); column c of the segment takes
// scale[c % period].
struct Seg {
  const void* w;
  const float* scale;
  int cols;
  int period;
};

// How a projection runs (Proj::route).
enum Route { CUDA_CORES = 0, WGMMA = 1, DECODE = 2 };

struct Proj {
  Seg seg[MAX_SEGS];
  int nseg;
  int wtype;   // TypeCode of every segment's weight
  int cols;    // sum of the segments' cols
  int splits;  // K splits (WGMMA: the cluster size; CUDA_CORES: asked
               // for, the plan may take fewer); DECODE: the grid's CTAs
  int route;   // Route
  int nw, nc;  // WGMMA: tokens of one wgmma (its N) and wgmmas per tile;
               // DECODE: nw = the tokens rounded up to 8
  int kps;     // WGMMA: K per split, a multiple of 64
  int stages;  // WGMMA, DECODE: ring stages
};

// Everything one fused layer call needs (mirrored by a ctypes Structure
// in ray_tpu_torch/ops/fused_decode.py: keep the two in step).
struct LayerArgs {
  int rows, D, H, KVH, hd, M;
  int act_type, ln_type, pool_type;
  int L, P, page, maxp, layer, R, tq;
  int attn_cluster, attn_slots;  // K8, bf16: the Hopper attention's plan
  float scale, soft_cap, eps;
  const void* x;
  const void* ln_a;
  const void* ln_m;
  const float* sin;
  const float* cos;
  Proj qkv, wo, gateup, down;
  const void* k_pools;
  const void* v_pools;
  const float* k_scales;
  const float* v_scales;
  const int* block_tables;
  const int* lengths;
  const int* row_slot;
  const int* row_start;
  const int* row_len;
  const int* row_off;
  void* xn;  // activations in the activation dtype: xn, ao, act
  float* part;
  float* qkv_buf;
  void* ao;
  float* h;
  void* act;
  void* x_out;
  void* k_new;
  void* v_new;
  int* counters;  // DECODE: one int per column tile (decode_tiles), zeroed
                  // by the chain's first norm, reset by each last arriver
  void* stream;
};

// ---------------------------------------------------------------------------
// small helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ float load_any(const void* p, int type, size_t i) {
  if (type == F32) return static_cast<const float*>(p)[i];
  if (type == BF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  return (float)static_cast<const int8_t*>(p)[i];
}

// x rounded to the dot dtype TA and back (the Pallas kernels' astype).
template <typename TA>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Four consecutive weights as f32 (4, 8 or 16 bytes; the wrapper checks
// the alignment).
template <typename TW>
__device__ __forceinline__ void load_w4(const TW* p, float* o);
template <>
__device__ __forceinline__ void load_w4<float>(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
template <>
__device__ __forceinline__ void load_w4<__nv_bfloat16>(const __nv_bfloat16* p,
                                                       float* o) {
  const float4 v = rtt::load4(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
template <>
__device__ __forceinline__ void load_w4<int8_t>(const int8_t* p, float* o) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  o[0] = (float)c.x; o[1] = (float)c.y; o[2] = (float)c.z; o[3] = (float)c.w;
}

// Block-wide sum (blockDim.x a multiple of 32); every thread gets it.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = rtt::group_sum<32>(v);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float r = 0.f;
  for (int w = 0; w < (int)(blockDim.x / 32); ++w) r += red[w];
  return r;
}

__device__ __forceinline__ float capped(float s, float soft_cap) {
  return soft_cap > 0.f ? soft_cap * tanhf(s / soft_cap) : s;
}

// ---------------------------------------------------------------------------
// RMSNorm: out = (x * 1/sqrt(mean(x^2) + eps)) * ln, in f32, rounded to
// the activation dtype TA on the store; one CTA a row
// ---------------------------------------------------------------------------

constexpr int NORM_THREADS = 256;

// Eight consecutive elements of x (f32, bf16 or int8 by type) as f32.
__device__ __forceinline__ void load8(const void* p, int type, size_t i,
                                      float* o) {
  if (type == F32) {
    const float4 a = *reinterpret_cast<const float4*>(
        static_cast<const float*>(p) + i);
    const float4 b = *reinterpret_cast<const float4*>(
        static_cast<const float*>(p) + i + 4);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  } else {
    rtt::Vec<__nv_bfloat16>::load(static_cast<const __nv_bfloat16*>(p) + i,
                                  o);
  }
}

// VEC: D is a multiple of 8 NORM_THREADS (at most 32 NORM_THREADS), x and
// ln are f32 or bf16: each thread keeps its runs of 8 in registers.  CTA 0
// also zeroes zero[0, nzero) (the chain's DECODE arrival counts, before
// any projection of the chain runs).
template <typename TA, bool VEC>
__global__ void __launch_bounds__(NORM_THREADS) rmsnorm_kernel(
    const void* __restrict__ x, int x_type, const void* __restrict__ ln,
    int ln_type, int D, float eps, TA* __restrict__ out,
    int* __restrict__ zero, int nzero) {
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  if (row == 0)
    for (int i = threadIdx.x; i < nzero; i += NORM_THREADS) zero[i] = 0;
  float ss = 0.f;
  if constexpr (VEC) {
    constexpr int RUNS = 4;  // at most 4 runs of 8 a thread
    float v[RUNS][8];
    const int runs = D / (8 * NORM_THREADS);
#pragma unroll
    for (int k = 0; k < RUNS; ++k)
      if (k < runs) {
        load8(x, x_type, row * D + 8 * (threadIdx.x + k * NORM_THREADS),
              v[k]);
#pragma unroll
        for (int e = 0; e < 8; ++e) ss += v[k][e] * v[k][e];
      }
    ss = block_sum(ss, red);
    const float r = 1.f / sqrtf(ss / (float)D + eps);
#pragma unroll
    for (int k = 0; k < RUNS; ++k)
      if (k < runs) {
        const int c = 8 * (threadIdx.x + k * NORM_THREADS);
        float w[8];
        load8(ln, ln_type, c, w);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          out[row * D + c + e] =
              from_float<TA>(__fmul_rn(__fmul_rn(v[k][e], r), w[e]));
      }
    return;
  }
  for (int i = threadIdx.x; i < D; i += NORM_THREADS) {
    const float v = load_any(x, x_type, row * D + i);
    ss += v * v;
  }
  ss = block_sum(ss, red);
  const float r = 1.f / sqrtf(ss / (float)D + eps);
  for (int i = threadIdx.x; i < D; i += NORM_THREADS)
    out[row * D + i] = from_float<TA>(
        __fmul_rn(__fmul_rn(load_any(x, x_type, row * D + i), r),
                  load_any(ln, ln_type, i)));
}

// ---------------------------------------------------------------------------
// projection: split-K partial sums part[split][row][col]
// ---------------------------------------------------------------------------

constexpr int G_THREADS = 128;
constexpr int G_CPT = 4;   // output columns per thread
constexpr int G_RT = 16;   // activation rows per CTA
constexpr int G_KC = 32;   // K staged per step
constexpr int G_COLS = G_THREADS * G_CPT;

// K per split (a multiple of G_KC) and the number of splits it gives.
__host__ __device__ __forceinline__ int split_k(int K, int want) {
  const int per = (K + want - 1) / want;
  return (per + G_KC - 1) / G_KC * G_KC;
}
__host__ __device__ __forceinline__ int split_count(int K, int want) {
  const int kps = split_k(K, want);
  return (K + kps - 1) / kps;
}

template <typename TA, typename TW>
__global__ void __launch_bounds__(G_THREADS) gemv_part_kernel(
    const TA* __restrict__ a, int rows, int K, Proj pj, int kps,
    float* __restrict__ part) {
  __shared__ __align__(16) float a_s[G_KC][G_RT];
  const int r0 = blockIdx.x * G_RT;
  const int c = blockIdx.y * G_COLS + threadIdx.x * G_CPT;
  const int split = blockIdx.z;
  const int k0 = split * kps;
  const int k1 = min(K, k0 + kps);
  const TW* w = nullptr;
  int wc = 1, lc = 0;
  for (int s = 0, base = 0; s < pj.nseg; ++s) {
    if (c >= base && c < base + pj.seg[s].cols) {
      w = static_cast<const TW*>(pj.seg[s].w);
      wc = pj.seg[s].cols;
      lc = c - base;
    }
    base += pj.seg[s].cols;
  }
  float acc[G_RT][G_CPT];
#pragma unroll
  for (int r = 0; r < G_RT; ++r)
#pragma unroll
    for (int j = 0; j < G_CPT; ++j) acc[r][j] = 0.f;

  for (int kc = k0; kc < k1; kc += G_KC) {
    __syncthreads();  // the previous step's readers are done with a_s
    for (int i = threadIdx.x; i < G_KC * G_RT; i += G_THREADS) {
      const int r = i / G_KC, kk = i % G_KC;
      const int row = r0 + r, k = kc + kk;
      a_s[kk][r] = (row < rows && k < k1) ? to_float(a[(size_t)row * K + k])
                                          : 0.f;
    }
    __syncthreads();
    if (w != nullptr) {
      const int kn = min(G_KC, k1 - kc);
      const TW* wp = w + (size_t)kc * wc + lc;
#pragma unroll 4
      for (int kk = 0; kk < kn; ++kk) {
        float wv[G_CPT];
        load_w4<TW>(wp + (size_t)kk * wc, wv);
        if (sizeof(TW) == 4 && sizeof(TA) == 2) {
#pragma unroll
          for (int j = 0; j < G_CPT; ++j) wv[j] = round_to<TA>(wv[j]);
        }
        const float4* ar = reinterpret_cast<const float4*>(a_s[kk]);
#pragma unroll
        for (int r4 = 0; r4 < G_RT / 4; ++r4) {
          const float4 av = ar[r4];
          const float al[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int j = 0; j < G_CPT; ++j)
              acc[r4 * 4 + q][j] = fmaf(al[q], wv[j], acc[r4 * 4 + q][j]);
        }
      }
    }
  }
  if (w == nullptr) return;
#pragma unroll
  for (int r = 0; r < G_RT; ++r) {
    const int row = r0 + r;
    if (row < rows)
      *reinterpret_cast<float4*>(
          part + ((size_t)split * rows + row) * pj.cols + c) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

__device__ __forceinline__ float seg_scale(const Proj& pj, int c) {
  for (int s = 0, base = 0; s < pj.nseg; ++s) {
    if (c < base + pj.seg[s].cols) {
      const float* sc = pj.seg[s].scale;
      return sc == nullptr ? 1.f : sc[(c - base) % pj.seg[s].period];
    }
    base += pj.seg[s].cols;
  }
  return 1.f;
}

// The residual an epilogue adds at idx: x (TA) for RESID, h (f32) for
// OUT, none otherwise.
template <typename TA>
__device__ __forceinline__ float resid_at(int mode, const void* resid,
                                          size_t idx) {
  if (mode == EPI_RESID) return to_float(static_cast<const TA*>(resid)[idx]);
  if (mode == EPI_OUT) return static_cast<const float*>(resid)[idx];
  return 0.f;
}

// One output element of a projection from its summed column y (and, for
// SWIGLU, u), their column scales sy, su and the residual r: STORE out_f
// = y * sy; RESID out_f = x + y * sy; OUT out_t = round(h + y * sy);
// SWIGLU (columns [gate | up]) out_t = round(silu(g * sg) * (u * su)).
// idx indexes the output row-major.  FAST takes the sigmoid from the
// special-function unit's exp and a fast reciprocal (within a few f32
// ulp; the WGMMA route, whose product rounds to bf16), else from expf and
// an IEEE division (the f32 route, held to the CPU's streams).
template <typename TA, bool FAST = false>
__device__ __forceinline__ void epilogue_one(int mode, size_t idx, float y,
                                             float u, float sy, float su,
                                             float r, float* out_f,
                                             TA* out_t) {
  y = __fmul_rn(y, sy);
  if (mode == EPI_STORE) {
    out_f[idx] = y;
  } else if (mode == EPI_RESID) {
    out_f[idx] = r + y;
  } else if (mode == EPI_OUT) {
    out_t[idx] = from_float<TA>(r + y);
  } else {
    u = __fmul_rn(u, su);
    const float sig = FAST ? __fdividef(1.f, 1.f + __expf(-y))
                           : 1.f / (1.f + expf(-y));
    out_t[idx] = from_float<TA>(__fmul_rn(__fmul_rn(y, sig), u));
  }
}

// epilogue_one's value before the store: y * sy, plus the residual r
// (RESID, OUT), or SiLU(y * sy) * (u * su) (SWIGLU).
template <bool FAST>
__device__ __forceinline__ float epilogue_value(int mode, float y, float u,
                                                float sy, float su, float r) {
  y = __fmul_rn(y, sy);
  if (mode == EPI_STORE) return y;
  if (mode == EPI_RESID || mode == EPI_OUT) return r + y;
  u = __fmul_rn(u, su);
  const float sig = FAST ? __fdividef(1.f, 1.f + __expf(-y))
                         : 1.f / (1.f + expf(-y));
  return __fmul_rn(__fmul_rn(y, sig), u);
}

// Sum the splits in order, then epilogue_one.
template <typename TA>
__global__ void epilogue_kernel(const float* __restrict__ part, int rows,
                                Proj pj, int splits, int mode,
                                const void* __restrict__ resid,
                                float* __restrict__ out_f,
                                TA* __restrict__ out_t) {
  const int ocols = mode == EPI_SWIGLU ? pj.cols / 2 : pj.cols;
  const size_t n = (size_t)rows * ocols;
  const size_t plane = (size_t)rows * pj.cols;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    const size_t r = idx / ocols;
    const int c = (int)(idx % ocols);
    const float* p = part + r * pj.cols + c;
    float y = 0.f, u = 0.f;
    for (int s = 0; s < splits; ++s) y += p[s * plane];
    if (mode == EPI_SWIGLU)
      for (int s = 0; s < splits; ++s) u += p[s * plane + ocols];
    epilogue_one<TA>(mode, idx, y, u, seg_scale(pj, c),
                     mode == EPI_SWIGLU ? seg_scale(pj, c + ocols) : 1.f,
                     resid_at<TA>(mode, resid, idx), out_f, out_t);
  }
}

template <typename TA, typename TW>
int launch_gemv(const TA* a, int rows, int K, const Proj& pj, float* part,
                cudaStream_t st) {
  const int kps = split_k(K, pj.splits);
  const dim3 grid((rows + G_RT - 1) / G_RT, (pj.cols + G_COLS - 1) / G_COLS,
                  split_count(K, pj.splits));
  gemv_part_kernel<TA, TW><<<grid, G_THREADS, 0, st>>>(a, rows, K, pj, kps,
                                                       part);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// WGMMA route: bf16 activations, int8 or bf16 weights
// ---------------------------------------------------------------------------

namespace hp = rtt::hopper;

constexpr int W_THREADS = 3 * hp::WG_THREADS;  // producer + 2 consumers
constexpr int W_SUB = 64 * 64 * 2;    // a 64 x 64 bf16 weight sub-tile
constexpr int W_RAW = 64 * 64;        // its int8 bytes
constexpr int W_LDD = 128 + 4;        // row of the f32 result tile (floats)
constexpr int W_MAX_STAGES = 8;
constexpr int W_MAX_SPLIT = 8;        // the largest portable cluster

// Shared memory of one ring stage for NT = NW * NC tokens: the tokens'
// activations [NT][64] bf16, two weight sub-tiles [64 K][64 columns] bf16
// (both in the 128-byte swizzle), and for int8 weights their raw bytes.
// Every part is a multiple of 1024 bytes.  The f32 result tile [NT][W_LDD]
// reuses the ring once the products are done.
template <int NW, int NC, bool I8W>
struct WLayout {
  static constexpr int NT = NW * NC;
  static constexpr uint32_t X = NT * 128;
  static constexpr uint32_t W = 2 * W_SUB;
  static constexpr uint32_t RAW = I8W ? 2 * W_RAW : 0;
  static constexpr uint32_t STAGE = X + W + RAW;
  static constexpr uint32_t DUMP = NT * W_LDD * 4;
};

struct WArgs {
  Proj pj;
  int rows, K, mode;
  int ocols;  // columns of an output row (SWIGLU: M)
  const void* resid;
  float* out_f;
  __nv_bfloat16* out_t;
};

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// CTA (split, j, t): K split `split` (its rank in the cluster) of column
// tile j for tokens [t * NT, t * NT + NT).  Consumer warpgroup w (1, 2)
// owns sub-tile w - 1: columns 128 j + 64 (w - 1), or for SWIGLU gate
// columns 64 j (w = 1) and the up columns M + 64 j (w = 2).
template <int NW, int NC, bool I8W>
__global__ void __launch_bounds__(W_THREADS, 1) proj_wgmma(
    const __grid_constant__ CUtensorMap tm_x,
    const __grid_constant__ CUtensorMap tm_w0,
    const __grid_constant__ CUtensorMap tm_w1,
    const __grid_constant__ CUtensorMap tm_w2, const WArgs a) {
  using L = WLayout<NW, NC, I8W>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * W_MAX_STAGES];
  __shared__ float col_scale[128];
  const uint32_t sbase = hp::smem_u32(smem_raw);
  const uint32_t base = (sbase + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - sbase);
  float* dump = reinterpret_cast<float*>(sm);
  const int tid = threadIdx.x, wg = tid / hp::WG_THREADS;
  const int warp = (tid / 32) & 3, lane = tid & 31;
  const int split = blockIdx.x, S = gridDim.x, j = blockIdx.y;
  const int r0 = blockIdx.z * L::NT;
  const int k0 = split * a.pj.kps;
  const int nsteps = (min(a.K, k0 + a.pj.kps) - k0 + 63) / 64;
  const int ST = a.pj.stages;
  const uint32_t bar0 = hp::smem_u32(bars);
  auto full = [&](int s) { return bar0 + 8u * s; };
  auto empty = [&](int s) { return bar0 + 8u * (W_MAX_STAGES + s); };
  auto xs = [&](int s) { return base + s * L::STAGE; };
  auto ws = [&](int s) { return base + s * L::STAGE + L::X; };
  auto rs = [&](int s) { return base + s * L::STAGE + L::X + L::W; };

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      hp::mbar_init(full(s), 1);
      hp::mbar_init(empty(s), 8);  // lane 0 of each consumer warp
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    hp::setmaxnreg_dec<40>();
    if (warp == 0) {
      if (lane == 0) {
        const CUtensorMap* wm[2];
        int wc[2];
        for (int w = 0; w < 2; ++w) {
          int c = a.mode == EPI_SWIGLU ? w * a.ocols + 64 * j
                                       : 128 * j + 64 * w;
          int seg = 0;
          while (seg + 1 < a.pj.nseg && c >= a.pj.seg[seg].cols)
            c -= a.pj.seg[seg++].cols;
          wm[w] = seg == 0 ? &tm_w0 : seg == 1 ? &tm_w1 : &tm_w2;
          wc[w] = c;
        }
        for (int i = 0; i < nsteps; ++i) {
          const int s = i % ST, k = k0 + 64 * i;
          hp::mbar_wait(empty(s), ((i / ST) & 1) ^ 1);
          hp::mbar_expect_tx(full(s), L::X + (I8W ? L::RAW : L::W));
          for (int c = 0; c < NC; ++c)
            hp::tma_load_2d(xs(s) + c * NW * 128, &tm_x, full(s), k,
                            r0 + c * NW);
          for (int w = 0; w < 2; ++w)
            hp::tma_load_2d(I8W ? rs(s) + w * W_RAW : ws(s) + w * W_SUB,
                            wm[w], full(s), wc[w], k);
        }
      }
    }
    if (S > 1) {  // the two cluster barriers of the reduction below
      hp::cluster_arrive();
      hp::cluster_wait();
      hp::cluster_arrive();
      hp::cluster_wait();
    }
    return;
  }

  hp::setmaxnreg_inc<232>();
  const int w = wg - 1;
  float acc[NC][NW / 2];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[c][i] = 0.f;
  for (int i = 0; i < nsteps; ++i) {
    const int s = i % ST;
    const uint32_t par = (i / ST) & 1;
    hp::mbar_wait(full(s), par);
    if (I8W) {
      // This warpgroup's raw [64][64] int8 sub-tile to bf16 in the
      // swizzle (4 chunks of 8 a thread), while the previous step's
      // products are still in flight.
      const uint8_t* raw = sm + (rs(s) - base) + w * W_RAW;
      uint8_t* dst = sm + (ws(s) - base) + w * W_SUB;
#pragma unroll
      for (int e = tid % hp::WG_THREADS; e < 64 * 8; e += hp::WG_THREADS) {
        const int r = e >> 3, ch = e & 7;
        const uint2 v = *reinterpret_cast<const uint2*>(raw + r * 64 + ch * 8);
        *reinterpret_cast<uint4*>(dst + r * 128 + ((ch ^ (r & 7)) << 4)) =
            rtt::int8x8_to_bf16(v.x, v.y);
      }
      hp::fence_proxy_async();
      named_sync(2 + w, hp::WG_THREADS);
    }
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // A: 16 K rows of the weight sub-tile (MN-major); B: 16 K columns
      // of the tokens' activations (K-major).
      const uint64_t da =
          hp::desc_sw128(ws(s) + w * W_SUB + kk * 2048, 64 * 128, 1024);
#pragma unroll
      for (int c = 0; c < NC; ++c)
        hp::wgmma_ta(acc[c], da,
                     hp::desc_sw128(xs(s) + c * NW * 128 + kk * 32, 16, 1024),
                     1);
    }
    hp::wgmma_commit();
    // Step i - 1's products have retired: its stage goes back to warp 0.
    hp::wgmma_wait<1>();
    if (i > 0 && lane == 0) hp::mbar_arrive(empty((i - 1) % ST));
  }
  hp::wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < NC; ++c) hp::fence_operand(acc[c]);

  // The f32 sums into this CTA's result tile [token][128 columns] (the
  // ring, which every product of both consumers is done with), and the
  // scales of the tile's columns.
  named_sync(1, 2 * hp::WG_THREADS);
  const int ct = tid - hp::WG_THREADS;  // 0 .. 255
  const bool swiglu = a.mode == EPI_SWIGLU;
  if (ct < 128)
    col_scale[ct] = seg_scale(
        a.pj, swiglu ? (ct >> 6) * a.ocols + 64 * j + (ct & 63) : 128 * j + ct);
  const int gq = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < NW / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 64 * w + 16 * warp + gq + 8 * (e >> 1);
        const int n = c * NW + 8 * i + 2 * tig + (e & 1);
        dump[n * W_LDD + m] = acc[c][4 * i + e];
      }
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  if (S > 1) {
    hp::cluster_arrive();
    hp::cluster_wait();
  } else {
    named_sync(1, 2 * hp::WG_THREADS);
  }

  // This rank's share of the tile's token rows: the ranks' sums in rank
  // order, then the epilogue.  A thread keeps four consecutive columns
  // and reads them from every rank (float4) before it adds any, so the
  // ranks' latencies overlap.
  const int ntok = min(L::NT, a.rows - r0);
  const int oc = swiglu ? 64 : 128;
  const int c = 4 * (ct % (oc / 4)), step = 256 / (oc / 4);
  const int col = oc * j + c;
  float sy[4], su[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    sy[i] = col_scale[c + i];
    su[i] = swiglu ? col_scale[64 + c + i] : 1.f;
  }
  const int t1 = ntok * (split + 1) / S;
  for (int t = ntok * split / S + ct / (oc / 4); t < t1; t += step) {
    float4 ys[W_MAX_SPLIT], us[W_MAX_SPLIT];
#pragma unroll
    for (int q = 0; q < W_MAX_SPLIT; ++q)
      if (q < S) {
        const float* dq = S > 1 ? cluster.map_shared_rank(dump, q) : dump;
        ys[q] = *reinterpret_cast<const float4*>(dq + t * W_LDD + c);
        if (swiglu)
          us[q] = *reinterpret_cast<const float4*>(dq + t * W_LDD + 64 + c);
      }
    float y[4] = {0.f, 0.f, 0.f, 0.f}, u[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int q = 0; q < W_MAX_SPLIT; ++q)
      if (q < S) {
        y[0] += ys[q].x; y[1] += ys[q].y; y[2] += ys[q].z; y[3] += ys[q].w;
        if (swiglu) {
          u[0] += us[q].x; u[1] += us[q].y; u[2] += us[q].z; u[3] += us[q].w;
        }
      }
    const size_t idx = (size_t)(r0 + t) * a.ocols + col;
    float r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[i] = resid_at<__nv_bfloat16>(a.mode, a.resid, idx + i);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      epilogue_one<__nv_bfloat16, true>(a.mode, idx + i, y[i], u[i], sy[i],
                                        su[i], r[i], a.out_f, a.out_t);
  }
  if (S > 1) {  // no CTA leaves while another reads its tile
    hp::cluster_arrive();
    hp::cluster_wait();
  }
}

// Tensor maps for the WGMMA route: the activations [rows, K] bf16 in
// boxes of 64 K columns x nw tokens, and each weight segment [K, cols] in
// boxes of 64 columns x 64 K rows (bf16 in the 128-byte swizzle; int8 raw).
inline int wgmma_maps(const __nv_bfloat16* a, int rows, int K,
                      const Proj& pj, CUtensorMap* tx, CUtensorMap* tw) {
  {
    const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
    const cuuint32_t box[2] = {64, (cuuint32_t)pj.nw};
    const int err = hp::encode_map(tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                   a, dims, strides, box,
                                   CU_TENSOR_MAP_SWIZZLE_128B);
    if (err) return err;
  }
  const bool i8 = pj.wtype == I8;
  for (int s = 0; s < pj.nseg; ++s) {
    const cuuint64_t dims[2] = {(cuuint64_t)pj.seg[s].cols, (cuuint64_t)K};
    const cuuint64_t strides[1] = {(cuuint64_t)pj.seg[s].cols * (i8 ? 1 : 2)};
    const cuuint32_t box[2] = {64, 64};
    const int err = hp::encode_map(
        tw + s,
        i8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
        2, pj.seg[s].w, dims, strides, box,
        i8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B);
    if (err) return err;
  }
  return 0;
}

template <int NW, int NC, bool I8W>
int launch_wgmma_t(const CUtensorMap& tx, const CUtensorMap* tw,
                   const WArgs& w, int ctiles, cudaStream_t st) {
  using L = WLayout<NW, NC, I8W>;
  auto kernel = proj_wgmma<NW, NC, I8W>;
  const uint32_t ring = w.pj.stages * L::STAGE;
  const size_t smem = (ring > L::DUMP ? ring : L::DUMP) + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(w.pj.splits, ctiles, (w.rows + L::NT - 1) / L::NT);
  cfg.blockDim = dim3(W_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = w.pj.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tx, tw[0], tw[1], tw[2], w);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// a [rows, K] bf16 -> the projection with its epilogue, in one launch.
inline int launch_wgmma(const __nv_bfloat16* a, int rows, int K,
                        const Proj& pj, int mode, const void* resid,
                        float* out_f, __nv_bfloat16* out_t,
                        cudaStream_t st) {
  if (pj.splits < 1 || pj.splits > W_MAX_SPLIT || pj.stages < 2 ||
      pj.stages > W_MAX_STAGES || pj.kps % 64)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw[MAX_SEGS] = {};
  int err = wgmma_maps(a, rows, K, pj, &tx, tw);
  if (err) return err;
  const bool swiglu = mode == EPI_SWIGLU;
  const WArgs w{pj, rows, K, mode, swiglu ? pj.cols / 2 : pj.cols, resid,
                out_f, out_t};
  const int ctiles = pj.cols / 128;  // SwiGLU: M / 64 gate/up pairs
  const bool i8 = pj.wtype == I8;
#define RTT_WGMMA(NW, NC)                                                  \
  (i8 ? launch_wgmma_t<NW, NC, true>(tx, tw, w, ctiles, st)                \
      : launch_wgmma_t<NW, NC, false>(tx, tw, w, ctiles, st))
  if (pj.nw == 64 && pj.nc == 1) return RTT_WGMMA(64, 1);
  if (pj.nw == 136 && pj.nc == 1) return RTT_WGMMA(136, 1);
  if (pj.nw == 136 && pj.nc == 2) return RTT_WGMMA(136, 2);
#undef RTT_WGMMA
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// DECODE route: int8 weights, bf16 activations, at most 64 tokens
// ---------------------------------------------------------------------------
//
// At decode widths a projection streams its weights (218 MB of int8 a
// LLAMA3_8B layer, 48 tokens): the bound is bytes, and every SM has to
// keep loads in flight from the first cycle to the last.  So:
//  - the grid is persistent, one CTA an SM, and the work is a list of
//    units (column tile, 64-K step) in tile-major order, cut into one
//    contiguous, equal share per CTA (stream-K): no SM idles and there is
//    no tail wave whatever the number of tiles;
//  - a column tile is 256 output columns (SwiGLU: 128 gate columns and the
//    same 128 up columns); each consumer warpgroup owns 128 of them, one
//    int8 TMA box of [64 K][128 columns] (128-byte rows, 128-byte swizzle)
//    a step, and a step's activations [N tokens][64 K] bf16 are shared by
//    both: the ring carries 6 KB of activations (N = 48) beside 16 KB of
//    weights, and each CTA loads each activation step once per tile;
//  - the weights are wgmma's A operand from registers: ldmatrix.trans
//    of the swizzled int8 box gives a lane four bytes W[k, k + 1][c, c +
//    1], which the byte-permute conversion (rtt::int8x8_to_bf16) turns
//    into bf16 fragments in place (no bf16 copy is written back); so a
//    warp's 16 accumulator rows are the columns 2g and 2g + 1 of its
//    16-column slice, an order the epilogue follows.  The tokens are N,
//    the real count rounded up to 8 (m64nNk16);
//  - a tile shared by several CTAs is summed in a fixed order: each puts
//    its f32 accumulators (in their register layout) in a slot of its
//    own, and the last to arrive (an atomic count per tile in the call's
//    workspace, zeroed by the chain's first norm and reset by that CTA
//    for the next projection) adds the slots in CTA order and runs the
//    epilogue: deterministic.

constexpr int D_BOX = 64 * 128;  // one [64 K][128 columns] int8 box
constexpr int D_MAX_STAGES = 12;

struct DArgs {
  Proj pj;
  int rows, K, mode;
  int ocols;   // columns of an output row (SWIGLU: M)
  int tiles;   // column tiles of 256 columns (SWIGLU: 128 gate/up pairs)
  const void* resid;
  float* out_f;
  __nv_bfloat16* out_t;
  float* part;    // [grid][2 slots][NT / 4][256 threads] float4 partials
  int* counters;  // [tiles]
  // EPI_QKV: RoPE tables [rows][64] and the fresh k/v outputs.
  const float* sin;
  const float* cos;
  int H, KVH;
  __nv_bfloat16* k_new;
  __nv_bfloat16* v_new;
};

// The CTA whose share of U units (cut into G) holds unit u.
__device__ __forceinline__ int cta_of(long long u, long long U, int G) {
  return (int)(((u + 1) * G + U - 1) / U) - 1;
}
__device__ __forceinline__ int unit_start(int cta, long long U, int G) {
  return (int)((long long)cta * U / G);
}

template <int NT>
__global__ void __launch_bounds__(W_THREADS, 1) proj_decode(
    const __grid_constant__ CUtensorMap tm_x,
    const __grid_constant__ CUtensorMap tm_w0,
    const __grid_constant__ CUtensorMap tm_w1,
    const __grid_constant__ CUtensorMap tm_w2, const DArgs a) {
  constexpr uint32_t X = NT * 128;  // a step's activations
  constexpr uint32_t STAGE = 2 * D_BOX + X;
  constexpr int NA = NT / 2;        // accumulators of one m64 tile
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * D_MAX_STAGES];
  __shared__ int fixer;
  const uint32_t sbase = hp::smem_u32(smem_raw);
  const uint32_t base = (sbase + 1023u) & ~1023u;
  const int ST = a.pj.stages;
  float* xch = reinterpret_cast<float*>(smem_raw + (base - sbase) +
                                        ST * STAGE);  // [NT][128]
  const int tid = threadIdx.x, wg = tid / hp::WG_THREADS;
  const int warp = (tid / 32) & 3, lane = tid & 31;
  const int G = gridDim.x, cta = blockIdx.x;
  const int ks_per_tile = a.K / 64;
  const long long U = (long long)a.tiles * ks_per_tile;
  const int u0 = unit_start(cta, U, G), n = unit_start(cta + 1, U, G) - u0;
  const bool swiglu = a.mode == EPI_SWIGLU;
  const uint32_t bar0 = hp::smem_u32(bars);
  auto full = [&](int s) { return bar0 + 8u * s; };
  auto empty = [&](int s) { return bar0 + 8u * (D_MAX_STAGES + s); };
  auto stage = [&](int s) { return base + s * STAGE; };

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      hp::mbar_init(full(s), 1);
      hp::mbar_init(empty(s), 8);  // lane 0 of each consumer warp
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    hp::setmaxnreg_dec<40>();
    if (warp == 0 && lane == 0) {
      for (int i = 0; i < n; ++i) {
        const int u = u0 + i, s = i % ST, tile = u / ks_per_tile;
        const int k = 64 * (u % ks_per_tile);
        if (i >= ST) hp::mbar_wait(empty(s), ((i / ST) & 1) ^ 1);
        hp::mbar_expect_tx(full(s), STAGE);
        for (int w = 0; w < 2; ++w) {
          int c = swiglu ? w * a.ocols + 128 * tile : 256 * tile + 128 * w;
          int seg = 0;
          while (seg + 1 < a.pj.nseg && c >= a.pj.seg[seg].cols)
            c -= a.pj.seg[seg++].cols;
          const CUtensorMap* m = seg == 0 ? &tm_w0 : seg == 1 ? &tm_w1 : &tm_w2;
          hp::tma_load_2d(stage(s) + w * D_BOX, m, full(s), c, k);
        }
        hp::tma_load_2d(stage(s) + 2 * D_BOX, &tm_x, full(s), k, 0);
      }
    }
    return;
  }

  hp::setmaxnreg_inc<232>();
  const int w = wg - 1, ct = tid - hp::WG_THREADS;  // ct: 0 .. 255
  const int g = lane >> 2, tq = lane & 3;
  float acc[2][NA];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NA; ++j) acc[m][j] = 0.f;

  // A fragments of the four k16 steps of stage s: ldmatrix.trans of the
  // swizzled int8 box, matrices (m-tile 0, k 0-7), (0, k 8-15), (1, k
  // 0-7), (1, k 8-15); lane (g, tq) gets W[k0 + 2tq, + 1][c0 + 2g, + 1].
  auto fragments = [&](int s, uint32_t (&af)[4][2][4]) {
    const uint32_t wb = stage(s) + w * D_BOX;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int q = lane >> 3;
      const int kr = 16 * kk + 8 * (q & 1) + (lane & 7);
      const int chunk = 4 * (q >> 1) + warp;
      uint32_t v[4];
      hp::ldsm_x4_t(wb + kr * 128 + ((chunk ^ (kr & 7)) << 4), v);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        // bytes (W[k][c], W[k][c+1], W[k+1][c], W[k+1][c+1]) -> row c's
        // pair (k, k+1) and row c+1's pair.
        const uint4 f = rtt::int8x8_to_bf16(__byte_perm(v[2 * m], 0, 0x3120),
                                            __byte_perm(v[2 * m + 1], 0,
                                                        0x3120));
        af[kk][m][0] = f.x;
        af[kk][m][1] = f.y;
        af[kk][m][2] = f.z;
        af[kk][m][3] = f.w;
      }
    }
  };
  // Stage i's products, then the tile's finish where stage i ends one.
  // (Converting stage i + 1's fragments while stage i's products run, with
  // a second fragment set, ran slower on the H100.)
  uint32_t af[4][2][4];
  auto step = [&](int i) {
    const int u = u0 + i, s = i % ST, tile = u / ks_per_tile;
    hp::mbar_wait(full(s), (i / ST) & 1);
    fragments(s, af);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = hp::desc_sw128(stage(s) + 2 * D_BOX + kk * 32, 16,
                                         1024);
      hp::wgmma_rsk<NT>(acc[0], af[kk][0], db);
      hp::wgmma_rsk<NT>(acc[1], af[kk][1], db);
    }
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_operand(acc[0]);
    hp::fence_operand(acc[1]);
    if (lane == 0) hp::mbar_arrive(empty(s));
    if ((u + 1) % ks_per_tile != 0 && i + 1 < n) return;
    // The CTA's share of this tile is summed.  Shared with other CTAs:
    // park it in this CTA's slot; the last to arrive sums every slot in
    // CTA order.
    const int lo = cta_of((long long)tile * ks_per_tile, U, G);
    const int hi = cta_of((long long)(tile + 1) * ks_per_tile - 1, U, G);
    if (lo != hi) {
      auto slot_of = [&](int c) {
        return unit_start(c, U, G) / ks_per_tile == tile ? 0 : 1;
      };
      // A slot is [NT / 4][256 threads] float4: each warp access is 512
      // contiguous bytes.
      float4* mine = reinterpret_cast<float4*>(a.part) +
                     ((size_t)cta * 2 + slot_of(cta)) * 64 * NT + ct;
#pragma unroll
      for (int f = 0; f < NT / 4; ++f) {
        const int m = f / (NA / 4), j = 4 * (f % (NA / 4));
        mine[f * 256] = make_float4(acc[m][j], acc[m][j + 1], acc[m][j + 2],
                                    acc[m][j + 3]);
      }
      __threadfence();
      named_sync(1, 2 * hp::WG_THREADS);
      if (ct == 0) {
        const int last = atomicAdd(a.counters + tile, 1) == hi - lo;
        if (last) a.counters[tile] = 0;  // ready for the next launch
        fixer = last;
      }
      named_sync(1, 2 * hp::WG_THREADS);
      const bool fix = fixer;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < NA; ++j) acc[m][j] = 0.f;
      if (!fix) return;
      __threadfence();
      // The slots in CTA order (a slot's loads all in flight together;
      // two slots at once would spill at NT 64).
      for (int c = lo; c <= hi; ++c) {
        const float4* src = reinterpret_cast<const float4*>(a.part) +
                            ((size_t)c * 2 + slot_of(c)) * 64 * NT + ct;
        float4 v[NT / 4];
#pragma unroll
        for (int f = 0; f < NT / 4; ++f) v[f] = __ldcg(src + f * 256);
#pragma unroll
        for (int f = 0; f < NT / 4; ++f) {
          const int m = f / (NA / 4), j = 4 * (f % (NA / 4));
          acc[m][j] += v[f].x;
          acc[m][j + 1] += v[f].y;
          acc[m][j + 2] += v[f].z;
          acc[m][j + 3] += v[f].w;
        }
      }
    }

    // Epilogue.  Accumulator j = 4 i + e of m-tile m is token 8 i + 2 tq
    // + (e & 1) and box column 64 m + 16 warp + 2 g + (e >> 1).  Every
    // global load (residual, RoPE table) is issued before any store: a
    // load after a store that may alias it waits for the store.
    if (swiglu && w == 1) {  // the up half goes to the gate warpgroup
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < NA; ++j)
          xch[(m * NA + j) * hp::WG_THREADS + ct - hp::WG_THREADS] =
              acc[m][j];
    }
    if (swiglu) named_sync(1, 2 * hp::WG_THREADS);
    if (!swiglu || w == 0) {
      const int col0 = swiglu ? 128 * tile : 256 * tile + 128 * w;
      const int d = 16 * warp + 2 * g;  // this lane's column pair in a box half
      if (a.mode == EPI_QKV) {
        // head_dim 128 = one box: m-tile 0 holds dims d, d + 1 of the
        // head and m-tile 1 dims d + 64, d + 65, so RoPE pairs meet here.
        const int head = col0 / 128;
        const bool rope = head < a.H + a.KVH;
        float2 sn[NT / 8][2], cs[NT / 8][2];
#pragma unroll
        for (int i = 0; i < NT / 8; ++i)
#pragma unroll
          for (int par = 0; par < 2; ++par) {
            const int tok = 8 * i + 2 * tq + par;
            sn[i][par] = cs[i][par] = make_float2(0.f, 0.f);
            if (rope && tok < a.rows) {
              sn[i][par] = *reinterpret_cast<const float2*>(
                  a.sin + (size_t)tok * 64 + d);
              cs[i][par] = *reinterpret_cast<const float2*>(
                  a.cos + (size_t)tok * 64 + d);
            }
          }
        const float s0[2] = {seg_scale(a.pj, col0 + d),
                             seg_scale(a.pj, col0 + d + 1)};
        const float s1[2] = {seg_scale(a.pj, col0 + 64 + d),
                             seg_scale(a.pj, col0 + 64 + d + 1)};
#pragma unroll
        for (int i = 0; i < NT / 8; ++i)
#pragma unroll
          for (int par = 0; par < 2; ++par) {
            const int tok = 8 * i + 2 * tq + par;
            if (tok >= a.rows) continue;
            const float sv[2] = {sn[i][par].x, sn[i][par].y};
            const float cv[2] = {cs[i][par].x, cs[i][par].y};
            float o1[2], o2[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float x1 = __fmul_rn(acc[0][4 * i + 2 * e + par], s0[e]);
              const float x2 = __fmul_rn(acc[1][4 * i + 2 * e + par], s1[e]);
              o1[e] = rope ? __fsub_rn(__fmul_rn(x1, cv[e]),
                                       __fmul_rn(x2, sv[e]))
                           : x1;
              o2[e] = rope ? __fadd_rn(__fmul_rn(x2, cv[e]),
                                       __fmul_rn(x1, sv[e]))
                           : x2;
            }
            if (head < a.H) {
              float* q = a.out_f + (size_t)tok * a.ocols + col0 + d;
              *reinterpret_cast<float2*>(q) = make_float2(o1[0], o1[1]);
              *reinterpret_cast<float2*>(q + 64) = make_float2(o2[0], o2[1]);
            } else {
              const bool is_k = head < a.H + a.KVH;
              __nv_bfloat16* dst =
                  (is_k ? a.k_new : a.v_new) +
                  ((size_t)tok * a.KVH + head - a.H - (is_k ? 0 : a.KVH)) *
                      128 + d;
              *reinterpret_cast<__nv_bfloat162*>(dst) =
                  __floats2bfloat162_rn(o1[0], o1[1]);
              *reinterpret_cast<__nv_bfloat162*>(dst + 64) =
                  __floats2bfloat162_rn(o2[0], o2[1]);
            }
          }
      } else {
        // The column scales, then an m-tile's residuals (x bf16 for
        // RESID, h f32 for OUT) or up halves, all before its first store.
        float sy[2][2], su[2][2];
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = col0 + 64 * m + d + e;
            sy[m][e] = seg_scale(a.pj, c);
            su[m][e] = swiglu ? seg_scale(a.pj, a.ocols + c) : 1.f;
          }
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int c = col0 + 64 * m + d;
          float2 r[NT / 8][2];
#pragma unroll
          for (int i = 0; i < NT / 8; ++i)
#pragma unroll
            for (int par = 0; par < 2; ++par) {
              const int tok = 8 * i + 2 * tq + par;
              const size_t idx = (size_t)tok * a.ocols + c;
              float2 v = make_float2(0.f, 0.f);
              if (swiglu) {
                v = make_float2(
                    xch[(m * NA + 4 * i + par) * hp::WG_THREADS + ct],
                    xch[(m * NA + 4 * i + 2 + par) * hp::WG_THREADS + ct]);
              } else if (tok < a.rows && a.mode == EPI_RESID) {
                v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                    static_cast<const __nv_bfloat16*>(a.resid) + idx));
              } else if (tok < a.rows && a.mode == EPI_OUT) {
                v = *reinterpret_cast<const float2*>(
                    static_cast<const float*>(a.resid) + idx);
              }
              r[i][par] = v;
            }
#pragma unroll
          for (int i = 0; i < NT / 8; ++i)
#pragma unroll
            for (int par = 0; par < 2; ++par) {
              const int tok = 8 * i + 2 * tq + par;
              if (tok >= a.rows) continue;
              const size_t idx = (size_t)tok * a.ocols + c;
              const float2 rv = r[i][par];
              const float y0 = epilogue_value<true>(
                  a.mode, acc[m][4 * i + par], rv.x, sy[m][0], su[m][0], rv.x);
              const float y1 = epilogue_value<true>(
                  a.mode, acc[m][4 * i + 2 + par], rv.y, sy[m][1], su[m][1],
                  rv.y);
              if (a.mode == EPI_STORE || a.mode == EPI_RESID)
                *reinterpret_cast<float2*>(a.out_f + idx) = make_float2(y0, y1);
              else
                *reinterpret_cast<__nv_bfloat162*>(a.out_t + idx) =
                    __floats2bfloat162_rn(y0, y1);
            }
        }
      }
    }
    if (swiglu) named_sync(1, 2 * hp::WG_THREADS);  // xch is free again
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < NA; ++j) acc[m][j] = 0.f;
  };
  for (int i = 0; i < n; ++i) step(i);
}

// Maps of the DECODE route: the activations [rows, K] bf16 in boxes of 64
// K x NT tokens, each int8 weight segment [K, cols] in boxes of 128
// columns x 64 K rows, both in the 128-byte swizzle.
inline int decode_maps(const __nv_bfloat16* a, int rows, int K,
                       const Proj& pj, CUtensorMap* tx, CUtensorMap* tw) {
  {
    const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
    const cuuint32_t box[2] = {64, (cuuint32_t)pj.nw};
    const int err = hp::encode_map(tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                   a, dims, strides, box,
                                   CU_TENSOR_MAP_SWIZZLE_128B);
    if (err) return err;
  }
  for (int s = 0; s < pj.nseg; ++s) {
    const cuuint64_t dims[2] = {(cuuint64_t)pj.seg[s].cols, (cuuint64_t)K};
    const cuuint64_t strides[1] = {(cuuint64_t)pj.seg[s].cols};
    const cuuint32_t box[2] = {128, 64};
    const int err = hp::encode_map(tw + s, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                                   pj.seg[s].w, dims, strides, box,
                                   CU_TENSOR_MAP_SWIZZLE_128B);
    if (err) return err;
  }
  return 0;
}

template <int NT>
int launch_decode_t(const CUtensorMap& tx, const CUtensorMap* tw,
                    const DArgs& d, cudaStream_t st) {
  auto kernel = proj_decode<NT>;
  const size_t smem = (size_t)d.pj.stages * (2 * D_BOX + NT * 128) +
                      (size_t)NT * 128 * 4 + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  proj_decode<NT><<<d.pj.splits, W_THREADS, smem, st>>>(tx, tw[0], tw[1],
                                                        tw[2], d);
  return (int)cudaGetLastError();
}

// a [rows, K] bf16 -> the projection with its epilogue, in one launch.
inline int launch_decode(const __nv_bfloat16* a, int rows, int K,
                         const Proj& pj, int mode, const void* resid,
                         float* out_f, __nv_bfloat16* out_t, float* part,
                         const LayerArgs& A, cudaStream_t st) {
  if (pj.stages < 2 || pj.stages > D_MAX_STAGES || pj.splits < 1 ||
      pj.nw < 8 || pj.nw > 64 || pj.nw % 8 || K % 64 || rows > pj.nw)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw[MAX_SEGS] = {};
  int err = decode_maps(a, rows, K, pj, &tx, tw);
  if (err) return err;
  const bool swiglu = mode == EPI_SWIGLU;
  DArgs d{pj, rows, K, mode, swiglu ? pj.cols / 2 : pj.cols,
          pj.cols / 256, resid, out_f, out_t, part,
          A.counters, A.sin, A.cos, A.H, A.KVH,
          static_cast<__nv_bfloat16*>(A.k_new),
          static_cast<__nv_bfloat16*>(A.v_new)};
  switch (pj.nw) {
    case 8: return launch_decode_t<8>(tx, tw, d, st);
    case 16: return launch_decode_t<16>(tx, tw, d, st);
    case 24: return launch_decode_t<24>(tx, tw, d, st);
    case 32: return launch_decode_t<32>(tx, tw, d, st);
    case 40: return launch_decode_t<40>(tx, tw, d, st);
    case 48: return launch_decode_t<48>(tx, tw, d, st);
    case 56: return launch_decode_t<56>(tx, tw, d, st);
    default: return launch_decode_t<64>(tx, tw, d, st);
  }
}

// a [rows, K] in TA -> the projection's epilogue.
template <typename TA>
int project(const TA* a, int rows, int K, const Proj& pj, float* part,
            int mode, const void* resid, float* out_f, TA* out_t,
            const LayerArgs& A, cudaStream_t st) {
  if constexpr (std::is_same<TA, __nv_bfloat16>::value) {
    if (pj.route == WGMMA)
      return launch_wgmma(a, rows, K, pj, mode, resid, out_f, out_t, st);
    if (pj.route == DECODE)
      return launch_decode(a, rows, K, pj, mode, resid, out_f, out_t, part,
                           A, st);
  }
  int err;
  if (pj.wtype == F32)
    err = launch_gemv<TA, float>(a, rows, K, pj, part, st);
  else if (pj.wtype == BF16)
    err = launch_gemv<TA, __nv_bfloat16>(a, rows, K, pj, part, st);
  else
    err = launch_gemv<TA, int8_t>(a, rows, K, pj, part, st);
  if (err) return err;
  const size_t n = (size_t)rows * (mode == EPI_SWIGLU ? pj.cols / 2 : pj.cols);
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  epilogue_kernel<TA><<<blocks, 256, 0, st>>>(
      part, rows, pj, split_count(K, pj.splits), mode, resid, out_f, out_t);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// RoPE: q heads rotated in place in qkv (f32); k heads rotated and v heads
// copied into k_new / v_new [rows, KVH, hd], rounded to TA.
// ---------------------------------------------------------------------------

template <typename TA>
__global__ void rope_kernel(float* __restrict__ qkv, int rows, int H, int KVH,
                            int hd, const float* __restrict__ sin,
                            const float* __restrict__ cos,
                            TA* __restrict__ k_new, TA* __restrict__ v_new) {
  const int half = hd / 2;
  const int heads = H + 2 * KVH;
  const size_t n = (size_t)rows * heads * half;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int i = (int)(idx % half);
    const int hh = (int)((idx / half) % heads);
    const size_t row = idx / ((size_t)half * heads);
    float* base = qkv + (row * heads + hh) * hd;
    const float x1 = base[i], x2 = base[i + half];
    if (hh >= H + KVH) {
      TA* dst = v_new + (row * KVH + (hh - H - KVH)) * hd;
      dst[i] = from_float<TA>(x1);
      dst[i + half] = from_float<TA>(x2);
      continue;
    }
    const float s = sin[row * half + i], c = cos[row * half + i];
    const float o1 = __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s));
    const float o2 = __fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s));
    if (hh < H) {
      base[i] = o1;
      base[i + half] = o2;
    } else {
      TA* dst = k_new + (row * KVH + (hh - H)) * hd;
      dst[i] = from_float<TA>(o1);
      dst[i + half] = from_float<TA>(o2);
    }
  }
}

inline int grid_for(size_t n) {
  const size_t b = (n + 255) / 256;
  return (int)(b < 8192 ? (b == 0 ? 1 : b) : 8192);
}

// The RMSNorm kernel, one CTA a row; it zeroes zero[0, nzero) too.
template <typename TA>
int launch_norm(const void* x, int x_type, const LayerArgs& A, const void* ln,
                TA* out, int* zero, int nzero, cudaStream_t st) {
  const bool vec = A.D % (8 * NORM_THREADS) == 0 &&
                   A.D <= 32 * NORM_THREADS && x_type != I8 &&
                   A.ln_type != I8;
  if (vec)
    rmsnorm_kernel<TA, true><<<A.rows, NORM_THREADS, 0, st>>>(
        x, x_type, ln, A.ln_type, A.D, A.eps, out, zero, nzero);
  else
    rmsnorm_kernel<TA, false><<<A.rows, NORM_THREADS, 0, st>>>(
        x, x_type, ln, A.ln_type, A.D, A.eps, out, zero, nzero);
  return (int)cudaGetLastError();
}

// The arrival counts the chain's DECODE projections use: one per column
// tile of the widest (0 when none takes the route).
inline int decode_tiles(const LayerArgs& A) {
  const Proj* projs[] = {&A.qkv, &A.wo, &A.gateup, &A.down};
  int n = 0;
  for (const Proj* p : projs)
    if (p->route == DECODE && p->cols / 256 > n) n = p->cols / 256;
  return n;
}

// Phase 1 and the RoPE of phase 2 (folded into the projection's epilogue
// on the DECODE route at head_dim 128).
template <typename TA>
int run_qkv(const LayerArgs& A, cudaStream_t st) {
  TA* xn = static_cast<TA*>(A.xn);
  int err = launch_norm<TA>(A.x, A.act_type, A, A.ln_a, xn, A.counters,
                            decode_tiles(A), st);
  if (err) return err;
  const bool fold = A.qkv.route == DECODE && A.hd == 128;
  err = project<TA>(xn, A.rows, A.D, A.qkv, A.part,
                    fold ? EPI_QKV : EPI_STORE, nullptr, A.qkv_buf, nullptr,
                    A, st);
  if (err || fold) return err;
  const size_t n = (size_t)A.rows * (A.H + 2 * A.KVH) * (A.hd / 2);
  rope_kernel<TA><<<grid_for(n), 256, 0, st>>>(
      A.qkv_buf, A.rows, A.H, A.KVH, A.hd, A.sin, A.cos,
      static_cast<TA*>(A.k_new), static_cast<TA*>(A.v_new));
  return (int)cudaGetLastError();
}

// Phases 3-5: o-proj + residual, RMSNorm, gate/up + SiLU, down + residual.
template <typename TA>
int run_mlp(const LayerArgs& A, cudaStream_t st) {
  TA* xn = static_cast<TA*>(A.xn);
  TA* act = static_cast<TA*>(A.act);
  int err = project<TA>(static_cast<const TA*>(A.ao), A.rows, A.H * A.hd,
                        A.wo, A.part, EPI_RESID, A.x, A.h, nullptr, A, st);
  if (err) return err;
  err = launch_norm<TA>(A.h, F32, A, A.ln_m, xn, nullptr, 0, st);
  if (err) return err;
  err = project<TA>(xn, A.rows, A.D, A.gateup, A.part, EPI_SWIGLU, nullptr,
                    nullptr, act, A, st);
  if (err) return err;
  return project<TA>(act, A.rows, A.M, A.down, A.part, EPI_OUT, A.h,
                     nullptr, static_cast<TA*>(A.x_out), A, st);
}

}  // namespace fused
}  // namespace rtt
