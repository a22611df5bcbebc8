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
//   2. RoPE (q in place, fresh k/v rounded to the activation dtype), then
//      the attention kernel of K7 or K8;
//   3. the o-projection and the residual add;
//   4. RMSNorm, then the gate/up projection and SiLU(gate) * up;
//   5. the down projection and the second residual add.
//
// Phase buffers are f32 (the Pallas kernels' VMEM scratch): xn [rows, D],
// qkv [rows, Cq], ao [rows, H*hd], h [rows, D], act [rows, M], and the
// split-K partial sums of the projections.
//
// Rounding follows the Pallas kernels, not the unfused path: the norm is
// f32 to the end; a projection rounds its f32 activation and its weight
// to the activation dtype (exact for int8 weights), accumulates in f32
// and multiplies the RESULT by the per-column scale; qkv, ao and h stay
// f32; only x_out, k_new and v_new are rounded.
//
// Projections (what bounds them: at decode widths the weight bytes, at
// the ragged step's 264 rows the operations): weights are read in place,
// row-major [K, cols], int8, bf16 or f32, one f32 scale per output column
// (or per column of one head, tiled across heads).  Separate q/k/v or
// gate/up leaves are up to three column segments of one projection, never
// concatenated.  With bf16 activations (the serving dtype) a CTA of 8
// warps owns a 64-row x 128-column output tile on the tensor cores
// (mma.sync m16n8k16, bf16 operands, f32 accumulators), its K steps of
// 32 landing raw in a cp.async ring of shared memory and converted to
// bf16 in the fragments (exact for int8 weights).  With f32
// activations (exact f32 products, as the reference's f32 dots) a CTA of
// 128 threads owns 512 consecutive output columns (4 per thread, so a
// warp's weight loads are consecutive addresses) and 16 activation rows
// held in registers, on the CUDA cores.  Either way the K axis is split
// across CTAs until about two CTAs per SM are in flight, and the partial
// sums go to an f32 buffer that the epilogue kernel sums in a fixed order
// (deterministic) before the scale, the residual or SiLU.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace rtt {
namespace fused {

enum TypeCode { F32 = 0, BF16 = 1, I8 = 2 };
enum Epilogue { EPI_STORE = 0, EPI_RESID = 1, EPI_OUT = 2, EPI_SWIGLU = 3 };

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

struct Proj {
  Seg seg[MAX_SEGS];
  int nseg;
  int wtype;   // TypeCode of every segment's weight
  int cols;    // sum of the segments' cols
  int splits;  // K splits asked for (the plan may take fewer)
  int mma;     // bf16 activations: tensor-core tiles (16-byte aligned rows)
};

// Everything one fused layer call needs (mirrored by a ctypes Structure
// in ray_tpu_torch/ops/fused_decode.py: keep the two in step).
struct LayerArgs {
  int rows, D, H, KVH, hd, M;
  int act_type, ln_type, pool_type;
  int L, P, page, maxp, layer, R, tq;
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
  float* xn;
  float* part;
  float* qkv_buf;
  float* ao;
  float* h;
  float* act;
  void* x_out;
  void* k_new;
  void* v_new;
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
// RMSNorm: out = (x * 1/sqrt(mean(x^2) + eps)) * ln, all f32; one CTA/row
// ---------------------------------------------------------------------------

constexpr int NORM_THREADS = 256;

__global__ void __launch_bounds__(NORM_THREADS) rmsnorm_kernel(
    const void* __restrict__ x, int x_type, const void* __restrict__ ln,
    int ln_type, int D, float eps, float* __restrict__ out) {
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  float ss = 0.f;
  for (int i = threadIdx.x; i < D; i += NORM_THREADS) {
    const float v = load_any(x, x_type, row * D + i);
    ss += v * v;
  }
  ss = block_sum(ss, red);
  const float r = 1.f / sqrtf(ss / (float)D + eps);
  for (int i = threadIdx.x; i < D; i += NORM_THREADS)
    out[row * D + i] =
        __fmul_rn(__fmul_rn(load_any(x, x_type, row * D + i), r),
                  load_any(ln, ln_type, i));
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
    const float* __restrict__ a, int rows, int K, Proj pj, int kps,
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
      const float v = (row < rows && k < k1) ? a[(size_t)row * K + k] : 0.f;
      a_s[kk][r] = round_to<TA>(v);
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

// Tensor-core tiles for bf16 activations.
constexpr int M_THREADS = 256;   // 8 warps: 2 (rows) x 4 (columns)
constexpr int M_ROWS = 64;
constexpr int M_COLS = 128;
constexpr int M_KC = 32;
constexpr int M_STAGES = 3;      // cp.async ring: two K steps in flight
constexpr int M_LDA = M_KC + 8;  // f32 activation row, padded (floats)

// Bytes of one weight row of a stage, padded by 16 so that the B-fragment
// loads of a warp fall in distinct banks or share a word.
template <typename TW>
__host__ __device__ constexpr int m_ldw_bytes() {
  return M_COLS * (int)sizeof(TW) + 16;
}

template <typename TW>
__host__ __device__ constexpr int mma_smem_bytes() {
  return M_STAGES * (M_ROWS * M_LDA * 4 + M_KC * m_ldw_bytes<TW>());
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 fills zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float w_to_float(float x) { return x; }
__device__ __forceinline__ float w_to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float w_to_float(int8_t x) { return (float)x; }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo: low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A 64-row x 128-column output tile on the tensor cores.  Each K step of
// 32 lands raw (f32 activations, int8/bf16/f32 weights) in a 3-stage ring
// of shared memory through cp.async, so two steps' loads are in flight
// while one is multiplied; the fragments convert to bf16 on their way to
// the mma (round to nearest even: the activation's and an f32 weight's
// rounding to the dot dtype; exact for int8 and bf16 weights).
template <typename TW>
__global__ void __launch_bounds__(M_THREADS) mma_part_kernel(
    const float* __restrict__ a, int rows, int K, Proj pj, int kps,
    float* __restrict__ part) {
  extern __shared__ float4 mma_smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(mma_smem4);
  constexpr int LDW = m_ldw_bytes<TW>();
  constexpr int A_BYTES = M_ROWS * M_LDA * 4;
  constexpr int STAGE = A_BYTES + M_KC * LDW;
  constexpr int N = 16 / (int)sizeof(TW);   // weights per 16-byte copy
  constexpr int CPR = M_COLS / N;           // copies per weight row
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp >> 2, wc = warp & 3;
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = blockIdx.x * M_ROWS, c0 = blockIdx.y * M_COLS;
  const int k0 = blockIdx.z * kps;
  const int k1 = min(K, k0 + kps);
  const int nsteps = (k1 - k0 + M_KC - 1) / M_KC;

  auto load_stage = [&](int slot, int kc) {
    float* a_st = reinterpret_cast<float*>(smem + slot * STAGE);
    unsigned char* w_st = smem + slot * STAGE + A_BYTES;
    for (int i = tid; i < M_ROWS * (M_KC / 4); i += M_THREADS) {
      const int r = i / (M_KC / 4), c4 = (i % (M_KC / 4)) * 4;
      const int row = r0 + r, k = kc + c4;
      const bool ok = row < rows && k < k1;
      cp_async16(a_st + r * M_LDA + c4, ok ? a + (size_t)row * K + k : a,
                 ok ? 16 : 0);
    }
    for (int i = tid; i < M_KC * CPR; i += M_THREADS) {
      const int kk = i / CPR, cc = (i % CPR) * N;
      const int k = kc + kk, c = c0 + cc;
      const TW* src = nullptr;
      if (k < k1) {
        for (int s = 0, base = 0; s < pj.nseg; ++s) {
          if (c >= base && c < base + pj.seg[s].cols)
            src = static_cast<const TW*>(pj.seg[s].w) +
                  (size_t)k * pj.seg[s].cols + (c - base);
          base += pj.seg[s].cols;
        }
      }
      cp_async16(w_st + kk * LDW + cc * (int)sizeof(TW),
                 src != nullptr ? (const void*)src : (const void*)a,
                 src != nullptr ? 16 : 0);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

#pragma unroll
  for (int st = 0; st < M_STAGES - 1; ++st) {
    if (st < nsteps) load_stage(st, k0 + st * M_KC);
    cp_async_commit();
  }
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<M_STAGES - 2>();  // this step's stage has landed
    __syncthreads();                // and every warp is done with the last
    const int nxt = step + M_STAGES - 1;
    if (nxt < nsteps) load_stage(nxt % M_STAGES, k0 + nxt * M_KC);
    cp_async_commit();
    const int slot = step % M_STAGES;
    const float* a_st = reinterpret_cast<const float*>(smem + slot * STAGE);
    const TW* w_st = reinterpret_cast<const TW*>(smem + slot * STAGE +
                                                 A_BYTES);
    constexpr int LDWE = LDW / (int)sizeof(TW);  // weight row in elements
#pragma unroll
    for (int ks = 0; ks < M_KC; ks += 16) {
      const int kf = ks + tig * 2;
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float* ar = a_st + (wr * 32 + mi * 16 + gid) * M_LDA + kf;
        const float2 x0 = *reinterpret_cast<const float2*>(ar);
        const float2 x1 = *reinterpret_cast<const float2*>(ar + 8 * M_LDA);
        const float2 x2 = *reinterpret_cast<const float2*>(ar + 8);
        const float2 x3 =
            *reinterpret_cast<const float2*>(ar + 8 * M_LDA + 8);
        af[mi][0] = pack_bf16(x0.x, x0.y);
        af[mi][1] = pack_bf16(x1.x, x1.y);
        af[mi][2] = pack_bf16(x2.x, x2.y);
        af[mi][3] = pack_bf16(x3.x, x3.y);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        // B fragment: rows k = kf, kf + 1 (and + 8) of column col.
        const TW* wcol = w_st + kf * LDWE + wc * 32 + ni * 8 + gid;
        bf[ni][0] = pack_bf16(w_to_float(wcol[0]), w_to_float(wcol[LDWE]));
        bf[ni][1] = pack_bf16(w_to_float(wcol[8 * LDWE]),
                              w_to_float(wcol[9 * LDWE]));
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni]);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int row = r0 + wr * 32 + mi * 16 + gid;
      const int col = c0 + wc * 32 + ni * 8 + tig * 2;
      if (col >= pj.cols) continue;
      float* dst = part + ((size_t)blockIdx.z * rows + row) * pj.cols + col;
      if (row < rows)
        *reinterpret_cast<float2*>(dst) =
            make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      if (row + 8 < rows)
        *reinterpret_cast<float2*>(dst + 8 * (size_t)pj.cols) =
            make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
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

// Sum the splits, then: STORE out = y * scale; RESID out = x + y * scale
// (x in TA); OUT out_t = round(h + y * scale) (h f32); SWIGLU (columns
// [gate | up]) out = silu(g * sg) * (u * su).
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
    float y = 0.f;
    for (int s = 0; s < splits; ++s) y += p[s * plane];
    y = __fmul_rn(y, seg_scale(pj, c));
    if (mode == EPI_STORE) {
      out_f[idx] = y;
    } else if (mode == EPI_RESID) {
      out_f[idx] = to_float(static_cast<const TA*>(resid)[idx]) + y;
    } else if (mode == EPI_OUT) {
      out_t[idx] = from_float<TA>(static_cast<const float*>(resid)[idx] + y);
    } else {
      float u = 0.f;
      for (int s = 0; s < splits; ++s) u += p[s * plane + ocols];
      u = __fmul_rn(u, seg_scale(pj, c + ocols));
      const float sig = 1.f / (1.f + expf(-y));
      out_f[idx] = __fmul_rn(__fmul_rn(y, sig), u);
    }
  }
}

template <typename TA, typename TW>
int launch_gemv(const float* a, int rows, int K, const Proj& pj, float* part,
                cudaStream_t st) {
  const int kps = split_k(K, pj.splits);
  if (std::is_same<TA, __nv_bfloat16>::value && pj.mma) {
    constexpr int smem = mma_smem_bytes<TW>();
    const cudaError_t err = cudaFuncSetAttribute(
        mma_part_kernel<TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((rows + M_ROWS - 1) / M_ROWS,
                    (pj.cols + M_COLS - 1) / M_COLS,
                    split_count(K, pj.splits));
    mma_part_kernel<TW><<<grid, M_THREADS, smem, st>>>(a, rows, K, pj, kps,
                                                       part);
  } else {
    const dim3 grid((rows + G_RT - 1) / G_RT,
                    (pj.cols + G_COLS - 1) / G_COLS,
                    split_count(K, pj.splits));
    gemv_part_kernel<TA, TW><<<grid, G_THREADS, 0, st>>>(a, rows, K, pj, kps,
                                                         part);
  }
  return (int)cudaGetLastError();
}

// a [rows, K] f32 -> the projection's epilogue.
template <typename TA>
int project(const float* a, int rows, int K, const Proj& pj, float* part,
            int mode, const void* resid, float* out_f, TA* out_t,
            cudaStream_t st) {
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

// Phase 1 and the RoPE of phase 2.
template <typename TA>
int run_qkv(const LayerArgs& A, cudaStream_t st) {
  rmsnorm_kernel<<<A.rows, NORM_THREADS, 0, st>>>(A.x, A.act_type, A.ln_a,
                                                  A.ln_type, A.D, A.eps, A.xn);
  int err = (int)cudaGetLastError();
  if (err) return err;
  err = project<TA>(A.xn, A.rows, A.D, A.qkv, A.part, EPI_STORE, nullptr,
                    A.qkv_buf, nullptr, st);
  if (err) return err;
  const size_t n = (size_t)A.rows * (A.H + 2 * A.KVH) * (A.hd / 2);
  rope_kernel<TA><<<grid_for(n), 256, 0, st>>>(
      A.qkv_buf, A.rows, A.H, A.KVH, A.hd, A.sin, A.cos,
      static_cast<TA*>(A.k_new), static_cast<TA*>(A.v_new));
  return (int)cudaGetLastError();
}

// Phases 3-5: o-proj + residual, RMSNorm, gate/up + SiLU, down + residual.
template <typename TA>
int run_mlp(const LayerArgs& A, cudaStream_t st) {
  int err = project<TA>(A.ao, A.rows, A.H * A.hd, A.wo, A.part, EPI_RESID,
                        A.x, A.h, nullptr, st);
  if (err) return err;
  rmsnorm_kernel<<<A.rows, NORM_THREADS, 0, st>>>(A.h, F32, A.ln_m, A.ln_type,
                                                  A.D, A.eps, A.xn);
  err = (int)cudaGetLastError();
  if (err) return err;
  err = project<TA>(A.xn, A.rows, A.D, A.gateup, A.part, EPI_SWIGLU, nullptr,
                    A.act, nullptr, st);
  if (err) return err;
  return project<TA>(A.act, A.rows, A.M, A.down, A.part, EPI_OUT, A.h,
                     nullptr, static_cast<TA*>(A.x_out), st);
}

}  // namespace fused
}  // namespace rtt
