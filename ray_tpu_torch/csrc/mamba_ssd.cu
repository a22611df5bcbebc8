// K12 — the Mamba-2 SSD chunk scan (forward).
//
// Replaces ray_tpu/ops/mamba_ssd.py _ssd_pallas_fwd_impl (Pallas body
// _ssd_kernel, pallas_call at :113).  Inputs x [B, S, H, P] f32 (already
// scaled by dt), log_a [B, S, H] f32 <= 0, Bm/Cm [B, S, N] f32 or bf16
// (shared by the heads), all contiguous; output y [B, S, H, P] f32 of
//   h[t] = exp(log_a[t]) h[t-1] + B[t] x[t],   y[t] = C[t] . h[t].
// Per block of T positions (cum = inclusive prefix sum of log_a in the
// block, total = its last value):
//   y     = (C.B^T o exp(cum_i - cum_j), j <= i) . x + exp(cum) o (C . state)
//   state = exp(total) state + (B o exp(total - cum))^T . x
//
// What bounds it on the H100: operations.  Per head and position it does
// about 2 (T/2 + 2N) P multiply-adds against 4 P bytes of x and y, far
// above the ~20 flop/byte ridge of f32 CUDA-core work (67 TFLOP/s over
// 3.35 TB/s).  Everything stays in f32 on the CUDA cores, as the Pallas
// body keeps f32 dots: TF32 tensor cores keep about three digits.
//
// Design.  The TPU kernel holds every head's f32 state [H*N, P] in VMEM
// (2.6 MB at Mamba-2 2.7B) and walks the chunks in its sequential grid
// axis.  Here the grid is split instead: heads are independent apart
// from sharing B and C, and column p of a head's state reads only column
// p of x, so one CTA owns one (batch, head, slice of P_TILE columns) with
// its [N, P_TILE] state in shared memory and walks the sequence in a loop.
// The chunk does not change the output except through rounding, and the
// 256 chunk's C.B^T alone would be 256 KB, so the walk goes in blocks of
// T = 64 positions whatever the chunk; a last partial block reads zeros
// past S.  C.B^T is shared by the heads, so a first kernel computes it once
// per (batch, block) into a scratch [B, nblk, T, T] that the scan CTAs read
// from L2.  The scan builds the masked decay matrix only for j <= i (above
// the diagonal cum_i - cum_j > 0 and exp would overflow), so exp(cum) may
// underflow to 0 only for the same positions as on the TPU.  Each thread
// owns a 4-column strip of P_TILE/16 rows of y and of the state update
// (float4 shared-memory reads, rows padded so a warp's rows fall in
// different banks).
#include "common.cuh"

namespace {

constexpr int T = 64;  // positions per block of the walk
constexpr int THREADS = 256;
constexpr int WS = T + 4;  // padded row stride of the decay matrix

// Rows t of Bm or Cm (zero past S), converted to f32 and scaled by
// scale[t] when given, into dst [T][N + 4].
template <typename TB>
__device__ __forceinline__ void load_rows(const TB* __restrict__ src,
                                          float* dst, const float* scale,
                                          int b, int t0, int S, int N) {
  constexpr int V = rtt::Vec<TB>::N;
  const int vecs = N / V, ns = N + 4;
  for (int e = threadIdx.x; e < T * vecs; e += THREADS) {
    const int t = e / vecs, n = (e % vecs) * V;
    float v[V];
    if (t0 + t < S) {
      rtt::Vec<TB>::load(src + ((size_t)b * S + t0 + t) * N + n, v);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] = 0.f;
    }
    const float s = scale ? scale[t] : 1.f;
#pragma unroll
    for (int k = 0; k < V; ++k) dst[t * ns + n + k] = v[k] * s;
  }
}

template <int R>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (R == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else if constexpr (R == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  } else {
    out[0] = p[0];
  }
}

__device__ __forceinline__ void fma4(float* acc, float a, const float4& v) {
  acc[0] = fmaf(a, v.x, acc[0]);
  acc[1] = fmaf(a, v.y, acc[1]);
  acc[2] = fmaf(a, v.z, acc[2]);
  acc[3] = fmaf(a, v.w, acc[3]);
}

// G[b, blk] = C.B^T of one block of T positions, f32.  One CTA per
// (block, batch); a thread owns rows 4 ti .. 4 ti + 3 and columns
// tj + 16 c, so the B rows a warp reads are consecutive.
template <typename TB>
__global__ void __launch_bounds__(THREADS) ssd_scores_kernel(
    const TB* __restrict__ Bm, const TB* __restrict__ Cm,
    float* __restrict__ G, int S, int N) {
  extern __shared__ float4 smem4[];
  float* Cs = reinterpret_cast<float*>(smem4);  // [T][N + 4]
  float* Bs = Cs + T * (N + 4);                 // [T][N + 4]
  const int blk = blockIdx.x, b = blockIdx.y, t0 = blk * T;
  load_rows<TB>(Cm, Cs, nullptr, b, t0, S, N);
  load_rows<TB>(Bm, Bs, nullptr, b, t0, S, N);
  __syncthreads();
  const int ti = threadIdx.x / 16, tj = threadIdx.x % 16, ns = N + 4;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  for (int n = 0; n < N; n += 4) {
    float4 cr[4], br[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      cr[r] = *reinterpret_cast<const float4*>(Cs + (ti * 4 + r) * ns + n);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      br[c] = *reinterpret_cast<const float4*>(Bs + (tj + 16 * c) * ns + n);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float a = acc[r][c];
        a = fmaf(cr[r].x, br[c].x, a);
        a = fmaf(cr[r].y, br[c].y, a);
        a = fmaf(cr[r].z, br[c].z, a);
        a = fmaf(cr[r].w, br[c].w, a);
        acc[r][c] = a;
      }
  }
  float* g = G + ((size_t)b * gridDim.x + blk) * T * T;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) g[(ti * 4 + r) * T + tj + 16 * c] = acc[r][c];
}

// The scan: one CTA per (slice of P_TILE columns, head, batch).
template <int PT, typename TB>
__global__ void __launch_bounds__(THREADS) ssd_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ log_a,
    const TB* __restrict__ Bm, const TB* __restrict__ Cm,
    const float* __restrict__ G, float* __restrict__ y, int S, int H, int P,
    int N) {
  constexpr int TX = PT / 4;   // 4-column strips
  constexpr int R = PT / 16;   // rows a thread owns in y and in the state
  static_assert(T / R * TX == THREADS, "one y strip per thread");
  extern __shared__ float4 smem4[];
  const int ns = N + 4;
  float* xs = reinterpret_cast<float*>(smem4);  // [T][PT]
  float* cb = xs + T * PT;                       // [T][N+4]: C, then B o dte
  float* ws = cb + T * ns;                      // [T][T+4]: decay matrix
  float* st = ws + T * WS;                      // [N][PT] state
  float* cum = st + N * PT;                     // [T]
  float* ecum = cum + T;                        // [T] exp(cum)
  float* dte = ecum + T;                        // [T] exp(total - cum)
  float* decay = dte + T;                       // [1] exp(total)

  const int p0 = blockIdx.x * PT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int nblk = (S + T - 1) / T;
  for (int e = tid; e < N * PT; e += THREADS) st[e] = 0.f;

  for (int blk = 0; blk < nblk; ++blk) {
    const int t0 = blk * T;
    __syncthreads();  // the last block's state update is done with xs, cb
    for (int e = tid; e < T * TX; e += THREADS) {
      const int t = e / TX, c = (e % TX) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t0 + t < S)
        v = *reinterpret_cast<const float4*>(
            x + (((size_t)b * S + t0 + t) * H + h) * P + p0 + c);
      *reinterpret_cast<float4*>(xs + t * PT + c) = v;
    }
    load_rows<TB>(Cm, cb, nullptr, b, t0, S, N);
    const float* g = G + ((size_t)b * nblk + blk) * T * T;
    for (int e = tid; e < T * T / 4; e += THREADS) {
      const int i = e / (T / 4), j = (e % (T / 4)) * 4;
      *reinterpret_cast<float4*>(ws + i * WS + j) =
          *reinterpret_cast<const float4*>(g + i * T + j);
    }
    if (tid < T)
      cum[tid] = t0 + tid < S ? log_a[((size_t)b * S + t0 + tid) * H + h]
                              : 0.f;
    __syncthreads();

    if (tid < 32) {  // inclusive prefix sum of the block's log decays
      const float a0 = cum[2 * tid], a1 = cum[2 * tid + 1];
      float inc = a0 + a1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, inc, o);
        if (tid >= o) inc += v;
      }
      float ex = __shfl_up_sync(0xffffffffu, inc, 1);
      if (tid == 0) ex = 0.f;
      const float c0 = ex + a0, c1 = c0 + a1;
      const float total = __shfl_sync(0xffffffffu, c1, 31);
      cum[2 * tid] = c0;
      cum[2 * tid + 1] = c1;
      ecum[2 * tid] = expf(c0);
      ecum[2 * tid + 1] = expf(c1);
      dte[2 * tid] = expf(total - c0);
      dte[2 * tid + 1] = expf(total - c1);
      if (tid == 0) decay[0] = expf(total);
    }
    __syncthreads();
    for (int e = tid; e < T * T; e += THREADS) {
      const int i = e / T, j = e % T;
      float* w = ws + i * WS + j;
      *w = j <= i ? *w * expf(cum[i] - cum[j]) : 0.f;
    }
    __syncthreads();

    {  // y strip: rows i0 .. i0 + R - 1, columns pc .. pc + 3
      const int pc = (tid % TX) * 4, i0 = (tid / TX) * R;
      float aw[R][4], ac[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) aw[r][k] = ac[r][k] = 0.f;
      const int jend = min(T, (i0 + R + 3) & ~3);  // the matrix is 0 above
      for (int j = 0; j < jend; j += 4) {
        float4 xr[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          xr[k] = *reinterpret_cast<const float4*>(xs + (j + k) * PT + pc);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 w =
              *reinterpret_cast<const float4*>(ws + (i0 + r) * WS + j);
          fma4(aw[r], w.x, xr[0]);
          fma4(aw[r], w.y, xr[1]);
          fma4(aw[r], w.z, xr[2]);
          fma4(aw[r], w.w, xr[3]);
        }
      }
      for (int n = 0; n < N; n += 4) {
        float4 sr[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          sr[k] = *reinterpret_cast<const float4*>(st + (n + k) * PT + pc);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 c =
              *reinterpret_cast<const float4*>(cb + (i0 + r) * ns + n);
          fma4(ac[r], c.x, sr[0]);
          fma4(ac[r], c.y, sr[1]);
          fma4(ac[r], c.z, sr[2]);
          fma4(ac[r], c.w, sr[3]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = i0 + r;
        if (t0 + i < S) {
          const float e = ecum[i];
          *reinterpret_cast<float4*>(
              y + (((size_t)b * S + t0 + i) * H + h) * P + p0 + pc) =
              make_float4(aw[r][0] + e * ac[r][0], aw[r][1] + e * ac[r][1],
                          aw[r][2] + e * ac[r][2], aw[r][3] + e * ac[r][3]);
        }
      }
    }
    __syncthreads();  // every y strip has read the state and C
    load_rows<TB>(Bm, cb, dte, b, t0, S, N);
    __syncthreads();

    const float dk = decay[0];
    for (int tile = tid; tile < (N / R) * TX; tile += THREADS) {
      const int pc = (tile % TX) * 4, n0 = (tile / TX) * R;
      float acc[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[r][k] = 0.f;
      for (int j = 0; j < T; ++j) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + j * PT + pc);
        float bv[R];
        load_vec<R>(cb + j * ns + n0, bv);
#pragma unroll
        for (int r = 0; r < R; ++r) fma4(acc[r], bv[r], xv);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float4* sp = reinterpret_cast<float4*>(st + (n0 + r) * PT + pc);
        float4 s = *sp;
        s.x = dk * s.x + acc[r][0];
        s.y = dk * s.y + acc[r][1];
        s.z = dk * s.z + acc[r][2];
        s.w = dk * s.w + acc[r][3];
        *sp = s;
      }
    }
  }
}

template <int PT, typename TB>
int launch_scan(const float* x, const float* log_a, const TB* Bm,
                const TB* Cm, const float* G, float* y, int B, int S, int H,
                int P, int N, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)T * PT + (size_t)T * (N + 4) +
                                       (size_t)T * WS + (size_t)N * PT +
                                       3 * T + 4);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<PT, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<PT, TB><<<dim3(P / PT, H, B), THREADS, smem, stream>>>(
      x, log_a, Bm, Cm, G, y, S, H, P, N);
  return (int)cudaGetLastError();
}

template <typename TB>
int launch(const void* x, const void* log_a, const void* Bm, const void* Cm,
           void* scores, void* y, int B, int S, int H, int P, int N,
           int p_tile, cudaStream_t stream) {
  const TB* bm = static_cast<const TB*>(Bm);
  const TB* cm = static_cast<const TB*>(Cm);
  float* g = static_cast<float*>(scores);
  const int nblk = (S + T - 1) / T;
  const size_t smem = sizeof(float) * 2 * (size_t)T * (N + 4);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scores_kernel<TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scores_kernel<TB><<<dim3(nblk, B), THREADS, smem, stream>>>(bm, cm, g,
                                                                   S, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float* xf = static_cast<const float*>(x);
  const float* la = static_cast<const float*>(log_a);
  float* yf = static_cast<float*>(y);
  switch (p_tile) {
    case 32:
      return launch_scan<32, TB>(xf, la, bm, cm, g, yf, B, S, H, P, N, stream);
    case 16:
      return launch_scan<16, TB>(xf, la, bm, cm, g, yf, B, S, H, P, N, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// bc_dtype (of Bm and Cm): 0 = float32, 1 = bfloat16.  scores is scratch
// of [B, ceil(S / 64), 64, 64] f32.  P is a multiple of p_tile (32 or
// 16) and N of 8.
extern "C" int rtt_ssd_scan(const void* x, const void* log_a, const void* Bm,
                            const void* Cm, void* scores, void* y,
                            int bc_dtype, int B, int S, int H, int P, int N,
                            int p_tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bc_dtype == 0)
    return launch<float>(x, log_a, Bm, Cm, scores, y, B, S, H, P, N, p_tile,
                         s);
  return launch<__nv_bfloat16>(x, log_a, Bm, Cm, scores, y, B, S, H, P, N,
                               p_tile, s);
}
