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
//   state = exp(total) state + B^T . (exp(total - cum) o x)
//
// What bounds it on the H100: operations.  Per head and position it does
// about (T/2 + 2N) P multiply-adds against 8 P bytes of x and y.  The
// Pallas body keeps f32 dots, and one TF32 pass keeps about three
// digits, so the four products run on the tensor cores in split
// precision (3xTF32): an f32 operand is hi + lo, hi its TF32 rounding and
// lo the f32 rest, and a.b = hi.hi + hi.lo + lo.hi (lo.lo, about 2^-22 of
// the product, is dropped).  A bf16 operand (B and C in the model) is
// exact in TF32, so C.B^T takes one pass and C.state and the state update
// two.  The bound on this route is the TF32 operations it issues at 495
// TFLOP/s, or the bytes, whichever is larger.
//
// Design.  The TPU kernel holds every head's f32 state in VMEM and walks
// the chunks in its sequential grid axis.  Here one CTA owns one (batch,
// head, slice of PT state columns) and walks the sequence in blocks of
// T = 32 positions (the chunk only changes rounding), its [N, PT] state
// in registers as mma.sync accumulators across the whole walk; a copy in
// shared memory, written once per block, feeds C.state.  PT = 32 gives
// B*H*P/32 CTAs of 8 warps and about 65 KB of shared memory, so three fit
// on an SM and the 2.7B layer's 320 CTAs run in one wave; PT = 16 (4
// warps) doubles the CTAs where that would leave SMs idle.  Each block's
// x, B, C and log_a arrive by cp.async into a second buffer while the
// previous block computes (three __syncthreads a block).  T = 32 is one
// warp: each warp takes the block's prefix sum with shuffles (in base-2
// units, for ex2) and reads cum, exp(cum) and exp(total - cum) from its
// lanes.  The six C.B^T tiles j <= i are computed once a block, one a
// warp (bf16 B/C: on bf16 mma.sync, whose products are exact), masked
// before the exp (above the diagonal cum_i - cum_j > 0, so
// exp(cum) underflows to 0 only where the TPU's does) and scaled in
// registers into the decay matrix, which goes through shared memory to
// the warps of (G o L).x.  Warp w then owns 16 rows and 8 columns of y
// and 16 MT state rows of the same 8 columns.  The k-slots t and t + 4
// of an mma are physical columns 2t and 2t + 1 of an 8-column step, so a
// lane loads both as one 8-byte word (C, the state) and bf16 B^T comes
// from ldmatrix.trans; C.state keeps its hi and lo passes in two
// accumulators (two short dependency chains).  Positions past S load as
// zeros (log_a 0), so a partial last block changes nothing; N is padded
// to NP = 32 MT with zero columns.
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int T = 32;  // positions per block of the walk (one warp)
constexpr unsigned FULL = 0xffffffffu;

namespace hp = rtt::hopper;
using hp::smem_u32;

// 16 (or 4) bytes global -> shared, asynchronously; zeros when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x as TF32 hi (round to nearest) and the f32 rest lo; the mma reads lo's
// top 19 bits.  EXACT: x is already a TF32 value (a bf16), lo unused.
template <bool EXACT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if (EXACT) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
    lo = __float_as_uint(x - __uint_as_float(hi));
  }
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A.B in split precision: the small terms first, then hi.hi.
template <bool AX, bool BX>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  if (!AX) mma_tf32(d, al, bh[0], bh[1]);
  if (!BX) mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

using hp::ex2;
using hp::LOG2E;
constexpr int SW = T + 8;  // row stride of the decay matrix (floats)

// Shared memory of one CTA (bytes); csrc and ops/mamba_ssd.py agree.
__host__ __device__ constexpr int smem_bytes(int PT, int NP, int tb) {
  return 4 * 2 * T * (PT + 4) + 2 * 2 * T * (NP + 8) * tb + 4 * 2 * T +
         4 * PT * (NP + 8) + 4 * T * SW;
}

// One CTA per (slice of PT columns, head, batch); PT / 4 warps.  Warp w
// owns the 8 columns 8 (w >> 1) .. + 7 of the slice: y rows 16 (w & 1)
// .. + 15 of each block, and state rows 16 MT (w & 1) .. + 16 MT - 1.
// Warps 0-5 (or each warp in turn) first compute one C.B^T tile j <= i
// each and store it masked and scaled, the decay matrix, in shared
// memory.
template <int PT, int MT, typename TB>
__global__ void __launch_bounds__(8 * PT, MT <= 4 ? (PT == 32 ? 3 : 4) : 2)
    ssd_kernel(const float* __restrict__ x, const float* __restrict__ log_a,
               const TB* __restrict__ Bm, const TB* __restrict__ Cm,
               float* __restrict__ y, int S, int H, int P, int N) {
  constexpr int NW = PT / 4, THREADS = 32 * NW;
  constexpr int NP = 32 * MT;  // state rows: N padded with zeros
  constexpr int SX = PT + 4;   // x row stride: 2 SX = 8 (mod 32) banks
  constexpr int SB = NP + 8;   // B/C row stride (elements)
  constexpr int SS = NP + 8;   // state [PT][SS] f32, columns major
  constexpr bool EX = std::is_same<TB, __nv_bfloat16>::value;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);        // [2][T][SX]
  TB* cs = reinterpret_cast<TB*>(xs + 2 * T * SX);    // [2][T][SB]
  TB* bs = cs + 2 * T * SB;                           // [2][T][SB]
  float* las = reinterpret_cast<float*>(bs + 2 * T * SB);  // [2][T]
  float* st = las + 2 * T;                            // [PT][SS]
  float* wm = st + PT * SS;                           // [T][SW]

  const int p0 = blockIdx.x * PT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int nblk = (S + T - 1) / T;

  auto issue = [&](int blk, int s) {
    const int t0 = blk * T;
    constexpr int XC = PT / 4;
    for (int e = tid; e < T * XC; e += THREADS) {
      const int r = e / XC, c = (e % XC) * 4;
      const bool ok = t0 + r < S;
      cp_async16(smem_u32(xs + (s * T + r) * SX + c),
                 x + (((size_t)b * S + (ok ? t0 + r : 0)) * H + h) * P + p0 + c,
                 ok);
    }
    constexpr int V = 16 / (int)sizeof(TB), BC = NP / V;
    for (int e = tid; e < T * BC; e += THREADS) {
      const int r = e / BC, c = (e % BC) * V;
      const bool ok = t0 + r < S && c < N;
      const size_t off = ((size_t)b * S + (ok ? t0 + r : 0)) * N + (ok ? c : 0);
      cp_async16(smem_u32(cs + (s * T + r) * SB + c), Cm + off, ok);
      cp_async16(smem_u32(bs + (s * T + r) * SB + c), Bm + off, ok);
    }
    if (tid < T) {
      const bool ok = t0 + tid < S;
      cp_async4(smem_u32(las + s * T + tid),
                log_a + ((size_t)b * S + (ok ? t0 + tid : 0)) * H + h, ok);
    }
    cp_async_commit();
  };

  float sacc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) sacc[m][e] = 0.f;
  for (int e = tid; e < PT * SS; e += THREADS) st[e] = 0.f;
  issue(0, 0);

  const int mi = warp & 1, pc = 8 * (warp >> 1);
  const int r0 = 16 * mi + g;         // y rows r0 and r0 + 8
  const int n0 = 16 * MT * mi;        // state rows of this warp
  for (int blk = 0; blk < nblk; ++blk) {
    const int s = blk & 1, t0 = blk * T;
    cp_async_wait_all();
    // Block blk's operands have landed, the state of block blk - 1 is in
    // st, and every read of the other buffer (block blk - 1) is done.
    __syncthreads();
    if (blk + 1 < nblk) issue(blk + 1, s ^ 1);
    const float* xb = xs + s * T * SX;
    const TB* cb = cs + s * T * SB;
    const TB* bb = bs + s * T * SB;

    // Inclusive prefix sum of the block's log decays, lane l = position l,
    // in base-2 units for ex2.
    float cum = las[s * T + lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(FULL, cum, o);
      if (lane >= o) cum += v;
    }
    const float c2 = cum * LOG2E;
    const float total2 = __shfl_sync(FULL, c2, 31);
    const float dte = ex2(total2 - c2);

    // The decay matrix: C.B^T tile (rows 16 gm .., columns 8 gn ..) for
    // gn <= 2 gm + 1, masked before the exp, into wm.
    for (int tile = warp; tile < 6; tile += NW) {
      const int gm = tile < 2 ? 0 : 1, gn = tile < 2 ? tile : tile - 2;
      float gacc[4] = {0.f, 0.f, 0.f, 0.f};
      const int gr = 16 * gm + g;
      if constexpr (EX) {
        // bf16 B and C: products exact in f32, so bf16 mma.sync (k 16)
        // straight from the stored pairs.
        const TB* br = bb + (8 * gn + g) * SB;
#pragma unroll 4
        for (int ks = 0; ks < NP / 16; ++ks) {
          const int k = 16 * ks + 2 * t;
          const uint32_t a4[4] = {ld32(cb + gr * SB + k),
                                  ld32(cb + (gr + 8) * SB + k),
                                  ld32(cb + gr * SB + k + 8),
                                  ld32(cb + (gr + 8) * SB + k + 8)};
          hp::mma_16816(gacc, a4, ld32(br + k), ld32(br + k + 8));
        }
      } else {
#pragma unroll 4
      for (int ks = 0; ks < NP / 8; ++ks) {
        const int k = 8 * ks + 2 * t;
        const float2 c0 = ld2(cb + gr * SB + k);
        const float2 c1 = ld2(cb + (gr + 8) * SB + k);
        const float2 bv = ld2(bb + (8 * gn + g) * SB + k);
        uint32_t ah[4], al[4], bh[2], bl[2];
        split<EX>(c0.x, ah[0], al[0]);
        split<EX>(c1.x, ah[1], al[1]);
        split<EX>(c0.y, ah[2], al[2]);
        split<EX>(c1.y, ah[3], al[3]);
        split<EX>(bv.x, bh[0], bl[0]);
        split<EX>(bv.y, bh[1], bl[1]);
        mma3<EX, EX>(gacc, ah, al, bh, bl);
      }
      }
      const float ci0 = __shfl_sync(FULL, c2, gr);
      const float ci1 = __shfl_sync(FULL, c2, gr + 8);
      const int j = 8 * gn + 2 * t;
      const float cj0 = __shfl_sync(FULL, c2, j);
      const float cj1 = __shfl_sync(FULL, c2, j + 1);
      *reinterpret_cast<float2*>(wm + gr * SW + j) =
          make_float2(j <= gr ? gacc[0] * ex2(ci0 - cj0) : 0.f,
                      j + 1 <= gr ? gacc[1] * ex2(ci0 - cj1) : 0.f);
      *reinterpret_cast<float2*>(wm + (gr + 8) * SW + j) =
          make_float2(j <= gr + 8 ? gacc[2] * ex2(ci1 - cj0) : 0.f,
                      j + 1 <= gr + 8 ? gacc[3] * ex2(ci1 - cj1) : 0.f);
    }

    // C.state for rows r0, r0 + 8 and this warp's 8 columns: hi and lo
    // passes in two accumulators (two short chains).
    float ysh[4] = {0.f, 0.f, 0.f, 0.f}, ysl[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int ks = 0; ks < NP / 8; ++ks) {
      const int k = 8 * ks + 2 * t;
      const float2 c0 = ld2(cb + r0 * SB + k);
      const float2 c1 = ld2(cb + (r0 + 8) * SB + k);
      uint32_t ah[4], al[4];
      split<EX>(c0.x, ah[0], al[0]);
      split<EX>(c1.x, ah[1], al[1]);
      split<EX>(c0.y, ah[2], al[2]);
      split<EX>(c1.y, ah[3], al[3]);
      const float2 sv =
          *reinterpret_cast<const float2*>(st + (pc + g) * SS + k);
      uint32_t bh[2], bl[2];
      split<false>(sv.x, bh[0], bl[0]);
      split<false>(sv.y, bh[1], bl[1]);
      if (!EX) mma_tf32(ysl, al, bh[0], bh[1]);
      mma_tf32(ysl, ah, bl[0], bl[1]);
      mma_tf32(ysh, ah, bh[0], bh[1]);
    }
    __syncthreads();  // the decay matrix is in wm

    {  // (G o L).x for rows r0, r0 + 8, then y
      float yi[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if (ks <= 2 * mi + 1) {
          const int j = 8 * ks + 2 * t;
          const float2 w0 = *reinterpret_cast<const float2*>(wm + r0 * SW + j);
          const float2 w1 =
              *reinterpret_cast<const float2*>(wm + (r0 + 8) * SW + j);
          uint32_t ah[4], al[4], bh[2], bl[2];
          split<false>(w0.x, ah[0], al[0]);
          split<false>(w1.x, ah[1], al[1]);
          split<false>(w0.y, ah[2], al[2]);
          split<false>(w1.y, ah[3], al[3]);
          split<false>(xb[j * SX + pc + g], bh[0], bl[0]);
          split<false>(xb[(j + 1) * SX + pc + g], bh[1], bl[1]);
          mma3<false, false>(yi, ah, al, bh, bl);
        }
      }
      const float e0 = ex2(__shfl_sync(FULL, c2, r0));
      const float e1 = ex2(__shfl_sync(FULL, c2, r0 + 8));
      const int p = p0 + pc + 2 * t;
      if (t0 + r0 < S)
        *reinterpret_cast<float2*>(
            y + (((size_t)b * S + t0 + r0) * H + h) * P + p) =
            make_float2(fmaf(e0, ysh[0] + ysl[0], yi[0]),
                        fmaf(e0, ysh[1] + ysl[1], yi[1]));
      if (t0 + r0 + 8 < S)
        *reinterpret_cast<float2*>(
            y + (((size_t)b * S + t0 + r0 + 8) * H + h) * P + p) =
            make_float2(fmaf(e1, ysh[2] + ysl[2], yi[2]),
                        fmaf(e1, ysh[3] + ysl[3], yi[3]));
    }

    {  // state = exp(total) state + B^T . (exp(total - cum) o x)
      const float dk = ex2(total2);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[m][e] *= dk;
#pragma unroll
      for (int ks = 0; ks < T / 8; ++ks) {
        const int j = 8 * ks + 2 * t;
        uint32_t bh[2], bl[2];
        split<false>(__shfl_sync(FULL, dte, j) * xb[j * SX + pc + g], bh[0],
                     bl[0]);
        split<false>(__shfl_sync(FULL, dte, j + 1) * xb[(j + 1) * SX + pc + g],
                     bh[1], bl[1]);
#pragma unroll
        for (int m = 0; m < MT; m += 2) {
          // A = B^T: rows n (16 a tile), k-slots t, t + 4 = positions j,
          // j + 1.  bf16: ldmatrix.trans of rows j of B gives a lane
          // B[8ks + 2t, + 1][n] of two m-tiles at once.
          uint32_t a[2][4], al[2][4] = {};
          if constexpr (EX) {
            const int q = lane >> 3;
            const int n = n0 + 16 * (m + (q >> 1)) + 8 * (q & 1);
            uint32_t v[4];
            hp::ldsm_x4_t(smem_u32(bb + (8 * ks + (lane & 7)) * SB + n), v);
#pragma unroll
            for (int mm = 0; mm < 2; ++mm) {
              a[mm][0] = v[2 * mm] << 16;
              a[mm][2] = v[2 * mm] & 0xffff0000u;
              a[mm][1] = v[2 * mm + 1] << 16;
              a[mm][3] = v[2 * mm + 1] & 0xffff0000u;
            }
          } else {
#pragma unroll
            for (int mm = 0; mm < 2 && m + mm < MT; ++mm) {
              const int n = n0 + 16 * (m + mm) + g;
              split<false>(ld1(bb + j * SB + n), a[mm][0], al[mm][0]);
              split<false>(ld1(bb + j * SB + n + 8), a[mm][1], al[mm][1]);
              split<false>(ld1(bb + (j + 1) * SB + n), a[mm][2], al[mm][2]);
              split<false>(ld1(bb + (j + 1) * SB + n + 8), a[mm][3],
                           al[mm][3]);
            }
          }
#pragma unroll
          for (int mm = 0; mm < 2; ++mm)
            if (m + mm < MT) mma3<EX, false>(sacc[m + mm], a[mm], al[mm], bh, bl);
        }
      }
    }
    __syncthreads();  // every warp is done reading st and wm
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int n = n0 + 16 * m + g, p = pc + 2 * t;
      st[p * SS + n] = sacc[m][0];
      st[(p + 1) * SS + n] = sacc[m][1];
      st[p * SS + n + 8] = sacc[m][2];
      st[(p + 1) * SS + n + 8] = sacc[m][3];
    }
  }
}

template <int PT, int MT, typename TB>
int launch_t(const void* x, const void* log_a, const void* Bm, const void* Cm,
             void* y, int B, int S, int H, int P, int N, cudaStream_t st) {
  auto kernel = ssd_kernel<PT, MT, TB>;
  const int smem = smem_bytes(PT, 32 * MT, (int)sizeof(TB));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(P / PT, H, B), 8 * PT, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(log_a),
      static_cast<const TB*>(Bm), static_cast<const TB*>(Cm),
      static_cast<float*>(y), S, H, P, N);
  return (int)cudaGetLastError();
}

template <int PT, typename TB>
int launch_np(const void* x, const void* log_a, const void* Bm,
              const void* Cm, void* y, int B, int S, int H, int P, int N,
              int np, cudaStream_t st) {
  switch (np) {
    case 32:
      return launch_t<PT, 1, TB>(x, log_a, Bm, Cm, y, B, S, H, P, N, st);
    case 64:
      return launch_t<PT, 2, TB>(x, log_a, Bm, Cm, y, B, S, H, P, N, st);
    case 128:
      return launch_t<PT, 4, TB>(x, log_a, Bm, Cm, y, B, S, H, P, N, st);
    case 256:
      return launch_t<PT, 8, TB>(x, log_a, Bm, Cm, y, B, S, H, P, N, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename TB>
int launch(const void* x, const void* log_a, const void* Bm, const void* Cm,
           void* y, int B, int S, int H, int P, int N, int p_tile, int np,
           cudaStream_t st) {
  if (p_tile == 32)
    return launch_np<32, TB>(x, log_a, Bm, Cm, y, B, S, H, P, N, np, st);
  if (p_tile == 16)
    return launch_np<16, TB>(x, log_a, Bm, Cm, y, B, S, H, P, N, np, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// bc_dtype (of Bm and Cm): 0 = float32, 1 = bfloat16.  P is a multiple of
// p_tile (32 or 16), np (32, 64, 128 or 256) the state rows: N (a
// multiple of 8) padded.  Plan: ops/mamba_ssd.py ssd_plan.
extern "C" int rtt_ssd_scan(const void* x, const void* log_a, const void* Bm,
                            const void* Cm, void* y, int bc_dtype, int B,
                            int S, int H, int P, int N, int p_tile, int np,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bc_dtype == 0)
    return launch<float>(x, log_a, Bm, Cm, y, B, S, H, P, N, p_tile, np, s);
  return launch<__nv_bfloat16>(x, log_a, Bm, Cm, y, B, S, H, P, N, p_tile, np,
                               s);
}
