// Tensor-core building blocks of the flash kernels in bf16 (K9f in
// flash_fwd.cu, K10/K11 in flash_bwd.cu): mma.sync m16n8k16 on bf16
// fragments with f32 accumulators, 4 warps of 16 rows each over 64-row
// tiles staged in shared memory as [64][D + 8] bf16.  A warp's
// accumulators of two neighbouring n-tiles are, rounded to bf16, the A
// fragment of one k-step (to_a), so a score tile feeds the next product
// from registers; B fragments of a row-major [k][n] tile come through
// ldmatrix.trans (mma_rows), those of a product with a tile's transpose
// from 32-bit reads (load_bt).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rtt {
namespace flash {

using bf16 = __nv_bfloat16;
constexpr int TILE = 64;          // rows of every staged tile
constexpr int MMA_THREADS = 128;  // 4 warps of 16 rows

// Bytes of `tiles` [64][D + 8] bf16 tiles (the 8-element pad keeps the
// 32-bit fragment reads and the ldmatrix rows bank-conflict free) and
// `rows` floats per tile row after them.
template <int D>
constexpr size_t mma_smem_bytes(int tiles, int rows) {
  return (size_t)tiles * TILE * (D + 8) * sizeof(bf16) +
         (size_t)rows * TILE * sizeof(float);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo: low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// B fragments of n-tiles n and n + 8 from rows k .. k + 15 of a row-major
// [k][n] tile; lane l gives the address of row k + l % 16, column
// n + 8 (l / 16).
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// 64 rows of D bf16 into a [64][D + 8] tile, 16 bytes a thread.
template <int D>
__device__ __forceinline__ void stage_bf16(bf16* dst, const bf16* src,
                                           size_t src_stride) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < TILE * CH; i += MMA_THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * src_stride + c);
  }
}

// A fragment: rows m .. m + 15, columns k .. k + 15 of a [.][D + 8] tile.
template <int D>
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* t, int m,
                                       int k) {
  const int g = (threadIdx.x & 31) >> 2, tig = threadIdx.x & 3;
  const bf16* p = t + (m + g) * (D + 8) + k + 2 * tig;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * (D + 8));
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * (D + 8) + 8);
}

// B fragment of a product with t^T: its n are rows n .. n + 7 of t, its k
// columns k .. k + 15.
template <int D>
__device__ __forceinline__ void load_bt(uint32_t* b, const bf16* t, int n,
                                        int k) {
  const int g = (threadIdx.x & 31) >> 2, tig = threadIdx.x & 3;
  const bf16* p = t + (n + g) * (D + 8) + k + 2 * tig;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// acc[.][D / 8 n-tiles] += a (16 x 16) . rows k .. k + 15 of t (all D).
template <int D>
__device__ __forceinline__ void mma_rows(float (*acc)[4], const uint32_t* a,
                                         const bf16* t, int k) {
  const int lane = threadIdx.x & 31;
  const bf16* base = t + (k + (lane & 15)) * (D + 8) + (lane >> 4) * 8;
#pragma unroll
  for (int nd = 0; nd < D / 8; nd += 2) {
    uint32_t b[4];
    ldsm_x4_trans(b, base + nd * 8);
    mma_bf16(acc[nd], a, b);
    mma_bf16(acc[nd + 1], a, b + 2);
  }
}

// The accumulators of n-tile nt (rows g, g + 8; columns 2 tig, + 1) as
// half of the A fragment of k-step nt / 2, rounded to bf16.
__device__ __forceinline__ void to_a(uint32_t (*a)[4], int nt,
                                     const float* x) {
  a[nt / 2][(nt & 1) * 2] = pack_bf16(x[0], x[1]);
  a[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(x[2], x[3]);
}

// Stores a 16-row x D accumulator (times `mul`) at rows `row` and
// row + 8 of a [.][stride] bf16 array.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, size_t row0,
                                           size_t stride, float (*acc)[4],
                                           float mul) {
  const int g = (threadIdx.x & 31) >> 2, tig = threadIdx.x & 3;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    bf16* p = out + (row0 + g) * stride + nd * 8 + 2 * tig;
    *reinterpret_cast<__nv_bfloat162*>(p) =
        __floats2bfloat162_rn(mul * acc[nd][0], mul * acc[nd][1]);
    *reinterpret_cast<__nv_bfloat162*>(p + 8 * stride) =
        __floats2bfloat162_rn(mul * acc[nd][2], mul * acc[nd][3]);
  }
}

}  // namespace flash
}  // namespace rtt
