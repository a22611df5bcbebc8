// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel takes float32 or bfloat16 operands (int8 for quantised KV
// pools) and computes in float32.  Global loads are 16-byte vectors (4
// floats, 8 bf16 or 16 int8 values), converted to float32 on the way
// into shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rtt {

// Mask value of the JAX kernels: a row with no live token keeps
// m = -1e30 and l = 0, which combine_with_self relies on.
constexpr float NEG_INF = -1e30f;

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;  // elements per 16-byte load
  __device__ __forceinline__ static void load(const float* p, float* out) {
    float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* out) {
    uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Vec<int8_t> {
  static constexpr int N = 16;
  __device__ __forceinline__ static void load(const int8_t* p, float* out) {
    uint4 u = *reinterpret_cast<const uint4*>(p);
    const char4* c = reinterpret_cast<const char4*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[4 * i] = (float)c[i].x;  // exact: |x| <= 127
      out[4 * i + 1] = (float)c[i].y;
      out[4 * i + 2] = (float)c[i].z;
      out[4 * i + 3] = (float)c[i].w;
    }
  }
};

// Four consecutive elements as float32 (the quantising appends read
// their fresh rows this way and write one packed 32-bit word of int8).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

// clip(round-half-even(x), -127, 127) as one int8: jnp.round and
// torch.round round half to even, which is rintf, not roundf.
__device__ __forceinline__ int quant1(float x) {
  return (int)fminf(fmaxf(rintf(x), -127.f), 127.f);
}
__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) |
         ((uint32_t)(c & 0xff) << 16) | ((uint32_t)(d & 0xff) << 24);
}

// Requantise four stored int8 values by `factor`; the product is rounded
// on its own (__fmul_rn), so no contraction with a neighbour changes it.
__device__ __forceinline__ uint32_t requant4(uint32_t w, float factor) {
  const char4 c = *reinterpret_cast<const char4*>(&w);
  return pack4(quant1(__fmul_rn((float)c.x, factor)),
               quant1(__fmul_rn((float)c.y, factor)),
               quant1(__fmul_rn((float)c.z, factor)),
               quant1(__fmul_rn((float)c.w, factor)));
}

// Block-wide max of non-negative values (blockDim.x a multiple of 32, at
// most 1024); every thread gets the result.  `red` holds 32 floats.
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // a previous call's readers are done with red
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float r = 0.f;
  for (int w = 0; w < (int)(blockDim.x / 32); ++w) r = fmaxf(r, red[w]);
  return r;
}

// Eight int8 values (two words, low bytes first) as eight bf16, exact,
// without the quarter-rate int-to-float conversions: each byte, its sign
// bit flipped (x + 128), becomes the low byte of the f32 2^23 + x + 128,
// minus 2^23 + 128; |x| <= 128 has at most 8 significant bits, so the
// f32's high half is its bf16.
__device__ __forceinline__ uint4 int8x8_to_bf16(uint32_t lo, uint32_t hi) {
  const uint32_t w[2] = {lo ^ 0x80808080u, hi ^ 0x80808080u};
  uint32_t out[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t x = w[i >> 1];
    const float a = __uint_as_float(
        __byte_perm(x, 0x4B000000u, 0x7440u | (2 * (i & 1)))) - 8388736.f;
    const float b = __uint_as_float(
        __byte_perm(x, 0x4B000000u, 0x7440u | (2 * (i & 1) + 1))) -
                    8388736.f;
    out[i] = __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632u);
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

// Reductions over the 2^k lanes that differ only in the low k bits.
template <int WIDTH>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = WIDTH / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int WIDTH>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = WIDTH / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace rtt
