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

// Four consecutive elements as float32 (K3 reads its fresh rows this way
// and writes one packed 32-bit word of int8).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
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

// clip(round-half-even(q), -127, 127) + 1.5 * 2^23: the add rounds q to
// an integer (ulp 1 in [2^23, 2^24), ties to even, as rintf), and the
// float's low byte is then the int8 value, two's complement.
constexpr float QB = 12582912.f;
__device__ __forceinline__ float quant_biased(float q) {
  return fminf(fmaxf(__fadd_rn(q, QB), QB - 127.f), QB + 127.f);
}

// The low bytes of four biased values, in order, as one word.
__device__ __forceinline__ uint32_t pack_biased(const float* b) {
  const uint32_t lo =
      __byte_perm(__float_as_uint(b[0]), __float_as_uint(b[1]), 0x0040);
  const uint32_t hi =
      __byte_perm(__float_as_uint(b[2]), __float_as_uint(b[3]), 0x0040);
  return __byte_perm(lo, hi, 0x5410);
}

__device__ __forceinline__ uint4 pack16(const float (&b)[16]) {
  return make_uint4(pack_biased(b), pack_biased(b + 4), pack_biased(b + 8),
                    pack_biased(b + 12));
}

// Sixteen stored int8 values times `factor`, each product rounded on its
// own (__fmul_rn), then rounded and clipped.
__device__ __forceinline__ uint4 requant16(uint4 w, float factor) {
  const uint4 lo = int8x8_to_bf16(w.x, w.y);
  const uint4 hi = int8x8_to_bf16(w.z, w.w);
  float c[16], b[16];
  Vec<__nv_bfloat16>::load(reinterpret_cast<const __nv_bfloat16*>(&lo), c);
  Vec<__nv_bfloat16>::load(reinterpret_cast<const __nv_bfloat16*>(&hi),
                           c + 8);
#pragma unroll
  for (int e = 0; e < 16; ++e) b[e] = quant_biased(__fmul_rn(c[e], factor));
  return pack16(b);
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
