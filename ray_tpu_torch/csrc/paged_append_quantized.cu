// K3 — int8 paged append: one new row per slot, all layers, in place on
// pools and page scales.
//
// Replaces ray_tpu/ops/paged_attention.py paged_append_quantized (Pallas
// body _append_kernel_q, pallas_call at :498).
//
// pools int8 [L, KVH, P, page, D], scales f32 [L, P, KVH, 1] (page-major),
// k_new/v_new [L, B, KVH, D] f32 or bf16, pids/offs [B].  Per (slot b,
// layer l, kv head h), for k and for v alike, with pid = clamp(pids[b], 0,
// P - 1), off = offs[b], old = scale[l, pid, h]:
//   needed    = absmax(row) / 127                      (no floor)
//   fresh     = off == 0
//   new_scale = fresh ? needed : max(old, needed)
//   safe      = new_scale == 0 ? 1 : new_scale
//   factor    = fresh ? 0 : (new_scale > old ? old / safe : 1)
//   page      = clip(round(page * factor))              (cells != off)
//   page[off] = clip(round(row * (1 / safe)))
//   scale     = new_scale
// Rounding is half to even (rintf), and every product and quotient is
// rounded on its own, so the stored bytes equal the plain version's.
//
// What bounds it on the H100: bytes, and at decode sizes launch latency.
// In the common case (off > 0 and the row fits the page's scale: factor
// is 1) the kernel reads the row and one scale and writes D bytes and the
// scale; only a grown scale (read and rewrite page x D bytes) or off == 0
// (zero page x D bytes) touches the rest of the page.
//
// Design: one CTA of 128 threads per (slot, layer, kv head, k or v).  The
// TPU kernel copies every page through VMEM whole and picks with an iota
// mask, because Mosaic cannot store one row at a dynamic sublane, and
// moves its scalars through SMEM; here the CTA reduces the row's absmax
// with shuffles, every thread takes the same decision from the old scale
// it read, and the page is rewritten only when the decision asks for it.
// Inactive slots all carry the scratch page id: their CTAs race on that
// page and its scale, which is garbage by contract and stays finite (each
// writes a finite value).
#include "common.cuh"

namespace {

constexpr int THREADS = 128;

template <typename T>
__global__ void __launch_bounds__(THREADS) paged_append_quantized_kernel(
    int8_t* __restrict__ k_pools, int8_t* __restrict__ v_pools,
    float* __restrict__ k_scales, float* __restrict__ v_scales,
    const T* __restrict__ k_new, const T* __restrict__ v_new,
    const int* __restrict__ pids, const int* __restrict__ offs, int B, int KVH,
    int P, int page, int D) {
  __shared__ float red[32];
  const int b = blockIdx.x, l = blockIdx.y;
  const int h = blockIdx.z / 2;
  const bool is_v = blockIdx.z % 2;
  const int tid = threadIdx.x;
  const int pid = min(max(pids[b], 0), P - 1);
  const int off = offs[b];
  const T* row = (is_v ? v_new : k_new) + (((size_t)l * B + b) * KVH + h) * D;
  float* scale = (is_v ? v_scales : k_scales) + ((size_t)l * P + pid) * KVH + h;
  uint32_t* pg = reinterpret_cast<uint32_t*>(
      (is_v ? v_pools : k_pools) +
      ((((size_t)l * KVH + h) * P + pid) * page) * (size_t)D);
  const int row_words = D / 4;

  const float old = *scale;  // read by every thread before thread 0 writes
  float amax = 0.f;
  for (int i = tid; i < row_words; i += THREADS) {
    const float4 x = rtt::load4(row + 4 * i);
    amax = fmaxf(amax, fmaxf(fmaxf(fabsf(x.x), fabsf(x.y)),
                             fmaxf(fabsf(x.z), fabsf(x.w))));
  }
  amax = rtt::block_max(amax, red);  // syncs: every thread holds `old`

  const float needed = __fdiv_rn(amax, 127.f);
  const bool fresh = off == 0;
  const float new_scale = fresh ? needed : fmaxf(old, needed);
  const float safe = new_scale == 0.f ? 1.f : new_scale;
  const bool grown = !fresh && new_scale > old;

  if (fresh || grown) {
    const float factor = fresh ? 0.f : __fdiv_rn(old, safe);
    for (int i = tid; i < page * row_words; i += THREADS) {
      if (i / row_words == off) continue;  // the new row lands there
      pg[i] = fresh ? 0u : rtt::requant4(pg[i], factor);
    }
  }
  const float inv = __fdiv_rn(1.f, safe);
  for (int i = tid; i < row_words; i += THREADS) {
    const float4 x = rtt::load4(row + 4 * i);
    pg[off * row_words + i] = rtt::pack4(
        rtt::quant1(__fmul_rn(x.x, inv)), rtt::quant1(__fmul_rn(x.y, inv)),
        rtt::quant1(__fmul_rn(x.z, inv)), rtt::quant1(__fmul_rn(x.w, inv)));
  }
  if (tid == 0) *scale = new_scale;
}

}  // namespace

// dtype (of k_new/v_new): 0 = float32, 1 = bfloat16.  D is a multiple of
// 16; offs[b] lies in [0, page).
extern "C" int rtt_paged_append_quantized(
    void* k_pools, void* v_pools, void* k_scales, void* v_scales,
    const void* k_new, const void* v_new, const void* pids, const void* offs,
    int dtype, int L, int B, int KVH, int P, int page, int D, void* stream) {
  const dim3 grid(B, L, KVH * 2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* kp = static_cast<int8_t*>(k_pools);
  int8_t* vp = static_cast<int8_t*>(v_pools);
  float* ks = static_cast<float*>(k_scales);
  float* vs = static_cast<float*>(v_scales);
  const int* pi = static_cast<const int*>(pids);
  const int* of = static_cast<const int*>(offs);
  if (dtype == 0)
    paged_append_quantized_kernel<float><<<grid, THREADS, 0, s>>>(
        kp, vp, ks, vs, static_cast<const float*>(k_new),
        static_cast<const float*>(v_new), pi, of, B, KVH, P, page, D);
  else
    paged_append_quantized_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        kp, vp, ks, vs, static_cast<const __nv_bfloat16*>(k_new),
        static_cast<const __nv_bfloat16*>(v_new), pi, of, B, KVH, P, page, D);
  return (int)cudaGetLastError();
}
