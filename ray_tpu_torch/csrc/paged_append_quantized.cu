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
// Design: one warp per (slot, layer, kv head, k or v) row, eight warps a
// CTA.  The TPU kernel copies every page through VMEM whole and picks with
// an iota mask, because Mosaic cannot store one row at a dynamic sublane,
// and moves its scalars through SMEM.  Here each lane loads its D / 32
// values of the row once (8 bytes at D 128 in bf16), issued before the page
// id and the scale they do not need, takes the absmax with five xor
// shuffles (no shared memory, no block barrier) and quantises from the
// same registers, one 4-byte store a lane; every lane reads the old scale,
// and lane 0 writes the new one after a warp barrier, so all take the same
// decision.  A fresh or grown page is rewritten by the same warp with
// 16-byte loads and stores, U in flight a lane (16 passes at page 64, D
// 128); the rounding adds 1.5 * 2^23 and packs bytes by permutes, with no
// float-to-int conversions.  The old design (a CTA of 128 threads per row,
// 96 of them idle at D 128, the row read twice and a two-barrier block
// max) launched 8x the CTAs.  Inactive slots all carry the scratch page
// id: their warps race on that page and its scale, which is garbage by
// contract and stays finite (each writes a finite value).
#include "common.cuh"

namespace {

constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int U = 8;  // 16-byte loads a lane issues before using any

__device__ __forceinline__ float absmax4(float4 x) {
  return fmaxf(fmaxf(fabsf(x.x), fabsf(x.y)), fmaxf(fabsf(x.z), fabsf(x.w)));
}

// WPL: 4-value words of the row a lane holds (D <= 128 * WPL).
template <typename T, int WPL>
__global__ void __launch_bounds__(THREADS) paged_append_quantized_kernel(
    int8_t* __restrict__ k_pools, int8_t* __restrict__ v_pools,
    float* __restrict__ k_scales, float* __restrict__ v_scales,
    const T* __restrict__ k_new, const T* __restrict__ v_new,
    const int* __restrict__ pids, const int* __restrict__ offs, int L, int B,
    int KVH, int P, int page, int D) {
  const int lane = threadIdx.x % 32;
  const int n_rows = L * B * KVH;  // rows of k; as many of v
  const int r = blockIdx.x * WARPS + threadIdx.x / 32;
  if (r >= 2 * n_rows) return;
  const bool is_v = r >= n_rows;
  const int rr = is_v ? r - n_rows : r;  // (l * B + b) * KVH + h
  const int h = rr % KVH, lb = rr / KVH;
  const int b = lb % B, l = lb / B;
  const int words = D / 4;

  // 1. The row, all of a lane's loads in flight before the page id.
  const T* row = (is_v ? v_new : k_new) + (size_t)rr * D;
  float4 x[WPL];
#pragma unroll
  for (int i = 0; i < WPL; ++i) {
    const int w = lane + 32 * i;
    x[i] = w < words ? rtt::load4(row + 4 * w)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int pid = min(max(pids[b], 0), P - 1);
  const int off = offs[b];
  float* scale =
      (is_v ? v_scales : k_scales) + ((size_t)l * P + pid) * KVH + h;
  const float old = *scale;  // every lane reads it before lane 0 writes
  int8_t* pg = (is_v ? v_pools : k_pools) +
               ((((size_t)l * KVH + h) * P + pid) * page) * (size_t)D;
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < WPL; ++i) amax = fmaxf(amax, absmax4(x[i]));
  amax = rtt::group_max<32>(amax);

  const float needed = __fdiv_rn(amax, 127.f);
  const bool fresh = off == 0;
  const float new_scale = fresh ? needed : fmaxf(old, needed);
  const float safe = new_scale == 0.f ? 1.f : new_scale;

  // 2. The page's other rows: zero on a fresh page, requantised by
  // old / safe when the scale grew, untouched when it held.
  if (fresh || new_scale > old) {
    const float factor = fresh ? 0.f : __fdiv_rn(old, safe);
    uint4* pg16 = reinterpret_cast<uint4*>(pg);
    const int row16 = D / 16, n16 = page * row16;
    const int skip0 = off * row16, skip1 = skip0 + row16;  // the new row
    for (int i0 = lane; i0 < n16; i0 += 32 * U) {
      uint4 w[U];
      bool mine[U];
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const int i = i0 + 32 * k;
        mine[k] = i < n16 && (i < skip0 || i >= skip1);
        if (mine[k] && !fresh) w[k] = pg16[i];
      }
#pragma unroll
      for (int k = 0; k < U; ++k)
        if (mine[k])
          pg16[i0 + 32 * k] = fresh ? make_uint4(0u, 0u, 0u, 0u)
                                    : rtt::requant16(w[k], factor);
    }
  }

  // 3. The row times 1 / safe, one 4-byte store a word.
  const float inv = __fdiv_rn(1.f, safe);
  uint32_t* dst = reinterpret_cast<uint32_t*>(pg + (size_t)off * D);
#pragma unroll
  for (int i = 0; i < WPL; ++i) {
    const int w = lane + 32 * i;
    if (w < words) {
      const float q[4] = {rtt::quant_biased(__fmul_rn(x[i].x, inv)),
                          rtt::quant_biased(__fmul_rn(x[i].y, inv)),
                          rtt::quant_biased(__fmul_rn(x[i].z, inv)),
                          rtt::quant_biased(__fmul_rn(x[i].w, inv))};
      dst[w] = rtt::pack_biased(q);
    }
  }
  __syncwarp();
  if (lane == 0) *scale = new_scale;
}

template <typename T, int WPL>
int launch(void* k_pools, void* v_pools, void* k_scales, void* v_scales,
           const void* k_new, const void* v_new, const void* pids,
           const void* offs, int L, int B, int KVH, int P, int page, int D,
           cudaStream_t s) {
  const int rows = 2 * L * B * KVH;
  paged_append_quantized_kernel<T, WPL>
      <<<(rows + WARPS - 1) / WARPS, THREADS, 0, s>>>(
          static_cast<int8_t*>(k_pools), static_cast<int8_t*>(v_pools),
          static_cast<float*>(k_scales), static_cast<float*>(v_scales),
          static_cast<const T*>(k_new), static_cast<const T*>(v_new),
          static_cast<const int*>(pids), static_cast<const int*>(offs), L, B,
          KVH, P, page, D);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(void* kp, void* vp, void* ks, void* vs, const void* kn,
             const void* vn, const void* pids, const void* offs, int L, int B,
             int KVH, int P, int page, int D, cudaStream_t s) {
  if (D <= 128)
    return launch<T, 1>(kp, vp, ks, vs, kn, vn, pids, offs, L, B, KVH, P,
                        page, D, s);
  if (D <= 256)
    return launch<T, 2>(kp, vp, ks, vs, kn, vn, pids, offs, L, B, KVH, P,
                        page, D, s);
  if (D <= 512)
    return launch<T, 4>(kp, vp, ks, vs, kn, vn, pids, offs, L, B, KVH, P,
                        page, D, s);
  return launch<T, 8>(kp, vp, ks, vs, kn, vn, pids, offs, L, B, KVH, P, page,
                      D, s);
}

}  // namespace

// dtype (of k_new/v_new): 0 = float32, 1 = bfloat16.  D is a multiple of
// 16, at most 1024; offs[b] lies in [0, page).
extern "C" int rtt_paged_append_quantized(
    void* k_pools, void* v_pools, void* k_scales, void* v_scales,
    const void* k_new, const void* v_new, const void* pids, const void* offs,
    int dtype, int L, int B, int KVH, int P, int page, int D, void* stream) {
  if (D % 16 || D > 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? dispatch<float>(k_pools, v_pools, k_scales, v_scales, k_new,
                               v_new, pids, offs, L, B, KVH, P, page, D, s)
             : dispatch<__nv_bfloat16>(k_pools, v_pools, k_scales, v_scales,
                                       k_new, v_new, pids, offs, L, B, KVH, P,
                                       page, D, s);
}
