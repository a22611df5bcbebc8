// K6 — int8 ragged paged append: every row's fresh k/v, all layers, in
// place on pools and page scales.
//
// Replaces ray_tpu/ops/ragged_paged_attention.py
// ragged_paged_append_quantized (Pallas body _ragged_append_kernel with
// quantized=True, pallas_call at :611).
//
// pools int8 [L, KVH, P, page, D], scales f32 [L, P, KVH, 1] (page-major),
// k_new/v_new [L, T, KVH, D] f32 or bf16, rows (slot, start, len, off) x R,
// block_tables [slots, maxp].  Token t < len of row r lands at position
// start + t of its slot.  Per (row, layer, j-th page the row's fresh
// tokens touch, kv head), for k and for v alike, with pg = start / page +
// j, base = pg * page, the landing tokens those with base <= start + t <
// base + page, and s_old the page's scale:
//   fresh  = base >= start         (the row writes the page from its cell 0)
//   needed = max(absmax(landing tokens) / 127, 1e-8)
//   s_new  = fresh ? needed : max(s_old, needed)
//   factor = fresh ? 0 : (s_new > s_old ? s_old / s_new : 1)
//   written cells = clip(round(token / s_new))
//   other cells   = clip(round(cell * factor))
//   scale         = s_new
// Rounding is half to even (rintf), and every product and quotient is
// rounded on its own, so the stored bytes equal the plain version's.
//
// What bounds it on the H100: bytes.  The fresh rows are read once (twice
// by this kernel: once for the absmax, once to quantise; the second read
// hits L2) and one int8 byte is written per element; a page whose scale
// grows is read and rewritten whole, a fresh page is zeroed beyond the
// landing tokens, and a page extended under a stable scale (every decode
// row in the common case) gets its new cells and nothing else.
//
// Design: one CTA of 128 threads per (row, layer, j, kv head, k or v); j
// runs to the static bound pages_per_row(T, page) and CTAs past the row's
// last touched page, and those of padding rows, exit at once, so a page no
// token touches is never written (the TPU kernel must route such dead
// cells to the scratch page, because its aliased copy-through would
// clobber a fresh append; its one-hot gather matmul over an 8-aligned
// window has no counterpart either: a thread reads its token's row
// directly).  Rows own distinct slots and so disjoint pages, and the j of
// one row are distinct pages: no two CTAs share a live (page, kv head,
// k or v).  A row decoded past its allocation reads the block table's
// sentinel and lands on the scratch page, garbage by contract.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;

template <typename T>
__global__ void __launch_bounds__(THREADS) ragged_append_quantized_kernel(
    int8_t* __restrict__ k_pools, int8_t* __restrict__ v_pools,
    float* __restrict__ k_scales, float* __restrict__ v_scales,
    const T* __restrict__ k_new, const T* __restrict__ v_new,
    const int* __restrict__ row_slot, const int* __restrict__ row_start,
    const int* __restrict__ row_len, const int* __restrict__ row_off,
    const int* __restrict__ block_tables, int T_, int KVH, int P, int page,
    int D, int maxp, int npr) {
  __shared__ float red[32];
  const int r = blockIdx.x, l = blockIdx.y;
  const int j = blockIdx.z % npr;
  const int h = (blockIdx.z / npr) / 2;
  const bool is_v = (blockIdx.z / npr) % 2;
  const int tid = threadIdx.x;
  const int start = row_start[r], nt = row_len[r];
  const int pg = start / page + j;
  const int base = pg * page;
  if (nt <= 0 || base >= start + nt) return;  // padding row, or past the row
  const int lo = max(base, start), hi = min(base + page, start + nt);
  const int n = hi - lo;                       // landing tokens, >= 1
  const int cell0 = lo - base;                 // first written cell
  int pid = block_tables[(size_t)row_slot[r] * maxp + min(pg, maxp - 1)];
  pid = min(max(pid, 0), P - 1);
  const int row_words = D / 4;
  // Token lo + i of the slot is buffer token off + (lo - start) + i.
  const T* src = (is_v ? v_new : k_new) +
                 (((size_t)l * T_ + row_off[r] + (lo - start)) * KVH + h) * D;
  const size_t tok_stride = (size_t)KVH * D;
  float* scale = (is_v ? v_scales : k_scales) + ((size_t)l * P + pid) * KVH + h;
  uint32_t* pgw = reinterpret_cast<uint32_t*>(
      (is_v ? v_pools : k_pools) +
      ((((size_t)l * KVH + h) * P + pid) * page) * (size_t)D);

  const float s_old = *scale;  // read by every thread before thread 0 writes
  float amax = 0.f;
  for (int i = tid; i < n * row_words; i += THREADS) {
    const float4 x =
        rtt::load4(src + (i / row_words) * tok_stride + 4 * (i % row_words));
    amax = fmaxf(amax, fmaxf(fmaxf(fabsf(x.x), fabsf(x.y)),
                             fmaxf(fabsf(x.z), fabsf(x.w))));
  }
  amax = rtt::block_max(amax, red);  // syncs: every thread holds s_old

  const float needed = fmaxf(__fdiv_rn(amax, 127.f), 1e-8f);
  const bool fresh = base >= start;
  const float s_new = fresh ? needed : fmaxf(s_old, needed);
  const bool grown = !fresh && s_new > s_old;

  if (fresh || grown) {
    const float factor = fresh ? 0.f : __fdiv_rn(s_old, s_new);
    for (int i = tid; i < page * row_words; i += THREADS) {
      const int cell = i / row_words;
      if (cell >= cell0 && cell < cell0 + n) continue;  // written below
      pgw[i] = fresh ? 0u : rtt::requant4(pgw[i], factor);
    }
  }
  for (int i = tid; i < n * row_words; i += THREADS) {
    const float4 x =
        rtt::load4(src + (i / row_words) * tok_stride + 4 * (i % row_words));
    pgw[cell0 * row_words + i] = rtt::pack4(
        rtt::quant1(__fdiv_rn(x.x, s_new)), rtt::quant1(__fdiv_rn(x.y, s_new)),
        rtt::quant1(__fdiv_rn(x.z, s_new)), rtt::quant1(__fdiv_rn(x.w, s_new)));
  }
  if (tid == 0) *scale = s_new;
}

}  // namespace

// dtype (of k_new/v_new): 0 = float32, 1 = bfloat16.  D is a multiple of
// 16; npr = pages_per_row(T, page), the most pages one row can touch.
extern "C" int rtt_ragged_append_quantized(
    void* k_pools, void* v_pools, void* k_scales, void* v_scales,
    const void* k_new, const void* v_new, const void* row_slot,
    const void* row_start, const void* row_len, const void* row_off,
    const void* block_tables, int dtype, int L, int T, int R, int KVH, int P,
    int page, int D, int maxp, int npr, void* stream) {
  const dim3 grid(R, L, npr * KVH * 2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* kp = static_cast<int8_t*>(k_pools);
  int8_t* vp = static_cast<int8_t*>(v_pools);
  float* ks = static_cast<float*>(k_scales);
  float* vs = static_cast<float*>(v_scales);
  const int* rs = static_cast<const int*>(row_slot);
  const int* rst = static_cast<const int*>(row_start);
  const int* rl = static_cast<const int*>(row_len);
  const int* ro = static_cast<const int*>(row_off);
  const int* bt = static_cast<const int*>(block_tables);
  if (dtype == 0)
    ragged_append_quantized_kernel<float><<<grid, THREADS, 0, s>>>(
        kp, vp, ks, vs, static_cast<const float*>(k_new),
        static_cast<const float*>(v_new), rs, rst, rl, ro, bt, T, KVH, P, page,
        D, maxp, npr);
  else
    ragged_append_quantized_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        kp, vp, ks, vs, static_cast<const __nv_bfloat16*>(k_new),
        static_cast<const __nv_bfloat16*>(v_new), rs, rst, rl, ro, bt, T, KVH,
        P, page, D, maxp, npr);
  return (int)cudaGetLastError();
}
