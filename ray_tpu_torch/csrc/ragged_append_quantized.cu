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
// What bounds it on the H100: bytes.  The fresh rows are read once from
// device memory and one int8 byte is written per element; a page whose
// scale grows is read and rewritten whole, a fresh page is zeroed beyond
// the landing tokens, and a page extended under a stable scale (every
// decode row in the common case) gets its new cells and nothing else.
//
// Design: work only where a row's tokens land.  The live (row, page)
// pairs are numbered row by row from the last row; a CTA finds its pair
// from row_start / row_len by a warp-level prefix sum over the rows (every
// warp computes it, so no block barrier), with no host sync: the grid is
// the layers times a static bound on the pairs (2 R + ceil(T / page), each
// row touching at most len / page + 2 pages) times the kv-head items,
// layers fastest, so the pages of a step's prompt rows (packed after its
// decode rows) are dispatched first; CTAs past the live pairs exit, and a
// grid-stride loop covers any pair past the bound.  One warp takes one
// (layer, pair, kv head, k or v) page.  Its lanes issue one cp.async.bulk
// copy per landing row into the warp's slice of shared memory (`cap`
// rows), all in flight at once on the warp's mbarrier, read any further
// rows with 16-byte loads (U in flight a lane), take the absmax with
// shuffles, rewrite the rest of the page when it is fresh or its scale
// grew (16-byte loads and stores, U in flight), then quantise the landing
// rows, 16 values to one 16-byte store: the rounding by adding 1.5 * 2^23
// and the bytes packed by byte permutes, no float-to-int conversions; rows
// past the slice are read again there.  A slice of 32 rows (seven CTAs an
// SM) measured faster than a whole page of 64 (three CTAs an SM), the
// second read of the other rows hitting L2.
// Rows own distinct slots and so disjoint pages, and the pages of one row
// are distinct: no two warps share a live (page, kv head, k or v), and a
// page no token touches is never written (the TPU kernel must route such
// dead cells to the scratch page, because its aliased copy-through would
// clobber a fresh append).  A row decoded past its allocation reads the
// block table's sentinel and lands on the scratch page, garbage by
// contract.
#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hp = rtt::hopper;

constexpr int WARPS = 4, THREADS = 32 * WARPS;
constexpr int U = 8;  // 16-byte loads a lane issues before using any

__device__ __forceinline__ float absmax4(float4 x) {
  return fmaxf(fmaxf(fabsf(x.x), fabsf(x.y)), fmaxf(fabsf(x.z), fabsf(x.w)));
}

// The absmax of a 16-byte chunk: 4 floats or 8 bf16.
__device__ __forceinline__ float chunk_absmax(uint4 u, const float*) {
  return absmax4(make_float4(__uint_as_float(u.x), __uint_as_float(u.y),
                             __uint_as_float(u.z), __uint_as_float(u.w)));
}
__device__ __forceinline__ float chunk_absmax(uint4 u, const __nv_bfloat16*) {
  float f[8];
  rtt::Vec<__nv_bfloat16>::load(reinterpret_cast<const __nv_bfloat16*>(&u),
                                f);
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) m = fmaxf(m, fabsf(f[i]));
  return m;
}

// Sixteen consecutive values (f32 or bf16) as f32, from 16-byte chunks.
__device__ __forceinline__ void load16(const float* p, float (&f)[16]) {
#pragma unroll
  for (int c = 0; c < 16; c += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + c);
    f[c] = v.x; f[c + 1] = v.y; f[c + 2] = v.z; f[c + 3] = v.w;
  }
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&f)[16]) {
  rtt::Vec<__nv_bfloat16>::load(p, f);
  rtt::Vec<__nv_bfloat16>::load(p + 8, f + 8);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ragged_append_quantized_kernel(
    int8_t* __restrict__ k_pools, int8_t* __restrict__ v_pools,
    float* __restrict__ k_scales, float* __restrict__ v_scales,
    const T* __restrict__ k_new, const T* __restrict__ v_new,
    const int* __restrict__ row_slot, const int* __restrict__ row_start,
    const int* __restrict__ row_len, const int* __restrict__ row_off,
    const int* __restrict__ block_tables, int T_, int R, int KVH, int P,
    int page, int D, int maxp, int groups, int cap) {
  extern __shared__ __align__(128) uint4 tiles[];  // [WARPS][cap * row_chunks]
  __shared__ __align__(8) uint64_t bars[WARPS];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int l = blockIdx.x;
  const int item = (blockIdx.y % groups) * WARPS + warp;  // (kv head, k|v)
  if (item >= 2 * KVH) return;
  const int h = item / 2;
  const bool is_v = item % 2;
  constexpr int EPC = 16 / sizeof(T);        // elements a 16-byte chunk
  const int row_chunks = D / EPC;
  const int row_words = D / 16;              // 16-byte words of int8
  uint4* tile = tiles + (size_t)warp * cap * row_chunks;
  const size_t tok_stride = (size_t)KVH * D;
  const uint32_t row_bytes = (uint32_t)(D * sizeof(T));
  const uint32_t tile_u32 = hp::smem_u32(tile);
  const uint32_t bar = hp::smem_u32(&bars[warp]);
  uint32_t phase = 0;
  if (lane == 0) {
    hp::mbar_init(bar, 1);
    hp::fence_barrier_init();
  }
  __syncwarp();

  for (int w = blockIdx.y / groups; ; w += gridDim.y / groups) {
    // The pair numbered w, the rows counted from the last (a step packs
    // its decode rows first, so its long prompt rows come first here and
    // their CTAs, the longest, are dispatched first): row r (the first
    // whose running page count passes w) and its j-th page.  Every lane
    // ends with the same row (its start, length, slot and buffer offset)
    // and j.
    int r = -1, j = 0, before = 0, start = 0, nt = 0, slot = 0, off = 0;
    for (int r0 = 0; r0 < R && r < 0; r0 += 32) {
      int rs = 0, rn = 0, rsl = 0, ro = 0;
      const int rr = R - 1 - (r0 + lane);  // the last row first
      if (rr >= 0) {
        rs = row_start[rr];
        rn = row_len[rr];
        rsl = row_slot[rr];
        ro = row_off[rr];
      }
      const int c = rn > 0 ? (rs + rn - 1) / page - rs / page + 1 : 0;
      int incl = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int x = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += x;
      }
      const unsigned hit =
          __ballot_sync(0xffffffffu, before + incl > w && c > 0);
      if (hit) {
        const int src = __ffs(hit) - 1;
        r = R - 1 - (r0 + src);
        j = w - before - (__shfl_sync(0xffffffffu, incl, src) -
                          __shfl_sync(0xffffffffu, c, src));
        start = __shfl_sync(0xffffffffu, rs, src);
        nt = __shfl_sync(0xffffffffu, rn, src);
        slot = __shfl_sync(0xffffffffu, rsl, src);
        off = __shfl_sync(0xffffffffu, ro, src);
      }
      before += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (r < 0) return;  // past the live pairs

    const int pg = start / page + j;
    const int base = pg * page;
    const int lo = max(base, start), hi = min(base + page, start + nt);
    const int n = hi - lo;                       // landing tokens, >= 1
    const int cell0 = lo - base;                 // first written cell
    // Token lo + i of the slot is buffer token off + (lo - start) + i.
    const T* src = (is_v ? v_new : k_new) +
                   (((size_t)l * T_ + off + (lo - start)) * KVH + h) * D;

    // 1. The landing rows: the first cap of them into shared memory by
    // bulk copies (one a row, all in flight at once, issued before the
    // page id is looked up), the rest read straight from device memory, U
    // loads a lane in flight; their absmax.
    const int n_tile = min(n, cap);
    if (n_tile > 0) {
      if (lane == 0) hp::mbar_expect_tx(bar, n_tile * row_bytes);
      __syncwarp();
      for (int t = lane; t < n_tile; t += 32)
        hp::bulk_load(tile_u32 + t * row_bytes, src + t * tok_stride,
                      row_bytes, bar);
    }
    int pid = block_tables[(size_t)slot * maxp + min(pg, maxp - 1)];
    pid = min(max(pid, 0), P - 1);
    float* scale =
        (is_v ? v_scales : k_scales) + ((size_t)l * P + pid) * KVH + h;
    uint4* pg_w = reinterpret_cast<uint4*>(
        (is_v ? v_pools : k_pools) +
        ((((size_t)l * KVH + h) * P + pid) * page) * (size_t)D);
    const float scale_in = lane == 0 ? *scale : 0.f;  // s_old, in flight
    float amax = 0.f;
    const int n_chunks = n * row_chunks;
    for (int i0 = n_tile * row_chunks + lane; i0 < n_chunks; i0 += 32 * U) {
      uint4 u[U];
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const int i = i0 + 32 * k;
        if (i < n_chunks)
          u[k] = *reinterpret_cast<const uint4*>(
              src + (i / row_chunks) * tok_stride +
              (size_t)(i % row_chunks) * EPC);
      }
#pragma unroll
      for (int k = 0; k < U; ++k)
        if (i0 + 32 * k < n_chunks) amax = fmaxf(amax, chunk_absmax(u[k], src));
    }
    if (n_tile > 0) {
      hp::mbar_wait(bar, phase);
      phase ^= 1;
      for (int i = lane; i < n_tile * row_chunks; i += 32)
        amax = fmaxf(amax, chunk_absmax(tile[i], src));
    }
    amax = rtt::group_max<32>(amax);
    const float s_old = __shfl_sync(0xffffffffu, scale_in, 0);
    const float needed = fmaxf(__fdiv_rn(amax, 127.f), 1e-8f);
    const bool fresh = base >= start;
    const float s_new = fresh ? needed : fmaxf(s_old, needed);

    // 2. The page's other cells: zero on a fresh page, requantised by
    // s_old / s_new when the scale grew, untouched when it held.
    if (fresh || s_new > s_old) {
      const float factor = fresh ? 0.f : __fdiv_rn(s_old, s_new);
      const int n_words = page * row_words;
      for (int i0 = lane; i0 < n_words; i0 += 32 * U) {
        uint4 old[U];
        bool mine[U];  // not a landing cell (those are written below)
#pragma unroll
        for (int k = 0; k < U; ++k) {
          const int i = i0 + 32 * k, cell = i / row_words;
          mine[k] = i < n_words && (cell < cell0 || cell >= cell0 + n);
          if (mine[k] && !fresh) old[k] = pg_w[i];
        }
#pragma unroll
        for (int k = 0; k < U; ++k)
          if (mine[k])
            pg_w[i0 + 32 * k] = fresh ? make_uint4(0u, 0u, 0u, 0u)
                                      : rtt::requant16(old[k], factor);
      }
    }
    __syncwarp();

    // 3. The landing rows, 16 values to one 16-byte store.
    for (int i = lane; i < n * row_words; i += 32) {
      const int t = i / row_words, c16 = (i % row_words) * 16;
      float x[16];
      load16(t < n_tile
                 ? reinterpret_cast<const T*>(tile + t * row_chunks) + c16
                 : src + t * tok_stride + c16,
             x);
#pragma unroll
      for (int e = 0; e < 16; ++e)
        x[e] = rtt::quant_biased(__fdiv_rn(x[e], s_new));
      pg_w[(size_t)cell0 * row_words + i] = rtt::pack16(x);
    }
    if (lane == 0) *scale = s_new;
    // The tile is rewritten by the next pair's bulk copies (async proxy)
    // only after every lane's reads.
    hp::fence_proxy_async();
    __syncwarp();
  }
}

}  // namespace

// dtype (of k_new/v_new): 0 = float32, 1 = bfloat16.  D is a multiple of
// 16.  pairs: the grid's bound on the live (row, page) pairs; cap: landing
// tokens a warp keeps in shared memory (the dynamic shared memory is
// WARPS * cap * D * element size).
extern "C" int rtt_ragged_append_quantized(
    void* k_pools, void* v_pools, void* k_scales, void* v_scales,
    const void* k_new, const void* v_new, const void* row_slot,
    const void* row_start, const void* row_len, const void* row_off,
    const void* block_tables, int dtype, int L, int T, int R, int KVH, int P,
    int page, int D, int maxp, int pairs, int cap, void* stream) {
  const int groups = (2 * KVH + WARPS - 1) / WARPS;
  const dim3 grid(L, pairs * groups);
  const size_t smem = (size_t)WARPS * cap * D * (dtype == 0 ? 4 : 2);
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
  cudaError_t err;
  if (dtype == 0) {
    err = cudaFuncSetAttribute(ragged_append_quantized_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    ragged_append_quantized_kernel<float><<<grid, THREADS, smem, s>>>(
        kp, vp, ks, vs, static_cast<const float*>(k_new),
        static_cast<const float*>(v_new), rs, rst, rl, ro, bt, T, R, KVH, P,
        page, D, maxp, groups, cap);
  } else {
    err = cudaFuncSetAttribute(ragged_append_quantized_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    ragged_append_quantized_kernel<__nv_bfloat16><<<grid, THREADS, smem, s>>>(
        kp, vp, ks, vs, static_cast<const __nv_bfloat16*>(k_new),
        static_cast<const __nv_bfloat16*>(v_new), rs, rst, rl, ro, bt, T, R,
        KVH, P, page, D, maxp, groups, cap);
  }
  return (int)cudaGetLastError();
}
