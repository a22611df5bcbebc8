// K5 — ragged paged append: every row's fresh k/v, all layers, in place.
//
// Replaces ray_tpu/ops/ragged_paged_attention.py ragged_paged_append
// (Pallas body _ragged_append_kernel, pallas_call at :546).
//
// pools [L, KVH, P, page, D], k_new/v_new [L, T, KVH, D], rows (slot,
// start, len, off) x R, block_tables [slots, maxp]: token t < len of row
// r lands at pos = start + t, in page
// clamp(block_tables[slot][min(pos / page, maxp - 1)], 0, P - 1) at
// offset pos % page, for every layer and kv head.
//
// What bounds it on the H100: bytes — each fresh k/v row read once and
// written once, no arithmetic; at decode sizes, launch latency.
//
// Design: the TPU kernel rewrites whole pages by a one-hot matmul over
// its q window, and needs a "dead cells write the scratch page" index
// map because an aliased copy-through could clobber a fresh append.  A
// CUDA thread copies exactly one 16-byte piece of one token's row, so
// tokens outside every row are simply never touched and no live page is
// written for them.  One CTA per (row, layer, 16 tokens of the row);
// tiles past the row's length exit at once.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int TOKENS = 16;  // tokens of one row per CTA

__global__ void __launch_bounds__(THREADS) ragged_append_kernel(
    uint4* __restrict__ k_pools, uint4* __restrict__ v_pools,
    const uint4* __restrict__ k_new, const uint4* __restrict__ v_new,
    const int* __restrict__ row_slot, const int* __restrict__ row_start,
    const int* __restrict__ row_len, const int* __restrict__ row_off,
    const int* __restrict__ block_tables, int T, int KVH, int P, int page,
    int maxp, int row_vecs) {
  const int r = blockIdx.x, l = blockIdx.y;
  const int t0 = blockIdx.z * TOKENS;
  const int len = row_len[r];
  if (t0 >= len) return;  // also padding rows (len 0)
  const int nt = min(TOKENS, len - t0);
  const int slot = row_slot[r], start = row_start[r], off = row_off[r];
  const int* bt_row = block_tables + (size_t)slot * maxp;
  const int per_tok = KVH * row_vecs;
  for (int i = threadIdx.x; i < nt * per_tok; i += THREADS) {
    const int t = t0 + i / per_tok;
    const int h = (i % per_tok) / row_vecs, c = i % row_vecs;
    const int pos = start + t;
    int pid = bt_row[min(pos / page, maxp - 1)];
    pid = min(max(pid, 0), P - 1);
    const size_t dst =
        ((((size_t)l * KVH + h) * P + pid) * page + pos % page) * row_vecs + c;
    const size_t src = (((size_t)l * T + off + t) * KVH + h) * row_vecs + c;
    k_pools[dst] = k_new[src];
    v_pools[dst] = v_new[src];
  }
}

}  // namespace

// row_bytes = D * sizeof(element), a multiple of 16; n_tiles =
// ceil(T / 16).
extern "C" int rtt_ragged_append(void* k_pools, void* v_pools,
                                 const void* k_new, const void* v_new,
                                 const void* row_slot, const void* row_start,
                                 const void* row_len, const void* row_off,
                                 const void* block_tables, int L, int T, int R,
                                 int KVH, int P, int page, int maxp,
                                 int row_bytes, int n_tiles, void* stream) {
  ragged_append_kernel<<<dim3(R, L, n_tiles), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(k_pools), static_cast<uint4*>(v_pools),
      static_cast<const uint4*>(k_new), static_cast<const uint4*>(v_new),
      static_cast<const int*>(row_slot), static_cast<const int*>(row_start),
      static_cast<const int*>(row_len), static_cast<const int*>(row_off),
      static_cast<const int*>(block_tables), T, KVH, P, page, maxp,
      row_bytes / 16);
  return (int)cudaGetLastError();
}
