// K2 — paged append: one new k/v row per slot, for every layer, in place.
//
// Replaces ray_tpu/ops/paged_attention.py paged_append (Pallas body
// _append_kernel, pallas_call at :564).
//
// pools [L, KVH, P, page, D], k_new/v_new [L, B, KVH, D], pids/offs [B]:
// writes k_new[l, b, h] to pools[l, h, pids[b], offs[b]].  Page ids are
// clamped to P - 1, the pool's scratch page: the OOB convention by
// which inactive slots write there and never onto a live page.
//
// What bounds it on the H100: bytes — 2 * L * B * KVH * D elements read
// and written once, no arithmetic.  At decode sizes (2 MB at LLAMA3_8B, 8
// slots: 0.6 us of bytes) that is far below a launch, so the kernel is a
// chain of dependent loads and stores behind one: a row's load, then its
// store, whose address needs the slot's page id and offset.
//
// Design: the TPU kernel rewrites a whole page by masked copy (a Mosaic
// tiling constraint); here each thread copies one 16-byte word of a k row
// and one of a v row straight into the pool.  A CTA is a 2-D block, (word
// of the row, kv head), for one (slot, layer), so no index is divided.
// Every row load is issued before the page id and offset loads, which only
// the stores need, so the two round trips to device memory overlap.  CTAs
// of 2 or 4 layers (2 or 4 words of k and of v in flight a thread, a grid
// of about one wave) measured slower than one layer a CTA at 8 and at 48
// slots, the more so the more layers: at these sizes the finer grid
// spreads the stores better.  The pool is updated in place: its owner (the
// engine's cache) sees the write, nothing is returned.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(1024) paged_append_kernel(
    uint4* __restrict__ k_pools, uint4* __restrict__ v_pools,
    const uint4* __restrict__ k_new, const uint4* __restrict__ v_new,
    const int* __restrict__ pids, const int* __restrict__ offs, int B,
    int KVH, int P, int page) {
  const int c = threadIdx.x, row_vecs = blockDim.x;  // 16-byte word
  const int h = blockIdx.z * blockDim.y + threadIdx.y;
  const int b = blockIdx.x, l = blockIdx.y;
  if (h >= KVH) return;
  const size_t src = (((size_t)l * B + b) * KVH + h) * row_vecs + c;
  const uint4 kx = k_new[src];
  const uint4 vx = v_new[src];
  const int pid = min(max(pids[b], 0), P - 1);
  const int off = min(max(offs[b], 0), page - 1);
  const size_t dst =
      ((((size_t)l * KVH + h) * P + pid) * page + off) * row_vecs + c;
  k_pools[dst] = kx;
  v_pools[dst] = vx;
}

}  // namespace

// row_bytes = D * sizeof(element), a multiple of 16, at most 16 KB.
extern "C" int rtt_paged_append(void* k_pools, void* v_pools,
                                const void* k_new, const void* v_new,
                                const void* pids, const void* offs, int L,
                                int B, int KVH, int P, int page, int row_bytes,
                                void* stream) {
  const int row_vecs = row_bytes / 16;
  if (row_bytes % 16 || row_vecs < 1 || row_vecs > 1024)
    return (int)cudaErrorInvalidValue;
  const int heads = min(KVH, 1024 / row_vecs);  // kv heads a CTA
  const dim3 grid(B, L, (KVH + heads - 1) / heads);
  paged_append_kernel<<<grid, dim3(row_vecs, heads), 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(k_pools), static_cast<uint4*>(v_pools),
      static_cast<const uint4*>(k_new), static_cast<const uint4*>(v_new),
      static_cast<const int*>(pids), static_cast<const int*>(offs), B, KVH, P,
      page);
  return (int)cudaGetLastError();
}
