// K1 — paged decode attention partials (one q token per slot), and
// K13 — normalised paged decode attention over one layer's pages.
//
// Replaces ray_tpu/ops/paged_attention.py paged_decode_attention_partial
// (Pallas body _kernel_partial, pallas_call at :347): bf16/f32 pools, and
// int8 pools with one f32 scale per physical page and kv head
// ([L, P, KVH, 1], page-major; true value = int8 * scale).
//
// Computes, for slot b and query head h against the PAST tokens of the
// layered page pool [L, KVH, P, page, D] (block table [B, maxp],
// lengths [B]): the unnormalised f32 accumulator acc = sum_t p_t v_t,
// the running max m and denominator l = sum_t p_t with
// p_t = exp(s_t - m), s_t = soft_cap(q . k_t * D^-0.5).  The caller
// folds in the current token (combine_with_self) and normalises.
//
// What bounds it on the H100: bytes.  Each live k/v row is read once
// per kv-head group and used by qpg = H/KVH query rows, i.e. about
// 2*qpg flops per byte — far below the ~295 flop/byte ridge.
//
// Design: one CTA per (slot, kv-head, page split).  B*KVH alone is 64
// CTAs at 8B decode shapes, half the SMs, each walking up to maxp pages
// in sequence; so the page axis splits into chunks of pages_per_split
// pages (chosen by the wrapper from the SM count), each chunk's CTA
// writes f32 partials (acc, m, l), and a second kernel merges the
// splits.  A CTA walks only the slot's live pages (ceil(len/page));
// entries past them hold the OOB sentinel and are never read.  Each
// page's k and v rows are staged into shared memory with 16-byte
// coalesced loads (f32 rows padded by 16 bytes, so the per-token score
// reads are bank-conflict free), all qpg query heads of the group are
// scored against the staged page (so each k/v byte leaves HBM once per
// group), and the online softmax keeps m, l in shared memory and acc
// in registers, in f32.  No TPU sublane padding of the q group
// (_MIN_QPG) is carried over.
//
// int8 pools (QUANT): a page's int8 bytes are staged the same way (half
// the bytes of bf16 leave HBM) and converted to f32 exactly; the page's
// two scales are read once per (page, kv head); the k scale multiplies
// the page's scores after the q.k dot, before the soft cap and the mask,
// and the v scale multiplies the page's p.v sum before it joins the
// accumulator.  m, l and acc stay f32 and unnormalised.
//
// K13 replaces ray_tpu/ops/paged_attention.py paged_decode_attention
// (Pallas body _kernel, pallas_call at :157): q [B, H, D] against one
// layer's bf16/f32 pages [KVH, P, page, D], lengths counting every token
// (the current one included), out = sum_t p_t v_t / sum_t p_t in q's
// dtype, 0 for a slot with no token.  It runs K1's page-split body on the
// pages as a one-layer pool, always into per-split partials, then its own
// epilogue (merge_normalise_kernel) merges the splits and divides, where
// the TPU kernel divided at its last grid step.  Bytes bound it, as K1.
// The Pallas body rounds p to bf16 before p.v on bf16 pages; K1's body
// keeps p in f32, so in bf16 the two differ by about a bf16 ulp of p.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_E = 4;  // accumulators per thread: qpg*D <= 1024

template <typename T, typename TK, bool QUANT>
__global__ void __launch_bounds__(THREADS) paged_decode_partial_kernel(
    const T* __restrict__ q, const TK* __restrict__ k_pools,
    const TK* __restrict__ v_pools, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ block_table,
    const int* __restrict__ lengths, float* __restrict__ acc_out,
    float* __restrict__ m_out, float* __restrict__ l_out, int layer,
    int KVH, int P, int page, int D, int qpg, int maxp, int pages_per_split,
    float scale, float soft_cap) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.x, g = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x;
  const int H = KVH * qpg;
  const int kst = D + 4;  // padded f32 row stride of the staged k page
  float* k_s = smem;                  // [page][D + 4]
  float* v_s = k_s + page * kst;      // [page][D]
  float* q_s = v_s + page * D;        // [qpg][D]
  float* p_s = q_s + qpg * D;         // [qpg][page] scores, then probs
  float* m_s = p_s + qpg * page;      // [qpg] running max
  float* l_s = m_s + qpg;             // [qpg] running denominator
  float* c_s = l_s + qpg;             // [qpg] this page's correction

  const T* qg = q + ((size_t)b * H + (size_t)g * qpg) * D;
  for (int i = tid; i < qpg * D; i += THREADS) q_s[i] = rtt::to_float(qg[i]);
  if (tid < qpg) {
    m_s[tid] = rtt::NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[MAX_E];
#pragma unroll
  for (int e = 0; e < MAX_E; ++e) acc[e] = 0.f;

  const int len = lengths[b];
  const int p_begin = split * pages_per_split;
  const int p_end =
      min(min((len + page - 1) / page, maxp), p_begin + pages_per_split);
  const size_t page_elems = (size_t)page * D;
  const size_t head_off = ((size_t)layer * KVH + g) * (size_t)P * page_elems;
  const TK* k_head = k_pools + head_off;
  const TK* v_head = v_pools + head_off;
  constexpr int N = rtt::Vec<TK>::N;
  const int chunks = D / N;
  const int warp = tid / 32, lane = tid % 32;
  __syncthreads();

  for (int p = p_begin; p < p_end; ++p) {
    int pid = block_table[(size_t)b * maxp + p];
    pid = min(max(pid, 0), P - 1);
    const TK* kp = k_head + (size_t)pid * page_elems;
    const TK* vp = v_head + (size_t)pid * page_elems;
    const int n_valid = min(page, len - p * page);
    float ks = 1.f, vs = 1.f;
    if (QUANT) {
      const size_t so = ((size_t)layer * P + pid) * KVH + g;
      ks = k_scales[so];
      vs = v_scales[so];
    }

    for (int i = tid; i < n_valid * chunks; i += THREADS) {
      const int t = i / chunks, c = (i % chunks) * N;
      float tmp[N];
      rtt::Vec<TK>::load(kp + (size_t)t * D + c, tmp);
#pragma unroll
      for (int j = 0; j < N; ++j) k_s[t * kst + c + j] = tmp[j];
      rtt::Vec<TK>::load(vp + (size_t)t * D + c, tmp);
#pragma unroll
      for (int j = 0; j < N; ++j) v_s[t * D + c + j] = tmp[j];
    }
    __syncthreads();

    for (int i = tid; i < qpg * page; i += THREADS) {
      const int qi = i / page, t = i % page;
      float s = rtt::NEG_INF;
      if (t < n_valid) {
        const float4* kr = reinterpret_cast<const float4*>(k_s + t * kst);
        const float4* qr = reinterpret_cast<const float4*>(q_s + qi * D);
        float dot = 0.f;
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const float4 a = qr[d4], kk = kr[d4];
          dot += a.x * kk.x + a.y * kk.y + a.z * kk.z + a.w * kk.w;
        }
        s = dot * scale;
        if (QUANT) s = s * ks;
        if (soft_cap > 0.f) s = soft_cap * tanhf(s / soft_cap);
      }
      p_s[qi * page + t] = s;
    }
    __syncthreads();

    for (int qi = warp; qi < qpg; qi += THREADS / 32) {
      float* row = p_s + qi * page;
      float mx = rtt::NEG_INF;
      for (int t = lane; t < n_valid; t += 32) mx = fmaxf(mx, row[t]);
      mx = rtt::group_max<32>(mx);
      const float m_prev = m_s[qi];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < page; t += 32) {
        const float e = t < n_valid ? expf(row[t] - m_new) : 0.f;
        row[t] = e;
        sum += e;
      }
      sum = rtt::group_sum<32>(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[qi] = corr;
        l_s[qi] = corr * l_s[qi] + sum;
        m_s[qi] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int e = 0; e < MAX_E; ++e) {
      const int idx = tid + e * THREADS;
      if (idx < qpg * D) {
        const int qi = idx / D, d = idx % D;
        const float* prow = p_s + qi * page;
        if (QUANT) {
          float pv = 0.f;
          for (int t = 0; t < n_valid; ++t) pv += prow[t] * v_s[t * D + d];
          acc[e] = acc[e] * c_s[qi] + pv * vs;
        } else {
          float a = acc[e] * c_s[qi];
          for (int t = 0; t < n_valid; ++t) a += prow[t] * v_s[t * D + d];
          acc[e] = a;
        }
      }
    }
    __syncthreads();  // the next page overwrites k_s, v_s, p_s, c_s
  }

  // Partials of split s live at rows [s, b, h] of [nsplit, B, H].
  const size_t row0 =
      ((size_t)split * gridDim.x + b) * H + (size_t)g * qpg;
#pragma unroll
  for (int e = 0; e < MAX_E; ++e) {
    const int idx = tid + e * THREADS;
    if (idx < qpg * D) acc_out[row0 * D + idx] = acc[e];
  }
  if (tid < qpg) {
    m_out[row0 + tid] = m_s[tid];
    l_out[row0 + tid] = l_s[tid];
  }
}

// Merge the page splits of one (slot, head) row: m = max_s m_s,
// l = sum_s l_s e^(m_s - m), acc = sum_s acc_s e^(m_s - m).  Empty
// splits carry m_s = -1e30, l_s = 0, acc_s = 0 and drop out; a slot
// with no live token keeps m = -1e30, l = 0, acc = 0.
__global__ void merge_splits_kernel(const float* __restrict__ part_acc,
                                    const float* __restrict__ part_m,
                                    const float* __restrict__ part_l,
                                    float* __restrict__ acc_out,
                                    float* __restrict__ m_out,
                                    float* __restrict__ l_out, int rows,
                                    int D, int nsplit) {
  const int row = blockIdx.x;
  float mx = rtt::NEG_INF;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, part_m[s * rows + row]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < nsplit; ++s)
      a += part_acc[((size_t)s * rows + row) * D + d] *
           expf(part_m[s * rows + row] - mx);
    acc_out[(size_t)row * D + d] = a;
  }
  if (threadIdx.x == 0) {
    float l = 0.f;
    for (int s = 0; s < nsplit; ++s)
      l += part_l[s * rows + row] * expf(part_m[s * rows + row] - mx);
    m_out[row] = mx;
    l_out[row] = l;
  }
}

// K13's epilogue: merge the splits of one (slot, head) row as
// merge_splits_kernel does, then out = acc / l in q's dtype, with l = 0
// (no live token) dividing by 1, so the row is 0.
template <typename T>
__global__ void merge_normalise_kernel(const float* __restrict__ part_acc,
                                       const float* __restrict__ part_m,
                                       const float* __restrict__ part_l,
                                       T* __restrict__ out, int rows, int D,
                                       int nsplit) {
  const int row = blockIdx.x;
  float mx = rtt::NEG_INF;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, part_m[s * rows + row]);
  float l = 0.f;
  for (int s = 0; s < nsplit; ++s)
    l += part_l[s * rows + row] * expf(part_m[s * rows + row] - mx);
  const float l_safe = l == 0.f ? 1.f : l;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < nsplit; ++s)
      a += part_acc[((size_t)s * rows + row) * D + d] *
           expf(part_m[s * rows + row] - mx);
    out[(size_t)row * D + d] = rtt::from_float<T>(a / l_safe);
  }
}

size_t partial_smem(int page, int D, int qpg) {
  return sizeof(float) * ((size_t)page * (D + 4) + (size_t)page * D +
                          (size_t)qpg * D + (size_t)qpg * page + 3 * qpg);
}

template <typename T>
int launch_normalised(const void* q, const void* k_pages, const void* v_pages,
                      const void* block_table, const void* lengths, void* out,
                      float* part_acc, float* part_m, float* part_l, int B,
                      int KVH, int P, int page, int D, int qpg, int maxp,
                      int pages_per_split, float scale, float soft_cap,
                      cudaStream_t stream) {
  const int nsplit = (maxp + pages_per_split - 1) / pages_per_split;
  const size_t smem = partial_smem(page, D, qpg);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_partial_kernel<T, T, false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  paged_decode_partial_kernel<T, T, false>
      <<<dim3(B, KVH, nsplit), THREADS, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k_pages),
          static_cast<const T*>(v_pages), nullptr, nullptr,
          static_cast<const int*>(block_table),
          static_cast<const int*>(lengths), part_acc, part_m, part_l, 0, KVH,
          P, page, D, qpg, maxp, pages_per_split, scale, soft_cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rows = B * KVH * qpg;
  const int threads = D < 32 ? 32 : (D > 256 ? 256 : D);
  merge_normalise_kernel<T><<<rows, threads, 0, stream>>>(
      part_acc, part_m, part_l, static_cast<T*>(out), rows, D, nsplit);
  return (int)cudaGetLastError();
}

template <typename T, typename TK, bool QUANT>
int launch(const void* q, const void* k_pools, const void* v_pools,
           const void* k_scales, const void* v_scales,
           const void* block_table, const void* lengths, float* acc, float* m,
           float* l, float* part_acc, float* part_m, float* part_l, int B,
           int KVH, int P, int page, int D, int qpg, int maxp,
           int pages_per_split, int layer, float scale, float soft_cap,
           cudaStream_t stream) {
  const int nsplit = (maxp + pages_per_split - 1) / pages_per_split;
  const size_t smem = partial_smem(page, D, qpg);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_partial_kernel<T, TK, QUANT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // One split writes the outputs directly; several write partials.
  const bool direct = nsplit == 1;
  paged_decode_partial_kernel<T, TK, QUANT>
      <<<dim3(B, KVH, nsplit), THREADS, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const TK*>(k_pools),
          static_cast<const TK*>(v_pools),
          static_cast<const float*>(k_scales),
          static_cast<const float*>(v_scales),
          static_cast<const int*>(block_table),
          static_cast<const int*>(lengths), direct ? acc : part_acc,
          direct ? m : part_m, direct ? l : part_l, layer, KVH, P, page, D,
          qpg, maxp, pages_per_split, scale, soft_cap);
  err = cudaGetLastError();
  if (err != cudaSuccess || direct) return (int)err;
  const int rows = B * KVH * qpg;
  const int threads = D < 32 ? 32 : (D > 256 ? 256 : D);
  merge_splits_kernel<<<rows, threads, 0, stream>>>(
      part_acc, part_m, part_l, acc, m, l, rows, D, nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of q): 0 = float32, 1 = bfloat16.  The pools have q's dtype when
// k_scales is null, and are int8 with f32 scales [L, P, KVH, 1] when it is
// not.  soft_cap <= 0 means none.  The partial buffers hold
// [ceil(maxp / pages_per_split), B, H] rows (f32, times D for part_acc);
// unused when one split covers maxp.
extern "C" int rtt_paged_decode_partial(
    const void* q, const void* k_pools, const void* v_pools,
    const void* k_scales, const void* v_scales, const void* block_table,
    const void* lengths, void* acc, void* m, void* l, void* part_acc,
    void* part_m, void* part_l, int dtype, int B, int KVH, int P, int page,
    int D, int qpg, int maxp, int pages_per_split, int layer, float scale,
    float soft_cap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(acc);
  float* mm = static_cast<float*>(m);
  float* ll = static_cast<float*>(l);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
#define RTT_K1_LAUNCH(T, TK, QUANT)                                          \
  launch<T, TK, QUANT>(q, k_pools, v_pools, k_scales, v_scales, block_table, \
                       lengths, a, mm, ll, pa, pm, pl, B, KVH, P, page, D,   \
                       qpg, maxp, pages_per_split, layer, scale, soft_cap, s)
  if (k_scales != nullptr)
    return dtype == 0 ? RTT_K1_LAUNCH(float, int8_t, true)
                      : RTT_K1_LAUNCH(__nv_bfloat16, int8_t, true);
  return dtype == 0 ? RTT_K1_LAUNCH(float, float, false)
                    : RTT_K1_LAUNCH(__nv_bfloat16, __nv_bfloat16, false);
#undef RTT_K1_LAUNCH
}

// K13.  dtype (of q and the pages): 0 = float32, 1 = bfloat16.  The
// pages are one layer's [KVH, P, page, D]; the partial buffers hold
// [ceil(maxp / pages_per_split), B, H] rows (f32, times D for part_acc);
// out is [B, H, D] in q's dtype.  soft_cap <= 0 means none.
extern "C" int rtt_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_table, const void* lengths, void* out, void* part_acc,
    void* part_m, void* part_l, int dtype, int B, int KVH, int P, int page,
    int D, int qpg, int maxp, int pages_per_split, float scale,
    float soft_cap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  if (dtype == 0)
    return launch_normalised<float>(q, k_pages, v_pages, block_table, lengths,
                                    out, pa, pm, pl, B, KVH, P, page, D, qpg,
                                    maxp, pages_per_split, scale, soft_cap, s);
  return launch_normalised<__nv_bfloat16>(
      q, k_pages, v_pages, block_table, lengths, out, pa, pm, pl, B, KVH, P,
      page, D, qpg, maxp, pages_per_split, scale, soft_cap, s);
}
