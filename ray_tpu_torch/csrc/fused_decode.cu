// K7 — one fused decode layer (one query token per slot).
//
// Replaces ray_tpu/ops/fused_decode.py fused_decode_layer (Pallas body
// _fused_kernel, pallas_call at :477): RMSNorm -> qkv projection (int8,
// bf16 or f32 weights, per-column scale on the result) -> RoPE -> paged
// attention over the slot's pages (bf16/f32 pools, or int8 pools with one
// f32 scale per page and kv head), READ-ONLY -> the current token's self
// term -> o-projection + residual -> RMSNorm -> gate/up/SiLU/down +
// residual.  x [B, D] in the activation dtype in; x_out [B, D], k_new and
// v_new [B, KVH, hd] out (the caller appends every layer's rows after the
// layer loop with K2 or K3).
//
// What bounds it on the H100: at decode widths (B = 8 to 48) the weight
// bytes of the layer (218 MB of int8 at LLAMA3_8B) plus the live pages.
// The phases are the chain of fused_layer.cuh (the projections on its
// WGMMA route wherever the wrapper can take it); this file holds the
// attention phase and the C entry.  The attention output ao is rounded to
// the activation dtype as it is stored (the o-projection's operand).
//
// Attention: one CTA of 128 threads per (slot, kv head) walks the slot's
// live pages (ceil(len / page), none for an empty slot), staging each
// page's k and v rows in shared memory as f32 so the qpg query heads of
// the group share every staged byte.  Rounding is the Pallas kernel's:
// the page dot takes q and the page in the activation dtype (exact for
// int8 and same-dtype pools), the probabilities are rounded to it for
// p.v while l sums the unrounded ones, int8 scales multiply the score
// after the dot (before the soft cap and the mask) and the page's p.v
// sum; the self term uses the unrounded f32 q against the rounded fresh
// k/v: o = (acc corr + p_self v) / (l corr + p_self).
#include "fused_layer.cuh"

namespace {

using namespace rtt::fused;

constexpr int A_THREADS = 128;

template <typename TA, typename TP, bool QUANT>
__global__ void __launch_bounds__(A_THREADS) decode_attn_kernel(
    const float* __restrict__ qkv, int Cq, const TA* __restrict__ k_new,
    const TA* __restrict__ v_new, const TP* __restrict__ k_pools,
    const TP* __restrict__ v_pools, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ bt,
    const int* __restrict__ lengths, TA* __restrict__ ao, int KVH,
    int qpg, int hd, int P, int page, int maxp, int layer, float scale,
    float soft_cap) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.x, g = blockIdx.y, tid = threadIdx.x;
  const int H = KVH * qpg;
  const int kst = hd + 4;
  const int nq = qpg * hd;
  float* q_s = smem;               // [qpg][hd] f32 q (self term)
  float* qd_s = q_s + nq;          // [qpg][hd] q in the dot dtype
  float* acc_s = qd_s + nq;        // [qpg][hd]
  float* k_s = acc_s + nq;         // [page][hd + 4]
  float* v_s = k_s + page * kst;   // [page][hd]
  float* p_s = v_s + page * hd;    // [qpg][page]
  float* m_s = p_s + qpg * page;   // [qpg]
  float* l_s = m_s + qpg;          // [qpg]
  float* c_s = l_s + qpg;          // [qpg] this page's correction
  float* o_s = c_s + qpg;          // [3 * qpg] self-term factors

  const float* qg = qkv + (size_t)b * Cq + (size_t)g * qpg * hd;
  for (int i = tid; i < nq; i += A_THREADS) {
    const float v = qg[i];
    q_s[i] = v;
    qd_s[i] = round_to<TA>(v);
    acc_s[i] = 0.f;
  }
  if (tid < qpg) {
    m_s[tid] = rtt::NEG_INF;
    l_s[tid] = 0.f;
  }
  const int len = lengths[b];
  const int npages = min((len + page - 1) / page, maxp);
  const size_t page_elems = (size_t)page * hd;
  const size_t head_off = ((size_t)layer * KVH + g) * (size_t)P * page_elems;
  constexpr int N = rtt::Vec<TP>::N;
  const int chunks = hd / N;
  const int warp = tid / 32, lane = tid % 32;
  __syncthreads();

  for (int p = 0; p < npages; ++p) {
    const int pid = min(max(bt[(size_t)b * maxp + p], 0), P - 1);
    const TP* kp = k_pools + head_off + (size_t)pid * page_elems;
    const TP* vp = v_pools + head_off + (size_t)pid * page_elems;
    const int n_valid = min(page, len - p * page);
    float ks = 1.f, vs = 1.f;
    if (QUANT) {
      const size_t so = ((size_t)layer * P + pid) * KVH + g;
      ks = k_scales[so];
      vs = v_scales[so];
    }
    for (int i = tid; i < n_valid * chunks; i += A_THREADS) {
      const int t = i / chunks, c = (i % chunks) * N;
      float tmp[N];
      rtt::Vec<TP>::load(kp + (size_t)t * hd + c, tmp);
#pragma unroll
      for (int j = 0; j < N; ++j) k_s[t * kst + c + j] = round_to<TA>(tmp[j]);
      rtt::Vec<TP>::load(vp + (size_t)t * hd + c, tmp);
#pragma unroll
      for (int j = 0; j < N; ++j) v_s[t * hd + c + j] = round_to<TA>(tmp[j]);
    }
    __syncthreads();

    for (int i = tid; i < qpg * page; i += A_THREADS) {
      const int qi = i / page, t = i % page;
      float s = rtt::NEG_INF;
      if (t < n_valid) {
        const float* kr = k_s + t * kst;
        const float* qr = qd_s + qi * hd;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = __fmul_rn(dot, scale);
        if (QUANT) s = __fmul_rn(s, ks);
        s = capped(s, soft_cap);
      }
      p_s[qi * page + t] = s;
    }
    __syncthreads();

    for (int qi = warp; qi < qpg; qi += A_THREADS / 32) {
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

    for (int i = tid; i < nq; i += A_THREADS) {
      const int qi = i / hd, d = i % hd;
      const float* prow = p_s + qi * page;
      float pv = 0.f;
      for (int t = 0; t < n_valid; ++t)
        pv = fmaf(round_to<TA>(prow[t]), v_s[t * hd + d], pv);
      if (QUANT) pv = __fmul_rn(pv, vs);
      acc_s[i] = acc_s[i] * c_s[qi] + pv;
    }
    __syncthreads();  // the next page overwrites k_s, v_s, p_s, c_s
  }

  // The current token's self term, from the rounded fresh k/v.
  const TA* kn = k_new + ((size_t)b * KVH + g) * hd;
  const TA* vn = v_new + ((size_t)b * KVH + g) * hd;
  for (int qi = warp; qi < qpg; qi += A_THREADS / 32) {
    float dot = 0.f;
    for (int d = lane; d < hd; d += 32)
      dot = fmaf(q_s[qi * hd + d], rtt::to_float(kn[d]), dot);
    dot = rtt::group_sum<32>(dot);
    if (lane == 0) {
      const float s = capped(__fmul_rn(dot, scale), soft_cap);
      const float m_prev = m_s[qi];
      const float m_new = fmaxf(m_prev, s);
      const float corr = expf(m_prev - m_new);
      const float p_self = expf(s - m_new);
      o_s[qi] = corr;
      o_s[qpg + qi] = p_self;
      o_s[2 * qpg + qi] = l_s[qi] * corr + p_self;
    }
  }
  __syncthreads();
  TA* out = ao + (size_t)b * H * hd + (size_t)g * nq;
  for (int i = tid; i < nq; i += A_THREADS) {
    const int qi = i / hd, d = i % hd;
    out[i] = rtt::from_float<TA>(
        (acc_s[i] * o_s[qi] + o_s[qpg + qi] * rtt::to_float(vn[d])) /
        o_s[2 * qpg + qi]);
  }
}

template <typename TA, typename TP, bool QUANT>
int launch_attn(const LayerArgs& A, cudaStream_t st) {
  const int qpg = A.H / A.KVH;
  const size_t smem =
      sizeof(float) * (3 * (size_t)qpg * A.hd + (size_t)A.page * (A.hd + 4) +
                       (size_t)A.page * A.hd + (size_t)qpg * A.page + 6 * qpg);
  cudaError_t err = cudaFuncSetAttribute(
      decode_attn_kernel<TA, TP, QUANT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_attn_kernel<TA, TP, QUANT>
      <<<dim3(A.rows, A.KVH), A_THREADS, smem, st>>>(
          A.qkv_buf, (A.H + 2 * A.KVH) * A.hd,
          static_cast<const TA*>(A.k_new), static_cast<const TA*>(A.v_new),
          static_cast<const TP*>(A.k_pools), static_cast<const TP*>(A.v_pools),
          A.k_scales, A.v_scales, A.block_tables, A.lengths,
          static_cast<TA*>(A.ao), A.KVH, qpg,
          A.hd, A.P, A.page, A.maxp, A.layer, A.scale, A.soft_cap);
  return (int)cudaGetLastError();
}

template <typename TA>
int run(const LayerArgs& A) {
  cudaStream_t st = static_cast<cudaStream_t>(A.stream);
  int err = run_qkv<TA>(A, st);
  if (err) return err;
  if (A.pool_type == I8)
    err = launch_attn<TA, int8_t, true>(A, st);
  else
    err = launch_attn<TA, TA, false>(A, st);
  if (err) return err;
  return run_mlp<TA>(A, st);
}

}  // namespace

// One fused decode layer on the caller's stream; returns the first
// cudaError_t of the chain (0 when every launch was accepted).  The pools
// have the activation dtype, or are int8 with k_scales/v_scales.
extern "C" int rtt_fused_decode_layer(const rtt::fused::LayerArgs* args) {
  return args->act_type == rtt::fused::F32 ? run<float>(*args)
                                           : run<__nv_bfloat16>(*args);
}
