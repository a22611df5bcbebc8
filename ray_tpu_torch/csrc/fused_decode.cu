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
// The phases are the chain of fused_layer.cuh: over int8 weights at most
// 64 tokens take its DECODE route (a persistent stream-K grid streaming
// the weights, RoPE folded into the qkv epilogue at head_dim 128), else
// its WGMMA or CUDA-core routes.  This file holds the attention phase and
// the C entry.  The attention output ao is rounded to the activation dtype as
// it is stored (the o-projection's operand).
//
// Attention: bf16 activations at head_dim 128 take decode_attn_tc below
// (TMA pages, mma.sync).  Otherwise one CTA of 128 threads per (slot, kv
// head) walks the slot's
// live pages (ceil(len / page), none for an empty slot), staging each
// page's k and v rows in shared memory as f32 so the qpg query heads of
// the group share every staged byte.  Both round as the Pallas kernel:
// the page dot takes q and the page in the activation dtype (exact for
// int8 and same-dtype pools), the probabilities are rounded to it for
// p.v while l sums the unrounded ones, int8 scales multiply the score
// after the dot (before the soft cap and the mask) and the page's p.v
// sum; the self term uses the unrounded f32 q against the rounded fresh
// k/v: o = (acc corr + p_self v) / (l corr + p_self).
#include <type_traits>

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

// ---------------------------------------------------------------------------
// The attention phase on the tensor cores (bf16 activations, head_dim 128,
// bf16 or int8 pools, pages of 16, 32 or 64, at most 16 query heads a kv
// head): one CTA of four warps per (slot, kv head).  The slot's pages
// arrive whole by
// TMA (two 64-column boxes of a bf16 page or one 128-byte box of an int8
// page, 128-byte swizzle) into a ring that keeps every page of a short
// past in flight at once; the group's query heads are the rows of
// mma.sync m16n8k16 tiles, so q.k^T and p.v are two short runs of tensor
// products a page (every warp takes the page's scores, each warp the p.v
// of 32 of the 128 dims), and the page walk keeps the plain version's
// order and
// rounding: q and the page in bf16 (int8 exact), the page's running max,
// p rounded to bf16 for p.v while l sums it unrounded, int8 scales on the
// score and on the page's p.v.  int8 pages are converted as they are
// read (ldmatrix of byte pairs, then the byte-permute conversion): k's
// 16-byte rows give a lane dims 4t .. 4t + 3, so the dot's k-slots are
// permuted (q is built in the same order), and v's transposed pairs give
// columns 2g and 2g + 1, so a lane's outputs are dims 4t .. 4t + 3 of a
// 16-column chunk.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

constexpr int TC_HD = 128;

template <int PAGE, bool I8P>
struct TcLayout {
  static constexpr int PAGE_BYTES = PAGE * TC_HD * (I8P ? 1 : 2);
  static constexpr int STAGES = I8P ? 4 : 2;
  static constexpr int SMEM = STAGES * 2 * PAGE_BYTES + 1024;
};

constexpr int TC_WARPS = 4;  // each owns 32 of the 128 output dims

template <int PAGE, bool I8P>
__global__ void __launch_bounds__(32 * TC_WARPS, 1) decode_attn_tc(
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ qkv,
    int Cq, const __nv_bfloat16* __restrict__ k_new,
    const __nv_bfloat16* __restrict__ v_new,
    const float* __restrict__ k_scales, const float* __restrict__ v_scales,
    const int* __restrict__ bt, const int* __restrict__ lengths,
    __nv_bfloat16* __restrict__ ao, int KVH, int qpg, int P, int maxp,
    int layer, float scale, float soft_cap) {
  using Lt = TcLayout<PAGE, I8P>;
  constexpr int ST = Lt::STAGES, PB = Lt::PAGE_BYTES, NK = PAGE / 8;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[ST];
  const uint32_t sbase = hp::smem_u32(smem_raw);
  const uint32_t base = (sbase + 1023u) & ~1023u;
  const int b = blockIdx.x, g = blockIdx.y;
  const int lane = threadIdx.x & 31, wd = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const uint32_t bar0 = hp::smem_u32(bars);
  auto kst = [&](int s) { return base + s * 2 * PB; };
  auto vst = [&](int s) { return base + s * 2 * PB + PB; };

  const int len = lengths[b];
  const int npages = min((len + PAGE - 1) / PAGE, maxp);
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) hp::mbar_init(bar0 + 8u * s, 1);
    hp::fence_barrier_init();
  }
  __syncthreads();
  auto issue = [&](int p) {
    const int s = p % ST;
    const int pid = min(max(bt[(size_t)b * maxp + p], 0), P - 1);
    const int row = ((layer * KVH + g) * P + pid) * PAGE;
    const uint32_t bar = bar0 + 8u * s;
    hp::mbar_expect_tx(bar, 2 * PB);
    if (I8P) {
      hp::tma_load_2d(kst(s), &tm_k, bar, 0, row);
      hp::tma_load_2d(vst(s), &tm_v, bar, 0, row);
    } else {
      for (int h = 0; h < 2; ++h) {
        hp::tma_load_2d(kst(s) + h * PAGE * 128, &tm_k, bar, 64 * h, row);
        hp::tma_load_2d(vst(s) + h * PAGE * 128, &tm_v, bar, 64 * h, row);
      }
    }
  };
  if (threadIdx.x == 0)
    for (int p = 0; p < min(ST, npages); ++p) issue(p);

  // q rows gq and gq + 8 (query heads of the group; rows >= qpg are 0),
  // rounded to bf16, as A fragments of the 8 k16 steps of the dot.
  const float* qg = qkv + (size_t)b * Cq + (size_t)g * qpg * TC_HD;
  const bool live0 = gq < qpg, live1 = gq + 8 < qpg;
  uint32_t qa[8][4];
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    // Dims of k-slots (2tq, 2tq + 1) and (2tq + 8, 2tq + 9).
    const int d0 = I8P ? 16 * ks + 4 * tq : 16 * ks + 2 * tq;
    const int d1 = I8P ? d0 + 2 : d0 + 8;
    float2 a = make_float2(0.f, 0.f), c = a, e = a, f = a;
    if (live0) {
      a = *reinterpret_cast<const float2*>(qg + gq * TC_HD + d0);
      e = *reinterpret_cast<const float2*>(qg + gq * TC_HD + d1);
    }
    if (live1) {
      c = *reinterpret_cast<const float2*>(qg + (gq + 8) * TC_HD + d0);
      f = *reinterpret_cast<const float2*>(qg + (gq + 8) * TC_HD + d1);
    }
    qa[ks][0] = pack2(a.x, a.y);
    qa[ks][1] = pack2(c.x, c.y);
    qa[ks][2] = pack2(e.x, e.y);
    qa[ks][3] = pack2(f.x, f.y);
  }

  // The current token's self score, from the unrounded f32 q and the
  // rounded fresh k (taken before the page walk, which leaves fewer
  // registers live); lane tq of a row's quad sums dims 32 tq .. + 31.
  float sc_self[2];
  {
    const __nv_bfloat16* kn = k_new + ((size_t)b * KVH + g) * TC_HD;
    uint4 kv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      kv[j] = *reinterpret_cast<const uint4*>(kn + 32 * tq + 8 * j);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float dot = 0.f;
      if (gq + 8 * r < qpg) {
        const float* qr = qg + (gq + 8 * r) * TC_HD + 32 * tq;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 qa4 = *reinterpret_cast<const float4*>(qr + 8 * j);
          const float4 qb4 = *reinterpret_cast<const float4*>(qr + 8 * j + 4);
          const __nv_bfloat162* k2 =
              reinterpret_cast<const __nv_bfloat162*>(&kv[j]);
          const float2 k0 = __bfloat1622float2(k2[0]);
          const float2 k1 = __bfloat1622float2(k2[1]);
          const float2 k2f = __bfloat1622float2(k2[2]);
          const float2 k3 = __bfloat1622float2(k2[3]);
          dot = fmaf(qa4.x, k0.x, dot);
          dot = fmaf(qa4.y, k0.y, dot);
          dot = fmaf(qa4.z, k1.x, dot);
          dot = fmaf(qa4.w, k1.y, dot);
          dot = fmaf(qb4.x, k2f.x, dot);
          dot = fmaf(qb4.y, k2f.y, dot);
          dot = fmaf(qb4.z, k3.x, dot);
          dot = fmaf(qb4.w, k3.y, dot);
        }
      }
      dot = rtt::group_sum<4>(dot);
      sc_self[r] = capped(__fmul_rn(dot, scale), soft_cap);
    }
  }

  float m[2] = {rtt::NEG_INF, rtt::NEG_INF}, l[2] = {0.f, 0.f};
  float acc[4][4];  // this warp's tiles 4 wd .. 4 wd + 3
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  const float* ksc = k_scales + (size_t)layer * P * KVH + g;
  const float* vsc = v_scales + (size_t)layer * P * KVH + g;

  for (int p = 0; p < npages; ++p) {
    const int s = p % ST;
    hp::mbar_wait(bar0 + 8u * s, (p / ST) & 1);
    const int n_valid = min(PAGE, len - p * PAGE);
    float ks_ = 1.f, vs_ = 1.f;
    if (I8P) {
      const int pid = min(max(bt[(size_t)b * maxp + p], 0), P - 1);
      ks_ = ksc[(size_t)pid * KVH];
      vs_ = vsc[(size_t)pid * KVH];
    }
    // Scores of the page's keys: sacc[nt] holds rows gq / gq + 8, keys
    // 8 nt + 2 tq, + 1.
    float sacc[NK][4];
#pragma unroll
    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[nt][e] = 0.f;
    const int qm = lane >> 3, r8 = lane & 7;
#pragma unroll
    for (int nt = 0; nt < NK; ++nt) {
      const int kr = 8 * nt + r8;  // this lane's ldmatrix row (a key)
      if (I8P) {
#pragma unroll
        for (int k4 = 0; k4 < 2; ++k4) {
          // Matrices: 16-byte chunks 4 k4 + qm of the key rows.
          const int chunk = 4 * k4 + qm;
          uint32_t v[4];
          hp::ldsm_x4(kst(s) + kr * 128 + ((chunk ^ (kr & 7)) << 4), v);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint4 f = rtt::int8x8_to_bf16(v[j], 0u);
            hp::mma_16816(sacc[nt], qa[4 * k4 + j], f.x, f.y);
          }
        }
      } else {
#pragma unroll
        for (int k2 = 0; k2 < 4; ++k2) {
          // Matrices: dims 32 k2 + 8 qm .. + 7 (k-steps 2 k2, 2 k2 + 1).
          const int dim = 32 * k2 + 8 * qm;
          const int h = dim / 64, chunk = (dim % 64) / 8;
          uint32_t v[4];
          hp::ldsm_x4(kst(s) + h * PAGE * 128 + kr * 128 +
                          ((chunk ^ (kr & 7)) << 4),
                      v);
          hp::mma_16816(sacc[nt], qa[2 * k2], v[0], v[1]);
          hp::mma_16816(sacc[nt], qa[2 * k2 + 1], v[2], v[3]);
        }
      }
    }
    // The page's softmax step (rows gq, gq + 8).
    float mx[2] = {rtt::NEG_INF, rtt::NEG_INF};
#pragma unroll
    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * nt + 2 * tq + (e & 1);
        float sc = __fmul_rn(sacc[nt][e], scale);
        if (I8P) sc = __fmul_rn(sc, ks_);
        sc = capped(sc, soft_cap);
        sacc[nt][e] = key < n_valid ? sc : rtt::NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], sacc[nt][e]);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = rtt::group_max<4>(mx[r]);
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * nt + 2 * tq + (e & 1);
        const float pe = key < n_valid ? expf(sacc[nt][e] - m[e >> 1]) : 0.f;
        sacc[nt][e] = pe;
        sum[e >> 1] += pe;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      l[r] = corr[r] * l[r] + rtt::group_sum<4>(sum[r]);
    // p.v of the page for this warp's 32 dims into fresh sums (the int8
    // scale multiplies them).  Every warp took the whole page's scores.
    {
      float pv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[i][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < PAGE / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = pack2(sacc[2 * kk][0], sacc[2 * kk][1]);
        pa[1] = pack2(sacc[2 * kk][2], sacc[2 * kk][3]);
        pa[2] = pack2(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]);
        pa[3] = pack2(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3]);
        // Matrix rows: keys 16 kk + 8 (qm & 1) + r8.
        const int vr = 16 * kk + 8 * (qm & 1) + r8;
        uint32_t v[4];
        if (I8P) {
          // 16-byte chunks 2 wd and 2 wd + 1 (matrices by qm >> 1): lanes
          // get V[2tq, 2tq + 1][2gq, 2gq + 1] of a chunk.
          const int chunk = 2 * wd + (qm >> 1);
          hp::ldsm_x4_t(vst(s) + vr * 128 + ((chunk ^ (vr & 7)) << 4), v);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint4 f = rtt::int8x8_to_bf16(
                __byte_perm(v[2 * h], 0, 0x3120),
                __byte_perm(v[2 * h + 1], 0, 0x3120));
            // Tile 2h: dims 2gq of chunk 2 wd + h; tile 2h + 1: 2gq + 1.
            hp::mma_16816(pv[2 * h], pa, f.x, f.z);
            hp::mma_16816(pv[2 * h + 1], pa, f.y, f.w);
          }
        } else {
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            // Dims 16 n2 + 8 (qm >> 1) .. + 7, n2 = 2 wd + n.
            const int dim = 32 * wd + 16 * n + 8 * (qm >> 1);
            const int h = dim / 64, chunk = (dim % 64) / 8;
            hp::ldsm_x4_t(vst(s) + h * PAGE * 128 + vr * 128 +
                              ((chunk ^ (vr & 7)) << 4),
                          v);
            hp::mma_16816(pv[2 * n], pa, v[0], v[1]);
            hp::mma_16816(pv[2 * n + 1], pa, v[2], v[3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][e] = acc[i][e] * corr[e >> 1] +
                      (I8P ? __fmul_rn(pv[i][e], vs_) : pv[i][e]);
    }
    __syncthreads();  // every warp is done with stage s
    if (threadIdx.x == 0 && p + ST < npages) issue(p + ST);
  }

  const __nv_bfloat16* vn = v_new + ((size_t)b * KVH + g) * TC_HD;
  // The self term's v: v_new at this lane's output dims (see the store
  // below); tile i of the warp is tile 4 wd + i of the head.
  uint32_t vv[4];
#pragma unroll
  for (int i = 0; i < 4; i += 2) {
    const int t = 4 * wd + i;
    if (I8P) {  // tile t: dims 16 c + 4 tq + {0, 2}; tile t + 1: {1, 3}
      const uint2 w4 =
          *reinterpret_cast<const uint2*>(vn + 8 * t + 4 * tq);
      vv[i] = __byte_perm(w4.x, w4.y, 0x5410);
      vv[i + 1] = __byte_perm(w4.x, w4.y, 0x7632);
    } else {    // tile t: dims 8 t + 2 tq, + 1
      vv[i] = *reinterpret_cast<const uint32_t*>(vn + 8 * t + 2 * tq);
      vv[i + 1] = *reinterpret_cast<const uint32_t*>(vn + 8 * t + 8 + 2 * tq);
    }
  }
  float o_corr[2], o_self[2], o_den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sc = sc_self[r];
    const float m_new = fmaxf(m[r], sc);
    o_corr[r] = expf(m[r] - m_new);
    o_self[r] = expf(sc - m_new);
    o_den[r] = l[r] * o_corr[r] + o_self[r];
  }
#pragma unroll
  for (int il = 0; il < 4; ++il)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int head = gq + 8 * r, i = 4 * wd + il;
      if (head >= qpg) continue;
      // bf16 pages: tile i = dims 8 i + 2 tq + e; int8 pages: tile
      // i = 2c + o, dims 16 c + 4 tq + 2 e + o (e = 0, 1).
      const float2 vf = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&vv[il]));
      float o[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        o[e] = (acc[il][2 * r + e] * o_corr[r] +
                o_self[r] * (e ? vf.y : vf.x)) /
               o_den[r];
      __nv_bfloat16* out =
          ao + ((size_t)b * KVH * qpg + (size_t)g * qpg + head) * TC_HD;
      if (I8P) {
        const int d0 = 16 * (i >> 1) + 4 * tq + (i & 1);
        out[d0] = __float2bfloat16(o[0]);
        out[d0 + 2] = __float2bfloat16(o[1]);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * i + 2 * tq) =
            __floats2bfloat162_rn(o[0], o[1]);
      }
    }
}

// TMA maps of the two pools viewed as [L * KVH * P * page, 128] rows.
inline int pool_map(CUtensorMap* map, const void* pool, bool i8, int L,
                    int KVH, int P, int page) {
  const cuuint64_t dims[2] = {(cuuint64_t)TC_HD,
                              (cuuint64_t)L * KVH * P * page};
  const cuuint64_t strides[1] = {(cuuint64_t)TC_HD * (i8 ? 1 : 2)};
  const cuuint32_t box[2] = {(cuuint32_t)(i8 ? 128 : 64), (cuuint32_t)page};
  return hp::encode_map(
      map, i8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, pool, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int PAGE, bool I8P>
int launch_attn_tc(const LayerArgs& A, cudaStream_t st) {
  CUtensorMap tk, tv;
  int e = pool_map(&tk, A.k_pools, I8P, A.L, A.KVH, A.P, A.page);
  if (!e) e = pool_map(&tv, A.v_pools, I8P, A.L, A.KVH, A.P, A.page);
  if (e) return e;
  auto kernel = decode_attn_tc<PAGE, I8P>;
  constexpr int smem = TcLayout<PAGE, I8P>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  decode_attn_tc<PAGE, I8P><<<dim3(A.rows, A.KVH), 32 * TC_WARPS, smem,
                               st>>>(
      tk, tv, (const float*)A.qkv_buf, (A.H + 2 * A.KVH) * A.hd,
      (const __nv_bfloat16*)A.k_new, (const __nv_bfloat16*)A.v_new,
      A.k_scales, A.v_scales, A.block_tables, A.lengths,
      static_cast<__nv_bfloat16*>(A.ao), A.KVH, A.H / A.KVH, A.P, A.maxp,
      A.layer, A.scale, A.soft_cap);
  return (int)cudaGetLastError();
}

// The Hopper attention where it takes the shape (bf16 activations, head_dim
// 128, pages of 16, 32 or 64, at most 16 query heads a kv head); else the
// CUDA-core kernel.
template <typename TA>
bool attn_tc_takes(const LayerArgs& A) {
  return std::is_same<TA, __nv_bfloat16>::value && A.hd == 128 &&
         (A.page == 16 || A.page == 32 || A.page == 64) &&
         A.H / A.KVH <= 16 && (A.pool_type == I8 || A.pool_type == BF16);
}

template <bool I8P>
int launch_attn_tc_page(const LayerArgs& A, cudaStream_t st) {
  switch (A.page) {
    case 16: return launch_attn_tc<16, I8P>(A, st);
    case 32: return launch_attn_tc<32, I8P>(A, st);
    default: return launch_attn_tc<64, I8P>(A, st);
  }
}

template <typename TA>
int run(const LayerArgs& A) {
  cudaStream_t st = static_cast<cudaStream_t>(A.stream);
  int err = run_qkv<TA>(A, st);
  if (err) return err;
  if (attn_tc_takes<TA>(A))
    err = A.pool_type == I8 ? launch_attn_tc_page<true>(A, st)
                            : launch_attn_tc_page<false>(A, st);
  else if (A.pool_type == I8)
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
