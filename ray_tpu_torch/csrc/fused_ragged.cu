// K8 — one fused decoder layer over a ragged batch.
//
// Replaces ray_tpu/ops/ragged_paged_attention.py fused_ragged_layer
// (Pallas body _fused_ragged_kernel, pallas_call at :995): K7's layer
// (fused_layer.cuh: RMSNorm, qkv tiles, RoPE, o-proj, MLP) over a flat
// buffer of T tokens packed in R rows (slot, start, len, off; len 0 =
// padding), with ragged paged attention in the middle: each token attends
// to its slot's pooled past (pages of the layer's pool, READ-ONLY) and to
// the causal prefix of its own row's fresh tokens.  x [T, D] in the
// activation dtype in; x_out [T, D], k_new and v_new [T, KVH, hd] out (the
// caller appends every layer's rows after the loop with K5 or K6).
// Tokens no row covers keep a zero attention output (their x_out is
// garbage that the caller masks).
//
// What bounds it on the H100: the operations.  At the 8B ragged mix
// (T = 264) the projections are 115 GFLOP per layer, about 0.12 ms of
// bf16 tensor-core time (fused_layer.cuh's WGMMA route: every weight byte
// read once per call); the attention is 2.9 GFLOP more.
//
// Attention, bf16 activations at head_dim 64 or 128: K4's Hopper kernel
// (ragged_attention.cuh) on K8's operands: q is the f32 q of qkv (split
// hi + lo on its way to wgmma), the fresh k/v are the rounded k_new /
// v_new, and the output is ao in bf16 (the o-projection's operand).
//
// Otherwise (f32 activations: the exact f32 path) attention follows the
// CUDA-core K4's structure with K8's numbers: one CTA of 128
// threads per (row, kv head, tile of up to 32 query rows = tokens x the
// qpg heads of the group); tiles past the row's length exit.  It walks the
// pooled past page by page (keys at positions < start, in blocks of up to
// 64), then the row's fresh keys in blocks of 64 (key j <= the token's
// own index), with an f32 online softmax per query row; a thread holds a
// 4 x 4 tile of scores and a 4-row x head_dim/16 tile of the output in
// registers, reading q and k rows from shared memory as float4.  Unlike
// K7, q, the pool values and the probabilities are all f32 (no dot-dtype
// rounding); int8 scales multiply
// the score after the dot and before the soft cap, and the block's p.v
// sum; the output is acc / max(l, 1e-30).  Pages resolve through
// min(block_table[slot, page], P - 1), as K4's do.
#include "fused_layer.cuh"
#include "ragged_attention.cuh"

namespace {

using namespace rtt::fused;

constexpr int A_THREADS = 128;
constexpr int QROWS = 32;   // query rows (tokens x group heads) per CTA
constexpr int KEYS = 64;    // keys per block
constexpr int PST = KEYS + 4;

// Rows [0, n) of a [n, hd] tile (row stride `row_stride` elements) into
// shared memory as f32 rows of stride hd + 4.
template <typename TK, int HD>
__device__ __forceinline__ void stage_rows(const TK* __restrict__ src,
                                           size_t row_stride, int n,
                                           float* dst) {
  constexpr int N = rtt::Vec<TK>::N;
  constexpr int CH = HD / N;
  for (int i = threadIdx.x; i < n * CH; i += A_THREADS) {
    const int t = i / CH, c = (i % CH) * N;
    float tmp[N];
    rtt::Vec<TK>::load(src + (size_t)t * row_stride + c, tmp);
#pragma unroll
    for (int j = 0; j < N; ++j) dst[t * (HD + 4) + c + j] = tmp[j];
  }
}

// Per-thread register tiles: thread t owns query rows 4 (t / 16) .. + 3;
// of the score block the keys kg, kg + 16, kg + 32, kg + 48 (kg = t % 16:
// a quarter warp reads consecutive key rows, conflict-free); of the
// output HD / 16 head dims, as float4 chunks kg, kg + 16, .. for HD >= 64
// and single dims kg, kg + 16, .. below.
template <int HD>
struct Tile {
  static constexpr int DPT = HD / 16;
  float acc[4][DPT];
};

template <int HD>
__device__ __forceinline__ int dim_of(int kg, int e) {
  return HD >= 64 ? 4 * (kg + 16 * (e / 4)) + e % 4 : kg + 16 * e;
}

// One key block of nk <= KEYS staged keys: scores (f32 FMAs, q and k
// rows read as float4), the online-softmax update per query row, and
// acc = acc * corr + (p . v) * vs in registers.  `valid(qr, key)` masks.
template <int HD, typename Valid>
__device__ __forceinline__ void flash_block(
    Tile<HD>& tl, const float* q_s, const float* k_s, const float* v_s,
    float* p_s, float* m_s, float* l_s, float* c_s, int nqr, int nk,
    float scale, float ks, float vs, float soft_cap, Valid valid) {
  constexpr int ST = HD + 4;
  constexpr int DPT = Tile<HD>::DPT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = tid / 16, kg = tid % 16;
  {
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 q[4], k[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        q[i] = *reinterpret_cast<const float4*>(q_s + (rg * 4 + i) * ST + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        k[j] = *reinterpret_cast<const float4*>(k_s + (kg + 16 * j) * ST + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(q[i].x, k[j].x, s[i][j]);
          s[i][j] = fmaf(q[i].y, k[j].y, s[i][j]);
          s[i][j] = fmaf(q[i].z, k[j].z, s[i][j]);
          s[i][j] = fmaf(q[i].w, k[j].w, s[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qr = rg * 4 + i, key = kg + 16 * j;
        float v = rtt::NEG_INF;
        if (key < nk && valid(qr, key)) {
          v = __fmul_rn(s[i][j], scale);
          if (ks != 1.f) v = __fmul_rn(v, ks);
          v = capped(v, soft_cap);
        }
        p_s[qr * PST + key] = v;
      }
  }
  __syncthreads();
  for (int qr = warp; qr < nqr; qr += A_THREADS / 32) {
    float* row = p_s + qr * PST;
    float mx = rtt::NEG_INF;
    for (int t = lane; t < nk; t += 32) mx = fmaxf(mx, row[t]);
    mx = rtt::group_max<32>(mx);
    const float m_prev = m_s[qr];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.f;
    for (int t = lane; t < nk; t += 32) {
      const float e = expf(row[t] - m_new);
      row[t] = e;
      sum += e;
    }
    sum = rtt::group_sum<32>(sum);
    if (lane == 0) {
      const float corr = expf(m_prev - m_new);
      c_s[qr] = corr;
      l_s[qr] = corr * l_s[qr] + sum;
      m_s[qr] = m_new;
    }
  }
  __syncthreads();
  {
    float pv[4][DPT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < DPT; ++e) pv[i][e] = 0.f;
    for (int t = 0; t < nk; ++t) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = p_s[(rg * 4 + i) * PST + t];
      const float* vr = v_s + t * ST;
      float ve[DPT];
      if constexpr (HD >= 64) {
#pragma unroll
        for (int e = 0; e < DPT; e += 4) {
          const float4 v4 =
              *reinterpret_cast<const float4*>(vr + dim_of<HD>(kg, e));
          ve[e] = v4.x; ve[e + 1] = v4.y; ve[e + 2] = v4.z; ve[e + 3] = v4.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < DPT; ++e) ve[e] = vr[dim_of<HD>(kg, e)];
      }
#pragma unroll
      for (int e = 0; e < DPT; ++e)
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i][e] = fmaf(p[i], ve[e], pv[i][e]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = rg * 4 + i < nqr ? c_s[rg * 4 + i] : 1.f;
#pragma unroll
      for (int e = 0; e < DPT; ++e) {
        const float add = vs != 1.f ? __fmul_rn(pv[i][e], vs) : pv[i][e];
        tl.acc[i][e] = tl.acc[i][e] * corr + add;
      }
    }
  }
  __syncthreads();  // the next block overwrites k_s, v_s, p_s, c_s
}

template <typename TA, typename TP, bool QUANT, int HD>
__global__ void __launch_bounds__(A_THREADS) ragged_attn_kernel(
    const float* __restrict__ qkv, int Cq, const TA* __restrict__ k_new,
    const TA* __restrict__ v_new, const TP* __restrict__ k_pools,
    const TP* __restrict__ v_pools, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ row_slot,
    const int* __restrict__ row_start, const int* __restrict__ row_len,
    const int* __restrict__ row_off, const int* __restrict__ bt,
    TA* __restrict__ ao, int KVH, int qpg, int P, int page, int maxp,
    int layer, int tq, float scale, float soft_cap) {
  constexpr int ST = HD + 4;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int r = blockIdx.x, g = blockIdx.y, tid = threadIdx.x;
  const int nt = row_len[r];
  const int i0 = blockIdx.z * tq;
  if (nt <= 0 || i0 >= nt) return;
  const int ntok = min(tq, nt - i0);
  const int nqr = ntok * qpg;
  const int H = KVH * qpg;
  float* q_s = smem;                  // [QROWS][HD + 4]
  float* k_s = q_s + QROWS * ST;      // [KEYS][HD + 4]
  float* v_s = k_s + KEYS * ST;       // [KEYS][HD + 4]
  float* p_s = v_s + KEYS * ST;       // [QROWS][KEYS + 4]
  float* m_s = p_s + QROWS * PST;     // [QROWS]
  float* l_s = m_s + QROWS;           // [QROWS]
  float* c_s = l_s + QROWS;           // [QROWS]

  const int start = row_start[r], off = row_off[r], slot = row_slot[r];
  for (int i = tid; i < QROWS * HD; i += A_THREADS) {
    const int qr = i / HD, d = i % HD;
    const int ti = qr / qpg, qi = qr % qpg;
    q_s[qr * ST + d] =
        qr < nqr ? qkv[(size_t)(off + i0 + ti) * Cq +
                       (size_t)(g * qpg + qi) * HD + d]
                 : 0.f;
  }
  if (tid < QROWS) {
    m_s[tid] = rtt::NEG_INF;
    l_s[tid] = 0.f;
  }
  Tile<HD> tl;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < Tile<HD>::DPT; ++e) tl.acc[i][e] = 0.f;
  __syncthreads();

  // Pooled past: keys at positions < start, page by page (blocks of up
  // to 64 keys of one page).
  const size_t page_elems = (size_t)page * HD;
  const size_t head_off = ((size_t)layer * KVH + g) * (size_t)P * page_elems;
  const int kb = page < KEYS ? page : KEYS;
  for (int b0 = 0; b0 < start; b0 += kb) {
    const int pc = b0 / page;
    if (pc >= maxp) break;
    const int pid = min(max(bt[(size_t)slot * maxp + pc], 0), P - 1);
    const int nk = min(kb, start - b0);
    float ks = 1.f, vs = 1.f;
    if (QUANT) {
      const size_t so = ((size_t)layer * P + pid) * KVH + g;
      ks = k_scales[so];
      vs = v_scales[so];
    }
    const size_t at = head_off + (size_t)pid * page_elems +
                      (size_t)(b0 - pc * page) * HD;
    stage_rows<TP, HD>(k_pools + at, HD, nk, k_s);
    stage_rows<TP, HD>(v_pools + at, HD, nk, v_s);
    __syncthreads();
    flash_block<HD>(tl, q_s, k_s, v_s, p_s, m_s, l_s, c_s, nqr, nk, scale,
                    ks, vs, soft_cap, [](int, int) { return true; });
  }

  // The row's own fresh keys, causal: key j <= the token's index i.
  const int i_last = i0 + ntok - 1;
  for (int j0 = 0; j0 <= i_last; j0 += KEYS) {
    const int nk = min(KEYS, nt - j0);
    stage_rows<TA, HD>(k_new + ((size_t)(off + j0) * KVH + g) * HD,
                       (size_t)KVH * HD, nk, k_s);
    stage_rows<TA, HD>(v_new + ((size_t)(off + j0) * KVH + g) * HD,
                       (size_t)KVH * HD, nk, v_s);
    __syncthreads();
    flash_block<HD>(tl, q_s, k_s, v_s, p_s, m_s, l_s, c_s, nqr, nk, scale,
                    1.f, 1.f, soft_cap, [=](int qr, int key) {
                      return j0 + key <= i0 + qr / qpg;
                    });
  }

  const int rg = tid / 16, kg = tid % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = rg * 4 + i;
    if (qr >= nqr) continue;
    const int ti = qr / qpg, qi = qr % qpg;
    const float den = fmaxf(l_s[qr], 1e-30f);
    TA* out = ao + (size_t)(off + i0 + ti) * H * HD +
              (size_t)(g * qpg + qi) * HD;
#pragma unroll
    for (int e = 0; e < Tile<HD>::DPT; ++e)
      out[dim_of<HD>(kg, e)] = rtt::from_float<TA>(tl.acc[i][e] / den);
  }
}

template <typename TA, typename TP, bool QUANT, int HD>
int launch_attn_hd(const LayerArgs& A, cudaStream_t st) {
  const int qpg = A.H / A.KVH;
  const size_t smem =
      sizeof(float) * ((size_t)(QROWS + 2 * KEYS) * (HD + 4) +
                       (size_t)QROWS * PST + 3 * QROWS);
  cudaError_t err = cudaFuncSetAttribute(
      ragged_attn_kernel<TA, TP, QUANT, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(A.R, A.KVH, (A.rows + A.tq - 1) / A.tq);
  ragged_attn_kernel<TA, TP, QUANT, HD><<<grid, A_THREADS, smem, st>>>(
      A.qkv_buf, (A.H + 2 * A.KVH) * HD, static_cast<const TA*>(A.k_new),
      static_cast<const TA*>(A.v_new), static_cast<const TP*>(A.k_pools),
      static_cast<const TP*>(A.v_pools), A.k_scales, A.v_scales, A.row_slot,
      A.row_start, A.row_len, A.row_off, A.block_tables,
      static_cast<TA*>(A.ao), A.KVH, qpg,
      A.P, A.page, A.maxp, A.layer, A.tq, A.scale, A.soft_cap);
  return (int)cudaGetLastError();
}

// K4's Hopper kernel on K8's operands (bf16, head_dim 64 or 128).
template <bool QUANT, int HD>
int launch_attn_hopper(const LayerArgs& A, cudaStream_t st) {
  const rtt::ragged::Params p{
      A.qkv_buf, (long long)(A.H + 2 * A.KVH) * HD, A.k_pools, A.v_pools,
      A.k_scales, A.v_scales, A.row_slot, A.row_start, A.row_len, A.row_off,
      A.block_tables, A.ao, (long long)A.H * HD, A.rows, A.R, A.H, A.KVH,
      A.L, A.P, A.page, A.maxp, A.layer, A.scale, A.soft_cap};
  return rtt::ragged::launch_hopper<float, __nv_bfloat16, QUANT, HD>(
      p, A.k_new, A.v_new, A.attn_cluster, A.attn_slots, st);
}

template <typename TA, typename TP, bool QUANT>
int launch_attn(const LayerArgs& A, cudaStream_t st) {
  if constexpr (std::is_same<TA, __nv_bfloat16>::value) {
    if (A.attn_cluster > 0)
      return A.hd == 64 ? launch_attn_hopper<QUANT, 64>(A, st)
                        : launch_attn_hopper<QUANT, 128>(A, st);
  }
  switch (A.hd) {
    case 16: return launch_attn_hd<TA, TP, QUANT, 16>(A, st);
    case 32: return launch_attn_hd<TA, TP, QUANT, 32>(A, st);
    case 64: return launch_attn_hd<TA, TP, QUANT, 64>(A, st);
    default: return launch_attn_hd<TA, TP, QUANT, 128>(A, st);
  }
}

template <typename TA>
int run(const LayerArgs& A) {
  cudaStream_t st = static_cast<cudaStream_t>(A.stream);
  int err = run_qkv<TA>(A, st);
  if (err) return err;
  // Tokens no row covers keep a zero attention output.
  err = (int)cudaMemsetAsync(A.ao, 0,
                             sizeof(TA) * (size_t)A.rows * A.H * A.hd, st);
  if (err) return err;
  if (A.R > 0) {
    if (A.pool_type == I8)
      err = launch_attn<TA, int8_t, true>(A, st);
    else
      err = launch_attn<TA, TA, false>(A, st);
    if (err) return err;
  }
  return run_mlp<TA>(A, st);
}

}  // namespace

// One fused ragged layer on the caller's stream; returns the first
// cudaError_t of the chain (0 when every launch was accepted).  The pools
// have the activation dtype, or are int8 with k_scales/v_scales.
extern "C" int rtt_fused_ragged_layer(const rtt::fused::LayerArgs* args) {
  return args->act_type == rtt::fused::F32 ? run<float>(*args)
                                           : run<__nv_bfloat16>(*args);
}
