// K9f — flash attention forward (causal or full), GQA by kv-head index.
//
// Replaces ray_tpu/ops/flash_attention.py _flash_forward (Pallas body
// _fwd_kernel, pallas_call at :115).
//
// q [B, S, H, D], k/v [B, S, KVH, D] (the model's own layout: no
// transposes) -> o [B, S, H, D] in the input dtype and
// lse [B, H, S] f32 (log-sum-exp per row, kept for the backward pass).
//
// What bounds it on the H100: operations.  Causal prefill at
// S >= 256 does ~S/2 multiply-adds per loaded element.  The C entry
// picks the kernel by dtype and D:
//  - bf16, D in {64, 128} (every real configuration): flash_fwd_wgmma,
//    the Hopper design below (warpgroup MMA on TMA-fed shared memory,
//    hopper.cuh);
//  - bf16, D in {16, 32} (the tiny test models): flash_fwd_mma, mma.sync
//    m16n8k16 tiles (flash_tiles.cuh), 4 warps of 16 q rows, tiles loaded
//    synchronously;
//  - f32: FMAs on the CUDA cores (a fraction of the tensor-core peak the
//    bound is stated against).
// Every bf16 kernel keeps scores and probabilities in registers, reduces
// the online softmax's row max and sum over each quad of lanes, and
// rounds p to bf16 at the running max for p.v, as the Pallas body
// rounds it.
//
// f32 design: one CTA per (64-row q tile, head, batch); 256 threads as a
// 16 x 16 grid, each owning 4 q rows x 4 kv columns of the score tile
// (rows ty + 16i, columns tx + 16j: strided, so the 16-byte shared
// reads of the padded k rows are bank-conflict free) and 4 rows x D/16
// output columns.  The CTA loops over 64-row kv tiles with an online
// softmax (running m, l in registers, f32), skips tiles above the
// diagonal, and indexes k/v by h / (H/KVH) so they are never expanded.
#include <type_traits>

#include "common.cuh"
#include "flash_tiles.cuh"
#include "hopper.cuh"

namespace {

constexpr int BQ = 64, BK = 64, THREADS = 256;
constexpr int PS = BK + 16;  // p tile row stride: conflict-free writes

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)BQ * (D + 4) + (size_t)BK * (D + 4) + (size_t)BK * D +
          (size_t)BQ * PS);
}

template <int D>
__device__ __forceinline__ void stage(float* dst, int dst_stride,
                                      const float* src, size_t src_stride,
                                      int rows) {
  constexpr int N = rtt::Vec<float>::N;
  constexpr int CH = D / N;
  for (int i = threadIdx.x; i < rows * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * N;
    float tmp[N];
    rtt::Vec<float>::load(src + (size_t)r * src_stride + c, tmp);
#pragma unroll
    for (int j = 0; j < N; ++j) dst[r * dst_stride + c + j] = tmp[j];
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, int S, int H, int KVH, float scale,
    int causal) {
  constexpr int QS = D + 4;
  constexpr int DPT = D / 16;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [BQ][QS]
  float* k_s = q_s + BQ * QS;                     // [BK][QS]
  float* v_s = k_s + BK * QS;                     // [BK][D]
  float* p_s = v_s + BK * D;                      // [BQ][PS]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = qt * BQ;
  const size_t q_row = (size_t)H * D, kv_row = (size_t)KVH * D;
  const float* qb = q + ((size_t)b * S + q0) * q_row + (size_t)h * D;
  const float* kb = k + (size_t)b * S * kv_row + (size_t)kvh * D;
  const float* vb = v + (size_t)b * S * kv_row + (size_t)kvh * D;

  stage<D>(q_s, QS, qb, q_row, BQ);

  float m_i[4], l_i[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = rtt::NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  const int n_tiles = causal ? (q0 + BQ - 1) / BK + 1 : S / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is done with k_s, v_s, p_s
    stage<D>(k_s, QS, kb + (size_t)k0 * kv_row, kv_row, BK);
    stage<D>(v_s, D, vb + (size_t)k0 * kv_row, kv_row, BK);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_s + (ty + 16 * i) * QS + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * j) * QS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y +
                     qv[i].z * kv[j].z + qv[i].w * kv[j].w;
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      float mx = rtt::NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * scale;
        if (causal && k0 + tx + 16 * j > r) x = rtt::NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = rtt::group_max<16>(mx);
      const float m_new = fmaxf(m_i[i], mx);
      const float corr = expf(m_i[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        p_s[(ty + 16 * i) * PS + tx + 16 * j] = p;
        sum += p;
      }
      sum = rtt::group_sum<16>(sum);
      l_i[i] = corr * l_i[i] + sum;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[DPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int cc = 0; cc < DPT; ++cc) vv[cc] = v_s[c * D + tx + 16 * cc];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < DPT; ++cc) acc[i][cc] += pv[i] * vv[cc];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    const float l_safe = l_i[i] == 0.f ? 1.f : l_i[i];
    const float inv = 1.f / l_safe;
    float* orow = o + ((size_t)b * S + r) * q_row + (size_t)h * D;
#pragma unroll
    for (int cc = 0; cc < DPT; ++cc)
      orow[tx + 16 * cc] = acc[i][cc] * inv;
    if (tx == 0)
      lse[((size_t)b * H + h) * S + r] = m_i[i] + logf(l_safe);
  }
}

using namespace rtt::flash;

// bf16: one CTA per (64-row q tile, head, batch); warp w owns q rows
// 16w .. 16w + 15 (this thread: rows g and g + 8 of them).
template <int D>
__global__ void __launch_bounds__(MMA_THREADS) flash_fwd_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
    int S, int H, int KVH, float scale, int causal) {
  constexpr int RS = D + 8;
  extern __shared__ float4 smem4[];
  bf16* q_s = reinterpret_cast<bf16*>(smem4);
  bf16* k_s = q_s + BQ * RS;
  bf16* v_s = k_s + BK * RS;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int m0 = (threadIdx.x >> 5) * 16;
  const int g = (threadIdx.x & 31) >> 2, tig = threadIdx.x & 3;
  const int q0 = qt * BQ;
  const size_t q_row = (size_t)H * D, kv_row = (size_t)KVH * D;
  const size_t qoff = ((size_t)b * S + q0) * q_row + (size_t)h * D;
  const bf16* kb = k + (size_t)b * S * kv_row + (size_t)kvh * D;
  const bf16* vb = v + (size_t)b * S * kv_row + (size_t)kvh * D;

  stage_bf16<D>(q_s, q + qoff, q_row);

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m_i[2] = {rtt::NEG_INF, rtt::NEG_INF}, l_i[2] = {0.f, 0.f};

  const int n_tiles = causal ? (q0 + BQ - 1) / BK + 1 : S / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is done with k_s, v_s
    stage_bf16<D>(k_s, kb + (size_t)k0 * kv_row, kv_row);
    stage_bf16<D>(v_s, vb + (size_t)k0 * kv_row, kv_row);
    __syncthreads();

    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t aq[4];
      load_a<D>(aq, q_s, m0, kk);
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        uint32_t bk[2];
        load_bt<D>(bk, k_s, nt * 8, kk);
        mma_bf16(s[nt], aq, bk);
      }
    }
    // Online softmax; element e of an n-tile is row g + 8 (e / 2).
    float mx[2] = {rtt::NEG_INF, rtt::NEG_INF};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = q0 + m0 + g + (e >> 1) * 8;
        float x = s[nt][e] * scale;
        if (causal && k0 + nt * 8 + 2 * tig + (e & 1) > r) x = rtt::NEG_INF;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = rtt::group_max<4>(mx[i]);
      const float m_new = fmaxf(m_i[i], mx[i]);
      corr[i] = expf(m_i[i] - m_new);
      m_i[i] = m_new;
    }
    uint32_t ap[BK / 16][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = expf(s[nt][e] - m_i[e >> 1]);
        sum[e >> 1] += p[e];
      }
      to_a(ap, nt, p);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
      l_i[i] = corr[i] * l_i[i] + rtt::group_sum<4>(sum[i]);
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      acc[nd][0] *= corr[0];
      acc[nd][1] *= corr[0];
      acc[nd][2] *= corr[1];
      acc[nd][3] *= corr[1];
    }
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) mma_rows<D>(acc, ap[j], v_s, j * 16);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l_safe = l_i[i] == 0.f ? 1.f : l_i[i];
    const int r = m0 + g + 8 * i;
    bf16* orow = o + qoff + (size_t)r * q_row;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(orow + nd * 8 + 2 * tig) =
          __floats2bfloat162_rn(acc[nd][2 * i] / l_safe,
                                acc[nd][2 * i + 1] / l_safe);
    if (tig == 0)
      lse[((size_t)b * H + h) * S + q0 + r] = m_i[i] + logf(l_safe);
  }
}

// bf16, D in {64, 128}: the Hopper design (hopper.cuh).  One CTA per
// (128-row q tile, head, batch), 3 warpgroups: warpgroup 0 is the
// producer (one thread issues every TMA load, on 24 registers), 1 and 2
// the consumers (240 registers), each owning 64 q rows.  Q (128 x D)
// loads once; K and V tiles of 128 rows come through a 3-stage ring
// (225 KB of shared memory at D = 128), each stage's K and V on barriers
// of their own.  S = Q.K^T is wgmma m64n128k16 (both operands in shared
// memory, K-major); O += P.V is wgmma m64nDk16 with p, rounded to bf16,
// as A fragments in registers and V MN-major.  Each consumer issues tile
// j's S together with tile j - 1's P.V and runs tile j's online softmax
// while that product is in flight.  Masks apply only on tiles that cross
// the diagonal or S; tiles above the diagonal are never loaded, and the
// heaviest q tiles launch first.
namespace hk {

namespace hp = rtt::hopper;
constexpr int BQ = 128, BK = 128, STAGES = 3, THREADS = 3 * hp::WG_THREADS;

template <int D>
struct Smem {
  static constexpr uint32_t Q_BYTES = BQ * D * 2, KV_BYTES = BK * D * 2;
  static constexpr uint32_t K_OFF = Q_BYTES;
  static constexpr uint32_t V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr uint32_t BYTES = V_OFF + STAGES * KV_BYTES;
};

// Barriers: q_full, k_full[STAGES], v_full[STAGES], empty[STAGES].
constexpr int N_BARS = 1 + 3 * STAGES;

// The online softmax of one m64n128 score tile in registers: scores to
// log2 units (masked at columns > row when causal, and >= S), the running
// max m2 and sum l of rows row0 and row0 + 8 (over each quad of lanes),
// corr = 2^(m_old - m_new), and p = 2^(s - m_new) in place of the scores.
__device__ __forceinline__ void online_softmax(float (&sc)[BK / 2],
                                               float (&m2)[2],
                                               float (&l_i)[2],
                                               float (&corr)[2], bool edge,
                                               int causal, int k0, int row0,
                                               int tig, int S, float sl2) {
  float mx[2] = {rtt::NEG_INF, rtt::NEG_INF};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {  // block i / 4, row row0 + 8 (i / 2 % 2)
    float x = sc[i] * sl2;
    if (edge) {
      const int c = k0 + 8 * (i / 4) + 2 * tig + (i & 1);
      if ((causal && c > row0 + 8 * ((i >> 1) & 1)) || c >= S)
        x = rtt::NEG_INF;
    }
    sc[i] = x;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m2[r], rtt::group_max<4>(mx[r]));
    corr[r] = hp::ex2(m2[r] - m_new);
    m2[r] = m_new;
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    sc[i] = hp::ex2(sc[i] - m2[(i >> 1) & 1]);
    sum[(i >> 1) & 1] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l_i[r] = corr[r] * l_i[r] + rtt::group_sum<4>(sum[r]);
}

template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] *= corr[(i >> 1) & 1];
}

// p rounded to bf16 as the A fragments of the P.V k-steps.
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BK / 16][4],
                                       const float (&p)[BK / 2]) {
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) to_a(pa, i, p + 4 * i);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_wgmma(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
    float* __restrict__ lse, int S, int H, int KVH, float scale,
    int causal) {
  using L = Smem<D>;
  constexpr int NB = D / 64;  // 64-column swizzle blocks of a row
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[N_BARS];
  const uint32_t base = (hp::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = hp::smem_u32(bars);
  auto k_full = [&](int s) { return q_full + 8u * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8u * (1 + STAGES + s); };
  auto empty = [&](int s) { return q_full + 8u * (1 + 2 * STAGES + s); };

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // heaviest first
  const int q0 = qt * BQ;
  const int kvh = h / (H / KVH);
  const int n_tiles = causal ? qt + 1 : (S + BK - 1) / BK;
  const int wg = threadIdx.x / hp::WG_THREADS;

  if (threadIdx.x == 0) {
    hp::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hp::mbar_init(k_full(s), 1);
      hp::mbar_init(v_full(s), 1);
      hp::mbar_init(empty(s), 8);  // lane 0 of each consumer warp
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    hp::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hp::mbar_expect_tx(q_full, L::Q_BYTES);
      for (int c = 0; c < NB; ++c)
        hp::tma_load_4d(base + c * BQ * 128, &tm_q, q_full, c * 64, h, q0, b);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % STAGES;
        hp::mbar_wait(empty(s), ((kt / STAGES) & 1) ^ 1);
        const uint32_t kd = base + L::K_OFF + s * L::KV_BYTES;
        const uint32_t vd = base + L::V_OFF + s * L::KV_BYTES;
        hp::mbar_expect_tx(k_full(s), L::KV_BYTES);
        for (int c = 0; c < NB; ++c)
          hp::tma_load_4d(kd + c * BK * 128, &tm_k, k_full(s), c * 64, kvh,
                          kt * BK, b);
        hp::mbar_expect_tx(v_full(s), L::KV_BYTES);
        for (int c = 0; c < NB; ++c)
          hp::tma_load_4d(vd + c * BK * 128, &tm_v, v_full(s), c * 64, kvh,
                          kt * BK, b);
      }
    }
    return;
  }

  hp::setmaxnreg_inc<240>();
  const int w = wg - 1;  // which 64 rows of the q tile
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  if (q0 + 64 * w >= S) {  // the last tile's second half: no live row
    for (int kt = 0; kt < n_tiles; ++kt) {
      const uint32_t par = (kt / STAGES) & 1;
      hp::mbar_wait(k_full(kt % STAGES), par);
      hp::mbar_wait(v_full(kt % STAGES), par);
      if (lane == 0) hp::mbar_arrive(empty(kt % STAGES));
    }
    return;
  }
  const int g = lane >> 2, tig = lane & 3;
  const int row0 = q0 + 64 * w + 16 * warp + g;  // and row0 + 8
  const float sl2 = scale * hp::LOG2E;
  const uint32_t qa = base + w * 64 * 128;
  // Tiles that cross the diagonal or S take masks.
  auto mask_tile = [&](int kt) {
    return (causal && kt * BK + BK - 1 > q0 + 64 * w) || kt * BK + BK > S;
  };

  float acc[D / 2], sc[BK / 2];
  uint32_t pa[BK / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m2[2] = {rtt::NEG_INF, rtt::NEG_INF}, l_i[2] = {0.f, 0.f};

  auto issue_qk = [&](int kt) {
    const uint32_t kb = base + L::K_OFF + (kt % STAGES) * L::KV_BYTES;
    hp::mbar_wait(k_full(kt % STAGES), (kt / STAGES) & 1);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // 16 columns a k-step
      hp::wgmma_ss(sc,
                   hp::desc_sw128(qa + (kk / 4) * BQ * 128 + off, 16, 1024),
                   hp::desc_sw128(kb + (kk / 4) * BK * 128 + off, 16, 1024),
                   kk > 0);
    }
    hp::wgmma_commit();
  };
  auto issue_pv = [&](int kt) {
    const uint32_t vb = base + L::V_OFF + (kt % STAGES) * L::KV_BYTES;
    hp::mbar_wait(v_full(kt % STAGES), (kt / STAGES) & 1);
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
      hp::wgmma_rs(acc, pa[j],
                   hp::desc_sw128(vb + j * 16 * 128, BK * 128, 1024), 1);
    hp::wgmma_commit();
  };

  // Tile kt's S = Q.K^T is issued together with tile kt - 1's O += P.V,
  // and kt's softmax runs while that product is in flight.  The first
  // tile is peeled, so no wgmma sits in a branch.
  float corr[2];
  hp::mbar_wait(q_full, 0);
  issue_qk(0);
  hp::wgmma_wait<0>();
  hp::fence_operand(sc);
  online_softmax(sc, m2, l_i, corr, mask_tile(0), causal, 0, row0, tig, S,
                 sl2);
  pack_p(pa, sc);
  for (int kt = 1; kt < n_tiles; ++kt) {
    issue_qk(kt);
    issue_pv(kt - 1);
    hp::wgmma_wait<1>();
    hp::fence_operand(sc);
    online_softmax(sc, m2, l_i, corr, mask_tile(kt), causal, kt * BK, row0,
                   tig, S, sl2);
    // Tile kt - 1's P.V has retired: free its stage, rescale O, and make
    // tile kt's p the A fragments.
    hp::wgmma_wait<0>();
    hp::fence_operand(acc);
    if (lane == 0) hp::mbar_arrive(empty((kt - 1) % STAGES));
    rescale(acc, corr);
    pack_p(pa, sc);
  }
  hp::fence_operand(acc);
  hp::wgmma_fence();
  issue_pv(n_tiles - 1);
  hp::wgmma_wait<0>();
  hp::fence_operand(acc);
  if (lane == 0) hp::mbar_arrive(empty((n_tiles - 1) % STAGES));

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    const float l_safe = l_i[r] == 0.f ? 1.f : l_i[r];
    bf16* orow = o + (((size_t)b * S + row) * H + h) * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i + 2 * tig) =
          __floats2bfloat162_rn(acc[4 * i + 2 * r] / l_safe,
                                acc[4 * i + 2 * r + 1] / l_safe);
    if (tig == 0)
      lse[((size_t)b * H + h) * S + row] = m2[r] * hp::LN2 + logf(l_safe);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int S, int H, int KVH, float scale, int causal,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = hp::encode_bshd(&tq, q, B, S, H, D, BQ);
  if (!err) err = hp::encode_bshd(&tk, k, B, S, KVH, D, BK);
  if (!err) err = hp::encode_bshd(&tv, v, B, S, KVH, D, BK);
  if (err) return err;
  constexpr size_t smem = Smem<D>::BYTES + 1024;  // + alignment slack
  err = (int)cudaFuncSetAttribute(flash_fwd_wgmma<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem);
  if (err) return err;
  const dim3 grid(H, B, (S + BQ - 1) / BQ);
  flash_fwd_wgmma<D><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), S, H, KVH,
      scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace hk

// The kernel by dtype and D: bf16 at D 64 and 128 takes the Hopper
// kernel, bf16 at D 16 and 32 the mma.sync tiles, f32 the FMA tiles.
template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int S, int H, int KVH, float scale, int causal,
           cudaStream_t stream) {
  constexpr bool is_bf16 = std::is_same<T, bf16>::value;
  if constexpr (is_bf16 && D >= 64) {
    return hk::launch<D>(q, k, v, o, lse, B, S, H, KVH, scale, causal,
                         stream);
  } else {
    const dim3 grid(S / BQ, H, B);
    cudaError_t err;
    if constexpr (is_bf16) {
      constexpr size_t smem = mma_smem_bytes<D>(3, 0);
      err = cudaFuncSetAttribute(flash_fwd_mma<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
      flash_fwd_mma<D><<<grid, MMA_THREADS, smem, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<bf16*>(o),
          static_cast<float*>(lse), S, H, KVH, scale, causal);
    } else {
      constexpr size_t smem = smem_bytes<D>();
      err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
      flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<float*>(o),
          static_cast<float*>(lse), S, H, KVH, scale, causal);
    }
    return (int)cudaGetLastError();
  }
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int S, int H, int KVH, int D, float scale,
               int causal, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, lse, B, S, H, KVH, scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, B, S, H, KVH, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, S, H, KVH, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, S, H, KVH, scale, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  S % 64 == 0, D in {16,32,64,128}.
extern "C" int rtt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int dtype, int B, int S,
                             int H, int KVH, int D, float scale, int causal,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, lse, B, S, H, KVH, D, scale, causal, s);
  return dispatch_d<__nv_bfloat16>(q, k, v, o, lse, B, S, H, KVH, D, scale,
                                   causal, s);
}
