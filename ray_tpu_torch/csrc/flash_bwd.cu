// K10 and K11 — flash attention backward (causal or full), GQA by kv-head
// index, p recomputed from the forward's log-sum-exp.
//
// Replace ray_tpu/ops/flash_attention.py _flash_backward: K10 its dq
// kernel (Pallas body _dq_kernel, pallas_call at :263), K11 its dk/dv
// kernel (_dkv_kernel, pallas_call at :284) together with the GQA group
// sum of _flash_bwd_rule (:346-349).
//
// Layout (the model's own, no transposes): q, do, dq [B, S, H, D];
// k, v, dk, dv [B, S, KVH, D]; lse and delta [B, H, S] f32, delta =
// sum(o * do) over D (computed by the wrapper).  q, k, v, do, dq, dk, dv
// share one dtype T (f32 or bf16); every product accumulates in f32.
// Rounding points are the Pallas bodies': K10 rounds ds to T before
// ds.k; K11 rounds p to T for dv and ds to T for dk.  Outputs are
// stored in T.  K11 sums the group's q heads in f32 before rounding
// (the TPU kernels round each head's dk/dv to T, then sum in T).
//
// What bounds them on the H100: operations.  K10 runs three causal
// products per tile (q.k^T, do.v^T, ds.k), K11 four (k.q^T, v.do^T,
// p^T.do, ds^T.q); at S >= 256 each loaded element feeds ~S/2
// multiply-adds.  Causal tiles strictly above the diagonal are skipped
// by the position test of the TPU kernels (key tile start <= last query
// row of the tile); masked scores are -1e30, so p = 0 there.
//  K10: one CTA per (q tile, head, batch); q and do staged once, the
//       CTA walks the kv tiles 0 .. diagonal.
//  K11: one CTA per (64-row kv tile, kv head, batch); k and v staged
//       once, the CTA walks the group's q heads and, for each, the q
//       tiles from the diagonal down.  Each CTA owns its dk/dv rows
//       outright: no atomics, a fixed summation order, deterministic.
//
// bf16 runs on the tensor cores.  At D in {16, 32} (the tiny test
// models): mma.sync m16n8k16 on bf16 fragments with f32 accumulators, 4
// warps of 16 rows each over 64-row tiles; the score tiles stay in
// registers, and p / ds, rounded to bf16 where the Pallas bodies round
// them, become the A fragments of the next product directly (the
// accumulator layout of two n-tiles is the A layout of one k-step).  B
// fragments of a row-major [k][n] tile come through ldmatrix.trans;
// tiles load synchronously.  At D in {64, 128} (every real
// configuration) K10 and K11 are the Hopper designs of
// flash_bwd_dq_wgmma and flash_bwd_dkv_wgmma below.
// f32 runs on the CUDA cores, the design of K9f: 256 threads as a
// 16 x 16 grid, each owning 4 rows x 4 columns of each score tile (rows
// ty + 16i, columns tx + 16j: strided, so the 16-byte shared reads of
// the padded rows are bank-conflict free) and 4 rows x D/16 columns of
// its f32 accumulators.
#include <type_traits>

#include "common.cuh"
#include "flash_tiles.cuh"
#include "hopper.cuh"

namespace {

constexpr int BQ = 64, BK = 64, THREADS = 256;
constexpr int PS = BK + 16;  // p / ds tile row stride: conflict-free writes

// Shared floats: four [64][D + 4] row tiles, `ptiles` [64][PS] tiles,
// and lse / delta for 64 rows.
template <int D>
constexpr size_t smem_bytes(int ptiles) {
  return sizeof(float) * (4 * (size_t)BQ * (D + 4) +
                          (size_t)ptiles * BQ * PS + 2 * BQ);
}

template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      size_t src_stride) {
  constexpr int N = rtt::Vec<float>::N;
  constexpr int CH = D / N;
  for (int i = threadIdx.x; i < BQ * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * N;
    float tmp[N];
    rtt::Vec<float>::load(src + (size_t)r * src_stride + c, tmp);
#pragma unroll
    for (int j = 0; j < N; ++j) dst[r * (D + 4) + c + j] = tmp[j];
  }
}

// s[i][j] = a_row(ty + 16i) . b_row(tx + 16j) and
// t[i][j] = c_row(ty + 16i) . d_row(tx + 16j) over D, rows of the
// [64][D + 4] tiles a, b, c, d: the two score products of one tile.
template <int D>
__device__ __forceinline__ void two_products(const float* a, const float* b,
                                             const float* c, const float* d,
                                             float s[4][4], float t[4][4]) {
  constexpr int RS = D + 4;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = t[i][j] = 0.f;
#pragma unroll 2
  for (int e = 0; e < D; e += 4) {
    float4 av[4], bv[4], cv[4], dv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * RS + e);
      cv[i] = *reinterpret_cast<const float4*>(c + (ty + 16 * i) * RS + e);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * RS + e);
      dv[j] = *reinterpret_cast<const float4*>(d + (tx + 16 * j) * RS + e);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] += av[i].x * bv[j].x + av[i].y * bv[j].y +
                   av[i].z * bv[j].z + av[i].w * bv[j].w;
        t[i][j] += cv[i].x * dv[j].x + cv[i].y * dv[j].y +
                   cv[i].z * dv[j].z + cv[i].w * dv[j].w;
      }
  }
}

// acc[i][cc] += sum_c p[(ty + 16i)][c] * x[c][tx + 16cc]: a [64][PS]
// tile times a [64][D + 4] row tile.
template <int D>
__device__ __forceinline__ void accumulate(const float* p, const float* x,
                                           float acc[4][D / 16]) {
  constexpr int RS = D + 4, DPT = D / 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
  for (int c = 0; c < BK; ++c) {
    float pv[4], xv[DPT];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = p[(ty + 16 * i) * PS + c];
#pragma unroll
    for (int cc = 0; cc < DPT; ++cc) xv[cc] = x[c * RS + tx + 16 * cc];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int cc = 0; cc < DPT; ++cc) acc[i][cc] += pv[i] * xv[cc];
  }
}

// --- f32: CUDA-core tiles ---------------------------------------------------

// K10 (f32): dq for one (q tile, head, batch).
template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int S, int H, int KVH, float scale, int causal) {
  constexpr int RS = D + 4, DPT = D / 16;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [BQ][RS]
  float* do_s = q_s + BQ * RS;                    // [BQ][RS]
  float* k_s = do_s + BQ * RS;                    // [BK][RS]
  float* v_s = k_s + BK * RS;                     // [BK][RS]
  float* ds_s = v_s + BK * RS;                    // [BQ][PS]
  float* lse_s = ds_s + BQ * PS;                  // [BQ]
  float* delta_s = lse_s + BQ;                    // [BQ]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = qt * BQ;
  const size_t q_row = (size_t)H * D, kv_row = (size_t)KVH * D;
  const size_t qoff = ((size_t)b * S + q0) * q_row + (size_t)h * D;
  const float* kb = k + (size_t)b * S * kv_row + (size_t)kvh * D;
  const float* vb = v + (size_t)b * S * kv_row + (size_t)kvh * D;
  const size_t stat = ((size_t)b * H + h) * S + q0;

  stage<D>(q_s, q + qoff, q_row);
  stage<D>(do_s, dout + qoff, q_row);
  if (threadIdx.x < BQ) {
    lse_s[threadIdx.x] = lse[stat + threadIdx.x];
    delta_s[threadIdx.x] = delta[stat + threadIdx.x];
  }

  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;

  const int n_tiles = causal ? (q0 + BQ - 1) / BK + 1 : S / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is done with k_s, v_s, ds_s
    stage<D>(k_s, kb + (size_t)k0 * kv_row, kv_row);
    stage<D>(v_s, vb + (size_t)k0 * kv_row, kv_row);
    __syncthreads();

    float s[4][4], dp[4][4];
    two_products<D>(q_s, k_s, do_s, v_s, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * scale;
        if (causal && k0 + tx + 16 * j > q0 + r) x = rtt::NEG_INF;
        const float p = expf(x - lse_s[r]);
        ds_s[r * PS + tx + 16 * j] = p * (dp[i][j] - delta_s[r]);
      }
    }
    __syncthreads();
    accumulate<D>(ds_s, k_s, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* row = dq + qoff + (size_t)(ty + 16 * i) * q_row;
#pragma unroll
    for (int cc = 0; cc < DPT; ++cc)
      row[tx + 16 * cc] = scale * acc[i][cc];
  }
}

// K11 (f32): dk, dv for one (kv tile, kv head, batch), summed over the
// group.
template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int S, int H, int KVH,
    float scale, int causal) {
  constexpr int RS = D + 4, DPT = D / 16;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // [BK][RS]
  float* v_s = k_s + BK * RS;                     // [BK][RS]
  float* q_s = v_s + BK * RS;                     // [BQ][RS]
  float* do_s = q_s + BQ * RS;                    // [BQ][RS]
  float* p_s = do_s + BQ * RS;                    // [BK][PS]: p^T
  float* ds_s = p_s + BK * PS;                    // [BK][PS]: ds^T
  float* lse_s = ds_s + BK * PS;                  // [BQ]
  float* delta_s = lse_s + BQ;                    // [BQ]

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int group = H / KVH;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int k0 = kt * BK;
  const size_t q_row = (size_t)H * D, kv_row = (size_t)KVH * D;
  const size_t kvoff = ((size_t)b * S + k0) * kv_row + (size_t)kvh * D;

  stage<D>(k_s, k + kvoff, kv_row);
  stage<D>(v_s, v + kvoff, kv_row);

  float acc_k[4][DPT], acc_v[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  // First q tile whose last row reaches the kv tile's first key.
  const int qt0 = causal ? k0 / BQ : 0;
  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    for (int qt = qt0; qt < S / BQ; ++qt) {
      const int q0 = qt * BQ;
      const size_t qoff = ((size_t)b * S + q0) * q_row + (size_t)h * D;
      const size_t stat = ((size_t)b * H + h) * S + q0;
      __syncthreads();  // the previous tile is done with q_s, do_s, p_s
      stage<D>(q_s, q + qoff, q_row);
      stage<D>(do_s, dout + qoff, q_row);
      if (threadIdx.x < BQ) {
        lse_s[threadIdx.x] = lse[stat + threadIdx.x];
        delta_s[threadIdx.x] = delta[stat + threadIdx.x];
      }
      __syncthreads();

      // Transposed tiles: rows are keys (ty + 16i), columns queries.
      float s[4][4], dp[4][4];
      two_products<D>(k_s, q_s, v_s, do_s, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          float x = s[i][j] * scale;
          if (causal && k0 + r > q0 + c) x = rtt::NEG_INF;
          const float p = expf(x - lse_s[c]);
          p_s[r * PS + c] = p;
          ds_s[r * PS + c] = p * (dp[i][j] - delta_s[c]);
        }
      }
      __syncthreads();
      accumulate<D>(p_s, do_s, acc_v);
      accumulate<D>(ds_s, q_s, acc_k);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t row = kvoff + (size_t)(ty + 16 * i) * kv_row;
#pragma unroll
    for (int cc = 0; cc < DPT; ++cc) {
      dk[row + tx + 16 * cc] = scale * acc_k[i][cc];
      dv[row + tx + 16 * cc] = acc_v[i][cc];
    }
  }
}

// --- bf16: tensor-core tiles (helpers in flash_tiles.cuh) -----------------

using namespace rtt::flash;

// K10 (bf16, D in {16, 32}): dq for one (64-row q tile, head, batch);
// warp w owns q rows 16w .. 16w + 15.
template <int D>
__global__ void __launch_bounds__(MMA_THREADS) flash_bwd_dq_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int S, int H, int KVH, float scale, int causal) {
  constexpr int RS = D + 8;
  extern __shared__ float4 smem4[];
  bf16* q_s = reinterpret_cast<bf16*>(smem4);
  bf16* do_s = q_s + BQ * RS;
  bf16* k_s = do_s + BQ * RS;
  bf16* v_s = k_s + BK * RS;
  float* lse_s = reinterpret_cast<float*>(v_s + BK * RS);
  float* delta_s = lse_s + BQ;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int m0 = (threadIdx.x >> 5) * 16;
  const int g = (threadIdx.x & 31) >> 2, tig = threadIdx.x & 3;
  const int q0 = qt * BQ;
  const size_t q_row = (size_t)H * D, kv_row = (size_t)KVH * D;
  const size_t qoff = ((size_t)b * S + q0) * q_row + (size_t)h * D;
  const bf16* kb = k + (size_t)b * S * kv_row + (size_t)kvh * D;
  const bf16* vb = v + (size_t)b * S * kv_row + (size_t)kvh * D;
  const size_t stat = ((size_t)b * H + h) * S + q0;

  stage_bf16<D>(q_s, q + qoff, q_row);
  stage_bf16<D>(do_s, dout + qoff, q_row);
  if (threadIdx.x < BQ) {
    lse_s[threadIdx.x] = lse[stat + threadIdx.x];
    delta_s[threadIdx.x] = delta[stat + threadIdx.x];
  }
  __syncthreads();
  const int r0 = m0 + g;  // this thread's rows: r0 and r0 + 8
  const float lse0 = lse_s[r0], lse1 = lse_s[r0 + 8];
  const float dl0 = delta_s[r0], dl1 = delta_s[r0 + 8];

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  const int n_tiles = causal ? (q0 + BQ - 1) / BK + 1 : S / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is done with k_s, v_s
    stage_bf16<D>(k_s, kb + (size_t)k0 * kv_row, kv_row);
    stage_bf16<D>(v_s, vb + (size_t)k0 * kv_row, kv_row);
    __syncthreads();

    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t aq[4], ado[4];
      load_a<D>(aq, q_s, m0, kk);
      load_a<D>(ado, do_s, m0, kk);
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        uint32_t bk[2], bv[2];
        load_bt<D>(bk, k_s, nt * 8, kk);
        load_bt<D>(bv, v_s, nt * 8, kk);
        mma_bf16(s[nt], aq, bk);
        mma_bf16(dp[nt], ado, bv);
      }
    }
    uint32_t ads[BK / 16][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = q0 + r0 + (e >> 1) * 8;
        const int c = k0 + nt * 8 + 2 * tig + (e & 1);
        float x = s[nt][e] * scale;
        if (causal && c > r) x = rtt::NEG_INF;
        const float p = expf(x - (e >> 1 ? lse1 : lse0));
        ds[e] = p * (dp[nt][e] - (e >> 1 ? dl1 : dl0));
      }
      to_a(ads, nt, ds);
    }
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) mma_rows<D>(acc, ads[j], k_s, j * 16);
  }
  store_rows<D>(dq + qoff, m0, q_row, acc, scale);
}

// K11 (bf16): dk, dv for one (kv tile, kv head, batch), summed over the
// group; warp w owns keys 16w .. 16w + 15 and walks each q tile in two
// 32-query halves (fewer live score registers beside its accumulators).
template <int D>
__global__ void __launch_bounds__(MMA_THREADS) flash_bwd_dkv_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H, int KVH,
    float scale, int causal) {
  constexpr int RS = D + 8, QC = 32;
  extern __shared__ float4 smem4[];
  bf16* k_s = reinterpret_cast<bf16*>(smem4);
  bf16* v_s = k_s + BK * RS;
  bf16* q_s = v_s + BK * RS;
  bf16* do_s = q_s + BQ * RS;
  float* lse_s = reinterpret_cast<float*>(do_s + BQ * RS);
  float* delta_s = lse_s + BQ;

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int group = H / KVH;
  const int m0 = (threadIdx.x >> 5) * 16;
  const int g = (threadIdx.x & 31) >> 2, tig = threadIdx.x & 3;
  const int k0 = kt * BK;
  const size_t q_row = (size_t)H * D, kv_row = (size_t)KVH * D;
  const size_t kvoff = ((size_t)b * S + k0) * kv_row + (size_t)kvh * D;

  stage_bf16<D>(k_s, k + kvoff, kv_row);
  stage_bf16<D>(v_s, v + kvoff, kv_row);

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[i][e] = acc_v[i][e] = 0.f;

  const int qt0 = causal ? k0 / BQ : 0;
  for (int gi = 0; gi < group; ++gi) {
    const int h = kvh * group + gi;
    for (int qt = qt0; qt < S / BQ; ++qt) {
      const int q0 = qt * BQ;
      const size_t qoff = ((size_t)b * S + q0) * q_row + (size_t)h * D;
      const size_t stat = ((size_t)b * H + h) * S + q0;
      __syncthreads();  // the previous tile is done with q_s, do_s
      stage_bf16<D>(q_s, q + qoff, q_row);
      stage_bf16<D>(do_s, dout + qoff, q_row);
      if (threadIdx.x < BQ) {
        lse_s[threadIdx.x] = lse[stat + threadIdx.x];
        delta_s[threadIdx.x] = delta[stat + threadIdx.x];
      }
      __syncthreads();
#pragma unroll
      for (int qc = 0; qc < BQ; qc += QC) {
        // Every (key, query) pair of this warp's half tile masked: skip
        // (warp-uniform; no barrier inside).
        if (causal && q0 + qc + QC - 1 < k0 + m0) continue;
        float s[QC / 8][4], dp[QC / 8][4];
#pragma unroll
        for (int nt = 0; nt < QC / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D; kk += 16) {
          uint32_t ak[4], av[4];
          load_a<D>(ak, k_s, m0, kk);
          load_a<D>(av, v_s, m0, kk);
#pragma unroll
          for (int nt = 0; nt < QC / 8; ++nt) {
            uint32_t bq[2], bdo[2];
            load_bt<D>(bq, q_s, qc + nt * 8, kk);
            load_bt<D>(bdo, do_s, qc + nt * 8, kk);
            mma_bf16(s[nt], ak, bq);
            mma_bf16(dp[nt], av, bdo);
          }
        }
        // Transposed tiles: rows are keys, columns queries.
        uint32_t ap[QC / 16][4], ads[QC / 16][4];
#pragma unroll
        for (int nt = 0; nt < QC / 8; ++nt) {
          float p[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = qc + nt * 8 + 2 * tig + (e & 1);
            float x = s[nt][e] * scale;
            if (causal && k0 + m0 + g + (e >> 1) * 8 > q0 + c)
              x = rtt::NEG_INF;
            p[e] = expf(x - lse_s[c]);
            ds[e] = p[e] * (dp[nt][e] - delta_s[c]);
          }
          to_a(ap, nt, p);
          to_a(ads, nt, ds);
        }
#pragma unroll
        for (int j = 0; j < QC / 16; ++j) {
          mma_rows<D>(acc_v, ap[j], do_s, qc + j * 16);
          mma_rows<D>(acc_k, ads[j], q_s, qc + j * 16);
        }
      }
    }
  }
  store_rows<D>(dk + kvoff, m0, kv_row, acc_k, scale);
  store_rows<D>(dv + kvoff, m0, kv_row, acc_v, 1.f);
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int B, S, H, KVH;
  float scale;
  int causal;
  cudaStream_t stream;
};

// K11 (bf16, D in {64, 128}): the Hopper design (hopper.cuh).  One CTA
// per (128-row kv tile, kv head, batch), 3 warpgroups: warpgroup 0 is
// the producer (one thread issues every TMA load, on 24 registers), 1
// and 2 the consumers (240 registers), each owning 64 kv rows.  K and V
// (128 x D) load once; a 3-stage ring over (q head of the group, 64-row
// q tile) brings q, do, lse and delta (33 KB a stage at D = 128).  Per
// stage each consumer computes S^T = K.Q^T and dP^T = V.dO^T (wgmma
// m64n64k16, both operands in shared memory, K-major), P^T and dS^T in
// registers, rounded to bf16 into A fragments, then dV += P^T.dO and
// dK += dS^T.Q (wgmma m64nDk16, A in registers, dO and Q MN-major).  dK
// and dV stay in registers (128 f32 a thread at D = 128, without
// spills); the group is summed in f32 in a fixed order, with no atomics.
// The kv tiles with the most q tiles to walk launch first.
namespace hk {

namespace hp = rtt::hopper;
constexpr int BKV = 128, BQT = 64, STAGES = 3, THREADS = 3 * hp::WG_THREADS;

template <int D>
struct Smem {
  static constexpr uint32_t KV_BYTES = BKV * D * 2, QT_BYTES = BQT * D * 2;
  static constexpr uint32_t V_OFF = KV_BYTES;
  static constexpr uint32_t STAGE_OFF = 2 * KV_BYTES;
  // q, do, then lse and delta (256 bytes each), padded to 1024 bytes.
  static constexpr uint32_t STAGE_BYTES = 2 * QT_BYTES + 1024;
  static constexpr uint32_t BYTES = STAGE_OFF + STAGES * STAGE_BYTES;
  static constexpr uint32_t TX_BYTES = 2 * QT_BYTES + 2 * BQT * 4;
};

// Barriers: kv_full, full[STAGES], empty[STAGES].
constexpr int N_BARS = 1 + 2 * STAGES;

template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dkv_wgmma(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int S, int H, int KVH, float scale, int causal) {
  using L = Smem<D>;
  constexpr int NB = D / 64;  // 64-column swizzle blocks of a row
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[N_BARS];
  const uint32_t raw = hp::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint8_t* sbase = smem_raw + (base - raw);
  const uint32_t kv_full = hp::smem_u32(bars);
  auto full = [&](int s) { return kv_full + 8u * (1 + s); };
  auto empty = [&](int s) { return kv_full + 8u * (1 + STAGES + s); };

  const int kvh = blockIdx.x, b = blockIdx.y, kt = blockIdx.z;
  const int group = H / KVH;
  const int k0 = kt * BKV;
  const int qt0 = causal ? k0 / BQT : 0;
  const int per_head = S / BQT - qt0;
  const int n_stages = group * per_head;
  const int wg = threadIdx.x / hp::WG_THREADS;

  if (threadIdx.x == 0) {
    hp::mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hp::mbar_init(full(s), 1);
      hp::mbar_init(empty(s), 8);  // lane 0 of each consumer warp
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    hp::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hp::mbar_expect_tx(kv_full, 2 * L::KV_BYTES);
      for (int c = 0; c < NB; ++c) {
        hp::tma_load_4d(base + c * BKV * 128, &tm_k, kv_full, c * 64, kvh,
                        k0, b);
        hp::tma_load_4d(base + L::V_OFF + c * BKV * 128, &tm_v, kv_full,
                        c * 64, kvh, k0, b);
      }
      for (int i = 0; i < n_stages; ++i) {
        const int s = i % STAGES;
        const int h = kvh * group + i / per_head;
        const int q0 = (qt0 + i % per_head) * BQT;
        const uint32_t st = base + L::STAGE_OFF + s * L::STAGE_BYTES;
        const size_t stat = ((size_t)b * H + h) * S + q0;
        hp::mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);
        hp::mbar_expect_tx(full(s), L::TX_BYTES);
        for (int c = 0; c < NB; ++c) {
          hp::tma_load_4d(st + c * BQT * 128, &tm_q, full(s), c * 64, h, q0,
                          b);
          hp::tma_load_4d(st + L::QT_BYTES + c * BQT * 128, &tm_do, full(s),
                          c * 64, h, q0, b);
        }
        hp::bulk_load(st + 2 * L::QT_BYTES, lse + stat, BQT * 4, full(s));
        hp::bulk_load(st + 2 * L::QT_BYTES + 256, delta + stat, BQT * 4,
                      full(s));
      }
    }
    return;
  }

  hp::setmaxnreg_inc<240>();
  const int w = wg - 1;  // which 64 kv rows of the tile
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int kr0 = k0 + 64 * w + 16 * warp + g;  // this thread's keys: + 0, 8
  const bool live = k0 + 64 * w < S;  // the last tile's second half may not
  const float sl2 = scale * hp::LOG2E;
  const uint32_t ka = base + w * 64 * 128;
  const uint32_t va = base + L::V_OFF + w * 64 * 128;

  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

  hp::mbar_wait(kv_full, 0);
  for (int i = 0; i < n_stages; ++i) {
    const int s = i % STAGES;
    const int q0 = (qt0 + i % per_head) * BQT;
    const uint32_t qs = base + L::STAGE_OFF + s * L::STAGE_BYTES;
    const uint32_t dos = qs + L::QT_BYTES;
    const float* lse_s = reinterpret_cast<const float*>(
        sbase + L::STAGE_OFF + s * L::STAGE_BYTES + 2 * L::QT_BYTES);
    const float* delta_s = lse_s + 64;
    hp::mbar_wait(full(s), (i / STAGES) & 1);
    // Every (key, query) pair of this warpgroup masked: nothing to add.
    if (live && !(causal && q0 + BQT - 1 < k0 + 64 * w)) {
      float st[BQT / 2], dpt[BQT / 2];
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 columns a k-step
        hp::wgmma_ss(st,
                     hp::desc_sw128(ka + (kk / 4) * BKV * 128 + off, 16, 1024),
                     hp::desc_sw128(qs + (kk / 4) * BQT * 128 + off, 16, 1024),
                     kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        hp::wgmma_ss(dpt,
                     hp::desc_sw128(va + (kk / 4) * BKV * 128 + off, 16, 1024),
                     hp::desc_sw128(dos + (kk / 4) * BQT * 128 + off, 16,
                                    1024),
                     kk > 0);
      }
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_operand(st);
      hp::fence_operand(dpt);

      // Transposed tiles: element e of block j is key kr0 + 8 (e / 2),
      // query q0 + 8j + 2 tig + e % 2.
      const bool edge = causal && k0 + 64 * w + 63 > q0;
      uint32_t ap[BQT / 16][4], ads[BQT / 16][4];
#pragma unroll
      for (int j = 0; j < BQT / 8; ++j) {
        const int c = 8 * j + 2 * tig;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c);
        const float2 dl = *reinterpret_cast<const float2*>(delta_s + c);
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = st[4 * j + e] * sl2;
          if (edge && kr0 + 8 * (e >> 1) > q0 + c + (e & 1)) x = rtt::NEG_INF;
          p[e] = hp::ex2(x - (e & 1 ? l2.y : l2.x) * hp::LOG2E);
          ds[e] = p[e] * (dpt[4 * j + e] - (e & 1 ? dl.y : dl.x));
        }
        to_a(ap, j, p);
        to_a(ads, j, ds);
      }
      hp::fence_operand(acc_v);
      hp::fence_operand(acc_k);
      hp::wgmma_fence();
#pragma unroll
      for (int j = 0; j < BQT / 16; ++j)
        hp::wgmma_rs(acc_v, ap[j],
                     hp::desc_sw128(dos + j * 16 * 128, BQT * 128, 1024), 1);
#pragma unroll
      for (int j = 0; j < BQT / 16; ++j)
        hp::wgmma_rs(acc_k, ads[j],
                     hp::desc_sw128(qs + j * 16 * 128, BQT * 128, 1024), 1);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_operand(acc_v);
      hp::fence_operand(acc_k);
    }
    if (lane == 0) hp::mbar_arrive(empty(s));
  }

  const size_t kv_row = (size_t)KVH * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kr0 + 8 * r;
    if (key >= S) continue;
    const size_t off = ((size_t)b * S + key) * kv_row + (size_t)kvh * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int c = 8 * i + 2 * tig;
      *reinterpret_cast<__nv_bfloat162*>(dk + off + c) =
          __floats2bfloat162_rn(scale * acc_k[4 * i + 2 * r],
                                scale * acc_k[4 * i + 2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + c) =
          __floats2bfloat162_rn(acc_v[4 * i + 2 * r],
                                acc_v[4 * i + 2 * r + 1]);
    }
  }
}

// K10 (bf16, D in {64, 128}): K11's Hopper design with the roles
// swapped.  One CTA per (128-row q tile, head, batch), 3 warpgroups:
// warpgroup 0 is the producer (one thread issues every load, on 24
// registers), 1 and 2 the consumers (240 registers), each owning 64 q
// rows.  Q and dO (128 x D) load once by TMA, lse and delta by bulk
// copies; K and V tiles of 64 keys come through a 3-stage ring (161 KB
// of shared memory at D = 128; 128-key tiles would not leave the
// registers for S, dP and dQ together).  Per kv tile each consumer
// computes S = Q.K^T and dP = dO.V^T (wgmma m64n64k16, both operands in
// shared memory, K-major), p = 2^(S scale log2e - lse log2e) and
// dS = p (dP - delta), rounded to bf16 into A fragments (the Pallas
// rounding point), then dQ += dS.K (wgmma m64nDk16, A in registers, K
// MN-major).  Tile j's S and dP are issued together with tile j - 1's dQ
// product, and j's dS is formed while that product is in flight; dS
// becomes A fragments only after it retires (the first tile is peeled,
// so no wgmma sits in a branch).  dQ stays f32 in registers (64 a thread
// at D = 128) and is scaled and stored once as bf16: each CTA owns its
// rows, no atomics, deterministic.  Causal: each consumer walks kv tiles
// 0 .. its diagonal and masks only the diagonal tile; the q tiles with
// the most kv tiles launch first.  S % 128 == 64: the tensor maps fill
// the last tile's rows past S with zeros and its second consumer, which
// owns no live row, only keeps the barrier protocol.
constexpr int BQD = 128, BKD = 64;

template <int D>
struct SmemDq {
  static constexpr uint32_t Q_BYTES = BQD * D * 2, KV_BYTES = BKD * D * 2;
  static constexpr uint32_t DO_OFF = Q_BYTES;
  static constexpr uint32_t STAT_OFF = 2 * Q_BYTES;  // lse, then delta
  static constexpr uint32_t K_OFF = STAT_OFF + 1024;
  static constexpr uint32_t V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr uint32_t BYTES = V_OFF + STAGES * KV_BYTES;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq_wgmma(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int S, int H,
    int KVH, float scale, int causal) {
  using L = SmemDq<D>;
  constexpr int NB = D / 64;  // 64-column swizzle blocks of a row
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[N_BARS];
  const uint32_t raw = hp::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint8_t* sbase = smem_raw + (base - raw);
  const uint32_t q_full = hp::smem_u32(bars);
  auto full = [&](int s) { return q_full + 8u * (1 + s); };
  auto empty = [&](int s) { return q_full + 8u * (1 + STAGES + s); };

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // heaviest first
  const int q0 = qt * BQD;
  const int rows = min(BQD, S - q0);  // 64 or 128 live rows
  const int kvh = h / (H / KVH);
  const int n_kv = causal ? (q0 + rows) / BKD : S / BKD;
  const int wg = threadIdx.x / hp::WG_THREADS;

  if (threadIdx.x == 0) {
    hp::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hp::mbar_init(full(s), 1);
      hp::mbar_init(empty(s), 8);  // lane 0 of each consumer warp
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    hp::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      const size_t stat = ((size_t)b * H + h) * S + q0;
      hp::mbar_expect_tx(q_full, 2 * L::Q_BYTES + 2 * rows * 4);
      for (int c = 0; c < NB; ++c) {
        hp::tma_load_4d(base + c * BQD * 128, &tm_q, q_full, c * 64, h, q0,
                        b);
        hp::tma_load_4d(base + L::DO_OFF + c * BQD * 128, &tm_do, q_full,
                        c * 64, h, q0, b);
      }
      hp::bulk_load(base + L::STAT_OFF, lse + stat, rows * 4, q_full);
      hp::bulk_load(base + L::STAT_OFF + 512, delta + stat, rows * 4,
                    q_full);
      for (int kt = 0; kt < n_kv; ++kt) {
        const int s = kt % STAGES;
        hp::mbar_wait(empty(s), ((kt / STAGES) & 1) ^ 1);
        const uint32_t kd = base + L::K_OFF + s * L::KV_BYTES;
        const uint32_t vd = base + L::V_OFF + s * L::KV_BYTES;
        hp::mbar_expect_tx(full(s), 2 * L::KV_BYTES);
        for (int c = 0; c < NB; ++c) {
          hp::tma_load_4d(kd + c * BKD * 128, &tm_k, full(s), c * 64, kvh,
                          kt * BKD, b);
          hp::tma_load_4d(vd + c * BKD * 128, &tm_v, full(s), c * 64, kvh,
                          kt * BKD, b);
        }
      }
    }
    return;
  }

  hp::setmaxnreg_inc<240>();
  const int w = wg - 1;  // which 64 rows of the q tile
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  if (64 * w >= rows) {  // the last tile's second half: no live row
    for (int kt = 0; kt < n_kv; ++kt) {
      hp::mbar_wait(full(kt % STAGES), (kt / STAGES) & 1);
      if (lane == 0) hp::mbar_arrive(empty(kt % STAGES));
    }
    return;
  }
  const int g = lane >> 2, tig = lane & 3;
  const int r0 = 64 * w + 16 * warp + g;  // this thread's rows: + 0, 8
  // Kv tiles 0 .. this warpgroup's diagonal; only the diagonal is masked.
  const int n_w = causal ? 2 * qt + w + 1 : n_kv;
  const float sl2 = scale * hp::LOG2E;
  const uint32_t qa = base + w * 64 * 128;
  const uint32_t doa = base + L::DO_OFF + w * 64 * 128;

  hp::mbar_wait(q_full, 0);
  const float* lse_s = reinterpret_cast<const float*>(sbase + L::STAT_OFF);
  const float* delta_s = lse_s + BQD;
  const float lse2[2] = {lse_s[r0] * hp::LOG2E, lse_s[r0 + 8] * hp::LOG2E};
  const float dl[2] = {delta_s[r0], delta_s[r0 + 8]};

  float acc[D / 2], st[BKD / 2], dpt[BKD / 2];
  uint32_t ads[BKD / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  auto issue_sdp = [&](int kt) {
    const int s = kt % STAGES;
    const uint32_t kb = base + L::K_OFF + s * L::KV_BYTES;
    const uint32_t vb = base + L::V_OFF + s * L::KV_BYTES;
    hp::mbar_wait(full(s), (kt / STAGES) & 1);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // 16 columns a k-step
      hp::wgmma_ss(st,
                   hp::desc_sw128(qa + (kk / 4) * BQD * 128 + off, 16, 1024),
                   hp::desc_sw128(kb + (kk / 4) * BKD * 128 + off, 16, 1024),
                   kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      hp::wgmma_ss(dpt,
                   hp::desc_sw128(doa + (kk / 4) * BQD * 128 + off, 16, 1024),
                   hp::desc_sw128(vb + (kk / 4) * BKD * 128 + off, 16, 1024),
                   kk > 0);
    }
    hp::wgmma_commit();
  };
  auto issue_dq = [&](int kt) {
    const uint32_t kb = base + L::K_OFF + (kt % STAGES) * L::KV_BYTES;
#pragma unroll
    for (int j = 0; j < BKD / 16; ++j)
      hp::wgmma_rs(acc, ads[j],
                   hp::desc_sw128(kb + j * 16 * 128, BKD * 128, 1024), 1);
    hp::wgmma_commit();
  };
  // dS of tile kt in place of its scores.  Element e of block j is row
  // r0 + 8 (e / 2), key kt * 64 + 8j + 2 tig + e % 2; the diagonal tile
  // starts at key q0 + 64 w.
  auto form_ds = [&](int kt) {
    const bool edge = causal && kt == n_w - 1;
#pragma unroll
    for (int j = 0; j < BKD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = st[4 * j + e] * sl2;
        if (edge && 8 * j + 2 * tig + (e & 1) > 16 * warp + g + 8 * (e >> 1))
          x = rtt::NEG_INF;
        const float p = hp::ex2(x - lse2[e >> 1]);
        st[4 * j + e] = p * (dpt[4 * j + e] - dl[e >> 1]);
      }
  };
  auto pack_ds = [&] {
#pragma unroll
    for (int j = 0; j < BKD / 8; ++j) to_a(ads, j, st + 4 * j);
  };

  issue_sdp(0);
  hp::wgmma_wait<0>();
  hp::fence_operand(st);
  hp::fence_operand(dpt);
  form_ds(0);
  pack_ds();
  for (int kt = 1; kt < n_w; ++kt) {
    issue_sdp(kt);
    issue_dq(kt - 1);
    hp::wgmma_wait<1>();
    hp::fence_operand(st);
    hp::fence_operand(dpt);
    form_ds(kt);
    // Tile kt - 1's dQ product has retired: free its stage and make
    // tile kt's dS the A fragments.
    hp::wgmma_wait<0>();
    hp::fence_operand(acc);
    if (lane == 0) hp::mbar_arrive(empty((kt - 1) % STAGES));
    pack_ds();
  }
  hp::fence_operand(acc);
  hp::wgmma_fence();
  issue_dq(n_w - 1);
  hp::wgmma_wait<0>();
  hp::fence_operand(acc);
  if (lane == 0) hp::mbar_arrive(empty((n_w - 1) % STAGES));

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t off = (((size_t)b * S + q0 + r0 + 8 * r) * H + h) * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(dq + off + 8 * i + 2 * tig) =
          __floats2bfloat162_rn(scale * acc[4 * i + 2 * r],
                                scale * acc[4 * i + 2 * r + 1]);
  }
}

template <int D>
int launch_dq(const Args& a) {
  CUtensorMap tq, tk, tv, tdo;
  int err = hp::encode_bshd(&tq, a.q, a.B, a.S, a.H, D, BQD);
  if (!err) err = hp::encode_bshd(&tdo, a.dout, a.B, a.S, a.H, D, BQD);
  if (!err) err = hp::encode_bshd(&tk, a.k, a.B, a.S, a.KVH, D, BKD);
  if (!err) err = hp::encode_bshd(&tv, a.v, a.B, a.S, a.KVH, D, BKD);
  if (err) return err;
  constexpr size_t smem = SmemDq<D>::BYTES + 1024;  // + alignment slack
  err = (int)cudaFuncSetAttribute(flash_bwd_dq_wgmma<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem);
  if (err) return err;
  const dim3 grid(a.H, a.B, (a.S + BQD - 1) / BQD);
  flash_bwd_dq_wgmma<D><<<grid, THREADS, smem, a.stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<bf16*>(a.dq), a.S, a.H,
      a.KVH, a.scale, a.causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const Args& a) {
  CUtensorMap tq, tk, tv, tdo;
  int err = hp::encode_bshd(&tq, a.q, a.B, a.S, a.H, D, BQT);
  if (!err) err = hp::encode_bshd(&tdo, a.dout, a.B, a.S, a.H, D, BQT);
  if (!err) err = hp::encode_bshd(&tk, a.k, a.B, a.S, a.KVH, D, BKV);
  if (!err) err = hp::encode_bshd(&tv, a.v, a.B, a.S, a.KVH, D, BKV);
  if (err) return err;
  constexpr size_t smem = Smem<D>::BYTES + 1024;  // + alignment slack
  err = (int)cudaFuncSetAttribute(flash_bwd_dkv_wgmma<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem);
  if (err) return err;
  const dim3 grid(a.KVH, a.B, (a.S + BKV - 1) / BKV);
  flash_bwd_dkv_wgmma<D><<<grid, THREADS, smem, a.stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.S, a.H, a.KVH, a.scale, a.causal);
  return (int)cudaGetLastError();
}

}  // namespace hk

template <typename T, int D>
int launch_dq(const Args& a) {
  const dim3 grid(a.S / BQ, a.H, a.B);
  cudaError_t err;
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr size_t smem = mma_smem_bytes<D>(4, 2);
    err = cudaFuncSetAttribute(flash_bwd_dq_mma<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dq_mma<D><<<grid, MMA_THREADS, smem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<bf16*>(a.dq), a.S, a.H, a.KVH, a.scale, a.causal);
  } else {
    const size_t smem = smem_bytes<D>(1);
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dq_kernel<D><<<grid, THREADS, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<float*>(a.dq), a.S, a.H, a.KVH, a.scale, a.causal);
  }
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const Args& a) {
  const dim3 grid(a.S / BK, a.KVH, a.B);
  cudaError_t err;
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr size_t smem = mma_smem_bytes<D>(4, 2);
    err = cudaFuncSetAttribute(flash_bwd_dkv_mma<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dkv_mma<D><<<grid, MMA_THREADS, smem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.S, a.H, a.KVH,
        a.scale, a.causal);
  } else {
    const size_t smem = smem_bytes<D>(2);
    err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dkv_kernel<D><<<grid, THREADS, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.S, a.H,
        a.KVH, a.scale, a.causal);
  }
  return (int)cudaGetLastError();
}

// K10 and K11 by dtype and D: bf16 at D 64 and 128 takes the Hopper
// kernels, bf16 at D 16 and 32 the mma.sync tiles, f32 the FMA tiles.
template <typename T, int D>
int launch(int which, const Args& a) {
  if constexpr (std::is_same<T, bf16>::value && D >= 64)
    return which == 0 ? hk::launch_dq<D>(a) : hk::launch_dkv<D>(a);
  else
    return which == 0 ? launch_dq<T, D>(a) : launch_dkv<T, D>(a);
}

template <typename T>
int dispatch_d(int which, int D, const Args& a) {
  switch (D) {
    case 16: return launch<T, 16>(which, a);
    case 32: return launch<T, 32>(which, a);
    case 64: return launch<T, 64>(which, a);
    case 128: return launch<T, 128>(which, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

int entry(int which, const void* q, const void* k, const void* v,
          const void* dout, const void* lse, const void* delta, void* dq,
          void* dk, void* dv, int dtype, int B, int S, int H, int KVH, int D,
          float scale, int causal, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, dk, dv, B, S, H, KVH,
               scale, causal, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_d<float>(which, D, a);
  return dispatch_d<__nv_bfloat16>(which, D, a);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  S % 64 == 0, D in {16,32,64,128}.
// K10: dq [B, S, H, D].
extern "C" int rtt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int dtype, int B,
                                int S, int H, int KVH, int D, float scale,
                                int causal, void* stream) {
  return entry(0, q, k, v, dout, lse, delta, dq, nullptr, nullptr, dtype, B,
               S, H, KVH, D, scale, causal, stream);
}

// K11: dk, dv [B, S, KVH, D], summed over each kv head's q heads.
extern "C" int rtt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 int dtype, int B, int S, int H, int KVH,
                                 int D, float scale, int causal,
                                 void* stream) {
  return entry(1, q, k, v, dout, lse, delta, nullptr, dk, dv, dtype, B, S, H,
               KVH, D, scale, causal, stream);
}
