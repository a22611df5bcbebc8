// Hopper ragged paged attention: the attention of K4
// (ragged_attention.cu) and of K8's attention phase (fused_ragged.cu) on
// bf16 fresh keys and bf16 or int8 pools, head dims 64 and 128.
//
// Work: a q tile is 64 query rows (tokens x the qpg heads of one kv
// head) of one row; its keys are the row's pooled past (positions below
// min(start, maxp * page), through block_tables) and then the row's fresh
// keys up to the tile's last token, in blocks of 64.  A cluster of C CTAs
// (C from the wrapper, fixed per launch) splits a tile's key blocks into
// contiguous runs, one per rank, so a decode row's long past is walked by
// several SMs at once; ranks past the last run exit at once.  The grid is
// (C, KVH, slots), slots an upper bound on the q tiles of the call (the
// row lengths live on the card and are not read by the host): a CTA finds
// its (row, tile) from the row lengths, a row's last tile first (it has
// the most fresh keys), and slots past every tile exit at once.
//
// A CTA is one consumer warpgroup (warps 0-3) and one producer warp
// (warp 4), two CTAs an SM.  The producer fills a 2-stage ring by TMA,
// page ids fetched 32 at a time across its lanes: bf16 pools and the
// fresh k/v [T, KVH, D] as [64 keys][D] bf16 tiles in the 128-byte
// swizzle (a page of one kv head is one contiguous [page][D] block, boxes
// of min(page, 64) rows); int8 pools as raw [64][D] rows, with each key's
// page scales beside them, which the consumer converts to bf16 (exact)
// in one tile pair (fresh keys land there by TMA after the block before
// them).  The consumer runs S = Q . K^T as wgmma m64n64k16 (both operands
// in shared memory, K-major), the online softmax in f32 registers (log2
// units), and O += P . V as wgmma m64nDk16 with P from registers and V
// MN-major.
//
// Precision is f32 level, as the CUDA-core kernels it replaces: bf16 q and
// bf16 or int8 pages are exact in bf16 and the products sum in f32; an
// operand that is not (K8's f32 q, and p always) is split into hi + lo
// bf16 parts, each its own wgmma, so the dropped bits are about 2^-17 of
// the operand.  int8 scales: the k scale multiplies the score after the
// dot (before the soft cap and the mask), the v scale multiplies p before
// P . V, and l sums the unscaled p.
//
// The ranks of a cluster merge through distributed shared memory: each
// rank puts its (acc, m, l) in its own shared memory, and after a cluster
// barrier each live rank takes a share of the tile's outputs, sums the
// ranks' terms in rank order (deterministic) scaled to the common max,
// and stores acc / l; a second barrier keeps every rank's memory alive
// until all have read it.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace rtt {
namespace ragged {

namespace hp = rtt::hopper;

constexpr int QR = 64;        // query rows of a tile
constexpr int KB = 64;        // keys of a block
constexpr int STAGES = 2;
constexpr int THREADS = 160;  // consumer warpgroup + producer warp
constexpr int MAX_CLUSTER = 8;

struct Params {
  const void* q;      // (token t, head h, d) at t * q_tok + h * D + d
  long long q_tok;
  const void* k_pools;  // [L, KVH, P, page, D]
  const void* v_pools;
  const float* k_scales;  // int8 pools: [L, P, KVH, 1]
  const float* v_scales;
  const int* row_slot;
  const int* row_start;
  const int* row_len;
  const int* row_off;
  const int* block_tables;  // [slots, maxp]
  void* out;  // (token t, head h, d) at t * o_tok + h * D + d
  long long o_tok;
  int T, R, H, KVH, L, P, page, maxp, layer;
  float scale, soft_cap;
};

// Eight values as eight bf16 (hi) and, for f32, the rounded remainder (lo).
__device__ __forceinline__ void split8(const float* v, uint4& hi, uint4& lo) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    const float2 f = __bfloat1622float2(b);
    const __nv_bfloat162 r =
        __floats2bfloat162_rn(v[2 * i] - f.x, v[2 * i + 1] - f.y);
    h[i] = *reinterpret_cast<const uint32_t*>(&b);
    l[i] = *reinterpret_cast<const uint32_t*>(&r);
  }
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  rtt::Vec<__nv_bfloat16>::load(p, v);
}

__device__ __forceinline__ uint32_t bf16x2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);  // a: low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Byte offset of 16-byte chunk c8 (8 bf16 columns) of row r in a tile of
// 64 rows: 64-column blocks of 8 KB, the 128-byte swizzle inside.
__device__ __forceinline__ uint32_t swz(int r, int c8) {
  return (c8 >> 3) * (64 * 128) + r * 128 + (((c8 & 7) ^ (r & 7)) << 4);
}

template <typename TQ, typename TO, bool I8, int D>
__global__ void __launch_bounds__(THREADS, 2) attention_hopper(
    const __grid_constant__ CUtensorMap tm_kp,
    const __grid_constant__ CUtensorMap tm_vp,
    const __grid_constant__ CUtensorMap tm_kn,
    const __grid_constant__ CUtensorMap tm_vn, const Params p) {
  constexpr bool SPLIT_Q = std::is_same<TQ, float>::value;
  constexpr int NB = D / 64;                      // 64-column blocks
  constexpr uint32_t TILE = 64 * D * 2;           // a [64][D] bf16 tile
  constexpr uint32_t QB = (SPLIT_Q ? 2 : 1) * TILE;  // q (hi, lo)
  constexpr int LDD = D + 4;                      // result row (floats)
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES + 2];
  __shared__ float ks_s[STAGES][KB], vs_s[STAGES][KB];
  __shared__ float m_s[QR], l_s[QR], lsum_s[QR];
  __shared__ float scl_s[MAX_CLUSTER][QR];
  __shared__ int item[2];
  const uint32_t sbase = hp::smem_u32(smem_raw);
  const uint32_t base = (sbase + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - sbase);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const int rank = blockIdx.x, C = gridDim.x, g = blockIdx.y;
  const int qpg = p.H / p.KVH;
  const int tpt = QR / qpg;  // tokens of a full tile

  // This CTA's (row, tile): slot blockIdx.z of the rows' tiles in order.
  int* cnt = reinterpret_cast<int*>(sm + QB);
  for (int r = tid; r < p.R; r += THREADS) {
    const int n = p.row_len[r];
    cnt[r] = n > 0 ? (n + tpt - 1) / tpt : 0;
  }
  __syncthreads();
  if (tid == 0) {
    int at = 0, row = -1, tile = 0;
    for (int r = 0; r < p.R; ++r) {
      if ((int)blockIdx.z < at + cnt[r]) {
        row = r;
        tile = cnt[r] - 1 - ((int)blockIdx.z - at);
        break;
      }
      at += cnt[r];
    }
    item[0] = row;
    item[1] = tile;
  }
  __syncthreads();
  const int row = item[0];
  if (row < 0) return;
  const int slot = p.row_slot[row], start = p.row_start[row];
  const int len = p.row_len[row], off = p.row_off[row];
  const int t0 = item[1] * tpt;
  const int ntok = min(tpt, len - t0);
  const int nrows = ntok * qpg;
  const int n_pool = min(start, p.maxp * p.page);
  const int nbp = (n_pool + KB - 1) / KB;       // pooled blocks
  const int nb = nbp + (t0 + ntok + KB - 1) / KB;  // + fresh blocks
  const int per = (nb + C - 1) / C;
  const int n_live = (nb + per - 1) / per;
  if (rank >= n_live) return;
  const int b0 = rank * per;
  const int nmy = min(per, nb - b0);

  // The ring: bf16 pools and fresh keys, k and v tiles in the swizzle at
  // QB + s * 2 TILE.  int8 pools: the ring holds the pooled blocks' raw
  // [64][D] int8 k and v (RAW each) at QB + 2 TILE + s * 2 RAW, which the
  // consumer converts into the one bf16 tile pair at QB; fresh blocks land
  // there by TMA once the block before them is done (buf_full, buf_free).
  constexpr uint32_t RAW = 64 * D;
  const uint32_t full0 = hp::smem_u32(bars), empty0 = full0 + 8 * STAGES;
  const uint32_t buf_full = full0 + 16 * STAGES, buf_free = buf_full + 8;
  auto ring = [&](int s) {
    return base + QB + (I8 ? 2 * TILE + s * 2 * RAW : s * 2 * TILE);
  };
  // This rank's pooled blocks are its first np.
  const int np = min(max(nbp - b0, 0), nmy);
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hp::mbar_init(full0 + 8 * s, 1);
      hp::mbar_init(empty0 + 8 * s, 4);  // lane 0 of each consumer warp
    }
    hp::mbar_init(buf_full, 1);
    hp::mbar_init(buf_free, 4);
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {
    // Producer: block b0 + j into stage j % STAGES.  The row's page ids
    // come 32 at a time, one per lane, so no block waits on a load of
    // the block table before its copies are issued.
    const int* bt = p.block_tables + (size_t)slot * p.maxp;
    const int head = p.layer * p.KVH + g;
    const int pr = min(p.page, KB);  // rows of one pooled box
    int window = -1, ids = 0;
    auto page_id = [&](int pos) {  // warp-uniform pos
      const int pc = min(pos / p.page, p.maxp - 1);
      if (pc / 32 != window) {
        window = pc / 32;
        const int at = min(32 * window + lane, p.maxp - 1);
        ids = min(max(bt[at], 0), p.P - 1);
      }
      return __shfl_sync(0xffffffffu, ids, pc % 32);
    };
    for (int j = 0; j < nmy; ++j) {
      const int blk = b0 + j, s = j % STAGES;
      if (blk < nbp) {
        const int pos0 = blk * KB;
        const uint32_t kd = ring(s), vd = kd + (I8 ? RAW : TILE);
        hp::mbar_wait(empty0 + 8 * s, ((j / STAGES) & 1) ^ 1);
        if (I8) {  // each key's page scales beside the block
          for (int rr = 0; rr < KB; rr += 32) {
            int pid = 0;
            for (int u = rr / pr; u < (rr + 32 + pr - 1) / pr && u < KB / pr;
                 ++u) {
              const int id = page_id(pos0 + u * pr);
              if ((rr + lane) / pr == u) pid = id;
            }
            const size_t so = ((size_t)p.layer * p.P + pid) * p.KVH + g;
            ks_s[s][rr + lane] = p.k_scales[so];
            vs_s[s][rr + lane] = p.v_scales[so];
          }
          __syncwarp();
        }
        if (lane == 0)
          hp::mbar_expect_tx(full0 + 8 * s, I8 ? 2 * RAW : 2 * TILE);
        for (int u = 0; u < KB / pr; ++u) {
          const int pos = pos0 + u * pr;
          const int pid = page_id(pos);
          if (lane == 0) {
            for (int c = 0; c < (I8 ? 1 : NB); ++c) {
              const uint32_t o = I8 ? u * pr * D : c * (64 * 128) + u * pr * 128;
              hp::tma_load_4d(kd + o, &tm_kp, full0 + 8 * s, 64 * c,
                              pos % p.page, pid, head);
              hp::tma_load_4d(vd + o, &tm_vp, full0 + 8 * s, 64 * c,
                              pos % p.page, pid, head);
            }
          }
        }
      } else {
        const int j0 = (blk - nbp) * KB;
        uint32_t kd = ring(s), bar = full0 + 8 * s;
        if (I8) {
          // Into the bf16 tile once the block before has been consumed.
          if (j > 0) hp::mbar_wait(buf_free, (j - max(np, 1)) & 1);
          kd = base + QB;
          bar = buf_full;
        } else {
          hp::mbar_wait(empty0 + 8 * s, ((j / STAGES) & 1) ^ 1);
        }
        if (lane == 0) {
          hp::mbar_expect_tx(bar, 2 * TILE);
          for (int c = 0; c < NB; ++c) {
            hp::tma_load_4d(kd + c * (64 * 128), &tm_kn, bar, 64 * c, g,
                            off + j0, 0);
            hp::tma_load_4d(kd + TILE + c * (64 * 128), &tm_vn, bar, 64 * c,
                            g, off + j0, 0);
          }
        }
      }
    }
  } else {
    // Consumer.  The q tile, rounded (bf16 q) or split hi + lo (f32 q).
    const TQ* q = static_cast<const TQ*>(p.q);
    for (int i = tid; i < QR * (D / 8); i += 128) {
      const int r = i / (D / 8), c8 = i % (D / 8);
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (r < nrows)
        load8(q + (off + t0 + r / qpg) * p.q_tok +
                  (size_t)(g * qpg + r % qpg) * D + 8 * c8,
              v);
      uint4 hi, lo;
      split8(v, hi, lo);
      *reinterpret_cast<uint4*>(sm + swz(r, c8)) = hi;
      if constexpr (SPLIT_Q)
        *reinterpret_cast<uint4*>(sm + TILE + swz(r, c8)) = lo;
    }
    hp::fence_proxy_async();
    asm volatile("bar.sync 1, 128;\n" ::: "memory");

    const int gq = lane >> 2, tig = lane & 3;
    const int rA = 16 * warp + gq;  // and rA + 8
    int tok[2];                     // the rows' tokens in the row (-1: none)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      tok[h] = rA + 8 * h < nrows ? t0 + (rA + 8 * h) / qpg : -1;
    const float cap = p.soft_cap;
    float acc[D / 2], sc[KB / 2];
    uint32_t ph[KB / 16][4], pl[KB / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m2[2] = {rtt::NEG_INF, rtt::NEG_INF}, l2[2] = {0.f, 0.f};

    for (int j = 0; j < nmy; ++j) {
      const int blk = b0 + j, s = j % STAGES;
      const bool pooled = blk < nbp;
      uint32_t kb = ring(s);
      if (I8) {
        kb = base + QB;
        if (pooled) {
          // The raw int8 rows to bf16 in the swizzle (exact), once every
          // warp's products of the last block are done with the tile.
          hp::mbar_wait(full0 + 8 * s, (j / STAGES) & 1);
          asm volatile("bar.sync 1, 128;\n" ::: "memory");
          const uint8_t* raw = sm + (ring(s) - base);
#pragma unroll 4
          for (int e = tid; e < 2 * 64 * (D / 8); e += 128) {
            const int kv = e / (64 * (D / 8)), r = (e / (D / 8)) % 64;
            const int c8 = e % (D / 8);
            const uint2 v = *reinterpret_cast<const uint2*>(
                raw + kv * RAW + r * D + 8 * c8);
            *reinterpret_cast<uint4*>(sm + QB + kv * TILE + swz(r, c8)) =
                rtt::int8x8_to_bf16(v.x, v.y);
          }
          hp::fence_proxy_async();
          asm volatile("bar.sync 1, 128;\n" ::: "memory");
        } else {
          hp::mbar_wait(buf_full, (j - np) & 1);
        }
      } else {
        hp::mbar_wait(full0 + 8 * s, (j / STAGES) & 1);
      }
      const uint32_t vb = kb + TILE;
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t o = (kk / 4) * (64 * 128) + (kk % 4) * 32;
        hp::wgmma_ss(sc, hp::desc_sw128(base + o, 16, 1024),
                     hp::desc_sw128(kb + o, 16, 1024), kk > 0);
      }
      if constexpr (SPLIT_Q) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t o = (kk / 4) * (64 * 128) + (kk % 4) * 32;
          hp::wgmma_ss(sc, hp::desc_sw128(base + TILE + o, 16, 1024),
                       hp::desc_sw128(kb + o, 16, 1024), 1);
        }
      }
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_operand(sc);

      // Scores to log2 units: scale, k scale, soft cap, mask.  Key c of
      // the block is valid for row half h when c < lim[h]: the pooled
      // past below n_pool, or the fresh keys up to the row's token.
      int lim[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        lim[h] = tok[h] < 0 ? 0
                 : pooled   ? n_pool - blk * KB
                            : tok[h] + 1 - (blk - nbp) * KB;
#pragma unroll
      for (int i = 0; i < KB / 2; ++i) {
        sc[i] *= p.scale;
        if (I8 && pooled) sc[i] *= ks_s[s][8 * (i / 4) + 2 * tig + (i & 1)];
      }
      if (cap > 0.f) {
#pragma unroll
        for (int i = 0; i < KB / 2; ++i) sc[i] = cap * tanhf(sc[i] / cap);
      }
      float mx[2] = {rtt::NEG_INF, rtt::NEG_INF};
#pragma unroll
      for (int i = 0; i < KB / 2; ++i) {
        const int h = (i >> 1) & 1;
        const int c = 8 * (i / 4) + 2 * tig + (i & 1);
        sc[i] = c < lim[h] ? sc[i] * hp::LOG2E : rtt::NEG_INF;
        mx[h] = fmaxf(mx[h], sc[i]);
      }
      float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m2[h], rtt::group_max<4>(mx[h]));
        corr[h] = hp::ex2(m2[h] - m_new);
        m2[h] = m_new;
      }
      // p (l takes it unscaled), then p * v scale split hi + lo as the A
      // fragments of the P . V k-steps.
#pragma unroll
      for (int i = 0; i < KB / 2; ++i) {
        const int h = (i >> 1) & 1;
        const float pe =
            sc[i] == rtt::NEG_INF ? 0.f : hp::ex2(sc[i] - m2[h]);
        sum[h] += pe;
        sc[i] = (I8 && pooled) ? pe * vs_s[s][8 * (i / 4) + 2 * tig + (i & 1)]
                               : pe;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        l2[h] = corr[h] * l2[h] + rtt::group_sum<4>(sum[h]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
#pragma unroll
      for (int i = 0; i < KB / 8; ++i) {  // 8-key column blocks
        const float* x = sc + 4 * i;
        const uint32_t h01 = bf16x2(x[0], x[1]), h23 = bf16x2(x[2], x[3]);
        const float2 f01 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&h01));
        const float2 f23 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&h23));
        ph[i / 2][(i & 1) * 2] = h01;
        ph[i / 2][(i & 1) * 2 + 1] = h23;
        pl[i / 2][(i & 1) * 2] = bf16x2(x[0] - f01.x, x[1] - f01.y);
        pl[i / 2][(i & 1) * 2 + 1] = bf16x2(x[2] - f23.x, x[3] - f23.y);
      }
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KB / 16; ++kk) {
        const uint64_t dv = hp::desc_sw128(vb + kk * 16 * 128, 64 * 128, 1024);
        hp::wgmma_rs(acc, ph[kk], dv, 1);
        hp::wgmma_rs(acc, pl[kk], dv, 1);
      }
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_operand(acc);
      if (lane == 0) {
        if (!I8 || pooled) hp::mbar_arrive(empty0 + 8 * s);
        if (I8 && j + 1 >= np && j + 1 < nmy) hp::mbar_arrive(buf_free);
      }
    }

    // This rank's (acc, m, l) into its own shared memory (over the ring,
    // which both warpgroups are done with).
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
    float* res = reinterpret_cast<float*>(sm + QB);
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(res + (rA + 8 * h) * LDD + 8 * i +
                                   2 * tig) =
            make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
    if (tig == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m_s[rA + 8 * h] = m2[h];
        l_s[rA + 8 * h] = l2[h];
      }
    }
  }

  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  hp::cluster_arrive();
  hp::cluster_wait();
  // Each row's common max and sum over the live ranks, then this rank's
  // share of the outputs: sum over ranks (in order) of acc * 2^(m - M).
  if (tid < nrows) {
    float M = rtt::NEG_INF;
    for (int r = 0; r < n_live; ++r)
      M = fmaxf(M, cluster.map_shared_rank(m_s, r)[tid]);
    float l = 0.f;
    for (int r = 0; r < n_live; ++r) {
      const float f = hp::ex2(cluster.map_shared_rank(m_s, r)[tid] - M);
      scl_s[r][tid] = f;
      l += cluster.map_shared_rank(l_s, r)[tid] * f;
    }
    lsum_s[tid] = l;
  }
  __syncthreads();
  const float* res = reinterpret_cast<const float*>(sm + QB);
  TO* out = static_cast<TO*>(p.out);
  const int n_el = nrows * D / 4;  // in float4
  const int lo = (int)((long long)n_el * rank / n_live);
  const int hi = (int)((long long)n_el * (rank + 1) / n_live);
  for (int e = lo + tid; e < hi; e += THREADS) {
    const int r = e / (D / 4), d = 4 * (e % (D / 4));
    float4 part[MAX_CLUSTER];
#pragma unroll
    for (int k = 0; k < MAX_CLUSTER; ++k)
      if (k < n_live)
        part[k] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(res, k) + r * LDD + d);
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < MAX_CLUSTER; ++k)
      if (k < n_live) {
        const float f = scl_s[k][r];
        a[0] += part[k].x * f;
        a[1] += part[k].y * f;
        a[2] += part[k].z * f;
        a[3] += part[k].w * f;
      }
    TO* o = out + (off + t0 + r / qpg) * p.o_tok +
            (size_t)(g * qpg + r % qpg) * D + d;
    const float inv = 1.f / lsum_s[r];
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = rtt::from_float<TO>(a[i] * inv);
  }
  hp::cluster_arrive();
  hp::cluster_wait();
}

// Launch on `st`: C CTAs a cluster, `slots` q-tile slots (>= the tiles of
// every row: sum over rows of ceil(len * qpg / 64)).  Returns a
// cudaError_t.  q, k_new and v_new rows 16-byte aligned; D in {64, 128};
// page % 8 == 0 and page a divisor or a multiple of 64; qpg a power of 2.
template <typename TQ, typename TO, bool I8, int D>
int launch_hopper(const Params& p, const void* k_new, const void* v_new,
                  int C, int slots, cudaStream_t st) {
  if (C < 1 || C > MAX_CLUSTER || slots < 1 || p.page % 8 ||
      (p.page % KB && KB % p.page))
    return (int)cudaErrorInvalidValue;
  CUtensorMap kn, vn, kp, vp;
  int err = hp::encode_bshd(&kn, k_new, 1, p.T, p.KVH, D, KB);
  if (!err) err = hp::encode_bshd(&vn, v_new, 1, p.T, p.KVH, D, KB);
  if (!err) {
    // Pools as 4-d (D, page, P, L * KVH): a box is min(page, 64) rows of
    // one page of one (layer, kv head); bf16 in 64-column boxes in the
    // 128-byte swizzle, int8 whole rows as they are.
    const int es = I8 ? 1 : 2;
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)p.page,
                                (cuuint64_t)p.P,
                                (cuuint64_t)p.L * p.KVH};
    const cuuint64_t strides[3] = {(cuuint64_t)D * es,
                                   (cuuint64_t)p.page * D * es,
                                   (cuuint64_t)p.P * p.page * D * es};
    const cuuint32_t box[4] = {I8 ? (cuuint32_t)D : 64u,
                               (cuuint32_t)(p.page < KB ? p.page : KB), 1, 1};
    const CUtensorMapDataType type = I8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const CUtensorMapSwizzle swizzle =
        I8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B;
    err = hp::encode_map(&kp, type, 4, p.k_pools, dims, strides, box,
                         swizzle);
    if (!err)
      err = hp::encode_map(&vp, type, 4, p.v_pools, dims, strides, box,
                           swizzle);
  }
  if (err) return err;
  auto kernel = attention_hopper<TQ, TO, I8, D>;
  constexpr bool SPLIT_Q = std::is_same<TQ, float>::value;
  constexpr size_t smem =
      (SPLIT_Q ? 2 : 1) * 64 * D * 2 + STAGES * 2 * 64 * D * 2 + 1024;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, p.KVH, slots);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, kp, vp, kn, vn, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace ragged
}  // namespace rtt
