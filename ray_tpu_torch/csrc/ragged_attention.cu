// K4 — ragged paged attention (bf16/f32 or int8 pools), one layer.
//
// Replaces ray_tpu/ops/ragged_paged_attention.py ragged_paged_attention
// (Pallas body _ragged_kernel, pallas_call at :379): bf16/f32 pools, and
// int8 pools with one f32 scale per physical page and kv head
// ([L, P, KVH, 1], page-major; true value = int8 * scale).
//
// A flat buffer of T tokens holds R rows (slot, start, len, off).  Token
// t < len of row r sits at position start + t of its slot and attends to
//   (a) the slot's pooled past: positions j < start, read through
//       block_tables[slot] (page ids clamped to P - 1), and
//   (b) the row's own fresh keys u <= t (k_new/v_new at off + u),
// with s = soft_cap(q . k * D^-0.5) and a softmax in f32.  Output is f32
// [T, H, D]; the wrapper zeroes it, so tokens no row covers stay zero.
//
// What bounds it on the H100: bytes for decode rows (each pooled k/v
// row read once per kv head, used by qpg query heads), operations for
// prefill chunks (a 256-token chunk row reuses each key 256 x qpg
// times).
//
// Two kernels.  bf16 q at D 64 and 128 (every real configuration) takes
// the Hopper kernel of ragged_attention.cuh: q tiles of 64 query rows on
// wgmma, pages by TMA (bf16) or converted from int8 in shared memory, a
// decode row's past split over a cluster and merged in rank order.  f32,
// and bf16 at D 16 and 32 or pages it cannot box, take the CUDA-core
// kernel below, in f32 on exactly converted inputs.
//
// CUDA-core design: one CTA per (row, kv head, q tile).  The TPU kernel's 8-aligned
// q window, its masked flash update (the window overlapped neighbour
// rows) and its sequential (R, maxp + 1) grid with state in VMEM have no
// counterpart: a CTA reads its own row's descriptor, takes a tile of the
// row's tokens (tokens x the qpg query heads of its kv head as the tile's
// rows, 64 rows; a row with at most 16 query rows takes a 16-row tile, so
// a decode row does a quarter of the work), and loops inside the block
// over the row's keys, 64 at a time: first the pooled past (pool phase),
// then the fresh keys up to the tile's last token (self phase, causal
// mask).  Each key block's k and v rows are staged in shared memory as
// f32 (k rows padded by 4 floats: conflict-free float4 reads); a thread
// owns RPT rows x 4 strided key columns of the score tile, so a row's 64
// scores live in the 16 lanes of one half-warp and the online softmax
// (m, l per row, in f32) reduces with shuffles; probabilities go through
// shared memory to the P.V product, where the same thread owns the same
// RPT rows x D/16 strided output columns in registers.
//
// int8 pools (QUANT): a staged key block may span several pages (its 64
// keys are indexed page by page), so the scales are carried PER KEY: the
// thread that stages a pooled key's first piece also stores the key's
// page scales beside the block.  The k scale multiplies the score after
// the q.k dot (before the soft cap and the mask); the v scale multiplies
// the probability on its way to the P.V product, while the row sum l
// takes the unscaled one.  Fresh keys (the self phase) are f32/bf16 and
// carry no scale.
#include "ragged_attention.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int KC = 64;               // keys per staged block
constexpr int CG = 16;               // threads sharing one row (a half-warp)
constexpr int RG = THREADS / CG;     // row groups
constexpr int MAX_ROWS = RG * 4;     // rows of the large tile

template <int D>
constexpr size_t smem_floats() {
  return (size_t)MAX_ROWS * (D + 4) + (size_t)KC * (D + 4) + (size_t)KC * D +
         (size_t)MAX_ROWS * (KC + 4) + 2 * KC;
}

struct Row {
  int slot, start, len, off;
};

struct Args {
  int H, KVH, P, page, maxp, layer;
  float scale, soft_cap;
};

// Stage one block of nk keys (zero rows up to KC) as f32: key kk's k and
// v rows come from src(kk), which returns their common element offset.
template <typename TS, int D, typename Src>
__device__ __forceinline__ void stage_block(float* k_s, float* v_s,
                                            const TS* __restrict__ kbase,
                                            const TS* __restrict__ vbase,
                                            int nk, Src src) {
  constexpr int KS = D + 4;
  constexpr int N = rtt::Vec<TS>::N;
  constexpr int CHUNKS = D / N;
  for (int i = threadIdx.x; i < KC * CHUNKS; i += THREADS) {
    const int kk = i / CHUNKS, c = (i % CHUNKS) * N;
    float tk[N], tv[N];
    if (kk < nk) {
      const size_t o = src(kk, c == 0);
      rtt::Vec<TS>::load(kbase + o + c, tk);
      rtt::Vec<TS>::load(vbase + o + c, tv);
    } else {
#pragma unroll
      for (int jj = 0; jj < N; ++jj) tk[jj] = tv[jj] = 0.f;
    }
#pragma unroll
    for (int jj = 0; jj < N; ++jj) {
      k_s[kk * KS + c + jj] = tk[jj];
      v_s[kk * D + c + jj] = tv[jj];
    }
  }
}

// One q tile: tokens [t0, t0 + ntok) of row `row`, kv head g.
template <typename T, typename TK, bool QUANT, int D, int RPT>
__device__ __forceinline__ void run_tile(
    float* smem, const T* __restrict__ q, const T* __restrict__ k_new,
    const T* __restrict__ v_new, const TK* __restrict__ k_pools,
    const TK* __restrict__ v_pools, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ block_tables,
    float* __restrict__ out, const Args& a, const Row& row, int g, int t0,
    int ntok) {
  constexpr int ROWS = RG * RPT;
  constexpr int QS = D + 4, KS = D + 4, PS = KC + 4;
  constexpr int DPT = D / CG;
  constexpr int N = rtt::Vec<T>::N;
  constexpr int CHUNKS = D / N;
  float* q_s = smem;                 // [ROWS][QS]
  float* k_s = q_s + ROWS * QS;      // [KC][KS]
  float* v_s = k_s + KC * KS;        // [KC][D]
  float* p_s = v_s + KC * D;         // [ROWS][PS]
  float* ks_s = p_s + ROWS * PS;     // [KC] k scale of each pooled key
  float* vs_s = ks_s + KC;           // [KC] v scale
  const int tid = threadIdx.x, rg = tid / CG, cg = tid % CG;
  const int qpg = a.H / a.KVH;
  const int nrows = ntok * qpg;

  // Stage the tile's queries: row i = token i / qpg, head i % qpg.
  for (int i = tid; i < ROWS * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * N;
    float tmp[N];
    if (r < nrows) {
      const int tok = row.off + t0 + r / qpg;
      rtt::Vec<T>::load(
          q + ((size_t)tok * a.H + (size_t)g * qpg + r % qpg) * D + c, tmp);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) tmp[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < N; ++j) q_s[r * QS + c + j] = tmp[j];
  }

  float m[RPT], l[RPT], acc[RPT][DPT];
  int tok_of[RPT];  // row-relative token of each owned row (-1: none)
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = rtt::NEG_INF;
    l[i] = 0.f;
    const int r = rg * RPT + i;
    tok_of[i] = r < nrows ? t0 + r / qpg : -1;
#pragma unroll
    for (int k = 0; k < DPT; ++k) acc[i][k] = 0.f;
  }

  const size_t page_elems = (size_t)a.page * D;
  const size_t head_off =
      ((size_t)a.layer * a.KVH + g) * (size_t)a.P * page_elems;
  const int* bt_row = block_tables + (size_t)row.slot * a.maxp;
  const int n_pool = min(row.start, a.maxp * a.page);
  const int n_self = t0 + ntok;  // fresh keys up to the tile's last token

  // Phase 0 walks the pooled past, phase 1 the row's fresh keys.
  for (int phase = 0; phase < 2; ++phase) {
    const int nkeys = phase == 0 ? n_pool : n_self;
    for (int kb = 0; kb < nkeys; kb += KC) {
      const int nk = min(KC, nkeys - kb);
      __syncthreads();  // the previous block's readers are done
      if (phase == 0) {
        stage_block<TK, D>(
            k_s, v_s, k_pools, v_pools, nk, [&](int kk, bool first) {
              const int j = kb + kk;
              int pid = bt_row[j / a.page];
              pid = min(max(pid, 0), a.P - 1);
              if (QUANT && first) {
                const size_t so = ((size_t)a.layer * a.P + pid) * a.KVH + g;
                ks_s[kk] = k_scales[so];
                vs_s[kk] = v_scales[so];
              }
              return head_off + (size_t)pid * page_elems +
                     (size_t)(j % a.page) * D;
            });
      } else {
        stage_block<T, D>(k_s, v_s, k_new, v_new, nk, [&](int kk, bool) {
          return ((size_t)(row.off + kb + kk) * a.KVH + g) * D;
        });
      }
      __syncthreads();
      const bool scaled = QUANT && phase == 0;

      // Scores of the thread's RPT rows x key columns cg + 16 j.
      float s[RPT][4];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        float4 qv[RPT], kv[4];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
          qv[i] = *reinterpret_cast<const float4*>(
              q_s + (rg * RPT + i) * QS + d);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kv[j] = *reinterpret_cast<const float4*>(k_s + (cg + CG * j) * KS +
                                                   d);
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            s[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y +
                       qv[i].z * kv[j].z + qv[i].w * kv[j].w;
      }

      // Mask, scale, cap; online softmax over the half-warp of each row.
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = rg * RPT + i;
        float mx = rtt::NEG_INF;
        bool valid[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = cg + CG * j;
          valid[j] = tok_of[i] >= 0 && col < nk &&
                     (phase == 0 || kb + col <= tok_of[i]);
          float x = s[i][j] * a.scale;
          if (scaled) x = x * ks_s[col < nk ? col : 0];
          if (a.soft_cap > 0.f) x = a.soft_cap * tanhf(x / a.soft_cap);
          s[i][j] = x;
          if (valid[j]) mx = fmaxf(mx, x);
        }
        mx = rtt::group_max<CG>(mx);
        const float m_new = fmaxf(m[i], mx);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
          const int col = cg + CG * j;
          p_s[r * PS + col] = scaled && col < nk ? p * vs_s[col] : p;
          sum += p;
        }
        sum = rtt::group_sum<CG>(sum);
        const float corr = expf(m[i] - m_new);
        l[i] = l[i] * corr + sum;
        m[i] = m_new;
#pragma unroll
        for (int k = 0; k < DPT; ++k) acc[i][k] *= corr;
      }
      __syncthreads();

      // acc[i][k] += sum_c p[row i][c] * v[c][cg + 16 k].
      for (int c = 0; c < nk; ++c) {
        float pv[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) pv[i] = p_s[(rg * RPT + i) * PS + c];
#pragma unroll
        for (int k = 0; k < DPT; ++k) {
          const float v = v_s[c * D + cg + CG * k];
#pragma unroll
          for (int i = 0; i < RPT; ++i) acc[i][k] += pv[i] * v;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg * RPT + i;
    if (r >= nrows) continue;
    const int tok = row.off + t0 + r / qpg;
    float* o = out + ((size_t)tok * a.H + (size_t)g * qpg + r % qpg) * D;
    const float inv = 1.f / l[i];  // l >= 1: the token's own key counts
#pragma unroll
    for (int k = 0; k < DPT; ++k) o[cg + CG * k] = acc[i][k] * inv;
  }
}

template <typename T, typename TK, bool QUANT, int D>
__global__ void __launch_bounds__(THREADS) ragged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_new,
    const T* __restrict__ v_new, const TK* __restrict__ k_pools,
    const TK* __restrict__ v_pools, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ row_slot,
    const int* __restrict__ row_start, const int* __restrict__ row_len,
    const int* __restrict__ row_off, const int* __restrict__ block_tables,
    float* __restrict__ out, Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int r = blockIdx.x, g = blockIdx.y, tile = blockIdx.z;
  const Row row{row_slot[r], row_start[r], row_len[r], row_off[r]};
  if (row.len <= 0) return;  // padding row
  const int qpg = a.H / a.KVH;
  if (row.len * qpg <= RG) {  // a decode row or a short chunk: one 16-row tile
    if (tile == 0)
      run_tile<T, TK, QUANT, D, 1>(smem, q, k_new, v_new, k_pools, v_pools,
                                   k_scales, v_scales, block_tables, out, a,
                                   row, g, 0, row.len);
    return;
  }
  const int per_tile = MAX_ROWS / qpg;
  const int t0 = tile * per_tile;
  if (t0 >= row.len) return;
  run_tile<T, TK, QUANT, D, 4>(smem, q, k_new, v_new, k_pools, v_pools,
                               k_scales, v_scales, block_tables, out, a, row,
                               g, t0, min(per_tile, row.len - t0));
}

struct Ptrs {
  const void *q, *k_new, *v_new, *k_pools, *v_pools, *k_scales, *v_scales,
      *row_slot, *row_start, *row_len, *row_off, *block_tables;
  float* out;
};

template <typename T, typename TK, bool QUANT, int D>
int launch(const Ptrs& p, const Args& a, int R, int n_tiles,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(
      ragged_attention_kernel<T, TK, QUANT, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ragged_attention_kernel<T, TK, QUANT, D>
      <<<dim3(R, a.KVH, n_tiles), THREADS, smem, stream>>>(
          static_cast<const T*>(p.q), static_cast<const T*>(p.k_new),
          static_cast<const T*>(p.v_new), static_cast<const TK*>(p.k_pools),
          static_cast<const TK*>(p.v_pools),
          static_cast<const float*>(p.k_scales),
          static_cast<const float*>(p.v_scales),
          static_cast<const int*>(p.row_slot),
          static_cast<const int*>(p.row_start),
          static_cast<const int*>(p.row_len),
          static_cast<const int*>(p.row_off),
          static_cast<const int*>(p.block_tables), p.out, a);
  return (int)cudaGetLastError();
}

template <typename T, typename TK, bool QUANT>
int dispatch_d(int D, const Ptrs& p, const Args& a, int R, int n_tiles,
               cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<T, TK, QUANT, 16>(p, a, R, n_tiles, s);
    case 32:
      return launch<T, TK, QUANT, 32>(p, a, R, n_tiles, s);
    case 64:
      return launch<T, TK, QUANT, 64>(p, a, R, n_tiles, s);
    case 128:
      return launch<T, TK, QUANT, 128>(p, a, R, n_tiles, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (of q and the fresh k/v): 0 = float32, 1 = bfloat16.  The pools
// have that dtype when k_scales is null, and are int8 with f32 scales
// [L, P, KVH, 1] when it is not.  soft_cap <= 0 means none.  out is f32
// [T, H, D], zeroed by the caller.  cluster > 0 takes the Hopper kernel
// (bf16, D 64 or 128) with that cluster size and n_tiles q-tile slots;
// cluster 0 the CUDA-core kernel with n_tiles = ceil(T / (64 / qpg)).
extern "C" int rtt_ragged_attention(
    const void* q, const void* k_new, const void* v_new, const void* k_pools,
    const void* v_pools, const void* k_scales, const void* v_scales,
    const void* row_slot, const void* row_start, const void* row_len,
    const void* row_off, const void* block_tables, void* out, int dtype,
    int H, int KVH, int P, int page, int D, int maxp, int R, int n_tiles,
    int layer, float scale, float soft_cap, int L, int T, int cluster,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster > 0) {
    if (dtype != 1 || (D != 64 && D != 128)) return (int)cudaErrorInvalidValue;
    const rtt::ragged::Params p{
        q, (long long)H * D, k_pools, v_pools,
        static_cast<const float*>(k_scales),
        static_cast<const float*>(v_scales),
        static_cast<const int*>(row_slot), static_cast<const int*>(row_start),
        static_cast<const int*>(row_len), static_cast<const int*>(row_off),
        static_cast<const int*>(block_tables), out, (long long)H * D, T, R, H,
        KVH, L, P, page, maxp, layer, scale, soft_cap};
    using bf = __nv_bfloat16;
    namespace rg = rtt::ragged;
    if (k_scales != nullptr)
      return D == 64 ? rg::launch_hopper<bf, float, true, 64>(
                           p, k_new, v_new, cluster, n_tiles, s)
                     : rg::launch_hopper<bf, float, true, 128>(
                           p, k_new, v_new, cluster, n_tiles, s);
    return D == 64 ? rg::launch_hopper<bf, float, false, 64>(
                         p, k_new, v_new, cluster, n_tiles, s)
                   : rg::launch_hopper<bf, float, false, 128>(
                         p, k_new, v_new, cluster, n_tiles, s);
  }
  const Args a{H, KVH, P, page, maxp, layer, scale, soft_cap};
  const Ptrs p{q,        k_new,   v_new,     k_pools, v_pools,
               k_scales, v_scales, row_slot, row_start, row_len,
               row_off,  block_tables, static_cast<float*>(out)};
  if (k_scales != nullptr)
    return dtype == 0
               ? dispatch_d<float, int8_t, true>(D, p, a, R, n_tiles, s)
               : dispatch_d<__nv_bfloat16, int8_t, true>(D, p, a, R, n_tiles,
                                                         s);
  return dtype == 0
             ? dispatch_d<float, float, false>(D, p, a, R, n_tiles, s)
             : dispatch_d<__nv_bfloat16, __nv_bfloat16, false>(D, p, a, R,
                                                               n_tiles, s);
}
