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
// dtype, 0 for a slot with no token.  Its own kernel, in one launch:
// see paged_decode_attention_hopper below.
#include <cooperative_groups.h>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

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

size_t partial_smem(int page, int D, int qpg) {
  return sizeof(float) * ((size_t)page * (D + 4) + (size_t)page * D +
                          (size_t)qpg * D + (size_t)qpg * page + 3 * qpg);
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


// K13 on Hopper: normalised paged decode attention in one launch.
//
// What bounds it on the H100: bytes, as K1 (4 * tokens * H * D flops
// against 4 * tokens * KVH * D bytes of bf16 k and v: 2 * qpg flops a
// byte).  At decode sizes the pages are a few MB, so what the design
// shortens is the chain of dependent steps of one call.
//
// The page axis of one (slot, kv head) splits over a thread-block
// cluster of up to 8 CTAs (the portable size), ppc pages each.  A rank
// whose pages all lie past the slot's live ones leaves at once (a
// cluster barrier waits only for threads that have not exited, and no
// rank touches its shared memory); rank 0 of a slot with no token
// writes its zeros.  Each (kv head, page id) k or v page is one
// contiguous [page, D] block, so a 1-D cp.async.bulk copies it whole
// into shared memory, in the pages' dtype, completing on an mbarrier;
// one thread a copy issues them, all at once.  The copies run through a
// ring of n_stages page buffers: the CTA's k pages, then its v pages,
// all in flight when they fit the wrapper's budget, else each stage
// refilled as soon as its page is read.
//
// The rounding points are the Pallas body's (s, m, l and acc in f32; p
// rounded to the pages' dtype before p.v), and every f32 value up to the
// rounded p is one the plain version reproduces bit for bit:
//  1. scores: warps split a page's tokens, lanes split D (EPL = 8
//     columns a lane).  The q.k dot is summed in a fixed order: each
//     lane's eight products left to right, then pairs of lanes l, l + n/2
//     for n = D/8, D/16, .., 2 (halving exchanges: about one shuffle a
//     result); products and sums rounded one at a time (__fmul_rn,
//     __fadd_rn; in bf16 the products are exact, so an fma is the same).
//     s = f32(dot) * scale, then the soft cap through tanh in f64 rounded
//     once; kept in shared memory for the CTA's tokens;
//  2. p against the power of two just above the rank's max: with
//     y = s log2(e) in f64 and M = ceil(max y), p = f32(2^(y - M))
//     (correctly rounded), l = sum p in f32, and p rounded to the pages'
//     dtype in place.  Rounding commutes with the power of two
//     2^(M - M_slot) that takes a rank's p to the slot's reference, so
//     each rank rounds p exactly as the plain version does at the slot's
//     M, with no barrier to agree on a max first;
//  3. p.v with warps splitting tokens (two at a time), lanes D, f32
//     accumulators reduced across lane groups by shuffles and across
//     warps in shared memory;
//  4. every live rank writes its (acc, l, M) into rank 0's shared memory
//     (after a cluster barrier arrived on at the start, so rank 0 has
//     started) and arrives on a second one; the others leave, and rank 0
//     waits, scales each rank's sums by 2^(M_rank - M) (exact), adds them
//     in rank order (deterministic), divides (l = 0 divides by 1) and
//     writes out in q's dtype.
// No global partials, no second kernel: the wrapper allocates only out.
namespace {
namespace k13 {

namespace cg = cooperative_groups;
namespace hp = rtt::hopper;
constexpr int THREADS = 128, NW = THREADS / 32;
constexpr int MAX_STAGES = 16, MAX_CLUSTER = 8;
constexpr int V = 32;    // partial dots a lane holds before the reduction
constexpr double LOG2E = 1.4426950408889634;
constexpr int EPL = 8;   // columns a lane takes of a row

// EPL consecutive elements as f32 (16-byte loads).
__device__ __forceinline__ void load_row(const float* p, float (&f)[EPL]) {
#pragma unroll
  for (int c = 0; c < EPL; c += 4) {
    const float4 v = rtt::load4(p + c);
    f[c] = v.x; f[c + 1] = v.y; f[c + 2] = v.z; f[c + 3] = v.w;
  }
}
__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                         float (&f)[EPL]) {
  static_assert(EPL % 8 == 0, "16-byte loads of bf16");
#pragma unroll
  for (int c = 0; c < EPL; c += 8) {
    float t[8];
    rtt::Vec<__nv_bfloat16>::load(p + c, t);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[c + i] = t[i];
  }
}

// (..(q0 k0 + q1 k1) + ..) + q_{EPL-1} k_{EPL-1}, each step rounded on
// its own.  A product of two bf16 values is exact in f32, so there an
// fma rounds the same sum.
template <typename T>
__device__ __forceinline__ float dot_row(const float (&a)[EPL],
                                         const float (&b)[EPL]) {
  float s = __fmul_rn(a[0], b[0]);
#pragma unroll
  for (int i = 1; i < EPL; ++i) {
    if constexpr (std::is_same<T, float>::value)
      s = __fadd_rn(s, __fmul_rn(a[i], b[i]));
    else
      s = __fmaf_rn(a[i], b[i], s);
  }
  return s;
}

// One halving exchange over lane offset O, then the next (template
// recursion, so every index is a constant and v stays in registers): a
// lane keeps one half of its values (by its lane bit O) and adds the
// partner's copy of that half, sending the other.
template <int HALF, int O>
__device__ __forceinline__ void halve(float (&v)[V], int lane, int& base) {
  if constexpr (O > 0) {
    const bool up = (lane & O) != 0;
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      const float send = up ? v[i] : v[i + HALF];
      const float keep = up ? v[i + HALF] : v[i];
      v[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, O));
    }
    if (up) base += HALF;
    halve<HALF / 2, O / 2>(v, lane, base);
  }
}

// Shared bytes: the ring (later the cross-warp sums [NW][qpg][D] f32),
// the scores [qpg][ppc * page] f32 and the ranks' sums [csize][qpg][D]
// f32 (read in rank 0).
__host__ __device__ __forceinline__ size_t ring_bytes(size_t stage_bytes,
                                                      int n_stages,
                                                      int qpg_d) {
  const size_t ring = stage_bytes * n_stages, red = 4 * (size_t)NW * qpg_d;
  return ring > red ? ring : red;
}
size_t smem_bytes(int esize, int page, int D, int qpg, int ppc,
                  int n_stages, int csize) {
  return ring_bytes((size_t)page * D * esize, n_stages, qpg * D) +
         4 * ((size_t)qpg * ppc * page + (size_t)csize * qpg * D);
}

template <typename T, int QPG, int D>
__global__ void __launch_bounds__(THREADS) paged_decode_attention_hopper(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ block_table,
    const int* __restrict__ lengths, T* __restrict__ out, int P, int page,
    int maxp, int ppc, int n_stages, float scale, float soft_cap) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(128) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[MAX_STAGES];
  __shared__ double m_loc[QPG], m_tot[QPG], m_all[MAX_CLUSTER][QPG];
  __shared__ float l_loc[QPG], l_all[MAX_CLUSTER][QPG];
  __shared__ float scl[MAX_CLUSTER][QPG];

  const int rank = blockIdx.x;
  const int g = blockIdx.y, b = blockIdx.z, KVH = gridDim.y;
  const int H = KVH * QPG;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  constexpr int LPT = D / EPL;  // lanes a token's row is split over
  constexpr int GPW = 32 / LPT;
  const int grp = lane / LPT, li = lane % LPT;
  constexpr int TB = V / QPG;  // tokens of one lane group a pass
  static_assert(V >= LPT && LPT <= 32, "a lane keeps whole sums");

  const int len = lengths[b];
  const int n_live = min((len + page - 1) / page, maxp);
  const int n_ranks = (n_live + ppc - 1) / ppc;  // ranks with live pages
  T* orow = out + ((size_t)b * H + g * QPG) * D;
  if (rank >= n_ranks) {
    if (rank == 0)
      for (int e = tid; e < QPG * D; e += THREADS)
        orow[e] = rtt::from_float<T>(0.f);
    return;
  }
  // Arrive on the barrier that rank 0 waits for before the other ranks
  // write into its shared memory.
  hp::cluster_arrive_relaxed();
  const int j0 = rank * ppc;
  const int n_my = min(ppc, n_live - j0);
  const int n_tok = min(len - j0 * page, n_my * page);
  const int n_load = 2 * n_my;

  const size_t stage_elems = (size_t)page * D;
  const uint32_t stage_bytes = (uint32_t)(stage_elems * sizeof(T));
  const T* ring = reinterpret_cast<const T*>(smem_raw);
  const int ctok = ppc * page;
  float* sc = reinterpret_cast<float*>(
      smem_raw + ring_bytes(stage_bytes, n_stages, QPG * D));
  float* acc_all = sc + QPG * ctok;  // [csize][QPG][D], rank 0's read
  const int* bt = block_table + (size_t)b * maxp + j0;
  const size_t head_off = (size_t)g * P * stage_elems;
  const uint32_t ring_u32 = hp::smem_u32(smem_raw);
  const uint32_t bar0 = hp::smem_u32(bars);

  // Load i: the CTA's k pages, then its v pages, into stage i % n_stages.
  auto issue = [&](int i) {
    const int j = i < n_my ? i : i - n_my;
    const int pid = min(max(bt[j], 0), P - 1);
    const T* src = (i < n_my ? k_pages : v_pages) + head_off +
                   (size_t)pid * stage_elems;
    const int s = i % n_stages;
    hp::mbar_expect_tx(bar0 + 8 * s, stage_bytes);
    hp::bulk_load(ring_u32 + s * stage_bytes, src, stage_bytes, bar0 + 8 * s);
  };
  auto wait = [&](int i) {
    hp::mbar_wait(bar0 + 8 * (i % n_stages), (i / n_stages) & 1);
  };
  // Load i has been consumed: its stage takes load i + n_stages.
  auto refill = [&](int i) {
    if (i + n_stages < n_load) {
      __syncthreads();
      if (tid == 0) issue(i + n_stages);
    }
  };

  if (tid < n_stages) {
    hp::mbar_init(bar0 + 8 * tid, 1);
    hp::fence_barrier_init();
  }
  __syncthreads();
  if (tid < min(n_load, n_stages)) issue(tid);
  // This lane's EPL columns of the group's q rows.
  float qf[QPG][EPL];
#pragma unroll
  for (int qi = 0; qi < QPG; ++qi)
    load_row(q + ((size_t)b * H + g * QPG + qi) * D + EPL * li, qf[qi]);

  // 1. Scores of the CTA's tokens.  A warp pass covers TB * GPW tokens:
  // token t0 + GPW * tb + grp for lane group grp.
  const int tpw = TB * GPW;
  for (int j = 0; j < n_my; ++j) {
    wait(j);
    const T* kp = ring + (size_t)(j % n_stages) * stage_elems;
    const int t_end = min(page, n_tok - j * page);
    for (int t0 = warp * tpw; t0 < t_end; t0 += NW * tpw) {
      // Every row first (rows past the page's valid tokens read stale
      // data of the stage; their sums are never written), then the dots.
      float f[TB][EPL], v[V];
#pragma unroll
      for (int tb = 0; tb < TB; ++tb) {
        const int t = min(t0 + GPW * tb + grp, page - 1);
        load_row(kp + (size_t)t * D + EPL * li, f[tb]);
      }
#pragma unroll
      for (int tb = 0; tb < TB; ++tb)
#pragma unroll
        for (int qi = 0; qi < QPG; ++qi)
          v[tb * QPG + qi] = dot_row<T>(qf[qi], f[tb]);
      // After the log2(LPT) halving exchanges over the group's lanes,
      // lane li holds the full sums of values base .. base + V/LPT - 1.
      int base = 0;
      halve<V / 2, LPT / 2>(v, lane, base);
#pragma unroll
      for (int i = 0; i < V / LPT; ++i) {
        const int idx = base + i, tb = idx / QPG, qi = idx % QPG;
        const int t = t0 + GPW * tb + grp;
        if (t < t_end) {
          float s = __fmul_rn(v[i], scale);
          if (soft_cap > 0.f)
            s = __fmul_rn(soft_cap, __double2float_rn(tanh(
                                        (double)__fdiv_rn(s, soft_cap))));
          sc[qi * ctok + j * page + t] = s;
        }
      }
    }
    refill(j);
  }
  // 2. This rank's reference M = ceil(max y), y = s log2(e) in f64; then
  // p = f32(2^(y - M)) (correctly rounded), l = sum p in f32, and p
  // rounded to the pages' dtype in place.  Rounding commutes with the
  // power of two 2^(M - M_slot) that takes p to the slot's reference, so
  // every rank rounds p as the plain version does at the slot's.
  __syncthreads();
  for (int qi = warp; qi < QPG; qi += NW) {
    float mx = rtt::NEG_INF;
    for (int t = lane; t < n_tok; t += 32) mx = fmaxf(mx, sc[qi * ctok + t]);
    mx = rtt::group_max<32>(mx);
    const double m_ref = ceil((double)mx * LOG2E);
    float l = 0.f;
    for (int t = lane; t < n_tok; t += 32) {
      float* ps = sc + qi * ctok + t;
      const float p = __double2float_rn(exp2((double)*ps * LOG2E - m_ref));
      l += p;
      *ps = rtt::to_float(rtt::from_float<T>(p));
    }
    l = rtt::group_sum<32>(l);
    if (lane == 0) {
      l_loc[qi] = l;
      m_loc[qi] = m_ref;
    }
  }
  __syncthreads();

  float acc[QPG][EPL];
#pragma unroll
  for (int qi = 0; qi < QPG; ++qi)
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[qi][e] = 0.f;
  const int step = NW * GPW;  // tokens between a lane group's turns
  for (int j = 0; j < n_my; ++j) {
    const int i = n_my + j;
    wait(i);
    const T* vp = ring + (size_t)(i % n_stages) * stage_elems;
    const int t_end = min(page, n_tok - j * page);
    const float* pj = sc + j * page;
    int t = warp * GPW + grp;
    for (; t + step < t_end; t += 2 * step) {
      float f[2][EPL];
#pragma unroll
      for (int u = 0; u < 2; ++u)
        load_row(vp + (size_t)(t + u * step) * D + EPL * li, f[u]);
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int qi = 0; qi < QPG; ++qi) {
          const float p = pj[qi * ctok + t + u * step];
#pragma unroll
          for (int e = 0; e < EPL; ++e)
            acc[qi][e] = fmaf(p, f[u][e], acc[qi][e]);
        }
    }
    if (t < t_end) {
      float f[EPL];
      load_row(vp + (size_t)t * D + EPL * li, f);
#pragma unroll
      for (int qi = 0; qi < QPG; ++qi) {
        const float p = pj[qi * ctok + t];
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[qi][e] = fmaf(p, f[e], acc[qi][e]);
      }
    }
    refill(i);
  }
  // Across the warp's lane groups, then across warps (in the ring, whose
  // copies have all landed and been read).
#pragma unroll
  for (int qi = 0; qi < QPG; ++qi)
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      for (int o = LPT; o < 32; o <<= 1)
        acc[qi][e] += __shfl_xor_sync(0xffffffffu, acc[qi][e], o);
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem_raw);  // [NW][QPG][D]
  if (grp == 0)
#pragma unroll
    for (int qi = 0; qi < QPG; ++qi)
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        red[(warp * QPG + qi) * D + EPL * li + e] = acc[qi][e];
  __syncthreads();

  // 3. Every live rank's (acc, l, M) into rank 0's shared memory, once
  // every CTA of the cluster has started; then rank 0 merges.
  const int n_el = QPG * D;
  hp::cluster_wait();
  float* acc0 = cluster.map_shared_rank(acc_all, 0) + rank * n_el;
  for (int e = tid; e < n_el; e += THREADS) {
    float a = red[e];
    for (int w = 1; w < NW; ++w) a += red[w * n_el + e];
    acc0[e] = a;
  }
  if (tid < QPG) {
    cluster.map_shared_rank(&l_all[0][0], 0)[rank * QPG + tid] = l_loc[tid];
    cluster.map_shared_rank(&m_all[0][0], 0)[rank * QPG + tid] = m_loc[tid];
  }
  hp::cluster_arrive();
  if (rank != 0) return;
  hp::cluster_wait();

  // 4. acc / l at the slot's reference: each rank's sums scaled by
  // 2^(M_rank - M), exactly (so an fma rounds as the sum of the scaled
  // term), summed in rank order (deterministic).
  if (tid < QPG) {
    double m = m_all[0][tid];
    for (int r = 1; r < n_ranks; ++r) m = fmax(m, m_all[r][tid]);
    m_tot[tid] = m;
  }
  __syncthreads();
  if (tid < n_ranks * QPG) {
    // 2^(M_rank - M) as a float (0 below 2^-126, where the terms are far
    // below an f32 ulp of the sum).
    const int r = tid / QPG, qi = tid % QPG;
    const double sh = m_all[r][qi] - m_tot[qi];
    scl[r][qi] = sh < -126.0 ? 0.f : __int_as_float(((int)sh + 127) << 23);
  }
  __syncthreads();
  for (int e = tid; e < n_el; e += THREADS) {
    const int qi = e / D;
    float a = 0.f, l = 0.f;
    for (int r = 0; r < n_ranks; ++r) {
      a = __fmaf_rn(acc_all[r * n_el + e], scl[r][qi], a);
      l = __fmaf_rn(l_all[r][qi], scl[r][qi], l);
    }
    orow[e] = rtt::from_float<T>(__fdiv_rn(a, l == 0.f ? 1.f : l));
  }
}

template <typename T, int QPG, int D>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* block_table, const void* lengths, void* out, int B,
           int KVH, int P, int page, int qpg, int maxp, int csize, int ppc,
           int n_stages, float scale, float soft_cap, cudaStream_t stream) {
  auto kernel = paged_decode_attention_hopper<T, QPG, D>;
  const size_t smem =
      smem_bytes((int)sizeof(T), page, D, qpg, ppc, n_stages, csize);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize, KVH, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(block_table),
      static_cast<const int*>(lengths), static_cast<T*>(out), P, page, maxp,
      ppc, n_stages, scale, soft_cap);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, int QPG>
int dispatch_d(const void* q, const void* k_pages, const void* v_pages,
               const void* block_table, const void* lengths, void* out, int B,
               int KVH, int P, int page, int D, int maxp, int csize, int ppc,
               int n_stages, float scale, float soft_cap, cudaStream_t s) {
#define RTT_K13_LAUNCH(DD)                                                  \
  launch<T, QPG, DD>(q, k_pages, v_pages, block_table, lengths, out, B, KVH, \
                     P, page, QPG, maxp, csize, ppc, n_stages, scale,       \
                     soft_cap, s)
  switch (D) {
    case 16: return RTT_K13_LAUNCH(16);
    case 64: return RTT_K13_LAUNCH(64);
    case 128: return RTT_K13_LAUNCH(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef RTT_K13_LAUNCH
}

template <typename T>
int dispatch_qpg(const void* q, const void* k_pages, const void* v_pages,
                 const void* block_table, const void* lengths, void* out,
                 int B, int KVH, int P, int page, int D, int qpg, int maxp,
                 int csize, int ppc, int n_stages, float scale,
                 float soft_cap, cudaStream_t s) {
#define RTT_K13_LAUNCH(QPG)                                                 \
  dispatch_d<T, QPG>(q, k_pages, v_pages, block_table, lengths, out, B, KVH, \
                     P, page, D, maxp, csize, ppc, n_stages, scale,         \
                     soft_cap, s)
  switch (qpg) {
    case 1: return RTT_K13_LAUNCH(1);
    case 2: return RTT_K13_LAUNCH(2);
    case 4: return RTT_K13_LAUNCH(4);
    case 8: return RTT_K13_LAUNCH(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef RTT_K13_LAUNCH
}

}  // namespace k13

}  // namespace

// K13.  dtype (of q and the pages): 0 = float32, 1 = bfloat16.  The
// pages are one layer's [KVH, P, page, D]; out is [B, H, D] in q's
// dtype.  qpg in {1, 2, 4, 8}, D in {16, 64, 128}; the grid is csize
// CTAs (one cluster, csize <= 8, csize * ppc >= maxp) per (kv head,
// slot), ppc pages each, through a ring of n_stages (<= 16) page
// buffers.  soft_cap <= 0 means none.
extern "C" int rtt_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_table, const void* lengths, void* out, int dtype,
    int B, int KVH, int P, int page, int D, int qpg, int maxp, int csize,
    int ppc, int n_stages, float scale, float soft_cap, void* stream) {
  if (csize < 1 || csize > k13::MAX_CLUSTER || csize * ppc < maxp ||
      n_stages < 1 || n_stages > k13::MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return k13::dispatch_qpg<float>(q, k_pages, v_pages, block_table,
                                    lengths, out, B, KVH, P, page, D, qpg,
                                    maxp, csize, ppc, n_stages, scale,
                                    soft_cap, s);
  return k13::dispatch_qpg<__nv_bfloat16>(
      q, k_pages, v_pages, block_table, lengths, out, B, KVH, P, page, D,
      qpg, maxp, csize, ppc, n_stages, scale, soft_cap, s);
}
