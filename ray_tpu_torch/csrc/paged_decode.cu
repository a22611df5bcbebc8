// K1 — paged decode attention partials (one q token per slot), and
// K13 — normalised paged decode attention over one layer's pages.
//
// K1 replaces ray_tpu/ops/paged_attention.py paged_decode_attention_partial
// (Pallas body _kernel_partial, pallas_call at :347): bf16/f32 pools, and
// int8 pools with one f32 scale per physical page and kv head
// ([L, P, KVH, 1], page-major; true value = int8 * scale).  For slot b and
// query head h against the PAST tokens of the layered pool
// [L, KVH, P, page, D] (block table [B, maxp], lengths [B]) it returns the
// state of the Pallas body's online softmax after its walk over the slot's
// pages in order.  Per page: s = soft_cap(q.k * D^-0.5, times the page's k
// scale on int8 pools), masked past the slot's length; m_new = max(m, page
// max); p = exp(s - m_new); corr = exp(m - m_new); l = corr * l + sum p
// (p unrounded); acc = corr * acc + round(p) . v (times the page's v scale
// on int8 pools), p rounded to q's dtype.  acc, m and l are f32 and
// unnormalised; the caller folds in the current token (combine_with_self)
// and normalises.  A slot with no token gives acc 0, m -1e30, l 0.
//
// K13 replaces paged_decode_attention (Pallas body _kernel, pallas_call at
// :157): q [B, H, D] against one layer's bf16/f32 pages [KVH, P, page, D],
// lengths counting every token (the current one included), out =
// sum p v / sum p in q's dtype, 0 for a slot with no token.
//
// What bounds both on the H100: bytes.  Each live k/v row is read once per
// kv-head group and used by qpg = H/KVH query rows, about 2 * qpg flops a
// byte, far below the ~295 flop/byte ridge.  At decode sizes the pages are
// a few MB, so what the designs shorten is the chain of dependent steps of
// one call.
//
// Two routes, chosen by shape in the wrappers (ops/paged_attention.py):
//  - paged_decode_hopper (K1 and K13): D in {16, 32, 64, 128}, qpg <= 8,
//    one launch, a thread-block cluster per (slot, kv head), whole pages by
//    bulk copy (below);
//  - page_walk_kernel (K1 and K13 on every shape the Hopper route does not
//    take: any qpg, any D up to 256, pages beyond the Hopper plan's shared
//    memory): one CTA per (slot, kv head, block of query rows) walking the
//    slot's pages in order, each staged in f32 shared memory (below).
// Both sum q.k in one fixed order and take exp and the soft cap's tanh in
// f64, rounded once to f32, as the plain versions do (_fixed_order_dot): so
// every f32 value up to p is the plain version's, and p rounds the same.
#include <cooperative_groups.h>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int EPL = 8;  // columns of one partial sum of q.k

__device__ __forceinline__ float soft_cap_f(float s, float cap) {
  return __fmul_rn(cap, __double2float_rn(tanh((double)__fdiv_rn(s, cap))));
}

__device__ __forceinline__ float exp_f(float a, float b) {  // f32(e^(a-b))
  return __double2float_rn(exp((double)a - (double)b));
}

// ---------------------------------------------------------------------------
// The page-walk route: K1 and K13 on every shape the Hopper route refuses
// ---------------------------------------------------------------------------
//
// One CTA per (slot, kv head, block of the group's query rows) walks the
// slot's pages in order, as the Pallas body's grid does.  A block holds
// `rows` <= floor(1024 / D) rows (the wrapper's walk_plan), so a group of
// any size splits over the grid's third dimension and each block walks the
// pages itself.  Per page: k and v are staged in f32 shared memory (16-byte
// loads where a row's bytes are a multiple of 16, element loads otherwise:
// the rows are then not 16-byte aligned), q and k zero-padded to Dp, a
// multiple of EPL, so that dot_fixed sums in _fixed_order_dot's order; where
// k and v of a page do not fit together, k is staged, read, and v staged
// into the same buffer after it.  Then the page's scores, its max and p
// (one warp a row), and p.v (each thread up to MAX_E (row, column)
// accumulators).  K1 (PARTIAL) takes the Pallas body's running max m and
// writes (acc, m, l).  K13 takes p against a running power of two M, the
// ceiling of the walk's max of y = s log2(e), raised page by page: the
// sums so far are scaled by 2^(M_old - M_new), exactly, so p rounds as the
// plain version's p at the slot's final M; out = acc / l in q's dtype.
constexpr int THREADS = 256;
constexpr int MAX_E = 4;    // accumulators per thread: rows * D <= 1024
constexpr int MAX_D = 256;  // the walk's widest head
constexpr int MAX_PARTS = MAX_D / EPL;
constexpr double LOG2E = 1.4426950408889634;

// q.k over Dp (a multiple of EPL) in the fixed order: each EPL columns left
// to right, then pairs i, i + h of the n partial sums, h = n / 2, an odd
// one carried, until one is left.
__device__ float dot_fixed(const float* a, const float* b, int Dp) {
  float part[MAX_PARTS];
  int n = Dp / EPL;
  for (int c = 0; c < n; ++c) {
    const float* x = a + c * EPL;
    const float* y = b + c * EPL;
    float s = __fmul_rn(x[0], y[0]);
#pragma unroll
    for (int i = 1; i < EPL; ++i) s = __fadd_rn(s, __fmul_rn(x[i], y[i]));
    part[c] = s;
  }
  while (n > 1) {
    const int h = n / 2;
    for (int i = 0; i < h; ++i) part[i] = __fadd_rn(part[i], part[i + h]);
    if (n & 1) part[h] = part[2 * h];
    n -= h;
  }
  return part[0];
}

// 2^sh for an integer sh <= 0 as a float, exact; 0 below 2^-126, where a
// term is far below an f32 ulp of the sums it joins.
__device__ __forceinline__ float pow2_le0(float sh) {
  return sh < -126.f ? 0.f : __int_as_float(((int)sh + 127) << 23);
}

__device__ __forceinline__ float elem_f(float x) { return x; }
__device__ __forceinline__ float elem_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float elem_f(int8_t x) { return (float)x; }

struct WalkParams {
  const void* q;
  const void* k;  // K1: pools [L, KVH, P, page, D]; K13: [KVH, P, page, D]
  const void* v;
  const float* k_scales;  // int8 pools: [L, P, KVH, 1]
  const float* v_scales;
  const int* block_table;
  const int* lengths;
  void* out;   // K13: [B, H, D] in q's dtype
  float* acc;  // K1: [B, H, D], m and l [B, H]
  float* m;
  float* l;
  int P, page, D, qpg, maxp, layer, rows, split, vec;
  float scale, soft_cap;
};

__host__ __device__ __forceinline__ int padded_d(int D) {
  return (D + EPL - 1) / EPL * EPL;
}

// Shared floats: k [page][Dp + 4] (v [page][D] beside it unless split),
// q [rows][Dp], scores [rows][page], running max, denominator, correction.
size_t page_walk_smem(int page, int D, int rows, bool split) {
  const int Dp = padded_d(D);
  return sizeof(float) *
         ((size_t)page * (Dp + 4) + (split ? 0 : (size_t)page * D) +
          (size_t)rows * Dp + (size_t)rows * page + 3 * (size_t)rows);
}

// n rows of a page, D elements each, into dst at row stride `stride`.
template <typename TK>
__device__ __forceinline__ void stage(float* dst, int stride, const TK* src,
                                      int n, int D, bool vec) {
  if (vec) {
    constexpr int N = rtt::Vec<TK>::N;
    const int chunks = D / N;
    for (int i = threadIdx.x; i < n * chunks; i += THREADS) {
      const int t = i / chunks, c = (i % chunks) * N;
      float tmp[N];
      rtt::Vec<TK>::load(src + (size_t)t * D + c, tmp);
#pragma unroll
      for (int j = 0; j < N; ++j) dst[t * stride + c + j] = tmp[j];
    }
  } else {
    for (int i = threadIdx.x; i < n * D; i += THREADS)
      dst[(i / D) * stride + i % D] = elem_f(src[i]);
  }
}

template <typename T, typename TK, bool QUANT, bool PARTIAL>
__global__ void __launch_bounds__(THREADS) page_walk_kernel(
    const WalkParams pr) {
  static_assert(PARTIAL || !QUANT, "K13 takes no int8 pages");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.x, g = blockIdx.y, KVH = gridDim.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int D = pr.D, Dp = padded_d(D), page = pr.page, rows = pr.rows;
  const int r0 = blockIdx.z * rows;  // this block's first row of the group
  const int nr = min(rows, pr.qpg - r0);
  const int kst = Dp + 4;  // padded row stride of the staged k page
  float* k_s = smem;
  float* v_s = pr.split ? k_s : k_s + page * kst;
  float* q_s = k_s + page * kst + (pr.split ? 0 : page * D);
  float* p_s = q_s + rows * Dp;  // scores, then probs
  float* m_s = p_s + rows * page;  // K1: running max; K13: running M
  float* l_s = m_s + rows;         // running denominator
  float* c_s = l_s + rows;         // this page's correction

  const size_t row0 = (size_t)b * KVH * pr.qpg + (size_t)g * pr.qpg + r0;
  const T* qg = static_cast<const T*>(pr.q) + row0 * D;
  for (int i = tid; i < nr * Dp; i += THREADS) {
    const int qi = i / Dp, d = i % Dp;
    q_s[i] = d < D ? rtt::to_float(qg[qi * D + d]) : 0.f;
  }
  if (tid < nr) {
    m_s[tid] = rtt::NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[MAX_E];
#pragma unroll
  for (int e = 0; e < MAX_E; ++e) acc[e] = 0.f;

  const int len = pr.lengths[b];
  const int p_end = min((len + page - 1) / page, pr.maxp);
  const size_t page_elems = (size_t)page * D;
  const size_t head_off =
      ((size_t)pr.layer * KVH + g) * (size_t)pr.P * page_elems;
  const TK* k_head = static_cast<const TK*>(pr.k) + head_off;
  const TK* v_head = static_cast<const TK*>(pr.v) + head_off;
  __syncthreads();

  for (int p = 0; p < p_end; ++p) {
    int pid = pr.block_table[(size_t)b * pr.maxp + p];
    pid = min(max(pid, 0), pr.P - 1);
    const TK* kp = k_head + (size_t)pid * page_elems;
    const TK* vp = v_head + (size_t)pid * page_elems;
    const int n_valid = min(page, len - p * page);
    float ks = 1.f, vs = 1.f;
    if (QUANT) {
      const size_t so = ((size_t)pr.layer * pr.P + pid) * KVH + g;
      ks = pr.k_scales[so];
      vs = pr.v_scales[so];
    }

    stage(k_s, kst, kp, n_valid, D, pr.vec);
    for (int i = tid; i < n_valid * (Dp - D); i += THREADS)
      k_s[(i / (Dp - D)) * kst + D + i % (Dp - D)] = 0.f;
    if (!pr.split) stage(v_s, D, vp, n_valid, D, pr.vec);
    __syncthreads();

    for (int i = tid; i < nr * n_valid; i += THREADS) {
      const int qi = i / n_valid, t = i % n_valid;
      float s = __fmul_rn(dot_fixed(q_s + qi * Dp, k_s + t * kst, Dp),
                          pr.scale);
      if (QUANT) s = __fmul_rn(s, ks);
      if (pr.soft_cap > 0.f) s = soft_cap_f(s, pr.soft_cap);
      p_s[qi * page + t] = s;
    }
    __syncthreads();

    // The page's max, p at the new reference (l sums p unrounded; p.v
    // takes p rounded to q's dtype) and this page's correction.
    for (int qi = warp; qi < nr; qi += THREADS / 32) {
      float* row = p_s + qi * page;
      float mx = rtt::NEG_INF;
      for (int t = lane; t < n_valid; t += 32) mx = fmaxf(mx, row[t]);
      mx = rtt::group_max<32>(mx);
      const float m_prev = m_s[qi];
      float m_new, corr;
      if constexpr (PARTIAL) {
        m_new = fmaxf(m_prev, mx);
        corr = exp_f(m_prev, m_new);
      } else {
        m_new = fmaxf(m_prev, (float)ceil((double)mx * LOG2E));
        corr = pow2_le0(m_prev - m_new);
      }
      float sum = 0.f;
      for (int t = lane; t < n_valid; t += 32) {
        const float e =
            PARTIAL ? exp_f(row[t], m_new)
                    : __double2float_rn(exp2((double)row[t] * LOG2E - m_new));
        row[t] = rtt::to_float(rtt::from_float<T>(e));
        sum += e;
      }
      sum = rtt::group_sum<32>(sum);
      if (lane == 0) {
        c_s[qi] = corr;
        l_s[qi] = __fadd_rn(__fmul_rn(corr, l_s[qi]), sum);
        m_s[qi] = m_new;
      }
    }
    __syncthreads();
    if (pr.split) {  // v into the buffer k has left
      stage(v_s, D, vp, n_valid, D, pr.vec);
      __syncthreads();
    }

#pragma unroll
    for (int e = 0; e < MAX_E; ++e) {
      const int idx = tid + e * THREADS;
      if (idx < nr * D) {
        const int qi = idx / D, d = idx % D;
        const float* prow = p_s + qi * page;
        float pv = 0.f;
        for (int t = 0; t < n_valid; ++t) pv += prow[t] * v_s[t * D + d];
        if (QUANT) pv = __fmul_rn(pv, vs);
        acc[e] = __fadd_rn(__fmul_rn(acc[e], c_s[qi]), pv);
      }
    }
    __syncthreads();  // the next page overwrites k_s, v_s, p_s, c_s
  }

#pragma unroll
  for (int e = 0; e < MAX_E; ++e) {
    const int idx = tid + e * THREADS;
    if (idx < nr * D) {
      if constexpr (PARTIAL) {
        pr.acc[row0 * D + idx] = acc[e];
      } else {
        const float l = l_s[idx / D];
        static_cast<T*>(pr.out)[row0 * D + idx] =
            rtt::from_float<T>(__fdiv_rn(acc[e], l == 0.f ? 1.f : l));
      }
    }
  }
  if constexpr (PARTIAL) {
    if (tid < nr) {
      pr.m[row0 + tid] = m_s[tid];
      pr.l[row0 + tid] = l_s[tid];
    }
  }
}

template <typename T, typename TK, bool QUANT, bool PARTIAL>
int launch_page_walk(const WalkParams& pr, int B, int KVH,
                     cudaStream_t stream) {
  auto kernel = page_walk_kernel<T, TK, QUANT, PARTIAL>;
  const size_t smem = page_walk_smem(pr.page, pr.D, pr.rows, pr.split);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B, KVH, (pr.qpg + pr.rows - 1) / pr.rows);
  kernel<<<grid, THREADS, smem, stream>>>(pr);
  return (int)cudaGetLastError();
}

bool walk_ok(const WalkParams& pr) {
  return pr.D >= 1 && pr.D <= MAX_D && pr.rows >= 1 &&
         pr.rows * pr.D <= THREADS * MAX_E && pr.qpg >= 1 && pr.page >= 1;
}

// ---------------------------------------------------------------------------
// The Hopper route: K1 and K13 in one launch
// ---------------------------------------------------------------------------
//
// The page axis of one (slot, kv head) splits over a thread-block cluster
// of up to 8 CTAs (the portable size), ppc pages each.  A rank whose pages
// all lie past the slot's live ones leaves at once (a cluster barrier waits
// only for threads that have not exited, and no rank touches its shared
// memory); rank 0 of a slot with no token writes the empty result.  Each
// (kv head, page id) k or v page is one contiguous [page, D] block, so a
// 1-D cp.async.bulk copies it whole into shared memory, in the pool's
// dtype (int8 pages land raw, half the bytes of bf16, and are converted
// exactly in registers), completing on an mbarrier; one thread a copy
// issues them, all at once.  The copies run through a ring of n_stages
// page buffers: the CTA's k pages, then its v pages, all in flight when
// they fit the wrapper's budget, else each stage refilled as soon as its
// page is read.  The group's qpg query rows are padded to QPG in {1, 2, 4,
// 8} with zero rows whose results are dropped (the Pallas kernels pad to 8).
//
//  1. scores: warps split a page's tokens, lanes split D (EPL = 8 columns a
//     lane).  The q.k dot is summed in the fixed order: each lane's eight
//     products left to right, then pairs of lanes l, l + n/2 for n = D/8,
//     D/16, .., 2 (halving exchanges: about one shuffle a result); products
//     and sums rounded one at a time (__fmul_rn, __fadd_rn; where q is bf16
//     the products are exact, so an fma is the same).  s = f32(dot) * scale
//     (* the page's k scale), then the soft cap; kept in shared memory for
//     the CTA's tokens;
//  2. p.  K1 (PARTIAL) rounds p at the running max, as the Pallas body's
//     walk does: each rank takes its pages' maxima, pushes its own maximum
//     into the shared memory of every later rank of the cluster, and after
//     one cluster barrier takes the prefix max up to each of its pages
//     (exact and order-free: the walk's m_new); p = f32(e^(s - m_new)),
//     corr = f32(e^(m_prev - m_new)) for each page, l = corr l + sum p in
//     page order (p unrounded), then p rounded to q's dtype in place.
//     K13 takes p against the power of two just above the rank's max: with
//     y = s log2(e) in f64 and M = ceil(max y), p = f32(2^(y - M)), l = sum
//     p, p rounded to q's dtype; rounding commutes with the power of two
//     2^(M - M_slot) that takes a rank's p to the slot's reference, so each
//     rank rounds p exactly as the plain version does at the slot's M, with
//     no barrier to agree on a max first;
//  3. p.v with warps splitting tokens (two at a time), lanes D, f32
//     accumulators (K1: scaled by each page's corr as the page starts, p
//     times the page's v scale on int8 pools), reduced across lane groups
//     by shuffles and across warps in shared memory;
//  4. every live rank writes its (acc, l, m) into rank 0's shared memory
//     and arrives on a cluster barrier; the others leave, and rank 0 waits,
//     scales each rank's sums to the slot's max (K1: f32(e^(m_rank - m)),
//     m_rank the running max at the rank's last page; K13: 2^(M_rank - M),
//     exact), adds them in rank order (deterministic) and writes acc, m, l
//     (K13: acc / l, l = 0 dividing by 1, in q's dtype).
// No global partials, no second kernel: the wrappers allocate only the
// outputs, and no launch parameter depends on the data (capturable).
namespace pdh {

namespace cg = cooperative_groups;
namespace hp = rtt::hopper;
constexpr int THREADS = 128, NW = THREADS / 32;
constexpr int MAX_STAGES = 16, MAX_CLUSTER = 8;
constexpr int V = 32;    // partial dots a lane holds before the reduction

struct Params {
  const void* q;
  const void* k;  // K1: pools [L, KVH, P, page, D]; K13: [KVH, P, page, D]
  const void* v;
  const float* k_scales;  // int8 pools: [L, P, KVH, 1]
  const float* v_scales;
  const int* block_table;
  const int* lengths;
  void* out;     // K13: [B, H, D] in q's dtype
  float* acc;    // K1: [B, H, D], m and l [B, H]
  float* m;
  float* l;
  int P, page, maxp, ppc, n_stages, layer, qpg;
  float scale, soft_cap;
};

// EPL consecutive elements as f32 (16-byte loads; int8 8-byte loads,
// converted exactly without int-to-float instructions).
__device__ __forceinline__ void load_row(const float* p, float (&f)[EPL]) {
#pragma unroll
  for (int c = 0; c < EPL; c += 4) {
    const float4 v = rtt::load4(p + c);
    f[c] = v.x; f[c + 1] = v.y; f[c + 2] = v.z; f[c + 3] = v.w;
  }
}
__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                         float (&f)[EPL]) {
  static_assert(EPL == 8, "one 16-byte load of bf16");
  rtt::Vec<__nv_bfloat16>::load(p, f);
}
__device__ __forceinline__ void load_row(const int8_t* p, float (&f)[EPL]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const uint4 u = rtt::int8x8_to_bf16(w.x, w.y);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// (..(q0 k0 + q1 k1) + ..) + q_{EPL-1} k_{EPL-1}, each step rounded on
// its own.  A product of a bf16 value and a bf16 or int8 one is exact in
// f32, so there an fma rounds the same sum.
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

// Shared bytes: the ring (later the cross-warp sums [NW][QPG][D] f32), the
// scores [QPG][ppc * page] f32, the ranks' sums [csize][QPG][D] f32 (read
// in rank 0) and, for K1, each page's max and corr [2][ppc][QPG] f32.
__host__ __device__ __forceinline__ size_t ring_bytes(size_t stage_bytes,
                                                      int n_stages,
                                                      int qpg_d) {
  const size_t ring = stage_bytes * n_stages, red = 4 * (size_t)NW * qpg_d;
  return ring > red ? ring : red;
}
size_t smem_bytes(int esize, int page, int D, int QPG, int ppc, int n_stages,
                  int csize, bool partial) {
  return ring_bytes((size_t)page * D * esize, n_stages, QPG * D) +
         4 * ((size_t)QPG * ppc * page + (size_t)csize * QPG * D +
              (partial ? 2 * (size_t)ppc * QPG : 0));
}

template <typename T, typename TK, int QPG, int D, bool PARTIAL>
__global__ void __launch_bounds__(THREADS) paged_decode_hopper(
    const Params pr) {
  constexpr bool QUANT = std::is_same<TK, int8_t>::value;
  static_assert(PARTIAL || !QUANT, "K13 takes no int8 pages");
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(128) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[MAX_STAGES];
  __shared__ double m_loc[QPG], m_tot[QPG], m_all[MAX_CLUSTER][QPG];
  __shared__ float l_loc[QPG], l_all[MAX_CLUSTER][QPG];
  __shared__ float scl[MAX_CLUSTER][QPG];
  __shared__ float r_max[MAX_CLUSTER][QPG];  // K1: the ranks' maxima

  const int rank = blockIdx.x;
  const int g = blockIdx.y, b = blockIdx.z, KVH = gridDim.y;
  const int qpg = pr.qpg, page = pr.page, ppc = pr.ppc;
  const int n_stages = pr.n_stages;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  constexpr int LPT = D / EPL;  // lanes a token's row is split over
  constexpr int GPW = 32 / LPT;
  const int grp = lane / LPT, li = lane % LPT;
  constexpr int TB = V / QPG;  // tokens of one lane group a pass
  static_assert(V >= LPT && LPT <= 32, "a lane keeps whole sums");

  const int len = pr.lengths[b];
  const int n_live = min((len + page - 1) / page, pr.maxp);
  const int n_ranks = (n_live + ppc - 1) / ppc;  // ranks with live pages
  const size_t row0 = (size_t)b * KVH * qpg + (size_t)g * qpg;
  if (rank >= n_ranks) {
    if (rank == 0) {  // no token: the empty result
      for (int e = tid; e < qpg * D; e += THREADS) {
        if constexpr (PARTIAL)
          pr.acc[row0 * D + e] = 0.f;
        else
          static_cast<T*>(pr.out)[row0 * D + e] = rtt::from_float<T>(0.f);
      }
      if constexpr (PARTIAL) {
        if (tid < qpg) {
          pr.m[row0 + tid] = rtt::NEG_INF;
          pr.l[row0 + tid] = 0.f;
        }
      }
    }
    return;
  }
  // Arrive on the barrier that every rank waits for before the first
  // write into another rank's shared memory.
  hp::cluster_arrive_relaxed();
  const int j0 = rank * ppc;
  const int n_my = min(ppc, n_live - j0);
  const int n_tok = min(len - j0 * page, n_my * page);
  const int n_load = 2 * n_my;

  const size_t stage_elems = (size_t)page * D;
  const uint32_t stage_bytes = (uint32_t)(stage_elems * sizeof(TK));
  const TK* ring = reinterpret_cast<const TK*>(smem_raw);
  const int ctok = ppc * page;
  float* sc = reinterpret_cast<float*>(
      smem_raw + ring_bytes(stage_bytes, n_stages, QPG * D));
  float* acc_all = sc + QPG * ctok;  // [csize][QPG][D], rank 0's read
  float* pm = acc_all + gridDim.x * QPG * D;  // K1: [ppc][QPG] page maxima
  float* cj = pm + ppc * QPG;                 // K1: [ppc][QPG] corr
  const int* bt = pr.block_table + (size_t)b * pr.maxp + j0;
  const size_t head_off =
      ((size_t)pr.layer * KVH + g) * (size_t)pr.P * stage_elems;
  const uint32_t ring_u32 = hp::smem_u32(smem_raw);
  const uint32_t bar0 = hp::smem_u32(bars);
  auto page_id = [&](int j) { return min(max(bt[j], 0), pr.P - 1); };
  auto page_scale = [&](const float* scales, int j) {
    return scales[((size_t)pr.layer * pr.P + page_id(j)) * KVH + g];
  };

  // Load i: the CTA's k pages, then its v pages, into stage i % n_stages.
  auto issue = [&](int i) {
    const int j = i < n_my ? i : i - n_my;
    const TK* src = static_cast<const TK*>(i < n_my ? pr.k : pr.v) +
                    head_off + (size_t)page_id(j) * stage_elems;
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
  // This lane's EPL columns of the group's q rows (padding rows zero).
  float qf[QPG][EPL];
#pragma unroll
  for (int qi = 0; qi < QPG; ++qi) {
    if (qi < qpg) {
      load_row(static_cast<const T*>(pr.q) + (row0 + qi) * D + EPL * li,
               qf[qi]);
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) qf[qi][e] = 0.f;
    }
  }

  // 1. Scores of the CTA's tokens.  A warp pass covers TB * GPW tokens:
  // token t0 + GPW * tb + grp for lane group grp.
  const int tpw = TB * GPW;
  for (int j = 0; j < n_my; ++j) {
    const float ks = QUANT ? page_scale(pr.k_scales, j) : 1.f;
    wait(j);
    const TK* kp = ring + (size_t)(j % n_stages) * stage_elems;
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
          float s = __fmul_rn(v[i], pr.scale);
          if constexpr (QUANT) s = __fmul_rn(s, ks);
          sc[qi * ctok + j * page + t] = s;
        }
      }
    }
    refill(j);
  }
  // The soft cap (its branch hoisted out of the unrolled score loop).
  __syncthreads();
  if (pr.soft_cap > 0.f)
    for (int i = tid; i < QPG * n_tok; i += THREADS) {
      float* ps = sc + (i / n_tok) * ctok + i % n_tok;
      *ps = soft_cap_f(*ps, pr.soft_cap);
    }
  __syncthreads();

  // 2. p, l and the reference of this rank's sums.
  if constexpr (PARTIAL) {
    for (int qi = warp; qi < QPG; qi += NW) {
      float rm = rtt::NEG_INF;
      for (int j = 0; j < n_my; ++j) {
        const int t_end = min(page, n_tok - j * page);
        const float* row = sc + qi * ctok + j * page;
        float mx = rtt::NEG_INF;
        for (int t = lane; t < t_end; t += 32) mx = fmaxf(mx, row[t]);
        mx = rtt::group_max<32>(mx);
        if (lane == 0) pm[j * QPG + qi] = mx;
        rm = fmaxf(rm, mx);
      }
      if (lane == 0) r_max[rank][qi] = rm;
    }
    __syncthreads();
    hp::cluster_wait();  // every live rank has started
    if (tid < QPG)
      for (int r = rank + 1; r < n_ranks; ++r)
        cluster.map_shared_rank(&r_max[0][0], r)[rank * QPG + tid] =
            r_max[rank][tid];
    hp::cluster_arrive();
    hp::cluster_wait();
    for (int qi = warp; qi < QPG; qi += NW) {
      float m_prev = rtt::NEG_INF;  // the walk's m before this rank's pages
      for (int r = 0; r < rank; ++r) m_prev = fmaxf(m_prev, r_max[r][qi]);
      float l = 0.f;
      for (int j = 0; j < n_my; ++j) {
        const int t_end = min(page, n_tok - j * page);
        float* row = sc + qi * ctok + j * page;
        const float m_new = fmaxf(m_prev, pm[j * QPG + qi]);
        float sum = 0.f;
        for (int t = lane; t < t_end; t += 32) {
          const float p = exp_f(row[t], m_new);
          sum += p;
          row[t] = rtt::to_float(rtt::from_float<T>(p));
        }
        sum = rtt::group_sum<32>(sum);
        const float corr = exp_f(m_prev, m_new);
        l = __fadd_rn(__fmul_rn(corr, l), sum);
        if (lane == 0) cj[j * QPG + qi] = corr;
        m_prev = m_new;
      }
      if (lane == 0) {
        l_loc[qi] = l;
        m_loc[qi] = m_prev;
      }
    }
  } else {
    for (int qi = warp; qi < QPG; qi += NW) {
      float mx = rtt::NEG_INF;
      for (int t = lane; t < n_tok; t += 32)
        mx = fmaxf(mx, sc[qi * ctok + t]);
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
  }
  __syncthreads();

  // 3. p.v.
  float acc[QPG][EPL];
#pragma unroll
  for (int qi = 0; qi < QPG; ++qi)
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[qi][e] = 0.f;
  const int step = NW * GPW;  // tokens between a lane group's turns
  for (int j = 0; j < n_my; ++j) {
    const int i = n_my + j;
    const float vs = QUANT ? page_scale(pr.v_scales, j) : 1.f;
    if constexpr (PARTIAL) {
#pragma unroll
      for (int qi = 0; qi < QPG; ++qi) {
        const float c = cj[j * QPG + qi];
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[qi][e] = __fmul_rn(acc[qi][e], c);
      }
    }
    wait(i);
    const TK* vp = ring + (size_t)(i % n_stages) * stage_elems;
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
          float p = pj[qi * ctok + t + u * step];
          if constexpr (QUANT) p = __fmul_rn(p, vs);
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
        float p = pj[qi * ctok + t];
        if constexpr (QUANT) p = __fmul_rn(p, vs);
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

  // 4. Every live rank's (acc, l, m) into rank 0's shared memory, once
  // every CTA of the cluster has started (K1 has waited for that in 2);
  // then rank 0 merges.
  const int n_el = QPG * D;
  if constexpr (!PARTIAL) hp::cluster_wait();
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

  if (tid < QPG) {
    double m = m_all[0][tid];
    for (int r = 1; r < n_ranks; ++r) m = fmax(m, m_all[r][tid]);
    m_tot[tid] = m;
  }
  __syncthreads();
  if (tid < n_ranks * QPG) {
    const int r = tid / QPG, qi = tid % QPG;
    if constexpr (PARTIAL) {
      scl[r][qi] = exp_f((float)m_all[r][qi], (float)m_tot[qi]);
    } else {
      // 2^(M_rank - M) as a float (0 below 2^-126, where the terms are
      // far below an f32 ulp of the sum).
      const double sh = m_all[r][qi] - m_tot[qi];
      scl[r][qi] = sh < -126.0 ? 0.f : __int_as_float(((int)sh + 127) << 23);
    }
  }
  __syncthreads();
  for (int e = tid; e < qpg * D; e += THREADS) {
    const int qi = e / D;
    float a = 0.f, l = 0.f;
    for (int r = 0; r < n_ranks; ++r) {
      a = __fmaf_rn(acc_all[r * n_el + e], scl[r][qi], a);
      l = __fmaf_rn(l_all[r][qi], scl[r][qi], l);
    }
    if constexpr (PARTIAL) {
      pr.acc[row0 * D + e] = a;
      if (e % D == 0) {
        pr.l[row0 + qi] = l;
        pr.m[row0 + qi] = (float)m_tot[qi];
      }
    } else {
      static_cast<T*>(pr.out)[row0 * D + e] =
          rtt::from_float<T>(__fdiv_rn(a, l == 0.f ? 1.f : l));
    }
  }
}

template <typename T, typename TK, int QPG, int D, bool PARTIAL>
int launch(const Params& pr, int B, int KVH, int csize, cudaStream_t stream) {
  auto kernel = paged_decode_hopper<T, TK, QPG, D, PARTIAL>;
  const size_t smem = smem_bytes((int)sizeof(TK), pr.page, D, QPG, pr.ppc,
                                 pr.n_stages, csize, PARTIAL);
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
  err = cudaLaunchKernelEx(&cfg, kernel, pr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The instantiation for (q dtype, pool dtype, qpg padded to 1, 2, 4 or 8,
// D in {16, 32, 64, 128}).
template <typename T, typename TK, bool PARTIAL, int QPG>
int dispatch_d(const Params& pr, int B, int KVH, int D, int csize,
               cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, TK, QPG, 16, PARTIAL>(pr, B, KVH, csize, s);
    case 32: return launch<T, TK, QPG, 32, PARTIAL>(pr, B, KVH, csize, s);
    case 64: return launch<T, TK, QPG, 64, PARTIAL>(pr, B, KVH, csize, s);
    case 128: return launch<T, TK, QPG, 128, PARTIAL>(pr, B, KVH, csize, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, typename TK, bool PARTIAL>
int dispatch(const Params& pr, int B, int KVH, int D, int csize,
             cudaStream_t s) {
  if (pr.qpg < 1 || pr.qpg > 8) return (int)cudaErrorInvalidValue;
  if (pr.qpg == 1) return dispatch_d<T, TK, PARTIAL, 1>(pr, B, KVH, D, csize, s);
  if (pr.qpg == 2) return dispatch_d<T, TK, PARTIAL, 2>(pr, B, KVH, D, csize, s);
  if (pr.qpg <= 4) return dispatch_d<T, TK, PARTIAL, 4>(pr, B, KVH, D, csize, s);
  return dispatch_d<T, TK, PARTIAL, 8>(pr, B, KVH, D, csize, s);
}

bool plan_ok(int csize, int ppc, int maxp, int n_stages) {
  return csize >= 1 && csize <= MAX_CLUSTER && csize * ppc >= maxp &&
         n_stages >= 1 && n_stages <= MAX_STAGES;
}

}  // namespace pdh

}  // namespace

// K1 on the Hopper route.  dtype (of q): 0 = float32, 1 = bfloat16.  The
// pools have q's dtype when k_scales is null, and are int8 with f32 scales
// [L, P, KVH, 1] when it is not.  qpg <= 8, D in {16, 32, 64, 128}; the
// grid is csize CTAs (one cluster, csize <= 8, csize * ppc >= maxp) per
// (kv head, slot), ppc pages each, through a ring of n_stages (<= 16) page
// buffers.  soft_cap <= 0 means none.  acc [B, H, D], m and l [B, H] f32.
extern "C" int rtt_paged_decode_partial(
    const void* q, const void* k_pools, const void* v_pools,
    const void* k_scales, const void* v_scales, const void* block_table,
    const void* lengths, void* acc, void* m, void* l, int dtype, int B,
    int KVH, int P, int page, int D, int qpg, int maxp, int csize, int ppc,
    int n_stages, int layer, float scale, float soft_cap, void* stream) {
  if (!pdh::plan_ok(csize, ppc, maxp, n_stages))
    return (int)cudaErrorInvalidValue;
  const pdh::Params pr{q, k_pools, v_pools,
                       static_cast<const float*>(k_scales),
                       static_cast<const float*>(v_scales),
                       static_cast<const int*>(block_table),
                       static_cast<const int*>(lengths), nullptr,
                       static_cast<float*>(acc), static_cast<float*>(m),
                       static_cast<float*>(l), P, page, maxp, ppc, n_stages,
                       layer, qpg, scale, soft_cap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k_scales != nullptr)
    return dtype == 0
               ? pdh::dispatch<float, int8_t, true>(pr, B, KVH, D, csize, s)
               : pdh::dispatch<__nv_bfloat16, int8_t, true>(pr, B, KVH, D,
                                                            csize, s);
  return dtype == 0
             ? pdh::dispatch<float, float, true>(pr, B, KVH, D, csize, s)
             : pdh::dispatch<__nv_bfloat16, __nv_bfloat16, true>(pr, B, KVH,
                                                                 D, csize, s);
}

// K1 on the page-walk route (any qpg, D up to 256; the wrapper's
// walk_plan gives `rows`, the query rows a CTA holds, at most 1024 / D, and
// `split`, k and v staged one after the other): the same arguments as the
// Hopper route's without the cluster plan; acc, m, l as above.
extern "C" int rtt_paged_decode_partial_walk(
    const void* q, const void* k_pools, const void* v_pools,
    const void* k_scales, const void* v_scales, const void* block_table,
    const void* lengths, void* acc, void* m, void* l, int dtype, int B,
    int KVH, int P, int page, int D, int qpg, int maxp, int rows, int split,
    int layer, float scale, float soft_cap, void* stream) {
  const bool quant = k_scales != nullptr;
  const size_t esize = quant ? 1 : (dtype == 0 ? 4 : 2);
  const WalkParams pr{q, k_pools, v_pools,
                      static_cast<const float*>(k_scales),
                      static_cast<const float*>(v_scales),
                      static_cast<const int*>(block_table),
                      static_cast<const int*>(lengths), nullptr,
                      static_cast<float*>(acc), static_cast<float*>(m),
                      static_cast<float*>(l), P, page, D, qpg, maxp, layer,
                      rows, split, (int)((D * esize) % 16 == 0), scale,
                      soft_cap};
  if (!walk_ok(pr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (quant)
    return dtype == 0
               ? launch_page_walk<float, int8_t, true, true>(pr, B, KVH, s)
               : launch_page_walk<__nv_bfloat16, int8_t, true, true>(pr, B,
                                                                     KVH, s);
  return dtype == 0
             ? launch_page_walk<float, float, false, true>(pr, B, KVH, s)
             : launch_page_walk<__nv_bfloat16, __nv_bfloat16, false, true>(
                   pr, B, KVH, s);
}

// K13.  dtype (of q and the pages): 0 = float32, 1 = bfloat16.  The pages
// are one layer's [KVH, P, page, D]; out is [B, H, D] in q's dtype.  qpg
// <= 8, D in {16, 32, 64, 128}; the plan as K1's.
extern "C" int rtt_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_table, const void* lengths, void* out, int dtype,
    int B, int KVH, int P, int page, int D, int qpg, int maxp, int csize,
    int ppc, int n_stages, float scale, float soft_cap, void* stream) {
  if (!pdh::plan_ok(csize, ppc, maxp, n_stages))
    return (int)cudaErrorInvalidValue;
  const pdh::Params pr{q, k_pages, v_pages, nullptr, nullptr,
                       static_cast<const int*>(block_table),
                       static_cast<const int*>(lengths), out, nullptr,
                       nullptr, nullptr, P, page, maxp, ppc, n_stages, 0,
                       qpg, scale, soft_cap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? pdh::dispatch<float, float, false>(pr, B, KVH, D, csize, s)
             : pdh::dispatch<__nv_bfloat16, __nv_bfloat16, false>(pr, B, KVH,
                                                                  D, csize, s);
}

// K13 on the page-walk route (any qpg, D up to 256; rows and split as
// K1's walk): the arguments of rtt_paged_decode_attention without the
// cluster plan.
extern "C" int rtt_paged_decode_attention_walk(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_table, const void* lengths, void* out, int dtype,
    int B, int KVH, int P, int page, int D, int qpg, int maxp, int rows,
    int split, float scale, float soft_cap, void* stream) {
  const size_t esize = dtype == 0 ? 4 : 2;
  const WalkParams pr{q, k_pages, v_pages, nullptr, nullptr,
                      static_cast<const int*>(block_table),
                      static_cast<const int*>(lengths), out, nullptr,
                      nullptr, nullptr, P, page, D, qpg, maxp, 0, rows,
                      split, (int)((D * esize) % 16 == 0), scale, soft_cap};
  if (!walk_ok(pr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? launch_page_walk<float, float, false, false>(pr, B, KVH, s)
             : launch_page_walk<__nv_bfloat16, __nv_bfloat16, false, false>(
                   pr, B, KVH, s);
}
