// One-token paged decode attention for Hopper (sm_90a), plain CUDA C++:
// K6, and its dequantizing form K6q.
//
// Replaces the TPU kernel `_paged_decode_pallas` (paddle_tpu/serving/
// attention.py:530, pallas_call at :578, body `_paged_decode_kernel` :460):
// for every batch row, its single query token attends over the K/V pages
// its page-table row names, up to and including its own position `pos`.
// Pools are bf16 or fp32 (K6) or, as K6q (the TPU body's dequantizing form,
// :473-516), int8 or fp8 e4m3 with fp32 scale slabs of shape (kvh, P, ps,
// 1), each scale read through the same page-table entry as its data.
//
// Semantics kept from the TPU kernel at the edges:
//   - key columns past `pos` are masked; pages wholly past `pos` are not
//     read at all (the TPU kernel's splash-style skip);
//   - the softmax denominator is clamped at 1e-30;
//   - a row parked at pos = max_pages * page_size (batch padding, finished
//     rows) attends every page of its table, as on the TPU.
// What is gone: the TPU's padding of the query group to 8 rows and of
// head_dim to 128 lanes, and the scalar prefetch of the page table.
//
// What bounds it on an H100: bytes. At b = 8 rows with positions spread
// over 0..1023, 32 kv heads of 128, one call must read 4097 positions of K
// and V: 67.1 MB in bf16 (20 us at 3.35 TB/s), 33.6 MB plus 1 MB of scales
// in int8 / fp8; about 1 flop a byte, far below the ~295 where the tensor
// cores would matter.
//
// Design (split-KV, one launch). Every (kv head, row, split of 128 keys) is
// a block; splits wholly past the row's position exit at once. A block is
// the decode walk of paged_common.cuh (`decode_split`): the split's table
// entries first, then all its K and V rows in flight through cp.async,
// scores from shared memory four lanes a key with the rep query heads of
// the kv head together (GQA shares every K/V byte), a softmax over the
// split, P V with a thread per 8 columns, and the last split of a (row, kv
// head) to arrive merges the row's partials in split order. The walk takes
// bf16 queries over bf16, int8 and fp8 pools at head_dim 64 and 128; each
// (pool type, head_dim, rep) is its own instantiation.
//
// The fp32 forms (fp32 q or fp32 pools) and head_dim 32 / 256 keep the FMA
// kernel of the first port: each of 4 warps takes every 4th token of a
// split, a lane per head_dim / 32 elements, the q . k dot a warp shuffle
// sum, an online softmax in registers, and a second kernel merges the
// splits.

#include <math.h>

#include <type_traits>

#include "paged_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kSplitTokens = 128;
constexpr int kUnroll = 4;  // tokens a warp has in flight per iteration

// VEC consecutive elements of T into fp32, with the widest aligned load
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float* out) {
  constexpr int kBytes = VEC * sizeof(T);
  if constexpr (kBytes == 16 || kBytes == 8 || kBytes == 4) {
    using V = typename std::conditional<
        kBytes == 16, uint4,
        typename std::conditional<kBytes == 8, uint2, unsigned>::type>::type;
    V raw = *reinterpret_cast<const V*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = ptt::to_f32(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = ptt::to_f32(p[i]);
  }
}

// grid (kvh, b, n_splits); VEC = head_dim / 32; REP = heads / kvh;
// k_scale / v_scale are read only for int8 / fp8 pools
template <typename TQ, typename TKV, int VEC, int REP>
__global__ void __launch_bounds__(kThreads)
    paged_decode_split_kernel(const TQ* __restrict__ q,
                              const TKV* __restrict__ k_pool,
                              const TKV* __restrict__ v_pool,
                              const float* __restrict__ k_scale,
                              const float* __restrict__ v_scale,
                              const int* __restrict__ page_table,
                              const int* __restrict__ pos_arr,
                              float* __restrict__ part_ml,
                              float* __restrict__ part_acc, int heads,
                              int kvh, int num_pages, int ps, int max_pages,
                              float scale) {
  constexpr int HD = VEC * 32;
  __shared__ float red_ml[kWarps][REP][2];
  __shared__ float red_acc[kWarps][REP][HD];

  const int g = blockIdx.x, bb = blockIdx.y, sp = blockIdx.z;
  const int n_splits = gridDim.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pos = pos_arr[bb];
  // columns 0..pos attend; a parked row (pos = max_pages*ps) sees all
  const int n_tok = min(pos + 1, max_pages * ps);
  const int t_begin = sp * kSplitTokens;
  const int t_end = min(n_tok, t_begin + kSplitTokens);
  const int* pt = page_table + (long long)bb * max_pages;

  // query heads g*rep .. g*rep+REP-1 attend kv head g (repeat-interleave)
  float qv[REP][VEC];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    const TQ* qr =
        q + ((long long)bb * heads + (long long)g * REP + r) * HD + lane * VEC;
#pragma unroll
    for (int i = 0; i < VEC; ++i) qv[r][i] = ptt::to_f32(qr[i]) * scale;
  }
  float m[REP], l[REP], acc[REP][VEC];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[r][i] = 0.f;
  }

  const long long head_base = (long long)g * num_pages;
  for (int t0 = t_begin + warp; t0 < t_end; t0 += kWarps * kUnroll) {
    float kk[kUnroll][VEC], vv[kUnroll][VEC];
    bool live[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * kWarps;
      live[u] = t < t_end;
      if (live[u]) {
        const long long slot = (head_base + pt[t / ps]) * ps + t % ps;
        const long long off = slot * HD + lane * VEC;
        load_vec<TKV, VEC>(k_pool + off, kk[u]);
        load_vec<TKV, VEC>(v_pool + off, vv[u]);
        if constexpr (ptt::kQuantized<TKV>) {
          const float ks = k_scale[slot], vs = v_scale[slot];
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            kk[u][i] *= ks;
            vv[u][i] *= vs;
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) kk[u][i] = vv[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float s[kUnroll];
      float mx = m[r];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) d += qv[r][i] * kk[u][i];
        d = ptt::warp_sum(d);
        s[u] = live[u] ? d : -INFINITY;
        mx = fmaxf(mx, s[u]);
      }
      // online softmax in fp32; -inf guards mirror the TPU kernel
      const float m_safe = mx == -INFINITY ? 0.f : mx;
      const float alpha = m[r] == -INFINITY ? 0.f : expf(m[r] - m_safe);
      l[r] *= alpha;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[r][i] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float p = s[u] == -INFINITY ? 0.f : expf(s[u] - m_safe);
        l[r] += p;
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[r][i] += p * vv[u][i];
      }
      m[r] = mx;
    }
  }

  // fold the warps together, then one partial per (query head, split)
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (lane == 0) {
      red_ml[warp][r][0] = m[r];
      red_ml[warp][r][1] = l[r];
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) red_acc[warp][r][lane * VEC + i] = acc[r][i];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < REP * HD; e += kThreads) {
    const int r = e / HD, c = e % HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red_ml[w][r][0]);
    float sum_l = 0.f, sum_a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = red_ml[w][r][0];
      const float f = mw == -INFINITY ? 0.f : expf(mw - mx);
      sum_l += red_ml[w][r][1] * f;
      sum_a += red_acc[w][r][c] * f;
    }
    const long long row = ((long long)bb * heads + (long long)g * REP + r) *
                              n_splits + sp;
    part_acc[row * HD + c] = sum_a;
    if (c == 0) {
      part_ml[row * 2] = mx;
      part_ml[row * 2 + 1] = sum_l;
    }
  }
}

// grid (heads, b), head_dim threads: merge the splits of one (row, head)
template <typename TQ>
__global__ void paged_decode_merge_kernel(const float* __restrict__ part_ml,
                                          const float* __restrict__ part_acc,
                                          TQ* __restrict__ out, int heads,
                                          int hd, int n_splits) {
  const int h = blockIdx.x, bb = blockIdx.y, c = threadIdx.x;
  const long long row0 = ((long long)bb * heads + h) * n_splits;
  float mx = -INFINITY;
  for (int s = 0; s < n_splits; ++s) mx = fmaxf(mx, part_ml[(row0 + s) * 2]);
  float sum_l = 0.f, sum_a = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const float ms = part_ml[(row0 + s) * 2];
    const float f = ms == -INFINITY ? 0.f : expf(ms - mx);
    sum_l += part_ml[(row0 + s) * 2 + 1] * f;
    sum_a += part_acc[(row0 + s) * hd + c] * f;
  }
  out[((long long)bb * heads + h) * hd + c] =
      ptt::from_f32<TQ>(sum_a / fmaxf(sum_l, 1e-30f));
}

// grid (kvh, b, n_splits): the decode walk of one (kv head, row, split);
// bf16 q and output, TKV pools (bf16, int8, fp8)
template <typename TKV, int HD, int REP>
__global__ void __launch_bounds__(ptt::paged::kThreads)
    paged_decode_walk_kernel(const __nv_bfloat16* __restrict__ q,
                             const TKV* __restrict__ k_pool,
                             const TKV* __restrict__ v_pool,
                             const float* __restrict__ k_scale,
                             const float* __restrict__ v_scale,
                             const int* __restrict__ page_table,
                             const int* __restrict__ pos_arr,
                             __nv_bfloat16* __restrict__ out,
                             float* __restrict__ part_ml,
                             float* __restrict__ part_acc, int* counters,
                             int heads, int kvh, int num_pages, int ps,
                             int max_pages, float scale) {
  namespace pg = ptt::paged;
  extern __shared__ __align__(16) unsigned char smem[];
  PTT_STAMP_BEGIN();
  const int g = blockIdx.x, bb = blockIdx.y, sp = blockIdx.z;
  const int n_splits = gridDim.z;
  // columns 0..pos attend; a parked row (pos = max_pages*ps) sees all
  const int n_tok = min(pos_arr[bb] + 1, max_pages * ps);
  const long long hq = (long long)bb * heads + g * REP;  // first q head
  if (n_tok <= 0) {
    if (sp == 0) pg::zero_heads<HD, REP>(out + hq * HD);
    return;
  }
  if (sp * pg::kSplit >= n_tok) return;
  const pg::WalkItem it{q + hq * HD,
                        out + hq * HD,
                        page_table + (long long)bb * max_pages,
                        n_tok,
                        sp,
                        part_ml + hq * n_splits * 2,
                        part_acc + hq * n_splits * HD,
                        n_splits,
                        counters + bb * kvh + g};
  pg::decode_split<TKV, HD, REP>(smem, it, k_pool, v_pool, k_scale, v_scale,
                                 (long long)g * num_pages, ps, scale);
  PTT_STAMP_END();
}

// the pointer and size arguments every launch passes along
struct Args {
  const void *q, *kp, *vp;
  const float *ks, *vs;
  const int *pt, *pos;
  void* out;
  float *ml, *acc;
  int* counters;
  int b, heads, kvh, num_pages, ps, max_pages, n_splits;
  float scale;
  cudaStream_t st;
};

template <typename TKV, int HD, int REP>
int launch_walk(const Args& a) {
  auto kern = paged_decode_walk_kernel<TKV, HD, REP>;
  const int smem = ptt::paged::WalkSmem<TKV, HD, REP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.kvh, a.b, a.n_splits);
  kern<<<grid, ptt::paged::kThreads, smem, a.st>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const TKV*>(a.kp),
      static_cast<const TKV*>(a.vp), a.ks, a.vs, a.pt, a.pos,
      static_cast<__nv_bfloat16*>(a.out), a.ml, a.acc, a.counters, a.heads,
      a.kvh, a.num_pages, a.ps, a.max_pages, a.scale);
  return (int)cudaGetLastError();
}

template <typename TKV, int HD>
int walk_rep(int rep, const Args& a) {
  if (rep == 1) return launch_walk<TKV, HD, 1>(a);
  if (rep == 2) return launch_walk<TKV, HD, 2>(a);
  if (rep == 4) return launch_walk<TKV, HD, 4>(a);
  if (rep == 8) return launch_walk<TKV, HD, 8>(a);
  return (int)cudaErrorInvalidValue;
}

template <typename TKV>
int walk_hd(int hd, int rep, const Args& a) {
  if (hd == 64) return walk_rep<TKV, 64>(rep, a);
  if (hd == 128) return walk_rep<TKV, 128>(rep, a);
  return (int)cudaErrorInvalidValue;
}

// bf16 q over bf16 / int8 / fp8 pools at head_dim 64 / 128: the walk
bool takes_walk(int q_dtype, int kv_dtype, int hd) {
  return q_dtype == ptt::kBF16 && kv_dtype != ptt::kF32 &&
         (hd == 64 || hd == 128);
}

template <typename TQ, typename TKV, int VEC, int REP>
int launch(const Args& a) {
  dim3 grid(a.kvh, a.b, a.n_splits);
  paged_decode_split_kernel<TQ, TKV, VEC, REP><<<grid, kThreads, 0, a.st>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.kp),
      static_cast<const TKV*>(a.vp), a.ks, a.vs, a.pt, a.pos, a.ml, a.acc,
      a.heads, a.kvh, a.num_pages, a.ps, a.max_pages, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_decode_merge_kernel<TQ><<<dim3(a.heads, a.b), VEC * 32, 0, a.st>>>(
      a.ml, a.acc, static_cast<TQ*>(a.out), a.heads, VEC * 32, a.n_splits);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV, int VEC>
int dispatch_rep(int rep, const Args& a) {
  if (rep == 1) return launch<TQ, TKV, VEC, 1>(a);
  if (rep == 2) return launch<TQ, TKV, VEC, 2>(a);
  if (rep == 4) return launch<TQ, TKV, VEC, 4>(a);
  if (rep == 8) return launch<TQ, TKV, VEC, 8>(a);
  return (int)cudaErrorInvalidValue;
}

// bf16 q over bf16 / int8 / fp8 pools at head_dim 64 / 128 is the walk's:
// the FMA kernel is not instantiated for those forms
template <typename TQ, typename TKV>
int dispatch_hd(int hd, int rep, const Args& a) {
  constexpr bool kWalkForm = std::is_same<TQ, __nv_bfloat16>::value &&
                             !std::is_same<TKV, float>::value;
  if (hd == 32) return dispatch_rep<TQ, TKV, 1>(rep, a);
  if constexpr (!kWalkForm) {
    if (hd == 64) return dispatch_rep<TQ, TKV, 2>(rep, a);
    if (hd == 128) return dispatch_rep<TQ, TKV, 4>(rep, a);
  }
  if (hd == 256) return dispatch_rep<TQ, TKV, 8>(rep, a);
  return (int)cudaErrorInvalidValue;
}

// the FMA kernel: fp32 q or fp32 pools at any head_dim, and bf16 q over
// bf16 / int8 / fp8 pools at head_dim 32 / 256
template <typename TQ>
int dispatch_kv(int kv_dtype, int hd, int rep, const Args& a) {
  if (kv_dtype == ptt::kF32) return dispatch_hd<TQ, float>(hd, rep, a);
  if (kv_dtype == ptt::kBF16)
    return dispatch_hd<TQ, __nv_bfloat16>(hd, rep, a);
  if (a.ks == nullptr || a.vs == nullptr) return (int)cudaErrorInvalidValue;
  if (kv_dtype == ptt::kI8) return dispatch_hd<TQ, int8_t>(hd, rep, a);
  if (kv_dtype == ptt::kFP8)
    return dispatch_hd<TQ, __nv_fp8_e4m3>(hd, rep, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Dynamic shared memory (bytes) of the walk's instantiation for kv_dtype
// (1 bf16, 2 int8, 3 fp8), head_dim and rep; 0 for a form it does not take.
extern "C" int ptt_paged_decode_walk_smem(int kv_dtype, int hd, int rep) {
  namespace pg = ptt::paged;
  if (kv_dtype < ptt::kBF16 || kv_dtype > ptt::kFP8) return 0;
  if (hd != 64 && hd != 128) return 0;
  const bool wide = kv_dtype == ptt::kBF16;
  auto pick = [&](auto tag) -> int {
    using T = decltype(tag);
    if (hd == 64) {
      if (rep == 1) return pg::WalkSmem<T, 64, 1>::kBytes;
      if (rep == 2) return pg::WalkSmem<T, 64, 2>::kBytes;
      if (rep == 4) return pg::WalkSmem<T, 64, 4>::kBytes;
      if (rep == 8) return pg::WalkSmem<T, 64, 8>::kBytes;
    } else {
      if (rep == 1) return pg::WalkSmem<T, 128, 1>::kBytes;
      if (rep == 2) return pg::WalkSmem<T, 128, 2>::kBytes;
      if (rep == 4) return pg::WalkSmem<T, 128, 4>::kBytes;
      if (rep == 8) return pg::WalkSmem<T, 128, 8>::kBytes;
    }
    return 0;
  };
  // int8 and fp8 rows are the same size
  return wide ? pick(__nv_bfloat16()) : pick(int8_t());
}

// Number of token splits the wrapper must size the scratch for: kSplit
// keys a split for the walk, kSplitTokens for the FMA kernel.
extern "C" int ptt_paged_decode_splits(int max_pages, int ps, int hd,
                                       int q_dtype, int kv_dtype) {
  const int split = takes_walk(q_dtype, kv_dtype, hd) ? ptt::paged::kSplit
                                                      : kSplitTokens;
  return (max_pages * ps + split - 1) / split;
}

// q/out: contiguous (b, 1, heads, hd) of q_dtype (0 fp32, 1 bf16);
// k_pool/v_pool: contiguous (kvh, num_pages, ps, hd) of kv_dtype (0 fp32,
// 1 bf16, 2 int8, 3 fp8 e4m3), 16-byte aligned; k_scale/v_scale:
// contiguous fp32 (kvh, num_pages, ps, 1) for int8/fp8 pools, else null;
// page_table: (b, max_pages) int32; pos: (b,) int32; part_ml / part_acc:
// fp32 scratch of b*heads*n_splits*2 and b*heads*n_splits*hd elements,
// n_splits from ptt_paged_decode_splits; counters: b*kvh int32, all zero
// (the walk leaves them zero). hd in {32, 64, 128, 256}, heads/kvh in
// {1, 2, 4, 8}. Returns cudaGetLastError() after the launch(es).
extern "C" int ptt_paged_decode(const void* q, const void* k_pool,
                                const void* v_pool, const void* k_scale,
                                const void* v_scale, const void* page_table,
                                const void* pos, void* out, void* part_ml,
                                void* part_acc, void* counters, int b,
                                int heads, int kvh, int hd, int num_pages,
                                int ps, int max_pages, float scale,
                                int q_dtype, int kv_dtype, void* stream) {
  if (kvh < 1 || heads % kvh != 0 || ps < 1 || max_pages < 1)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k_pool, v_pool,
               static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(page_table),
               static_cast<const int*>(pos), out,
               static_cast<float*>(part_ml), static_cast<float*>(part_acc),
               static_cast<int*>(counters),
               b, heads, kvh, num_pages, ps, max_pages,
               ptt_paged_decode_splits(max_pages, ps, hd, q_dtype, kv_dtype),
               scale,
               static_cast<cudaStream_t>(stream)};
  const int rep = heads / kvh;
  if (takes_walk(q_dtype, kv_dtype, hd)) {
    if (a.counters == nullptr) return (int)cudaErrorInvalidValue;
    if (kv_dtype == ptt::kBF16) return walk_hd<__nv_bfloat16>(hd, rep, a);
    if (a.ks == nullptr || a.vs == nullptr) return (int)cudaErrorInvalidValue;
    if (kv_dtype == ptt::kI8) return walk_hd<int8_t>(hd, rep, a);
    if (kv_dtype == ptt::kFP8) return walk_hd<__nv_fp8_e4m3>(hd, rep, a);
    return (int)cudaErrorInvalidValue;
  }
  if (q_dtype == ptt::kF32) return dispatch_kv<float>(kv_dtype, hd, rep, a);
  if (q_dtype == ptt::kBF16)
    return dispatch_kv<__nv_bfloat16>(kv_dtype, hd, rep, a);
  return (int)cudaErrorInvalidValue;
}
