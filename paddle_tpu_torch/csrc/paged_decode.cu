// One-token paged decode attention for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the TPU kernel `_paged_decode_pallas` (paddle_tpu/serving/
// attention.py:530, pallas_call at :578, body `_paged_decode_kernel` :460):
// for every batch row, its single query token attends over the K/V pages
// its page-table row names, up to and including its own position `pos`.
// Pools are fp32 or bf16 (K6) or, as K6q, the dequantizing variant of the
// TPU kernel (body :473-516): int8 or fp8 e4m3 pools with fp32 scale slabs
// of shape (kvh, P, ps, 1), each K/V element times its slot's scale as it
// is loaded, the scale read through the same page-table entry as the data.
//
// Semantics kept from the TPU kernel at the edges:
//   - key columns past `pos` are masked; pages wholly past `pos` are not
//     read at all (the TPU kernel's splash-style skip);
//   - the softmax denominator is clamped at 1e-30;
//   - a row parked at pos = max_pages * page_size (batch padding, finished
//     rows) attends every page of its table, as on the TPU.
// What is gone: the TPU's padding of the query group to 8 rows and of
// head_dim to 128 lanes, and the scalar prefetch of the page table (each
// block reads its own table row).
//
// What bounds it on an H100: bytes. At b=8 rows of 512 tokens, 32 kv
// heads, hd=128, bf16, one layer's call must read 2 * 8*512*32*128*2 B =
// 67 MB of K/V (~20 us at 3.35 TB/s) and does ~1 flop per byte read, far
// below the ~295 flop/byte where the matrix units would take over. An
// int8/fp8 pool halves those bytes and adds 8 bytes of scales per token
// and kv head.
//
// Design (split-KV, "flash-decoding"): the TPU walks one row's pages on a
// sequential grid axis; here every (kv head, row, split of kSplitTokens
// tokens) is its own block, so a batch of 8 rows fills the card. Within a
// block each of 4 warps takes every 4th token: each lane loads its
// head_dim/32 contiguous elements of the token's K and V with one vector
// load (a warp reads the token's whole 256 B row), the q.k dot is a warp
// shuffle sum, and the warp keeps an online softmax (fp32 max, sum and
// output slice) per query head in registers. The rep = heads/kvh query
// heads of a kv head share every K/V load (GQA). The block folds its warps
// together in shared memory and writes one unnormalized partial (max, sum,
// output) per query head and split; a second small kernel merges the
// splits of each (row, head) and divides by the clamped sum.

#include <math.h>

#include <type_traits>

#include "common.cuh"

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

// the pointer and size arguments every launch passes along
struct Args {
  const void *q, *kp, *vp;
  const float *ks, *vs;
  const int *pt, *pos;
  void* out;
  float *ml, *acc;
  int b, heads, kvh, num_pages, ps, max_pages, n_splits;
  float scale;
  cudaStream_t st;
};

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

template <typename TQ, typename TKV>
int dispatch_hd(int hd, int rep, const Args& a) {
  if (hd == 32) return dispatch_rep<TQ, TKV, 1>(rep, a);
  if (hd == 64) return dispatch_rep<TQ, TKV, 2>(rep, a);
  if (hd == 128) return dispatch_rep<TQ, TKV, 4>(rep, a);
  if (hd == 256) return dispatch_rep<TQ, TKV, 8>(rep, a);
  return (int)cudaErrorInvalidValue;
}

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

// Number of token splits the wrapper must size the scratch for.
extern "C" int ptt_paged_decode_splits(int max_pages, int ps) {
  return (max_pages * ps + kSplitTokens - 1) / kSplitTokens;
}

// q/out: contiguous (b, 1, heads, hd) of q_dtype (0 fp32, 1 bf16);
// k_pool/v_pool: contiguous (kvh, num_pages, ps, hd) of kv_dtype (0 fp32,
// 1 bf16, 2 int8, 3 fp8 e4m3); k_scale/v_scale: contiguous fp32 (kvh,
// num_pages, ps, 1) for int8/fp8 pools, else null; page_table:
// (b, max_pages) int32; pos: (b,) int32; part_ml / part_acc: fp32 scratch
// of b*heads*n_splits*2 and b*heads*n_splits*hd elements, n_splits from
// ptt_paged_decode_splits. hd in {32, 64, 128, 256}, heads/kvh in
// {1, 2, 4, 8}. Returns cudaGetLastError() after the launches.
extern "C" int ptt_paged_decode(const void* q, const void* k_pool,
                                const void* v_pool, const void* k_scale,
                                const void* v_scale, const void* page_table,
                                const void* pos, void* out, void* part_ml,
                                void* part_acc, int b, int heads, int kvh,
                                int hd, int num_pages, int ps, int max_pages,
                                float scale, int q_dtype, int kv_dtype,
                                void* stream) {
  if (kvh < 1 || heads % kvh != 0 || ps < 1 || max_pages < 1)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k_pool, v_pool,
               static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(page_table),
               static_cast<const int*>(pos), out,
               static_cast<float*>(part_ml), static_cast<float*>(part_acc),
               b, heads, kvh, num_pages, ps, max_pages,
               ptt_paged_decode_splits(max_pages, ps), scale,
               static_cast<cudaStream_t>(stream)};
  const int rep = heads / kvh;
  if (q_dtype == ptt::kF32) return dispatch_kv<float>(kv_dtype, hd, rep, a);
  if (q_dtype == ptt::kBF16)
    return dispatch_kv<__nv_bfloat16>(kv_dtype, hd, rep, a);
  return (int)cudaErrorInvalidValue;
}
