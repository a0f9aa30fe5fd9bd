// Ragged paged attention for Hopper (sm_90a), plain CUDA C++ (K7).
//
// Replaces the TPU kernel `_ragged_paged_pallas` (paddle_tpu/serving/
// attention.py:659, pallas_call at :707, body `_ragged_attend_kernel` :590):
// the paged decode kernel with the batch axis replaced by a flat TOKEN axis.
// Every row of a mixed prefill/decode step puts its tokens on one (1, T)
// axis: a decode row one token, a prefill chunk a contiguous run. Token t
// attends, for each query head, the K/V pages of page-table row row_ids[t]
// up to and including its own position pos[t]. Query head h*rep + r attends
// kv head h (the reference's reshape(t, kvh, rep, hd)). Pools are fp32 or
// bf16, or int8 / fp8 e4m3 with fp32 (kvh, P, ps, 1) scale slabs: a logit
// is (q . k_q) * k_scale[slot] / sqrt(d) and the output sums p * v_scale
// [slot] * v_q, each scale read through the same page-table entry as its
// data (the reference's dequantizing form).
//
// Semantics kept from the TPU kernel at the edges: key columns past a
// token's position are masked and pages wholly past it are not read; the
// softmax denominator is clamped at 1e-30; a token parked at or past the
// table capacity (max_pages * page_size: flat-batch padding) reads nothing
// and emits zeros. What is gone: the TPU's padding of the query group to 8
// rows and of head_dim to 128 lanes, and the scalar prefetch of the page
// table, positions and row ids (each block reads its own).
//
// What bounds it on an H100: bytes. A flat step of LLaMA-7B (32 kv heads of
// 128, page 16) holding 8 decode tokens and one 256-token chunk at offset
// 512 must read each position's K and V once per layer: 16 KB a position in
// bf16, about 10 MB a layer, ~3 us at 3.35 TB/s. The TPU kernel's grid
// (token, kv head, page) re-reads a chunk's pages once per TOKEN, about
// 2.7 GB a layer for that chunk.
//
// Design (query tiles over split KV). A tiny plan, built on the device by
// the wrapper, cuts the flat axis into tiles: runs of consecutive tokens of
// one row, at most kNQ / rep tokens each. So a chunk's tokens share tiles
// and a decode token is a tile of its own. A block takes (kv head, tile,
// split of kSplit keys) and walks its tile's keys of that split in tiles of
// kKT keys: the K/V tile is loaded once into shared memory as fp32
// (dequantized on the way in) and used by all kNQ query vectors of the tile
// (its tokens times the rep query heads of the kv head), each with its own
// causal limit. Scores are one warp per query vector row and one lane per
// key, with the online softmax (fp32 max, sum) in registers; the output
// accumulates in registers, one column per thread. Each block writes one
// unnormalized partial (max, sum, output) per query vector and split; a
// second small kernel merges the splits a token reached and divides by the
// clamped sum. A chunk's pages are read once per tile of 16 tokens (L2
// catches most of the repeats), and decode tokens get split-KV parallelism
// as in the paged decode kernel. The products run on the CUDA cores (FMA),
// not the tensor cores; both inner loops read shared memory as float4, a
// K row and a probability row serving four multiply-adds per load, and
// rows that hold no token (padding of a short tile) skip their sums.

#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kNQ = 16;      // query vectors a block holds (tokens x rep)
constexpr int kKT = 32;      // keys per shared-memory tile (one per lane)
constexpr int kSplit = 256;  // keys per split of the key axis

// 8 consecutive elements of T as fp32, with one or two vector loads
template <typename T>
__device__ __forceinline__ void load8(const T* __restrict__ p, float* out) {
  if constexpr (sizeof(T) == 4) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  } else if constexpr (sizeof(T) == 2) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = ptt::to_f32(e[i]);
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = ptt::to_f32(e[i]);
  }
}

// grid (kvh, tile slots, n_splits). Tile j covers flat tokens
// [tile_starts[j], tile_starts[j + 1]) for j < *tile_count; a block walks
// tiles blockIdx.y, blockIdx.y + gridDim.y, ...
template <typename TQ, typename TKV, int HD, int REP>
__global__ void __launch_bounds__(kThreads)
    ragged_attend_kernel(const TQ* __restrict__ q,
                         const TKV* __restrict__ k_pool,
                         const TKV* __restrict__ v_pool,
                         const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale,
                         const int* __restrict__ page_table,
                         const int* __restrict__ pos_arr,
                         const int* __restrict__ row_ids,
                         const int* __restrict__ tile_starts,
                         const int* __restrict__ tile_count,
                         float* __restrict__ part_ml,
                         float* __restrict__ part_acc, int heads,
                         int num_pages, int ps, int max_pages, int rows,
                         float scale) {
  constexpr int kTok = kNQ / REP;            // tokens a tile holds
  constexpr int kRowsPerWarp = kNQ / kWarps;
  constexpr int kStride = kThreads / HD;     // rows between accumulators
  constexpr int kAcc = kNQ * HD / kThreads;  // accumulators a thread holds
  static_assert(kThreads % HD == 0, "head_dim must divide the block");
  // rows are read as float4; the K tile's row stride of HD + 4 floats keeps
  // a quarter-warp's 16-byte reads on distinct banks
  __shared__ __align__(16) float qs[kNQ][HD];
  __shared__ __align__(16) float ks[kKT][HD + 4];
  __shared__ __align__(16) float vs[kKT][HD];
  __shared__ __align__(16) float pr_s[kNQ][kKT];
  __shared__ float alpha_s[kNQ];
  __shared__ int tpos[kTok];

  const int g = blockIdx.x, split = blockIdx.z;
  const int n_splits = gridDim.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cap = max_pages * ps;
  const int count = *tile_count;
  const int k_begin = split * kSplit;
  const long long head_base = (long long)g * num_pages;
  const int col = tid % HD, row0 = tid / HD;

  for (int tile = blockIdx.y; tile < count; tile += gridDim.y) {
    const int t0 = tile_starts[tile];
    const int len = tile_starts[tile + 1] - t0;
    const int row = row_ids[t0];
    const bool row_ok = row >= 0 && row < rows;
    __syncthreads();            // the previous tile is done with smem
    if (tid < kTok) {
      // a token's position, or -1 for padding (parked at or past the
      // capacity, past the tile, or naming no table row)
      int p = -1;
      if (tid < len && row_ok) {
        p = pos_arr[t0 + tid];
        if (p < 0 || p >= cap) p = -1;
      }
      tpos[tid] = p;
    }
    __syncthreads();
    int maxpos = -1;
#pragma unroll
    for (int i = 0; i < kTok; ++i) maxpos = max(maxpos, tpos[i]);
    const int k_end = min(k_begin + kSplit, maxpos + 1);
    if (k_begin >= k_end) continue;          // the same for every thread
    const int* pt = page_table + (long long)row * max_pages;

    // query vector i: token i / REP, query head g * REP + i % REP
    for (int e = tid; e < kNQ * HD; e += kThreads) {
      const int i = e / HD, c = e % HD, tl = i / REP;
      float v = 0.f;
      if (tl < len)
        v = ptt::to_f32(q[((long long)(t0 + tl) * heads + g * REP + i % REP) *
                              HD + c]) * scale;
      qs[i][c] = v;
    }
    // which rows hold a real token: whole warps of padding skip the
    // scores, padding accumulators skip the output sums
    bool warp_live = false;
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j)
      warp_live |= tpos[(warp + kWarps * j) / REP] >= 0;
    unsigned acc_live = 0;
#pragma unroll
    for (int a = 0; a < kAcc; ++a)
      if (tpos[(row0 + kStride * a) / REP] >= 0) acc_live |= 1u << a;
    float m[kRowsPerWarp], l[kRowsPerWarp], acc[kAcc];
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      m[j] = -INFINITY;
      l[j] = 0.f;
    }
#pragma unroll
    for (int a = 0; a < kAcc; ++a) acc[a] = 0.f;

    for (int c0 = k_begin; c0 < k_end; c0 += kKT) {
      __syncthreads();          // qs written / last key tile consumed
      for (int e = tid; e < kKT * HD / 8; e += kThreads) {
        const int kj = e / (HD / 8), c = (e % (HD / 8)) * 8;
        const int key = c0 + kj;
        float kk[8], vv[8];
        if (key < k_end) {
          const long long slot = (head_base + pt[key / ps]) * ps + key % ps;
          load8(k_pool + slot * HD + c, kk);
          load8(v_pool + slot * HD + c, vv);
          if constexpr (ptt::kQuantized<TKV>) {
            const float ksc = k_scale[slot], vsc = v_scale[slot];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              kk[i] *= ksc;
              vv[i] *= vsc;
            }
          }
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) kk[i] = vv[i] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          ks[kj][c + i] = kk[i];
          vs[kj][c + i] = vv[i];
        }
      }
      __syncthreads();
      // scores and the online softmax: warp w owns rows w + kWarps * j,
      // lane = key. A key past a token's position is masked; keys of the
      // next split never occur (c0 + lane < k_begin + kSplit).
      const int key = c0 + lane;
      float sc[kRowsPerWarp];
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) sc[j] = 0.f;
      if (warp_live) {            // a warp whose rows are all padding skips
        const float4* krow = reinterpret_cast<const float4*>(ks[lane]);
#pragma unroll 4
        for (int c4 = 0; c4 < HD / 4; ++c4) {
          const float4 k4 = krow[c4];
#pragma unroll
          for (int j = 0; j < kRowsPerWarp; ++j) {
            const float4 q4 =
                reinterpret_cast<const float4*>(qs[warp + kWarps * j])[c4];
            sc[j] = fmaf(q4.x, k4.x, sc[j]);
            sc[j] = fmaf(q4.y, k4.y, sc[j]);
            sc[j] = fmaf(q4.z, k4.z, sc[j]);
            sc[j] = fmaf(q4.w, k4.w, sc[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) {
        const int i = warp + kWarps * j;
        const int p = tpos[i / REP];
        const float s = (p >= 0 && key <= p) ? sc[j] : -INFINITY;
        const float m_new = fmaxf(m[j], ptt::warp_max(s));
        const float m_safe = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = m[j] == -INFINITY ? 0.f : expf(m[j] - m_safe);
        const float pr = s == -INFINITY ? 0.f : expf(s - m_safe);
        l[j] = l[j] * alpha + ptt::warp_sum(pr);
        m[j] = m_new;
        pr_s[i][lane] = pr;
        if (lane == 0) alpha_s[i] = alpha;
      }
      __syncthreads();
      // output: thread owns column `col` of rows row0 + kStride * a
#pragma unroll
      for (int a = 0; a < kAcc; ++a) acc[a] *= alpha_s[row0 + kStride * a];
#pragma unroll 2
      for (int k4 = 0; k4 < kKT / 4; ++k4) {
        const float v0 = vs[4 * k4][col], v1 = vs[4 * k4 + 1][col];
        const float v2 = vs[4 * k4 + 2][col], v3 = vs[4 * k4 + 3][col];
#pragma unroll
        for (int a = 0; a < kAcc; ++a) {
          if (!((acc_live >> a) & 1u)) continue;   // padding row: p == 0
          const float4 p4 = reinterpret_cast<const float4*>(
              pr_s[row0 + kStride * a])[k4];
          acc[a] = fmaf(p4.x, v0, acc[a]);
          acc[a] = fmaf(p4.y, v1, acc[a]);
          acc[a] = fmaf(p4.z, v2, acc[a]);
          acc[a] = fmaf(p4.w, v3, acc[a]);
        }
      }
    }

    // one partial per query vector of a token that reaches this split
#pragma unroll
    for (int a = 0; a < kAcc; ++a) {
      const int i = row0 + kStride * a, tl = i / REP;
      if (tpos[tl] >= k_begin) {
        const long long prow =
            ((long long)(t0 + tl) * heads + g * REP + i % REP) * n_splits +
            split;
        part_acc[prow * HD + col] = acc[a];
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) {
        const int i = warp + kWarps * j, tl = i / REP;
        if (tpos[tl] >= k_begin) {
          const long long prow =
              ((long long)(t0 + tl) * heads + g * REP + i % REP) * n_splits +
              split;
          part_ml[prow * 2] = m[j];
          part_ml[prow * 2 + 1] = l[j];
        }
      }
    }
  }
}

// grid (heads, T), head_dim threads: merge the splits token t reached;
// parked tokens write zeros
template <typename TQ>
__global__ void ragged_merge_kernel(const float* __restrict__ part_ml,
                                    const float* __restrict__ part_acc,
                                    const int* __restrict__ pos_arr,
                                    const int* __restrict__ row_ids,
                                    TQ* __restrict__ out, int heads, int hd,
                                    int n_splits, int cap, int rows) {
  const int h = blockIdx.x, t = blockIdx.y, c = threadIdx.x;
  const int p = pos_arr[t], row = row_ids[t];
  float val = 0.f;
  if (p >= 0 && p < cap && row >= 0 && row < rows) {
    const int used = min(n_splits, p / kSplit + 1);
    const long long row0 = ((long long)t * heads + h) * n_splits;
    float mx = -INFINITY;
    for (int s = 0; s < used; ++s) mx = fmaxf(mx, part_ml[(row0 + s) * 2]);
    float sum_l = 0.f, sum_a = 0.f;
    for (int s = 0; s < used; ++s) {
      const float ms = part_ml[(row0 + s) * 2];
      const float f = ms == -INFINITY ? 0.f : expf(ms - mx);
      sum_l += part_ml[(row0 + s) * 2 + 1] * f;
      sum_a += part_acc[(row0 + s) * hd + c] * f;
    }
    val = sum_a / fmaxf(sum_l, 1e-30f);
  }
  out[((long long)t * heads + h) * hd + c] = ptt::from_f32<TQ>(val);
}

struct Args {
  const void *q, *kp, *vp;
  const float *ks, *vs;
  const int *pt, *pos, *rows_ids, *tile_starts, *tile_count;
  float *ml, *acc;
  void* out;
  int t, heads, kvh, num_pages, ps, max_pages, rows, grid_tiles, n_splits;
  float scale;
  cudaStream_t st;
};

template <typename TQ, typename TKV, int HD, int REP>
int launch(const Args& a) {
  dim3 grid(a.kvh, a.grid_tiles, a.n_splits);
  ragged_attend_kernel<TQ, TKV, HD, REP><<<grid, kThreads, 0, a.st>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.kp),
      static_cast<const TKV*>(a.vp), a.ks, a.vs, a.pt, a.pos, a.rows_ids,
      a.tile_starts, a.tile_count, a.ml, a.acc, a.heads, a.num_pages, a.ps,
      a.max_pages, a.rows, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ragged_merge_kernel<TQ><<<dim3(a.heads, a.t), HD, 0, a.st>>>(
      a.ml, a.acc, a.pos, a.rows_ids, static_cast<TQ*>(a.out), a.heads, HD,
      a.n_splits, a.max_pages * a.ps, a.rows);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV, int HD>
int dispatch_rep(int rep, const Args& a) {
  if (rep == 1) return launch<TQ, TKV, HD, 1>(a);
  if (rep == 2) return launch<TQ, TKV, HD, 2>(a);
  if (rep == 4) return launch<TQ, TKV, HD, 4>(a);
  if (rep == 8) return launch<TQ, TKV, HD, 8>(a);
  return (int)cudaErrorInvalidValue;
}

template <typename TQ, typename TKV>
int dispatch_hd(int hd, int rep, const Args& a) {
  if (hd == 64) return dispatch_rep<TQ, TKV, 64>(rep, a);
  if (hd == 128) return dispatch_rep<TQ, TKV, 128>(rep, a);
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

// Number of key splits the wrapper must size the partials for.
extern "C" int ptt_ragged_paged_splits(int max_pages, int ps) {
  return (max_pages * ps + kSplit - 1) / kSplit;
}

// Most tokens a query tile holds for heads / kv_heads = rep (0: rep not
// taken).
extern "C" int ptt_ragged_paged_tile(int rep) {
  return (rep == 1 || rep == 2 || rep == 4 || rep == 8) ? kNQ / rep : 0;
}

// q/out: contiguous (1, T, heads, hd) of q_dtype (0 fp32, 1 bf16);
// k_pool/v_pool: contiguous (kvh, num_pages, ps, hd) of kv_dtype (0 fp32,
// 1 bf16, 2 int8, 3 fp8 e4m3); k_scale/v_scale: contiguous fp32
// (kvh, num_pages, ps, 1) for int8/fp8 pools, else null; page_table:
// (rows, max_pages) int32; pos, row_ids: (T,) int32; tile_starts: (T + 2,)
// int32 and tile_count: (1,) int32, the plan (tiles of at most
// ptt_ragged_paged_tile(rep) tokens of one row, tile_starts[count] == T);
// part_ml / part_acc: fp32 scratch of T*heads*n_splits*2 and
// T*heads*n_splits*hd elements, n_splits from ptt_ragged_paged_splits;
// grid_tiles: the blocks along the tile axis (each walks tiles
// blockIdx.y + k * grid_tiles). hd in {64, 128}, heads/kvh in {1, 2, 4, 8}.
// Returns cudaGetLastError() after the launches.
extern "C" int ptt_ragged_paged(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* pos, const void* row_ids, const void* tile_starts,
    const void* tile_count, void* part_ml, void* part_acc, void* out, int t,
    int heads, int kvh, int hd, int num_pages, int ps, int max_pages,
    int rows, int grid_tiles, float scale, int q_dtype, int kv_dtype,
    void* stream) {
  if (t < 1 || kvh < 1 || heads % kvh != 0 || ps < 1 || max_pages < 1 ||
      rows < 1 || grid_tiles < 1 || grid_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k_pool, v_pool,
               static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(page_table),
               static_cast<const int*>(pos),
               static_cast<const int*>(row_ids),
               static_cast<const int*>(tile_starts),
               static_cast<const int*>(tile_count),
               static_cast<float*>(part_ml), static_cast<float*>(part_acc),
               out, t, heads, kvh, num_pages, ps, max_pages, rows, grid_tiles,
               ptt_ragged_paged_splits(max_pages, ps), scale,
               static_cast<cudaStream_t>(stream)};
  const int rep = heads / kvh;
  if (q_dtype == ptt::kF32) return dispatch_kv<float>(kv_dtype, hd, rep, a);
  if (q_dtype == ptt::kBF16)
    return dispatch_kv<__nv_bfloat16>(kv_dtype, hd, rep, a);
  return (int)cudaErrorInvalidValue;
}
