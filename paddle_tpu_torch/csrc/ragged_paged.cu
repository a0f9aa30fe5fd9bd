// Ragged paged attention for Hopper (sm_90a), plain CUDA C++ (K7, and its
// dequantizing form K7q).
//
// Replaces the TPU kernel `_ragged_paged_pallas` (paddle_tpu/serving/
// attention.py:659, pallas_call at :707, body `_ragged_attend_kernel` :590):
// the paged decode kernel with the batch axis replaced by a flat TOKEN axis.
// Every row of a mixed prefill/decode step puts its tokens on one (1, T)
// axis: a decode row one token, a prefill chunk a contiguous run. Token t
// attends, for each query head, the K/V pages of page-table row row_ids[t]
// up to and including its own position pos[t]. Query head h*rep + r attends
// kv head h. Pools are bf16 or fp32, or int8 / fp8 e4m3 with fp32 (kvh, P,
// ps, 1) scale slabs (the reference's dequantizing form).
//
// Semantics kept from the TPU kernel at the edges: key columns past a
// token's position are masked and pages wholly past it are not read; the
// softmax denominator is clamped at 1e-30; a token parked at or past the
// table capacity (max_pages * page_size: flat-batch padding), or naming no
// table row, reads nothing and emits zeros. What is gone: the TPU's padding
// of the query group to 8 rows and of head_dim to 128 lanes, the scalar
// prefetch, and the grid (token, kv head, page) that re-reads a chunk's
// pages once per token.
//
// What bounds it on an H100: bytes. On the flat step of the chunked
// LLaMA-7B serve (32 kv heads of 128, page 16; 8 decode tokens at positions
// spread over 0..1023 and one 256-token chunk at 512..767) one call must
// read 4865 positions of K and V, 79.7 MB in bf16 (23.8 us at 3.35 TB/s):
// 4097 of them (84%) are the decode tokens', exactly the paged decode
// kernel's shape. The chunk adds 2.75 GFLOP of products (2.8 us on bf16
// tensor cores, 41 us at the whole fp32 FMA rate).
//
// Design: a plan, built on the device by the wrapper, cuts the flat axis
// into query tiles of one row's consecutive tokens, at most kTileRows (64)
// query vectors (tokens x rep) each; a run longer than that is cut into
// nearly equal tiles, so a tile of one token is exactly a token alone in its
// run (a decode token). One launch, grid (kv head, tile slot, split of 128
// keys), takes both kinds of tile:
//   - a one-token tile is the decode walk of paged_common.cuh, split-KV as
//     in the paged decode kernel, its splits merged by the last to arrive;
//   - a longer tile is walked by one warpgroup on wgmma (the flash
//     kernels' helpers), whole, by the block of split 0, without a key
//     split, wherever the launch's live tiles give at least half as many
//     (tile, kv head) pairs as the card has SMs; below that (a short run at
//     a deep position with few other tiles) the tile is split like a decode
//     token, a block a split, and the last split to arrive merges. Q and
//     32-key K / V tiles are gathered page by page with cp.async into
//     128-byte-swizzled shared memory (3 stages), S = Q K^T and O += P V
//     (P from registers) with the online softmax per row in registers;
//     each row has its own causal limit, and the element mask runs only on
//     key tiles that reach past the tile's first position. Over bf16 pools
//     p is rounded to bf16 before P V, as the reference rounds it; over
//     int8 / fp8 pools each staged tile is converted (exactly) to a bf16 K
//     tile and an fp16 V tile, k_scale multiplies S's columns and P's
//     columns are multiplied by v_scale over the key tile's largest
//     v_scale and split into two fp16 terms (hi + lo, two products: fp32's
//     accuracy, where one fp16 term moved outputs of magnitude 2-4 by a
//     bf16 rounding, 0.0156, past the 1e-2 limit). A tile walked whole
//     writes its output directly: no partials.
// wgmma rather than mma.sync: mma.sync tiles spent ~1.3 us a 32-key tile
// in their issue chain and took 0.048 ms for the chunk alone (PERF.md).
// The registers are capped for three blocks an SM, so the decode
// walk of the same kernel keeps the paged decode kernel's occupancy. Each
// (pool type, head_dim, rep) is its own instantiation.
//
// The fp32 forms (fp32 q or fp32 pools) keep the FMA kernels of the first
// port: tiles of at most kNQ query vectors over split KV (kSplit keys), the
// K / V tile in shared memory as fp32, scores a lane per key, the output a
// column per thread, and a second kernel merging the splits.

#include <math.h>

#include <type_traits>

#include "paged_common.cuh"

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

// ------------------------------------------------ the tensor-core tile
// Query tiles of 2 or more tokens (at most kTileRows query vectors: tokens
// times rep) walk all their keys as one warpgroup on wgmma, without a key
// split. S = Q K^T (both operands in shared memory) and O += P V (P from
// registers) in the layouts of the flash kernels (flash_fwd.cu): bf16 rows
// in boxes of 64 columns (128 bytes), 128-byte swizzled, every box on a
// 1024-byte boundary. The pages are gathered by cp.async, 16 bytes at the
// swizzled place.
constexpr int kTileRows = 64;   // = RAGGED_TILE_ROWS in serving/attention.py
constexpr int kKeyTile = 32;    // keys a staged K / V tile holds
constexpr int kTileStages = 3;  // staged K / V tiles (2 in flight)
// threads that load one key's K and V rows
constexpr int kTPK = ptt::paged::kThreads / kKeyTile;
// blocks an SM holds: the tile's registers are capped so that the decode
// walk's blocks of the same kernel keep three an SM, as in the paged decode
// kernel (its shared memory allows three)
constexpr int kBlocksPerSM = 3;

// byte offset of 16-byte piece `piece` (8 bf16 columns) of row `row` in a
// tile of `rows` rows: box piece / 8, 128-byte swizzle inside the box
__device__ __forceinline__ int swz(int row, int piece, int rows) {
  return (piece >> 3) * rows * 128 + row * 128 +
         (((piece & 7) ^ (row & 7)) << 4);
}

constexpr int align_up(int x, int a) { return (x + a - 1) / a * a; }

// Shared memory of chunk_tile (from a 1024-byte aligned base). bf16 pools
// are staged straight into the swizzled boxes wgmma reads; int8 / fp8 pools
// are staged as raw rows (padded by 16 bytes) with their scales and
// converted tile by tile into a bf16 K tile and an fp16 V tile.
template <typename TKV, int HD>
struct TileSmem {
  static constexpr bool kQuant = ptt::kQuantized<TKV>;
  static constexpr int kStages = kTileStages;
  static constexpr int kRawRow = HD + 16;  // quantized staged rows
  static constexpr int kTileB = kQuant ? kKeyTile * kRawRow
                                       : kKeyTile * HD * 2;
  static constexpr int kStage = 2 * kTileB + (kQuant ? 2 * kKeyTile * 4 : 0);
  static constexpr int kQ = 0;
  static constexpr int kStage0 = kQ + kTileRows * HD * 2;
  static constexpr int kConvK =
      align_up(kStage0 + kStages * kStage, 1024);
  static constexpr int kConvV = kConvK + (kQuant ? kKeyTile * HD * 2 : 0);
  static constexpr int kPos = kConvV + (kQuant ? kKeyTile * HD * 2 : 0);
  static constexpr int kFlag = kPos + kTileRows * 4;  // the last to arrive
  static constexpr int kMerge = kFlag + 16;  // its rows' max and 1 / sum
  static constexpr int kBytes = kMerge + 2 * kTileRows * 4 + 1024;
  static_assert(kQuant || kStage % 1024 == 0, "boxes on 1024 bytes");
};

// The pool slot of this thread's key (threadIdx.x / kTPK) in key tile kt,
// or -1 past n_keys (a page-table read; reading it a tile ahead was no
// faster, PERF.md)
__device__ __forceinline__ int tile_slot(int kt, int n_keys,
                                         const int* __restrict__ pt,
                                         long long head_base, int ps) {
  const int kk = kt * kKeyTile + (int)threadIdx.x / kTPK;
  return kk < n_keys ? (int)((head_base + pt[kk / ps]) * ps + kk % ps) : -1;
}

// Issue the cp.async loads of a key tile into `stage`: kTPK threads a key,
// each a share of its K and V rows (at `slot`, from tile_slot); keys past
// the tile's end (slot -1) zero-filled
template <typename TKV, int HD>
__device__ __forceinline__ void issue_tile(
    unsigned char* stage, int slot, const TKV* __restrict__ k_pool,
    const TKV* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale) {
  using L = TileSmem<TKV, HD>;
  constexpr int kPieces = HD * (int)sizeof(TKV) / 16;
  constexpr int kEl = 16 / (int)sizeof(TKV);
  static_assert(kPieces % kTPK == 0, "a key's pieces split evenly");
  const int key = threadIdx.x / kTPK, part = threadIdx.x % kTPK;
  const bool ok = slot >= 0;
  slot = ok ? slot : 0;
#pragma unroll
  for (int j = 0; j < kPieces / kTPK; ++j) {
    const int piece = part * (kPieces / kTPK) + j;
    const int off = L::kQuant ? key * L::kRawRow + piece * 16
                              : swz(key, piece, kKeyTile);
    const long long src = (long long)slot * HD + piece * kEl;
    ptt::sm90::cp_async_16(stage + off, k_pool + (ok ? src : 0),
                           ok ? 16 : 0);
    ptt::sm90::cp_async_16(stage + L::kTileB + off, v_pool + (ok ? src : 0),
                           ok ? 16 : 0);
  }
  if constexpr (L::kQuant) {
    if (part == 0) {
      float* sc = reinterpret_cast<float*>(stage + 2 * L::kTileB);
      ptt::sm90::cp_async_4(sc + key, k_scale + slot, ok);
      ptt::sm90::cp_async_4(sc + kKeyTile + key, v_scale + slot, ok);
    }
  }
}

// int8 / fp8 staged rows -> the bf16 K tile and the fp16 V tile (exact)
template <typename TKV, int HD>
__device__ __forceinline__ void convert_tile(unsigned char* smem,
                                             const unsigned char* stage) {
  using L = TileSmem<TKV, HD>;
  namespace pg = ptt::paged;
  constexpr int kPieces = HD / 16;  // raw 16-byte pieces a row
  static_assert(kPieces % kTPK == 0, "a key's pieces split evenly");
  const int key = threadIdx.x / kTPK, part = threadIdx.x % kTPK;
#pragma unroll
  for (int j = 0; j < kPieces / kTPK; ++j) {
    const int piece = part * (kPieces / kTPK) + j;
#pragma unroll
    for (int kv = 0; kv < 2; ++kv) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          stage + kv * L::kTileB + key * L::kRawRow + piece * 16);
      float f[16];
      pg::piece_to_f32<TKV>(raw, f);
      uint32_t w[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        w[i] = kv ? pg::pack_f16(f[2 * i], f[2 * i + 1])
                  : ptt::sm90::pack_bf16(f[2 * i], f[2 * i + 1]);
      unsigned char* dst = smem + (kv ? L::kConvV : L::kConvK);
      *reinterpret_cast<uint4*>(dst + swz(key, 2 * piece, kKeyTile)) =
          make_uint4(w[0], w[1], w[2], w[3]);
      *reinterpret_cast<uint4*>(dst + swz(key, 2 * piece + 1, kKeyTile)) =
          make_uint4(w[4], w[5], w[6], w[7]);
    }
  }
}

// One key tile of the warpgroup's 64 query vectors: S = Q K^T, the online
// softmax, O += P V. Thread t holds rows 16 (t / 32) + (t % 32) / 4 (row a)
// and + 8 (row b); register i of an accumulator is column 8 (i / 4) + 2 (t
// % 4) + i % 2 of row a when (i / 2) % 2 == 0, else of row b. kMask: keys
// past a row's position are masked (only tiles that reach past the tile's
// first live position need it).
template <typename TKV, int HD, bool kMask>
__device__ __forceinline__ void tile_step(
    const unsigned char* q_s, const unsigned char* kt_s,
    const unsigned char* vt_s, const float* ksc, const float* vsc, int k0,
    int lim_a, int lim_b, float scale_log2, float (&m)[2], float (&l)[2],
    float& vscale, float (&o)[HD / 2]) {
  using namespace ptt::sm90;
  namespace pg = ptt::paged;
  constexpr bool kQuant = ptt::kQuantized<TKV>;
  const int lane = threadIdx.x & 31, quad = lane & 3;
  float s[kKeyTile / 2];
#pragma unroll
  for (int i = 0; i < kKeyTile / 2; ++i) s[i] = 0.f;
  // S over head_dim in k-steps of 16 (32 bytes inside a 128-byte box)
  fence_regs(s);
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int x = kk / 4, off = (kk % 4) * 2;
    const uint64_t dq = desc_sw128(q_s + x * kTileRows * 128, 16, 1024) + off;
    const uint64_t dk = desc_sw128(kt_s + x * kKeyTile * 128, 16, 1024) + off;
    pg::wgmma_ss_n32(s, dq, dk, kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);

  // logits in log2 units, masked
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < kKeyTile / 2; ++i) {
    const int h = (i >> 1) & 1, kc = 8 * (i >> 2) + 2 * quad + (i & 1);
    float v = s[i] * scale_log2;
    if constexpr (kQuant) v *= ksc[kc];
    if constexpr (kMask) {
      if (k0 + kc > (h ? lim_b : lim_a)) v = -INFINITY;
    }
    s[i] = v;
    mx[h] = fmaxf(mx[h], v);
  }
  // over int8 / fp8 pools O is kept in units of `vscale`, the largest
  // v_scale of the latest key tile: P's columns are p * v_scale / vscale
  // <= 1 (exactly p for the key of the largest scale)
  float ratio = 1.f, vt = 1.f;
  if constexpr (kQuant) {
    vt = ptt::warp_max(vsc[lane % kKeyTile]);  // > 0: key k0 is live
    ratio = vscale / vt;
    vscale = vt;
  }
  float alpha[2], msafe[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float mn = fmaxf(m[h], mx[h]);
    msafe[h] = mn == -INFINITY ? 0.f : mn;
    alpha[h] = ex2(m[h] - msafe[h]);
    m[h] = mn;
    l[h] *= alpha[h];
  }
  const float ra = alpha[0] * ratio, rb = alpha[1] * ratio;
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] *= ((i >> 1) & 1) ? rb : ra;
  // P as the A operand of P V, k-step k = registers 8k .. 8k+7 as pairs:
  // over bf16 pools p in bf16, as the reference rounds it; over int8 / fp8
  // pools p * v_scale / vscale as the sum of two fp16 terms (hi + lo: 22
  // bits, so P V keeps fp32's accuracy where one fp16 would flip bf16
  // roundings of the output)
  uint32_t pa[kKeyTile / 16][4], pl[kQuant ? kKeyTile / 16 : 1][4];
#pragma unroll
  for (int i = 0; i < kKeyTile / 2; i += 2) {
    const int h = (i >> 1) & 1, kc = 8 * (i >> 2) + 2 * quad;
    const float p0 = ex2(s[i] - msafe[h]), p1 = ex2(s[i + 1] - msafe[h]);
    l[h] += p0 + p1;
    if constexpr (kQuant) {
      const float x0 = p0 * (vsc[kc] / vt), x1 = p1 * (vsc[kc + 1] / vt);
      const __half2 hi = __floats2half2_rn(x0, x1);
      pa[i >> 3][(i >> 1) & 3] = *reinterpret_cast<const uint32_t*>(&hi);
      pl[i >> 3][(i >> 1) & 3] =
          pg::pack_f16(x0 - __low2float(hi), x1 - __high2float(hi));
    } else {
      pa[i >> 3][(i >> 1) & 3] = pack_bf16(p0, p1);
    }
  }
  fence_regs(o);
  fence_regs(pa);
  if constexpr (kQuant) fence_regs(pl);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < kKeyTile / 16; ++k) {
    const uint64_t dv = desc_sw128(vt_s + k * 16 * 128, kKeyTile * 128, 1024);
    if constexpr (kQuant) {
      if constexpr (HD == 64) {
        pg::wgmma_rs_n64_f16(o, pa[k], dv);
        pg::wgmma_rs_n64_f16(o, pl[k], dv);
      } else {
        pg::wgmma_rs_n128_f16(o, pa[k], dv);
        pg::wgmma_rs_n128_f16(o, pl[k], dv);
      }
    } else {
      if constexpr (HD == 64)
        wgmma_rs_n64(o, pa[k], dv);
      else
        wgmma_rs_n128(o, pa[k], dv);
    }
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(o);
}

// The key split a tensor-core tile's block takes. With `on` (the launch's
// live tiles are too few to fill half the card), a tile whose keys span more
// than one split of kSplit keys is walked split by split: block `sp` takes
// keys sp * kSplit .. + kSplit - 1, writes the partials (max, sum,
// unnormalized output) of the rows that reach them in the decode walk's
// layout, and the last split to arrive merges them in split order. Else
// the block of split 0 walks every key and writes the outputs.
struct TileSplit {
  int sp;
  bool on;
  float* part_ml;   // (token, head, split) rows, as in WalkItem
  float* part_acc;
  int n_splits;
  int* counter;     // arrival counter of (the tile's first token, kv head)
};

// A split tile's end (TileSplit): its rows' partials, then the merge by
// the last split to arrive, as in the decode walk: the block's writes, a
// barrier, one thread's fence and arrival (release); the last arrival's
// fence (acquire) and a barrier before its reads, which go to L2 (ld.cg).
// The merge takes each row's largest max and merged sum first, a thread a
// row, then the outputs four columns a thread, so every thread has its
// splits' loads in flight together. Row r of the tile (thread layout of
// tile_step) is token r / REP, query head g * REP + r % REP; tokens past
// `len` are not the tile's.
template <int HD, int REP>
__device__ __forceinline__ void tile_partials(
    unsigned char* flag_s, float* merge_s, const int* tpos,
    const float (&o)[HD / 2],
    const float (&m)[2], const float (&l)[2], float vscale,
    __nv_bfloat16* __restrict__ out, int t0, int len, int g, int heads,
    int k_lo, int maxp, const TileSplit& ks) {
  constexpr int kSplit = ptt::paged::kSplit;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + (lane >> 2) + 8 * h;
    if (r / REP >= len || tpos[r / REP] < k_lo) continue;  // no key here
    const long long row =
        ((long long)(t0 + r / REP) * heads + g * REP + r % REP) *
            ks.n_splits + ks.sp;
    float* dst = ks.part_acc + row * HD + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) =
          make_float2(o[4 * n + 2 * h] * vscale,
                      o[4 * n + 2 * h + 1] * vscale);
    if ((lane & 3) == 0) {
      ks.part_ml[2 * row] = m[h];
      ks.part_ml[2 * row + 1] = l[h];
    }
  }
  __syncthreads();
  int* flag = reinterpret_cast<int*>(flag_s);
  if (tid == 0) {
    __threadfence();
    const bool last = atomicAdd(ks.counter, 1) == maxp / kSplit;
    if (last) __threadfence();
    *flag = last;
  }
  __syncthreads();
  if (*flag) {
    const int n_rows = len * REP;
    auto head_row = [&](int r) {
      return (long long)(t0 + r / REP) * heads + g * REP + r % REP;
    };
    if (tid < n_rows) {
      const int lim = tpos[tid / REP];
      float mx = -INFINITY, inv = 0.f;
      if (lim >= 0) {
        const int n = lim / kSplit + 1;
        const float* ml = ks.part_ml + head_row(tid) * ks.n_splits * 2;
        for (int s = 0; s < n; ++s) mx = fmaxf(mx, __ldcg(ml + 2 * s));
        float sum = 0.f;
        for (int s = 0; s < n; ++s)
          sum += __ldcg(ml + 2 * s + 1) *
                 ptt::sm90::ex2(__ldcg(ml + 2 * s) - mx);
        inv = 1.f / fmaxf(sum, 1e-30f);
      }
      merge_s[tid] = mx;
      merge_s[kTileRows + tid] = inv;
    }
    __syncthreads();
    constexpr int kQuads = HD / 4;
    for (int e = tid; e < n_rows * kQuads; e += ptt::paged::kThreads) {
      const int r = e / kQuads, c4 = e % kQuads, lim = tpos[r / REP];
      const long long hq = head_row(r);
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      if (lim >= 0) {
        const int n = lim / kSplit + 1;
        const float mx = merge_s[r], inv = merge_s[kTileRows + r];
        const float* ml = ks.part_ml + hq * ks.n_splits * 2;
        const float4* acc = reinterpret_cast<const float4*>(
                                ks.part_acc + hq * ks.n_splits * HD) + c4;
#pragma unroll 8
        for (int s = 0; s < n; ++s) {
          const float f = ptt::sm90::ex2(__ldcg(ml + 2 * s) - mx);
          const float4 x = __ldcg(acc + s * kQuads);
          a.x += x.x * f;
          a.y += x.y * f;
          a.z += x.z * f;
          a.w += x.w * f;
        }
        a = make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv);
      }
      *reinterpret_cast<uint2*>(out + hq * HD + 4 * c4) =
          make_uint2(ptt::sm90::pack_bf16(a.x, a.y),
                     ptt::sm90::pack_bf16(a.z, a.w));
    }
    if (tid == 0) *ks.counter = 0;
  }
  PTT_STAMP(13, 0);
  __syncthreads();
}

// A query tile of len >= 2 tokens t0 .. t0+len-1 of one table row.
template <typename TKV, int HD, int REP>
__device__ __forceinline__ void chunk_tile(
    unsigned char* smem_raw, const __nv_bfloat16* __restrict__ q,
    const TKV* __restrict__ k_pool, const TKV* __restrict__ v_pool,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ pt, const int* __restrict__ pos_arr,
    __nv_bfloat16* __restrict__ out, int t0, int len, bool row_ok, int cap,
    int g, int heads, long long head_base, int ps, float scale,
    const TileSplit& ks) {
  using L = TileSmem<TKV, HD>;
  constexpr int kSplit = ptt::paged::kSplit;
  constexpr int kTok = kTileRows / REP;  // tokens a tile holds at most
  constexpr int kPieces = HD / 8;        // 16-byte pieces of a bf16 row
  unsigned char* smem = ptt::sm90::align1024(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int* tpos = reinterpret_cast<int*>(smem + L::kPos);
  if (tid < kTok) {
    // a token's position, or -1: padding, parked at or past the capacity,
    // or naming no table row
    int p = -1;
    if (tid < len && row_ok) {
      p = pos_arr[t0 + tid];
      if (p < 0 || p >= cap) p = -1;
    }
    tpos[tid] = p;
  }
  // Q by cp.async, in flight with the first key tiles: query vector i is
  // token i / REP, query head g * REP + i % REP; rows past the tile zero
  for (int e = tid; e < kTileRows * kPieces; e += ptt::paged::kThreads) {
    const int i = e / kPieces, piece = e % kPieces, tl = i / REP;
    const __nv_bfloat16* src =
        tl < len ? q + ((long long)(t0 + tl) * heads + g * REP + i % REP) *
                           HD + piece * 8
                 : q;
    ptt::sm90::cp_async_16(smem + L::kQ + swz(i, piece, kTileRows), src,
                           tl < len ? 16 : 0);
  }
  ptt::sm90::cp_async_commit();
  __syncthreads();
  int maxp = -1, minp = cap;
#pragma unroll 4
  for (int i = 0; i < kTok; ++i) {
    const int p = tpos[i];
    if (p >= 0) {
      maxp = max(maxp, p);
      minp = min(minp, p);
    }
  }
  const int ra = warp * 16 + (lane >> 2), rb = ra + 8;
  const int lim_a = ra / REP < len ? tpos[ra / REP] : -1;
  const int lim_b = rb / REP < len ? tpos[rb / REP] : -1;
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, vscale = 1.f;
  // this block's keys [k_lo, k_hi): one split of them (`part`), or all
  const bool part = ks.on && maxp >= kSplit;
  const int k_lo = part ? ks.sp * kSplit : 0;
  if (part ? k_lo > maxp : ks.sp != 0) {  // no key of this split
    ptt::paged::cp_async_wait<0>();
    __syncthreads();
    return;
  }
  const int k_hi = part ? min(maxp + 1, k_lo + kSplit) : maxp + 1;
  PTT_STAMP(11, tpos[0]);

  if (maxp >= 0) {
    const float scale_log2 = scale * ptt::paged::kLog2e;
    const int kt0 = k_lo / kKeyTile;
    const int n_kt = (k_hi + kKeyTile - 1) / kKeyTile;
    unsigned char* stages = smem + L::kStage0;
#pragma unroll
    for (int s = 0; s < L::kStages - 1; ++s) {
      if (kt0 + s < n_kt)
        issue_tile<TKV, HD>(stages + s * L::kStage,
                            tile_slot(kt0 + s, k_hi, pt, head_base, ps),
                            k_pool, v_pool, k_scale, v_scale);
      ptt::sm90::cp_async_commit();
    }
    for (int kt = kt0; kt < n_kt; ++kt) {
      ptt::paged::cp_async_wait<L::kStages - 2>();
      ptt::sm90::fence_proxy_async();  // cp.async writes, wgmma reads
      __syncthreads();
      const int nk = kt + L::kStages - 1;
      if (nk < n_kt)
        issue_tile<TKV, HD>(stages + ((nk - kt0) % L::kStages) * L::kStage,
                            tile_slot(nk, k_hi, pt, head_base, ps), k_pool,
                            v_pool, k_scale, v_scale);
      ptt::sm90::cp_async_commit();
      const unsigned char* stage =
          stages + ((kt - kt0) % L::kStages) * L::kStage;
      const unsigned char* kt_s = stage;
      const unsigned char* vt_s = stage + L::kTileB;
      const float* sc = reinterpret_cast<const float*>(stage + 2 * L::kTileB);
      if constexpr (L::kQuant) {
        convert_tile<TKV, HD>(smem, stage);
        ptt::sm90::fence_proxy_async();
        __syncthreads();
        kt_s = smem + L::kConvK;
        vt_s = smem + L::kConvV;
      }
      const int k0 = kt * kKeyTile;
      if (k0 + kKeyTile - 1 <= minp)
        tile_step<TKV, HD, false>(smem + L::kQ, kt_s, vt_s, sc,
                                  sc + kKeyTile, k0, lim_a, lim_b,
                                  scale_log2, m, l, vscale, o);
      else
        tile_step<TKV, HD, true>(smem + L::kQ, kt_s, vt_s, sc, sc + kKeyTile,
                                 k0, lim_a, lim_b, scale_log2, m, l, vscale,
                                 o);
    }
  }
  ptt::paged::cp_async_wait<0>();  // Q's group too, when no key tile ran
  PTT_STAMP(12, __float_as_uint(o[0]));

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  if (part) {
    tile_partials<HD, REP>(smem + L::kFlag,
                           reinterpret_cast<float*>(smem + L::kMerge), tpos,
                           o, m, l, vscale, out, t0, len, g, heads, k_lo,
                           maxp, ks);
    return;
  }
  // outputs: live rows O / sum, the rows of parked tokens zeros
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = h ? rb : ra, lim = h ? lim_b : lim_a;
    if (r / REP >= len) continue;
    const float inv = 1.f / fmaxf(l[h], 1e-30f);
    __nv_bfloat16* dst =
        out + ((long long)(t0 + r / REP) * heads + g * REP + r % REP) * HD +
        2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const uint32_t w =
          lim >= 0 ? ptt::sm90::pack_bf16(o[4 * n + 2 * h] * vscale * inv,
                                          o[4 * n + 2 * h + 1] * vscale * inv)
                   : 0u;
      *reinterpret_cast<uint32_t*>(dst + 8 * n) = w;
    }
  }
  PTT_STAMP(13, 0);
  __syncthreads();
}

// grid (kvh, tile slots, n_splits): tile j covers flat tokens
// [tile_starts[j], tile_starts[j + 1]) for j < tile_count[0], of which
// tile_count[1] are live; a block walks tiles blockIdx.y, blockIdx.y +
// gridDim.y, ... A tile of one token is the decode walk of split
// blockIdx.z (paged_common.cuh); a longer tile is the tensor-core tile,
// taken whole by the blocks of split 0 or, when the live tiles give fewer
// (tile, kv head) pairs than half the card's SMs, split by split
// (TileSplit).
template <typename TKV, int HD, int REP>
__global__ void __launch_bounds__(ptt::paged::kThreads, kBlocksPerSM)
    ragged_paged_kernel(const __nv_bfloat16* __restrict__ q,
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
                        float* __restrict__ part_acc, int* counters,
                        __nv_bfloat16* __restrict__ out, int heads, int kvh,
                        int num_pages, int ps, int max_pages, int rows,
                        int n_sms, float scale) {
  namespace pg = ptt::paged;
  extern __shared__ __align__(16) unsigned char smem[];
  PTT_STAMP_BEGIN();
  const int g = blockIdx.x, sp = blockIdx.z, n_splits = gridDim.z;
  const int cap = max_pages * ps, count = tile_count[0];
  // split the tensor-core tiles' keys when their blocks would fill fewer
  // than half the SMs: there the merge costs less than the idle card
  const bool split_tiles = 2 * tile_count[1] * kvh < n_sms;
  const long long head_base = (long long)g * num_pages;
  for (int tile = blockIdx.y; tile < count; tile += gridDim.y) {
    const int t0 = tile_starts[tile];
    const int len = tile_starts[tile + 1] - t0;
    const int row = row_ids[t0];
    const bool row_ok = row >= 0 && row < rows;
    const int* pt = page_table + (long long)(row_ok ? row : 0) * max_pages;
    if (len == 1) {
      const int p = row_ok ? pos_arr[t0] : -1;
      const int n_tok = (p >= 0 && p < cap) ? p + 1 : 0;
      const long long hq = (long long)t0 * heads + g * REP;
      if (n_tok == 0) {
        if (sp == 0) pg::zero_heads<HD, REP>(out + hq * HD);
        continue;
      }
      if (sp * pg::kSplit >= n_tok) continue;
      const pg::WalkItem it{q + hq * HD,
                            out + hq * HD,
                            pt,
                            n_tok,
                            sp,
                            part_ml + hq * n_splits * 2,
                            part_acc + hq * n_splits * HD,
                            n_splits,
                            counters + (long long)t0 * kvh + g};
      pg::decode_split<TKV, HD, REP>(smem, it, k_pool, v_pool, k_scale,
                                     v_scale, head_base, ps, scale);
    } else if (sp == 0 || (split_tiles && row_ok && pos_arr[t0] >= 0 &&
                           pos_arr[t0] < cap)) {  // a live tile's split
      const TileSplit ks{sp, split_tiles, part_ml, part_acc, n_splits,
                         counters + (long long)t0 * kvh + g};
      chunk_tile<TKV, HD, REP>(smem, q, k_pool, v_pool, k_scale, v_scale, pt,
                               pos_arr, out, t0, len, row_ok, cap, g, heads,
                               head_base, ps, scale, ks);
    }
  }
  PTT_STAMP_END();
}

struct Args {
  const void *q, *kp, *vp;
  const float *ks, *vs;
  const int *pt, *pos, *rows_ids, *tile_starts, *tile_count;
  float *ml, *acc;
  int* counters;
  void* out;
  int t, heads, kvh, num_pages, ps, max_pages, rows, grid_tiles, n_splits;
  float scale;
  cudaStream_t st;
};

// ---- the FMA kernels: fp32 q or fp32 pools
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

int dispatch_fma(int q_dtype, int kv_dtype, int hd, int rep, const Args& a) {
  if (q_dtype == ptt::kBF16)  // bf16 q takes the FMA kernel over fp32 pools
    return dispatch_hd<__nv_bfloat16, float>(hd, rep, a);
  if (kv_dtype == ptt::kF32) return dispatch_hd<float, float>(hd, rep, a);
  if (kv_dtype == ptt::kBF16)
    return dispatch_hd<float, __nv_bfloat16>(hd, rep, a);
  if (a.ks == nullptr || a.vs == nullptr) return (int)cudaErrorInvalidValue;
  if (kv_dtype == ptt::kI8) return dispatch_hd<float, int8_t>(hd, rep, a);
  if (kv_dtype == ptt::kFP8)
    return dispatch_hd<float, __nv_fp8_e4m3>(hd, rep, a);
  return (int)cudaErrorInvalidValue;
}

// ---- the Hopper kernel: bf16 q over bf16 / int8 / fp8 pools
template <typename TKV, int HD, int REP>
int launch_tc(const Args& a) {
  auto kern = ragged_paged_kernel<TKV, HD, REP>;
  constexpr int kWalk = ptt::paged::WalkSmem<TKV, HD, REP>::kBytes;
  constexpr int kTile = TileSmem<TKV, HD>::kBytes;
  const int smem = kWalk > kTile ? kWalk : kTile;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.kvh, a.grid_tiles, a.n_splits);
  kern<<<grid, ptt::paged::kThreads, smem, a.st>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const TKV*>(a.kp),
      static_cast<const TKV*>(a.vp), a.ks, a.vs, a.pt, a.pos, a.rows_ids,
      a.tile_starts, a.tile_count, a.ml, a.acc, a.counters,
      static_cast<__nv_bfloat16*>(a.out), a.heads, a.kvh, a.num_pages, a.ps,
      a.max_pages, a.rows, n_sms, a.scale);
  return (int)cudaGetLastError();
}

template <typename TKV, int HD>
int tc_rep(int rep, const Args& a) {
  if (rep == 1) return launch_tc<TKV, HD, 1>(a);
  if (rep == 2) return launch_tc<TKV, HD, 2>(a);
  if (rep == 4) return launch_tc<TKV, HD, 4>(a);
  if (rep == 8) return launch_tc<TKV, HD, 8>(a);
  return (int)cudaErrorInvalidValue;
}

template <typename TKV>
int tc_hd(int hd, int rep, const Args& a) {
  if (hd == 64) return tc_rep<TKV, 64>(rep, a);
  if (hd == 128) return tc_rep<TKV, 128>(rep, a);
  return (int)cudaErrorInvalidValue;
}

bool takes_tc(int q_dtype, int kv_dtype) {
  return q_dtype == ptt::kBF16 && kv_dtype != ptt::kF32;
}

}  // namespace

// Dynamic shared memory (bytes) of the Hopper kernel's instantiation for
// kv_dtype (1 bf16, 2 int8, 3 fp8), head_dim and rep: the larger of the
// decode walk's and the tensor-core tile's; 0 for a form it does not take.
extern "C" int ptt_ragged_paged_smem(int kv_dtype, int hd, int rep) {
  namespace pg = ptt::paged;
  if (kv_dtype < ptt::kBF16 || kv_dtype > ptt::kFP8) return 0;
  if (hd != 64 && hd != 128) return 0;
  if (rep != 1 && rep != 2 && rep != 4 && rep != 8) return 0;
  auto pick = [&](auto tag) -> int {
    using T = decltype(tag);
    int walk = 0;
    if (hd == 64) {
      walk = rep == 1   ? pg::WalkSmem<T, 64, 1>::kBytes
             : rep == 2 ? pg::WalkSmem<T, 64, 2>::kBytes
             : rep == 4 ? pg::WalkSmem<T, 64, 4>::kBytes
                        : pg::WalkSmem<T, 64, 8>::kBytes;
    } else {
      walk = rep == 1   ? pg::WalkSmem<T, 128, 1>::kBytes
             : rep == 2 ? pg::WalkSmem<T, 128, 2>::kBytes
             : rep == 4 ? pg::WalkSmem<T, 128, 4>::kBytes
                        : pg::WalkSmem<T, 128, 8>::kBytes;
    }
    const int tile = hd == 64 ? TileSmem<T, 64>::kBytes
                              : TileSmem<T, 128>::kBytes;
    return walk > tile ? walk : tile;
  };
  return kv_dtype == ptt::kBF16 ? pick(__nv_bfloat16()) : pick(int8_t());
}

// Number of key splits the wrapper must size the partials for: 128 keys a
// split for the Hopper kernel, 256 for the FMA kernels.
extern "C" int ptt_ragged_paged_splits(int max_pages, int ps, int q_dtype,
                                       int kv_dtype) {
  const int split = takes_tc(q_dtype, kv_dtype) ? ptt::paged::kSplit : kSplit;
  return (max_pages * ps + split - 1) / split;
}

// Most query vectors (tokens x rep) a query tile holds: kTileRows for the
// Hopper kernel (its tensor-core tiles), kNQ for the FMA kernels.
extern "C" int ptt_ragged_paged_tile_rows(int q_dtype, int kv_dtype) {
  return takes_tc(q_dtype, kv_dtype) ? kTileRows : kNQ;
}

// q/out: contiguous (1, T, heads, hd) of q_dtype (0 fp32, 1 bf16);
// k_pool/v_pool: contiguous (kvh, num_pages, ps, hd) of kv_dtype (0 fp32,
// 1 bf16, 2 int8, 3 fp8 e4m3), 16-byte aligned; k_scale/v_scale:
// contiguous fp32 (kvh, num_pages, ps, 1) for int8/fp8 pools, else null;
// page_table: (rows, max_pages) int32; pos, row_ids: (T,) int32;
// tile_starts: (T + 2,) int32 and tile_count: (2,) int32, the plan (tiles
// of one row's consecutive tokens, at most ptt_ragged_paged_tile_rows / rep
// of them, all live or all parked, a tile of one token only for a token
// alone in its run; tile_starts[count] == T; tile_count holds the tiles,
// then the live tiles); part_ml / part_acc: fp32 scratch of
// T*heads*n_splits*2 and T*heads*n_splits*hd elements, n_splits from
// ptt_ragged_paged_splits; counters: T*kvh int32, all zero (the Hopper
// kernel leaves them zero; the FMA kernels do not read them); grid_tiles:
// the blocks along the tile axis (each walks tiles blockIdx.y + k *
// grid_tiles). hd in {64, 128}, heads/kvh in {1, 2, 4, 8}. Returns
// cudaGetLastError() after the launch(es).
extern "C" int ptt_ragged_paged(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* pos, const void* row_ids, const void* tile_starts,
    const void* tile_count, void* part_ml, void* part_acc, void* counters,
    void* out, int t, int heads, int kvh, int hd, int num_pages, int ps,
    int max_pages, int rows, int grid_tiles, float scale, int q_dtype,
    int kv_dtype, void* stream) {
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
               static_cast<int*>(counters), out, t, heads, kvh, num_pages,
               ps, max_pages, rows, grid_tiles,
               ptt_ragged_paged_splits(max_pages, ps, q_dtype, kv_dtype),
               scale, static_cast<cudaStream_t>(stream)};
  const int rep = heads / kvh;
  if (q_dtype != ptt::kF32 && q_dtype != ptt::kBF16)
    return (int)cudaErrorInvalidValue;
  if (!takes_tc(q_dtype, kv_dtype))
    return dispatch_fma(q_dtype, kv_dtype, hd, rep, a);
  if (a.counters == nullptr) return (int)cudaErrorInvalidValue;
  if (kv_dtype == ptt::kBF16) return tc_hd<__nv_bfloat16>(hd, rep, a);
  if (a.ks == nullptr || a.vs == nullptr) return (int)cudaErrorInvalidValue;
  if (kv_dtype == ptt::kI8) return tc_hd<int8_t>(hd, rep, a);
  if (kv_dtype == ptt::kFP8) return tc_hd<__nv_fp8_e4m3>(hd, rep, a);
  return (int)cudaErrorInvalidValue;
}
