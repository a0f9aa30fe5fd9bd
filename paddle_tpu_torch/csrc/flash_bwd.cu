// Flash-attention backward for Hopper (sm_90a), plain CUDA C++: two
// kernels, as on the TPU.
//
// K2 replaces `_bwd_dq_call` (paddle_tpu/ops/pallas_kernels.py:357,
// pallas_call at :462): dQ = sum_k dS K * scale over key tiles.
// K3 replaces `_bwd_dkv_call` (:474, pallas_call at :572): kv-major,
// dV = sum_q P_dropped^T dO and dK = sum_q dS^T Q * scale over query tiles.
// Both recompute the probabilities as `_recompute_p_ds` (:328) does,
//   p  = exp(q k^T * scale + mask - lse)       (0 where causal / past sk),
//   dP = dO V^T, dropout-masked and rescaled by 1 / (1 - r),
//   dS = p * (dP - delta),
// from the forward's row log-sum-exp `lse` and delta = rowsum(dO * O)
// (fp32, computed by the caller as `_flash_vjp` does at :627-633). The
// dropout keep bit is the forward's counter-based hash (common.cuh), so no
// mask is stored between the passes. The additive float mask keeps its
// size-1 batch / head / query dims as zero strides.
//
// d(mask). Since s = scale * q k^T + mask, d(mask) = dS, unscaled, in fp32
// before dS is rounded to the operand type (the `want_dmask` store of
// `_bwd_dq_call`, :382-415). Given a `dmask` buffer, K2 writes it there as
// (batch, heads, sq, sk) fp32, only for live (row < sq, col < sk) elements;
// the caller sums it over the mask's size-1 dims, as `_flash_vjp` does
// (:643-652). Key tiles past the causal diagonal are never visited, so the
// caller hands K2 a zeroed buffer under `is_causal`. The store is a
// template flag: without a buffer K2 compiles and runs as before. With
// dropout, dS already uses the dropped and rescaled dP, so d(mask) is the
// forward's own mask's gradient.
//
// Layout is the public (batch, seq, heads, head_dim) one for q, k, v, dO and
// the outputs; lse and delta are (batch, heads, seq) fp32.
//
// Ring form (K2r, K3r: the `offs=` parameter of both TPU kernels, :346-347,
// :422-424 and :540-542): causal masking at global positions (ptt::Causal,
// row + q_off >= col + k_off) from the global lse and delta of the whole
// ring. K2 ends its key loop at the last key its tile can see; K3 starts
// its query loop at the first query that sees its first key, floored to
// the tile, so a key tile that no query sees runs no query tile and writes
// dK = dV = 0. Offsets and d(mask) do not combine (the TPU kernel asserts
// so, :450); the wrapper refuses the pair.
//
// Design. A loop inside the block replaces the TPU grid's sequential axis:
// K2 runs one block per (batch, head, 64-query tile) over key tiles, K3 one
// block per (batch, head, 64-key tile) over query tiles; causal tiles that
// contribute nothing are skipped. Two code paths, chosen as the forward's:
//   - bf16 with head_dim 64 or 128 (the training path): every product on
//     the tensor cores through WMMA 16x16x16 fragments, 4 warps of 16 rows.
//     S and dP go through a per-warp fp32 shared slab, where each lane pair
//     computes p and dS for one row; dS (and, in K3, P_dropped) are written
//     back as bf16 operands, and the dQ / dK / dV sums stay in accumulator
//     fragments across the whole loop (no rescaling is needed in the
//     backward, unlike the forward's online softmax);
//   - fp32, or other head_dims up to 256: fp32 FMAs, 8 warps of 8 rows; in
//     the score phase lane j owns column j of a 32-wide tile, and the
//     products keep each lane's head_dim slice in registers, as the
//     forward's FMA kernel.
//
// What bounds it on an H100. At ERNIE-base training shapes (b 32, h 12,
// S 512, D 64, bf16) K2 does three S x S x D products (38.7 GFLOP, 0.039 ms
// at the bf16 peak) and moves ~126 MB (0.038 ms); K3 four products (51.5
// GFLOP, 0.052 ms) and ~151 MB. Both are bound by operations; these first
// versions are limited by the shared-memory round trips of S, dP and dS
// and by the per-lane elementwise work (PERF.md has their times). With
// d(mask), K2 also writes b*h*sq*sk fp32: 402.7 MB at T5-base's encoder
// shape (b 32, h 12, 512 x 512), 0.120 ms at 3.35 TB/s, which then binds
// it by bytes. A ring step of (1, 4096, 32, 128) bf16 is bound by
// operations too: K2r 0.209 ms and K3r 0.278 ms at the bf16 peak on the
// diagonal's live pairs, twice that on a block wholly in the past.

#include <math.h>
#include <mma.h>

#include "common.cuh"

namespace {

// ------------------------------------------------------------------- FMA
constexpr int kBR = 64;              // the block's own rows
constexpr int kBC = 32;              // streamed columns per tile
constexpr int kWarps = 8;
constexpr int kRows = kBR / kWarps;  // rows per warp
constexpr int kThreads = kWarps * 32;

template <int NC>
constexpr int dq_smem_floats() {
  // q, dO [64][DP] + k, v [32][DP+4] + dS [8 warps][8 rows][32]
  return 2 * kBR * NC * 32 + 2 * kBC * (NC * 32 + 4) + kWarps * kRows * kBC;
}

template <int NC>
constexpr int dkv_smem_floats() {
  // k, v [64][DP] + q, dO [32][DP+4] + lse, delta, row keys [32]
  // + P_dropped, dS [8 warps][8 rows][32]
  return 2 * kBR * NC * 32 + 2 * kBC * (NC * 32 + 4) + 3 * kBC +
         2 * kWarps * kRows * kBC;
}

// rows x DP fp32 tile from (seq, h*d) rows of T; zero past `rows` or d
template <typename T, int DP, int kTileRows>
__device__ __forceinline__ void load_tile_f32(float* dst, int ld,
                                              const T* __restrict__ src,
                                              int row0, int rows, int d,
                                              long long rs) {
  for (int i = threadIdx.x; i < kTileRows * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    dst[r * ld + c] =
        (row0 + r < rows && c < d) ? ptt::to_f32(src[(row0 + r) * rs + c])
                                   : 0.f;
  }
}

// 4-wide dot product of two fp32 rows of DP (DP % 4 == 0)
template <int DP>
__device__ __forceinline__ float dot_row(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll 4
  for (int c = 0; c < DP; c += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + c);
    const float4 y = *reinterpret_cast<const float4*>(b + c);
    s += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
  }
  return s;
}

// K2, FMA path. NC = head_dim in chunks of 32; T = q/k/v/dO/dq type.
// kDmask: also store fp32 dS to dmask (b, h, sq, sk), lane j's column.
template <typename T, int NC, bool kDmask>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ mask, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, float* __restrict__ dmask, int sq, int sk, int h,
    int d, long long msb, long long msh, long long msq, ptt::Causal causal,
    float scale, ptt::Dropout drop) {
  constexpr int DP = NC * 32;
  constexpr int KP = DP + 4;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [kBR][DP]
  float* do_s = q_s + kBR * DP;                   // [kBR][DP]
  float* k_s = do_s + kBR * DP;                   // [kBC][KP]
  float* v_s = k_s + kBC * KP;                    // [kBC][KP]
  float* ds_s = v_s + kBC * KP;                   // [kWarps][kRows][kBC]

  const int q0 = blockIdx.x * kBR, hh = blockIdx.y, bb = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long rs = (long long)h * d;
  const long long head = (long long)hh * d;
  const T* kb = k + (long long)bb * sk * rs + head;
  const T* vb = v + (long long)bb * sk * rs + head;
  const float* mb =
      mask ? mask + (long long)bb * msb + (long long)hh * msh : nullptr;
  const long long lrow = ((long long)bb * h + hh) * sq;  // lse / delta row
  float* dmb = kDmask ? dmask + lrow * sk : nullptr;

  load_tile_f32<T, DP, kBR>(q_s, DP, q + (long long)bb * sq * rs + head, q0,
                            sq, d, rs);
  load_tile_f32<T, DP, kBR>(do_s, DP, dout + (long long)bb * sq * rs + head,
                            q0, sq, d, rs);

  const int row0 = q0 + warp * kRows;
  const unsigned hkey =
      drop.seed ? ptt::dropout_head_key((unsigned)*drop.seed, bb, hh) : 0u;
  float lse_r[kRows], delta_r[kRows], acc[kRows][NC];
  unsigned rkey[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r;
    lse_r[r] = row < sq ? lse[lrow + row] : 0.f;
    delta_r[r] = row < sq ? delta[lrow + row] : 0.f;
    rkey[r] = ptt::dropout_row_key(hkey, row);
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }
  float* dsw = ds_s + warp * kRows * kBC;
  const int k_end = causal.k_end(q0 + kBR, sk);

  for (int k0 = 0; k0 < k_end; k0 += kBC) {
    __syncthreads();  // the previous tile is consumed (and q, dO stored)
    load_tile_f32<T, DP, kBC>(k_s, KP, kb, k0, sk, d, rs);
    load_tile_f32<T, DP, kBC>(v_s, KP, vb, k0, sk, d, rs);
    __syncthreads();

    const int col = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      const float* qrow = q_s + (warp * kRows + r) * DP;
      const float* dorow = do_s + (warp * kRows + r) * DP;
      float x = dot_row<DP>(qrow, k_s + lane * KP) * scale;
      float dpv = dot_row<DP>(dorow, v_s + lane * KP);
      const bool live = row < sq && col < sk && !causal.masked(row, col);
      if (live && mb) x += mb[(long long)row * msq + col];
      const float p = live ? expf(x - lse_r[r]) : 0.f;
      const bool keep =
          !drop.seed || ptt::dropout_keep(rkey[r], col, drop.threshold);
      dpv = keep ? dpv * drop.inv_keep : 0.f;
      const float ds = p * (dpv - delta_r[r]);
      dsw[r * kBC + lane] = ds;
      if (kDmask && row < sq && col < sk) dmb[(long long)row * sk + col] = ds;
    }
    __syncwarp();

    // acc[r][c] += sum_j dS[r][j] * k[j][c*32 + lane]
#pragma unroll 2
    for (int j = 0; j < kBC; j += 4) {
      float kj[4][NC];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          kj[t][c] = k_s[(j + t) * KP + c * 32 + lane];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 s4 = *reinterpret_cast<const float4*>(dsw + r * kBC + j);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          acc[r][c] += s4.x * kj[0][c] + s4.y * kj[1][c] + s4.z * kj[2][c] +
                       s4.w * kj[3][c];
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r;
    if (row >= sq) continue;
    T* orow = dq + (long long)bb * sq * rs + row * rs + head;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int cc = c * 32 + lane;
      if (cc < d) orow[cc] = ptt::from_f32<T>(acc[r][c] * scale);
    }
  }
}

// K3, FMA path: one block per 64 keys; warp w owns keys w*8 .. w*8+7.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ mask, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int sq, int sk, int h, int d,
    long long msb, long long msh, long long msq, ptt::Causal causal,
    float scale, ptt::Dropout drop) {
  constexpr int DP = NC * 32;
  constexpr int KP = DP + 4;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // [kBR][DP]
  float* v_s = k_s + kBR * DP;                    // [kBR][DP]
  float* q_s = v_s + kBR * DP;                    // [kBC][KP]
  float* do_s = q_s + kBC * KP;                   // [kBC][KP]
  float* lse_s = do_s + kBC * KP;                 // [kBC]
  float* delta_s = lse_s + kBC;                   // [kBC]
  unsigned* rkey_s = reinterpret_cast<unsigned*>(delta_s + kBC);  // [kBC]
  float* pd_s = delta_s + 2 * kBC;                // [kWarps][kRows][kBC]
  float* ds_s = pd_s + kWarps * kRows * kBC;      // [kWarps][kRows][kBC]

  const int k0 = blockIdx.x * kBR, hh = blockIdx.y, bb = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long rs = (long long)h * d;
  const long long head = (long long)hh * d;
  const T* qb = q + (long long)bb * sq * rs + head;
  const T* dob = dout + (long long)bb * sq * rs + head;
  const float* mb =
      mask ? mask + (long long)bb * msb + (long long)hh * msh : nullptr;
  const long long lrow = ((long long)bb * h + hh) * sq;

  load_tile_f32<T, DP, kBR>(k_s, DP, k + (long long)bb * sk * rs + head, k0,
                            sk, d, rs);
  load_tile_f32<T, DP, kBR>(v_s, DP, v + (long long)bb * sk * rs + head, k0,
                            sk, d, rs);

  const int key0 = k0 + warp * kRows;
  const unsigned hkey =
      drop.seed ? ptt::dropout_head_key((unsigned)*drop.seed, bb, hh) : 0u;
  float acc_k[kRows][NC], acc_v[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;
  float* pdw = pd_s + warp * kRows * kBC;
  float* dsw = ds_s + warp * kRows * kBC;
  // causal: query rows before the first one that sees the block's first
  // key see none of its keys
  const int q_begin = causal.q_begin(k0) / kBC * kBC;

  for (int q0 = q_begin; q0 < sq; q0 += kBC) {
    __syncthreads();  // the previous tile is consumed (and k, v stored)
    load_tile_f32<T, DP, kBC>(q_s, KP, qb, q0, sq, d, rs);
    load_tile_f32<T, DP, kBC>(do_s, KP, dob, q0, sq, d, rs);
    if (threadIdx.x < kBC) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < sq ? lse[lrow + row] : 0.f;
      delta_s[threadIdx.x] = row < sq ? delta[lrow + row] : 0.f;
      rkey_s[threadIdx.x] = ptt::dropout_row_key(hkey, row);
    }
    __syncthreads();

    const int row = q0 + lane;  // this lane's query row
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int key = key0 + r;
      float x =
          dot_row<DP>(k_s + (warp * kRows + r) * DP, q_s + lane * KP) * scale;
      float dpv = dot_row<DP>(v_s + (warp * kRows + r) * DP, do_s + lane * KP);
      const bool live = row < sq && key < sk && !causal.masked(row, key);
      if (live && mb) x += mb[(long long)row * msq + key];
      const float p = live ? expf(x - lse_s[lane]) : 0.f;
      const bool keep =
          !drop.seed || ptt::dropout_keep(rkey_s[lane], key, drop.threshold);
      dpv = keep ? dpv * drop.inv_keep : 0.f;
      pdw[r * kBC + lane] = keep ? p * drop.inv_keep : 0.f;
      dsw[r * kBC + lane] = p * (dpv - delta_s[lane]);
    }
    __syncwarp();

    // acc_v[r][c] += sum_i P_dropped[r][i] * dO[i][c*32 + lane]
    // acc_k[r][c] += sum_i dS[r][i] * q[i][c*32 + lane]
#pragma unroll 2
    for (int i = 0; i < kBC; i += 4) {
      float qi[4][NC], di[4][NC];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          qi[t][c] = q_s[(i + t) * KP + c * 32 + lane];
          di[t][c] = do_s[(i + t) * KP + c * 32 + lane];
        }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(pdw + r * kBC + i);
        const float4 s4 = *reinterpret_cast<const float4*>(dsw + r * kBC + i);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc_v[r][c] += p4.x * di[0][c] + p4.y * di[1][c] + p4.z * di[2][c] +
                         p4.w * di[3][c];
          acc_k[r][c] += s4.x * qi[0][c] + s4.y * qi[1][c] + s4.z * qi[2][c] +
                         s4.w * qi[3][c];
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int key = key0 + r;
    if (key >= sk) continue;
    const long long off = (long long)bb * sk * rs + key * rs + head;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int cc = c * 32 + lane;
      if (cc < d) {
        dk[off + cc] = ptt::from_f32<T>(acc_k[r][c] * scale);
        dv[off + cc] = ptt::from_f32<T>(acc_v[r][c]);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *mask, *lse, *delta;
  void *dq, *dk, *dv;
  float* dmask;  // K2's d(mask) buffer, or nullptr
  int b, sq, sk, h, d;
  long long msb, msh, msq;
  ptt::Causal causal;
  float scale;
  ptt::Dropout drop;
};

template <typename T, int NC>
int launch_fma(const Args& a, bool want_dq, cudaStream_t st) {
  if (want_dq) {
    const size_t smem = dq_smem_floats<NC>() * sizeof(float);
    auto kern = a.dmask ? flash_bwd_dq_kernel<T, NC, true>
                        : flash_bwd_dq_kernel<T, NC, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((a.sq + kBR - 1) / kBR, a.h, a.b);
    kern<<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), a.mask, static_cast<const T*>(a.dout),
        a.lse, a.delta, static_cast<T*>(a.dq), a.dmask, a.sq, a.sk, a.h, a.d,
        a.msb, a.msh, a.msq, a.causal, a.scale, a.drop);
  } else {
    const size_t smem = dkv_smem_floats<NC>() * sizeof(float);
    auto kern = flash_bwd_dkv_kernel<T, NC>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((a.sk + kBR - 1) / kBR, a.h, a.b);
    kern<<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), a.mask, static_cast<const T*>(a.dout),
        a.lse, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.sq,
        a.sk, a.h, a.d, a.msb, a.msh, a.msq, a.causal, a.scale, a.drop);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_fma(const Args& a, bool want_dq, cudaStream_t st) {
  if (a.d <= 32) return launch_fma<T, 1>(a, want_dq, st);
  if (a.d <= 64) return launch_fma<T, 2>(a, want_dq, st);
  if (a.d <= 128) return launch_fma<T, 4>(a, want_dq, st);
  return launch_fma<T, 8>(a, want_dq, st);
}

// ----------------------------------------------------------- bf16 (WMMA)
namespace wm = nvcuda::wmma;
using bf16 = __nv_bfloat16;
constexpr int kWT = 64;                // block rows, and columns per tile
constexpr int kWWarps = 4;
constexpr int kWThreads = kWWarps * 32;
constexpr int kWRows = kWT / kWWarps;  // 16 rows per warp

template <int D>
struct BwdSmem {
  static constexpr int DP = D + 8;     // bf16 row stride of the four tiles
  static constexpr int SP = kWT + 4;   // fp32 row stride of S and dP
  static constexpr int PP = kWT + 8;   // bf16 row stride of dS / P_dropped
  static constexpr int OP = D + 4;     // fp32 row stride of the output rows
  // per warp, S [16][SP] then dP [16][SP]; after the loop the same slab
  // stages the warp's output rows [16][OP] (OP <= 2 * SP for D <= 128)
  static_assert(OP <= 2 * SP, "output staging must fit the S/dP slab");
  static constexpr size_t tile = (size_t)kWT * DP * 2;
  static constexpr size_t sdp = 4 * tile;
  static constexpr size_t ops = sdp + (size_t)kWWarps * 2 * kWRows * SP * 4;
  static constexpr size_t ops2 = ops + (size_t)kWWarps * kWRows * PP * 2;
  static constexpr size_t rows = ops2 + (size_t)kWWarps * kWRows * PP * 2;
  static constexpr size_t bytes = rows + 3 * kWT * 4;
};

template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int row0, int rows, long long rs) {
  ptt::load_tile_bf16<D, BwdSmem<D>::DP, kWT, kWThreads>(dst, src, row0,
                                                         rows, rs);
}

// acc[0..3] = A_w (16 x D, rows of a_s) * B^T (D x 64, rows of b_s): the
// warp's 16 x 64 block of S (or S^T), stored to `out` with row stride SP
template <int D>
__device__ __forceinline__ void scores_16x64(const bf16* a_rows,
                                             const bf16* b_s, float* out) {
  using L = BwdSmem<D>;
  wm::fragment<wm::accumulator, 16, 16, 16, float> sf[kWT / 16];
#pragma unroll
  for (int j = 0; j < kWT / 16; ++j) wm::fill_fragment(sf[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> a;
    wm::load_matrix_sync(a, a_rows + kk * 16, L::DP);
#pragma unroll
    for (int j = 0; j < kWT / 16; ++j) {
      wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major> b;
      wm::load_matrix_sync(b, b_s + j * 16 * L::DP + kk * 16, L::DP);
      wm::mma_sync(sf[j], a, b, sf[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kWT / 16; ++j)
    wm::store_matrix_sync(out + j * 16, sf[j], L::SP, wm::mem_row_major);
}

// acc[dj] += P (16 x 64, row stride PP) * B (64 x D, rows of b_s)
template <int D>
__device__ __forceinline__ void accumulate_16xD(
    wm::fragment<wm::accumulator, 16, 16, 16, float>* acc, const bf16* p,
    const bf16* b_s) {
  using L = BwdSmem<D>;
#pragma unroll
  for (int kk = 0; kk < kWT / 16; ++kk) {
    wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> a;
    wm::load_matrix_sync(a, p + kk * 16, L::PP);
#pragma unroll
    for (int dj = 0; dj < D / 16; ++dj) {
      wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> b;
      wm::load_matrix_sync(b, b_s + kk * 16 * L::DP + dj * 16, L::DP);
      wm::mma_sync(acc[dj], a, b, acc[dj]);
    }
  }
}

// write a warp's 16 x D accumulator rows (times `mul`) as bf16 rows
// row0 .. row0+15 of `dst` (row stride rs), skipping rows >= `rows`
template <int D>
__device__ __forceinline__ void store_rows(
    wm::fragment<wm::accumulator, 16, 16, 16, float>* acc, float mul,
    float* stage, bf16* dst, int row0, int rows, long long rs) {
  using L = BwdSmem<D>;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int dj = 0; dj < D / 16; ++dj) {
#pragma unroll
    for (int i = 0; i < acc[dj].num_elements; ++i) acc[dj].x[i] *= mul;
    wm::store_matrix_sync(stage + dj * 16, acc[dj], L::OP, wm::mem_row_major);
  }
  __syncwarp();
  // lane pair per row, 8 bf16 (16 bytes) a store
  const int r = lane >> 1, half = lane & 1;
  if (row0 + r < rows) {
    bf16* out = dst + (long long)(row0 + r) * rs;
    for (int c = half * 8; c < D; c += 16) {
      __align__(16) bf16 v8[8];
#pragma unroll
      for (int t = 0; t < 8; ++t)
        v8[t] = __float2bfloat16(stage[r * L::OP + c + t]);
      *reinterpret_cast<uint4*>(out + c) = *reinterpret_cast<const uint4*>(v8);
    }
  }
  __syncwarp();
}

// K2, bf16 tensor-core path: one block per (batch, head, 64-query tile).
// kDmask: the fp32 dS of each warp's 16 x 64 tile goes back into the warp's
// S slab (each lane overwrites the S values it has just read), and the warp
// then writes the tile to dmask row by row, 32 consecutive floats a store.
template <int D, bool kDmask>
__global__ void __launch_bounds__(kWThreads) flash_bwd_dq_wmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ mask,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq,
    float* __restrict__ dmask, int sq, int sk, int h, long long msb,
    long long msh, long long msq, ptt::Causal causal, float scale,
    ptt::Dropout drop) {
  using L = BwdSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  auto* q_s = reinterpret_cast<bf16*>(smem);
  auto* do_s = reinterpret_cast<bf16*>(smem + L::tile);
  auto* k_s = reinterpret_cast<bf16*>(smem + 2 * L::tile);
  auto* v_s = reinterpret_cast<bf16*>(smem + 3 * L::tile);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* s_w =
      reinterpret_cast<float*>(smem + L::sdp) + warp * 2 * kWRows * L::SP;
  float* dp_w = s_w + kWRows * L::SP;
  bf16* ds_w = reinterpret_cast<bf16*>(smem + L::ops) + warp * kWRows * L::PP;

  const int q0 = blockIdx.x * kWT, hh = blockIdx.y, bb = blockIdx.z;
  const long long rs = (long long)h * D;
  const long long head = (long long)hh * D;
  const bf16* kb = k + (long long)bb * sk * rs + head;
  const bf16* vb = v + (long long)bb * sk * rs + head;
  const float* mb =
      mask ? mask + (long long)bb * msb + (long long)hh * msh : nullptr;
  const long long lrow = ((long long)bb * h + hh) * sq;

  load_tile<D>(q_s, q + (long long)bb * sq * rs + head, q0, sq, rs);
  load_tile<D>(do_s, dout + (long long)bb * sq * rs + head, q0, sq, rs);

  // lane -> (row r of the warp's 16, half of the tile's 64 columns)
  const int r = lane >> 1, half = lane & 1;
  const int row = q0 + warp * kWRows + r;
  const float lse_r = row < sq ? lse[lrow + row] : 0.f;
  const float delta_r = row < sq ? delta[lrow + row] : 0.f;
  const unsigned rkey = ptt::dropout_row_key(
      drop.seed ? ptt::dropout_head_key((unsigned)*drop.seed, bb, hh) : 0u,
      row);

  wm::fragment<wm::accumulator, 16, 16, 16, float> acc[D / 16];
#pragma unroll
  for (int dj = 0; dj < D / 16; ++dj) wm::fill_fragment(acc[dj], 0.f);
  const int k_end = causal.k_end(q0 + kWT, sk);

  for (int k0 = 0; k0 < k_end; k0 += kWT) {
    __syncthreads();  // previous K/V tiles consumed (q, dO stored on entry)
    load_tile<D>(k_s, kb, k0, sk, rs);
    load_tile<D>(v_s, vb, k0, sk, rs);
    __syncthreads();

    scores_16x64<D>(q_s + warp * kWRows * L::DP, k_s, s_w);    // S
    scores_16x64<D>(do_s + warp * kWRows * L::DP, v_s, dp_w);  // dP
    __syncwarp();

#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const int cc = half * 32 + c, col = k0 + cc;
      const bool live = row < sq && col < sk && !causal.masked(row, col);
      float x = s_w[r * L::SP + cc] * scale;
      if (live && mb) x += mb[(long long)row * msq + col];
      const float p = live ? expf(x - lse_r) : 0.f;
      float dpv = dp_w[r * L::SP + cc];
      const bool keep =
          !drop.seed || ptt::dropout_keep(rkey, col, drop.threshold);
      dpv = keep ? dpv * drop.inv_keep : 0.f;
      const float ds = p * (dpv - delta_r);
      ds_w[r * L::PP + cc] = __float2bfloat16(ds);
      if (kDmask) s_w[r * L::SP + cc] = ds;
    }
    __syncwarp();

    if (kDmask) {
      const int wrow0 = q0 + warp * kWRows;
      float* dmb = dmask + (lrow + wrow0) * sk;
      for (int i = 0; i < kWRows && wrow0 + i < sq; ++i) {
#pragma unroll
        for (int t = 0; t < kWT / 32; ++t) {
          const int c = t * 32 + lane;
          if (k0 + c < sk)
            dmb[(long long)i * sk + k0 + c] = s_w[i * L::SP + c];
        }
      }
    }

    accumulate_16xD<D>(acc, ds_w, k_s);  // dQ_w += dS K
  }
  __syncwarp();
  store_rows<D>(acc, scale, s_w, dq + (long long)bb * sq * rs + head,
                q0 + warp * kWRows, sq, rs);
}

// K3, bf16 tensor-core path: one block per (batch, head, 64-key tile);
// warp w owns keys w*16 .. w*16+15 and walks the query tiles.
template <int D>
__global__ void __launch_bounds__(kWThreads) flash_bwd_dkv_wmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ mask,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int sq, int sk, int h, long long msb,
    long long msh, long long msq, ptt::Causal causal, float scale,
    ptt::Dropout drop) {
  using L = BwdSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  auto* k_s = reinterpret_cast<bf16*>(smem);
  auto* v_s = reinterpret_cast<bf16*>(smem + L::tile);
  auto* q_s = reinterpret_cast<bf16*>(smem + 2 * L::tile);
  auto* do_s = reinterpret_cast<bf16*>(smem + 3 * L::tile);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* s_w =
      reinterpret_cast<float*>(smem + L::sdp) + warp * 2 * kWRows * L::SP;
  float* dp_w = s_w + kWRows * L::SP;
  bf16* pd_w = reinterpret_cast<bf16*>(smem + L::ops) + warp * kWRows * L::PP;
  bf16* ds_w = reinterpret_cast<bf16*>(smem + L::ops2) + warp * kWRows * L::PP;
  float* lse_s = reinterpret_cast<float*>(smem + L::rows);
  float* delta_s = lse_s + kWT;
  unsigned* rkey_s = reinterpret_cast<unsigned*>(delta_s + kWT);

  const int k0 = blockIdx.x * kWT, hh = blockIdx.y, bb = blockIdx.z;
  const long long rs = (long long)h * D;
  const long long head = (long long)hh * D;
  const bf16* qb = q + (long long)bb * sq * rs + head;
  const bf16* dob = dout + (long long)bb * sq * rs + head;
  const float* mb =
      mask ? mask + (long long)bb * msb + (long long)hh * msh : nullptr;
  const long long lrow = ((long long)bb * h + hh) * sq;
  const unsigned hkey =
      drop.seed ? ptt::dropout_head_key((unsigned)*drop.seed, bb, hh) : 0u;

  load_tile<D>(k_s, k + (long long)bb * sk * rs + head, k0, sk, rs);
  load_tile<D>(v_s, v + (long long)bb * sk * rs + head, k0, sk, rs);

  // lane -> (key r of the warp's 16, half of the tile's 64 query columns)
  const int r = lane >> 1, half = lane & 1;
  const int key = k0 + warp * kWRows + r;
  wm::fragment<wm::accumulator, 16, 16, 16, float> acc_k[D / 16], acc_v[D / 16];
#pragma unroll
  for (int dj = 0; dj < D / 16; ++dj) {
    wm::fill_fragment(acc_k[dj], 0.f);
    wm::fill_fragment(acc_v[dj], 0.f);
  }
  // causal: query rows before the first one that sees the block's first
  // key see none of its keys
  const int q_begin = causal.q_begin(k0) / kWT * kWT;

  for (int q0 = q_begin; q0 < sq; q0 += kWT) {
    __syncthreads();  // previous q/dO tiles consumed (k, v stored on entry)
    load_tile<D>(q_s, qb, q0, sq, rs);
    load_tile<D>(do_s, dob, q0, sq, rs);
    if (threadIdx.x < kWT) {
      const int qr = q0 + threadIdx.x;
      lse_s[threadIdx.x] = qr < sq ? lse[lrow + qr] : 0.f;
      delta_s[threadIdx.x] = qr < sq ? delta[lrow + qr] : 0.f;
      rkey_s[threadIdx.x] = ptt::dropout_row_key(hkey, qr);
    }
    __syncthreads();

    scores_16x64<D>(k_s + warp * kWRows * L::DP, q_s, s_w);    // S^T
    scores_16x64<D>(v_s + warp * kWRows * L::DP, do_s, dp_w);  // dP^T
    __syncwarp();

#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const int qi = half * 32 + c, row = q0 + qi;
      const bool live = row < sq && key < sk && !causal.masked(row, key);
      float x = s_w[r * L::SP + qi] * scale;
      if (live && mb) x += mb[(long long)row * msq + key];
      const float p = live ? expf(x - lse_s[qi]) : 0.f;
      const bool keep =
          !drop.seed || ptt::dropout_keep(rkey_s[qi], key, drop.threshold);
      const float dpv = keep ? dp_w[r * L::SP + qi] * drop.inv_keep : 0.f;
      pd_w[r * L::PP + qi] = __float2bfloat16(keep ? p * drop.inv_keep : 0.f);
      ds_w[r * L::PP + qi] = __float2bfloat16(p * (dpv - delta_s[qi]));
    }
    __syncwarp();

    accumulate_16xD<D>(acc_v, pd_w, do_s);  // dV_w += P_dropped^T dO
    accumulate_16xD<D>(acc_k, ds_w, q_s);   // dK_w += dS^T Q
  }
  __syncwarp();
  const long long base = (long long)bb * sk * rs + head;
  store_rows<D>(acc_v, 1.f, s_w, dv + base, k0 + warp * kWRows, sk, rs);
  store_rows<D>(acc_k, scale, s_w, dk + base, k0 + warp * kWRows, sk, rs);
}

template <int D>
int launch_wmma(const Args& a, bool want_dq, cudaStream_t st) {
  const size_t smem = BwdSmem<D>::bytes;
  using cbf = const bf16*;
  if (want_dq) {
    auto kern = a.dmask ? flash_bwd_dq_wmma_kernel<D, true>
                        : flash_bwd_dq_wmma_kernel<D, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((a.sq + kWT - 1) / kWT, a.h, a.b);
    kern<<<grid, kWThreads, smem, st>>>(
        static_cast<cbf>(a.q), static_cast<cbf>(a.k), static_cast<cbf>(a.v),
        a.mask, static_cast<cbf>(a.dout), a.lse, a.delta,
        static_cast<bf16*>(a.dq), a.dmask, a.sq, a.sk, a.h, a.msb, a.msh,
        a.msq, a.causal, a.scale, a.drop);
  } else {
    auto kern = flash_bwd_dkv_wmma_kernel<D>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((a.sk + kWT - 1) / kWT, a.h, a.b);
    kern<<<grid, kWThreads, smem, st>>>(
        static_cast<cbf>(a.q), static_cast<cbf>(a.k), static_cast<cbf>(a.v),
        a.mask, static_cast<cbf>(a.dout), a.lse, a.delta,
        static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.sq, a.sk, a.h,
        a.msb, a.msh, a.msq, a.causal, a.scale, a.drop);
  }
  return (int)cudaGetLastError();
}

int dispatch(const Args& a, int dtype, bool want_dq, void* stream) {
  if (a.d < 1 || a.d > 256) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kBF16 && a.d == 64) return launch_wmma<64>(a, want_dq, st);
  if (dtype == ptt::kBF16 && a.d == 128)
    return launch_wmma<128>(a, want_dq, st);
  if (dtype == ptt::kBF16) return dispatch_fma<bf16>(a, want_dq, st);
  if (dtype == ptt::kF32) return dispatch_fma<float>(a, want_dq, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q/dout/dq: contiguous (b, sq, h, d); k/v/dk/dv: contiguous (b, sk, h, d),
// all of `dtype` (0 fp32, 1 bf16), d <= 256; mask: nullptr or fp32 with
// element strides msb/msh/msq (0 = broadcast dim) and unit stride over
// keys; lse, delta: (b, h, sq) fp32; seed: nullptr (no dropout) or a device
// int32, threshold = floor(p * 2^32), inv_keep = 1 / (1 - p); dmask (K2
// only): nullptr, or a contiguous (b, h, sq, sk) fp32 buffer for d(mask),
// zeroed by the caller under is_causal; q_off / k_off: the global positions
// of the first query row and key column for causal masking (0, 0 for one
// call).
// Each returns cudaGetLastError() after its launch.
extern "C" int ptt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* mask, const void* dout,
                                const void* lse, const void* delta, void* dq,
                                void* dmask, int b, int sq, int sk, int h,
                                int d, long long msb, long long msh,
                                long long msq, int is_causal, int q_off,
                                int k_off, float scale, const void* seed,
                                unsigned threshold, float inv_keep, int dtype,
                                void* stream) {
  const Args a{q, k, v, dout,
               static_cast<const float*>(mask),
               static_cast<const float*>(lse),
               static_cast<const float*>(delta),
               dq, nullptr, nullptr, static_cast<float*>(dmask),
               b, sq, sk, h, d, msb, msh, msq,
               ptt::Causal{is_causal, q_off, k_off}, scale,
               ptt::Dropout{static_cast<const int*>(seed), threshold,
                            seed ? inv_keep : 1.f}};
  return dispatch(a, dtype, true, stream);
}

extern "C" int ptt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* mask, const void* dout,
                                 const void* lse, const void* delta, void* dk,
                                 void* dv, int b, int sq, int sk, int h, int d,
                                 long long msb, long long msh, long long msq,
                                 int is_causal, int q_off, int k_off,
                                 float scale, const void* seed,
                                 unsigned threshold, float inv_keep, int dtype,
                                 void* stream) {
  const Args a{q, k, v, dout,
               static_cast<const float*>(mask),
               static_cast<const float*>(lse),
               static_cast<const float*>(delta),
               nullptr, dk, dv, nullptr, b, sq, sk, h, d, msb, msh, msq,
               ptt::Causal{is_causal, q_off, k_off}, scale,
               ptt::Dropout{static_cast<const int*>(seed), threshold,
                            seed ? inv_keep : 1.f}};
  return dispatch(a, dtype, false, stream);
}
