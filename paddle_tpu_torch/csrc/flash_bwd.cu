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
// the tile, so a key tile that no query sees loads nothing and writes dK =
// dV = 0 (with 16-byte stores in the Hopper kernel). Offsets and d(mask) do
// not combine (the TPU kernel asserts so, :450); the wrapper refuses the
// pair.
//
// Design. A loop inside the block replaces the TPU grid's sequential axis:
// K2 runs one block per (batch, head, 64-query tile) over key tiles, K3 one
// block per (batch, head, key tile) over query tiles; causal tiles that
// contribute nothing are skipped. The code paths:
//   - K3, bf16 with head_dim 64 or 128 (the training path and the ring):
//     the Hopper kernel flash_bwd_dkv_sm90_kernel below: K and V loaded
//     once by TMA, Q / dO streamed through mbarrier stages, S^T and dP^T on
//     wgmma from shared memory, P, P_dropped and dS^T formed in registers
//     and fed to the dV and dK products as register A operands, dK and dV
//     accumulated in registers for the whole loop;
//   - K2, bf16 with head_dim 64 or 128: WMMA 16x16x16 fragments, 4 warps of
//     16 rows. S and dP go through a per-warp fp32 shared slab, where each
//     lane pair computes p and dS for one row; dS is written back as a bf16
//     operand, and the dQ sum stays in accumulator fragments across the
//     whole loop (no rescaling is needed in the backward, unlike the
//     forward's online softmax);
//   - fp32, or other head_dims up to 256: fp32 FMAs, 8 warps of 8 rows; in
//     the score phase lane j owns column j of a 32-wide tile, and the
//     products keep each lane's head_dim slice in registers, as the
//     forward's FMA kernel.
//
// What bounds it on an H100. At ERNIE-base training shapes (b 32, h 12,
// S 512, D 64, bf16) K2 does three S x S x D products (38.7 GFLOP, 0.039 ms
// at the bf16 peak) and moves ~126 MB (0.038 ms); K3 four products (51.5
// GFLOP, 0.052 ms) and ~151 MB. Both are bound by operations. K2 is still
// limited by the shared-memory round trips of S, dP and dS and by its
// per-lane elementwise work; the Hopper K3 by the per-element work between
// its products (exp, the mask, the dropout hash, dS, the bf16 packing),
// which it keeps branch-free (the mask kind and dropout are template
// parameters), overlaps with the tensor cores (the dropout bits are hashed
// while S^T runs, dV's product runs while dS is formed) and spreads over two
// warpgroups that run apart (PERF.md has the times). With d(mask), K2 also
// writes b*h*sq*sk fp32: 402.7 MB at T5-base's encoder shape (b 32, h 12,
// 512 x 512), 0.120 ms at 3.35 TB/s, which then binds it by bytes. A ring
// step of (1, 4096, 32, 128) bf16 is bound by operations too: K2r 0.209 ms
// and K3r 0.278 ms at the bf16 peak on the diagonal's live pairs, twice that
// on a block wholly in the past.

#include <math.h>
#include <mma.h>

#include <type_traits>

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

// ------------------------------------------------------ K3, bf16 (Hopper)
// One block of two consumer warpgroups per (batch, head, 128-key tile);
// warpgroup w owns keys 64w .. 64w+63. K and V arrive once by TMA; the
// query tiles of kBQ rows stream through two shared-memory stages (Q, dO by
// TMA; each warpgroup's own copies of lse, delta, the dropout row keys,
// computed once a tile, and its keys' half of the mask tile, by cp.async
// behind a barrier of its 128 threads), tile j+1 in flight while tile j is
// computed. The warpgroups run apart (no block barrier in the loop), so
// one's elementwise work overlaps the other's products: a Q / dO stage is
// refilled by whichever warpgroup releases it second. Per query tile, in
// one warpgroup:
//   S^T = K Q^T, dP^T = V dO^T   wgmma m64n64k16, both operands from
//                                shared memory, fp32 registers;
//   P, P_dropped, dS^T           in registers (the accumulator layout of
//                                common.cuh), rounded to bf16 A operands;
//   dV += P_dropped^T dO,        wgmma m64nDk16, A from registers, dO / Q
//   dK += dS^T Q                 read MN-major (transposed) through their
//                                descriptors.
// dK and dV accumulate in fp32 registers across the whole loop and are
// written once (dK times scale), staged as bf16 rows for 16-byte stores.

constexpr int kHKeys = 128;                // keys a block (two warpgroups)
constexpr int kBQ = 64;                     // query rows a tile
constexpr int kHThreads = 256;
constexpr int kHMaskLd = 64 + 4;           // fp32 row stride of a
                                           // warpgroup's mask tile

template <int D>
struct DkvSmem {
  static constexpr size_t bars = 0;        // K/V, Q/dO stage 0, 1
  static constexpr size_t counts = 64;     // Q/dO stage releases
  static constexpr size_t k = 1024;        // [D/64][kHKeys][64] bf16
  static constexpr size_t kv_tile = (size_t)kHKeys * D * 2;
  static constexpr size_t v = k + kv_tile;
  static constexpr size_t qt = (size_t)kBQ * D * 2;  // one Q or dO tile
  static constexpr size_t stages = v + kv_tile;     // [2][Q, dO][D/64][kBQ][64]
  // [2 stages][2 warpgroups][lse, delta, rkey][kBQ]
  static constexpr size_t side = stages + 4 * qt;
  static constexpr size_t side_stage = (size_t)3 * kBQ * 4;
  // [2 stages][2 warpgroups][kBQ][kHMaskLd]
  static constexpr size_t mask = side + 4 * side_stage;
  static constexpr size_t mask_stage = (size_t)kBQ * kHMaskLd * 4;
  static constexpr size_t bytes(bool with_mask_tile) {
    return mask + (with_mask_tile ? 4 * mask_stage : 0) + 1024;
  }
  // the epilogue's bf16 rows [kHKeys][D + 8] reuse K / V
  static_assert((size_t)kHKeys * (D + 8) * 2 <= 2 * kv_tile, "dK staging");
};

// kMask: 0 none, 1 a mask over keys only ((b|1, h|1, 1, k): two values a
// thread, read once), 2 a mask with query rows (staged tiles); kDrop:
// attention dropout. Each case is its own kernel, so the per-element code
// carries no branch.
template <int D, int kMask, bool kDrop>
__global__ void __launch_bounds__(kHThreads, 1) flash_bwd_dkv_sm90_kernel(
    __grid_constant__ const CUtensorMap tm_q,
    __grid_constant__ const CUtensorMap tm_k,
    __grid_constant__ const CUtensorMap tm_v,
    __grid_constant__ const CUtensorMap tm_do, const float* __restrict__ mask,
    int mask_vec, const float* __restrict__ lse,
    const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int sk, int h,
    long long msb, long long msh, long long msq, ptt::Causal causal,
    float scale, ptt::Dropout drop) {
  using L = DkvSmem<D>;
  using namespace ptt::sm90;
  constexpr int NB = D / 64;  // 64-column boxes of a row
  const int k0 = blockIdx.x * kHKeys, hh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x;
  const long long rs = (long long)h * D;
  const long long base = (long long)bb * sk * rs + (long long)hh * D;
  const long long lrow = ((long long)bb * h + hh) * sq;
  // causal: query rows before the first one that sees the block's first
  // key see none of its keys
  const int q_begin = causal.q_begin(k0) / kBQ * kBQ;
  const int n_tiles = q_begin < sq ? (sq - q_begin + kBQ - 1) / kBQ : 0;

  if (n_tiles == 0) {
    // no query sees these keys (a ring step in the future): dK = dV = 0
    for (int i = tid; i < kHKeys * (D / 8); i += kHThreads) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      if (k0 + r < sk) {
        *reinterpret_cast<uint4*>(dk + base + (k0 + r) * rs + c) =
            make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(dv + base + (k0 + r) * rs + c) =
            make_uint4(0, 0, 0, 0);
      }
    }
    return;
  }

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::bars);
  bf16* k_s = reinterpret_cast<bf16*>(smem + L::k);
  bf16* v_s = reinterpret_cast<bf16*>(smem + L::v);
  auto q_stage = [&](int s) {
    return reinterpret_cast<bf16*>(smem + L::stages + (size_t)s * 2 * L::qt);
  };
  auto do_stage = [&](int s) {
    return reinterpret_cast<bf16*>(smem + L::stages +
                                   (size_t)(s * 2 + 1) * L::qt);
  };
  int* released = reinterpret_cast<int*>(smem + L::counts);
  const int wg = tid >> 7, wtid = tid & 127;  // warpgroup, thread in it
  auto side = [&](int s) {
    return reinterpret_cast<float*>(smem + L::side +
                                    (size_t)(s * 2 + wg) * L::side_stage);
  };
  auto mask_tile = [&](int s) {
    return reinterpret_cast<float*>(smem + L::mask +
                                    (size_t)(s * 2 + wg) * L::mask_stage);
  };
  const float* mb = kMask ? mask + (long long)bb * msb + (long long)hh * msh
                          : nullptr;
  constexpr bool tile_mask = kMask == 2;
  const unsigned hkey =
      kDrop ? ptt::dropout_head_key((unsigned)*drop.seed, bb, hh) : 0u;

  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    mbar_init(&bar[2], 1);
    released[0] = released[1] = 0;
    fence_barrier_init();
  }
  __syncthreads();

  auto load_qdo = [&](int j) {  // one thread
    const int q0 = q_begin + j * kBQ, s = j & 1;
    mbar_expect_tx(&bar[1 + s], 2 * L::qt);
#pragma unroll
    for (int x = 0; x < NB; ++x) {
      tma_load_3d(q_stage(s) + x * kBQ * 64, &tm_q, &bar[1 + s],
                  hh * D + x * 64, q0, bb);
      tma_load_3d(do_stage(s) + x * kBQ * 64, &tm_do, &bar[1 + s],
                  hh * D + x * 64, q0, bb);
    }
  };
  // the warpgroup's lse, delta, row keys and mask half of query tile j, one
  // commit group
  auto load_side = [&](int j) {
    const int q0 = q_begin + j * kBQ, s = j & 1, kw = k0 + wg * 64;
    float* sd = side(s);
    for (int i = wtid; i < 3 * kBQ; i += 128) {
      const int which = i / kBQ, ql = i % kBQ, q = q0 + ql;
      if (which == 2)
        reinterpret_cast<unsigned*>(sd)[2 * kBQ + ql] =
            ptt::dropout_row_key(hkey, q);
      else
        cp_async_4(sd + which * kBQ + ql,
                   (which ? delta : lse) + lrow + (q < sq ? q : 0), q < sq);
    }
    if (tile_mask && mask_vec) {
      float* dst = mask_tile(s);
      for (int i = wtid; i < kBQ * 16; i += 128) {
        const int ql = i / 16, kl = (i % 16) * 4;
        const int n = q0 + ql < sq ? min(max(sk - kw - kl, 0), 4) : 0;
        cp_async_16(dst + ql * kHMaskLd + kl,
                    n ? mb + (long long)(q0 + ql) * msq + kw + kl : mb, n * 4);
      }
    } else if (tile_mask) {
      float* dst = mask_tile(s);
      for (int i = wtid; i < kBQ * 64; i += 128) {
        const int ql = i / 64, kl = i % 64;
        const bool ok = q0 + ql < sq && kw + kl < sk;
        cp_async_4(dst + ql * kHMaskLd + kl,
                   ok ? mb + (long long)(q0 + ql) * msq + kw + kl : mb, ok);
      }
    }
    cp_async_commit();
  };

  if (tid == 0) {
    mbar_expect_tx(&bar[0], (unsigned)(2 * L::kv_tile));
#pragma unroll
    for (int x = 0; x < NB; ++x) {
      tma_load_3d(k_s + x * kHKeys * 64, &tm_k, &bar[0], hh * D + x * 64, k0,
                  bb);
      tma_load_3d(v_s + x * kHKeys * 64, &tm_v, &bar[0], hh * D + x * 64, k0,
                  bb);
    }
    load_qdo(0);
    if (n_tiles > 1) load_qdo(1);
  }
  load_side(0);

  // this thread's keys (local to the block) and query columns within 8
  const int lane = tid & 31;
  const int r_lo = wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
  const int key0 = k0 + r_lo, key1 = key0 + 8;
  const int cq = 2 * (lane & 3);
  const int wg_last_key = k0 + wg * 64 + 63;
  float mk0 = 0.f, mk1 = 0.f;  // a mask over keys only, read once
  if (kMask == 1) {
    mk0 = key0 < sk ? mb[key0] : 0.f;
    mk1 = key1 < sk ? mb[key1] : 0.f;
  }
  constexpr float kLog2e = 1.4426950408889634f;
  float acc_v[D / 2], acc_k[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_v[i] = acc_k[i] = 0.f;

  mbar_wait(&bar[0], 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j & 1, q0 = q_begin + j * kBQ;
    mbar_wait(&bar[1 + s], (j >> 1) & 1);
    // the warpgroup's side copies of tile j are in, and its threads are
    // done with the side stage of tile j - 1: load tile j + 1's there
    cp_async_wait_all();
    named_barrier(1 + wg, 128);
    if (j + 1 < n_tiles) load_side(j + 1);

    // S^T = K Q^T and dP^T = V dO^T over D in k-steps of 16, committed as
    // two groups
    float st[kBQ / 2], dpt[kBQ / 2];
#pragma unroll
    for (int i = 0; i < kBQ / 2; ++i) st[i] = dpt[i] = 0.f;
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int x = kk / 4, off = (kk % 4) * 2;  // box, 16-byte units
      const uint64_t dq = desc_sw128(q_stage(s) + x * kBQ * 64, 16, 1024) + off;
      const uint64_t dk_ =
          desc_sw128(k_s + x * kHKeys * 64 + wg * 64 * 64, 16, 1024) + off;
      wgmma_ss_n64(st, dk_, dq, kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int x = kk / 4, off = (kk % 4) * 2;
      const uint64_t ddo =
          desc_sw128(do_stage(s) + x * kBQ * 64, 16, 1024) + off;
      const uint64_t dv_ =
          desc_sw128(v_s + x * kHKeys * 64 + wg * 64 * 64, 16, 1024) + off;
      wgmma_ss_n64(dpt, dv_, ddo, kk > 0);
    }
    wgmma_commit();
    // while the products run: the dropout keep bits of this tile (bit i
    // for register i)
    const float* lse_s = side(s);
    const float* delta_s = lse_s + kBQ;
    const unsigned* rkey_s = reinterpret_cast<const unsigned*>(lse_s + 2 * kBQ);
    uint32_t keep = 0;
    if constexpr (kDrop) {
#pragma unroll
      for (int jj = 0; jj < kBQ / 8; ++jj) {
        const uint2 rk = *reinterpret_cast<const uint2*>(rkey_s + 8 * jj + cq);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          keep |= ptt::dropout_keep((i & 1) ? rk.y : rk.x,
                                    (i & 2) ? key1 : key0, drop.threshold)
                      ? 1u << (4 * jj + i)
                      : 0u;
      }
    }
    wgmma_wait_one();  // S^T is done; dP^T may still run
    fence_regs(st);

    // p = exp(s - lse) in st, in place; P_dropped^T as bf16 A operands
    const float* mt = mask_tile(s);
    uint32_t pa[kBQ / 16][4], sa[kBQ / 16][4];
    auto form_p = [&](auto edge_c) {
      constexpr bool kEdge = decltype(edge_c)::value;
#pragma unroll
      for (int jj = 0; jj < kBQ / 8; ++jj) {
        const int ql = 8 * jj + cq;  // and ql + 1
        const float2 lq = *reinterpret_cast<const float2*>(lse_s + ql);
        float pd[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = i & 1, half = i >> 1;
          float x = st[4 * jj + i] * scale;
          if constexpr (kMask == 2)
            x += mt[(ql + e) * kHMaskLd + r_lo - wg * 64 + 8 * half];
          if constexpr (kMask == 1) x += half ? mk1 : mk0;
          float p = ex2((x - (e ? lq.y : lq.x)) * kLog2e);
          if constexpr (kEdge) {
            const int qrow = q0 + ql + e, key = half ? key1 : key0;
            const bool dead =
                (qrow >= sq) |
                (causal.on & (key + causal.k_off > qrow + causal.q_off));
            p = dead ? 0.f : p;
          }
          st[4 * jj + i] = p;
          pd[i] = p;
          if constexpr (kDrop)
            pd[i] = (keep >> (4 * jj + i)) & 1u ? p * drop.inv_keep : 0.f;
        }
        pa[jj / 2][(jj % 2) * 2] = pack_bf16(pd[0], pd[1]);
        pa[jj / 2][(jj % 2) * 2 + 1] = pack_bf16(pd[2], pd[3]);
      }
    };
    // tiles that no causal boundary or sq crosses take the copy without
    // the selects
    if (q0 + kBQ > sq ||
        (causal.on && wg_last_key + causal.k_off > q0 + causal.q_off))
      form_p(std::true_type{});
    else
      form_p(std::false_type{});
    // dV += P_dropped^T dO: dO (queries x D) is the B operand read MN-major;
    // it runs while dS is formed
    fence_regs(acc_v);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      const uint64_t ddo =
          desc_sw128(do_stage(s) + kk * 16 * 64, kBQ * 128, 1024);
      if constexpr (D == 64)
        wgmma_rs_n64(acc_v, pa[kk], ddo);
      else
        wgmma_rs_n128(acc_v, pa[kk], ddo);
    }
    wgmma_commit();
    wgmma_wait_one();  // dP^T is done; dV's product may still run
    fence_regs(dpt);

    // dS^T = p (dP_dropped - delta), as bf16 A operands
#pragma unroll
    for (int jj = 0; jj < kBQ / 8; ++jj) {
      const float2 dl = *reinterpret_cast<const float2*>(delta_s + 8 * jj + cq);
      float ds[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int i = 4 * jj + t;
        float dpv = dpt[i];
        if constexpr (kDrop)
          dpv = (keep >> i) & 1u ? dpv * drop.inv_keep : 0.f;
        ds[t] = st[i] * (dpv - ((t & 1) ? dl.y : dl.x));
      }
      sa[jj / 2][(jj % 2) * 2] = pack_bf16(ds[0], ds[1]);
      sa[jj / 2][(jj % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dK += dS^T Q: Q (queries x D) read MN-major
    fence_regs(acc_k);
    fence_regs(sa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      const uint64_t dq =
          desc_sw128(q_stage(s) + kk * 16 * 64, kBQ * 128, 1024);
      if constexpr (D == 64)
        wgmma_rs_n64(acc_k, sa[kk], dq);
      else
        wgmma_rs_n128(acc_k, sa[kk], dq);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc_v);
    fence_regs(acc_k);
    fence_regs(pa);
    fence_regs(sa);
    // every product of tile j is done in this warpgroup: the second
    // warpgroup to release its stage refills it with tile j + 2
    if (wtid == 0 && j + 2 < n_tiles && release_stage(&released[s]))
      load_qdo(j + 2);
  }

  // dV, then dK * scale: bf16 rows staged over K / V (every warpgroup is
  // past its last product and no load is in flight), 16-byte stores
  bf16* stg = reinterpret_cast<bf16*>(smem + L::k);
  constexpr int OL = D + 8;
  auto store = [&](const float(&acc)[D / 2], float mul, bf16* dst) {
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      const int c = 8 * jj + cq;
      *reinterpret_cast<uint32_t*>(stg + r_lo * OL + c) =
          pack_bf16(acc[4 * jj] * mul, acc[4 * jj + 1] * mul);
      *reinterpret_cast<uint32_t*>(stg + (r_lo + 8) * OL + c) =
          pack_bf16(acc[4 * jj + 2] * mul, acc[4 * jj + 3] * mul);
    }
    __syncthreads();
    for (int i = tid; i < kHKeys * (D / 8); i += kHThreads) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      if (k0 + r < sk)
        *reinterpret_cast<uint4*>(dst + (k0 + r) * rs + c) =
            *reinterpret_cast<const uint4*>(stg + r * OL + c);
    }
  };
  store(acc_v, 1.f, dv + base);
  store(acc_k, scale, dk + base);
}

template <int D, int kMask, bool kDrop>
int launch_dkv_sm90_kernel(const CUtensorMap& tq, const CUtensorMap& tk,
                           const CUtensorMap& tv, const CUtensorMap& tdo,
                           int vec, const Args& a, cudaStream_t st) {
  auto kern = flash_bwd_dkv_sm90_kernel<D, kMask, kDrop>;
  const size_t smem = DkvSmem<D>::bytes(kMask == 2);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.sk + kHKeys - 1) / kHKeys, a.h, a.b);
  kern<<<grid, kHThreads, smem, st>>>(
      tq, tk, tv, tdo, a.mask, vec, a.lse, a.delta, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.sq, a.sk, a.h, a.msb, a.msh, a.msq,
      a.causal, a.scale, a.drop);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_sm90(const Args& a, cudaStream_t st) {
  CUtensorMap tq, tk, tv, tdo;
  int err = ptt::sm90::make_tensor_map_bf16(&tq, a.q, a.b, a.sq, a.h * D, kBQ);
  if (!err)
    err = ptt::sm90::make_tensor_map_bf16(&tdo, a.dout, a.b, a.sq, a.h * D,
                                          kBQ);
  if (!err)
    err = ptt::sm90::make_tensor_map_bf16(&tk, a.k, a.b, a.sk, a.h * D,
                                          kHKeys);
  if (!err)
    err = ptt::sm90::make_tensor_map_bf16(&tv, a.v, a.b, a.sk, a.h * D,
                                          kHKeys);
  if (err) return err;
  // 16-byte mask copies need 16-byte aligned rows
  const int vec = a.mask != nullptr &&
                  reinterpret_cast<uintptr_t>(a.mask) % 16 == 0 &&
                  a.msb % 4 == 0 && a.msh % 4 == 0 && a.msq % 4 == 0;
  const int kind = a.mask == nullptr ? 0 : a.msq ? 2 : 1;
  const bool drop = a.drop.seed != nullptr;
#define PTT_DKV_CASE(M, P)                                                 \
  if (kind == M && drop == P)                                              \
    return launch_dkv_sm90_kernel<D, M, P>(tq, tk, tv, tdo, vec, a, st);
  PTT_DKV_CASE(0, false)
  PTT_DKV_CASE(0, true)
  PTT_DKV_CASE(1, false)
  PTT_DKV_CASE(1, true)
  PTT_DKV_CASE(2, false)
  PTT_DKV_CASE(2, true)
#undef PTT_DKV_CASE
  return (int)cudaErrorInvalidValue;
}

template <int D>
int launch_dq_wmma(const Args& a, cudaStream_t st) {
  const size_t smem = BwdSmem<D>::bytes;
  using cbf = const bf16*;
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
  return (int)cudaGetLastError();
}

int dispatch(const Args& a, int dtype, bool want_dq, void* stream) {
  if (a.d < 1 || a.d > 256) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kBF16 && a.d == 64)
    return want_dq ? launch_dq_wmma<64>(a, st) : launch_dkv_sm90<64>(a, st);
  if (dtype == ptt::kBF16 && a.d == 128)
    return want_dq ? launch_dq_wmma<128>(a, st)
                   : launch_dkv_sm90<128>(a, st);
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

// Dynamic shared memory of K3's Hopper kernel (bf16, head_dim 64 / 128), with
// or without a staged (query x key) mask tile; 0 for other head_dims.
extern "C" int ptt_flash_bwd_dkv_sm90_smem(int d, int with_mask_tile) {
  if (d == 64) return (int)DkvSmem<64>::bytes(with_mask_tile);
  if (d == 128) return (int)DkvSmem<128>::bytes(with_mask_tile);
  return 0;
}
