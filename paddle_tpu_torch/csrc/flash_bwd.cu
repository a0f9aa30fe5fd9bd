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
// `_bwd_dq_call`, :382-415), summed over the mask's size-1 dims as
// `_flash_vjp` does (:643-657). Given a `dmask` buffer, K2 writes partial
// sums of it, (groups, heads, sq, sk) fp32: block z walks the batch entries
// z * dmask_batch .. (z + 1) * dmask_batch - 1 (fewer in the last group) in
// order, and adds each entry's dS into its own rows of partial z, so the
// same thread reads, adds and writes each element, entry after entry: no
// atomics, the same bits on every run. A mask with its own batch dim takes
// one entry a group (the whole dS); a mask with batch 1 (T5's (1, h, q, k)
// bias) takes the groups the host chose (ops/flash_attention.py
// dmask_groups), and the wrapper sums the partials over the groups and the
// mask's other size-1 dims. Every element of a partial is written, zeros
// past the causal diagonal included, so the buffer needs no zeroing. The
// store is a template flag: without a buffer K2 writes none. With
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
// the tile, so a query (key) tile that no key (query) sees loads nothing
// and writes dQ = 0 (dK = dV = 0) with 16-byte stores. Offsets and d(mask)
// do not combine (the TPU kernel asserts so, :450); the wrapper refuses the
// pair.
//
// Design. A loop inside the block replaces the TPU grid's sequential axis:
// K2 runs one block per (batch group, head, 128-query tile) over key tiles,
// K3 one block per (batch, head, 128-key tile) over query tiles; causal
// tiles that contribute nothing are skipped. The code paths:
//   - bf16 with head_dim 64 or 128 (the training path, T5, the ring): the
//     Hopper kernels, flash_bwd_dq_sm90_kernel (K2) and
//     flash_bwd_dkv_sm90_kernel (K3) below: two consumer warpgroups a block
//     that run apart, the block's own rows (Q and dO for K2, K and V for K3)
//     loaded once by TMA, the streamed tiles through mbarrier stages, the
//     two score products (S and dP, or S^T and dP^T) on wgmma from shared
//     memory into fp32 registers, p, the dropout bits and dS formed in
//     registers in the accumulator layout and fed to the next products as
//     bf16 register A operands, the outputs accumulated in registers for
//     the whole loop, staged mask tiles, and a branch-free kernel per (mask
//     kind, dropout, d(mask));
//   - fp32, or other head_dims up to 256: fp32 FMAs, 8 warps of 8 rows; in
//     the score phase lane j owns column j of a 32-wide tile, and the
//     products keep each lane's head_dim slice in registers, as the
//     forward's FMA kernel.
//
// What bounds it on an H100. At ERNIE-base training shapes (b 32, h 12,
// S 512, D 64, bf16) K2 does three S x S x D products (38.7 GFLOP, 0.039 ms
// at the bf16 peak) and moves ~126 MB (0.038 ms); K3 four products (51.5
// GFLOP, 0.052 ms) and ~151 MB. Both are bound by operations. What holds
// the Hopper kernels above that is the per-element work between their
// products (exp, the mask, the dropout hash, dS, the bf16 packing), which
// they keep branch-free (the mask kind, dropout and d(mask) are template
// parameters, tile edges take their own copy of the loop), overlap with the
// tensor cores (the dropout bits are hashed while S runs; K2's dQ product of
// one tile runs under the next tile's S and dP, K3's dV product while dS is
// formed) and spread over two warpgroups that run apart (PERF.md has the
// times). With d(mask) at T5-base's encoder shape (b 32, h 12, 512 x 512,
// a (1, h, q, k) bias) K2 reads and rewrites its partials in L2 once per
// batch entry and writes groups x h x sq x sk fp32 (8 groups: 100.7 MB,
// 0.030 ms at 3.35 TB/s) instead of the whole 402.7 MB dS. A ring step of
// (1, 4096, 32, 128) bf16 is bound by operations too: K2r 0.209 ms and K3r
// 0.278 ms at the bf16 peak on the diagonal's live pairs, twice that on a
// block wholly in the past.

#include <math.h>

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
// Block z walks batch entries z * n_per .. (the d(mask) groups; n_per = 1
// without d(mask)). kDmask: also add fp32 dS into the group's partial
// (groups, h, sq, sk), lane j's column, entry after entry.
template <typename T, int NC, bool kDmask>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ mask, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, float* __restrict__ dmask, int b, int n_per, int sq,
    int sk, int h, int d, long long msb, long long msh, long long msq,
    ptt::Causal causal, float scale, ptt::Dropout drop) {
  constexpr int DP = NC * 32;
  constexpr int KP = DP + 4;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [kBR][DP]
  float* do_s = q_s + kBR * DP;                   // [kBR][DP]
  float* k_s = do_s + kBR * DP;                   // [kBC][KP]
  float* v_s = k_s + kBC * KP;                    // [kBC][KP]
  float* ds_s = v_s + kBC * KP;                   // [kWarps][kRows][kBC]

  const int q0 = blockIdx.x * kBR, hh = blockIdx.y;
  const int b0 = blockIdx.z * n_per, b1 = min(b, b0 + n_per);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long rs = (long long)h * d;
  const long long head = (long long)hh * d;
  float* dmb =
      kDmask ? dmask + ((long long)blockIdx.z * h + hh) * sq * sk : nullptr;
  const int row0 = q0 + warp * kRows;
  const int k_end = causal.k_end(q0 + kBR, sk);
  float* dsw = ds_s + warp * kRows * kBC;

  if (kDmask) {
    // the key columns no tile visits (past the causal diagonal): zeros
    const int c0 = min((k_end + kBC - 1) / kBC * kBC, sk), w = sk - c0;
    for (int i = threadIdx.x; i < kBR * w; i += kThreads) {
      const int r = i / w, c = c0 + i % w;
      if (q0 + r < sq) dmb[(long long)(q0 + r) * sk + c] = 0.f;
    }
  }

  for (int bb = b0; bb < b1; ++bb) {
    __syncthreads();  // the previous entry's q and dO are consumed
    const T* kb = k + (long long)bb * sk * rs + head;
    const T* vb = v + (long long)bb * sk * rs + head;
    const float* mb =
        mask ? mask + (long long)bb * msb + (long long)hh * msh : nullptr;
    const long long lrow = ((long long)bb * h + hh) * sq;  // lse / delta row
    load_tile_f32<T, DP, kBR>(q_s, DP, q + (long long)bb * sq * rs + head,
                              q0, sq, d, rs);
    load_tile_f32<T, DP, kBR>(do_s, DP,
                              dout + (long long)bb * sq * rs + head, q0, sq,
                              d, rs);
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
        if (kDmask && row < sq && col < sk) {
          float* pm = dmb + (long long)row * sk + col;
          *pm = bb > b0 ? *pm + ds : ds;
        }
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
          const float4 s4 =
              *reinterpret_cast<const float4*>(dsw + r * kBC + j);
#pragma unroll
          for (int c = 0; c < NC; ++c)
            acc[r][c] += s4.x * kj[0][c] + s4.y * kj[1][c] +
                         s4.z * kj[2][c] + s4.w * kj[3][c];
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
  float* dmask;  // K2's d(mask) partials, or nullptr
  int b, n_per;  // batch, and the batch entries a K2 block walks
  int sq, sk, h, d;
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
    dim3 grid((a.sq + kBR - 1) / kBR, a.h, (a.b + a.n_per - 1) / a.n_per);
    kern<<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), a.mask, static_cast<const T*>(a.dout),
        a.lse, a.delta, static_cast<T*>(a.dq), a.dmask, a.b, a.n_per, a.sq,
        a.sk, a.h, a.d, a.msb, a.msh, a.msq, a.causal, a.scale, a.drop);
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

using bf16 = __nv_bfloat16;

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

// ------------------------------------------------------ K2, bf16 (Hopper)
// One block of two consumer warpgroups per (batch group, head, 128-query
// tile); warpgroup w owns query rows 64w .. 64w+63. Q and dO arrive once a
// batch entry by TMA; the K / V tiles of 64 keys stream through a ring of
// shared-memory stages (three; two at head_dim 128 with a staged mask
// tile), each with its mbarrier, tiles t+1 .. in flight while tile t is
// computed; the ring runs on across the batch entries a block walks, so
// the next entry's first tiles land during this one's last. The
// warpgroups run apart (no block barrier in the loop): a stage is refilled
// by whichever warpgroup releases it second. Each warpgroup stages its own
// rows of the mask (cp.async, 16-byte copies where the rows allow, 4-byte
// ones else, zero-filled past sq / sk) in a ring of two stages behind a
// barrier of its own 128 threads; lse, delta and the dropout row keys of a
// thread's two rows sit in its registers. Per key tile t, in one warpgroup:
//   S = Q K_t^T, dP = dO V_t^T   wgmma m64n64k16, both operands from shared
//                                memory, fp32 registers, issued and
//                                committed together behind the dQ product
//                                of tile t-1, which is still running;
//   the dropout keep bits        hashed while the products run;
//   p = exp(S scale + m - lse)   in registers (the accumulator layout of
//                                common.cuh): at head_dim 64 once S is
//                                done, while dP runs; at 128 in one pass
//                                with dS once both are done (each form
//                                measured the faster at its head_dim);
//   dS = p (dP_dropped - delta)  in registers, rounded to bf16 A operands
//                                (and added in fp32 into the d(mask)
//                                partial);
//   dQ += dS K_t                 wgmma m64nDk16, A from registers, K read
//                                MN-major through its descriptor (as K1
//                                reads V for P V), left running into
//                                the next tile (issued instead behind the
//                                next tile's S and dP and waited within
//                                it, as K1 orders P V, it read 18-41%
//                                slower, though it spares the wait that
//                                ptxas injects for this form, C7517).
// dQ stays in fp32 registers for a batch entry's whole loop and is written
// once, times scale, staged as bf16 rows over Q / dO for 16-byte stores.

constexpr int kDqRows = 128;  // query rows a block (two warpgroups)
constexpr int kDqKeys = 64;   // keys a K / V tile

// K / V stages: three, or two where a staged mask tile leaves no room
template <int D, int kMask>
__host__ __device__ constexpr int dq_stages() {
  return D == 128 && kMask == 2 ? 2 : 3;
}

// kMRows: the mask rows a warpgroup stages a tile (0 none, 1 a mask over
// keys only, 64 a mask with query rows)
template <int D, int kStages, int kMRows>
struct DqSmem {
  static constexpr int mask_ld = kDqKeys + 8;       // fp32 row stride
  static constexpr size_t bars = 0;                 // Q/dO, K/V stages
  static constexpr size_t counts = 64;              // K/V stage releases
  static constexpr size_t qt = (size_t)kDqRows * D * 2;  // Q or dO
  static constexpr size_t q = 1024;                 // [D/64][kDqRows][64]
  static constexpr size_t dout = q + qt;            // [D/64][kDqRows][64]
  static constexpr size_t tile = (size_t)kDqKeys * D * 2;  // K or V tile
  // [kStages][K, V][D/64][kDqKeys][64]
  static constexpr size_t kv = dout + qt;
  // [2 stages][2 warpgroups][kMRows][mask_ld]
  static constexpr size_t mask = kv + 2 * kStages * tile;
  // +1024 for the alignment of the base
  static constexpr size_t bytes = mask + (size_t)4 * kMRows * mask_ld * 4 +
                                  1024;
  // the epilogue's bf16 rows [kDqRows][D + 8] reuse Q / dO
  static_assert((size_t)kDqRows * (D + 8) * 2 <= 2 * qt, "dQ staging");
};

template <int D, int kMask>
using DqLayout =
    DqSmem<D, dq_stages<D, kMask>(), kMask == 2 ? 64 : kMask>;

// kMask: 0 none, 1 a mask over keys only ((b|1, h|1, 1, k): one row staged
// a tile), 2 a mask with query rows; kDrop: attention dropout; kDmask: add
// dS into the d(mask) partial of the block's batch group. Each case is its
// own kernel, so the per-element code carries no branch.
template <int D, int kMask, bool kDrop, bool kDmask>
__global__ void __launch_bounds__(kHThreads, 1) flash_bwd_dq_sm90_kernel(
    __grid_constant__ const CUtensorMap tm_q,
    __grid_constant__ const CUtensorMap tm_k,
    __grid_constant__ const CUtensorMap tm_v,
    __grid_constant__ const CUtensorMap tm_do, const float* __restrict__ mask,
    int mask_vec, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq,
    float* __restrict__ dmask, int b, int n_per, int sq, int sk, int h,
    long long msb, long long msh, long long msq, ptt::Causal causal,
    float scale, ptt::Dropout drop) {
  constexpr int BK = kDqKeys;
  constexpr int kStages = dq_stages<D, kMask>();
  constexpr int kMRows = kMask == 2 ? 64 : kMask;
  using L = DqLayout<D, kMask>;
  using namespace ptt::sm90;
  constexpr int NB = D / 64;  // 64-column boxes of a row
  constexpr int ML = L::mask_ld;
  const int q0 = blockIdx.x * kDqRows, hh = blockIdx.y;
  // the batch entries this block walks
  const int b0 = blockIdx.z * n_per, n_b = min(b - b0, n_per);
  const int tid = threadIdx.x;
  const long long rs = (long long)h * D;
  // causal: the tile's rows see no key column at or past k_end
  const int n_tiles = (causal.k_end(q0 + kDqRows, sk) + BK - 1) / BK;
  // this block's rows of its group's d(mask) partial (groups, h, sq, sk)
  float* pm =
      kDmask ? dmask + ((long long)blockIdx.z * h + hh) * sq * sk : nullptr;

  if constexpr (kDmask) {
    // the key columns no tile visits (past the causal diagonal): zeros
    const int c0 = min(n_tiles * BK, sk), w = sk - c0;
    for (int i = tid; i < kDqRows * w; i += kHThreads) {
      const int r = i / w, c = c0 + i % w;
      if (q0 + r < sq) pm[(long long)(q0 + r) * sk + c] = 0.f;
    }
  }
  if (n_tiles == 0) {
    // no row sees a key (a ring step in the future): no load, dQ = 0
    for (int e = 0; e < n_b; ++e) {
      bf16* ob = dq + (long long)(b0 + e) * sq * rs + (long long)hh * D;
      for (int i = tid; i < kDqRows * (D / 8); i += kHThreads) {
        const int r = i / (D / 8), c = (i % (D / 8)) * 8;
        if (q0 + r < sq)
          *reinterpret_cast<uint4*>(ob + (q0 + r) * rs + c) =
              make_uint4(0, 0, 0, 0);
      }
    }
    return;
  }

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::bars);
  int* released = reinterpret_cast<int*>(smem + L::counts);
  bf16* q_s = reinterpret_cast<bf16*>(smem + L::q);
  bf16* do_s = reinterpret_cast<bf16*>(smem + L::dout);
  auto k_stage = [&](int s) {
    return reinterpret_cast<bf16*>(smem + L::kv + (size_t)s * 2 * L::tile);
  };
  auto v_stage = [&](int s) {
    return reinterpret_cast<bf16*>(smem + L::kv +
                                   (size_t)(s * 2 + 1) * L::tile);
  };
  const int wg = tid >> 7, wtid = tid & 127;  // warpgroup, thread in it
  auto mask_stage = [&](int s) {
    return reinterpret_cast<float*>(smem + L::mask) +
           (s * 2 + wg) * kMRows * ML;
  };

  if (tid == 0) {
    for (int i = 0; i <= kStages; ++i) mbar_init(&bar[i], 1);
    for (int i = 0; i < kStages; ++i) released[i] = 0;
    fence_barrier_init();
  }
  __syncthreads();

  const int n_total = n_b * n_tiles;  // key tiles over the walk
  auto load_qdo = [&](int e) {        // one thread: entry e's Q and dO
    mbar_expect_tx(&bar[0], (unsigned)(2 * L::qt));
#pragma unroll
    for (int x = 0; x < NB; ++x) {
      tma_load_3d(q_s + x * kDqRows * 64, &tm_q, &bar[0], hh * D + x * 64,
                  q0, b0 + e);
      tma_load_3d(do_s + x * kDqRows * 64, &tm_do, &bar[0], hh * D + x * 64,
                  q0, b0 + e);
    }
  };
  auto load_kv = [&](int t) {  // one thread: tile t of the walk
    const int s = t % kStages, e = t / n_tiles, j = t - e * n_tiles;
    mbar_expect_tx(&bar[1 + s], (unsigned)(2 * L::tile));
#pragma unroll
    for (int x = 0; x < NB; ++x) {
      tma_load_3d(k_stage(s) + x * BK * 64, &tm_k, &bar[1 + s],
                  hh * D + x * 64, j * BK, b0 + e);
      tma_load_3d(v_stage(s) + x * BK * 64, &tm_v, &bar[1 + s],
                  hh * D + x * 64, j * BK, b0 + e);
    }
  };
  auto load_mask = [&](int t) {  // the warpgroup's rows, one commit group
    const int e = t / n_tiles, j = t - e * n_tiles;
    const float* mb =
        mask + (long long)(b0 + e) * msb + (long long)hh * msh;
    float* dst = mask_stage(t & 1);
    const int k0 = j * BK, r0 = q0 + wg * 64;
    if (mask_vec) {
      for (int i = wtid; i < kMRows * (BK / 4); i += 128) {
        const int r = i / (BK / 4), c = (i % (BK / 4)) * 4;
        const int n = r0 + r < sq ? min(max(sk - k0 - c, 0), 4) : 0;
        cp_async_16(dst + r * ML + c,
                    n ? mb + (long long)(r0 + r) * msq + k0 + c : mb, n * 4);
      }
    } else {
      for (int i = wtid; i < kMRows * BK; i += 128) {
        const int r = i / BK, c = i % BK;
        const bool ok = r0 + r < sq && k0 + c < sk;
        cp_async_4(dst + r * ML + c,
                   ok ? mb + (long long)(r0 + r) * msq + k0 + c : mb, ok);
      }
    }
    cp_async_commit();
  };

  if (tid == 0) {
    load_qdo(0);
    for (int t = 0; t < kStages && t < n_total; ++t) load_kv(t);
  }
  if constexpr (kMask != 0) load_mask(0);

  // this thread's rows (local to the block) and columns within 8
  const int lane = tid & 31;
  const int r_lo = wg * 64 + (wtid >> 5) * 16 + (lane >> 2);
  const int row0 = q0 + r_lo, row1 = row0 + 8;
  const int cq = 2 * (lane & 3);
  const int wg_row = q0 + wg * 64;  // the warpgroup's first row
  // d(mask) rows are float2 aligned when sk is even
  const bool v2 = (sk & 1) == 0;
  constexpr float kLog2e = 1.4426950408889634f;
  // without a mask, p = 2^(s scale log2(e) - lse log2(e)): lse in log2
  // units; with one, lse stays in natural units (the element pass says why)
  constexpr float kLseUnit = kMask ? 1.f : kLog2e;
  const float scale_l2 = scale * kLog2e;
  float dqa[D / 2];            // dQ of the current batch entry
  uint32_t dsa[BK / 16][4];    // dS of the last tile, the A operand
  float lse0 = 0.f, lse1 = 0.f, dl0 = 0.f, dl1 = 0.f;
  unsigned rkey0 = 0, rkey1 = 0;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) dsa[kk][i] = 0u;

  // a stage the second warpgroup releases is refilled with the tile
  // kStages further on
  auto release = [&](int t) {
    if (wtid == 0 && t + kStages < n_total &&
        release_stage(&released[t % kStages]))
      load_kv(t + kStages);
  };

  for (int t = 0, e = 0, j = 0; t < n_total; ++t) {
    const int s = t % kStages, k0 = j * BK;
    if (j == 0) {
      // a new batch entry: its rows' lse, delta and dropout keys, dQ = 0
      const int bb = b0 + e;
      const long long lrow = ((long long)bb * h + hh) * sq;
      lse0 = row0 < sq ? lse[lrow + row0] * kLseUnit : 0.f;
      lse1 = row1 < sq ? lse[lrow + row1] * kLseUnit : 0.f;
      dl0 = row0 < sq ? delta[lrow + row0] : 0.f;
      dl1 = row1 < sq ? delta[lrow + row1] : 0.f;
      if constexpr (kDrop) {
        const unsigned hk =
            ptt::dropout_head_key((unsigned)*drop.seed, bb, hh);
        rkey0 = ptt::dropout_row_key(hk, row0);
        rkey1 = ptt::dropout_row_key(hk, row1);
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
      mbar_wait(&bar[0], e & 1);
    }
    mbar_wait(&bar[1 + s], (t / kStages) & 1);
    if constexpr (kMask != 0) {
      // the warpgroup's mask copies of tile t are in, and its threads are
      // done with the mask stage of tile t - 1: load tile t + 1's there
      cp_async_wait_all();
      named_barrier(1 + wg, 128);
      if (t + 1 < n_total) load_mask(t + 1);
    }

    // S = Q K^T and dP = dO V^T over D in k-steps of 16 (32 bytes inside a
    // 128-byte box), committed as two groups behind tile t-1's dQ product
    float sacc[BK / 2], dpa[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sacc[i] = dpa[i] = 0.f;
    fence_regs(sacc);
    fence_regs(dpa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int x = kk / 4, off = (kk % 4) * 2;  // box, 16-byte units
      const uint64_t dq_ =
          desc_sw128(q_s + x * kDqRows * 64 + wg * 64 * 64, 16, 1024) + off;
      const uint64_t dk = desc_sw128(k_stage(s) + x * BK * 64, 16, 1024) + off;
      wgmma_ss_n64(sacc, dq_, dk, kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int x = kk / 4, off = (kk % 4) * 2;
      const uint64_t ddo =
          desc_sw128(do_s + x * kDqRows * 64 + wg * 64 * 64, 16, 1024) + off;
      const uint64_t dv = desc_sw128(v_stage(s) + x * BK * 64, 16, 1024) + off;
      wgmma_ss_n64(dpa, ddo, dv, kk > 0);
    }
    wgmma_commit();
    // while the products run: this tile's dropout keep bits (bit 4 jj + i
    // for register 4 jj + i) and the d(mask) partial's sums of the group's
    // earlier entries
    uint32_t keep = 0;
    if constexpr (kDrop) {
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          keep |= ptt::dropout_keep(i < 2 ? rkey0 : rkey1,
                                    k0 + 8 * jj + cq + (i & 1),
                                    drop.threshold)
                      ? 1u << (4 * jj + i)
                      : 0u;
    }
    float dmo[kDmask ? BK / 2 : 1];
    if constexpr (kDmask) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) dmo[i] = 0.f;
      if (e > 0) {
#pragma unroll
        for (int jj = 0; jj < BK / 8; ++jj) {
          const int col = k0 + 8 * jj + cq;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = r ? row1 : row0;
            const float* src = pm + (long long)row * sk + col;
            if (row < sq && col < sk) {
              if (v2) {
                const float2 o = *reinterpret_cast<const float2*>(src);
                dmo[4 * jj + 2 * r] = o.x;
                dmo[4 * jj + 2 * r + 1] = o.y;
              } else {
                dmo[4 * jj + 2 * r] = src[0];
                if (col + 1 < sk) dmo[4 * jj + 2 * r + 1] = src[1];
              }
            }
          }
        }
      }
    }
    // One pass over the tile's elements: with kP, p = exp(S scale + mask -
    // lse), 0 where causal or past sk (in sacc unless the same pass goes
    // on); with kDs, dS = p (dP_dropped - delta), rounded to bf16 A
    // operands of dQ += dS K and added in fp32 into the d(mask) partial.
    // With a mask, p follows the TPU kernel's (and the plain version's)
    // order of roundings, S scale, + mask, - lse: a row whose visible keys
    // all carry a padding value of -1e4 has logits and lse near -1e4, where
    // one fp32 ulp is 1e-3, so p there follows the order in which they are
    // rounded (d(mask) read 2e-4 of its value off in another order).
    auto pass = [&](auto edge_c, auto p_c, auto ds_c) {
      constexpr bool kEdge = decltype(edge_c)::value;
      constexpr bool kP = decltype(p_c)::value, kDs = decltype(ds_c)::value;
      const float* ms0 = mask_stage(t & 1) +
                         (kMask == 2 ? (r_lo - wg * 64) * ML : 0);
      const float* ms1 = ms0 + (kMask == 2 ? 8 * ML : 0);
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj) {
        const int cl = 8 * jj + cq;
        float2 mk0 = make_float2(0.f, 0.f), mk1 = mk0;
        if constexpr (kP && kMask != 0) {
          mk0 = *reinterpret_cast<const float2*>(ms0 + cl);
          mk1 = *reinterpret_cast<const float2*>(ms1 + cl);
        }
        float ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e2 = i & 1, hr = i >> 1;  // column of the pair, row
          float p = sacc[4 * jj + i];
          if constexpr (kP) {
            if constexpr (kMask != 0) {
              const float m = hr ? (e2 ? mk1.y : mk1.x) : (e2 ? mk0.y : mk0.x);
              const float x = __fadd_rn(__fmul_rn(p, scale), m);
              p = ex2((x - (hr ? lse1 : lse0)) * kLog2e);
            } else {
              p = ex2(fmaf(p, scale_l2, -(hr ? lse1 : lse0)));
            }
            if constexpr (kEdge) {
              const int col = k0 + cl + e2, row = hr ? row1 : row0;
              const bool dead =
                  (col >= sk) |
                  (causal.on & (col + causal.k_off > row + causal.q_off));
              p = dead ? 0.f : p;
            }
            if constexpr (!kDs) sacc[4 * jj + i] = p;
          }
          if constexpr (kDs) {
            float dpv = dpa[4 * jj + i];
            if constexpr (kDrop)
              dpv = (keep >> (4 * jj + i)) & 1u ? dpv * drop.inv_keep : 0.f;
            ds[i] = p * (dpv - (hr ? dl1 : dl0));
          }
        }
        if constexpr (kDs) {
          dsa[jj / 2][(jj % 2) * 2] = pack_bf16(ds[0], ds[1]);
          dsa[jj / 2][(jj % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
        }
        if constexpr (kDs && kDmask) {
          const int col = k0 + cl;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = r ? row1 : row0;
            float* dst = pm + (long long)row * sk + col;
            const float a0 = ds[2 * r] + dmo[4 * jj + 2 * r];
            const float a1 = ds[2 * r + 1] + dmo[4 * jj + 2 * r + 1];
            if (row < sq && col < sk) {
              if (v2) {
                *reinterpret_cast<float2*>(dst) = make_float2(a0, a1);
              } else {
                dst[0] = a0;
                if (col + 1 < sk) dst[1] = a1;
              }
            }
          }
        }
      }
    };
    using yes = std::true_type;
    using no = std::false_type;
    // tiles that no causal boundary or sk crosses take the copy without
    // the selects
    const bool edge =
        k0 + BK > sk ||
        (causal.on && k0 + BK - 1 + causal.k_off > wg_row + causal.q_off);
    if constexpr (D == 128) {
      // wait for S and dP together, then p and dS in one pass (faster at
      // head_dim 128, where the products are long: PERF.md section 6)
      wgmma_wait_all();  // (and tile t-1's dQ product)
      fence_regs(sacc);
      fence_regs(dpa);
      fence_regs(dqa);
      fence_regs(dsa);
      if (j > 0) release(t - 1);
      if (edge)
        pass(yes{}, yes{}, yes{});
      else
        pass(no{}, yes{}, yes{});
    } else {
      // p while dP still runs, then dS (faster at head_dim 64)
      wgmma_wait_one();  // S is done (and tile t-1's dQ product)
      fence_regs(sacc);
      fence_regs(dqa);
      fence_regs(dsa);
      if (j > 0) release(t - 1);
      if (edge)
        pass(yes{}, yes{}, no{});
      else
        pass(no{}, yes{}, no{});
      wgmma_wait_all();  // dP is done
      fence_regs(dpa);
      pass(no{}, no{}, yes{});
    }

    // dQ += dS K: K (keys x D) is the B operand read MN-major; it runs
    // under the next tile's S and dP
    fence_regs(dqa);
    fence_regs(dsa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dk = desc_sw128(k_stage(s) + kk * 16 * 64, BK * 128, 1024);
      if constexpr (D == 64)
        wgmma_rs_n64(dqa, dsa[kk], dk);
      else
        wgmma_rs_n128(dqa, dsa[kk], dk);
    }
    wgmma_commit();

    if (++j < n_tiles) continue;
    // the entry's last tile: dQ is complete
    wgmma_wait_all();
    fence_regs(dqa);
    fence_regs(dsa);
    release(t);
    // stage dQ * scale as bf16 rows over Q / dO (both warpgroups are past
    // their products on them), then 16-byte stores
    __syncthreads();
    bf16* stg = q_s;
    constexpr int OL = D + 8;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      const int c = 8 * jj + cq;
      *reinterpret_cast<uint32_t*>(stg + r_lo * OL + c) =
          pack_bf16(dqa[4 * jj] * scale, dqa[4 * jj + 1] * scale);
      *reinterpret_cast<uint32_t*>(stg + (r_lo + 8) * OL + c) =
          pack_bf16(dqa[4 * jj + 2] * scale, dqa[4 * jj + 3] * scale);
    }
    __syncthreads();
    bf16* ob = dq + (long long)(b0 + e) * sq * rs + (long long)hh * D;
    for (int i = tid; i < kDqRows * (D / 8); i += kHThreads) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      if (q0 + r < sq)
        *reinterpret_cast<uint4*>(ob + (q0 + r) * rs + c) =
            *reinterpret_cast<const uint4*>(stg + r * OL + c);
    }
    j = 0;
    if (++e < n_b) {
      // the staging's reads (generic proxy) come before the next entry's
      // Q / dO land there (async proxy)
      fence_proxy_async();
      __syncthreads();
      if (tid == 0) load_qdo(e);
    }
  }
}

template <int D, int kMask, bool kDrop, bool kDmask>
int launch_dq_sm90_kernel(const CUtensorMap& tq, const CUtensorMap& tk,
                          const CUtensorMap& tv, const CUtensorMap& tdo,
                          int vec, const Args& a, cudaStream_t st) {
  auto kern = flash_bwd_dq_sm90_kernel<D, kMask, kDrop, kDmask>;
  const size_t smem = DqLayout<D, kMask>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.sq + kDqRows - 1) / kDqRows, a.h,
            (a.b + a.n_per - 1) / a.n_per);
  kern<<<grid, kHThreads, smem, st>>>(
      tq, tk, tv, tdo, a.mask, vec, a.lse, a.delta, static_cast<bf16*>(a.dq),
      a.dmask, a.b, a.n_per, a.sq, a.sk, a.h, a.msb, a.msh, a.msq, a.causal,
      a.scale, a.drop);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_sm90(const Args& a, cudaStream_t st) {
  CUtensorMap tq, tk, tv, tdo;
  int err =
      ptt::sm90::make_tensor_map_bf16(&tq, a.q, a.b, a.sq, a.h * D, kDqRows);
  if (!err)
    err = ptt::sm90::make_tensor_map_bf16(&tdo, a.dout, a.b, a.sq, a.h * D,
                                          kDqRows);
  if (!err)
    err = ptt::sm90::make_tensor_map_bf16(&tk, a.k, a.b, a.sk, a.h * D,
                                          kDqKeys);
  if (!err)
    err = ptt::sm90::make_tensor_map_bf16(&tv, a.v, a.b, a.sk, a.h * D,
                                          kDqKeys);
  if (err) return err;
  // 16-byte mask copies need 16-byte aligned rows
  const int vec = a.mask != nullptr &&
                  reinterpret_cast<uintptr_t>(a.mask) % 16 == 0 &&
                  a.msb % 4 == 0 && a.msh % 4 == 0 && a.msq % 4 == 0;
  const int kind = a.mask == nullptr ? 0 : a.msq ? 2 : 1;
  const bool drop = a.drop.seed != nullptr, dm = a.dmask != nullptr;
#define PTT_DQ_CASE(M, P, G)                                               \
  if (kind == M && drop == P && dm == G)                                   \
    return launch_dq_sm90_kernel<D, M, P, G>(tq, tk, tv, tdo, vec, a, st);
  PTT_DQ_CASE(0, false, false)
  PTT_DQ_CASE(0, true, false)
  PTT_DQ_CASE(1, false, false)
  PTT_DQ_CASE(1, true, false)
  PTT_DQ_CASE(1, false, true)
  PTT_DQ_CASE(1, true, true)
  PTT_DQ_CASE(2, false, false)
  PTT_DQ_CASE(2, true, false)
  PTT_DQ_CASE(2, false, true)
  PTT_DQ_CASE(2, true, true)
#undef PTT_DQ_CASE
  return (int)cudaErrorInvalidValue;  // d(mask) without a mask
}

int dispatch(const Args& a, int dtype, bool want_dq, void* stream) {
  if (a.d < 1 || a.d > 256) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kBF16 && a.d == 64)
    return want_dq ? launch_dq_sm90<64>(a, st) : launch_dkv_sm90<64>(a, st);
  if (dtype == ptt::kBF16 && a.d == 128)
    return want_dq ? launch_dq_sm90<128>(a, st)
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
// only): nullptr, or a contiguous (ceil(b / dmask_batch), h, sq, sk) fp32
// buffer for d(mask)'s partial sums, group g summing dS over the batch
// entries g * dmask_batch .. (the kernel writes every element);
// dmask_batch: 1 without dmask, and 1 for a mask with its own batch dim;
// q_off / k_off: the global positions of the first query row and key
// column for causal masking (0, 0 for one call).
// Each returns cudaGetLastError() after its launch.
extern "C" int ptt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* mask, const void* dout,
                                const void* lse, const void* delta, void* dq,
                                void* dmask, int b, int dmask_batch, int sq,
                                int sk, int h, int d, long long msb,
                                long long msh, long long msq, int is_causal,
                                int q_off, int k_off, float scale,
                                const void* seed, unsigned threshold,
                                float inv_keep, int dtype, void* stream) {
  if (dmask_batch < 1 || (dmask != nullptr && mask == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout,
               static_cast<const float*>(mask),
               static_cast<const float*>(lse),
               static_cast<const float*>(delta),
               dq, nullptr, nullptr, static_cast<float*>(dmask),
               b, dmask ? dmask_batch : 1, sq, sk, h, d, msb, msh, msq,
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
               nullptr, dk, dv, nullptr, b, 1, sq, sk, h, d, msb, msh, msq,
               ptt::Causal{is_causal, q_off, k_off}, scale,
               ptt::Dropout{static_cast<const int*>(seed), threshold,
                            seed ? inv_keep : 1.f}};
  return dispatch(a, dtype, false, stream);
}

// Dynamic shared memory of K2's Hopper kernel (bf16, head_dim 64 / 128), with
// or without a staged (query x key) mask tile; 0 for other head_dims.
extern "C" int ptt_flash_bwd_dq_sm90_smem(int d, int with_mask_tile) {
  if (d == 64)
    return (int)(with_mask_tile ? DqLayout<64, 2>::bytes
                                : DqLayout<64, 0>::bytes);
  if (d == 128)
    return (int)(with_mask_tile ? DqLayout<128, 2>::bytes
                                : DqLayout<128, 0>::bytes);
  return 0;
}

// Dynamic shared memory of K3's Hopper kernel (bf16, head_dim 64 / 128), with
// or without a staged (query x key) mask tile; 0 for other head_dims.
extern "C" int ptt_flash_bwd_dkv_sm90_smem(int d, int with_mask_tile) {
  if (d == 64) return (int)DkvSmem<64>::bytes(with_mask_tile);
  if (d == 128) return (int)DkvSmem<128>::bytes(with_mask_tile);
  return 0;
}
