// Flash-attention forward for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the TPU kernel `_fwd_call` (paddle_tpu/ops/pallas_kernels.py:164,
// pallas_call at :303): softmax(q k^T * scale + mask) v with the softmax
// taken online over key tiles in fp32, an additive float mask whose batch,
// head and query dims may be size-1 broadcasts, top-left causal masking,
// the row log-sum-exp as an optional second output, and attention dropout
// (upscale_in_train: the P.V product takes where(keep, p / (1 - r), 0)
// while the softmax denominator sums the undropped p, as the TPU kernel at
// :247-255). The keep bit is the counter-based hash of (seed, batch, head,
// row, column) in common.cuh, so the backward kernels (flash_bwd.cu) and
// the plain version redraw the identical mask.
//
// Layout is the public (batch, seq, heads, head_dim) one, read in place:
// no transpose, no padding of S to the TPU's 512 blocks or of head_dim to
// 128 lanes. lse is (batch, heads, seq) fp32 (the TPU's (8, S) sublane
// broadcast is gone). Fully masked rows give out = 0 and lse = 0, as the
// TPU kernel without keep_neg_inf_lse, or lse = -inf with it.
//
// Ring form (K1r, the `offs=` / `keep_neg_inf_lse=` parameters of the TPU
// kernel, :226-227 and :263-281): causal masking at global positions
// (ptt::Causal: row + q_off >= col + k_off), the key tiles wholly in the
// future of a query tile skipped, and lse = -inf for a row that sees no key
// so that the ring's merge weighs it at zero. A query tile whose every key
// lies in the future runs no key tile and still writes out = 0 and its lse.
//
// Design. One thread block per (batch, head, 64-query tile); a loop over
// key tiles inside the block replaces the TPU grid's sequential k axis,
// and causal tiles wholly above the diagonal are skipped. Two kernels,
// chosen by what the inputs allow:
//   - bf16 with head_dim 64 or 128 (the serving path): both products on
//     the tensor cores through WMMA (mma.sync) fragments; see
//     flash_fwd_wmma_kernel below;
//   - fp32, or any other head_dim up to 256: fp32 FMAs. 8 warps own 8
//     query rows each; in the score phase lane j owns key column j of a
//     32-key tile, so each row's max and sum are warp shuffles. Q and the
//     K/V tile sit in shared memory as fp32 (K rows padded by 4 floats so
//     the lanes' float4 reads of 32 different rows hit distinct banks); P
//     goes through a per-warp shared slab and the P.V product keeps each
//     lane's head_dim slice (columns lane, lane+32, ...) in registers.
//
// What bounds it on an H100. At the prefill shapes (S <= 1024, D = 128)
// one layer's call moves ~18 MB at S=512 (q/k/v/o and the mask, ~5 us at
// 3.35 TB/s) and does ~2 GFLOP causal (~2 us at the bf16 peak): both
// bounds are microseconds, and the kernels sit far above them (PERF.md),
// limited by shared-memory traffic and per-lane softmax work. A ring step
// of (1, 4096, 32, 128) bf16 is bound by operations: 137 GFLOP for the
// live pairs of the diagonal (0.139 ms at the bf16 peak), twice that for a
// block wholly in the past; a block wholly in the future only writes its
// 32 MiB of zeros and -inf (0.010 ms).

#include <math.h>
#include <mma.h>

#include "common.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 32;
constexpr int kWarps = 8;
constexpr int kRows = kBlockQ / kWarps;  // query rows per warp
constexpr int kThreads = kWarps * 32;

template <int NC>
constexpr int smem_floats() {
  // q [64][DP] + k [32][DP+4] + v [32][DP] + p [8 warps][8 rows][32]
  return kBlockQ * NC * 32 + kBlockK * (NC * 32 + 4) + kBlockK * NC * 32 +
         kWarps * kRows * kBlockK;
}

// NC = head_dim in chunks of 32 (head_dim <= 32 * NC); T = q/k/v/out type
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ mask,
                     T* __restrict__ out, float* __restrict__ lse, int sq,
                     int sk, int h, int d, long long msb, long long msh,
                     long long msq, ptt::Causal causal, int keep_neg_inf,
                     float scale, ptt::Dropout drop) {
  constexpr int DP = NC * 32;
  constexpr int KP = DP + 4;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* q_s = smem;                   // [kBlockQ][DP]
  float* k_s = q_s + kBlockQ * DP;     // [kBlockK][KP]
  float* v_s = k_s + kBlockK * KP;     // [kBlockK][DP]
  float* p_s = v_s + kBlockK * DP;     // [kWarps][kRows][kBlockK]

  const int q0 = blockIdx.x * kBlockQ;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long rs = (long long)h * d;  // elements between sequence rows
  const T* qb = q + (long long)bb * sq * rs + (long long)hh * d;
  const T* kb = k + (long long)bb * sk * rs + (long long)hh * d;
  const T* vb = v + (long long)bb * sk * rs + (long long)hh * d;
  const float* mb =
      mask ? mask + (long long)bb * msb + (long long)hh * msh : nullptr;

  for (int i = tid; i < kBlockQ * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    q_s[i] = (q0 + r < sq && c < d) ? ptt::to_f32(qb[(q0 + r) * rs + c]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }
  float* pw = p_s + warp * kRows * kBlockK;
  const int row0 = q0 + warp * kRows;
  // dropout: one hash key per row, the per-element hash in the score loop
  const unsigned hkey =
      drop.seed ? ptt::dropout_head_key((unsigned)*drop.seed, bb, hh) : 0u;
  unsigned rkey[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    rkey[r] = ptt::dropout_row_key(hkey, row0 + r);
  // causal: the tile's rows see no key column at or past k_end
  const int k_end = causal.k_end(q0 + kBlockQ, sk);

  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed (and Q is stored)
    for (int i = tid; i < kBlockK * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      float kv = 0.f, vv = 0.f;
      if (k0 + r < sk && c < d) {
        kv = ptt::to_f32(kb[(k0 + r) * rs + c]);
        vv = ptt::to_f32(vb[(k0 + r) * rs + c]);
      }
      k_s[r * KP + c] = kv;
      v_s[r * DP + c] = vv;
    }
    __syncthreads();

    // scores of this warp's rows against key column k0 + lane
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* krow = k_s + lane * KP;
#pragma unroll 4
    for (int c = 0; c < DP; c += 4) {
      const float4 kc = *reinterpret_cast<const float4*>(krow + c);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qc =
            *reinterpret_cast<const float4*>(q_s + (warp * kRows + r) * DP + c);
        s[r] += qc.x * kc.x + qc.y * kc.y + qc.z * kc.z + qc.w * kc.w;
      }
    }
    const int col = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      float x = s[r] * scale;
      const bool live = row < sq && col < sk && !causal.masked(row, col);
      if (live && mb) x += mb[(long long)row * msq + col];
      x = live ? x : -INFINITY;
      // online softmax, all in fp32; the -inf guards mirror the TPU kernel
      const float m_new = fmaxf(m[r], ptt::warp_max(x));
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float p = x == -INFINITY ? 0.f : expf(x - m_safe);
      const float alpha = m[r] == -INFINITY ? 0.f : expf(m[r] - m_safe);
      l[r] = l[r] * alpha + ptt::warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
      // dropout acts on P.V only; l above summed the undropped p
      const bool keep =
          !drop.seed || ptt::dropout_keep(rkey[r], col, drop.threshold);
      pw[r * kBlockK + lane] = keep ? p * drop.inv_keep : 0.f;
    }
    __syncwarp();

    // acc[r][c] += sum_j p[r][j] * v[j][c*32 + lane]
#pragma unroll 2
    for (int j = 0; j < kBlockK; j += 4) {
      float vj[4][NC];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int c = 0; c < NC; ++c) vj[t][c] = v_s[(j + t) * DP + c * 32 + lane];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(pw + r * kBlockK + j);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          acc[r][c] += p4.x * vj[0][c] + p4.y * vj[1][c] + p4.z * vj[2][c] +
                       p4.w * vj[3][c];
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r;
    if (row >= sq) continue;
    const float lf = fmaxf(l[r], 1e-30f);
    T* orow = out + (long long)bb * sq * rs + row * rs + (long long)hh * d;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int cc = c * 32 + lane;
      if (cc < d) orow[cc] = ptt::from_f32<T>(acc[r][c] / lf);
    }
    if (lse != nullptr && lane == 0) {
      float v_lse = m[r] + logf(lf);
      if (v_lse == -INFINITY && !keep_neg_inf) v_lse = 0.f;
      lse[((long long)bb * h + hh) * sq + row] = v_lse;
    }
  }
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, const float* mask,
           void* out, float* lse, int b, int sq, int sk, int h, int d,
           long long msb, long long msh, long long msq, ptt::Causal causal,
           int keep_neg_inf, float scale, ptt::Dropout drop,
           cudaStream_t stream) {
  const size_t smem = smem_floats<NC>() * sizeof(float);
  auto kern = flash_fwd_kernel<T, NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + kBlockQ - 1) / kBlockQ, h, b);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), lse, sq, sk, h, d,
      msb, msh, msq, causal, keep_neg_inf, scale, drop);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const float* mask,
               void* out, float* lse, int b, int sq, int sk, int h, int d,
               long long msb, long long msh, long long msq,
               ptt::Causal causal, int keep_neg_inf, float scale,
               ptt::Dropout drop, cudaStream_t st) {
  if (d <= 32)
    return launch<T, 1>(q, k, v, mask, out, lse, b, sq, sk, h, d, msb, msh,
                        msq, causal, keep_neg_inf, scale, drop, st);
  if (d <= 64)
    return launch<T, 2>(q, k, v, mask, out, lse, b, sq, sk, h, d, msb, msh,
                        msq, causal, keep_neg_inf, scale, drop, st);
  if (d <= 128)
    return launch<T, 4>(q, k, v, mask, out, lse, b, sq, sk, h, d, msb, msh,
                        msq, causal, keep_neg_inf, scale, drop, st);
  return launch<T, 8>(q, k, v, mask, out, lse, b, sq, sk, h, d, msb, msh, msq,
                      causal, keep_neg_inf, scale, drop, st);
}

// ---------------------------------------------------------------------------
// bf16 tensor-core path (head_dim 64 or 128): the same online softmax, with
// both products on the tensor cores through WMMA (mma.sync) 16x16x16 bf16
// fragments accumulating in fp32. One block of 4 warps per (batch, head,
// 64-query tile); each warp owns 16 query rows and walks 64-key tiles.
// S = Q K^T goes through a per-warp fp32 shared slab, where two lanes per
// row take the row max / sum, write P as bf16 and rescale the warp's fp32
// output rows; O += P V then loads those rows as accumulator fragments.
// (Keeping O in registers needs the fragment layout WMMA hides; the shared
// round trip is the price of a first tensor-core version.)

namespace wm = nvcuda::wmma;
constexpr int kWQ = 64;                 // query rows per block
constexpr int kWK = 64;                 // keys per tile
constexpr int kWWarps = 4;
constexpr int kWRows = kWQ / kWWarps;   // 16 rows per warp

template <int D>
struct WmmaSmem {
  static constexpr int DP = D + 8;      // bf16 row stride of q/k/v tiles
  static constexpr int SP = kWK + 4;    // fp32 row stride of S
  static constexpr int PP = kWK + 8;    // bf16 row stride of P
  static constexpr int OP = D + 4;      // fp32 row stride of O
  static constexpr size_t q = 0;
  static constexpr size_t k = q + kWQ * DP * 2;
  static constexpr size_t v = k + kWK * DP * 2;
  static constexpr size_t s = v + kWK * DP * 2;
  static constexpr size_t p = s + kWWarps * kWRows * SP * 4;
  static constexpr size_t o = p + kWWarps * kWRows * PP * 2;
  static constexpr size_t bytes = o + kWWarps * kWRows * OP * 4;
};

template <int D>
__device__ __forceinline__ void load_tile_bf16(
    __nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src, int row0,
    int rows, long long rs) {
  // kWQ == kWK rows of D bf16, zero past `rows`
  ptt::load_tile_bf16<D, WmmaSmem<D>::DP, kWQ, kWWarps * 32>(dst, src, row0,
                                                              rows, rs);
}

template <int D>
__global__ void __launch_bounds__(kWWarps * 32)
    flash_fwd_wmma_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const float* __restrict__ mask,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ lse, int sq, int sk, int h,
                          long long msb, long long msh, long long msq,
                          ptt::Causal causal, int keep_neg_inf, float scale,
                          ptt::Dropout drop) {
  using L = WmmaSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  auto* q_s = reinterpret_cast<__nv_bfloat16*>(smem + L::q);
  auto* k_s = reinterpret_cast<__nv_bfloat16*>(smem + L::k);
  auto* v_s = reinterpret_cast<__nv_bfloat16*>(smem + L::v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* s_w = reinterpret_cast<float*>(smem + L::s) + warp * kWRows * L::SP;
  auto* p_w = reinterpret_cast<__nv_bfloat16*>(smem + L::p) +
              warp * kWRows * L::PP;
  float* o_w = reinterpret_cast<float*>(smem + L::o) + warp * kWRows * L::OP;

  const int q0 = blockIdx.x * kWQ, hh = blockIdx.y, bb = blockIdx.z;
  const long long rs = (long long)h * D;
  const __nv_bfloat16* qb = q + (long long)bb * sq * rs + (long long)hh * D;
  const __nv_bfloat16* kb = k + (long long)bb * sk * rs + (long long)hh * D;
  const __nv_bfloat16* vb = v + (long long)bb * sk * rs + (long long)hh * D;
  const float* mb =
      mask ? mask + (long long)bb * msb + (long long)hh * msh : nullptr;

  load_tile_bf16<D>(q_s, qb, q0, sq, rs);
  for (int i = lane; i < kWRows * L::OP; i += 32) o_w[i] = 0.f;

  // lane -> (row r of the warp's 16, half of the key / head_dim columns)
  const int r = lane >> 1, half = lane & 1;
  const int row = q0 + warp * kWRows + r;
  const unsigned rkey =
      drop.seed ? ptt::dropout_row_key(
                      ptt::dropout_head_key((unsigned)*drop.seed, bb, hh), row)
                : 0u;
  float m = -INFINITY, l = 0.f;
  const int k_end = causal.k_end(q0 + kWQ, sk);

  for (int k0 = 0; k0 < k_end; k0 += kWK) {
    __syncthreads();  // previous K/V tiles consumed (Q stored on entry)
    load_tile_bf16<D>(k_s, kb, k0, sk, rs);
    load_tile_bf16<D>(v_s, vb, k0, sk, rs);
    __syncthreads();

    // S (16 x 64) = Q_w (16 x D) K^T (D x 64)
    wm::fragment<wm::accumulator, 16, 16, 16, float> sf[kWK / 16];
#pragma unroll
    for (int j = 0; j < kWK / 16; ++j) wm::fill_fragment(sf[j], 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wm::fragment<wm::matrix_a, 16, 16, 16, __nv_bfloat16, wm::row_major> a;
      wm::load_matrix_sync(a, q_s + warp * kWRows * L::DP + kk * 16, L::DP);
#pragma unroll
      for (int j = 0; j < kWK / 16; ++j) {
        wm::fragment<wm::matrix_b, 16, 16, 16, __nv_bfloat16, wm::col_major>
            bf;
        wm::load_matrix_sync(bf, k_s + j * 16 * L::DP + kk * 16, L::DP);
        wm::mma_sync(sf[j], a, bf, sf[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kWK / 16; ++j)
      wm::store_matrix_sync(s_w + j * 16, sf[j], L::SP, wm::mem_row_major);
    __syncwarp();

    // online softmax of row r over this lane's 32 key columns
    float x[32];
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = k0 + half * 32 + c;
      float val = s_w[r * L::SP + half * 32 + c] * scale;
      const bool live = row < sq && col < sk && !causal.masked(row, col);
      if (live && mb) val += mb[(long long)row * msq + col];
      x[c] = live ? val : -INFINITY;
      mx = fmaxf(mx, x[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float m_safe = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = m == -INFINITY ? 0.f : expf(m - m_safe);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float pv = x[c] == -INFINITY ? 0.f : expf(x[c] - m_safe);
      sum += pv;  // the denominator takes the undropped p
      const bool keep =
          !drop.seed ||
          ptt::dropout_keep(rkey, k0 + half * 32 + c, drop.threshold);
      p_w[r * L::PP + half * 32 + c] =
          __float2bfloat16(keep ? pv * drop.inv_keep : 0.f);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * alpha + sum;
    m = m_new;
    for (int c = half * (D / 2); c < (half + 1) * (D / 2); ++c)
      o_w[r * L::OP + c] *= alpha;
    __syncwarp();

    // O_w (16 x D) += P (16 x 64) V (64 x D)
#pragma unroll
    for (int dj = 0; dj < D / 16; ++dj) {
      wm::fragment<wm::accumulator, 16, 16, 16, float> of;
      wm::load_matrix_sync(of, o_w + dj * 16, L::OP, wm::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kWK / 16; ++kk) {
        wm::fragment<wm::matrix_a, 16, 16, 16, __nv_bfloat16, wm::row_major>
            a;
        wm::fragment<wm::matrix_b, 16, 16, 16, __nv_bfloat16, wm::row_major>
            bf;
        wm::load_matrix_sync(a, p_w + kk * 16, L::PP);
        wm::load_matrix_sync(bf, v_s + kk * 16 * L::DP + dj * 16, L::DP);
        wm::mma_sync(of, a, bf, of);
      }
      wm::store_matrix_sync(o_w + dj * 16, of, L::OP, wm::mem_row_major);
    }
    __syncwarp();
  }

  if (row < sq) {
    const float lf = fmaxf(l, 1e-30f);
    __nv_bfloat16* orow = out + (long long)bb * sq * rs + row * rs +
                          (long long)hh * D;
    for (int c = half * (D / 2); c < (half + 1) * (D / 2); ++c)
      orow[c] = __float2bfloat16(o_w[r * L::OP + c] / lf);
    if (lse != nullptr && half == 0) {
      float v_lse = m + logf(lf);
      if (v_lse == -INFINITY && !keep_neg_inf) v_lse = 0.f;
      lse[((long long)bb * h + hh) * sq + row] = v_lse;
    }
  }
}

template <int D>
int launch_wmma(const void* q, const void* k, const void* v,
                const float* mask, void* out, float* lse, int b, int sq,
                int sk, int h, long long msb, long long msh, long long msq,
                ptt::Causal causal, int keep_neg_inf, float scale,
                ptt::Dropout drop, cudaStream_t stream) {
  const size_t smem = WmmaSmem<D>::bytes;
  auto kern = flash_fwd_wmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + kWQ - 1) / kWQ, h, b);
  kern<<<grid, kWWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), mask,
      static_cast<__nv_bfloat16*>(out), lse, sq, sk, h, msb, msh, msq,
      causal, keep_neg_inf, scale, drop);
  return (int)cudaGetLastError();
}

}  // namespace

// q/k/v/out: contiguous (b, s, h, d) of `dtype` (0 fp32, 1 bf16), d <= 256;
// mask: nullptr or fp32 with element strides msb/msh/msq (0 = broadcast
// dim) and unit stride over keys; lse: nullptr or (b, h, sq) fp32;
// seed: nullptr (no dropout) or a device int32, with threshold =
// floor(p * 2^32) and inv_keep = 1 / (1 - p); q_off / k_off: the global
// positions of the first query row and key column for causal masking (0, 0
// for one call); keep_neg_inf: a row that sees no key reports lse = -inf,
// not 0.
// Returns cudaGetLastError() after the launch.
extern "C" int ptt_flash_fwd(const void* q, const void* k, const void* v,
                             const void* mask, void* out, void* lse, int b,
                             int sq, int sk, int h, int d, long long msb,
                             long long msh, long long msq, int is_causal,
                             int q_off, int k_off, int keep_neg_inf,
                             float scale, const void* seed,
                             unsigned threshold, float inv_keep, int dtype,
                             void* stream) {
  if (d < 1 || d > 256) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const ptt::Causal causal{is_causal, q_off, k_off};
  const ptt::Dropout drop{static_cast<const int*>(seed), threshold,
                          seed ? inv_keep : 1.f};
  auto m = static_cast<const float*>(mask);
  auto l = static_cast<float*>(lse);
  if (dtype == ptt::kBF16 && d == 128)
    return launch_wmma<128>(q, k, v, m, out, l, b, sq, sk, h, msb, msh, msq,
                            causal, keep_neg_inf, scale, drop, st);
  if (dtype == ptt::kBF16 && d == 64)
    return launch_wmma<64>(q, k, v, m, out, l, b, sq, sk, h, msb, msh, msq,
                           causal, keep_neg_inf, scale, drop, st);
  if (dtype == ptt::kBF16)
    return dispatch_d<__nv_bfloat16>(q, k, v, m, out, l, b, sq, sk, h, d, msb,
                                     msh, msq, causal, keep_neg_inf, scale,
                                     drop, st);
  if (dtype == ptt::kF32)
    return dispatch_d<float>(q, k, v, m, out, l, b, sq, sk, h, d, msb, msh,
                             msq, causal, keep_neg_inf, scale, drop, st);
  return (int)cudaErrorInvalidValue;
}
