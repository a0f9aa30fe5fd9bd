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
// lies in the future loads nothing and only writes out = 0 and its lse with
// 16-byte stores.
//
// Design. One thread block per (batch, head, query tile); a loop over key
// tiles inside the block replaces the TPU grid's sequential k axis, and
// causal tiles wholly above the diagonal are skipped. Two kernels, chosen by
// what the inputs allow:
//   - bf16 with head_dim 64 or 128 (serving, training, the ring): the
//     Hopper kernel below, flash_fwd_sm90_kernel: TMA loads into a ring of
//     shared-memory stages with mbarriers, both products on wgmma, S and P
//     in registers (P the register A operand of P V), O accumulated in
//     registers for the whole loop, a staged mask tile, two warpgroups that
//     run apart;
//   - fp32, or any other head_dim up to 256: fp32 FMAs. 8 warps own 8
//     query rows each; in the score phase lane j owns key column j of a
//     32-key tile, so each row's max and sum are warp shuffles. Q and the
//     K/V tile sit in shared memory as fp32 (K rows padded by 4 floats so
//     the lanes' float4 reads of 32 different rows hit distinct banks); P
//     goes through a per-warp shared slab and the P.V product keeps each
//     lane's head_dim slice (columns lane, lane+32, ...) in registers.
//
// What bounds it on an H100. A ring step of (1, 4096, 32, 128) bf16 is
// bound by operations: 137 GFLOP for the live pairs of the diagonal (0.139
// ms at the bf16 peak), twice that for a block wholly in the past; a block
// wholly in the future only writes its 32 MiB of zeros and -inf (0.010 ms).
// At the training and prefill shapes (S <= 1024) the bytes bound (q/k/v/o,
// the mask) and the operations bound are both a few tens of microseconds.
// What holds the Hopper kernel above them is the per-element work between
// the two products (scale, mask, causal and dropout selects, exp, the
// dropout hash, the bf16 packing): it is branch-free (the mask kind and
// dropout are template parameters, a tile that no causal boundary crosses
// takes a copy without the selects), the dropout bits are hashed while S is
// on the tensor cores, the softmax of tile j runs under P_{j-1} V_{j-1}, and
// the two warpgroups drift apart so that one's softmax meets the other's
// products. PERF.md section 6 has the times.

#include <math.h>

#include <type_traits>

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
// bf16, head_dim 64 or 128: the Hopper kernel. One block of two consumer
// warpgroups per (batch, head, 128-query tile); warpgroup w owns query rows
// 64w .. 64w+63 of the tile. TMA brings Q once, then the K / V tiles (64 or
// 128 keys, fwd_tile_keys) into a ring of three shared-memory stages, each
// with its mbarrier: tiles j+1 and j+2 are in flight while tile j is
// computed. The warpgroups run apart (no block barrier in the loop), so
// one's softmax overlaps the other's products: a stage is refilled by
// whichever warpgroup releases it second. Each warpgroup stages its own rows
// of the mask (cp.async, zero-filled past sq / sk; 16-byte copies where the
// mask's rows allow) in a ring of two stages, behind a barrier of its own
// 128 threads.
// Per key tile j, in one warpgroup:
//   S_j = Q K_j^T      wgmma m64nBKk16, both operands from shared memory, S
//                      in fp32 registers (the accumulator layout of
//                      common.cuh), issued together with
//   O += P_{j-1} V_{j-1}   wgmma m64nDk16, P from registers (bf16, the A
//                      operand), V read MN-major (transposed) through its
//                      descriptor;
//   softmax of S_j     scale, mask, causal at offsets, the online max and
//                      sum in registers (a shuffle across the 4 lanes of a
//                      row), while the P V product runs on the tensor cores;
//   P_j                dropped and rescaled, rounded to bf16 in registers:
//                      never stored. O is rescaled once P V is done.
// O, m and l stay in registers for the whole loop; the epilogue stages O as
// bf16 rows in shared memory and writes them with 16-byte stores.

using bf16 = __nv_bfloat16;
constexpr int kHQ = 128;          // query rows a block (two warpgroups)
constexpr int kHThreads = 256;
constexpr int kHStages = 3;       // K / V stages: the products read K_j
                                  // and V_{j-1} while tile j+1 lands

// keys a tile: 128 at head_dim 128 without a mask (wgmma n128 reads a third
// less shared memory per operation than n64, and the per-tile rescale and
// waits halve), else 64 (the staged mask tiles need the room)
template <int D, int kMask>
__host__ __device__ constexpr int fwd_tile_keys() {
  return D == 128 && kMask == 0 ? 128 : 64;
}

template <int D, int BK>
struct FwdSmem {
  static constexpr int mask_ld = BK + 8;               // fp32 row stride
  static constexpr size_t bars = 0;                    // Q, K/V stages
  static constexpr size_t counts = 64;                 // K/V stage releases
  static constexpr size_t q = 1024;                    // [D/64][kHQ][64]
  static constexpr size_t tile = (size_t)BK * D * 2;   // one K or V tile
  // [3 stages][K, V][D/64][BK][64]
  static constexpr size_t kv = q + (size_t)kHQ * D * 2;
  // [2 stages][2 warpgroups][rows][mask_ld]
  static constexpr size_t mask = kv + 2 * kHStages * tile;
  // shared bytes for a mask staged `rows` rows a tile and warpgroup (0: no
  // mask), +1024 for the alignment of the base
  static constexpr size_t bytes(int rows) {
    return mask + (size_t)4 * rows * mask_ld * 4 + 1024;
  }
  // the epilogue's bf16 rows [kHQ][D + 8] reuse the K/V stages
  static_assert((size_t)kHQ * (D + 8) * 2 <= 2 * kHStages * tile, "O staging");
};

// kMask: 0 none, 1 a mask over keys only ((b|1, h|1, 1, k): one row staged
// a tile), 2 a mask with query rows; kDrop: attention dropout. Each case is
// its own kernel, so the per-element code carries no branch.
template <int D, int kMask, bool kDrop>
__global__ void __launch_bounds__(kHThreads, 1) flash_fwd_sm90_kernel(
    __grid_constant__ const CUtensorMap tm_q,
    __grid_constant__ const CUtensorMap tm_k,
    __grid_constant__ const CUtensorMap tm_v, const float* __restrict__ mask,
    int mask_vec, bf16* __restrict__ out, float* __restrict__ lse, int sq,
    int sk, int h, long long msb, long long msh, long long msq,
    ptt::Causal causal, int keep_neg_inf, float scale, ptt::Dropout drop) {
  constexpr int BK = fwd_tile_keys<D, kMask>();
  using L = FwdSmem<D, BK>;
  using namespace ptt::sm90;
  using KeepBits = std::conditional_t<(BK > 64), uint64_t, uint32_t>;
  constexpr int NB = D / 64;  // 64-column boxes of a row
  constexpr int kHMaskLd = L::mask_ld;
  const int q0 = blockIdx.x * kHQ, hh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x;
  const long long rs = (long long)h * D;
  bf16* ob = out + (long long)bb * sq * rs + (long long)hh * D;
  const long long lrow = ((long long)bb * h + hh) * sq;
  // causal: the tile's rows see no key column at or past k_end
  const int n_tiles = (causal.k_end(q0 + kHQ, sk) + BK - 1) / BK;

  if (n_tiles == 0) {
    // wholly in the future (a ring step): no load, out = 0 and the lse of
    // a row that sees no key
    for (int i = tid; i < kHQ * (D / 8); i += kHThreads) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      if (q0 + r < sq)
        *reinterpret_cast<uint4*>(ob + (q0 + r) * rs + c) =
            make_uint4(0, 0, 0, 0);
    }
    if (lse != nullptr && tid < kHQ && q0 + tid < sq)
      lse[lrow + q0 + tid] = keep_neg_inf ? -INFINITY : 0.f;
    return;
  }

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::bars);
  bf16* q_s = reinterpret_cast<bf16*>(smem + L::q);
  auto k_stage = [&](int s) {
    return reinterpret_cast<bf16*>(smem + L::kv + (size_t)s * 2 * L::tile);
  };
  auto v_stage = [&](int s) {
    return reinterpret_cast<bf16*>(smem + L::kv +
                                   (size_t)(s * 2 + 1) * L::tile);
  };
  const float* mb = kMask ? mask + (long long)bb * msb + (long long)hh * msh
                          : nullptr;
  int* released = reinterpret_cast<int*>(smem + L::counts);
  const int wg = tid >> 7, wtid = tid & 127;  // warpgroup, thread in it
  // the rows a warpgroup stages a tile
  constexpr int mrows = kMask == 2 ? 64 : 1;
  auto mask_stage = [&](int s) {
    return reinterpret_cast<float*>(smem + L::mask) +
           (s * 2 + wg) * mrows * kHMaskLd;
  };

  if (tid == 0) {
    for (int i = 0; i <= kHStages; ++i) mbar_init(&bar[i], 1);
    for (int i = 0; i < kHStages; ++i) released[i] = 0;
    fence_barrier_init();
  }
  __syncthreads();

  auto load_kv = [&](int j) {  // one thread
    const int s = j % kHStages;
    mbar_expect_tx(&bar[1 + s], 2 * L::tile);
#pragma unroll
    for (int x = 0; x < NB; ++x) {
      tma_load_3d(k_stage(s) + x * BK * 64, &tm_k, &bar[1 + s], hh * D + x * 64,
                  j * BK, bb);
      tma_load_3d(v_stage(s) + x * BK * 64, &tm_v, &bar[1 + s], hh * D + x * 64,
                  j * BK, bb);
    }
  };
  auto load_mask = [&](int j) {  // the warpgroup's rows, one commit group
    float* dst = mask_stage(j & 1);
    const int k0 = j * BK, r0 = q0 + wg * 64;
    if (mask_vec) {
      for (int i = wtid; i < mrows * (BK / 4); i += 128) {
        const int r = i / (BK / 4), c = (i % (BK / 4)) * 4;
        const int n = r0 + r < sq ? min(max(sk - k0 - c, 0), 4) : 0;
        cp_async_16(dst + r * kHMaskLd + c,
                    n ? mb + (long long)(r0 + r) * msq + k0 + c : mb, n * 4);
      }
    } else {
      for (int i = wtid; i < mrows * BK; i += 128) {
        const int r = i / BK, c = i % BK;
        const bool ok = r0 + r < sq && k0 + c < sk;
        cp_async_4(dst + r * kHMaskLd + c,
                   ok ? mb + (long long)(r0 + r) * msq + k0 + c : mb, ok);
      }
    }
    cp_async_commit();
  };

  if (tid == 0) {
    mbar_expect_tx(&bar[0], (unsigned)(kHQ * D * 2));
#pragma unroll
    for (int x = 0; x < NB; ++x)
      tma_load_3d(q_s + x * kHQ * 64, &tm_q, &bar[0], hh * D + x * 64, q0, bb);
    for (int t = 0; t < kHStages && t < n_tiles; ++t) load_kv(t);
  }
  if (kMask) load_mask(0);

  // this thread's rows (local to the block) and columns within 8
  const int lane = tid & 31;
  const int r_lo = wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
  const int row0 = q0 + r_lo, row1 = row0 + 8;
  const int cq = 2 * (lane & 3);
  const int wg_row = q0 + wg * 64;  // the warpgroup's first row
  unsigned rkey0 = 0, rkey1 = 0;
  if (kDrop) {
    const unsigned hk = ptt::dropout_head_key((unsigned)*drop.seed, bb, hh);
    rkey0 = ptt::dropout_row_key(hk, row0);
    rkey1 = ptt::dropout_row_key(hk, row1);
  }
  constexpr float kLog2e = 1.4426950408889634f;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  uint32_t pa[BK / 16][4];  // P of the previous tile, the A operand
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int t = 0; t < 4; ++t) pa[kk][t] = 0u;

  // O += P V_t (V of tile t), issued and committed, not waited for
  auto issue_pv = [&](int t) {
    const bf16* vs = v_stage(t % kHStages);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dv = desc_sw128(vs + kk * 16 * 64, BK * 128, 1024);
      if constexpr (D == 64)
        wgmma_rs_n64(o, pa[kk], dv);
      else
        wgmma_rs_n128(o, pa[kk], dv);
    }
    wgmma_commit();
  };

  mbar_wait(&bar[0], 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kHStages, k0 = j * BK;
    mbar_wait(&bar[1 + s], (j / kHStages) & 1);
    if (kMask) {
      // the warpgroup's mask copies of tile j are in, and its threads are
      // done with the mask stage of tile j - 1: load tile j + 1's there
      cp_async_wait_all();
      named_barrier(1 + wg, 128);
      if (j + 1 < n_tiles) load_mask(j + 1);
    }

    // S = Q K^T over D in k-steps of 16 (32 bytes inside a 128-byte box),
    // then P_{j-1} V_{j-1} behind it
    float sacc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sacc[i] = 0.f;
    fence_regs(sacc);
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int x = kk / 4, off = (kk % 4) * 2;  // box, 16-byte units
      const uint64_t dq =
          desc_sw128(q_s + x * kHQ * 64 + wg * 64 * 64, 16, 1024) + off;
      const uint64_t dk = desc_sw128(k_stage(s) + x * BK * 64, 16, 1024) + off;
      if constexpr (BK == 64)
        wgmma_ss_n64(sacc, dq, dk, kk > 0);
      else
        wgmma_ss_n128(sacc, dq, dk, kk > 0);
    }
    wgmma_commit();
    if (j > 0) issue_pv(j - 1);
    // while the products run: this tile's dropout keep bits (bit 4 jj + i
    // for register 4 jj + i)
    KeepBits keep = 0;
    if constexpr (kDrop) {
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          keep |= ptt::dropout_keep(i < 2 ? rkey0 : rkey1,
                                    k0 + 8 * jj + cq + (i & 1),
                                    drop.threshold)
                      ? KeepBits(1) << (4 * jj + i)
                      : KeepBits(0);
    }
    if (j > 0)
      wgmma_wait_one();  // S_j is done; P_{j-1} V_{j-1} may still run
    else
      wgmma_wait_all();
    fence_regs(sacc);

    // logits in place (scale, mask, -inf where causal or past sk), then
    // the online softmax in fp32; the -inf guards mirror the TPU kernel
    // (x - max is exact for close values, also for a row of -1e9s)
    float alpha0, alpha1;
    uint32_t pn[BK / 16][4];  // P_j, dropped and rescaled, bf16 A operands
    auto softmax = [&](auto edge_c) {
      constexpr bool kEdge = decltype(edge_c)::value;
      const float* ms0 = mask_stage(j & 1) +
                         (kMask == 2 ? (r_lo - wg * 64) * kHMaskLd : 0);
      const float* ms1 = ms0 + (kMask == 2 ? 8 * kHMaskLd : 0);
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj) {
        const int cl = 8 * jj + cq;
        float2 mk0 = make_float2(0.f, 0.f), mk1 = mk0;
        if constexpr (kMask != 0) {
          mk0 = *reinterpret_cast<const float2*>(ms0 + cl);
          mk1 = *reinterpret_cast<const float2*>(ms1 + cl);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x0 = sacc[4 * jj + e] * scale + (e ? mk0.y : mk0.x);
          float x1 = sacc[4 * jj + 2 + e] * scale + (e ? mk1.y : mk1.x);
          if constexpr (kEdge) {
            const int col = k0 + cl + e;
            const bool out = col >= sk;
            const bool dead0 =
                out | (causal.on & (col + causal.k_off > row0 + causal.q_off));
            const bool dead1 =
                out | (causal.on & (col + causal.k_off > row1 + causal.q_off));
            x0 = dead0 ? -INFINITY : x0;
            x1 = dead1 ? -INFINITY : x1;
          }
          sacc[4 * jj + e] = x0;
          sacc[4 * jj + 2 + e] = x1;
          mx0 = fmaxf(mx0, x0);
          mx1 = fmaxf(mx1, x1);
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float b0 = mn0 == -INFINITY ? 0.f : mn0;
      const float b1 = mn1 == -INFINITY ? 0.f : mn1;
      alpha0 = ex2((m0 - b0) * kLog2e);
      alpha1 = ex2((m1 - b1) * kLog2e);
      m0 = mn0;
      m1 = mn1;
      // l sums the undropped p; P V takes where(keep, p / (1 - r), 0)
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = ex2((sacc[4 * jj + i] - (i < 2 ? b0 : b1)) * kLog2e);
          if (i < 2)
            s0 += p[i];
          else
            s1 += p[i];
          if constexpr (kDrop)
            p[i] = (keep >> (4 * jj + i)) & 1 ? p[i] * drop.inv_keep : 0.f;
        }
        pn[jj / 2][(jj % 2) * 2] = pack_bf16(p[0], p[1]);
        pn[jj / 2][(jj % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
      }
      l0 = l0 * alpha0 + s0;
      l1 = l1 * alpha1 + s1;
    };
    // tiles that no causal boundary or sk crosses take the copy without
    // the -inf selects
    if (k0 + BK > sk ||
        (causal.on && k0 + BK - 1 + causal.k_off > wg_row + causal.q_off))
      softmax(std::true_type{});
    else
      softmax(std::false_type{});

    // P_{j-1} V_{j-1} is done: O takes this tile's rescale, P_j waits
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(pa);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= ((i / 2) % 2) ? alpha1 : alpha0;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int t = 0; t < 4; ++t) pa[kk][t] = pn[kk][t];
    // both products of tile j - 1 are done in this warpgroup: the second
    // warpgroup to release its stage refills it with tile j + 2
    if (wtid == 0 && j >= 1 && j + 2 < n_tiles &&
        release_stage(&released[(j - 1) % kHStages]))
      load_kv(j + 2);
  }
  // the last tile's P V
  fence_regs(o);
  fence_regs(pa);
  wgmma_fence();
  issue_pv(n_tiles - 1);
  wgmma_wait_all();
  fence_regs(o);
  fence_regs(pa);

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float lf0 = fmaxf(l0, 1e-30f), lf1 = fmaxf(l1, 1e-30f);
  if (lse != nullptr && (lane & 3) == 0) {
    float v0 = m0 + logf(lf0), v1 = m1 + logf(lf1);
    if (v0 == -INFINITY && !keep_neg_inf) v0 = 0.f;
    if (v1 == -INFINITY && !keep_neg_inf) v1 = 0.f;
    if (row0 < sq) lse[lrow + row0] = v0;
    if (row1 < sq) lse[lrow + row1] = v1;
  }
  // stage O / l as bf16 rows over the K/V stages (every warpgroup is past
  // its last product and no load is in flight), then 16-byte stores
  __syncthreads();
  bf16* st = reinterpret_cast<bf16*>(smem + L::kv);
  constexpr int OL = D + 8;
  const float i0 = 1.f / lf0, i1 = 1.f / lf1;
#pragma unroll
  for (int jj = 0; jj < D / 8; ++jj) {
    const int c = 8 * jj + cq;
    *reinterpret_cast<uint32_t*>(st + r_lo * OL + c) =
        pack_bf16(o[4 * jj] * i0, o[4 * jj + 1] * i0);
    *reinterpret_cast<uint32_t*>(st + (r_lo + 8) * OL + c) =
        pack_bf16(o[4 * jj + 2] * i1, o[4 * jj + 3] * i1);
  }
  __syncthreads();
  for (int i = tid; i < kHQ * (D / 8); i += kHThreads) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    if (q0 + r < sq)
      *reinterpret_cast<uint4*>(ob + (q0 + r) * rs + c) =
          *reinterpret_cast<const uint4*>(st + r * OL + c);
  }
}

template <int D, int kMask, bool kDrop>
int launch_sm90_kernel(const void* q, const void* k, const void* v,
                       const float* mask, int vec, void* out, float* lse,
                       int b, int sq, int h, long long msb, long long msh,
                       long long msq, ptt::Causal causal, int keep_neg_inf,
                       float scale, ptt::Dropout drop, int sk,
                       cudaStream_t stream) {
  constexpr int BK = fwd_tile_keys<D, kMask>();
  CUtensorMap tq, tk, tv;
  int err = ptt::sm90::make_tensor_map_bf16(&tq, q, b, sq, h * D, kHQ);
  if (!err) err = ptt::sm90::make_tensor_map_bf16(&tk, k, b, sk, h * D, BK);
  if (!err) err = ptt::sm90::make_tensor_map_bf16(&tv, v, b, sk, h * D, BK);
  if (err) return err;
  auto kern = flash_fwd_sm90_kernel<D, kMask, kDrop>;
  const size_t smem = FwdSmem<D, BK>::bytes(kMask == 2 ? 64 : kMask);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((sq + kHQ - 1) / kHQ, h, b);
  kern<<<grid, kHThreads, smem, stream>>>(
      tq, tk, tv, mask, vec, static_cast<bf16*>(out), lse, sq, sk, h, msb,
      msh, msq, causal, keep_neg_inf, scale, drop);
  return (int)cudaGetLastError();
}

template <int D>
int launch_sm90(const void* q, const void* k, const void* v,
                const float* mask, void* out, float* lse, int b, int sq,
                int sk, int h, long long msb, long long msh, long long msq,
                ptt::Causal causal, int keep_neg_inf, float scale,
                ptt::Dropout drop, cudaStream_t stream) {
  // 16-byte mask copies need 16-byte aligned rows
  const int vec = mask != nullptr &&
                  reinterpret_cast<uintptr_t>(mask) % 16 == 0 &&
                  msb % 4 == 0 && msh % 4 == 0 && msq % 4 == 0;
  const int kind = mask == nullptr ? 0 : msq ? 2 : 1;
#define PTT_FWD_CASE(M, P)                                                  \
  if (kind == M && (drop.seed != nullptr) == P)                             \
    return launch_sm90_kernel<D, M, P>(q, k, v, mask, vec, out, lse, b,     \
                                       sq, h, msb, msh, msq, causal,        \
                                       keep_neg_inf, scale, drop, sk, stream);
  PTT_FWD_CASE(0, false)
  PTT_FWD_CASE(0, true)
  PTT_FWD_CASE(1, false)
  PTT_FWD_CASE(1, true)
  PTT_FWD_CASE(2, false)
  PTT_FWD_CASE(2, true)
#undef PTT_FWD_CASE
  return (int)cudaErrorInvalidValue;
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
    return launch_sm90<128>(q, k, v, m, out, l, b, sq, sk, h, msb, msh, msq,
                            causal, keep_neg_inf, scale, drop, st);
  if (dtype == ptt::kBF16 && d == 64)
    return launch_sm90<64>(q, k, v, m, out, l, b, sq, sk, h, msb, msh, msq,
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

// Dynamic shared memory of K1's Hopper kernel (bf16, head_dim 64 / 128), with
// or without a staged mask; 0 for other head_dims.
extern "C" int ptt_flash_fwd_sm90_smem(int d, int with_mask) {
  if (d == 64) return (int)FwdSmem<64, 64>::bytes(with_mask ? 64 : 0);
  if (d == 128)
    return with_mask ? (int)FwdSmem<128, 64>::bytes(64)
                     : (int)FwdSmem<128, 128>::bytes(0);
  return 0;
}
