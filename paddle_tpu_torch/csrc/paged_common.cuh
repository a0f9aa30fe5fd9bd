// Shared device code of the paged attention kernels (paged_decode.cu:
// K6 / K6q; ragged_paged.cu: K7 / K7q).
//
// The decode walk (`decode_split`): one query token, its `rep` query heads
// of one kv head, over one split of kSplit keys of its page-table row. It is
// the whole of the paged decode kernel and the path of K7's single-token
// query tiles. It is built for bytes:
//   - the table first: each of the split's keys has its pool slot read from
//     the page table by its own thread, once, before any K/V address is
//     formed, so no K/V load waits on a table read;
//   - every byte of the split in flight at once: the split's K rows then
//     its V rows go to shared memory through cp.async, 16 bytes a thread,
//     in groups of 32 keys (kSplit / 32 of K, as many of V), all issued
//     before the first is waited for. An int8 / fp8 row is half a bf16 row, so a
//     quantized split moves half the bytes with the same instructions;
//   - no shuffle chain per token: the scores of a staged chunk are computed
//     from shared memory, four lanes a key (a quarter of head_dim each, two
//     shuffles to finish the dot), the rep heads together, q in shared
//     memory as fp32; rows are padded by 16 bytes, so the 8 keys a quarter
//     warp reads sit on distinct banks;
//   - scales folded: over int8 / fp8 pools a logit is (q . k_q) * k_scale
//     and p is multiplied by v_scale before p . v_q (the reference's
//     `kblk * ks`, `vblk * vs`, up to fp32 rounding);
//   - one launch: a block writes its unnormalized partial (max, sum,
//     output); the last of a (token, kv head)'s splits to arrive, found by
//     an arrival counter in global memory, merges them in split order (so
//     two launches give the same bits) and resets the counter. A token
//     whose keys fit one split writes its output directly.
// Logits are kept in log2 units (q is pre-multiplied by scale * log2(e)).
//
// The wgmma forms below serve K7's multi-token query tiles
// (ragged_paged.cu).
//
// Phase stamps: built with -DPTT_STAMPS, thread 0 of every block records
// its start and end on the global timer, its SM and clock64() readings at
// the phases a kernel marks with PTT_STAMP; tools/paged_stamps.py reads
// them back through ptt_stamps_read. Without the flag the macros are empty
// and nothing is recorded.
#pragma once

#include <cuda_fp16.h>

#include "common.cuh"

namespace ptt {
namespace paged {

constexpr int kStampBlocks = 8192;  // blocks recorded (by linear id)
constexpr int kStampSlots = 16;     // 0 start ns, 1 end ns, 2 SM, 3.. phases

#ifdef PTT_STAMPS
__device__ long long g_stamps[kStampBlocks][kStampSlots];

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)::"memory");
  return t;
}

__device__ __forceinline__ int linear_block() {
  return (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
}

// clock64() once `dep` has arrived (the mov waits on its register)
__device__ __forceinline__ long long clock_after(unsigned dep) {
  unsigned d;
  asm volatile("mov.b32 %0, %1;" : "=r"(d) : "r"(dep));
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t + (d & 0);
}

#define PTT_STAMP_BEGIN()                                                  \
  if (threadIdx.x == 0 &&                                                  \
      ::ptt::paged::linear_block() < ::ptt::paged::kStampBlocks) {         \
    unsigned sm;                                                           \
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));                        \
    auto* s_ = ::ptt::paged::g_stamps[::ptt::paged::linear_block()];       \
    s_[0] = ::ptt::paged::global_ns();                                     \
    s_[2] = sm;                                                            \
    s_[3] = clock64();                                                     \
  }
// slot `i` (4..15) := clock64() after `dep`
#define PTT_STAMP(i, dep)                                                  \
  if (threadIdx.x == 0 &&                                                  \
      ::ptt::paged::linear_block() < ::ptt::paged::kStampBlocks)           \
    ::ptt::paged::g_stamps[::ptt::paged::linear_block()][i] =             \
        ::ptt::paged::clock_after((unsigned)(dep));
#define PTT_STAMP_END()                                                    \
  if (threadIdx.x == 0 &&                                                  \
      ::ptt::paged::linear_block() < ::ptt::paged::kStampBlocks)           \
    ::ptt::paged::g_stamps[::ptt::paged::linear_block()][1] =             \
        ::ptt::paged::global_ns();
#else
#define PTT_STAMP_BEGIN()
#define PTT_STAMP(i, dep)
#define PTT_STAMP_END()
#endif


constexpr int kThreads = 128;        // every paged block: four warps
constexpr int kSplit = 128;          // keys a decode split walks
constexpr int kChunk = 32;           // keys a cp.async group carries
constexpr int kChunks = kSplit / kChunk;
static_assert(kChunks >= 1 && kChunks <= 4, "groups in flight: 2 * kChunks");
constexpr float kLog2e = 1.4426950408889634f;

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wait until at most n (0..7, known once the caller's loop is unrolled)
// committed groups are pending
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// ------------------------------------------------------- element loads
// Elements of TKV in one 16-byte piece.
template <typename T>
constexpr int kPieceElems = 16 / (int)sizeof(T);

// fp32 of the 8 bf16 in a 16-byte piece (exact)
__device__ __forceinline__ void piece_f32(const uint4& r, float (&f)[8]) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// fp32 of the 4 int8 codes of a word (exact): 2^23 + (code + 128) as the
// float's mantissa, minus 2^23 + 128
__device__ __forceinline__ void word_i8_f32(unsigned w, float* f) {
  const unsigned x = w ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __int_as_float(__byte_perm(x, 0x4B000000u, 0x7540u + j)) -
           8388736.f;
}

// fp32 of the 4 fp8 e4m3 values of a word (exact, through f16x2)
__device__ __forceinline__ void word_e4m3_f32(unsigned w, float* f) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
        (__nv_fp8x2_storage_t)(w >> (16 * j)), __NV_E4M3);
    const float2 v = __half22float2(*reinterpret_cast<const __half2*>(&h));
    f[2 * j] = v.x;
    f[2 * j + 1] = v.y;
  }
}

// fp32 of the kPieceElems<T> elements of a 16-byte piece of T
template <typename T>
__device__ __forceinline__ void piece_to_f32(const uint4& r,
                                             float (&f)[kPieceElems<T>]) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    piece_f32(r, f);
  } else {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (std::is_same<T, int8_t>::value)
        word_i8_f32(w[i], f + 4 * i);
      else
        word_e4m3_f32(w[i], f + 4 * i);
    }
  }
}

// fp32 of the 8 elements of T at p (16 bytes of bf16, 8 of int8 / fp8)
template <typename T>
__device__ __forceinline__ void load8_f32(const unsigned char* p,
                                          float (&f)[8]) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    piece_f32(*reinterpret_cast<const uint4*>(p), f);
  } else {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    if constexpr (std::is_same<T, int8_t>::value) {
      word_i8_f32(r.x, f);
      word_i8_f32(r.y, f + 4);
    } else {
      word_e4m3_f32(r.x, f);
      word_e4m3_f32(r.y, f + 4);
    }
  }
}

// ------------------------------------------------------- the decode walk
// Shared memory of decode_split: K and V rows of the split (padded by 16
// bytes), then q (fp32), the scores / probabilities, the per-key scales,
// the per-key pool slots and the (max, sum) of each head. The warps' output
// fold reuses the K rows where they are large enough.
template <typename TKV, int HD, int REP>
struct WalkSmem {
  static constexpr int kRow = HD * (int)sizeof(TKV) + 16;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kSplit * kRow;
  static constexpr int kQ = kV + kSplit * kRow;
  static constexpr int kS = kQ + REP * HD * 4;
  static constexpr int kKsc = kS + REP * kSplit * 4;
  static constexpr int kVsc = kKsc + kSplit * 4;
  static constexpr int kSlot = kVsc + kSplit * 4;
  static constexpr int kMl = kSlot + kSplit * 4;
  static constexpr int kFlag = kMl + REP * 2 * 4;
  // the warps' output fold: over the K rows where they are large enough
  static constexpr int kRedBytes = 4 * REP * HD * 4;
  static constexpr bool kRedInK = kSplit * kRow >= kRedBytes;
  static constexpr int kRed = kRedInK ? kK : kFlag + 16;
  static constexpr int kBytes = kFlag + 16 + (kRedInK ? 0 : kRedBytes);
};

// One work item of the walk.
struct WalkItem {
  const __nv_bfloat16* q;  // the token's REP query heads of this kv head
  __nv_bfloat16* out;      // their outputs
  const int* pt;           // the token's page-table row
  int n_tok;               // keys 0 .. n_tok - 1 attend (n_tok >= 1)
  int split;               // keys split * kSplit ..
  float* part_ml;          // (max, sum) of query head r, split s at
  float* part_acc;         //   [(r * n_splits + s) * 2], output at
  int n_splits;            //   [(r * n_splits + s) * HD]
  int* counter;            // arrival counter of (token, kv head)
};

// Walk one split. `head_base` = kv head * num_pages; `scale` = 1 / sqrt(HD).
// Every thread of the block calls it; it ends with the block in step.
template <typename TKV, int HD, int REP>
__device__ __forceinline__ void decode_split(
    unsigned char* smem, const WalkItem& it, const TKV* __restrict__ k_pool,
    const TKV* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, long long head_base, int ps,
    float scale) {
  using L = WalkSmem<TKV, HD, REP>;
  constexpr bool kQuant = kQuantized<TKV>;
  constexpr int kPieces = HD * (int)sizeof(TKV) / 16;  // 16 B pieces a row
  constexpr int kEl = kPieceElems<TKV>;
  unsigned char* ks = smem + L::kK;
  unsigned char* vs = smem + L::kV;
  float* q_s = reinterpret_cast<float*>(smem + L::kQ);
  float* sc = reinterpret_cast<float*>(smem + L::kS);
  float* ksc = reinterpret_cast<float*>(smem + L::kKsc);
  float* vsc = reinterpret_cast<float*>(smem + L::kVsc);
  int* slot_s = reinterpret_cast<int*>(smem + L::kSlot);
  float* ml_s = reinterpret_cast<float*>(smem + L::kMl);
  int* flag = reinterpret_cast<int*>(smem + L::kFlag);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = it.split * kSplit;
  const int kn = min(it.n_tok - k0, kSplit);

  // the table first: one thread a key
  if (tid < kn) {
    const int key = k0 + tid;
    slot_s[tid] = (int)((head_base + it.pt[key / ps]) * ps + key % ps);
  }
  // q in the same round trip (loaded after the split's cp.async requests,
  // it queued behind them: 5% slower, PERF.md)
  for (int e = tid; e < REP * HD; e += kThreads)
    q_s[e] = __bfloat162float(it.q[e]) * (scale * kLog2e);
  __syncthreads();
  PTT_STAMP(4, slot_s[0]);

  // every byte of the split in flight: K chunks, then V chunks (the scales
  // ride with the first K chunk); rows past kn are zero-filled
#pragma unroll
  for (int kv = 0; kv < 2; ++kv) {
    const TKV* pool = kv ? v_pool : k_pool;
    unsigned char* dst = kv ? vs : ks;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      for (int i = tid; i < kChunk * kPieces; i += kThreads) {
        const int key = c * kChunk + i / kPieces, piece = i % kPieces;
        const bool ok = key < kn;
        const TKV* src =
            ok ? pool + (long long)slot_s[key] * HD + piece * kEl : pool;
        sm90::cp_async_16(dst + key * L::kRow + piece * 16, src, ok ? 16 : 0);
      }
      if constexpr (kQuant) {
        if (kv == 0 && c == 0 && tid < kSplit) {
          const bool ok = tid < kn;
          const int sl = ok ? slot_s[tid] : 0;
          sm90::cp_async_4(ksc + tid, k_scale + sl, ok);
          sm90::cp_async_4(vsc + tid, v_scale + sl, ok);
        }
      }
      sm90::cp_async_commit();
    }
  }

  // scores: warp w takes keys 8w .. 8w+7 of each chunk, four lanes a key,
  // lane group g = lane / 8 the pieces g, g + 4, ...
  const int key_in = warp * 8 + (lane & 7), grp = lane >> 3;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    cp_async_wait_n(2 * kChunks - 1 - c);
    __syncthreads();
    if (c == 0) PTT_STAMP(5, 0);
    if (c * kChunk >= kn) continue;  // the same for every thread
    const int key = c * kChunk + key_in;
    float dot[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) dot[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kPieces / 4; ++i) {
      const int pi = 4 * i + grp;
      float kf[kEl];
      piece_to_f32<TKV>(
          *reinterpret_cast<const uint4*>(ks + key * L::kRow + pi * 16), kf);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float4* qv =
            reinterpret_cast<const float4*>(q_s + r * HD + pi * kEl);
#pragma unroll
        for (int j = 0; j < kEl / 4; ++j) {
          const float4 q4 = qv[j];
          dot[r] = fmaf(q4.x, kf[4 * j], dot[r]);
          dot[r] = fmaf(q4.y, kf[4 * j + 1], dot[r]);
          dot[r] = fmaf(q4.z, kf[4 * j + 2], dot[r]);
          dot[r] = fmaf(q4.w, kf[4 * j + 3], dot[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], 8);
      dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], 16);
    }
    if (grp == 0) {
      const float ksv = kQuant ? ksc[key] : 1.f;
#pragma unroll
      for (int r = 0; r < REP; ++r)
        sc[r * kSplit + key] = key < kn ? dot[r] * ksv : -INFINITY;
    }
  }
  __syncthreads();
  PTT_STAMP(6, 0);

  // softmax of each head over the split: warp w takes heads w, w + 4
  for (int r = warp; r < REP; r += 4) {
    float v[kSplit / 32];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kSplit / 32; ++j) {
      const int key = j * 32 + lane;
      v[j] = key < kn ? sc[r * kSplit + key] : -INFINITY;
      mx = fmaxf(mx, v[j]);
    }
    mx = warp_max(mx);  // finite: key 0 of the split is live
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kSplit / 32; ++j) {
      const int key = j * 32 + lane;
      const float p = v[j] == -INFINITY ? 0.f : sm90::ex2(v[j] - mx);
      sum += p;
      if (key < kn) sc[r * kSplit + key] = kQuant ? p * vsc[key] : p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      ml_s[2 * r] = mx;
      ml_s[2 * r + 1] = sum;
    }
  }
  PTT_STAMP(7, 0);

  // P V: thread owns 8 columns (cg) of every kKG-th key (kg)
  constexpr int kCG = HD / 8, kKG = kThreads / kCG;
  const int cg = tid % kCG, kg = tid / kCG;
  float acc[REP][8];
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    cp_async_wait_n(kChunks - 1 - c);
    __syncthreads();
    if (c * kChunk >= kn) continue;
#pragma unroll
    for (int i = 0; i < kChunk / kKG; ++i) {
      const int key = c * kChunk + i * kKG + kg;
      if (key >= kn) break;
      float vf[8];
      load8_f32<TKV>(vs + key * L::kRow + cg * 8 * (int)sizeof(TKV), vf);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float p = sc[r * kSplit + key];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(p, vf[j], acc[r][j]);
      }
    }
  }
  PTT_STAMP(8, __float_as_uint(acc[0][0]));

  // fold the key groups: lanes of a warp by shuffles, the warps in shared
  // memory (over the K rows, no longer read)
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int o = kCG; o < 32; o <<= 1)
        acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], o);
  float* red = reinterpret_cast<float*>(smem + L::kRed);
  if (lane < kCG) {
#pragma unroll
    for (int r = 0; r < REP; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        red[(warp * REP + r) * HD + cg * 8 + j] = acc[r][j];
  }
  __syncthreads();
  const bool whole = kn == it.n_tok;  // the token's keys fit one split
  for (int e = tid; e < REP * HD; e += kThreads) {
    const int r = e / HD, col = e % HD;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) a += red[(w * REP + r) * HD + col];
    if (whole) {
      it.out[e] = __float2bfloat16(a / fmaxf(ml_s[2 * r + 1], 1e-30f));
    } else {
      const int row = r * it.n_splits + it.split;
      it.part_acc[(long long)row * HD + col] = a;
      if (col == 0) {
        it.part_ml[2 * row] = ml_s[2 * r];
        it.part_ml[2 * row + 1] = ml_s[2 * r + 1];
      }
    }
  }
  PTT_STAMP(9, 0);
  if (whole) {
    PTT_STAMP(10, 0);
    __syncthreads();
    return;
  }

  // the last split to arrive merges, in split order: the block's writes,
  // a barrier, then one thread's fence and arrival (release); the last
  // arrival's fence (acquire) and a barrier before its reads, which go to
  // L2 (ld.cg)
  __syncthreads();
  const int n_used = (it.n_tok + kSplit - 1) / kSplit;
  if (tid == 0) {
    __threadfence();
    const bool last = atomicAdd(it.counter, 1) == n_used - 1;
    if (last) __threadfence();
    *flag = last;
  }
  __syncthreads();
  if (*flag) {
    for (int e = tid; e < REP * HD; e += kThreads) {
      const int r = e / HD, col = e % HD;
      const float* ml = it.part_ml + 2 * r * it.n_splits;
      float mx = -INFINITY;
      for (int s = 0; s < n_used; ++s) mx = fmaxf(mx, __ldcg(ml + 2 * s));
      float sum = 0.f, a = 0.f;
      for (int s = 0; s < n_used; ++s) {
        const float f = sm90::ex2(__ldcg(ml + 2 * s) - mx);
        sum += __ldcg(ml + 2 * s + 1) * f;
        a += __ldcg(it.part_acc +
                    ((long long)r * it.n_splits + s) * HD + col) * f;
      }
      it.out[e] = __float2bfloat16(a / fmaxf(sum, 1e-30f));
    }
    if (tid == 0) *it.counter = 0;
  }
  PTT_STAMP(10, 0);
  __syncthreads();
}

// zeros for the REP heads of a token that attends nothing
template <int HD, int REP>
__device__ __forceinline__ void zero_heads(__nv_bfloat16* out) {
  for (int e = threadIdx.x; e < REP * HD; e += kThreads)
    out[e] = __float2bfloat16(0.f);
}

// ------------------------------------------------ tensor-core building blocks
// wgmma (sm_90a) forms that ragged_paged.cu's tiles need beside the flash
// kernels' ones in common.cuh: S of 64 rows x 32 keys, and P V with fp16
// operands (int8 / fp8 pools)

// D (64 x 32, fp32 registers) (+)= A (64 x 16, shared) B (16 x 32, shared),
// both K-major, bf16
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, fp32 registers) += A (64 x 16, fp16 registers) B (16 x 64,
// shared, MN-major, fp16)
__device__ __forceinline__ void wgmma_rs_n64_f16(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, fp32 registers) += A (64 x 16, fp16 registers) B (16 x 128,
// shared, MN-major, fp16)
__device__ __forceinline__ void wgmma_rs_n128_f16(float (&d)[64],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// two fp32 as one f16x2 register, the lower column in the low half
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace paged
}  // namespace ptt

#ifdef PTT_STAMPS
// Copy the stamp table (kStampBlocks x kStampSlots int64) to host memory
// `dst`, then zero it. Returns a cudaError_t.
extern "C" int ptt_stamps_read(void* dst) {
  cudaError_t err = cudaMemcpyFromSymbol(dst, ptt::paged::g_stamps,
                                         sizeof(ptt::paged::g_stamps));
  if (err != cudaSuccess) return (int)err;
  static long long zeros[ptt::paged::kStampBlocks][ptt::paged::kStampSlots];
  return (int)cudaMemcpyToSymbol(ptt::paged::g_stamps, zeros,
                                 sizeof(zeros));
}
#endif
