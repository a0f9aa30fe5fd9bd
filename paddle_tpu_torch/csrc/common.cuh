// Shared helpers of the port's CUDA kernels: element conversion between
// the storage types the kernels take (fp32, bf16, and the quantized KV
// pools' int8 and fp8 e4m3) and fp32 compute, and the error-string entry
// point every kernel library exports.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace ptt {

// dtype codes passed across the C interface (the wrappers' _DTYPES maps)
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2, kFP8 = 3 };

// the quantized KV pool types, whose elements carry a per-slot scale
template <typename T>
constexpr bool kQuantized = std::is_same<T, int8_t>::value ||
                            std::is_same<T, __nv_fp8_e4m3>::value;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Copy kTileRows rows of D bf16 values (row stride `rs` elements in device
// memory, starting at row0) into shared memory with row stride DP, as
// 16-byte vectors; rows at or past `rows` are zero. D % 8 == 0 and the
// source rows 16-byte aligned.
template <int D, int DP, int kTileRows, int kThreads>
__device__ __forceinline__ void load_tile_bf16(
    __nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src, int row0,
    int rows, long long rs) {
  constexpr int V = D / 8;
  for (int i = threadIdx.x; i < kTileRows * V; i += kThreads) {
    const int r = i / V, c = (i % V) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < rows)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * rs + c);
    *reinterpret_cast<uint4*>(dst + r * DP + c) = val;
  }
}

// Attention-dropout keep mask, a counter-based hash of (seed, batch, head,
// query row, key column); the same function as
// paddle_tpu_torch/ops/dropout_mask.py, which documents it. It does not
// depend on tiling, so the forward, both backward kernels and the plain
// versions draw the identical mask.
constexpr unsigned kGolden = 0x9E3779B9u;

__device__ __forceinline__ unsigned fmix32(unsigned x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

// per (batch, head): computed once per block
__device__ __forceinline__ unsigned dropout_head_key(unsigned seed, int b,
                                                     int h) {
  return fmix32(fmix32(fmix32(seed ^ kGolden) ^ (unsigned)b) ^ (unsigned)h);
}

// per query row: computed once per row
__device__ __forceinline__ unsigned dropout_row_key(unsigned head_key,
                                                   int row) {
  return fmix32(head_key ^ (unsigned)row);
}

// per element: keep iff the bits reach the threshold floor(p * 2^32)
__device__ __forceinline__ bool dropout_keep(unsigned row_key, int col,
                                             unsigned threshold) {
  return fmix32(row_key + (unsigned)col * kGolden) >= threshold;
}

// Dropout parameters as the kernels take them: `seed` points at a device
// int32 (read inside the kernel, so drawing a seed never syncs the host);
// threshold = floor(p * 2^32); inv_keep = 1 / (1 - p). p = 0 is seed ==
// nullptr.
struct Dropout {
  const int* seed;
  unsigned threshold;
  float inv_keep;
};

// Causal masking at global sequence positions, as the TPU kernels take it
// from `offs` (pallas_kernels.py:263-280): query row `row` (local index)
// sees key column `col` iff row + q_off >= col + k_off. Offsets (0, 0) are
// one call's top-left causal mask; a ring step passes the global positions
// of its query shard and of the key shard it holds (ops/ring_flash.py).
// The offsets are host ints: the rank is known on the host, so nothing is
// read from the device for them.
struct Causal {
  int on;
  int q_off;
  int k_off;
  __device__ __forceinline__ bool masked(int row, int col) const {
    return on && col + k_off > row + q_off;
  }
  // exclusive end of the key columns that query rows below row_end see
  __device__ __forceinline__ int k_end(int row_end, int sk) const {
    return on ? min(max(row_end + q_off - k_off, 0), sk) : sk;
  }
  // the first query row that sees key column col
  __device__ __forceinline__ int q_begin(int col) const {
    return on ? max(col + k_off - q_off, 0) : 0;
  }
};

}  // namespace ptt

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
