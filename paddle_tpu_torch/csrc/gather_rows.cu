// Row gather for Hopper (sm_90a), plain CUDA C++: out[m] = src[idx[m]],
// a zero row where idx[m] < 0.
//
// Replaces the TPU kernel `_gather_rows_fwd_impl` (paddle_tpu/ops/
// pallas_kernels.py:1173, pallas_call at :1196, body `_gather_rows_kernel`
// :1140), the MoE layer's dispatch and combine primitive: the dispatch
// fills the expert queues, expert_in[e, c] = x[slot_token[e, c]], and the
// combine reads per_k[t, k] = expert_out[tok_slot[t, k]].
//
// What is kept from the TPU kernel: the function, for any element type
// (rows are copied as bytes). What is gone: the TPU's layout rules, the
// padding of rows to 1024 elements and of the row count to 256-row blocks,
// and the clamp-then-zero outside the kernel; here an empty slot is
// written as zeros without reading `src` at all. An index >= n (a caller
// error the routing cannot produce) is also written as zeros, so the
// kernel never reads outside `src`.
//
// What bounds it on an H100: bytes. It does no arithmetic; at the MoE
// dispatch shape (39328 rows of 768 fp32, ~17% empty) it must write
// 120.8 MB and read at most 100.7 MB, ~0.066 ms at 3.35 TB/s.
//
// Design (the simple right one): each warp takes one output row at a time
// (grid-stride over the rows), reads its index once (one broadcast load)
// and moves the row in the widest unit that the row's byte count and both
// base pointers allow: 16-byte vectors (uint4) on the main path's rows
// (3072 B fp32, 1536 B bf16), down to single bytes for odd rows, the
// lanes of the warp on consecutive units, so each warp instruction moves
// 512 contiguous bytes.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxBlocks = 132 * 16;

template <typename V>
__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel(const char* __restrict__ src,
                       const int* __restrict__ idx, char* __restrict__ out,
                       long long n, long long m, long long row_bytes) {
  const int lane = threadIdx.x & 31;
  const long long units = row_bytes / static_cast<long long>(sizeof(V));
  const long long warps = (static_cast<long long>(gridDim.x) * kThreads) / 32;
  for (long long r = (static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x) / 32;
       r < m; r += warps) {
    const int s = idx[r];
    V* dst = reinterpret_cast<V*>(out + r * row_bytes);
    if (s >= 0 && s < n) {
      const V* row = reinterpret_cast<const V*>(src + s * row_bytes);
#pragma unroll 4
      for (long long i = lane; i < units; i += 32) dst[i] = row[i];
    } else {
      const V zero = {};
#pragma unroll 4
      for (long long i = lane; i < units; i += 32) dst[i] = zero;
    }
  }
}

template <typename V>
int launch(const void* src, const void* idx, void* out, long long n,
           long long m, long long row_bytes, cudaStream_t stream) {
  const long long blocks = (m + kWarps - 1) / kWarps;
  const int grid = static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
  gather_rows_kernel<V><<<grid, kThreads, 0, stream>>>(
      static_cast<const char*>(src), static_cast<const int*>(idx),
      static_cast<char*>(out), n, m, row_bytes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src: contiguous (n, row_bytes) bytes; idx: (m,) int32 on the card; out:
// contiguous (m, row_bytes) bytes. The copy unit is the largest of 16, 8,
// 4, 2 and 1 bytes dividing row_bytes and both base pointers. m > 0 and
// row_bytes > 0. Returns cudaGetLastError() after the launch.
extern "C" int ptt_gather_rows(const void* src, const void* idx, void* out,
                               long long n, long long m, long long row_bytes,
                               void* stream) {
  if (m <= 0 || row_bytes <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(src) |
                         reinterpret_cast<uintptr_t>(out) |
                         static_cast<uintptr_t>(row_bytes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((bits & 15) == 0)
    return launch<uint4>(src, idx, out, n, m, row_bytes, st);
  if ((bits & 7) == 0)
    return launch<uint2>(src, idx, out, n, m, row_bytes, st);
  if ((bits & 3) == 0)
    return launch<unsigned>(src, idx, out, n, m, row_bytes, st);
  if ((bits & 1) == 0)
    return launch<unsigned short>(src, idx, out, n, m, row_bytes, st);
  return launch<unsigned char>(src, idx, out, n, m, row_bytes, st);
}
