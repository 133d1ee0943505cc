// Shared pieces of the batched GEMV kernels (fused_local_solve.cu,
// block_matvec.cu): one warp per output row, the domain's input vector
// staged in shared memory, lanes striding along the row so that each
// load instruction of a warp reads 32 neighbouring elements.
//
// Both kernels read every matrix element exactly once and do two flops
// per element (8 bytes in float64), so they are bound by device memory
// bandwidth, far below the arithmetic limit.  The design keeps the
// matrix stream coalesced and reads the input vector from shared memory
// instead of device memory; the sums run in a fixed order (per-lane
// strided partial sums, then a shuffle tree), so results are
// bit-reproducible from run to run.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace g4p {

constexpr int kWarps = 8;                               // warps per block
constexpr int kRowsPerWarp = 4;                         // rows per warp
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;    // rows per block
constexpr int kThreads = kWarps * 32;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;  // complete in lane 0
}

// sum_j row[j] * s[j] over one warp; the result is valid in lane 0.
template <typename T>
__device__ __forceinline__ T row_dot(const T* __restrict__ row,
                                     const T* __restrict__ s, int n,
                                     int lane) {
  T acc = T(0);
#pragma unroll 4
  for (int j = lane; j < n; j += 32) acc += row[j] * s[j];
  return warp_sum(acc);
}

// Rows [first, first + kRowsPerWarp) of this warp inside one domain.
__device__ __forceinline__ int warp_first_row() {
  return blockIdx.y * kRowsPerBlock + (threadIdx.x >> 5) * kRowsPerWarp;
}

// Opt a kernel in to more than 48 KB of dynamic shared memory when the
// staged vector needs it (n > 6144 in float64).
inline cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Grid: x = domain (up to 2^31 - 1), y = block of kRowsPerBlock rows.
inline dim3 gemv_grid(int64_t n_dom, int64_t n) {
  return dim3((unsigned)n_dom,
              (unsigned)((n + kRowsPerBlock - 1) / kRowsPerBlock));
}

}  // namespace g4p
