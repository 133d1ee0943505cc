// K2: the batched per-subdomain product out[d, i] = sum_j A[d, i, j] x[d, j],
// the local product of the MatIS SpMV (SubdomainBatch.matvec).
//
// Replaces the Pallas kernel geneo4petsc_tpu/ops/pallas_kernels.py
// block_matvec (kernel body _block_matvec_kernel).
//
// Bound by memory bandwidth: each element of A is read once for two
// flops.  The design streams A row by row with coalesced warp loads and
// reads x[d] from shared memory, staged once per block.  Any n and any
// number of domains; no padding of the batch.
#include "batched_gemv.cuh"

namespace {

using namespace g4p;

template <typename T>
__global__ void __launch_bounds__(kThreads)
block_matvec_kernel(const T* __restrict__ a, const T* __restrict__ x,
                    T* __restrict__ out, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int64_t base = (int64_t)blockIdx.x * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) s[j] = x[base + j];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int first = warp_first_row();
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = first + r;
    if (i >= n) break;
    const T y = row_dot(a + (base + i) * (int64_t)n, s, n, lane);
    if (lane == 0) out[base + i] = y;
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* x, void* out, int64_t n_dom,
                   int64_t n, cudaStream_t stream) {
  auto kernel = block_matvec_kernel<T>;
  const size_t smem = (size_t)n * sizeof(T);
  cudaError_t err = allow_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<gemv_grid(n_dom, n), kThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(x),
      static_cast<T*>(out), (int)n);
  return cudaGetLastError();
}

}  // namespace

// a [n_dom, n, n], x/out [n_dom, n]: contiguous row-major device
// tensors.  Returns the CUDA error code of the launch (0 on success).
extern "C" int g4p_block_matvec(const void* a, const void* x, void* out,
                                int64_t n_dom, int64_t n, int is_f64,
                                void* stream) {
  if (n_dom <= 0 || n <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_f64 ? launch<double>(a, x, out, n_dom, n, st)
                           : launch<float>(a, x, out, n_dom, n, st);
  return (int)err;
}
