// K1: the fused level-1 local solve with precomputed block inverses,
//   out[d, i] = mask[d, i] * D[d, i]^post * sum_j Minv[d, i, j] * D[d, j]^pre * x[d, j]
// for every subdomain d (applyLevel1 of the reference, ASM/RAS/SRAS).
//
// Replaces the Pallas kernel geneo4petsc_tpu/ops/pallas_kernels.py
// fused_local_solve (kernel body _make_fused_kernel).
//
// Bound by memory bandwidth: each element of Minv is read once for two
// flops.  The design streams Minv row by row with coalesced warp loads,
// applies the pre-weight once per domain while staging x[d] in shared
// memory (so the weight costs no device traffic per row), and fuses the
// post-weight and the padding mask into the store.  Any n and any number
// of domains; no padding of the batch.
#include "batched_gemv.cuh"

namespace {

using namespace g4p;

template <typename T, bool PRE, bool POST>
__global__ void __launch_bounds__(kThreads)
fused_local_solve_kernel(const T* __restrict__ inv, const T* __restrict__ d,
                         const uint8_t* __restrict__ mask,
                         const T* __restrict__ x, T* __restrict__ out,
                         int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int64_t base = (int64_t)blockIdx.x * n;  // this domain's vectors
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    T v = x[base + j];
    if (PRE) v *= d[base + j];
    s[j] = v;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int first = warp_first_row();
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = first + r;
    if (i >= n) break;
    T y = row_dot(inv + (base + i) * (int64_t)n, s, n, lane);
    if (lane == 0) {
      if (POST) y *= d[base + i];
      out[base + i] = mask[base + i] ? y : T(0);
    }
  }
}

template <typename T, bool PRE, bool POST>
cudaError_t launch(const void* inv, const void* d, const void* mask,
                   const void* x, void* out, int64_t n_dom, int64_t n,
                   cudaStream_t stream) {
  auto kernel = fused_local_solve_kernel<T, PRE, POST>;
  const size_t smem = (size_t)n * sizeof(T);
  cudaError_t err = allow_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<gemv_grid(n_dom, n), kThreads, smem, stream>>>(
      static_cast<const T*>(inv), static_cast<const T*>(d),
      static_cast<const uint8_t*>(mask), static_cast<const T*>(x),
      static_cast<T*>(out), (int)n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* inv, const void* d, const void* mask,
                     const void* x, void* out, int64_t n_dom, int64_t n,
                     int pre, int post, cudaStream_t stream) {
  if (pre && post)
    return launch<T, true, true>(inv, d, mask, x, out, n_dom, n, stream);
  if (pre)
    return launch<T, true, false>(inv, d, mask, x, out, n_dom, n, stream);
  if (post)
    return launch<T, false, true>(inv, d, mask, x, out, n_dom, n, stream);
  return launch<T, false, false>(inv, d, mask, x, out, n_dom, n, stream);
}

}  // namespace

// All pointers are device pointers of contiguous row-major tensors:
// inv [n_dom, n, n], d/x/out [n_dom, n] (d may be null when neither pre
// nor post is set), mask [n_dom, n] bytes (0/1).  Returns the CUDA error
// code of the launch (0 on success).
extern "C" int g4p_fused_local_solve(const void* inv, const void* d,
                                     const void* mask, const void* x,
                                     void* out, int64_t n_dom, int64_t n,
                                     int pre, int post, int is_f64,
                                     void* stream) {
  if (n_dom <= 0 || n <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_f64 ? dispatch<double>(inv, d, mask, x, out, n_dom, n, pre, post, st)
             : dispatch<float>(inv, d, mask, x, out, n_dom, n, pre, post, st);
  return (int)err;
}
