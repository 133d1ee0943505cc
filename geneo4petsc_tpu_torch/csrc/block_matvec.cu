// K2: the batched per-subdomain product out[d, i] = sum_j A[d, i, j] x[d, j],
// the local product of the MatIS SpMV (SubdomainBatch.matvec), launched
// twice per CG iteration.
//
// Replaces the Pallas kernel geneo4petsc_tpu/ops/pallas_kernels.py
// block_matvec (kernel body _block_matvec_kernel), which gives each
// group of domains' [n, n] blocks to the TPU's matrix unit.
//
// On a Hopper card the product is bound by device memory: each element
// of A is read once for two flops, so the least time is the bytes of A,
// x and out over the card's memory rate.  The kernel is the shared
// stream of batched_gemv.cuh with the plainest load and store: a
// persistent ring of bulk-copied row tiles for 16-byte aligned batches,
// direct 16-byte loads for every other.  Any n and any number of
// domains; no padding of the batch.
#include "batched_gemv.cuh"

namespace {

using namespace g4p;

template <typename T>
struct MatvecOp {
  const T* __restrict__ x;
  T* __restrict__ out;
  __device__ __forceinline__ T load_x(int64_t i) const { return x[i]; }
  __device__ __forceinline__ void store(int64_t i, T y) const { out[i] = y; }
  // Nothing but the sum goes into a stored row, so nothing is staged.
  __host__ __device__ static int64_t extra_bytes(int64_t) { return 0; }
  __device__ __forceinline__ void stage(unsigned char*, int, int64_t,
                                        int) const {}
  __device__ __forceinline__ void store_staged(int64_t base, int j, T y,
                                               const unsigned char*,
                                               int) const {
    out[base + j] = y;
  }
};

template <typename T>
cudaError_t launch(const void* a, const void* x, void* out, int64_t n_dom,
                   int64_t n, const Plan& plan, cudaStream_t stream) {
  const MatvecOp<T> op{static_cast<const T*>(x), static_cast<T*>(out)};
  return launch_gemv(static_cast<const T*>(a), op, n_dom, n, plan, stream);
}

}  // namespace

// a [n_dom, n, n], x/out [n_dom, n]: contiguous row-major device
// tensors.  path .. smem are the plan of ops/local_kernels.py
// (_stream_plan).  Returns the CUDA error code of the launch (0 on
// success).
extern "C" int g4p_block_matvec(const void* a, const void* x, void* out,
                                int64_t n_dom, int64_t n, int is_f64,
                                int path, int rows, int stages, int grid,
                                int threads, int64_t smem, void* stream) {
  const Plan plan{path, rows, stages, grid, threads, smem};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_f64 ? launch<double>(a, x, out, n_dom, n, plan, st)
                           : launch<float>(a, x, out, n_dom, n, plan, st);
  return (int)err;
}
