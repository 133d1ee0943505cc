// K1: the fused level-1 local solve with precomputed block inverses,
//   out[d, i] = mask[d, i] * D[d, i]^post * sum_j Minv[d, i, j] * D[d, j]^pre * x[d, j]
// for every subdomain d (applyLevel1 of the reference, ASM/RAS/SRAS),
// launched once per preconditioner apply.
//
// Replaces the Pallas kernel geneo4petsc_tpu/ops/pallas_kernels.py
// fused_local_solve (kernel body _make_fused_kernel), which weights,
// multiplies on the TPU's matrix unit and masks in one pass.
//
// On a Hopper card the solve is bound by device memory: each element of
// Minv is read once for two flops, so the least time is the bytes of
// Minv, x, out, the mask and (when weighted) D over the card's memory
// rate.  The kernel is the shared stream of batched_gemv.cuh; the fusion
// lives in its load and store: the pre-weight is applied once per domain
// while x[d] is staged in shared memory, the post-weight and the padding
// mask in the store of each row (on the ring path from copies staged
// with x[d], so that no row's store waits on device memory), so neither
// costs a pass over device memory.  Any n and any number of domains; no
// padding of the batch.
#include "batched_gemv.cuh"

namespace {

using namespace g4p;

template <typename T, bool PRE, bool POST>
struct LocalSolveOp {
  const T* __restrict__ d;
  const uint8_t* __restrict__ mask;
  const T* __restrict__ x;
  T* __restrict__ out;
  __device__ __forceinline__ T load_x(int64_t i) const {
    return PRE ? x[i] * d[i] : x[i];
  }
  // Row i with its mask and weight read from device memory.
  __device__ __forceinline__ void store(int64_t i, T y) const {
    if (POST) y *= d[i];
    out[i] = mask[i] ? y : T(0);
  }
  // The ring stages a domain's mask (n bytes) and, when POST, its
  // weights (from the next 16-byte boundary on) beside x[d].
  __host__ __device__ static int64_t extra_bytes(int64_t n) {
    return POST ? align_up(n, 16) + n * (int64_t)sizeof(T) : n;
  }
  __device__ __forceinline__ void stage(unsigned char* extra, int n,
                                        int64_t base, int j) const {
    extra[j] = mask[base + j];
    if (POST) reinterpret_cast<T*>(extra + align_up(n, 16))[j] = d[base + j];
  }
  // Row j of the domain at `base` with its mask and weight as staged.
  __device__ __forceinline__ void store_staged(int64_t base, int j, T y,
                                               const unsigned char* extra,
                                               int n) const {
    if (POST) y *= reinterpret_cast<const T*>(extra + align_up(n, 16))[j];
    out[base + j] = extra[j] ? y : T(0);
  }
};

template <typename T, bool PRE, bool POST>
cudaError_t launch(const void* inv, const void* d, const void* mask,
                   const void* x, void* out, int64_t n_dom, int64_t n,
                   const Plan& plan, cudaStream_t stream) {
  const LocalSolveOp<T, PRE, POST> op{
      static_cast<const T*>(d), static_cast<const uint8_t*>(mask),
      static_cast<const T*>(x), static_cast<T*>(out)};
  return launch_gemv(static_cast<const T*>(inv), op, n_dom, n, plan, stream);
}

template <typename T>
cudaError_t dispatch(const void* inv, const void* d, const void* mask,
                     const void* x, void* out, int64_t n_dom, int64_t n,
                     int pre, int post, const Plan& plan,
                     cudaStream_t stream) {
  if (pre && post)
    return launch<T, true, true>(inv, d, mask, x, out, n_dom, n, plan, stream);
  if (pre)
    return launch<T, true, false>(inv, d, mask, x, out, n_dom, n, plan, stream);
  if (post)
    return launch<T, false, true>(inv, d, mask, x, out, n_dom, n, plan, stream);
  return launch<T, false, false>(inv, d, mask, x, out, n_dom, n, plan, stream);
}

}  // namespace

// All pointers are device pointers of contiguous row-major tensors:
// inv [n_dom, n, n], d/x/out [n_dom, n] (d may be null when neither pre
// nor post is set), mask [n_dom, n] bytes (0/1).  path .. smem are the
// plan of ops/local_kernels.py (_stream_plan).  Returns the CUDA error
// code of the launch (0 on success).
extern "C" int g4p_fused_local_solve(const void* inv, const void* d,
                                     const void* mask, const void* x,
                                     void* out, int64_t n_dom, int64_t n,
                                     int pre, int post, int is_f64, int path,
                                     int rows, int stages, int grid,
                                     int threads, int64_t smem,
                                     void* stream) {
  const Plan plan{path, rows, stages, grid, threads, smem};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_f64 ? dispatch<double>(inv, d, mask, x, out, n_dom, n, pre, post,
                                plan, st)
             : dispatch<float>(inv, d, mask, x, out, n_dom, n, pre, post,
                               plan, st);
  return (int)err;
}
