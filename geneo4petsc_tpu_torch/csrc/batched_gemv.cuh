// The batched GEMV stream shared by K1 (fused_local_solve.cu) and K2
// (block_matvec.cu):  y[d, i] = store(sum_j M[d, i, j] * load_x(d, j)).
//
// Both TPU kernels (geneo4petsc_tpu/ops/pallas_kernels.py,
// fused_local_solve and block_matvec) hand a whole [n, n] block and its
// vector to the TPU's matrix unit, one grid step per group of domains.
// On a Hopper card the same function is bound by device memory: every
// matrix element is read once for two flops (8 bytes in float64), far
// below the arithmetic limit.  So the only thing to design is the read
// stream of the matrix batch, and the card must never be left without
// requests in flight.
//
// A [n_dom, n, n] row-major batch is one contiguous stream, and a tile
// of consecutive rows of one domain is one contiguous run of bytes.  Two
// kernels read it:
//
// * ring (the main path): persistent blocks, about one per SM, each
//   walking a contiguous range of (domain, row tile) items.  One
//   producer thread keeps `stages` tiles in flight with 1-D bulk copies
//   (cp.async.bulk, completed on an mbarrier, marked evict-first in
//   L2 since every byte is read once) into a ring in shared memory;
//   consumer warps reduce the rows of an arrived tile from shared
//   memory with 16-byte reads, four rows at a time so that one read of
//   x feeds four rows, and hand the stage back through an "empty"
//   barrier.  The copies cost no registers and are never drained
//   at a row, tile or domain boundary; x[d] and whatever the store of
//   a row needs (K1: mask and post-weight) are staged once per domain
//   and block, so that no consumer waits on device memory between two
//   tiles.  A bulk copy needs 16-byte aligned addresses and sizes,
//   so this path takes batches whose base pointer and row size are
//   multiples of 16 bytes.
//
// * direct (the general path): one warp per four rows, lanes striding
//   along the rows with 16-byte read-only loads from device memory, the
//   four rows' loads interleaved; each row is peeled to its own first
//   16-byte boundary, so any n and any element-aligned base pointer are
//   taken.  x[d] is staged per block in shared memory.
//
// Which path and which geometry a launch takes is decided by the plan
// computed in ops/local_kernels.py (_stream_plan) from the shapes, the
// pointer's alignment and the card's limits; launch_gemv checks the plan
// against the arguments and refuses what the kernels cannot take.
//
// The sums run in a fixed order on both paths (per-lane partial sums in
// stride order, then a butterfly of shuffles), with no atomics and no
// dependence on which SM took an item: results are bit-reproducible
// from run to run.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace g4p {

constexpr int kRowsPerWarp = 4;     // rows a warp reduces at once
constexpr int kMaxThreads = 288;    // one producer warp + 8 consumer warps
constexpr int kMaxStages = 8;
constexpr int kBarrierBytes = 128;  // full[] and empty[] barriers of the ring
constexpr int kPathDirect = 0;
constexpr int kPathRing = 1;

// Launch geometry, computed by ops/local_kernels.py (_stream_plan).
struct Plan {
  int path;      // kPathDirect or kPathRing
  int rows;      // rows per tile (ring) or per block (direct)
  int stages;    // ring depth (ring only)
  int grid;      // blocks
  int threads;   // threads per block
  int64_t smem;  // dynamic shared memory, bytes
};

// ---- 16-byte words ---------------------------------------------------

template <typename T> struct Word;
template <> struct Word<double> {
  using type = double2;
  static constexpr int kLanes = 2;
};
template <> struct Word<float> {
  using type = float4;
  static constexpr int kLanes = 4;
};

__device__ __forceinline__ double dot_word(double2 a, double2 b, double acc) {
  acc = fma(a.x, b.x, acc);
  return fma(a.y, b.y, acc);
}
__device__ __forceinline__ float dot_word(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
// The same with the vector's word read as scalars (x not 16-byte aligned).
__device__ __forceinline__ double dot_word(double2 a, const double* b,
                                           double acc) {
  acc = fma(a.x, b[0], acc);
  return fma(a.y, b[1], acc);
}
__device__ __forceinline__ float dot_word(float4 a, const float* b,
                                          float acc) {
  acc = fmaf(a.x, b[0], acc);
  acc = fmaf(a.y, b[1], acc);
  acc = fmaf(a.z, b[2], acc);
  return fmaf(a.w, b[3], acc);
}

// Butterfly sum over a warp: every lane ends with the same bits.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Reduce the four partial sums over the warp and let lane q store row q
// with store(q, sum).
template <typename T, typename Store>
__device__ __forceinline__ void store_rows(T (&acc)[kRowsPerWarp], int rows,
                                           int lane, const Store& store) {
  T y = T(0);
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) {
    const T s = warp_sum(acc[q]);
    if (lane == q) y = s;
  }
  if (lane < rows) store(lane, y);
}

// ---- barriers and bulk copies (PTX) ----------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n\t"
        ".reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t"
        "}"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// L2 policy of the matrix stream: every byte is read once, so its lines
// are the first to go and leave the vectors in the cache.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

// Copy `bytes` contiguous bytes from device to shared memory; completion
// is counted on `bar`.  Addresses and size are multiples of 16.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)),
         "l"(policy)
      : "memory");
}

// Barrier among the consumer warps only (barrier 0 is __syncthreads).
__device__ __forceinline__ void consumer_sync(int threads) {
  asm volatile("bar.sync 1, %0;" :: "r"(threads) : "memory");
}

// ---- ring kernel -----------------------------------------------------

__host__ __device__ inline int64_t align_up(int64_t v, int64_t a) {
  return (v + a - 1) / a * a;
}

// Dynamic shared memory of the ring kernel: barriers, x[d], the store's
// operands of the domain (`extra` bytes), the stages.
inline int64_t ring_smem_bytes(int64_t n, int64_t itemsize, int64_t extra,
                               int rows, int stages) {
  return kBarrierBytes + align_up(n * itemsize, 128) + align_up(extra, 128) +
         (int64_t)stages * rows * n * itemsize;
}

// The rows of one tile in shared memory (rows r0 .. of domain d), four
// at a time, strided over the consumer warps; rows past the tile's end
// are clamped and not stored.
template <typename T, typename Op>
__device__ __forceinline__ void reduce_tile(const T* tile, const T* xs,
                                            const unsigned char* extra,
                                            int rows, int n, int64_t d, int r0,
                                            const Op& op, int cwarp,
                                            int n_cwarps, int lane) {
  using W = typename Word<T>::type;
  const int nw = n / Word<T>::kLanes;
  const W* xw = reinterpret_cast<const W*>(xs);
  for (int r = cwarp * kRowsPerWarp; r < rows; r += n_cwarps * kRowsPerWarp) {
    const W* rw[kRowsPerWarp];
    T acc[kRowsPerWarp];
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
      rw[q] = reinterpret_cast<const W*>(tile + (size_t)min(r + q, rows - 1) * n);
      acc[q] = T(0);
    }
#pragma unroll 2
    for (int k = lane; k < nw; k += 32) {
      const W xv = xw[k];
#pragma unroll
      for (int q = 0; q < kRowsPerWarp; ++q)
        acc[q] = dot_word(rw[q][k], xv, acc[q]);
    }
    store_rows(acc, min(kRowsPerWarp, rows - r), lane, [&](int q, T y) {
      op.store_staged(d * n, r0 + r + q, y, extra, n);
    });
  }
}

// Block b walks items [items * b / grid, items * (b + 1) / grid), an item
// being tile t of domain d with item = d * tiles + t: a block stays in
// one domain as long as it can.  Warp 0 is the producer, the others
// consume.  ops/local_kernels.py (stream_tiles) mirrors this indexing.
template <typename T, typename Op>
__global__ void __launch_bounds__(kMaxThreads)
gemv_ring_kernel(const T* __restrict__ mat, const Op op, int64_t n_dom,
                 int n, int rows, int stages) {
  extern __shared__ __align__(128) unsigned char ring_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(ring_smem);
  uint64_t* empty = full + kMaxStages;
  T* xs = reinterpret_cast<T*>(ring_smem + kBarrierBytes);
  const size_t row_bytes = (size_t)n * sizeof(T);
  unsigned char* extra = ring_smem + kBarrierBytes + align_up(row_bytes, 128);
  unsigned char* ring = extra + align_up(Op::extra_bytes(n), 128);
  const size_t stage_bytes = (size_t)rows * row_bytes;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_cwarps = (blockDim.x >> 5) - 1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, n_cwarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int64_t tiles = (n + rows - 1) / rows;
  const int64_t items = n_dom * tiles;
  const int64_t begin = items * blockIdx.x / gridDim.x;
  const int64_t end = items * (blockIdx.x + 1) / gridDim.x;

  if (warp == 0) {
    if (lane != 0) return;
    int s = 0;
    uint32_t phase = 0;
    const uint64_t policy = evict_first_policy();
    for (int64_t item = begin; item < end; ++item) {
      const int64_t d = item / tiles;
      const int r0 = (int)(item - d * tiles) * rows;
      const uint32_t bytes = (uint32_t)(min(rows, n - r0) * row_bytes);
      mbar_wait(empty + s, phase ^ 1);  // passes at once in the first round
      mbar_expect_tx(full + s, bytes);
      bulk_copy(ring + s * stage_bytes, mat + (d * n + r0) * (int64_t)n, bytes,
                full + s, policy);
      if (++s == stages) { s = 0; phase ^= 1; }
    }
    return;
  }

  const int cwarp = warp - 1;
  const int cthreads = n_cwarps * 32, ctid = threadIdx.x - 32;
  int s = 0;
  uint32_t phase = 0;
  int64_t staged = -1;  // the domain whose vector is in xs
  for (int64_t item = begin; item < end; ++item) {
    const int64_t d = item / tiles;
    const int r0 = (int)(item - d * tiles) * rows;
    if (d != staged) {
      consumer_sync(cthreads);  // every warp is done with the old vector
      for (int j = ctid; j < n; j += cthreads) {
        xs[j] = op.load_x(d * n + j);
        op.stage(extra, n, d * n, j);
      }
      consumer_sync(cthreads);
      staged = d;
    }
    mbar_wait(full + s, phase);
    reduce_tile(reinterpret_cast<const T*>(ring + s * stage_bytes), xs, extra,
                min(rows, n - r0), n, d, r0, op, cwarp, n_cwarps, lane);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
    if (++s == stages) { s = 0; phase ^= 1; }
  }
}

// ---- direct kernel ---------------------------------------------------

// Up to four consecutive rows starting at `row0`, their loads
// interleaved.  Each row is split at its own 16-byte boundaries into a
// head of single elements, a body of 16-byte words and a tail.
template <typename T, typename Op>
__device__ __forceinline__ void direct_rows(const T* __restrict__ row0,
                                            const T* xs, int rows, int n,
                                            int64_t first, const Op& op,
                                            int lane) {
  using W = typename Word<T>::type;
  constexpr int L = Word<T>::kLanes;
  const T* rp[kRowsPerWarp];
  int head[kRowsPerWarp], nw[kRowsPerWarp];
  T acc[kRowsPerWarp];
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) {
    rp[q] = row0 + (size_t)min(q, rows - 1) * n;
    const int to_boundary =
        (int)(((16 - (reinterpret_cast<uintptr_t>(rp[q]) & 15)) & 15) /
              sizeof(T));
    head[q] = min(to_boundary, n);
    nw[q] = (n - head[q]) / L;
    acc[q] = lane < head[q] ? rp[q][lane] * xs[lane] : T(0);
  }
  const int nw_most = n / L;
#pragma unroll 2
  for (int k = lane; k < nw_most; k += 32) {
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
      if (k < nw[q]) {
        const W a = __ldg(reinterpret_cast<const W*>(rp[q] + head[q]) + k);
        acc[q] = dot_word(a, xs + head[q] + L * k, acc[q]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) {
    const int j = head[q] + L * nw[q] + lane;  // the tail: fewer than L
    if (j < n) acc[q] += rp[q][j] * xs[j];
  }
  store_rows(acc, rows, lane, [&](int q, T y) { op.store(first + q, y); });
}

// One block per item (tile t of domain d, item = d * tiles + t), `rows`
// rows a block, four per warp.
template <typename T, typename Op>
__global__ void __launch_bounds__(kMaxThreads)
gemv_direct_kernel(const T* __restrict__ mat, const Op op, int n, int rows) {
  extern __shared__ __align__(128) unsigned char direct_smem[];
  T* xs = reinterpret_cast<T*>(direct_smem);
  const int tiles = (n + rows - 1) / rows;
  const int64_t d = blockIdx.x / tiles;
  const int r0 = (int)(blockIdx.x - d * tiles) * rows;
  for (int j = threadIdx.x; j < n; j += blockDim.x) xs[j] = op.load_x(d * n + j);
  __syncthreads();

  const int r = r0 + (threadIdx.x >> 5) * kRowsPerWarp;
  if (r >= n) return;
  direct_rows(mat + (d * n + r) * (int64_t)n, xs, min(kRowsPerWarp, n - r), n,
              d * n + r, op, threadIdx.x & 31);
}

// ---- launch ----------------------------------------------------------

// Opt a kernel in to more than 48 KB of dynamic shared memory.
inline cudaError_t allow_smem(const void* kernel, int64_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Launch the planned kernel; a plan that does not fit the arguments is
// refused with cudaErrorInvalidValue, a launch the card refuses returns
// the card's error.
template <typename T, typename Op>
cudaError_t launch_gemv(const T* mat, const Op& op, int64_t n_dom, int64_t n,
                        const Plan& p, cudaStream_t stream) {
  if (n_dom <= 0 || n <= 0) return cudaSuccess;
  if (n > INT32_MAX || p.rows < 1 || p.grid < 1 || p.threads % 32 != 0 ||
      p.threads < 64 || p.threads > kMaxThreads)
    return cudaErrorInvalidValue;
  const int64_t items = n_dom * ((n + p.rows - 1) / p.rows);
  cudaError_t err;
  if (p.path == kPathRing) {
    if (p.stages < 2 || p.stages > kMaxStages || p.grid > items ||
        reinterpret_cast<uintptr_t>(mat) % 16 != 0 ||
        (n * sizeof(T)) % 16 != 0 ||
        p.smem != ring_smem_bytes(n, sizeof(T), Op::extra_bytes(n), p.rows,
                                  p.stages))
      return cudaErrorInvalidValue;
    auto kernel = gemv_ring_kernel<T, Op>;
    err = allow_smem((const void*)kernel, p.smem);
    if (err != cudaSuccess) return err;
    kernel<<<p.grid, p.threads, p.smem, stream>>>(mat, op, n_dom, (int)n,
                                                  p.rows, p.stages);
  } else if (p.path == kPathDirect) {
    if (p.rows != p.threads / 32 * kRowsPerWarp || p.grid != items ||
        p.smem != n * (int64_t)sizeof(T))
      return cudaErrorInvalidValue;
    auto kernel = gemv_direct_kernel<T, Op>;
    err = allow_smem((const void*)kernel, p.smem);
    if (err != cudaSuccess) return err;
    kernel<<<p.grid, p.threads, p.smem, stream>>>(mat, op, (int)n, p.rows);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace g4p
