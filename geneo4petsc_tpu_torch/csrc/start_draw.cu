// The structured path's LOBPCG start block, drawn on the card:
//   out[dom, col, p] = mask[dom, p] * N(((dom * n) + p) * k + col)
// into a contiguous [d, k, n] block, where N(i) is element i of the JAX
// package's jax.random.normal(PRNGKey(0), (d, n, k)): the partitionable
// Threefry-2x32 hash (20 rounds, key (0, 0)) of the counter pair
// (i >> 32, i & 0xffffffff), mapped to a uniform on [nextafter(-1, 0), 1)
// and through sqrt(2) erf^-1.  ops/start_draw.py holds the plain version
// (the same arithmetic in torch ops) and the wrapper.
//
// It replaces no TPU kernel: XLA makes JAX's draw
// (geneo4petsc_tpu/structured/geneo.py run_lobpcg, jax.random.normal).
// The port drew its start block on the host and copied it to the card
// from pageable memory, which held a 10M-DOF set-up for most of a second.
//
// Bound: every element is independent, so the kernel is one pass that
// writes d * k * n values and reads the d * n mask once.  At the main
// path's shape ([64, 2, 195112] float32: 100 MB written, 50 MB read) that
// is ~0.045 ms of device memory; the hash's ~100 integer operations an
// element come to about as much again on the SMs' integer units, so the
// two overlap.  The design keeps everything but the mask and the output
// out of memory: one thread per (dom, p), neighbouring threads on
// neighbouring p, so the mask load and each of the k stores are
// coalesced; the hash, the uniform and erf^-1 stay in registers.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds, key (0, 0): (x0, x1) -> (b1, b2).
__device__ __forceinline__ void threefry_00(uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {0u, 0u, 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

// erf^-1 by XLA's float32 formula (Giles' single-precision polynomials),
// each step of the polynomial one fused multiply-add as in XLA's CPU code.
__device__ __forceinline__ float erfinv_xla(float x) {
  const float lt5[9] = {2.81022636e-08f, 3.43273939e-07f, -3.5233877e-06f,
                        -4.39150654e-06f, 0.00021858087f, -0.00125372503f,
                        -0.00417768164f, 0.246640727f, 1.50140941f};
  const float ge5[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f,
                        -0.00367342844f, 0.00573950773f, -0.0076224613f,
                        0.00943887047f, 1.00167406f, 2.83297682f};
  float w = -log1pf(__fmul_rn(-x, x));
  const bool lt = w < 5.0f;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(sqrtf(w), 3.0f);
  float p = lt ? lt5[0] : ge5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = __fmaf_rn(p, w, lt ? lt5[i] : ge5[i]);
  return __fmul_rn(p, x);
}

template <typename T>
struct Normal;

template <>
struct Normal<float> {
  __device__ __forceinline__ static float of(uint32_t b1, uint32_t b2) {
    const uint32_t bits = ((b1 ^ b2) >> 9) | 0x3F800000u;
    const float f = __fsub_rn(__uint_as_float(bits), 1.0f);
    const float lo = -0.99999994f;  // nextafter(-1, 0); (1 - lo) rounds to 2
    const float u = fmaxf(lo, __fadd_rn(__fmul_rn(f, 2.0f), lo));
    return __fmul_rn(1.4142135381698608f, erfinv_xla(u));  // sqrt(2)
  }
};

template <>
struct Normal<double> {
  __device__ __forceinline__ static double of(uint32_t b1, uint32_t b2) {
    const uint64_t mant =
        (((uint64_t)b1 << 20) | ((uint64_t)b2 >> 12)) & ((1ull << 52) - 1);
    const double f =
        __dsub_rn(__longlong_as_double((long long)(mant | 0x3FF0000000000000ull)),
                  1.0);
    const double lo = -0x1.fffffffffffffp-1;  // nextafter(-1, 0)
    const double u = fmax(lo, __dadd_rn(__dmul_rn(f, 1.0 - lo), lo));
    return __dmul_rn(1.4142135623730951, erfinv(u));
  }
};

template <typename T>
__global__ void start_draw_kernel(const T* __restrict__ mask,
                                  T* __restrict__ out, int64_t d, int k,
                                  int64_t n) {
  const int64_t p_step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t dom = blockIdx.y; dom < d; dom += gridDim.y) {
    for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < n;
         p += p_step) {
      const T m = mask[dom * n + p];
      const uint64_t base = (uint64_t)(dom * n + p) * (uint64_t)k;
      T* o = out + dom * k * n + p;
      for (int col = 0; col < k; ++col) {
        const uint64_t i = base + (uint64_t)col;
        uint32_t x0 = (uint32_t)(i >> 32), x1 = (uint32_t)i;
        threefry_00(x0, x1);
        o[(int64_t)col * n] = m * Normal<T>::of(x0, x1);
      }
    }
  }
}

}  // namespace

// mask [d, n], out [d, k, n]: contiguous device tensors of one dtype
// (float64 when is_f64).  The wrapper (ops/start_draw.py) picks the grid
// and the threads a block.  Returns the CUDA error code of the launch
// (0 on success).
extern "C" int g4p_start_draw(const void* mask, void* out, int64_t d,
                              int64_t k, int64_t n, int is_f64, int grid_x,
                              int grid_y, int threads, void* stream) {
  const dim3 grid(grid_x, grid_y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f64)
    start_draw_kernel<double><<<grid, threads, 0, st>>>(
        static_cast<const double*>(mask), static_cast<double*>(out), d,
        (int)k, n);
  else
    start_draw_kernel<float><<<grid, threads, 0, st>>>(
        static_cast<const float*>(mask), static_cast<float*>(out), d,
        (int)k, n);
  return (int)cudaGetLastError();
}
