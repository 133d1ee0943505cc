// One iteration of the structured path's batched PCG local solver
// (structured/solvers.py PCGSolver) on a 7-point LocalStencil, in three
// kernels around the preconditioner's solve:
//
//   pcg_matvec  beta from the r.z partials, p_new = z + beta p_old,
//               w = (A p_new) * mask, one p.w partial a block;
//   pcg_update  alpha from the p.w and r.z partials, u += alpha p,
//               r -= alpha w in place, one r.r partial a block;
//   pcg_dot     one r.z partial a block, after z = pre.solve(r).
//
// Vectors are contiguous [n_sys, lz, ly, lx] (n_sys = n_dom * m for a block
// [n_dom, m, lz, ly, lx]); the stencil's fields and the mask are
// [n_dom, lz, ly, lx], system s reading domain s / m.  Every partial is
// summed in a fixed order (a thread's points in turn, then a fixed tree
// over the block), and each scalar is reduced from its partials by every
// block that needs it in the same fixed order, so the same inputs give
// the same bits and no float atomics are used.  Each product and sum is
// rounded on its own, as the plain version's torch ops round them, and
// the stencil adds its terms in stencil_apply's order (diagonal, then per
// axis x, y, z the upper and the lower neighbour).  ops/pcg_fused.py holds
// the plain version and the wrappers.
//
// It replaces no TPU kernel: the JAX package's PCGSolver.solve is a
// lax.while_loop of jnp ops that XLA fuses.  The port ran ~14 torch passes
// over [n_sys, N] an iteration (~2.85 GB at [64, 58^3] float32).
//
// Bound: bytes.  An iteration must read z, p, the diagonal, the three
// coupling fields and the mask and write p and w (matvec), read u, r, p
// and w and write u and r (update), and read r and z (dot): 17 passes of
// [64, 58^3] float32, 0.85 GB, 0.25 ms at 3.35 TB/s, against ~26
// operations a point.  The design touches each array about once:
// pcg_matvec gives a block a tile of whole rows of the plane (8 rows of
// 58 at the 10M cells' boxes) and marches it up a z-chunk of 8 planes,
// keeping p_new of three planes in shared memory with a one-point halo,
// so a neighbour's p_new is computed once and read from shared memory;
// only the halo rows and the chunk's end planes are read twice, from L2.
// Each step issues all of its loads before its one wait.  pcg_update
// issues its loads before it sums the partials into alpha, so the sum
// hides behind them; pcg_update and pcg_dot are single coalesced passes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads a block of every kernel here
constexpr int kPer = 8;        // elements a thread of update and dot
constexpr int kPts = 2;        // tile points a thread of pcg_matvec, at most

template <typename T>
struct Ar;

template <>
struct Ar<float> {
  __device__ __forceinline__ static float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  __device__ __forceinline__ static float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  __device__ __forceinline__ static float sub(float a, float b) {
    return __fsub_rn(a, b);
  }
  __device__ __forceinline__ static float div(float a, float b) {
    return __fdiv_rn(a, b);
  }
};

template <>
struct Ar<double> {
  __device__ __forceinline__ static double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  __device__ __forceinline__ static double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  __device__ __forceinline__ static double sub(double a, double b) {
    return __dsub_rn(a, b);
  }
  __device__ __forceinline__ static double div(double a, double b) {
    return __ddiv_rn(a, b);
  }
};

// The block's sum of v, in a fixed order, returned to every thread.  Every
// thread of the block calls it; sh holds 33 values.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = Ar<T>::add(v, __shfl_down_sync(0xffffffffu, v, o));
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    T t = sh[0];
    for (int i = 1; i < (int)(blockDim.x >> 5); ++i)
      t = Ar<T>::add(t, sh[i]);
    sh[32] = t;
  }
  __syncthreads();
  const T out = sh[32];
  __syncthreads();
  return out;
}

// acc + c * p, the product rounded before the sum (as torch's addcmul_).
template <typename T>
__device__ __forceinline__ T add_prod(T acc, T c, T p) {
  return Ar<T>::add(acc, Ar<T>::mul(c, p));
}

// The sum of a system's n partials, the same bits in every block.
template <typename T>
__device__ __forceinline__ T sum_parts(const T* parts, int n, T* sh) {
  T v = T(0);
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    v = Ar<T>::add(v, parts[j]);
  return block_sum(v, sh);
}

// grid.x: the in-plane tiles of ty rows by sx columns (ty * sx <= kPts *
// blockDim.x) times the z-chunks of zc planes; grid.y: systems (looped
// beyond gridDim.y).  A block marches its tile up its z-chunk; p_new of
// the planes k-1, k and k+1 lives in shared memory with a one-point halo
// in x and y, 3 (ty + 2) (sx + 2) values.  Each step issues all of its
// loads at once (the coefficients of plane k into registers, z and p_old
// of plane k+1 into shared memory as p_new), waits once, then computes
// plane k.  first: p_new is p_old (start's p = pre.solve(b)), and neither
// z nor the r.z partials are read.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    pcg_matvec_kernel(const T* __restrict__ z, const T* __restrict__ p_old,
                      T* __restrict__ p_new, T* __restrict__ w,
                      const T* __restrict__ diag, const T* __restrict__ cx,
                      const T* __restrict__ cy, const T* __restrict__ cz,
                      const T* __restrict__ mask,
                      const T* __restrict__ rz_parts,
                      const T* __restrict__ rz_prev, T* __restrict__ pw_parts,
                      int64_t n_sys, int m, int lz, int ly, int lx, int zc,
                      int ty, int sx, int n_rz, int first) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const buf = reinterpret_cast<T*>(smem_raw);
  __shared__ T sh[33];
  const int ny_t = (ly + ty - 1) / ty, nx_t = (lx + sx - 1) / sx;
  const int tile = blockIdx.x % (ny_t * nx_t);
  const int chunk = blockIdx.x / (ny_t * nx_t);
  const int y0 = (tile / nx_t) * ty, x0 = (tile % nx_t) * sx;
  const int th = min(ty, ly - y0), tw = min(sx, lx - x0);
  const int W = tw + 2, hp = W * (th + 2), npts = th * tw;
  const int stride = (ty + 2) * (sx + 2);
  const int64_t plane = (int64_t)ly * lx, nvec = plane * lz;
  const int z0 = chunk * zc, z1 = min(z0 + zc, lz);
  // this thread's points of the tile (py < 0: none): coordinates,
  // in-plane offset and slot in the shared planes
  int64_t off[kPts];
  int slot[kPts], px[kPts], py[kPts];
#pragma unroll
  for (int q = 0; q < kPts; ++q) {
    const int j = threadIdx.x + q * blockDim.x;
    const int ry = j < npts ? j / tw : 0, rx = j < npts ? j - ry * tw : 0;
    py[q] = j < npts ? y0 + ry : -1;
    px[q] = x0 + rx;
    off[q] = (int64_t)(y0 + ry) * lx + x0 + rx;
    slot[q] = (ry + 1) * W + rx + 1;
  }
  for (int64_t s = blockIdx.y; s < n_sys; s += gridDim.y) {
    T beta = T(0);
    if (!first) {
      const T rz = sum_parts(rz_parts + s * n_rz, n_rz, sh);
      const T old = rz_prev[s];
      beta = old > T(0) ? Ar<T>::div(rz, old > T(1e-30) ? old : T(1e-30))
                        : T(0);
    }
    const int64_t fb = (s / m) * nvec;
    const T* __restrict__ zs = z + s * nvec;
    const T* __restrict__ ps = p_old + s * nvec;
    T* __restrict__ pn_out = p_new + s * nvec;
    T* __restrict__ w_out = w + s * nvec;
    const T* __restrict__ ds = diag + fb;
    const T* __restrict__ cxs = cx + fb;
    const T* __restrict__ cys = cy + fb;
    const T* __restrict__ czs = cz + fb;
    const T* __restrict__ ms = mask + fb;
    // p_new of plane k into B: the tile's points and, with halo, its
    // edges (corners are never read) where they lie in the box
    auto fill = [&](T* B, int k, bool halo) {
      const int64_t base = (int64_t)k * plane;
      for (int j = threadIdx.x; j < hp; j += blockDim.x) {
        const int hy = j / W, hx = j - hy * W;
        const int y = y0 + hy - 1, x = x0 + hx - 1;
        const bool in_y = hy >= 1 && hy <= th, in_x = hx >= 1 && hx <= tw;
        if (y < 0 || y >= ly || x < 0 || x >= lx) continue;
        if (!(in_y && in_x) && (!halo || (!in_y && !in_x))) continue;
        const int64_t i = base + (int64_t)y * lx + x;
        const T po = __ldg(ps + i);
        B[j] = first ? po : Ar<T>::add(__ldg(zs + i), Ar<T>::mul(beta, po));
      }
    };
    T* pm_b = buf;
    T* pc_b = buf + stride;
    T* pp_b = buf + 2 * stride;
    if (z0 > 0) fill(pm_b, z0 - 1, false);
    fill(pc_b, z0, true);
    T pw = T(0);
    for (int k = z0; k < z1; ++k) {
      const int64_t base = (int64_t)k * plane;
      T d[kPts] = {}, cxp[kPts] = {}, cxm[kPts] = {}, cyp[kPts] = {},
        cym[kPts] = {}, czp[kPts] = {}, czm[kPts] = {}, mk[kPts] = {};
#pragma unroll
      for (int q = 0; q < kPts; ++q) {
        if (py[q] < 0) continue;
        const int64_t i = base + off[q];
        d[q] = __ldg(ds + i);
        cxp[q] = __ldg(cxs + i);
        cyp[q] = __ldg(cys + i);
        czp[q] = __ldg(czs + i);
        mk[q] = __ldg(ms + i);
        cxm[q] = px[q] > 0 ? __ldg(cxs + i - 1) : T(0);
        cym[q] = py[q] > 0 ? __ldg(cys + i - lx) : T(0);
        czm[q] = k > 0 ? __ldg(czs + i - plane) : T(0);
      }
      if (k + 1 < lz) fill(pp_b, k + 1, k + 1 < z1);
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kPts; ++q) {
        if (py[q] < 0) continue;
        const int c = slot[q], x = px[q], y = py[q];
        const T pc = pc_b[c];
        T acc = Ar<T>::mul(d[q], pc);
        if (x + 1 < lx) acc = add_prod(acc, cxp[q], pc_b[c + 1]);
        if (x > 0) acc = add_prod(acc, cxm[q], pc_b[c - 1]);
        if (y + 1 < ly) acc = add_prod(acc, cyp[q], pc_b[c + W]);
        if (y > 0) acc = add_prod(acc, cym[q], pc_b[c - W]);
        if (k + 1 < lz) acc = add_prod(acc, czp[q], pp_b[c]);
        if (k > 0) acc = add_prod(acc, czm[q], pm_b[c]);
        const T wv = Ar<T>::mul(acc, mk[q]);
        pn_out[base + off[q]] = pc;
        w_out[base + off[q]] = wv;
        pw = add_prod(pw, pc, wv);
      }
      __syncthreads();
      T* const t = pm_b;
      pm_b = pc_b;
      pc_b = pp_b;
      pp_b = t;
    }
    const T tot = block_sum(pw, sh);
    if (threadIdx.x == 0) pw_parts[s * gridDim.x + blockIdx.x] = tot;
  }
}

// grid.x: blocks of kThreads * kPer elements of a system; grid.y: systems.
// Block 0 of a system keeps its r.z for the next pcg_matvec's beta.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    pcg_update_kernel(T* __restrict__ u, T* __restrict__ r,
                      const T* __restrict__ p, const T* __restrict__ w,
                      const T* __restrict__ pw_parts, int n_pw,
                      const T* __restrict__ rz_parts, int n_rz,
                      T* __restrict__ rz_prev, T* __restrict__ rr_parts,
                      int64_t n_sys, int64_t nvec) {
  __shared__ T sh[33];
  for (int64_t s = blockIdx.y; s < n_sys; s += gridDim.y) {
    const int64_t first = (int64_t)blockIdx.x * blockDim.x * kPer;
    T* __restrict__ us = u + s * nvec;
    T* __restrict__ rs = r + s * nvec;
    const T* __restrict__ ps = p + s * nvec;
    const T* __restrict__ ws = w + s * nvec;
    // every load before alpha and before any store, so that they are all
    // in flight while the partials are summed
    T uv[kPer] = {}, rv[kPer] = {}, pv[kPer] = {}, wv[kPer] = {};
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int64_t i = first + (int64_t)j * blockDim.x + threadIdx.x;
      if (i < nvec) {
        uv[j] = us[i];
        rv[j] = rs[i];
        pv[j] = __ldg(ps + i);
        wv[j] = __ldg(ws + i);
      }
    }
    const T pwv = sum_parts(pw_parts + s * n_pw, n_pw, sh);
    const T rz = sum_parts(rz_parts + s * n_rz, n_rz, sh);
    const T alpha =
        pwv > T(0) ? Ar<T>::div(rz, pwv > T(1e-30) ? pwv : T(1e-30)) : T(0);
    if (blockIdx.x == 0 && threadIdx.x == 0) rz_prev[s] = rz;
    T acc = T(0);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int64_t i = first + (int64_t)j * blockDim.x + threadIdx.x;
      if (i < nvec) {
        us[i] = Ar<T>::add(uv[j], Ar<T>::mul(alpha, pv[j]));
        const T rn = Ar<T>::sub(rv[j], Ar<T>::mul(alpha, wv[j]));
        rs[i] = rn;
        acc = add_prod(acc, rn, rn);
      }
    }
    const T tot = block_sum(acc, sh);
    if (threadIdx.x == 0) rr_parts[s * gridDim.x + blockIdx.x] = tot;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    pcg_dot_kernel(const T* __restrict__ r, const T* __restrict__ z,
                   T* __restrict__ rz_parts, int64_t n_sys, int64_t nvec) {
  __shared__ T sh[33];
  for (int64_t s = blockIdx.y; s < n_sys; s += gridDim.y) {
    const int64_t first = (int64_t)blockIdx.x * blockDim.x * kPer;
    const T* __restrict__ rs = r + s * nvec;
    const T* __restrict__ zs = z + s * nvec;
    T rv[kPer] = {}, zv[kPer] = {};
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int64_t i = first + (int64_t)j * blockDim.x + threadIdx.x;
      if (i < nvec) {
        rv[j] = __ldg(rs + i);
        zv[j] = __ldg(zs + i);
      }
    }
    T acc = T(0);
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc = add_prod(acc, rv[j], zv[j]);
    const T tot = block_sum(acc, sh);
    if (threadIdx.x == 0) rz_parts[s * gridDim.x + blockIdx.x] = tot;
  }
}

}  // namespace

// Every pointer is a contiguous device tensor of one dtype (float64 when
// is_f64); the wrapper (ops/pcg_fused.py) checks them and picks the grid
// (the number of partials a system); a block has kThreads threads.  Each
// returns the CUDA error code of its launch (0 on success).
extern "C" int g4p_pcg_matvec(const void* z, const void* p_old, void* p_new,
                              void* w, const void* diag, const void* cx,
                              const void* cy, const void* cz,
                              const void* mask, const void* rz_parts,
                              const void* rz_prev, void* pw_parts,
                              int64_t n_sys, int64_t m, int64_t lz,
                              int64_t ly, int64_t lx, int64_t zc, int64_t ty,
                              int64_t sx, int64_t n_rz, int first,
                              int is_f64, int grid_x, int grid_y,
                              void* stream) {
  const dim3 grid(grid_x, grid_y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = 3 * (size_t)(ty + 2) * (size_t)(sx + 2) *
                      (is_f64 ? sizeof(double) : sizeof(float));
#define G4P_MATVEC(T)                                                     \
  pcg_matvec_kernel<T><<<grid, kThreads, smem, st>>>(                     \
      static_cast<const T*>(z), static_cast<const T*>(p_old),             \
      static_cast<T*>(p_new), static_cast<T*>(w),                         \
      static_cast<const T*>(diag), static_cast<const T*>(cx),             \
      static_cast<const T*>(cy), static_cast<const T*>(cz),               \
      static_cast<const T*>(mask), static_cast<const T*>(rz_parts),       \
      static_cast<const T*>(rz_prev), static_cast<T*>(pw_parts), n_sys,   \
      (int)m, (int)lz, (int)ly, (int)lx, (int)zc, (int)ty, (int)sx,       \
      (int)n_rz, first)
  if (is_f64)
    G4P_MATVEC(double);
  else
    G4P_MATVEC(float);
#undef G4P_MATVEC
  return (int)cudaGetLastError();
}

extern "C" int g4p_pcg_update(void* u, void* r, const void* p, const void* w,
                              const void* pw_parts, int64_t n_pw,
                              const void* rz_parts, int64_t n_rz,
                              void* rz_prev, void* rr_parts, int64_t n_sys,
                              int64_t nvec, int is_f64, int grid_x,
                              int grid_y, void* stream) {
  const dim3 grid(grid_x, grid_y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define G4P_UPDATE(T)                                                     \
  pcg_update_kernel<T><<<grid, kThreads, 0, st>>>(                        \
      static_cast<T*>(u), static_cast<T*>(r), static_cast<const T*>(p),   \
      static_cast<const T*>(w), static_cast<const T*>(pw_parts), (int)n_pw, \
      static_cast<const T*>(rz_parts), (int)n_rz, static_cast<T*>(rz_prev), \
      static_cast<T*>(rr_parts), n_sys, nvec)
  if (is_f64)
    G4P_UPDATE(double);
  else
    G4P_UPDATE(float);
#undef G4P_UPDATE
  return (int)cudaGetLastError();
}

extern "C" int g4p_pcg_dot(const void* r, const void* z, void* rz_parts,
                           int64_t n_sys, int64_t nvec, int is_f64,
                           int grid_x, int grid_y, void* stream) {
  const dim3 grid(grid_x, grid_y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f64)
    pcg_dot_kernel<double><<<grid, kThreads, 0, st>>>(
        static_cast<const double*>(r), static_cast<const double*>(z),
        static_cast<double*>(rz_parts), n_sys, nvec);
  else
    pcg_dot_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(r), static_cast<const float*>(z),
        static_cast<float*>(rz_parts), n_sys, nvec);
  return (int)cudaGetLastError();
}

