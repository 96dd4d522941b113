// K6: the whole Jacobi-preconditioned conjugate-gradient solve of
// solvers/elliptic.py::cg_solve in one persistent cooperative launch.
//
// Replaces beom_tpu/stencils/cg_vmem.py::_cg_kernel with
// precond='jacobi' (its in-kernel multigrid preconditioner is not
// ported).  The reference runs that kernel only where the solver state
// fits the TPU's VMEM (about 1024^2 f32) and the XLA loop elsewhere;
// this kernel keeps its state in device memory and runs at every size.
//
// Bound: device-memory bytes and grid-wide synchronisation.  An
// iteration reads ~13 and writes 6 grid fields (the five-point matvec,
// the preconditioner, the vector updates) and its scalars need a
// reduction over the whole grid.  The design: one CTA per resident slot
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SM count, so
// cudaLaunchCooperativeKernel can hold them all), grid-stride loops over
// the points, and two grid syncs per iteration:
//   phase 1: the vector updates of the Chronopoulos-Gear recurrence and
//            u = inv_diag r mask (pointwise, each thread its own points);
//   sync;
//   phase 2: w = A u (reads the neighbours of u) and the six dot
//            products (r,u), (w,u), (r,r), (r,mask), (u,mask), (w,mask)
//            as per-CTA partial sums in device memory;
//   sync;
// then every CTA sums the partials in the same fixed order (a strided
// per-thread sum, then a fixed shared-memory tree), so every CTA holds
// the same alpha, beta, the deflation means and the convergence test,
// takes the same branch, and a run is bitwise reproducible.  The
// deflated (r, u) of the lam = 0 solve are applied lazily in the next
// phase 1, where they are read anyway.
//
// Scalar algebra, deflation, safe_div and the stopping test are those of
// cg_solve; the matvec is laplacian_H's and the Jacobi inverse diagonal
// arrives from the caller (jacobi_diag).  Sums run in another order than
// torch.sum's, so x agrees with the plain version to the solver
// tolerance, not bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int NDOT = 6;

template <typename T>
struct Params {
  const T *b, *x0, *Hu, *Hv, *mask, *inv_diag;
  T *x, *r, *u, *w, *p, *s, *partials;
  int* iters;
  T* resnorm;
  int ny, nx, maxiter, deflate;
  T inv_dx, inv_dy, lam, tol2, tiny;
};

// jnp.maximum: NaN propagates
template <typename T>
__device__ __forceinline__ T vmax(T a, T b) {
  return (a > b || a != a) ? a : b;
}

template <typename T>
__device__ __forceinline__ T safe_div(T num, T den, T tiny) {
  const T mag = vmax(den < T(0) ? -den : den, tiny);
  return num / (den < T(0) ? -mag : mag);
}

// the block's sums of v[0..n) in a fixed tree; every thread gets them
template <typename T, int N>
__device__ void block_sum(T (&v)[N], T* sh) {
  const int tid = threadIdx.x;
  for (int j = 0; j < N; ++j) sh[j * THREADS + tid] = v[j];
  __syncthreads();
  for (int st = THREADS / 2; st > 0; st >>= 1) {
    if (tid < st)
      for (int j = 0; j < N; ++j)
        sh[j * THREADS + tid] += sh[j * THREADS + tid + st];
    __syncthreads();
  }
  for (int j = 0; j < N; ++j) v[j] = sh[j * THREADS];
  __syncthreads();
}

// v holds this thread's partial sums: reduce them over the whole grid.
// Every CTA computes the same totals in the same order.  Consecutive
// calls alternate between two halves of `partials`: a CTA may still be
// reading one call's partials when another writes the next call's, and
// the grid sync inside the next call orders the one after it.
template <typename T>
__device__ void grid_sum(T (&v)[NDOT], T* sh, T* partials, int& round,
                         cg::grid_group& grid) {
  T* part = partials + (round++ & 1) * int(gridDim.x) * NDOT;
  block_sum(v, sh);
  if (threadIdx.x == 0)
    for (int j = 0; j < NDOT; ++j) part[blockIdx.x * NDOT + j] = v[j];
  grid.sync();
  for (int j = 0; j < NDOT; ++j) v[j] = T(0);
  for (int i = threadIdx.x; i < int(gridDim.x); i += THREADS)
    for (int j = 0; j < NDOT; ++j) v[j] += __ldcg(&part[i * NDOT + j]);
  block_sum(v, sh);
}

// (A q)_i = laplacian_H: d_xm(Hu d_xp q) + d_ym(Hv d_yp q) [- lam q], masked
template <typename T>
__device__ __forceinline__ T apply_A(const Params<T>& p, const T* q, long i) {
  const int j = int(i / p.nx);
  const int c = int(i - long(j) * p.nx);
  const long row = long(j) * p.nx;
  const long e = row + (c + 1 == p.nx ? 0 : c + 1);
  const long w = row + (c == 0 ? p.nx - 1 : c - 1);
  const long n = long(j + 1 == p.ny ? 0 : j + 1) * p.nx + c;
  const long s = long(j == 0 ? p.ny - 1 : j - 1) * p.nx + c;
  const T qi = __ldcg(&q[i]);
  const T gx = p.Hu[i] * ((__ldcg(&q[e]) - qi) * p.inv_dx);
  const T gxw = p.Hu[w] * ((qi - __ldcg(&q[w])) * p.inv_dx);
  const T gy = p.Hv[i] * ((__ldcg(&q[n]) - qi) * p.inv_dy);
  const T gys = p.Hv[s] * ((qi - __ldcg(&q[s])) * p.inv_dy);
  T out = (gx - gxw) * p.inv_dx + (gy - gys) * p.inv_dy;
  if (p.lam != T(0)) out = out - p.lam * qi;
  return out * p.mask[i];
}

template <typename T>
__global__ void __launch_bounds__(THREADS) cg_kernel(const Params<T> p) {
  cg::grid_group grid = cg::this_grid();
  __shared__ T sh[NDOT * THREADS];
  const long n = long(p.ny) * p.nx;
  const long stride = long(gridDim.x) * THREADS;
  const long first = long(blockIdx.x) * THREADS + threadIdx.x;
  T v[NDOT];
  int round = 0;

  // nwet and the wet means of b * mask and x0 (deflate0)
  for (int j = 0; j < NDOT; ++j) v[j] = T(0);
  for (long i = first; i < n; i += stride) {
    const T m = p.mask[i];
    v[0] += m * m;
    v[1] += (p.b[i] * m) * m;
    v[2] += p.x0[i] * m;
  }
  grid_sum(v, sh, p.partials, round, grid);
  const T nwet = vmax(v[0], T(1));
  const T bmean = v[1] / nwet;
  const T xmean = v[2] / nwet;

  // b = deflate0(b * mask) (recomputed where needed, not stored),
  // x = deflate0(x0), p = s = 0, b2 = (b, b)
  auto b_defl = [&](long i) {
    const T m = p.mask[i];
    const T bm = p.b[i] * m;
    return p.deflate ? (bm - m * bmean) * m : bm * m;
  };
  for (int j = 0; j < NDOT; ++j) v[j] = T(0);
  for (long i = first; i < n; i += stride) {
    const T m = p.mask[i];
    p.x[i] = p.deflate ? (p.x0[i] - m * xmean) * m : p.x0[i] * m;
    p.p[i] = T(0);
    p.s[i] = T(0);
    const T bd = b_defl(i);
    v[0] += bd * bd;
  }
  grid_sum(v, sh, p.partials, round, grid);   // its grid sync also orders x
  const T threshold = p.tol2 * vmax(v[0], p.tiny);

  // r = (b - A x) mask, u = precond(r) mask
  for (long i = first; i < n; i += stride) {
    const T m = p.mask[i];
    const T ri = (b_defl(i) - apply_A(p, p.x, i)) * m;
    p.r[i] = ri;
    p.u[i] = (p.inv_diag[i] * ri) * m;
  }
  grid.sync();

  T alpha = T(0), beta = T(0), gamma = T(0), rr = T(0);
  T rmean = T(0), umean = T(0);
  int k = 0;
  for (bool first_pass = true;; first_pass = false) {
    if (!first_pass) {
      // phase 1: the recurrence on the deflated (r, u)
      for (long i = first; i < n; i += stride) {
        const T m = p.mask[i];
        const T ri = p.deflate ? (p.r[i] - rmean * m) * m : p.r[i] * m;
        const T ui = p.deflate ? (p.u[i] - umean * m) * m : p.u[i] * m;
        const T pi = ui + beta * p.p[i];
        const T si = p.w[i] + beta * p.s[i];
        p.p[i] = pi;
        p.s[i] = si;
        p.x[i] = p.x[i] + alpha * pi;
        const T rn = ri - alpha * si;
        p.r[i] = rn;
        p.u[i] = (p.inv_diag[i] * rn) * m;
      }
      grid.sync();
    }
    // phase 2: w = A u and the batched dots
    for (int j = 0; j < NDOT; ++j) v[j] = T(0);
    for (long i = first; i < n; i += stride) {
      const T wi = apply_A(p, p.u, i);
      p.w[i] = wi;
      const T ri = p.r[i];
      const T ui = p.u[i];
      const T m = p.mask[i];
      v[0] += ri * ui;
      v[1] += wi * ui;
      v[2] += ri * ri;
      v[3] += ri * m;
      v[4] += ui * m;
      v[5] += wi * m;
    }
    grid_sum(v, sh, p.partials, round, grid);
    T gamma_n = v[0], delta = v[1], rr_n = v[2];
    if (p.deflate) {
      gamma_n = v[0] - v[3] * v[4] / nwet;
      delta = v[1] - v[5] * v[4] / nwet;
      rr_n = v[2] - v[3] * v[3] / nwet;
      rmean = v[3] / nwet;
      umean = v[4] / nwet;
    }
    if (first_pass) {
      alpha = safe_div(gamma_n, delta, p.tiny);
      beta = T(0);
    } else {
      const T beta_n = safe_div(gamma_n, gamma, p.tiny);
      alpha = safe_div(gamma_n,
                       delta - beta_n * safe_div(gamma_n, alpha, p.tiny),
                       p.tiny);
      beta = beta_n;
      ++k;
    }
    gamma = gamma_n;
    rr = rr_n;
    // the same test in every CTA: they leave together
    if (!(k < p.maxiter && rr > threshold)) break;
  }

  for (long i = first; i < n; i += stride) p.x[i] = p.x[i] * p.mask[i];
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *p.iters = k;
    *p.resnorm = rr;
  }
}

template <typename T>
int cg_fused(const T* b, const T* x0, const T* Hu, const T* Hv,
             const T* mask, const T* inv_diag, T* x, T* r, T* u, T* w, T* pv,
             T* s, T* partials, int partials_len, int* iters, T* resnorm,
             int ny, int nx, int maxiter, int deflate, double inv_dx,
             double inv_dy, double lam, double tol2, double tiny,
             void* stream) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return int(e);
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return int(e);
  if (!coop) return int(cudaErrorNotSupported);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return int(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cg_kernel<T>,
                                                    THREADS, 0);
  if (e != cudaSuccess) return int(e);
  const int blocks = per_sm * sms;
  if (blocks < 1) return int(cudaErrorLaunchOutOfResources);
  if (2 * blocks * NDOT > partials_len) return int(cudaErrorInvalidValue);
  Params<T> p{b,        x0,      Hu,      Hv,     mask,  inv_diag,
              x,        r,       u,       w,      pv,    s,
              partials, iters,   resnorm, ny,     nx,    maxiter,
              deflate,  T(inv_dx), T(inv_dy), T(lam), T(tol2), T(tiny)};
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(cg_kernel<T>),
                                  dim3(blocks), dim3(THREADS), args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return int(e);
  return int(cudaGetLastError());
}

// the number of CTAs a launch uses on the current device
template <typename T>
int grid_blocks(int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cg_kernel<T>,
                                                      THREADS, 0);
  *blocks = per_sm * sms;
  return int(e);
}

}  // namespace

#define CG_FUSED_ENTRY(NAME, BLOCKS, T)                                      \
  extern "C" int NAME(const T* b, const T* x0, const T* Hu, const T* Hv,     \
                      const T* mask, const T* inv_diag, T* x, T* r, T* u,    \
                      T* w, T* pv, T* s, T* partials, int partials_len,      \
                      int* iters, T* resnorm, int ny, int nx, int maxiter,   \
                      int deflate, double inv_dx, double inv_dy, double lam, \
                      double tol2, double tiny, void* stream) {              \
    return cg_fused<T>(b, x0, Hu, Hv, mask, inv_diag, x, r, u, w, pv, s,     \
                       partials, partials_len, iters, resnorm, ny, nx,       \
                       maxiter, deflate, inv_dx, inv_dy, lam, tol2, tiny,    \
                       stream);                                              \
  }                                                                          \
  extern "C" int BLOCKS(int* blocks) { return grid_blocks<T>(blocks); }

CG_FUSED_ENTRY(beom_cg_fused_f32, beom_cg_fused_blocks_f32, float)
CG_FUSED_ENTRY(beom_cg_fused_f64, beom_cg_fused_blocks_f64, double)

extern "C" const char* beom_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
