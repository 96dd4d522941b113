// K6 with the multigrid preconditioner: the whole preconditioned
// conjugate-gradient solve of solvers/elliptic.py::cg_solve in one
// persistent cooperative launch, with one multigrid cycle per iteration.
//
// Replaces beom_tpu/stencils/cg_vmem.py::_cg_kernel, precond='mg' (the
// Jacobi preconditioner is csrc/cg_jacobi.cu).  The reference runs that
// kernel only where the solver state fits the TPU's VMEM (about 1024^2
// f32) and the XLA loop elsewhere; this kernel keeps its state in device
// memory and runs at every size.
//
// Bound: grid-wide synchronisation and the cycle's latency.  An
// iteration's scalars need a reduction over the whole grid, and its cycle
// is dozens of dependent passes.  The design: one CTA per SM (512 threads
// and the card's opt-in shared memory: mgc::cycle_launch; so
// cudaLaunchCooperativeKernel can hold them all), grid-stride loops over
// the points, and two grid syncs per iteration plus the cycle's:
//   phase 1: the vector updates of the Chronopoulos-Gear recurrence; r
//            mask goes to the cycle's level-0 input and the cycle
//            (csrc/mg_cycle.cuh: the fused gamma schedule, demean off;
//            two tiled passes per visit of a level above the
//            shared-memory tier, the tier on one CTA; 78 grid syncs per
//            cycle at 2048^2 f32) writes u;
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
// cg_solve; the matvec is laplacian_H's.  Sums run in another order than
// torch.sum's, so x agrees with the plain version to the solver
// tolerance, not bit for bit.

#include "coop_stamps.cuh"
#include "mg_cycle.cuh"

namespace {

namespace cg = mgc::cg;
using mgc::grid_sum;
using mgc::NDOT;
using mgc::CYCLE_THREADS;
using mgc::vmax;

template <typename T>
struct Params {
  const T *b, *x0, *Hu, *Hv, *mask;
  T *x, *r, *u, *w, *p, *s, *partials;
  int* iters;
  T* resnorm;
  int ny, nx, maxiter, deflate;
  T inv_dx, inv_dy, lam, tol2, tiny;
  // the cycle's tables, whose level-0 input is bc0 and whose level-0
  // output is u
  mgc::Cycle<T> cyc;
  T* bc0;
  unsigned long long* stamps;   // the timing mode (coop_stamps.cuh), or null
};

template <typename T>
__device__ __forceinline__ T safe_div(T num, T den, T tiny) {
  const T mag = vmax(den < T(0) ? -den : den, tiny);
  return num / (den < T(0) ? -mag : mag);
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

// u[i] in phases 1 and 2: the cycle wrote it from other CTAs (or from
// CTA 0 alone), so it is read from L2; every other work vector is read by
// the thread that wrote it, through L1
template <typename T>
__device__ __forceinline__ T load_u(const T* u, long i) {
  return __ldcg(&u[i]);
}

// the cycle's input at point i
template <typename T>
__device__ __forceinline__ void precond_in(const Params<T>& p, long i, T ri,
                                           T m) {
  p.bc0[i] = ri * m;
}

template <typename T>
__global__ void __launch_bounds__(CYCLE_THREADS) cg_kernel(const Params<T> p) {
  constexpr int NT = CYCLE_THREADS;
  stamp::entry(p.stamps);
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw;   // the cycle's
  T* sh = reinterpret_cast<T*>(smem_raw);
  const long n = long(p.ny) * p.nx;
  const long stride = long(gridDim.x) * NT;
  const long first = long(blockIdx.x) * NT + threadIdx.x;
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
  grid_sum<T, NT>(v, sh, p.partials, round, grid);
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
  // its grid sync also orders x
  grid_sum<T, NT>(v, sh, p.partials, round, grid);
  const T threshold = p.tol2 * vmax(v[0], p.tiny);

  // r = (b - A x) mask, u = precond(r) mask
  for (long i = first; i < n; i += stride) {
    const T m = p.mask[i];
    const T ri = (b_defl(i) - apply_A(p, p.x, i)) * m;
    p.r[i] = ri;
    precond_in<T>(p, i, ri, m);
  }
  grid.sync();
  mgc::run_cycle<T, NT>(p.cyc, smem, p.partials, round, grid);
  stamp::setup(p.stamps);

  T alpha = T(0), beta = T(0), gamma = T(0), rr = T(0);
  T rmean = T(0), umean = T(0);
  int k = 0;
  for (bool first_pass = true;; first_pass = false) {
    if (!first_pass) {
      // phase 1: the recurrence on the deflated (r, u)
      for (long i = first; i < n; i += stride) {
        const T m = p.mask[i];
        const T r0 = p.r[i], u0 = load_u<T>(p.u, i);
        const T ri = p.deflate ? (r0 - rmean * m) * m : r0 * m;
        const T ui = p.deflate ? (u0 - umean * m) * m : u0 * m;
        const T pi = ui + beta * p.p[i];
        const T si = p.w[i] + beta * p.s[i];
        p.p[i] = pi;
        p.s[i] = si;
        p.x[i] = p.x[i] + alpha * pi;
        const T rn = ri - alpha * si;
        p.r[i] = rn;
        precond_in<T>(p, i, rn, m);
      }
      grid.sync();
      mgc::run_cycle<T, NT>(p.cyc, smem, p.partials, round, grid);
    }
    // phase 2: w = A u and the batched dots
    for (int j = 0; j < NDOT; ++j) v[j] = T(0);
    for (long i = first; i < n; i += stride) {
      const T wi = apply_A(p, p.u, i);
      p.w[i] = wi;
      const T ri = p.r[i];
      const T ui = load_u<T>(p.u, i);
      const T m = p.mask[i];
      v[0] += ri * ui;
      v[1] += wi * ui;
      v[2] += ri * ri;
      v[3] += ri * m;
      v[4] += ui * m;
      v[5] += wi * m;
    }
    grid_sum<T, NT>(v, sh, p.partials, round, grid);
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
  stamp::leave(p.stamps);
}

template <typename T>
int cg_fused(const T* b, const T* x0, const T* Hu, const T* Hv,
             const T* mask, T* x, T* r, T* u, T* w, T* pv, T* s, T* partials,
             int partials_len, int* iters, T* resnorm, int ny, int nx,
             int maxiter, int deflate, double inv_dx, double inv_dy,
             double lam, double tol2, double tiny, const long long* mg_ptrs,
             const int* mg_dims, const T* mg_scal, const int* mg_steps,
             int mg_nsteps, int mg_nlev, int mg_nu, int mg_tier,
             int mg_tier_bytes, T* bc0, unsigned long long* stamps,
             void* stream) {
  const void* kernel = reinterpret_cast<const void*>(cg_kernel<T>);
  int blocks = 0, smem = 0, room = 0;
  cudaError_t e = mgc::cycle_launch(kernel, &blocks, &smem);
  if (e == cudaSuccess)
    e = mgc::cycle_room<T>(smem, mg_nlev, mg_nu, mg_tier_bytes, &room);
  if (e != cudaSuccess) return int(e);
  if (2 * blocks * NDOT > partials_len) return int(cudaErrorInvalidValue);
  Params<T> p{b,        x0,      Hu,      Hv,       mask,     x,
              r,        u,       w,       pv,       s,        partials,
              iters,    resnorm, ny,      nx,       maxiter,  deflate,
              T(inv_dx), T(inv_dy), T(lam), T(tol2), T(tiny),
              {mg_ptrs, mg_dims, mg_scal, mg_steps, mg_nsteps, mg_nlev,
               mg_nu, mg_tier, room, T(lam)},
              bc0,      stamps};
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(CYCLE_THREADS),
                                  args, size_t(smem),
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return int(e);
  return int(cudaGetLastError());
}

// the number of CTAs a launch uses on the current device (which = 0), or
// the dynamic shared memory each has (which = 1)
template <typename T>
int grid_query(int which, int* out) {
  int blocks = 0, smem = 0;
  const cudaError_t e = mgc::cycle_launch(
      reinterpret_cast<const void*>(cg_kernel<T>), &blocks, &smem);
  *out = which ? smem : blocks;
  return int(e);
}

}  // namespace

#define CG_FUSED_ENTRY(NAME, BLOCKS, SMEM, T)                                 \
  extern "C" int NAME(const T* b, const T* x0, const T* Hu, const T* Hv,      \
                      const T* mask, T* x, T* r, T* u, T* w, T* pv, T* s,     \
                      T* partials, int partials_len, int* iters, T* resnorm,  \
                      int ny, int nx, int maxiter, int deflate,               \
                      double inv_dx, double inv_dy, double lam, double tol2,  \
                      double tiny, const long long* mg_ptrs,                  \
                      const int* mg_dims, const T* mg_scal,                   \
                      const int* mg_steps, int mg_nsteps, int mg_nlev,        \
                      int mg_nu, int mg_tier, int mg_tier_bytes, T* bc0,      \
                      unsigned long long* stamps, void* stream) {             \
    return cg_fused<T>(b, x0, Hu, Hv, mask, x, r, u, w, pv, s, partials,      \
                       partials_len, iters, resnorm, ny, nx, maxiter,         \
                       deflate, inv_dx, inv_dy, lam, tol2, tiny, mg_ptrs,     \
                       mg_dims, mg_scal, mg_steps, mg_nsteps, mg_nlev, mg_nu, \
                       mg_tier, mg_tier_bytes, bc0, stamps, stream);          \
  }                                                                           \
  extern "C" int BLOCKS(int* blocks) { return grid_query<T>(0, blocks); }     \
  extern "C" int SMEM(int* bytes) { return grid_query<T>(1, bytes); }

CG_FUSED_ENTRY(beom_cg_fused_f32, beom_cg_fused_blocks_f32,
               beom_cg_fused_smem_f32, float)
CG_FUSED_ENTRY(beom_cg_fused_f64, beom_cg_fused_blocks_f64,
               beom_cg_fused_smem_f64, double)

extern "C" const char* beom_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
