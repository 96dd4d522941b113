// The multigrid cycle inside one persistent cooperative launch, shared by
// K5 (mg_coarse.cu) and the multigrid half of K6 (cg_fused.cu), with the
// fixed-order grid reductions both use.
//
// The host flattens one cycle of solvers/multigrid.py::_vcycle (the
// levels, nu, nu_coarse, the gamma schedule and the de-mean switch) into
// a list of steps, each one pass over one level (stencils/mg_coarse.py
// ::cycle_steps): a red or black half-sweep, the residual, the
// restriction, the prolongation with its correction, an add, a de-mean
// (a grid reduction) or a zero fill.  Every CTA walks the same list.  A
// step on a level with at most the host's `solo` size runs on CTA 0 alone
// and is followed by __syncthreads when the next step is solo too; every
// other step is followed by a grid sync.  The small levels, which a
// W-cycle visits most often, so cost no grid syncs among themselves.
//
// Each level is a row of pointers in `ptrs`: its face depths Hu, Hv, the
// west and south ones Hu_w, Hv_s, the mask and 1/diag (made by the host
// as the eager level is), then five work fields BC, XC, RC, X, R (the
// restricted right-hand side and the accumulated correction its parent
// keeps, the parent's second-pass residual, a visit's own x and
// residual).  Work fields are written by one launch and read by other
// CTAs, so they are read with __ldcg (L2, not the CTA's L1).  The
// arithmetic mirrors _halfsweep, _apply_A, _restrict_1d and _prolong_1d
// op for op (built with --fmad=false), so without the de-mean a cycle is
// bit for bit the eager one; a de-mean sums in another order than
// torch.sum.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace mgc {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
constexpr int NDOT = 6;
constexpr int MAX_CTAS_PER_SM = 2;

// a level's row in the pointer table
constexpr int F_HU = 0, F_HV = 1, F_HUW = 2, F_HVS = 3, F_MASK = 4,
              F_INV = 5, NPTR = 11;
constexpr int NSCAL = 3;       // rdx2, rdy2, nwet
constexpr int STEP_INTS = 6;   // op, level, a, b, c, solo

enum Op {
  OP_ZERO = 0,      // a: x                     x = 0
  OP_SWEEP = 1,     // a: x, b: rhs, c: colour | 2 * (x reads as 0)
  OP_RESID = 2,     // a: x, b: rhs, c: r       r = (b - A x) mask
  OP_RESTRICT = 3,  // a: fine src, b: coarse dst (level + 1)
  OP_DEMEAN = 4,    // a: v                     v = (v - mask sum(v)/nwet) mask
  OP_ADD = 5,       // a: dst, b: src           dst = dst + src
  OP_PROLONG = 6,   // a: fine x, b: coarse src x = (x + P src) mask
};

template <typename T>
struct Cycle {
  const long long* ptrs;   // nlev x NPTR
  const int* dims;         // nlev x (ny, nx)
  const T* scal;           // nlev x (rdx2, rdy2, nwet)
  const int* steps;        // nsteps x STEP_INTS
  int nsteps;
  T lam;
};

// jnp.maximum: NaN propagates
template <typename T>
__device__ __forceinline__ T vmax(T a, T b) {
  return (a > b || a != a) ? a : b;
}

// the block's sums of v[0..N) in a fixed tree; every thread gets them
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

__device__ __forceinline__ int wrap(int a, int n) {
  return a < 0 ? a + n : (a >= n ? a - n : a);
}

template <typename T>
__device__ __forceinline__ T* ptr(const Cycle<T>& c, int lev, int which) {
  return reinterpret_cast<T*>(c.ptrs[lev * NPTR + which]);
}

// one step; `first` and `stride` spread the points over the grid (or
// over CTA 0 alone for a solo step)
template <typename T>
__device__ void exec_step(const Cycle<T>& c, const int* st, bool solo,
                          T* sh, T* partials, int& round,
                          cg::grid_group& grid) {
  const int op = st[0], lev = st[1];
  const int ny = c.dims[2 * lev], nx = c.dims[2 * lev + 1];
  const long n = long(ny) * nx;
  const long first =
      solo ? long(threadIdx.x) : long(blockIdx.x) * THREADS + threadIdx.x;
  const long stride = solo ? long(THREADS) : long(gridDim.x) * THREADS;
  const T* Hu = ptr(c, lev, F_HU);
  const T* Hv = ptr(c, lev, F_HV);
  const T* Huw = ptr(c, lev, F_HUW);
  const T* Hvs = ptr(c, lev, F_HVS);
  const T* mask = ptr(c, lev, F_MASK);
  const T* inv = ptr(c, lev, F_INV);
  const T rdx2 = c.scal[NSCAL * lev], rdy2 = c.scal[NSCAL * lev + 1];
  const T nwet = c.scal[NSCAL * lev + 2];
  T* a = ptr(c, lev, st[2]);

  switch (op) {
    case OP_ZERO:
      for (long i = first; i < n; i += stride) a[i] = T(0);
      break;
    case OP_SWEEP: {
      const T* b = ptr(c, lev, st[3]);
      const int colour = st[4] & 1;       // 0: red, (row + column) even
      const bool zero = (st[4] & 2) != 0;
      for (long i = first; i < n; i += stride) {
        const int j = int(i / nx), col = int(i - long(j) * nx);
        const T m = mask[i];
        if (((j + col) & 1) == colour && m > T(0)) {
          T xe = T(0), xw = T(0), xn = T(0), xs = T(0);
          if (!zero) {
            const long row = long(j) * nx;
            xe = __ldcg(&a[row + wrap(col + 1, nx)]);
            xw = __ldcg(&a[row + wrap(col - 1, nx)]);
            xn = __ldcg(&a[long(wrap(j + 1, ny)) * nx + col]);
            xs = __ldcg(&a[long(wrap(j - 1, ny)) * nx + col]);
          }
          const T nb = (Hu[i] * xe + Huw[i] * xw) * rdx2 +
                       (Hv[i] * xn + Hvs[i] * xs) * rdy2;
          a[i] = ((__ldcg(&b[i]) - nb) * inv[i]) * m;
        } else if (zero) {
          a[i] = T(0);
        } else if (!(m > T(0))) {
          a[i] = __ldcg(&a[i]) * m;       // the other colour, re-masked
        }
      }
      break;
    }
    case OP_RESID: {
      const T* b = ptr(c, lev, st[3]);
      T* r = ptr(c, lev, st[4]);
      for (long i = first; i < n; i += stride) {
        const int j = int(i / nx), col = int(i - long(j) * nx);
        const long row = long(j) * nx;
        const T q = __ldcg(&a[i]);
        const T qe = __ldcg(&a[row + wrap(col + 1, nx)]);
        const T qw = __ldcg(&a[row + wrap(col - 1, nx)]);
        const T qn = __ldcg(&a[long(wrap(j + 1, ny)) * nx + col]);
        const T qs = __ldcg(&a[long(wrap(j - 1, ny)) * nx + col]);
        T out = (Hu[i] * qe + Huw[i] * qw - (Hu[i] + Huw[i]) * q) * rdx2 +
                (Hv[i] * qn + Hvs[i] * qs - (Hv[i] + Hvs[i]) * q) * rdy2;
        if (c.lam != T(0)) out = out - c.lam * q;
        const T m = mask[i];
        r[i] = (__ldcg(&b[i]) - out * m) * m;
      }
      break;
    }
    case OP_RESTRICT: {
      // dst on level + 1: y first, then x, as _restrict2
      const int cy = c.dims[2 * lev + 2], cx = c.dims[2 * lev + 3];
      T* dst = ptr(c, lev + 1, st[3]);
      const T* cmask = ptr(c, lev + 1, F_MASK);
      const long nc = long(cy) * cx;
      for (long i = first; i < nc; i += stride) {
        const int J = int(i / cx), I = int(i - long(J) * cx);
        const long r0 = long(wrap(2 * J - 1, ny)) * nx;
        const long r1 = long(2 * J) * nx;
        const long r2 = long(2 * J + 1) * nx;
        const long r3 = long(wrap(2 * J + 2, ny)) * nx;
        T ry[4];
        for (int q = 0; q < 4; ++q) {
          const int cc = wrap(2 * I - 1 + q, nx);
          ry[q] = T(0.5) * (T(0.75) * (__ldcg(&a[r1 + cc]) +
                                       __ldcg(&a[r2 + cc])) +
                            T(0.25) * __ldcg(&a[r0 + cc]) +
                            T(0.25) * __ldcg(&a[r3 + cc]));
        }
        const T v = T(0.5) * (T(0.75) * (ry[1] + ry[2]) + T(0.25) * ry[0] +
                              T(0.25) * ry[3]);
        dst[i] = v * cmask[i];
      }
      break;
    }
    case OP_DEMEAN: {
      T v[NDOT];
      for (int q = 0; q < NDOT; ++q) v[q] = T(0);
      for (long i = first; i < n; i += stride) v[0] += __ldcg(&a[i]);
      if (solo)
        block_sum(v, sh);
      else
        grid_sum(v, sh, partials, round, grid);
      const T mean = v[0] / nwet;
      for (long i = first; i < n; i += stride) {
        const T m = mask[i];
        a[i] = (__ldcg(&a[i]) - m * mean) * m;
      }
      break;
    }
    case OP_ADD: {
      const T* src = ptr(c, lev, st[3]);
      for (long i = first; i < n; i += stride)
        a[i] = __ldcg(&a[i]) + __ldcg(&src[i]);
      break;
    }
    case OP_PROLONG: {
      // src on level + 1: y first, then x, as _prolong2
      const int cy = c.dims[2 * lev + 2], cx = c.dims[2 * lev + 3];
      const T* src = ptr(c, lev + 1, st[3]);
      for (long i = first; i < n; i += stride) {
        const int j = int(i / nx), col = int(i - long(j) * nx);
        const int J = j >> 1, I = col >> 1;
        const long Jr = long(J) * cx;
        const long Jn = long(wrap((j & 1) ? J + 1 : J - 1, cy)) * cx;
        const int In = wrap((col & 1) ? I + 1 : I - 1, cx);
        const T t0 = T(0.75) * __ldcg(&src[Jr + I]) +
                     T(0.25) * __ldcg(&src[Jn + I]);
        const T t1 = T(0.75) * __ldcg(&src[Jr + In]) +
                     T(0.25) * __ldcg(&src[Jn + In]);
        const T f = T(0.75) * t0 + T(0.25) * t1;
        a[i] = (__ldcg(&a[i]) + f) * mask[i];
      }
      break;
    }
    default:
      break;
  }
}

// the whole cycle; every CTA of the grid calls it
template <typename T>
__device__ void run_cycle(const Cycle<T>& c, T* sh, T* partials, int& round,
                          cg::grid_group& grid) {
  for (int s = 0; s < c.nsteps; ++s) {
    const int* st = c.steps + STEP_INTS * s;
    const bool solo = st[5] != 0;
    if (!solo || blockIdx.x == 0)
      exec_step(c, st, solo, sh, partials, round, grid);
    const bool next_solo =
        s + 1 < c.nsteps && c.steps[STEP_INTS * (s + 1) + 5] != 0;
    if (solo && next_solo) {
      if (blockIdx.x == 0) __syncthreads();
    } else {
      grid.sync();
    }
  }
}

// the CTAs a cooperative launch of `kernel` with THREADS threads uses:
// the resident ones, at most MAX_CTAS_PER_SM per SM
inline cudaError_t coop_blocks(const void* kernel, int* blocks) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  *blocks = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, 0);
  if (e == cudaSuccess) {
    *blocks = (per_sm < MAX_CTAS_PER_SM ? per_sm : MAX_CTAS_PER_SM) * sms;
    if (*blocks < 1) e = cudaErrorLaunchOutOfResources;
  }
  return e;
}

}  // namespace mgc
