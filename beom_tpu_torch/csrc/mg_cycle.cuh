// The multigrid cycle inside one persistent cooperative launch, shared by
// K5 (mg_coarse.cu) and the multigrid half of K6 (cg_fused.cu), with the
// fixed-order grid reductions both use.
//
// The host flattens one cycle of solvers/multigrid.py::_vcycle (the
// levels, nu, nu_coarse, the gamma schedule and the de-mean switch) into
// a list of steps (stencils/mg_coarse.py::cycle_steps), and every CTA
// walks the same list.  Bound: latency.  A cycle is hundreds of dependent
// passes over levels of 16^2 to 2048^2 points, each reading neighbours
// the pass before wrote; on the H100 a step that does nothing but its
// grid sync takes ~1.6 us, more than a pass over a small level
// (tools/cycle_parts.py).  The design spends few such steps:
//
//  * The shared-memory tier.  From level `tier` down, the levels'
//    statics and work fields fit one CTA's shared memory together (the
//    host picks the largest such level for this card and dtype: 64^2 at
//    f32, 32^2 at f64).  The coarse correction under a visit of the level
//    above the tier, the recursion and the gamma loop included, runs on
//    CTA 0 alone between OP_TIER_IN (load the statics of every tier level
//    and the right-hand side) and OP_TIER_OUT (write the correction
//    back), its steps separated by __syncthreads, a run of half-sweeps
//    one step (OP_SWEEPS; on a level of at most one cell per thread each
//    thread keeps its cell's coefficients in registers).  The tier costs
//    one grid sync per visit where the walk before it paid one per pass.
//    It runs on one SM, bound by that SM's instruction rate.
//  * Two tiled passes per visit above the tier.  OP_PRE does the 2 nu
//    pre-smoothing half-sweeps from zero, the residual and its
//    restriction; OP_POST the prolongation with its correction and the 2
//    nu post-smoothing half-sweeps.  Each CTA takes tiles of t x t points
//    with a halo of W in shared memory, loaded with periodic wrap: a
//    half-sweep updates [1, R-1) of the R = t + 2W block, so after h
//    half-sweeps [h, R-h) is exact (as csrc/rb_sweep.cu).  OP_PRE takes
//    W = 2 nu + 2 (the residual reads one cell more, the restriction's
//    4-point stencil one more again), OP_POST W = 2 nu.  OP_PRE can also
//    form its right-hand side as the gamma loop's residual BC - A XC
//    (and store it: OP_POST reads it), OP_POST its correction as XC + X
//    (the gamma loop's last add).  The tiles' halos overlap, so a tiled
//    pass reads no field it writes: OP_PRE leaves its x in R, where
//    OP_POST takes it from.
//  * Everything else (the coarsest level outside the tier, the gamma
//    loop's adds where a de-mean follows, the de-means) is a plain step,
//    one pass over one level by the whole grid or, in the tier, by CTA 0.
//
// Each level is a row of pointers in `ptrs`: its face depths Hu, Hv, the
// mask and 1/diag (made by the host as the eager level is), then five
// work fields BC, XC, RC, X, R (the restricted right-hand side and the
// accumulated correction its parent keeps, the parent's second-pass
// residual, a visit's own x and residual).  The west and south face
// depths Hu_w, Hv_s are the periodic shifts of Hu and Hv, so they are
// read as the neighbour's Hu and Hv.  Every CTA copies the level table
// into shared memory when the walk starts, and fetches each step's word
// while the step before runs: a step's own latency is that of shared
// memory, not of L2.  In device memory, work fields are written by one
// CTA and read by others, so they are read with __ldcg (L2, not the
// CTA's L1).  In the tier, the levels lie one after another in shared
// memory, nine planes each.  The arithmetic mirrors _halfsweep,
// _apply_A, _restrict_1d and _prolong_1d op for op (built with
// --fmad=false), so without the de-mean a cycle is bit for bit the eager
// one; a de-mean sums in another order than torch.sum.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace mgc {

namespace cg = cooperative_groups;

constexpr int CYCLE_THREADS = 512;    // the cycle kernels' CTA
constexpr int NDOT = 6;

// a level's row in the pointer table, and its planes in the tier
constexpr int F_HU = 0, F_HV = 1, F_MASK = 2, F_INV = 3, F_BC = 4,
              F_XC = 5, F_X = 7, F_R = 8, NPLANES = 9;
constexpr int NSCAL = 3;       // rdx2, rdy2, nwet
// the level table in shared memory: at most MAX_LEVELS rows of LEVEL_BYTES
constexpr int MAX_LEVELS = 16, LEVEL_BYTES = 128;
// a tiled pass's shared planes (x, b, Hu, Hv, mask, 1/diag) and tiles
constexpr int TILE_PLANES = 6, MIN_TILE = 8, MAX_TILE = 64;

// a step is one int: op | level << 4 | a << 8 | b << 12 | c << 16 |
// in_tier << 26 (stencils/mg_coarse.py::pack)
enum Op {
  OP_ZERO = 0,      // a: x                     x = 0
  OP_SWEEP = 1,     // a: x, b: rhs, c: colour | 2 * (x reads as 0)
  OP_RESID = 2,     // a: x, b: rhs, c: r       r = (b - A x) mask
  OP_RESTRICT = 3,  // a: fine src, b: coarse dst (level + 1)
  OP_DEMEAN = 4,    // a: v                     v = (v - mask sum(v)/nwet) mask
  OP_ADD = 5,       // a: dst, b: src           dst = dst + src
  OP_PROLONG = 6,   // a: fine x, b: coarse src x = (x + P src) mask
  OP_PRE = 7,       // a: x (R), b: rhs, c: rhs = (BC - A XC) mask first
                    //   x = nu sweeps from 0; BC(level + 1) = P'(b - A x)
  OP_POST = 8,      // a: x, b: rhs, c: the correction is XC + X
                    //   x = nu reversed sweeps of (R + P XC(level + 1)) mask
  OP_TIER_IN = 9,   // a: rhs                   load the tier
  OP_TIER_OUT = 10, // a: x                     write the tier's x back
  OP_SWEEPS = 11,   // a: x, b: rhs, c: colour | 2 * (x reads as 0) |
                    //   count << 2: count half-sweeps, colours alternating
                    //   (in the tier only)
};

struct Step {
  int op, lev, a, b, c;
  bool tier;
  __device__ __forceinline__ explicit Step(int w)
      : op(w & 15), lev((w >> 4) & 15), a((w >> 8) & 15), b((w >> 12) & 15),
        c((w >> 16) & 1023), tier(((w >> 26) & 1) != 0) {}
};

template <typename T>
struct Cycle {
  const long long* ptrs;   // nlev x NPLANES
  const int* dims;         // nlev x (ny, nx)
  const T* scal;           // nlev x (rdx2, rdy2, nwet)
  const int* steps;        // nsteps packed steps
  int nsteps, nlev, nu;
  int tier;                // the tier's first level (nlev: none)
  int room;                // shared-memory bytes for the tier or a tile
  T lam;
};

// a level as the kernel reads it, in shared memory: its planes in device
// memory, its size, its planes' offset in the tier, its scalars
template <typename T>
struct Level {
  T* f[NPLANES];
  int ny, nx, off;
  T rdx2, rdy2, nwet;
};

// jnp.maximum: NaN propagates
template <typename T>
__device__ __forceinline__ T vmax(T a, T b) {
  return (a > b || a != a) ? a : b;
}

// the block's sums of v[0..N) in a fixed tree; every thread gets them
template <typename T, int N, int NT>
__device__ void block_sum(T (&v)[N], T* sh) {
  const int tid = threadIdx.x;
  for (int j = 0; j < N; ++j) sh[j * NT + tid] = v[j];
  __syncthreads();
  for (int st = NT / 2; st > 0; st >>= 1) {
    if (tid < st)
      for (int j = 0; j < N; ++j)
        sh[j * NT + tid] += sh[j * NT + tid + st];
    __syncthreads();
  }
  for (int j = 0; j < N; ++j) v[j] = sh[j * NT];
  __syncthreads();
}

// v holds this thread's partial sums: reduce them over the whole grid.
// Every CTA computes the same totals in the same order.  Consecutive
// calls alternate between two halves of `partials`: a CTA may still be
// reading one call's partials when another writes the next call's, and
// the grid sync inside the next call orders the one after it.
template <typename T, int NT>
__device__ void grid_sum(T (&v)[NDOT], T* sh, T* partials, int& round,
                         cg::grid_group& grid) {
  T* part = partials + (round++ & 1) * int(gridDim.x) * NDOT;
  block_sum<T, NDOT, NT>(v, sh);
  if (threadIdx.x == 0)
    for (int j = 0; j < NDOT; ++j) part[blockIdx.x * NDOT + j] = v[j];
  grid.sync();
  for (int j = 0; j < NDOT; ++j) v[j] = T(0);
  for (int i = threadIdx.x; i < int(gridDim.x); i += NT)
    for (int j = 0; j < NDOT; ++j) v[j] += __ldcg(&part[i * NDOT + j]);
  block_sum<T, NDOT, NT>(v, sh);
}

// a in [-n, 2n)
__device__ __forceinline__ int wrap(int a, int n) {
  return a < 0 ? a + n : (a >= n ? a - n : a);
}

// any a
__device__ __forceinline__ int wrap_any(int a, int n) {
  a %= n;
  return a < 0 ? a + n : a;
}

// a stride walk over the points of a row-major (?, nx) array: index,
// row and column, without a division per point
struct Walk {
  int i, j, col, dj, dc, nx;
  __device__ __forceinline__ Walk(int first, int stride, int n_x)
      : i(first), j(first / n_x), col(first - (first / n_x) * n_x),
        dj(stride / n_x), dc(stride - (stride / n_x) * n_x), nx(n_x) {}
  __device__ __forceinline__ void next(int stride) {
    i += stride;
    j += dj;
    col += dc;
    if (col >= nx) {
      col -= nx;
      ++j;
    }
  }
};

// a work field in device memory (__ldcg) or in the tier's shared memory
template <bool SH, typename T>
__device__ __forceinline__ T ld(const T* p) {
  if constexpr (SH)
    return *p;
  else
    return __ldcg(p);
}

// plane `which` of a level, in device memory or (SH) in the tier
template <bool SH, typename T>
__device__ __forceinline__ T* fld(const Level<T>& L, int which, T* tier) {
  if constexpr (SH)
    return tier + L.off + which * L.ny * L.nx;
  else
    return L.f[which];
}

// every CTA copies the level table into shared memory
template <typename T, int NT>
__device__ void load_levels(const Cycle<T>& c, Level<T>* lv) {
  const int t = threadIdx.x;
  if (t < c.nlev) {
    Level<T> L;
    for (int p = 0; p < NPLANES; ++p)
      L.f[p] = reinterpret_cast<T*>(c.ptrs[t * NPLANES + p]);
    L.ny = c.dims[2 * t];
    L.nx = c.dims[2 * t + 1];
    int off = 0;
    for (int l = c.tier; l < t; ++l)
      off += NPLANES * c.dims[2 * l] * c.dims[2 * l + 1];
    L.off = off;
    L.rdx2 = c.scal[NSCAL * t];
    L.rdy2 = c.scal[NSCAL * t + 1];
    L.nwet = c.scal[NSCAL * t + 2];
    lv[t] = L;
  }
  __syncthreads();
}

// the shared state of one walk
template <typename T>
struct Ctx {
  const Level<T>* lv;   // the level table (shared memory)
  T* sh;                // the reductions' NDOT x NT scratch
  T* data;              // the tier or a tile (room bytes)
  T* partials;
  int nu, room;
  T lam;
};

// one plain step over one level: by the whole grid on the fields in
// device memory, or (SH) by this CTA on the tier's
template <typename T, int NT, bool SH>
__device__ void exec_plain(const Ctx<T>& x, const Step& st, int& round,
                           cg::grid_group& grid) {
  const Level<T>& L = x.lv[st.lev];
  const int ny = L.ny, nx = L.nx;
  const int n = ny * nx;
  const int first = SH ? int(threadIdx.x) : int(blockIdx.x) * NT +
                                                int(threadIdx.x);
  const int stride = SH ? NT : int(gridDim.x) * NT;
  const T* Hu = fld<SH>(L, F_HU, x.data);
  const T* Hv = fld<SH>(L, F_HV, x.data);
  const T* mask = fld<SH>(L, F_MASK, x.data);
  const T* inv = fld<SH>(L, F_INV, x.data);
  const T rdx2 = L.rdx2, rdy2 = L.rdy2;
  T* a = fld<SH>(L, st.a, x.data);

  switch (st.op) {
    case OP_ZERO:
      for (int i = first; i < n; i += stride) a[i] = T(0);
      break;
    case OP_SWEEP: {
      const T* b = fld<SH>(L, st.b, x.data);
      const int colour = st.c & 1;        // 0: red, (row + column) even
      const bool zero = (st.c & 2) != 0;
      for (Walk p(first, stride, nx); p.i < n; p.next(stride)) {
        const int i = p.i, j = p.j, col = p.col;
        const T m = mask[i];
        if (((j + col) & 1) == colour && m > T(0)) {
          const int row = j * nx;
          const int w = row + wrap(col - 1, nx);
          const int s = wrap(j - 1, ny) * nx + col;
          T xe = T(0), xw = T(0), xn = T(0), xs = T(0);
          if (!zero) {
            xe = ld<SH>(&a[row + wrap(col + 1, nx)]);
            xw = ld<SH>(&a[w]);
            xn = ld<SH>(&a[wrap(j + 1, ny) * nx + col]);
            xs = ld<SH>(&a[s]);
          }
          const T nb = (Hu[i] * xe + Hu[w] * xw) * rdx2 +
                       (Hv[i] * xn + Hv[s] * xs) * rdy2;
          a[i] = ((ld<SH>(&b[i]) - nb) * inv[i]) * m;
        } else if (zero) {
          a[i] = T(0);
        } else if (!(m > T(0))) {
          a[i] = ld<SH>(&a[i]) * m;       // the other colour, re-masked
        }
      }
      break;
    }
    case OP_SWEEPS: {
      // the tier's runs of half-sweeps: the cells of one colour each (the
      // other colour's are products with the mask, which is 0 or 1, so
      // the eager re-mask leaves them as they are); from zero the other
      // colour and the colour's land are set to 0 first
      if constexpr (SH) {
        const T* b = fld<SH>(L, st.b, x.data);
        int colour = st.c & 1;
        const bool zero = (st.c & 2) != 0;
        const int count = st.c >> 2, hn = (nx + 1) / 2;
        if (zero)
          for (Walk p(first, stride, nx); p.i < n; p.next(stride))
            if (((p.j + p.col) & 1) != colour || !(mask[p.i] > T(0)))
              a[p.i] = T(0);
        if (2 * ny * hn <= NT) {
          // a small level: each thread keeps one cell of one colour, its
          // neighbours' offsets and its coefficients in registers
          const int k = threadIdx.x % (ny * hn), mine = threadIdx.x /
                                                        (ny * hn);
          const int j = k / hn, col = ((j + mine) & 1) + 2 * (k % hn);
          const int i = j * nx + col;
          const bool on = mine < 2 && col < nx && mask[i] > T(0);
          int e = 0, w = 0, nn = 0, s = 0;
          T hu = T(0), huw = T(0), hv = T(0), hvs = T(0), bi = T(0);
          T di = T(0), m = T(0);
          if (on) {
            e = j * nx + wrap(col + 1, nx);
            w = j * nx + wrap(col - 1, nx);
            nn = wrap(j + 1, ny) * nx + col;
            s = wrap(j - 1, ny) * nx + col;
            hu = Hu[i], huw = Hu[w], hv = Hv[i], hvs = Hv[s];
            bi = b[i], di = inv[i], m = mask[i];
          }
          for (int h = 0; h < count; ++h, colour ^= 1) {
            if (h > 0) __syncthreads();
            if (!on || mine != colour) continue;
            T xe = T(0), xw = T(0), xn = T(0), xs = T(0);
            if (!(zero && h == 0)) {
              xe = a[e];
              xw = a[w];
              xn = a[nn];
              xs = a[s];
            }
            const T nb = (hu * xe + huw * xw) * rdx2 + (hv * xn + hvs * xs) *
                                                           rdy2;
            a[i] = ((bi - nb) * di) * m;
          }
          break;
        }
        for (int h = 0; h < count; ++h, colour ^= 1) {
          if (h > 0) __syncthreads();
          for (Walk p(first, stride, hn); p.i < ny * hn; p.next(stride)) {
            const int j = p.j, col = ((j + colour) & 1) + 2 * p.col;
            if (col >= nx) continue;
            const int i = j * nx + col;
            const T m = mask[i];
            if (!(m > T(0))) continue;
            const int row = j * nx;
            const int w = row + wrap(col - 1, nx);
            const int s = wrap(j - 1, ny) * nx + col;
            T xe = T(0), xw = T(0), xn = T(0), xs = T(0);
            if (!(zero && h == 0)) {
              xe = a[row + wrap(col + 1, nx)];
              xw = a[w];
              xn = a[wrap(j + 1, ny) * nx + col];
              xs = a[s];
            }
            const T nb = (Hu[i] * xe + Hu[w] * xw) * rdx2 +
                         (Hv[i] * xn + Hv[s] * xs) * rdy2;
            a[i] = ((b[i] - nb) * inv[i]) * m;
          }
        }
      }
      break;
    }
    case OP_RESID: {
      const T* b = fld<SH>(L, st.b, x.data);
      T* r = fld<SH>(L, st.c, x.data);
      for (Walk p(first, stride, nx); p.i < n; p.next(stride)) {
        const int i = p.i, j = p.j, col = p.col;
        const int row = j * nx;
        const int w = row + wrap(col - 1, nx);
        const int s = wrap(j - 1, ny) * nx + col;
        const T q = ld<SH>(&a[i]);
        const T qe = ld<SH>(&a[row + wrap(col + 1, nx)]);
        const T qw = ld<SH>(&a[w]);
        const T qn = ld<SH>(&a[wrap(j + 1, ny) * nx + col]);
        const T qs = ld<SH>(&a[s]);
        const T hu = Hu[i], huw = Hu[w], hv = Hv[i], hvs = Hv[s];
        T out = (hu * qe + huw * qw - (hu + huw) * q) * rdx2 +
                (hv * qn + hvs * qs - (hv + hvs) * q) * rdy2;
        if (x.lam != T(0)) out = out - x.lam * q;
        const T m = mask[i];
        r[i] = (ld<SH>(&b[i]) - out * m) * m;
      }
      break;
    }
    case OP_RESTRICT: {
      // dst on level + 1: y first, then x, as _restrict2
      const Level<T>& C = x.lv[st.lev + 1];
      const int cx = C.nx;
      T* dst = fld<SH>(C, st.b, x.data);
      const T* cmask = fld<SH>(C, F_MASK, x.data);
      for (Walk p(first, stride, cx); p.i < C.ny * cx; p.next(stride)) {
        const int J = p.j, I = p.col;
        const int r0 = wrap(2 * J - 1, ny) * nx;
        const int r1 = 2 * J * nx;
        const int r2 = (2 * J + 1) * nx;
        const int r3 = wrap(2 * J + 2, ny) * nx;
        T ry[4];
        for (int q = 0; q < 4; ++q) {
          const int cc = wrap(2 * I - 1 + q, nx);
          ry[q] = T(0.5) * (T(0.75) * (ld<SH>(&a[r1 + cc]) +
                                       ld<SH>(&a[r2 + cc])) +
                            T(0.25) * ld<SH>(&a[r0 + cc]) +
                            T(0.25) * ld<SH>(&a[r3 + cc]));
        }
        const T v = T(0.5) * (T(0.75) * (ry[1] + ry[2]) + T(0.25) * ry[0] +
                              T(0.25) * ry[3]);
        dst[p.i] = v * cmask[p.i];
      }
      break;
    }
    case OP_DEMEAN: {
      T v[NDOT];
      for (int q = 0; q < NDOT; ++q) v[q] = T(0);
      for (int i = first; i < n; i += stride) v[0] += ld<SH>(&a[i]);
      if constexpr (SH)
        block_sum<T, NDOT, NT>(v, x.sh);
      else
        grid_sum<T, NT>(v, x.sh, x.partials, round, grid);
      const T mean = v[0] / L.nwet;
      for (int i = first; i < n; i += stride) {
        const T m = mask[i];
        a[i] = (ld<SH>(&a[i]) - m * mean) * m;
      }
      break;
    }
    case OP_ADD: {
      const T* src = fld<SH>(L, st.b, x.data);
      for (int i = first; i < n; i += stride)
        a[i] = ld<SH>(&a[i]) + ld<SH>(&src[i]);
      break;
    }
    case OP_PROLONG: {
      // src on level + 1: y first, then x, as _prolong2
      const Level<T>& C = x.lv[st.lev + 1];
      const int cy = C.ny, cx = C.nx;
      const T* src = fld<SH>(C, st.b, x.data);
      for (Walk p(first, stride, nx); p.i < n; p.next(stride)) {
        const int i = p.i, j = p.j, col = p.col;
        const int J = j >> 1, I = col >> 1;
        const int Jr = J * cx;
        const int Jn = wrap((j & 1) ? J + 1 : J - 1, cy) * cx;
        const int In = wrap((col & 1) ? I + 1 : I - 1, cx);
        const T t0 = T(0.75) * ld<SH>(&src[Jr + I]) +
                     T(0.25) * ld<SH>(&src[Jn + I]);
        const T t1 = T(0.75) * ld<SH>(&src[Jr + In]) +
                     T(0.25) * ld<SH>(&src[Jn + In]);
        const T f = T(0.75) * t0 + T(0.25) * t1;
        a[i] = (ld<SH>(&a[i]) + f) * mask[i];
      }
      break;
    }
    default:
      break;
  }
}

// OP_TIER_IN / OP_TIER_OUT on CTA 0: the statics of every tier level and
// the top level's right-hand side into shared memory, or its x out
template <typename T, int NT>
__device__ void exec_tier_io(const Ctx<T>& x, const Step& st, int nlev) {
  const Level<T>& L = x.lv[st.lev];
  const int n = L.ny * L.nx;
  T* g = fld<false>(L, st.a, x.data);
  T* s = fld<true>(L, st.a, x.data);
  if (st.op == OP_TIER_OUT) {
    for (int i = threadIdx.x; i < n; i += NT) g[i] = s[i];
    return;
  }
  for (int l = st.lev; l < nlev; ++l) {
    const Level<T>& M = x.lv[l];
    const int nl = M.ny * M.nx;
    const T *hu = M.f[F_HU], *hv = M.f[F_HV], *m = M.f[F_MASK],
            *inv = M.f[F_INV];
    T* d = x.data + M.off;   // the four statics' planes in a row
    for (int i = threadIdx.x; i < nl; i += NT) {
      const T a0 = hu[i], a1 = hv[i], a2 = m[i], a3 = inv[i];
      d[i] = a0;
      d[nl + i] = a1;
      d[2 * nl + i] = a2;
      d[3 * nl + i] = a3;
    }
  }
  for (int i = threadIdx.x; i < n; i += NT) s[i] = __ldcg(&g[i]);
}

// the tile t of a tiled pass with halo w, of those whose planes fit the
// shared memory: the least rounds of tiles per CTA times block points per
// thread (a round's phases are as long as its block's points per thread),
// the larger t on a tie
template <typename T, int NT>
__device__ __forceinline__ int tile_for(int ny, int nx, int w, int room) {
  int best = MIN_TILE, cost = 0;
  for (int t = MAX_TILE; t >= MIN_TILE; t >>= 1) {
    const int r = t + 2 * w;
    if (TILE_PLANES * r * r * int(sizeof(T)) > room) continue;
    const int tiles = ((ny + t - 1) / t) * ((nx + t - 1) / t);
    const int k = ((tiles + int(gridDim.x) - 1) / int(gridDim.x)) *
                  ((r * r + NT - 1) / NT);
    if (cost == 0 || k < cost) {
      best = t;
      cost = k;
    }
  }
  return best;
}

// one red-black half-sweep of the cells of one colour on the block's
// [1, r-1) (r even: (r - 2) / 2 of them per row).  The block's parity is
// the level's (its origin is even, the level's sides are).  The other
// colour is not re-masked: in a tile every x is already a product with
// the mask, and the mask is 0 or 1, so re-masking leaves it as it is.
template <typename T, int NT>
__device__ __forceinline__ void tile_halfsweep(T* x, const T* b, const T* hu,
                                               const T* hv, const T* m,
                                               const T* inv, int r,
                                               int colour, T rdx2, T rdy2) {
  const int h = (r - 2) / 2;
  for (Walk p(threadIdx.x, NT, h); p.i < (r - 2) * h; p.next(NT)) {
    const int jj = 1 + p.j;
    const int s = jj * r + 1 + ((jj + 1 + colour) & 1) + 2 * p.col;
    const T mm = m[s];
    if (mm > T(0)) {
      const T nb = (hu[s] * x[s + 1] + hu[s - 1] * x[s - 1]) * rdx2 +
                   (hv[s] * x[s + r] + hv[s - r] * x[s - r]) * rdy2;
      x[s] = ((b[s] - nb) * inv[s]) * mm;
    }
  }
}

// (b - A x) mask at block point s, in OP_RESID's order
template <typename T>
__device__ __forceinline__ T tile_resid(const T* x, const T* b, const T* hu,
                                        const T* hv, const T* m, int s,
                                        int r, T rdx2, T rdy2, T lam) {
  const T q = x[s];
  const T huc = hu[s], huw = hu[s - 1], hvc = hv[s], hvs = hv[s - r];
  T out = (huc * x[s + 1] + huw * x[s - 1] - (huc + huw) * q) * rdx2 +
          (hvc * x[s + r] + hvs * x[s - r] - (hvc + hvs) * q) * rdy2;
  if (lam != T(0)) out = out - lam * q;
  const T mm = m[s];
  return (b[s] - out * mm) * mm;
}

// OP_PRE and OP_POST: one visit's passes over a level above the tier,
// tile by tile, by the whole grid
template <typename T, int NT>
__device__ void exec_tiled(const Ctx<T>& x, const Step& st) {
  const bool pre = st.op == OP_PRE;
  const Level<T>& L = x.lv[st.lev];
  const Level<T>& C = x.lv[st.lev + 1];
  const int ny = L.ny, nx = L.nx, cy = C.ny, cx = C.nx;
  const T rdx2 = L.rdx2, rdy2 = L.rdy2;
  const T *Hu = L.f[F_HU], *Hv = L.f[F_HV], *mask = L.f[F_MASK],
          *invd = L.f[F_INV];
  T* xg = L.f[st.a];
  T* bg = L.f[st.b];
  const bool flag = (st.c & 1) != 0;
  // OP_PRE with flag: rhs = (BC - A XC) mask; OP_POST: the correction
  const T* xc = pre ? L.f[F_XC] : C.f[F_XC];
  const T* bc = L.f[F_BC];
  const T* xadd = C.f[F_X];
  const T* xr = L.f[F_R];          // OP_POST's x
  T* dst = C.f[F_BC];
  const T* cmask = C.f[F_MASK];

  const int w = pre ? 2 * x.nu + 2 : 2 * x.nu;
  const int t = tile_for<T, NT>(ny, nx, w, x.room);
  const int r = t + 2 * w, npt = r * r;
  T* xs = x.data;
  T* b = xs + npt;
  T* hu = b + npt;
  T* hv = hu + npt;
  T* m = hv + npt;
  T* inv = m + npt;
  const int ntx = (nx + t - 1) / t, nty = (ny + t - 1) / t;
  const bool near = r <= ny && r <= nx;   // one wrap at most
  const int tid = threadIdx.x;

  for (int tile = blockIdx.x; tile < ntx * nty; tile += gridDim.x) {
    const int by = tile / ntx, bx = tile - by * ntx;
    const int y0 = by * t - w, x0 = bx * t - w;
    for (Walk p(tid, NT, r); p.i < npt; p.next(NT)) {
      const int s = p.i;
      const int gj = near ? wrap(y0 + p.j, ny) : wrap_any(y0 + p.j, ny);
      const int gi = near ? wrap(x0 + p.col, nx) : wrap_any(x0 + p.col, nx);
      const int g = gj * nx + gi;
      hu[s] = Hu[g];
      hv[s] = Hv[g];
      const T mm = mask[g];
      m[s] = mm;
      inv[s] = invd[g];
      if (pre) {
        xs[s] = flag ? __ldcg(&xc[g]) : T(0);
        b[s] = __ldcg(&(flag ? bc : bg)[g]);
      } else {
        // (x + P correction) mask, as OP_PROLONG
        const int J = gj >> 1, I = gi >> 1;
        const int Jr = J * cx;
        const int Jn = wrap((gj & 1) ? J + 1 : J - 1, cy) * cx;
        const int In = wrap((gi & 1) ? I + 1 : I - 1, cx);
        T v00 = __ldcg(&xc[Jr + I]), v10 = __ldcg(&xc[Jn + I]);
        T v01 = __ldcg(&xc[Jr + In]), v11 = __ldcg(&xc[Jn + In]);
        if (flag) {
          v00 = v00 + __ldcg(&xadd[Jr + I]);
          v10 = v10 + __ldcg(&xadd[Jn + I]);
          v01 = v01 + __ldcg(&xadd[Jr + In]);
          v11 = v11 + __ldcg(&xadd[Jn + In]);
        }
        const T t0 = T(0.75) * v00 + T(0.25) * v10;
        const T t1 = T(0.75) * v01 + T(0.25) * v11;
        const T f = T(0.75) * t0 + T(0.25) * t1;
        xs[s] = (__ldcg(&xr[g]) + f) * mm;
        b[s] = __ldcg(&bg[g]);
      }
    }
    __syncthreads();
    if (pre && flag) {
      // the gamma loop's residual on [1, r-1), in place of BC (each point
      // reads its own), stored for OP_POST; then x starts from zero
      const int ri = r - 2;
      for (Walk p(tid, NT, ri); p.i < ri * ri; p.next(NT)) {
        const int s = (1 + p.j) * r + 1 + p.col;
        b[s] = tile_resid(xs, b, hu, hv, m, s, r, rdx2, rdy2, x.lam);
      }
      __syncthreads();
      for (int s = tid; s < npt; s += NT) xs[s] = T(0);
      for (Walk p(tid, NT, t); p.i < t * t; p.next(NT)) {
        const int gj = by * t + p.j, gi = bx * t + p.col;
        if (gj < ny && gi < nx)
          bg[gj * nx + gi] = b[(w + p.j) * r + w + p.col];
      }
      __syncthreads();
    }
    for (int half = 0; half < 2 * x.nu; ++half) {
      // pre: red, black, ...; post: black, red, ...
      tile_halfsweep<T, NT>(xs, b, hu, hv, m, inv, r,
                            (half & 1) ^ int(!pre), rdx2, rdy2);
      __syncthreads();
    }
    for (Walk p(tid, NT, t); p.i < t * t; p.next(NT)) {
      const int gj = by * t + p.j, gi = bx * t + p.col;
      if (gj < ny && gi < nx)
        xg[gj * nx + gi] = xs[(w + p.j) * r + w + p.col];
    }
    if (pre) {
      // the residual where the restriction reads it, [w-1, w+t+1), in
      // place of b; then the restriction of the tile's coarse points
      const int rr = t + 2;
      for (Walk p(tid, NT, rr); p.i < rr * rr; p.next(NT)) {
        const int s = (w - 1 + p.j) * r + w - 1 + p.col;
        b[s] = tile_resid(xs, b, hu, hv, m, s, r, rdx2, rdy2, x.lam);
      }
      __syncthreads();
      const int tc = t / 2;
      for (Walk p(tid, NT, tc); p.i < tc * tc; p.next(NT)) {
        const int J = by * tc + p.j, I = bx * tc + p.col;
        if (J >= cy || I >= cx) continue;
        const int s = (w + 2 * p.j) * r + w + 2 * p.col;   // fine (2J, 2I)
        T ry[4];
        for (int q = 0; q < 4; ++q) {
          const int cc = s - 1 + q;
          ry[q] = T(0.5) * (T(0.75) * (b[cc] + b[cc + r]) +
                            T(0.25) * b[cc - r] + T(0.25) * b[cc + 2 * r]);
        }
        const T v = T(0.5) * (T(0.75) * (ry[1] + ry[2]) + T(0.25) * ry[0] +
                              T(0.25) * ry[3]);
        dst[J * cx + I] = v * cmask[J * cx + I];
      }
    }
    __syncthreads();
  }
}

// the whole cycle; every CTA of the grid calls it.  smem: the reductions'
// NDOT x NT scratch, the level table, then c.room bytes for the tier or
// a tile.  Each step's word is fetched while the step before runs.
template <typename T, int NT>
__device__ void run_cycle(const Cycle<T>& c, unsigned char* smem,
                          T* partials, int& round, cg::grid_group& grid) {
  T* sh = reinterpret_cast<T*>(smem);
  Level<T>* lv = reinterpret_cast<Level<T>*>(smem + NDOT * NT * sizeof(T));
  T* data = reinterpret_cast<T*>(smem + NDOT * NT * sizeof(T) +
                                 MAX_LEVELS * LEVEL_BYTES);
  load_levels<T, NT>(c, lv);
  const Ctx<T> x{lv, sh, data, partials, c.nu, c.room, c.lam};
  int next = c.nsteps > 0 ? c.steps[0] : 0;
  for (int s = 0; s < c.nsteps; ++s) {
    const Step st(next);
    if (s + 1 < c.nsteps) next = c.steps[s + 1];
    if (st.tier) {
      if (blockIdx.x == 0) {
        if (st.op == OP_TIER_IN || st.op == OP_TIER_OUT)
          exec_tier_io<T, NT>(x, st, c.nlev);
        else
          exec_plain<T, NT, true>(x, st, round, grid);
      }
    } else if (st.op == OP_PRE || st.op == OP_POST) {
      exec_tiled<T, NT>(x, st);
    } else {
      exec_plain<T, NT, false>(x, st, round, grid);
    }
    if (st.tier && s + 1 < c.nsteps && Step(next).tier) {
      if (blockIdx.x == 0) __syncthreads();
    } else {
      grid.sync();
    }
  }
}

// the shared memory a cycle kernel needs beside c.room
template <typename T>
constexpr int fixed_smem() {
  return NDOT * CYCLE_THREADS * int(sizeof(T)) + MAX_LEVELS * LEVEL_BYTES;
}
static_assert(sizeof(Level<double>) <= LEVEL_BYTES, "level table row");

// the launch of a cycle kernel: CYCLE_THREADS threads and all the card's
// opt-in shared memory per CTA (*smem bytes of it dynamic), as many CTAs
// as are resident with that (one per SM)
inline cudaError_t cycle_launch(const void* kernel, int* blocks, int* smem) {
  int dev = 0, coop = 0, sms = 0, optin = 0, per_sm = 0;
  *blocks = *smem = 0;
  cudaFuncAttributes fa;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
  if (e == cudaSuccess) {
    *smem = optin - int(fa.sharedSizeBytes);
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             *smem);
  }
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      CYCLE_THREADS, *smem);
  if (e == cudaSuccess) {
    *blocks = per_sm * sms;
    if (*blocks < 1) e = cudaErrorLaunchOutOfResources;
  }
  return e;
}

// a cycle's room for its tier or a tile in `smem` bytes, checked against
// its levels, its tier and the smallest tile of its tiled passes
template <typename T>
inline cudaError_t cycle_room(int smem, int nlev, int nu, int tier_bytes,
                              int* room) {
  *room = smem - fixed_smem<T>();
  const int r = MIN_TILE + 2 * (2 * nu + 2);
  if (nu < 0 || nlev < 1 || nlev > MAX_LEVELS || tier_bytes > *room ||
      TILE_PLANES * r * r * int(sizeof(T)) > *room)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace mgc
