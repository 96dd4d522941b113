// K6 with the Jacobi preconditioner: the whole preconditioned conjugate-
// gradient solve of solvers/elliptic.py::cg_solve in one persistent
// cooperative launch, one pass over the grid and one grid sync per
// iteration.
//
// Replaces beom_tpu/stencils/cg_vmem.py::_cg_kernel, precond='jacobi'
// (the multigrid preconditioner stays in csrc/cg_fused.cu).  The
// reference runs that kernel only where the solver state fits the TPU's
// VMEM (about 1024^2 f32) and the XLA loop elsewhere; this kernel keeps its
// state in device memory and runs at every size.
//
// Bound: device-memory bytes.  An iteration of the Chronopoulos-Gear
// recurrence is pointwise updates, one five-point matvec and six dot
// products; its scalars need one reduction over the whole grid.  The
// design fuses the updates of iteration k + 1 into the matvec of
// iteration k, so an iteration is one pass and one grid sync:
//
//   Each CTA takes tiles of the grid (the host's plan,
//   stencils/cg_fused.py::tile_plan: nty x ntx tiles of balanced sizes,
//   each staged with its one-cell halo in SMEM_TILE bytes) and stages a
//   tile's rows in shared memory by 16-byte asynchronous copies through
//   L2 (cp.async.cg), two buffers per CTA, so its next tile loads while
//   it computes one.  For the tile and its halo, from the old r, w, s and
//   pm = inv_diag * mask:
//     u = pm r, the deflated (r, u), s' = w + beta s, r' = r - alpha s',
//     u' = pm r'
//   (pointwise, so the halo is recomputed, not exchanged); u' replaces r
//   in the staged tile, and at its own points the CTA writes p' = u +
//   beta p, s', r'; then w' = A u' from the staged tile, and the per-CTA
//   partials of (r', u'), (w', u'), (r', r'), (r', mask), (u', mask),
//   (w', mask).  Every CTA sums the partials in one fixed order
//   (grid_sum: its one grid sync), so every CTA holds the same alpha,
//   beta, means and stopping test, and two launches are bitwise equal.
//
// u is never stored.  Neighbours read r, w and s in the halo while their
// owners write the new ones, so r, w, s and p alternate between two banks
// per iteration.  x takes its steps two at a time, on odd passes:
// x_k = (x_{k-2} + alpha_{k-1} p_{k-1}) + alpha_k p_k, rounded as two
// passes would, with p_{k-1} the bank the pass reads anyway.  A pass
// moves 11 grid fields, 13 on odd passes (12 on average): it reads r, w,
// s, p, pm, Hu, Hv (all but p also in the halo) and writes r, w, s, p,
// and odd passes read and write x.  The mask is not read: with a 0/1
// mask (checked by the host) it is pm != 0, and multiplying by it is
// exact.  The staged fields start on 16 bytes and may be read up to 16
// bytes past their end (the host pads them).
//
// Before the first pass, the set-up: the wet count and means of b and x0
// (lam = 0), x = deflate0(x0) and r = (b - A x) mask (x at the neighbours
// recomputed from x0), w = s = p = 0, |b|^2: two grid sums.  The first
// pass runs with alpha = beta = 0 and zero means, which leaves x, p, s
// and r as they are and forms u, w and the first dots.  After the last
// pass, x = (x + its step if that pass was even) mask.
//
// Scalar algebra, deflation, safe_div and the stopping test are those of
// cg_solve; the matvec is laplacian_H's, op for op.  Sums run in another
// order than torch.sum's, so x agrees with the plain version to the
// solver tolerance, not bit for bit.

#include "coop_stamps.cuh"
#include "mg_cycle.cuh"

namespace {

namespace cg = mgc::cg;
using mgc::NDOT;
using mgc::vmax;
using mgc::Walk;
using mgc::wrap;

// one CTA of 512 threads per SM, with two staging buffers of 100 KB: on
// the H100 at 2048^2 f32 fewer, larger CTAs and tiles ran faster than
// two to four smaller ones per SM (less halo, more registers, no spills)
constexpr int NT = 512;          // threads per CTA
constexpr int NWARP = NT / 32;
constexpr int MAX_CTAS_PER_SM = 1;
// the staged planes: r, w, s, pm, Hu, Hv (the tile and its halo), p, x
constexpr int NPLANE = 8;
// a tile's staging bytes and ext rows at most, per buffer
constexpr int SMEM_TILE = 100 * 1024;
constexpr int MAX_EXT_ROWS = 128;
template <typename T>
constexpr int BUF_ELEMS = SMEM_TILE / int(sizeof(T));

template <typename T>
struct Params {
  const T *b, *x0, *Hu, *Hv, *pm;
  T *x, *partials;
  T *r[2], *w[2], *s[2], *p[2];  // the banks
  int* iters;
  T* resnorm;
  int ny, nx, maxiter, deflate, nty, ntx;
  T inv_dx, inv_dy, lam, tol2, tiny;
  unsigned long long* stamps;    // the timing mode (coop_stamps.cuh), or null
};

template <typename T>
__device__ __forceinline__ T safe_div(T num, T den, T tiny) {
  const T mag = vmax(den < T(0) ? -den : den, tiny);
  return num / (den < T(0) ? -mag : mag);
}

template <typename T>
__device__ __forceinline__ T mask_of(T pm) {
  return pm != T(0) ? T(1) : T(0);
}

// laplacian_H at one point from the centre, its four neighbours and the
// four face depths around it: d_xm(Hu d_xp q) + d_ym(Hv d_yp q) [- lam q]
template <typename T>
__device__ __forceinline__ T lap(const Params<T>& p, T qc, T qe, T qw, T qn,
                                 T qs, T hu, T huw, T hv, T hvs) {
  const T gx = hu * ((qe - qc) * p.inv_dx);
  const T gxw = huw * ((qc - qw) * p.inv_dx);
  const T gy = hv * ((qn - qc) * p.inv_dy);
  const T gys = hvs * ((qc - qs) * p.inv_dy);
  T out = (gx - gxw) * p.inv_dx + (gy - gys) * p.inv_dy;
  if (p.lam != T(0)) out = out - p.lam * qc;
  return out;
}

// the CTA's sums of v[0..NDOT) in a fixed order (each warp's shuffle
// tree, then the warps in order); every thread gets them.  Unlike
// mgc::block_sum, which stages every thread's sums (NDOT * NT elements),
// it needs NDOT * NWARP elements of shared memory beside the two staging
// buffers
template <typename T>
__device__ void block_sum(T (&v)[NDOT], T* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < NDOT; ++j) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[j] += __shfl_down_sync(~0u, v[j], o);
    if (lane == 0) sh[j * NWARP + warp] = v[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NDOT; ++j) {
    T t = T(0);
    for (int k = 0; k < NWARP; ++k) t += sh[j * NWARP + k];
    v[j] = t;
  }
  __syncthreads();
}

// v holds this thread's partial sums: reduce them over the whole grid
// with one grid sync.  Every CTA computes the same totals in the same
// order.  Consecutive calls alternate between two halves of `partials`: a
// CTA may still be reading one call's partials when another writes the
// next call's, and the grid sync inside the next call orders the one
// after it.
template <typename T>
__device__ void grid_sum(T (&v)[NDOT], T* sh, T* partials, int& round,
                         cg::grid_group& grid) {
  T* part = partials + (round++ & 1) * int(gridDim.x) * NDOT;
  block_sum(v, sh);
  if (threadIdx.x == 0)
    for (int j = 0; j < NDOT; ++j) part[blockIdx.x * NDOT + j] = v[j];
  grid.sync();
  for (int j = 0; j < NDOT; ++j) v[j] = T(0);
  for (int i = threadIdx.x; i < int(gridDim.x); i += NT)
    for (int j = 0; j < NDOT; ++j) v[j] += __ldcg(&part[i * NDOT + j]);
  block_sum(v, sh);
}

// tile t of the plan: owned rows [y0, y0 + h), columns [x0, x0 + w)
struct Tile {
  int y0, h, x0, w;
  __device__ Tile(int t, int nty, int ntx, int ny, int nx) {
    const int ty = t / ntx, tx = t - ty * ntx;
    y0 = int(static_cast<long long>(ty) * ny / nty);
    h = int(static_cast<long long>(ty + 1) * ny / nty) - y0;
    x0 = int(static_cast<long long>(tx) * nx / ntx);
    w = int(static_cast<long long>(tx + 1) * nx / ntx) - x0;
  }
};

// a tile's row in the staging planes: the 16-byte chunks that hold its
// columns [lo, hi) (the tile and its halo columns, unless a halo column
// wraps across the periodic seam), then two chunks for the wrapped halo
// columns.  Row stride, in elements, for tiles up to w columns wide:
template <typename T>
__host__ __device__ constexpr int row_stride(int w) {
  constexpr int vec = 16 / int(sizeof(T));
  return vec * ((w + 2 * vec) / vec + 2);
}

template <typename T>
__device__ __forceinline__ void copy16(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // .cg: through L2 only, as the banks were written by other CTAs
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// the staged tile: NPLANE planes of he rows of `sr` elements, and per row
// the offset of column lo in its first chunk and of the wrapped halo
// columns in theirs
template <typename T>
struct Stage {
  T* plane;     // NPLANE consecutive planes
  int sr, ps;   // row stride, plane stride
  int* off;     // he entries each: main, left wrap, right wrap
  int wl, wr;   // the left / right halo column wraps
  // the staging address of ext point (i, c), c in [0, w + 2)
  __device__ __forceinline__ int at(int i, int c, int w) const {
    if (c == 0 && wl) return i * sr + sr - 2 * (16 / int(sizeof(T))) +
                             off[3 * i + 1];
    if (c == w + 1 && wr) return i * sr + sr - 16 / int(sizeof(T)) +
                                 off[3 * i + 2];
    return i * sr + off[3 * i] + c - wl;
  }
};

// the staging of tile `tl` in buffer (smem, off)
template <typename T>
__device__ __forceinline__ Stage<T> stage_of(const Params<T>& p,
                                             const Tile& tl, T* smem,
                                             int* off) {
  Stage<T> st;
  st.plane = smem;
  st.sr = row_stride<T>(tl.w);
  st.ps = (tl.h + 2) * st.sr;
  st.off = off;
  st.wl = tl.x0 == 0;
  st.wr = tl.x0 + tl.w == p.nx;
  return st;
}

// start staging tile `tl` into buffer (smem, off): the ext rows of r, w,
// s (bank `in`), pm, Hu, Hv, and the owned rows of p (bank `in`) and, on
// odd passes (in = 1), of x, each row as 16-byte asynchronous copies in
// one commit group; the offsets are stored at once
template <typename T>
__device__ void stage_issue(const Params<T>& p, const Tile& tl, int in,
                            T* smem, int* off) {
  constexpr int vec = 16 / int(sizeof(T));
  const Stage<T> st = stage_of(p, tl, smem, off);
  const T* src[NPLANE] = {in ? p.r[1] : p.r[0], in ? p.w[1] : p.w[0],
                          in ? p.s[1] : p.s[0], p.pm, p.Hu, p.Hv,
                          in ? p.p[1] : p.p[0], p.x};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lo = st.wl ? 0 : tl.x0 - 1;
  const int hi = st.wr ? p.nx : tl.x0 + tl.w + 1;
  for (int i = warp; i < tl.h + 2; i += NWARP) {
    const int row = wrap(tl.y0 - 1 + i, p.ny) * p.nx;
    const int fs = (row + lo) & ~(vec - 1);
    const int nch = (row + hi - fs + vec - 1) / vec;
    const int np = i >= 1 && i <= tl.h ? NPLANE - 1 + in : NPLANE - 2;
    for (int c = lane; c < nch; c += 32)
#pragma unroll
      for (int k = 0; k < NPLANE; ++k)
        if (k < np)
          copy16(st.plane + k * st.ps + i * st.sr + c * vec,
                 src[k] + fs + c * vec);
    const int fl = row + p.nx - 1, fr = row;   // the wrapped columns
    if (lane == 0 && st.wl)
#pragma unroll
      for (int k = 0; k < NPLANE - 2; ++k)
        copy16(st.plane + k * st.ps + i * st.sr + st.sr - 2 * vec,
               src[k] + (fl & ~(vec - 1)));
    if (lane == 1 && st.wr)
#pragma unroll
      for (int k = 0; k < NPLANE - 2; ++k)
        copy16(st.plane + k * st.ps + i * st.sr + st.sr - vec,
               src[k] + (fr & ~(vec - 1)));
    if (lane == 2) {
      off[3 * i] = (row + lo) & (vec - 1);
      off[3 * i + 1] = fl & (vec - 1);
      off[3 * i + 2] = fr & (vec - 1);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// one pass over tile `tl`, staged in buffer (smem, off): the recurrence
// with (alpha, beta, rmean, umean) from bank `in` into bank 1 - in, u'
// and w' = A u', and this thread's share of the six dots in v.  x takes
// the updates of two passes on odd ones: alpha_prev is the step of the
// pass before
template <typename T>
__device__ void tile_pass(const Params<T>& p, const Tile& tl, int in,
                          T alpha, T alpha_prev, T beta, T rmean, T umean,
                          T* smem, int* off, T (&v)[NDOT]) {
  const Stage<T> st = stage_of(p, tl, smem, off);
  T* R = st.plane;             // r, then u' in place
  const T* W = R + st.ps;
  const T* S = W + st.ps;
  const T* PM = S + st.ps;
  const T* HU = PM + st.ps;
  const T* HV = HU + st.ps;
  const T* P = HV + st.ps;
  const T* X = P + st.ps;
  // selected, not indexed: a kernel parameter indexed at run time would
  // be copied to local memory
  T* r_out = in ? p.r[0] : p.r[1];
  T* w_out = in ? p.w[0] : p.w[1];
  T* s_out = in ? p.s[0] : p.s[1];
  T* p_out = in ? p.p[0] : p.p[1];
  const int we = tl.w + 2, ne = we * (tl.h + 2);
  for (Walk wk(threadIdx.x, NT, we); wk.i < ne; wk.next(NT)) {
    const int a = st.at(wk.j, wk.col, tl.w);
    const T r0 = R[a], pmv = PM[a];
    const T m = mask_of(pmv);
    const T u0 = pmv * r0;
    const T ri = p.deflate ? (r0 - rmean * m) * m : r0 * m;
    const T ui = p.deflate ? (u0 - umean * m) * m : u0 * m;
    const T si = W[a] + beta * S[a];
    const T rn = ri - alpha * si;
    const T un = pmv * rn;
    R[a] = un;
    if (wk.j >= 1 && wk.j <= tl.h && wk.col >= 1 && wk.col <= tl.w) {
      const int idx = (tl.y0 + wk.j - 1) * p.nx + tl.x0 + wk.col - 1;
      const T pi = ui + beta * P[a];
      p_out[idx] = pi;
      // x_k = (x_{k-2} + alpha_{k-1} p_{k-1}) + alpha_k p_k, rounded as
      // two passes would
      if (in) p.x[idx] = (X[a] + alpha_prev * P[a]) + alpha * pi;
      s_out[idx] = si;
      r_out[idx] = rn;
      v[0] += rn * un;
      v[2] += rn * rn;
      v[3] += rn * m;
      v[4] += un * m;
    }
  }
  __syncthreads();
  // w' = A u' at the owned points, from the staged tile
  for (Walk wo(threadIdx.x, NT, tl.w); wo.i < tl.h * tl.w; wo.next(NT)) {
    const int i = wo.j + 1, c = wo.col + 1;
    const int ac = st.at(i, c, tl.w);
    const int ae = c == tl.w ? st.at(i, c + 1, tl.w) : ac + 1;
    const int aw = c == 1 ? st.at(i, 0, tl.w) : ac - 1;
    const int an = st.at(i + 1, c, tl.w), as = st.at(i - 1, c, tl.w);
    const T qc = R[ac];
    const T m = mask_of(PM[ac]);
    const T wn = lap(p, qc, R[ae], R[aw], R[an], R[as], HU[ac], HU[aw],
                     HV[ac], HV[as]) *
                 m;
    w_out[(tl.y0 + wo.j) * p.nx + tl.x0 + wo.col] = wn;
    v[1] += wn * qc;
    v[5] += wn * m;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(NT, MAX_CTAS_PER_SM)
    cg_jacobi_kernel(const Params<T> p) {
  stamp::entry(p.stamps);
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  __shared__ int off[2 * 3 * MAX_EXT_ROWS];
  __shared__ T sh[NDOT * NWARP];
  const int n = p.ny * p.nx;
  const int stride = int(gridDim.x) * NT;
  const int first = int(blockIdx.x) * NT + int(threadIdx.x);
  T v[NDOT];
  int round = 0;

  // nwet and the wet means of b * mask and x0 (deflate0)
  T nwet = T(1), bmean = T(0), xmean = T(0);
  if (p.deflate) {
    for (int j = 0; j < NDOT; ++j) v[j] = T(0);
    for (int i = first; i < n; i += stride) {
      const T m = mask_of(p.pm[i]);
      v[0] += m * m;
      v[1] += (p.b[i] * m) * m;
      v[2] += p.x0[i] * m;
    }
    grid_sum(v, sh, p.partials, round, grid);
    nwet = vmax(v[0], T(1));
    bmean = v[1] / nwet;
    xmean = v[2] / nwet;
  }

  // x = deflate0(x0), r = (deflate0(b mask) - A x) mask, p = w = s = 0 in
  // bank 0, |b|^2; x at the neighbours is recomputed from x0
  auto x_at = [&](int i) {
    const T m = mask_of(p.pm[i]);
    return p.deflate ? (p.x0[i] - m * xmean) * m : p.x0[i] * m;
  };
  for (int j = 0; j < NDOT; ++j) v[j] = T(0);
  for (Walk wk(first, stride, p.nx); wk.i < n; wk.next(stride)) {
    const int i = wk.i, j = wk.j, c = wk.col, row = j * p.nx;
    const int e = row + (c + 1 == p.nx ? 0 : c + 1);
    const int w = row + (c == 0 ? p.nx - 1 : c - 1);
    const int nn = (j + 1 == p.ny ? 0 : j + 1) * p.nx + c;
    const int s = (j == 0 ? p.ny - 1 : j - 1) * p.nx + c;
    const T m = mask_of(p.pm[i]);
    const T bm = p.b[i] * m;
    const T bd = p.deflate ? (bm - m * bmean) * m : bm * m;
    const T xi = x_at(i);
    const T ax = lap(p, xi, x_at(e), x_at(w), x_at(nn), x_at(s), p.Hu[i],
                     p.Hu[w], p.Hv[i], p.Hv[s]) *
                 m;
    p.x[i] = xi;
    p.r[0][i] = (bd - ax) * m;
    p.p[0][i] = T(0);
    p.w[0][i] = T(0);
    p.s[0][i] = T(0);
    v[0] += bd * bd;
  }
  // its grid sync also orders the set-up's stores before the first pass
  grid_sum(v, sh, p.partials, round, grid);
  const T threshold = p.tol2 * vmax(v[0], p.tiny);
  stamp::setup(p.stamps);

  const int ntiles = p.nty * p.ntx;
  T alpha = T(0), alpha_prev = T(0), beta = T(0), gamma = T(0), rr = T(0);
  T rmean = T(0), umean = T(0);
  int k = 0, pass = 0;
  for (;; ++pass) {
    for (int j = 0; j < NDOT; ++j) v[j] = T(0);
    // two staging buffers: a CTA's next tile loads while its tile runs.
    // Odd passes walk the tiles backwards, so a pass starts on the tiles
    // the pass before wrote last, while L2 still holds some of them
    const int in = pass & 1;
    auto tile = [&](int t) {
      return Tile(in ? ntiles - 1 - t : t, p.nty, p.ntx, p.ny, p.nx);
    };
    int buf = 0;
    if (int(blockIdx.x) < ntiles)
      stage_issue(p, tile(blockIdx.x), in, smem, off);
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const int next = t + int(gridDim.x);
      if (next < ntiles) {
        stage_issue(p, tile(next), in, smem + (1 - buf) * BUF_ELEMS<T>,
                    off + (1 - buf) * 3 * MAX_EXT_ROWS);
        asm volatile("cp.async.wait_group 1;\n" ::);
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::);
      }
      __syncthreads();
      tile_pass(p, tile(t), in, alpha, alpha_prev, beta, rmean, umean,
                smem + buf * BUF_ELEMS<T>, off + buf * 3 * MAX_EXT_ROWS, v);
      buf = 1 - buf;
    }
    grid_sum(v, sh, p.partials, round, grid);
    alpha_prev = alpha;
    T gamma_n = v[0], delta = v[1], rr_n = v[2];
    if (p.deflate) {
      gamma_n = v[0] - v[3] * v[4] / nwet;
      delta = v[1] - v[5] * v[4] / nwet;
      rr_n = v[2] - v[3] * v[3] / nwet;
      rmean = v[3] / nwet;
      umean = v[4] / nwet;
    }
    if (pass == 0) {
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

  // x lacks the last pass's step if that pass was even; the last pass
  // wrote x and p from other CTAs: read them from L2
  const T* p_last = pass & 1 ? p.p[0] : p.p[1];
  for (int i = first; i < n; i += stride) {
    T xi = __ldcg(&p.x[i]);
    if (!(pass & 1)) xi = xi + alpha_prev * __ldcg(&p_last[i]);
    p.x[i] = xi * mask_of(p.pm[i]);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *p.iters = k;
    *p.resnorm = rr;
  }
  stamp::leave(p.stamps);
}

// the CTAs a cooperative launch uses on the current device: the resident
// ones, at most MAX_CTAS_PER_SM per SM
template <typename T>
cudaError_t coop_ctas(int* blocks) {
  const void* kernel = reinterpret_cast<const void*>(cg_jacobi_kernel<T>);
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  *blocks = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             2 * SMEM_TILE);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                      2 * SMEM_TILE);
  if (e == cudaSuccess) {
    *blocks = (per_sm < MAX_CTAS_PER_SM ? per_sm : MAX_CTAS_PER_SM) * sms;
    if (*blocks < 1) e = cudaErrorLaunchOutOfResources;
  }
  return e;
}

template <typename T>
int cg_jacobi(const T* b, const T* x0, const T* Hu, const T* Hv, const T* pm,
              T* x, T* p0, T* p1, T* r0, T* r1, T* w0, T* w1, T* s0, T* s1,
              T* partials, int* iters, T* resnorm, int ny, int nx,
              int maxiter, int deflate, int nty, int ntx, int blocks,
              double inv_dx, double inv_dy, double lam, double tol2,
              double tiny, unsigned long long* stamps, void* stream) {
  const void* kernel = reinterpret_cast<const void*>(cg_jacobi_kernel<T>);
  // the plan must fit the shared memory, the grid must be resident
  // (coop_ctas at the caller's build time), and the staged fields must
  // start on 16 bytes (each is also read up to 16 bytes past its end)
  const int hmax = (ny + nty - 1) / nty, wmax = (nx + ntx - 1) / ntx;
  const void* staged[] = {r0, r1, w0, w1, s0, s1, p0, p1, pm, Hu, Hv, x};
  bool aligned = true;
  for (const void* a : staged)
    aligned = aligned && (reinterpret_cast<unsigned long long>(a) & 15) == 0;
  if (blocks < 1 || nty < 1 || ntx < 1 || nty > ny || ntx > nx ||
      hmax + 2 > MAX_EXT_ROWS ||
      NPLANE * (hmax + 2) * row_stride<T>(wmax) * int(sizeof(T)) >
          SMEM_TILE ||
      !aligned || static_cast<long long>(ny) * nx >= (1LL << 31))
    return int(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 2 * SMEM_TILE);
  if (e != cudaSuccess) return int(e);
  Params<T> p{b,        x0,       Hu,       Hv,        pm,
              x,        partials, {r0, r1}, {w0, w1},  {s0, s1},
              {p0, p1}, iters,    resnorm,  ny,        nx,
              maxiter,  deflate,  nty,      ntx,       T(inv_dx),
              T(inv_dy), T(lam),  T(tol2),  T(tiny),   stamps};
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(NT), args,
                                  size_t(2 * SMEM_TILE),
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return int(e);
  return int(cudaGetLastError());
}

}  // namespace

#define CG_JACOBI_ENTRY(NAME, CTAS, T)                                        \
  extern "C" int NAME(const T* b, const T* x0, const T* Hu, const T* Hv,      \
                      const T* pm, T* x, T* p0, T* p1, T* r0, T* r1, T* w0,   \
                      T* w1, T* s0, T* s1, T* partials, int* iters,           \
                      T* resnorm,                                             \
                      int ny, int nx, int maxiter, int deflate, int nty,      \
                      int ntx, int blocks, double inv_dx, double inv_dy,      \
                      double lam, double tol2, double tiny,                   \
                      unsigned long long* stamps, void* stream) {             \
    return cg_jacobi<T>(b, x0, Hu, Hv, pm, x, p0, p1, r0, r1, w0, w1, s0, s1, \
                        partials, iters, resnorm, ny, nx, maxiter, deflate,   \
                        nty, ntx, blocks, inv_dx, inv_dy, lam, tol2, tiny,    \
                        stamps, stream);                                      \
  }                                                                           \
  extern "C" int CTAS(int* blocks) { return int(coop_ctas<T>(blocks)); }

CG_JACOBI_ENTRY(beom_cg_jacobi_f32, beom_cg_jacobi_ctas_f32, float)
CG_JACOBI_ENTRY(beom_cg_jacobi_f64, beom_cg_jacobi_ctas_f64, double)

extern "C" const char* beom_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
