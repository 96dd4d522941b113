// K4a: the blocked red-black SOR pass (solvers/elliptic.py::rb_sweeps, k
// sweeps, in one launch), in three modes: the sweeps alone; the sweeps
// and the residual b - A x of the result in multigrid.operator's order
// (the multigrid pre-smoother); and the blocked solve's pass, the sweeps,
// r = (b - A x) mask in elliptic.laplacian_H's order and sum r^2 reduced
// on the device, behind the solve's own convergence test.  K4b: one pass
// of the operator, A x or b - A x.
//
// K4a replaces beom_tpu/stencils/redblack_pallas.py::_rb_kernel as built
// by make_level_sweep (residual=True: the multigrid pre-smoother) and, in
// its solve mode, the residual test of make_pallas_rb_solve's loop; K4b
// the kernel built by make_apply_kernel (the standalone multigrid
// solver's outer residual).
//
// Bound: device-memory bytes.  A sweep is ~12 flops per point against
// the 5 fields it reads (x, b, Hu, Hv, mask) and the 1 it writes; one
// launch does k sweeps for one read and one write of each, and the
// residual costs one more write (the solve's sum one more word per CTA).
//
// Shape: a row-streaming wavefront.  A CTA owns a strip of t columns over
// a chunk of ch rows, and loads the strip with a halo of W = 2k (+1 with a
// residual) columns and rows on each side, wrapped periodically.  It
// walks down the rows, one step per row: half-sweep h is stage h of a
// pipeline and computes row tau - 2h at step tau, from the rows tau - 2h
// - 1 .. tau - 2h + 1 that stage h - 1 wrote at the steps before; the
// residual is stage 2k.  Every stage writes its own ring of 4 rows, so
// each half-sweep is computed from the x of the one before, as the plain
// version does, at any parity of ny and nx (at an odd size the periodic
// seam joins two cells of one colour, and an update in place would read a
// neighbour it had already moved).  A stage's valid columns and rows
// shrink by one per stage, so after 2k stages the t x ch interior is
// exact.  The static fields (b, Hu, Hv, mask and 1/diag) live in a ring
// of 4k + 4 + AHEAD rows, the input x in a ring of XRING rows; rows come
// in AHEAD + 1 steps ahead of use by asynchronous copies (cp.async), so
// loads overlap the sweeps, and one barrier per step orders the stages.
// A thread takes (stage, column pair) items: each pair holds one cell of
// each colour (both or neither across an odd seam), so a warp takes one
// branch; the cell's colour is the parity of its global row and column,
// read from per-CTA tables: no division or modulo per point.  A row in
// shared memory holds its even columns, then its odd ones, so a warp's
// cells of one colour and their neighbours are consecutive words (no bank
// conflict).  A pass of a few sweeps (k <= 2: the multigrid smoothers, the
// solve's first test) has few stages per step, so it runs CTAs of 128
// threads, four to an SM; the 8-sweep pass one CTA of 512 threads per SM
// on a strip of 128 columns (its static ring takes ~170 KB at f32).
//
// The solve mode reads the solve's state at its start (written by the
// pass before): once the test has stopped the solve it copies x and
// counts nothing.  Each CTA sums r^2 of its cells in a fixed order into a
// partial; the last CTA to finish (a ticket) sums the partials in index
// order and writes the new state: sum r^2, the passes that did work, and
// whether the next pass runs (sum > tol^2 |b|^2 and passes < max).  The
// state has two slots, read from one and written to the other, by the
// parity of the pass.
//
// The colour is the global parity (row + column) % 2 of the wrapped
// index (red = even), as the reference's checkerboard.  Arithmetic
// mirrors rb_sweeps, multigrid.operator and laplacian_H op for op, with
// the scalars rounded from the host's doubles and --fmad=false, so the
// plain versions are matched bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int AHEAD = 2;        // rows in flight beyond the next step's
constexpr int XRING = 8;        // rows of the input x ring (>= AHEAD + 4)
constexpr int SROWS = 4;        // rows of a stage's output ring
// row-load elements per thread: a row of 5 wd elements takes nt threads
__host__ __device__ constexpr int loads_for(int nt) {
  return nt >= 512 ? 8 : 6;
}
constexpr int STRIPS[] = {256, 128, 64, 32, 16};   // the widest first
constexpr int APPLY_THREADS = 512;

enum Mode { SWEEP = 0, MG_RESIDUAL = 1, SOLVE = 2 };

__host__ __device__ inline int wrap(long a, int n) {
  a %= n;
  return int(a < 0 ? a + n : a);
}

template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(BYTES));
}

__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void async_wait_ahead() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(AHEAD));
}

template <typename T>
struct Params {
  const T *x, *b, *Hu, *Hv, *mask;
  T *out, *r_out;       // r_out: the residual, or null
  double *part, *state; // SOLVE: per-CTA sums; {sum, go, passes} x 2 slots
  unsigned* ticket;     // SOLVE: CTAs done with this pass
  const T* thr;         // SOLVE: tol^2 |b|^2
  int ny, nx, k, reverse, t, ch, w, wd, s_ring;
  int parity, first, max_passes, has_lam;
  T rdx2, rdy2, rdx, rdy, lam, omega, one_m_omega;
};

// sum over the CTA's NT threads in a fixed order; red holds NT doubles
template <int NT>
__device__ double block_sum(double v, double* red) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  const double total = red[0];
  __syncthreads();
  return total;
}

template <typename T, int MODE, int NT>
__global__ void __launch_bounds__(NT, 512 / NT) rb_pass_kernel(
    const Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LOADS = loads_for(NT);
  const int tid = threadIdx.x;
  const int W = p.w, Wd = p.wd, S = p.s_ring, HALF = p.wd / 2;
  const int X0 = blockIdx.x * p.t, Y0 = blockIdx.y * p.ch;
  const int tw = min(p.t, p.nx - X0), chh = min(p.ch, p.ny - Y0);
  const int wd = tw + 2 * W, rows = chh + 2 * W;
  const int ns = 2 * p.k;                        // sweep stages
  const int fin = MODE == SWEEP ? ns - 1 : ns;   // the last stage

  bool go = true;
  if (MODE == SOLVE && !p.first) go = p.state[2 + p.parity] != 0.0;
  double acc = 0.0;   // SOLVE: this thread's sum of r^2, in step order

  if (go) {
    // every plane row holds its even local columns, then its odd ones
    // (column 2j + u at u * HALF + j): a warp's cells of one colour and
    // their neighbours are consecutive words
    T* sb = reinterpret_cast<T*>(smem_raw);
    T* shu = sb + S * Wd;
    T* shv = shu + S * Wd;
    T* sm = shv + S * Wd;
    T* sinv = sm + S * Wd;
    T* sx = sinv + S * Wd;
    T* rings = sx + XRING * Wd;
    int* pairpar = reinterpret_cast<int*>(rings + ns * SROWS * Wd);
    int* rowpar = pairpar + HALF;   // per static slot: its row's parity

    // the global parities of a pair's two columns, bits 0 and 1
    for (int j = tid; 2 * j < wd; j += NT) {
      const int c = wrap(long(X0) - W + 2 * j, p.nx);
      const int c1 = c + 1 == p.nx ? 0 : c + 1;
      pairpar[j] = (c & 1) | (2 * j + 1 < wd ? (c1 & 1) << 1 : 0);
    }
    // this thread's share of a row load: (field, column) elements, the
    // source column's address and the place in the row
    const T* lsrc[LOADS];
    int ldst[LOADS];
    int lisx = 0;
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      const int e = tid + j * NT;
      lsrc[j] = nullptr;
      ldst[j] = 0;
      if (e < 5 * wd) {
        const int f = e / wd, i = e - f * wd;
        const T* base = f == 0   ? p.x
                        : f == 1 ? p.b
                        : f == 2 ? p.Hu
                        : f == 3 ? p.Hv
                                 : p.mask;
        T* plane = f == 0 ? sx : f == 1 ? sb : f == 2 ? shu : f == 3 ? shv : sm;
        lsrc[j] = base + wrap(long(X0) - W + i, p.nx);
        ldst[j] = int(plane - sb) + (i & 1) * HALF + (i >> 1);
        if (f == 0) lisx |= 1 << j;
      }
    }
    auto load_row = [&](int rho, int grow, int sl) {
      const long off = long(grow) * p.nx;
#pragma unroll
      for (int j = 0; j < LOADS; ++j)
        if (lsrc[j])
          copy_async<sizeof(T)>(
              sb + ldst[j] +
                  ((lisx >> j) & 1 ? (rho & (XRING - 1)) : sl) * Wd,
              lsrc[j] + off);
      if (tid == 0) rowpar[sl] = grow & 1;
    };

    int grow = wrap(long(Y0) - W, p.ny);   // global row of the next load
    int lrow = 0;                          // its local row
    for (; lrow < AHEAD + 2; ++lrow) {
      if (lrow < rows) load_row(lrow, grow, lrow);
      async_commit();
      grow = grow + 1 == p.ny ? 0 : grow + 1;
    }
    async_wait_ahead();
    __syncthreads();

    // items: g = 0 the 1/diag row, g = 1 + h stage h; q the column pair
    // (2q, 2q + 1)
    const int nst = fin + 2;
    // items: g = 0 the 1/diag row, g = 1 + h stage h; q the column pair
    // (2q, 2q + 1)
    const int P = (wd + 1) >> 1;
    const int g0 = tid / P, q0 = tid - g0 * P;
    const int dg = NT / P, dq = NT - dg * P;
    const T* res_ring = ns > 0 ? rings + (ns - 1) * SROWS * Wd : sx;
    const int res_mask = ns > 0 ? SROWS - 1 : XRING - 1;

    // invariant at the top of step tau: rows <= tau + 1 are loaded, and
    // 1/diag of rows <= tau is written
    const int nsteps = rows + fin - 1;
    int sl_tau = 0;   // static slot of row tau
    for (int tau = 0; tau < nsteps; ++tau) {
      {
        int sl = sl_tau + AHEAD + 2;
        if (sl >= S) sl -= S;
        if (lrow < rows) load_row(lrow, grow, sl);
        async_commit();
        ++lrow;
        grow = grow + 1 == p.ny ? 0 : grow + 1;
      }
      for (int g = g0, q = q0; g < nst;) {
        const int c0 = 2 * q, c1 = c0 + 1;
        if (g == 0) {
          // 1/diag of row tau + 1: diag reads the west and south faces
          const int rho = tau + 1;
          if (rho < rows) {
            int sl = sl_tau + 1;
            if (sl >= S) sl -= S;
            const T* hu = shu + sl * Wd;
            const T* hv = shv + sl * Wd;
            const T* hvs = shv + sl_tau * Wd;
            T* inv = sinv + sl * Wd;
            auto diag_inv = [&](T hc, T hw, T hvc, T hvsc) {
              const T d = -((hc + hw) * p.rdx2 + (hvc + hvsc) * p.rdy2) -
                          p.lam;
              return d != T(0) ? T(1) / d : T(0);
            };
            const T huE = hu[q], huO = hu[HALF + q];
            if (c0 >= 1)
              inv[q] = diag_inv(huE, hu[HALF + q - 1], hv[q], hvs[q]);
            if (c1 < wd)
              inv[HALF + q] = diag_inv(huO, huE, hv[HALF + q], hvs[HALF + q]);
          }
        } else {
          const int h = g - 1;
          const int rho = tau - 2 * h;
          if (rho >= h + 1 && rho < rows - h - 1) {
            int sl = sl_tau - 2 * h;
            if (sl < 0) sl += S;
            const int sls = sl == 0 ? S - 1 : sl - 1;
            const T* bb = sb + sl * Wd;
            const T* hu = shu + sl * Wd;
            const T* hv = shv + sl * Wd;
            const T* hvs = shv + sls * Wd;
            const T* m = sm + sl * Wd;
            if (h < ns) {
              // half-sweep h: the cells of its colour on [h+1, wd-h-1)
              const T *xc, *xn, *xs;
              if (h == 0) {
                xc = sx + (rho & (XRING - 1)) * Wd;
                xn = sx + ((rho + 1) & (XRING - 1)) * Wd;
                xs = sx + ((rho - 1) & (XRING - 1)) * Wd;
              } else {
                const T* r = rings + (h - 1) * SROWS * Wd;
                xc = r + (rho & (SROWS - 1)) * Wd;
                xn = r + ((rho + 1) & (SROWS - 1)) * Wd;
                xs = r + ((rho - 1) & (SROWS - 1)) * Wd;
              }
              T* o = rings + (h * SROWS + (rho & (SROWS - 1))) * Wd;
              const T* inv = sinv + sl * Wd;
              const int lo = h + 1, hi = wd - h - 1;
              const bool in0 = c0 >= lo && c0 < hi, in1 = c1 >= lo && c1 < hi;
              const int cl = ((h & 1) ^ p.reverse) ^ rowpar[sl];
              const int pp = pairpar[q];
              const T xE = xc[q], xO = xc[HALF + q];
              const T mE = m[q], mO = m[HALF + q];
              // cell at index i of the row, west / east neighbours given
              auto update = [&](int i, T v, T xw, T xe, T huw) {
                const T nb = (hu[i] * xe + huw * xw) * p.rdx2 +
                             (hv[i] * xn[i] + hvs[i] * xs[i]) * p.rdy2;
                const T x_gs = (bb[i] - nb) * inv[i];
                return p.one_m_omega * v + p.omega * x_gs;
              };
              T v0 = xE, v1 = xO;
              if ((pp & 1) == cl && mE > T(0) && in0)
                v0 = update(q, xE, xc[HALF + q - 1], xO, hu[HALF + q - 1]);
              if ((pp >> 1) == cl && mO > T(0) && in1)
                v1 = update(HALF + q, xO, xE, xc[q + 1], hu[q]);
              v0 = v0 * mE;
              v1 = v1 * mO;
              if (in0) o[q] = v0;
              if (in1) o[HALF + q] = v1;
              if (h == ns - 1 && rho >= W && rho < W + chh) {
                T* g_out = p.out + long(Y0 + rho - W) * p.nx + X0 - W;
                if (in0 && c0 >= W && c0 < W + tw) g_out[c0] = v0;
                if (in1 && c1 >= W && c1 < W + tw) g_out[c1] = v1;
              }
            } else if (MODE != SWEEP) {
              // the residual of the swept x on the t x ch interior
              const T* xc = res_ring + (rho & res_mask) * Wd;
              const T* xn = res_ring + ((rho + 1) & res_mask) * Wd;
              const T* xs = res_ring + ((rho - 1) & res_mask) * Wd;
              auto residual = [&](int i, T xq, T xw, T xe, T huw) {
                const T mc = m[i];
                T ax;
                if (MODE == MG_RESIDUAL) {
                  // multigrid.operator's order, A x masked
                  ax = (hu[i] * xe + huw * xw - (hu[i] + huw) * xq) *
                           p.rdx2 +
                       (hv[i] * xn[i] + hvs[i] * xs[i] -
                        (hv[i] + hvs[i]) * xq) * p.rdy2;
                  if (p.has_lam) ax = ax - p.lam * xq;
                  return (bb[i] - ax * mc) * mc;
                }
                // laplacian_H's order: fluxes H d_xp x, then d_xm
                ax = (hu[i] * ((xe - xq) * p.rdx) -
                      huw * ((xq - xw) * p.rdx)) * p.rdx +
                     (hv[i] * ((xn[i] - xq) * p.rdy) -
                      hvs[i] * ((xq - xs[i]) * p.rdy)) * p.rdy;
                if (p.has_lam) ax = ax - p.lam * xq;
                ax = ax * mc;
                return (bb[i] - ax) * mc;
              };
              T* g_r = p.r_out ? p.r_out + long(Y0 + rho - W) * p.nx + X0 - W
                               : nullptr;
              const T xE = xc[q], xO = xc[HALF + q];
              if (c0 >= W && c0 < W + tw) {
                const T r = residual(q, xE, xc[HALF + q - 1], xO,
                                     hu[HALF + q - 1]);
                if (MODE == SOLVE) {
                  const T rr = r * r;
                  acc += double(rr);
                }
                if (g_r) g_r[c0] = r;
              }
              if (c1 >= W && c1 < W + tw) {
                const T r = residual(HALF + q, xO, xE, xc[q + 1], hu[q]);
                if (MODE == SOLVE) {
                  const T rr = r * r;
                  acc += double(rr);
                }
                if (g_r) g_r[c1] = r;
              }
            }
          }
        }
        q += dq;
        g += dg;
        if (q >= P) {
          q -= P;
          ++g;
        }
      }
      async_wait_ahead();
      __syncthreads();
      if (++sl_tau == S) sl_tau = 0;
    }
  } else if (p.out) {
    // the test stopped the solve: x stays as it is
    for (int j = 0; j < chh; ++j) {
      const long row = long(Y0 + j) * p.nx + X0;
      for (int i = tid; i < tw; i += NT) p.out[row + i] = p.x[row + i];
    }
  }

  if (MODE == SOLVE) {
    __syncthreads();
    double* red = reinterpret_cast<double*>(smem_raw);
    unsigned* last = reinterpret_cast<unsigned*>(red + NT);
    const double mine = block_sum<NT>(acc, red);
    const unsigned nblocks = gridDim.x * gridDim.y;
    if (tid == 0) {
      if (go) p.part[blockIdx.y * gridDim.x + blockIdx.x] = mine;
      __threadfence();
      *last = atomicAdd(p.ticket, 1u) == nblocks - 1;
    }
    __syncthreads();
    if (*last) {
      __threadfence();
      double a = 0.0;
      if (go)
        for (unsigned i = tid; i < nblocks; i += NT) a += __ldcg(p.part + i);
      const double total = block_sum<NT>(a, red);
      if (tid == 0) {
        const int pi = p.parity, po = pi ^ 1;
        if (go) {
          const double np =
              (p.first ? 0.0 : p.state[4 + pi]) + (p.k > 0 ? 1.0 : 0.0);
          p.state[po] = total;
          p.state[2 + po] =
              (T(total) > *p.thr && np < double(p.max_passes)) ? 1.0 : 0.0;
          p.state[4 + po] = np;
        } else {
          p.state[po] = p.state[pi];
          p.state[2 + po] = p.state[2 + pi];
          p.state[4 + po] = p.state[4 + pi];
        }
        atomicExch(p.ticket, 0u);
      }
    }
  }
}

// K4b: one thread per point; matvec gives A x masked, else (b - A x) mask
template <typename T>
__global__ void __launch_bounds__(APPLY_THREADS)
    apply_kernel(const T* x, const T* b, const T* Hu, const T* Hv,
                 const T* mask, T* out, int ny, int nx, int matvec, T rdx2,
                 T rdy2, T lam) {
  const long i = long(blockIdx.x) * APPLY_THREADS + threadIdx.x;
  if (i >= long(ny) * nx) return;
  const int j = int(i / nx), c = int(i - long(j) * nx);
  const long row = long(j) * nx;
  const long e = row + (c + 1 == nx ? 0 : c + 1);
  const long w = row + (c == 0 ? nx - 1 : c - 1);
  const long n = long(j + 1 == ny ? 0 : j + 1) * nx + c;
  const long s = long(j == 0 ? ny - 1 : j - 1) * nx + c;
  const T q = x[i], hu = Hu[i], huw = Hu[w], hv = Hv[i], hvs = Hv[s];
  T ax = (hu * x[e] + huw * x[w] - (hu + huw) * q) * rdx2 +
         (hv * x[n] + hvs * x[s] - (hv + hvs) * q) * rdy2;
  if (lam != T(0)) ax = ax - lam * q;
  const T m = mask[i];
  out[i] = matvec ? ax * m : (b[i] - ax * m) * m;
}

struct Plan {
  int t, ch, w, wd, s_ring, gx, gy, smem, nt;
};

template <typename T>
size_t smem_bytes(int wd, int s_ring, int k, int nt) {
  const size_t n = sizeof(T) * size_t(wd) *
                       (5 * s_ring + XRING + SROWS * 2 * k) +
                   sizeof(int) * (wd / 2 + s_ring);
  const size_t floor = sizeof(double) * nt + 16;   // block_sum
  return n > floor ? n : floor;
}

// the loaded width of a strip, rounded up to even (two halves per row)
inline int plane_width(int t, int nx, int w) {
  const int wd = (t < nx ? t : nx) + 2 * w;
  return wd + (wd & 1);
}

// threads per CTA: a step of few stages is short, and CTAs of 128 threads
// run several to an SM; the 8-sweep pass keeps 512
inline int threads_for(int k) { return k <= 2 ? 128 : 512; }

// the tile: the widest strip whose CTA fits an SM, at most 128 columns
// for 128 threads; the chunk: rows such that the CTAs fill the card once,
// at least 32
template <typename T, int MODE, int NT>
int make_plan(int ny, int nx, int k, Plan* pl) {
  static bool attr_set[64] = {};
  int dev = 0, smem_max = 0, n_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return int(e);
  e = cudaDeviceGetAttribute(&smem_max,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return int(e);
  e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return int(e);
  if (dev < 64 && !attr_set[dev]) {
    e = cudaFuncSetAttribute(rb_pass_kernel<T, MODE, NT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_max);
    if (e != cudaSuccess) return int(e);
    attr_set[dev] = true;
  }
  const int w = 2 * k + (MODE == SWEEP ? 0 : 1);
  const int s_ring = 4 * k + 4 + AHEAD;
  int best = 0, best_occ = 0;
  for (int t : STRIPS) {
    if (NT < 512 && t > 128) continue;
    const int wd = plane_width(t, nx, w);
    const size_t smem = smem_bytes<T>(wd, s_ring, k, NT);
    if (smem > size_t(smem_max) || 5 * wd > loads_for(NT) * NT) continue;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &best_occ, rb_pass_kernel<T, MODE, NT>, NT, smem);
    if (e != cudaSuccess) return int(e);
    if (best_occ < 1) continue;
    best = t;
    break;
  }
  if (best == 0) return int(cudaErrorInvalidValue);   // k too large
  pl->t = best;
  pl->nt = NT;
  pl->w = w;
  pl->s_ring = s_ring;
  pl->wd = plane_width(best, nx, w);
  pl->smem = int(smem_bytes<T>(pl->wd, s_ring, k, NT));
  pl->gx = (nx + best - 1) / best;
  int n_chunks = n_sm * best_occ / pl->gx;
  if (n_chunks < 1) n_chunks = 1;
  int ch = (ny + n_chunks - 1) / n_chunks;
  const int floor = ny < 32 ? ny : 32;
  if (ch < floor) ch = floor;
  pl->ch = ch;
  pl->gy = (ny + ch - 1) / ch;
  return 0;
}

template <typename T, int MODE>
int plan_nt(int ny, int nx, int k, Plan* pl) {
  return threads_for(k) == 128 ? make_plan<T, MODE, 128>(ny, nx, k, pl)
                               : make_plan<T, MODE, 512>(ny, nx, k, pl);
}

template <typename T>
int plan_any(int ny, int nx, int k, int mode, Plan* pl) {
  if (ny < 1 || nx < 1 || k < (mode == SOLVE ? 0 : 1))
    return int(cudaErrorInvalidValue);
  switch (mode) {
    case SWEEP: return plan_nt<T, SWEEP>(ny, nx, k, pl);
    case MG_RESIDUAL:
      return plan_nt<T, MG_RESIDUAL>(ny, nx, k, pl);
    case SOLVE: return plan_nt<T, SOLVE>(ny, nx, k, pl);
  }
  return int(cudaErrorInvalidValue);
}

template <typename T, int MODE>
int launch(Params<T> p, const Plan& pl, void* stream) {
  p.t = pl.t;
  p.ch = pl.ch;
  p.w = pl.w;
  p.wd = pl.wd;
  p.s_ring = pl.s_ring;
  const dim3 grid(pl.gx, pl.gy);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pl.nt == 128)
    rb_pass_kernel<T, MODE, 128><<<grid, 128, pl.smem, st>>>(p);
  else
    rb_pass_kernel<T, MODE, 512><<<grid, 512, pl.smem, st>>>(p);
  return int(cudaGetLastError());
}

template <typename T>
int rb_pass(const T* x, const T* b, const T* Hu, const T* Hv, const T* mask,
            T* out, T* r_out, double* part, int part_len, double* state,
            unsigned* ticket, const T* thr, int ny, int nx, int k, int mode,
            int reverse, int parity, int first, int max_passes, double rdx2,
            double rdy2, double rdx, double rdy,
            double lam, int has_lam, double omega, double one_m_omega,
            void* stream) {
  Plan pl;
  const int code = plan_any<T>(ny, nx, k, mode, &pl);
  if (code) return code;
  const bool bad =
      mode == SOLVE ? (!part || !state || !ticket || !thr ||
                       part_len < pl.gx * pl.gy || (k > 0) != (out != nullptr))
      : mode == MG_RESIDUAL ? (!out || !r_out)
                            : !out;
  if (bad) return int(cudaErrorInvalidValue);
  Params<T> p{x,       b,     Hu,    Hv,       mask,     out,
              r_out,   part,  state, ticket,   thr,      ny,
              nx,      k,     reverse, 0,      0,        0,
              0,       0,     parity, first,   max_passes, has_lam,
              T(rdx2), T(rdy2), T(rdx), T(rdy), T(lam),  T(omega),
              T(one_m_omega)};
  switch (mode) {
    case SWEEP: return launch<T, SWEEP>(p, pl, stream);
    case MG_RESIDUAL: return launch<T, MG_RESIDUAL>(p, pl, stream);
    default: return launch<T, SOLVE>(p, pl, stream);
  }
}

template <typename T>
int apply_op(const T* x, const T* b, const T* Hu, const T* Hv, const T* mask,
             T* out, int ny, int nx, int matvec, double rdx2, double rdy2,
             double lam, void* stream) {
  const long n = long(ny) * nx;
  apply_kernel<T><<<unsigned((n + APPLY_THREADS - 1) / APPLY_THREADS),
                    APPLY_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, b, Hu, Hv, mask, out, ny, nx, matvec, T(rdx2), T(rdy2), T(lam));
  return int(cudaGetLastError());
}

}  // namespace

#define RB_ENTRY(SUFFIX, T)                                                  \
  extern "C" int beom_rb_pass_##SUFFIX(                                      \
      const T* x, const T* b, const T* Hu, const T* Hv, const T* mask,       \
      T* out, T* r_out, double* part, int part_len, double* state,           \
      unsigned* ticket, const T* thr, int ny, int nx, int k, int mode,       \
      int reverse, int parity, int first, int max_passes, double rdx2,       \
      double rdy2, double rdx, double rdy, double lam, int has_lam,          \
      double omega, double one_m_omega, void* stream) {                      \
    return rb_pass<T>(x, b, Hu, Hv, mask, out, r_out, part, part_len, state, \
                      ticket, thr, ny, nx, k, mode, reverse, parity, first,  \
                      max_passes, rdx2, rdy2, rdx, rdy, lam, has_lam, omega, \
                      one_m_omega, stream);                                  \
  }                                                                          \
  /* out: t, ch, w, wd, ring rows, grid x, grid y, shared bytes, threads */ \
  extern "C" int beom_rb_plan_##SUFFIX(int ny, int nx, int k, int mode,      \
                                       int* out) {                           \
    Plan pl;                                                                 \
    const int code = plan_any<T>(ny, nx, k, mode, &pl);                      \
    if (code) return code;                                                   \
    const int v[9] = {pl.t,  pl.ch, pl.w,    pl.wd, pl.s_ring,               \
                      pl.gx, pl.gy, pl.smem, pl.nt};                         \
    for (int i = 0; i < 9; ++i) out[i] = v[i];                               \
    return 0;                                                                \
  }                                                                          \
  extern "C" int beom_apply_op_##SUFFIX(                                     \
      const T* x, const T* b, const T* Hu, const T* Hv, const T* mask,       \
      T* out, int ny, int nx, int matvec, double rdx2, double rdy2,          \
      double lam, void* stream) {                                            \
    return apply_op<T>(x, b, Hu, Hv, mask, out, ny, nx, matvec, rdx2, rdy2,  \
                       lam, stream);                                         \
  }

RB_ENTRY(f32, float)
RB_ENTRY(f64, double)

extern "C" const char* beom_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
