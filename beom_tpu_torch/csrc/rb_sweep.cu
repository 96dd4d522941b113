// K4a: k red-black SOR sweeps of A x = b, A = div(H grad) - lam, in one
// launch (solvers/elliptic.py::rb_sweeps, k sweeps), optionally with the
// residual b - A x of the result from the same pass; and K4b: one pass of
// the operator, A x or b - A x.
//
// K4a replaces beom_tpu/stencils/redblack_pallas.py::_rb_kernel as built
// by make_level_sweep (residual=True: the multigrid pre-smoother), K4b
// the kernel built by make_apply_kernel (the standalone multigrid
// solver's outer residual).
//
// Bound: device-memory bytes.  A sweep is ~12 flops per point against
// the 5 fields it reads (x, b, Hu, Hv, mask) and the 1 it writes; one
// launch does k sweeps for one read and one write of each, so it moves
// k times fewer bytes than k separate sweeps, and the residual costs one
// more write instead of another pass.  K4b is one read of each field and
// one write.
//
// Shape: one CTA per square tile of t x t interior points with a
// W-point halo on both axes, loaded with periodic wrap (exact for any
// ny, nx).  Each half-sweep updates the cells of one colour on [1, R-1)
// of the R = t + 2W block, so the block's outer ring goes stale by one
// cell per half-sweep; after the 2k half-sweeps of k sweeps the cells
// on [2k, R-2k) are exact.  W = 2k + 1 keeps the interior inside that
// cone with one cell to spare for the west/south face depths that
// diag reads; the residual's five-point stencil needs one cell more, so
// it takes W = 2k + 2.  Unlike the reference's band-lagged kernel, a
// launch is then exactly k strict red-black sweeps (and the exact
// residual), whatever the tiling.  The tile t is the largest of 64, 32,
// 16, 8 whose six shared planes (x, b, Hu, Hv, mask, 1/diag) fit the
// card's shared memory.
//
// The colour is the global parity (row + column) % 2 of the wrapped
// index (red = even), as the reference's checkerboard.  Arithmetic
// mirrors rb_sweeps and multigrid.operator op for op, with the scalars
// rounded from the host's doubles and --fmad=false, so the plain
// versions are matched bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;
constexpr int N_PLANES = 6;

__device__ __forceinline__ int wrap(int a, int n) {
  a %= n;
  return a < 0 ? a + n : a;
}

template <typename T>
struct Params {
  const T *x, *b, *Hu, *Hv, *mask;
  T *out, *r_out;       // r_out: the residual, or null
  int ny, nx, k, reverse, t, w;
  T rdx2, rdy2, lam, omega, one_m_omega;
};

template <typename T>
__global__ void __launch_bounds__(THREADS) rb_sweep_kernel(const Params<T> p) {
  extern __shared__ unsigned char smem_raw[];
  const int R = p.t + 2 * p.w;
  const int npt = R * R;
  T* x = reinterpret_cast<T*>(smem_raw);
  T* b = x + npt;
  T* hu = b + npt;
  T* hv = hu + npt;
  T* m = hv + npt;
  T* inv = m + npt;
  const int x0 = blockIdx.x * p.t - p.w;
  const int y0 = blockIdx.y * p.t - p.w;
  const int tid = threadIdx.x;

  for (int s = tid; s < npt; s += THREADS) {
    const int gj = wrap(y0 + s / R, p.ny);
    const int gi = wrap(x0 + s % R, p.nx);
    const long g = long(gj) * p.nx + gi;
    x[s] = p.x[g];
    b[s] = p.b[g];
    hu[s] = p.Hu[g];
    hv[s] = p.Hv[g];
    m[s] = p.mask[g];
  }
  __syncthreads();

  // 1/diag on [1, R): diag reads the west and south face depths
  for (int k = tid; k < (R - 1) * (R - 1); k += THREADS) {
    const int s = (1 + k / (R - 1)) * R + 1 + k % (R - 1);
    const T d = -((hu[s] + hu[s - 1]) * p.rdx2 +
                  (hv[s] + hv[s - R]) * p.rdy2) - p.lam;
    inv[s] = d != T(0) ? T(1) / d : T(0);
  }
  __syncthreads();

  const int n_in = (R - 2) * (R - 2);
  for (int half = 0; half < 2 * p.k; ++half) {
    // red (parity 0) first, black first when reverse
    const int colour = (half & 1) ^ p.reverse;
    for (int k = tid; k < n_in; k += THREADS) {
      const int jj = 1 + k / (R - 2);
      const int ii = 1 + k % (R - 2);
      const int s = jj * R + ii;
      const int par = (wrap(y0 + jj, p.ny) + wrap(x0 + ii, p.nx)) & 1;
      T v = x[s];
      if (par == colour && m[s] > T(0)) {
        const T nb = (hu[s] * x[s + 1] + hu[s - 1] * x[s - 1]) * p.rdx2 +
                     (hv[s] * x[s + R] + hv[s - R] * x[s - R]) * p.rdy2;
        const T x_gs = (b[s] - nb) * inv[s];
        v = p.one_m_omega * v + p.omega * x_gs;
      }
      // the other colour is only re-masked: in-place is safe, a cell
      // of this colour reads neighbours of the other one
      x[s] = v * m[s];
    }
    __syncthreads();
  }

  for (int k = tid; k < p.t * p.t; k += THREADS) {
    const int jj = k / p.t;
    const int ii = k % p.t;
    const int gj = blockIdx.y * p.t + jj;
    const int gi = blockIdx.x * p.t + ii;
    if (gj >= p.ny || gi >= p.nx) continue;
    const int s = (p.w + jj) * R + p.w + ii;
    p.out[long(gj) * p.nx + gi] = x[s];
    if (p.r_out) {
      // r = (b - A x) mask, A x masked, in multigrid.operator's order
      const T q = x[s];
      T ax = (hu[s] * x[s + 1] + hu[s - 1] * x[s - 1] -
              (hu[s] + hu[s - 1]) * q) * p.rdx2 +
             (hv[s] * x[s + R] + hv[s - R] * x[s - R] -
              (hv[s] + hv[s - R]) * q) * p.rdy2;
      if (p.lam != T(0)) ax = ax - p.lam * q;
      p.r_out[long(gj) * p.nx + gi] = (b[s] - ax * m[s]) * m[s];
    }
  }
}

// K4b: one thread per point; matvec gives A x masked, else (b - A x) mask
template <typename T>
__global__ void __launch_bounds__(THREADS)
    apply_kernel(const T* x, const T* b, const T* Hu, const T* Hv,
                 const T* mask, T* out, int ny, int nx, int matvec, T rdx2,
                 T rdy2, T lam) {
  const long i = long(blockIdx.x) * THREADS + threadIdx.x;
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

template <typename T>
int rb_sweep(const T* x, const T* b, const T* Hu, const T* Hv,
             const T* mask, T* out, T* r_out, int ny, int nx, int k,
             int reverse, double rdx2, double rdy2, double lam, double omega,
             double one_m_omega, void* stream) {
  if (k < 1) return int(cudaErrorInvalidValue);
  int dev = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return int(e);
  e = cudaDeviceGetAttribute(&smem_max,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return int(e);
  const int w = 2 * k + 1 + (r_out ? 1 : 0);
  int t = 64;
  while (t >= 8 &&
         size_t(N_PLANES) * (t + 2 * w) * (t + 2 * w) * sizeof(T) >
             size_t(smem_max))
    t /= 2;
  if (t < 8) return int(cudaErrorInvalidValue);   // k too large
  const int smem = int(N_PLANES * (t + 2 * w) * (t + 2 * w) * sizeof(T));
  e = cudaFuncSetAttribute(rb_sweep_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return int(e);
  Params<T> p{x,       b,       Hu,     Hv,       mask,
              out,     r_out,   ny,     nx,       k,
              reverse, t,       w,      T(rdx2),  T(rdy2),
              T(lam),  T(omega), T(one_m_omega)};
  const dim3 grid((nx + t - 1) / t, (ny + t - 1) / t);
  rb_sweep_kernel<T><<<grid, THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return int(cudaGetLastError());
}

template <typename T>
int apply_op(const T* x, const T* b, const T* Hu, const T* Hv, const T* mask,
             T* out, int ny, int nx, int matvec, double rdx2, double rdy2,
             double lam, void* stream) {
  const long n = long(ny) * nx;
  apply_kernel<T><<<unsigned((n + THREADS - 1) / THREADS), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      x, b, Hu, Hv, mask, out, ny, nx, matvec, T(rdx2), T(rdy2), T(lam));
  return int(cudaGetLastError());
}

}  // namespace

#define RB_SWEEP_ENTRY(NAME, APPLY, T)                                      \
  extern "C" int NAME(const T* x, const T* b, const T* Hu, const T* Hv,     \
                      const T* mask, T* out, T* r_out, int ny, int nx,      \
                      int k, int reverse, double rdx2, double rdy2,         \
                      double lam, double omega, double one_m_omega,         \
                      void* stream) {                                       \
    return rb_sweep<T>(x, b, Hu, Hv, mask, out, r_out, ny, nx, k, reverse,  \
                       rdx2, rdy2, lam, omega, one_m_omega, stream);        \
  }                                                                         \
  extern "C" int APPLY(const T* x, const T* b, const T* Hu, const T* Hv,    \
                       const T* mask, T* out, int ny, int nx, int matvec,   \
                       double rdx2, double rdy2, double lam, void* stream) { \
    return apply_op<T>(x, b, Hu, Hv, mask, out, ny, nx, matvec, rdx2, rdy2, \
                       lam, stream);                                        \
  }

RB_SWEEP_ENTRY(beom_rb_sweep_f32, beom_apply_op_f32, float)
RB_SWEEP_ENTRY(beom_rb_sweep_f64, beom_apply_op_f64, double)

extern "C" const char* beom_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
