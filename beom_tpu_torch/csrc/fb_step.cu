// K1: one free-surface forward-backward step (stepping/fb.py::fb_step) of
// a single layer, fused into one kernel launch.
//
// Replaces beom_tpu/stencils/band.py::_band_kernel running the body of
// beom_tpu/stencils/fused_fb.py::make_pallas_stepper.
//
// Bound: device-memory bytes.  A step reads 11 fields and writes 3, and
// does ~150 flops per point, far below the H100's ratio of operations to
// bytes.  The design keeps every intermediate of the step (h1, the
// Montgomery + kinetic potential, the PV, face thicknesses, tendencies,
// the first Coriolis sweep) in shared memory, so a point costs one read
// of each operand and one write of each result.
//
// Shape: one CTA per 2-D tile of TY x TX interior points with a W-point
// halo on both axes.  The CTA loads the (TY+2W) x (TX+2W) haloed block
// with periodic wrap on both axes (so the wrap is exact for any ny, nx),
// evaluates the step in five stages separated by __syncthreads(), each
// on a region that shrinks by the stage's stencil reach, and writes back
// the interior.  Ragged edge tiles are masked at the write.  Stage
// regions, as [lo, R - hi) on both axes of the R-point block:
//   S1 h1                                   [1, R-1)
//   S2 hx, hy, phi = M + K, q, drag denoms  [1, R-2)
//   S3 du_c, dv_c (pressure, viscosity, wind) [1, R-3)
//   S4 first Coriolis sweep (u1 or v1)      [2, R-3)
//   S5 second sweep on the interior         [W, R-W), which needs S4 on
//                                           [W-1, R-W+1): so W = 4.
//
// Arithmetic mirrors the eager port (beom_tpu_torch.stepping.fb.fb_step)
// op for op: the same association, the scalars rounded from the host's
// doubles, and --fmad=false at build time so no multiply-add is
// contracted.  The plain version is then matched bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 16;
constexpr int W = 4;
constexpr int RX = TX + 2 * W;
constexpr int RY = TY + 2 * W;
constexpr int NPT = RX * RY;
constexpr int THREADS = 256;

// shared-memory planes: 11 loaded operands, then the intermediates
enum Plane {
  P_H, P_U, P_V, P_HB, P_M, P_MU, P_MV, P_MQ, P_FQ, P_TX, P_TY,
  P_H1, P_HX, P_HY, P_PHI, P_Q, P_DENU, P_DENV, P_DUC, P_DVC, P_A1,
  N_PLANES
};

template <typename T>
struct Params {
  const T *h, *u, *v, *H, *mask, *mask_u, *mask_v, *mask_q, *f_q, *taux,
      *tauy;
  T *h1, *u1, *v1;
  int ny, nx;
  int u_first, sadourny, free_slip, visc, wind;
  T dt, inv_dx, inv_dy, g, nu2, rho0, h_min, r_bot;
};

__device__ __forceinline__ int wrap(int a, int n) {
  a %= n;
  return a < 0 ? a + n : a;
}

// jnp.maximum / torch.clamp_min: NaN propagates
template <typename T>
__device__ __forceinline__ T vmax(T a, T b) {
  return (a > b || a != a) ? a : b;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fb_step_kernel(const Params<T> p) {
  extern __shared__ unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* h = sm + P_H * NPT;
  T* u = sm + P_U * NPT;
  T* v = sm + P_V * NPT;
  T* Hb = sm + P_HB * NPT;
  T* mask = sm + P_M * NPT;
  T* mu = sm + P_MU * NPT;
  T* mv = sm + P_MV * NPT;
  T* mq = sm + P_MQ * NPT;
  T* fq = sm + P_FQ * NPT;
  T* tx = sm + P_TX * NPT;
  T* ty = sm + P_TY * NPT;
  T* h1 = sm + P_H1 * NPT;
  T* hx = sm + P_HX * NPT;
  T* hy = sm + P_HY * NPT;
  T* phi = sm + P_PHI * NPT;
  T* q = sm + P_Q * NPT;
  T* denu = sm + P_DENU * NPT;
  T* denv = sm + P_DENV * NPT;
  T* duc = sm + P_DUC * NPT;
  T* dvc = sm + P_DVC * NPT;
  T* a1 = sm + P_A1 * NPT;

  const T half = T(0.5);
  const T one = T(1.0);
  const int x0 = blockIdx.x * TX - W;
  const int y0 = blockIdx.y * TY - W;
  const int tid = threadIdx.x;

  // S0: the haloed block, periodic on both axes
  for (int s = tid; s < NPT; s += THREADS) {
    const int gj = wrap(y0 + s / RX, p.ny);
    const int gi = wrap(x0 + s % RX, p.nx);
    const long g = long(gj) * p.nx + gi;
    h[s] = p.h[g];
    u[s] = p.u[g];
    v[s] = p.v[g];
    Hb[s] = p.H[g];
    mask[s] = p.mask[g];
    mu[s] = p.mask_u[g];
    mv[s] = p.mask_v[g];
    mq[s] = p.mask_q[g];
    fq[s] = p.f_q[g];
    tx[s] = p.taux[g];
    ty[s] = p.tauy[g];
  }
  __syncthreads();

// loop over the square region [lo, R - hi) of the block on both axes
#define REGION(lo, hi, ...)                                         \
  {                                                                 \
    constexpr int nx_ = RX - (lo) - (hi);                           \
    constexpr int ny_ = RY - (lo) - (hi);                           \
    for (int k = tid; k < nx_ * ny_; k += THREADS) {                \
      const int s = ((lo) + k / nx_) * RX + (lo) + k % nx_;         \
      __VA_ARGS__                                                   \
    }                                                               \
  }                                                                 \
  __syncthreads();

  // S1: continuity, h1 = (h + dt * -div(F)) * mask
  REGION(1, 1, {
    const T fx = mu[s] * (half * (h[s] + h[s + 1])) * u[s];
    const T fxm = mu[s - 1] * (half * (h[s - 1] + h[s])) * u[s - 1];
    const T fy = mv[s] * (half * (h[s] + h[s + RX])) * v[s];
    const T fym = mv[s - RX] * (half * (h[s - RX] + h[s])) * v[s - RX];
    const T dh = -((fx - fxm) * p.inv_dx + (fy - fym) * p.inv_dy) * mask[s];
    h1[s] = (h[s] + p.dt * dh) * mask[s];
  })

  // S2: face thicknesses, phi = M (+ K), PV, implicit-drag denominators
  REGION(1, 2, {
    const T hxs = half * (h1[s] + h1[s + 1]);
    const T hys = half * (h1[s] + h1[s + RX]);
    hx[s] = hxs;
    hy[s] = hys;
    T ph = p.g * (h1[s] - Hb[s]);
    if (p.sadourny) {
      const T ke = half * (half * (u[s] * u[s] + u[s - 1] * u[s - 1]) +
                           half * (v[s] * v[s] + v[s - RX] * v[s - RX]));
      ph = ph + ke;
      const T zeta = ((v[s + 1] - v[s]) * p.inv_dx -
                      (u[s + RX] - u[s]) * p.inv_dy) * mq[s];
      const T hq = vmax(
          half * (hys + half * (h1[s + 1] + h1[s + 1 + RX])), p.h_min);
      q[s] = (fq[s] + zeta) / hq;
    } else {
      q[s] = fq[s];
    }
    phi[s] = ph;
    denu[s] = one + p.dt * (p.r_bot / vmax(hxs, p.h_min));
    denv[s] = one + p.dt * (p.r_bot / vmax(hys, p.h_min));
  })

  // S3: -grad(phi) + nu2 lap + wind, at u and v points
  REGION(1, 3, {
    T du = -((phi[s + 1] - phi[s]) * p.inv_dx);
    T dv = -((phi[s + RX] - phi[s]) * p.inv_dy);
    if (p.visc) {
      // lap_u: gx at centres (masked), gy at corners
      const T gx1 = ((u[s + 1] - u[s]) * p.inv_dx) * mask[s + 1];
      const T gx0 = ((u[s] - u[s - 1]) * p.inv_dx) * mask[s];
      T gy0 = (u[s + RX] - u[s]) * p.inv_dy;
      T gym = (u[s] - u[s - RX]) * p.inv_dy;
      // lap_v: gy at centres (masked), gx at corners
      const T ey1 = ((v[s + RX] - v[s]) * p.inv_dy) * mask[s + RX];
      const T ey0 = ((v[s] - v[s - RX]) * p.inv_dy) * mask[s];
      T ex0 = (v[s + 1] - v[s]) * p.inv_dx;
      T exm = (v[s] - v[s - 1]) * p.inv_dx;
      if (p.free_slip) {
        gy0 = gy0 * mq[s];
        gym = gym * mq[s - RX];
        ex0 = ex0 * mq[s];
        exm = exm * mq[s - 1];
      }
      const T lu = ((gx1 - gx0) * p.inv_dx + (gy0 - gym) * p.inv_dy) * mu[s];
      const T lv = ((ey1 - ey0) * p.inv_dy + (ex0 - exm) * p.inv_dx) * mv[s];
      du = du + p.nu2 * lu;
      dv = dv + p.nu2 * lv;
    }
    if (p.wind) {
      du = du + mu[s] * tx[s] / (p.rho0 * vmax(hx[s], p.h_min));
      dv = dv + mv[s] * ty[s] / (p.rho0 * vmax(hy[s], p.h_min));
    }
    duc[s] = du;
    dvc[s] = dv;
  })

  // S4: the first FB-Coriolis sweep, u on even steps, v on odd ones
  if (p.u_first) {
    REGION(2, 3, {
      const T V0 = p.sadourny ? hy[s] * v[s] : v[s];
      const T V1 = p.sadourny ? hy[s + 1] * v[s + 1] : v[s + 1];
      const T Vm0 = p.sadourny ? hy[s - RX] * v[s - RX] : v[s - RX];
      const T Vm1 = p.sadourny ? hy[s - RX + 1] * v[s - RX + 1]
                               : v[s - RX + 1];
      const T duq = half * (q[s] * (half * (V0 + V1)) +
                            q[s - RX] * (half * (Vm0 + Vm1)));
      a1[s] = ((u[s] + p.dt * (duc[s] + duq)) / denu[s]) * mu[s];
    })
  } else {
    REGION(2, 3, {
      const T U0 = p.sadourny ? hx[s] * u[s] : u[s];
      const T U1 = p.sadourny ? hx[s + RX] * u[s + RX] : u[s + RX];
      const T Um0 = p.sadourny ? hx[s - 1] * u[s - 1] : u[s - 1];
      const T Um1 = p.sadourny ? hx[s - 1 + RX] * u[s - 1 + RX]
                               : u[s - 1 + RX];
      const T dvq = -(half * (q[s] * (half * (U0 + U1)) +
                              q[s - 1] * (half * (Um0 + Um1))));
      a1[s] = ((v[s] + p.dt * (dvc[s] + dvq)) / denv[s]) * mv[s];
    })
  }

  // S5: the second sweep on the interior, then write back h1, u1, v1
  {
    for (int k = tid; k < TX * TY; k += THREADS) {
      const int jj = k / TX;
      const int ii = k % TX;
      const int gj = blockIdx.y * TY + jj;
      const int gi = blockIdx.x * TX + ii;
      if (gj >= p.ny || gi >= p.nx) continue;
      const int s = (W + jj) * RX + W + ii;
      T uo, vo;
      if (p.u_first) {
        const T U0 = p.sadourny ? hx[s] * a1[s] : a1[s];
        const T U1 = p.sadourny ? hx[s + RX] * a1[s + RX] : a1[s + RX];
        const T Um0 = p.sadourny ? hx[s - 1] * a1[s - 1] : a1[s - 1];
        const T Um1 = p.sadourny ? hx[s - 1 + RX] * a1[s - 1 + RX]
                                 : a1[s - 1 + RX];
        const T dvq = -(half * (q[s] * (half * (U0 + U1)) +
                                q[s - 1] * (half * (Um0 + Um1))));
        uo = a1[s];
        vo = ((v[s] + p.dt * (dvc[s] + dvq)) / denv[s]) * mv[s];
      } else {
        const T V0 = p.sadourny ? hy[s] * a1[s] : a1[s];
        const T V1 = p.sadourny ? hy[s + 1] * a1[s + 1] : a1[s + 1];
        const T Vm0 = p.sadourny ? hy[s - RX] * a1[s - RX] : a1[s - RX];
        const T Vm1 = p.sadourny ? hy[s - RX + 1] * a1[s - RX + 1]
                                 : a1[s - RX + 1];
        const T duq = half * (q[s] * (half * (V0 + V1)) +
                              q[s - RX] * (half * (Vm0 + Vm1)));
        uo = ((u[s] + p.dt * (duc[s] + duq)) / denu[s]) * mu[s];
        vo = a1[s];
      }
      const long g = long(gj) * p.nx + gi;
      p.h1[g] = h1[s];
      p.u1[g] = uo;
      p.v1[g] = vo;
    }
  }
#undef REGION
}

template <typename T>
int launch(const Params<T>& p, cudaStream_t stream) {
  const int smem = int(N_PLANES * NPT * sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(
      fb_step_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return int(e);
  const dim3 grid((p.nx + TX - 1) / TX, (p.ny + TY - 1) / TY);
  fb_step_kernel<T><<<grid, THREADS, smem, stream>>>(p);
  return int(cudaGetLastError());
}

template <typename T>
int fb_step(const T* h, const T* u, const T* v, const T* H, const T* mask,
            const T* mask_u, const T* mask_v, const T* mask_q, const T* f_q,
            const T* taux, const T* tauy, T* h1, T* u1, T* v1, int ny,
            int nx, int u_first, int sadourny, int free_slip, int visc,
            int wind, double dt, double inv_dx, double inv_dy, double g,
            double nu2, double rho0, double h_min, double r_bot,
            void* stream) {
  Params<T> p{h,    u,   v,      H,       mask,  mask_u, mask_v,
              mask_q, f_q, taux, tauy,    h1,    u1,     v1,
              ny,   nx,  u_first, sadourny, free_slip, visc, wind,
              T(dt), T(inv_dx), T(inv_dy), T(g), T(nu2), T(rho0), T(h_min),
              T(r_bot)};
  return launch(p, static_cast<cudaStream_t>(stream));
}

}  // namespace

#define FB_STEP_ENTRY(NAME, T)                                              \
  extern "C" int NAME(                                                      \
      const T* h, const T* u, const T* v, const T* H, const T* mask,        \
      const T* mask_u, const T* mask_v, const T* mask_q, const T* f_q,      \
      const T* taux, const T* tauy, T* h1, T* u1, T* v1, int ny, int nx,    \
      int u_first, int sadourny, int free_slip, int visc, int wind,         \
      double dt, double inv_dx, double inv_dy, double g, double nu2,        \
      double rho0, double h_min, double r_bot, void* stream) {              \
    return fb_step<T>(h, u, v, H, mask, mask_u, mask_v, mask_q, f_q, taux,  \
                      tauy, h1, u1, v1, ny, nx, u_first, sadourny,          \
                      free_slip, visc, wind, dt, inv_dx, inv_dy, g, nu2,    \
                      rho0, h_min, r_bot, stream);                          \
  }

FB_STEP_ENTRY(beom_fb_step_f32, float)
FB_STEP_ENTRY(beom_fb_step_f64, double)

extern "C" const char* beom_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
