// K3a and K3b: the two phases of a rigid-lid / implicit-free-surface step
// (stepping/projection.py) of a single layer, each fused into one launch.
//
// Replace beom_tpu/stencils/band.py::_band_kernel running the bodies
// body_a and body_b of
// beom_tpu/stencils/fused_projection.py::make_pallas_projection_stepper.
//
//   proj_a (K3a): the provisional momentum of fb.momentum_update with
//     free_surface=False (from the old h; for one layer the Montgomery
//     potential is then 0 and only K remains), then the barotropic
//     transport U, V = a_xp(h) u*, a_yp(h) v* (masked) and its
//     divergence div = (d_xm U + d_ym V) mask.
//   proj_b (K3b): u1 = (u* - corr mask_u d_xp p) mask_u (v1 likewise),
//     then continuity h1 = (h + dt dh(h, u1, v1)) mask; finalize is the
//     identity for the terms these kernels take.
//
// Bound: device-memory bytes, as K1 (csrc/fb_step.cu): ~120 flops per
// point against 10 fields read and 3 written (K3a), ~30 flops against 7
// read and 3 written (K3b).  The design keeps every intermediate in
// shared memory: one CTA per 2-D tile, loaded with a periodic halo on
// both axes that covers the phase's dependence cone, so a point costs
// one read of each operand and one write of each result.
//
// K3a's stages, as [lo, R - hi) on both axes of the R-point block (h is
// loaded, so there is no continuity stage before the momentum):
//   S1 hx, hy, phi = K (or 0), q, drag denominators  [1, R-1)
//   S2 du_c, dv_c (pressure, viscosity, wind)        [1, R-2)
//   S3 first Coriolis sweep (u* or v*)               [2, R-2)
//   S4 second sweep                                  [3, R-3)
//   S5 U, V, div on the interior                     [W, R-W), which
//      reads u*, v* one cell west and south: W = 4.
// K3b's: S1 u1, v1 on [0, R-1); S2 h1 on the interior [1, R-1): W = 1.
//
// Arithmetic mirrors the eager port op for op (stepping/fb.py,
// stepping/projection.py), the scalars rounded from the host's doubles,
// and --fmad=false, so the plain versions are matched bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 16;
constexpr int THREADS = 256;

__device__ __forceinline__ int wrap(int a, int n) {
  a %= n;
  return a < 0 ? a + n : a;
}

// jnp.maximum / torch.clamp_min: NaN propagates
template <typename T>
__device__ __forceinline__ T vmax(T a, T b) {
  return (a > b || a != a) ? a : b;
}

// loop over the square region [lo, R - hi) of an RX x RY block on both
// axes, then sync the CTA
#define REGION(RX_, RY_, lo, hi, ...)                               \
  {                                                                 \
    constexpr int nx_ = (RX_) - (lo) - (hi);                        \
    constexpr int ny_ = (RY_) - (lo) - (hi);                        \
    for (int k = threadIdx.x; k < nx_ * ny_; k += THREADS) {        \
      const int s = ((lo) + k / nx_) * (RX_) + (lo) + k % nx_;      \
      __VA_ARGS__                                                   \
    }                                                               \
  }                                                                 \
  __syncthreads();

// ---------------------------------------------------------------- K3a

namespace pa {

constexpr int W = 4;
constexpr int RX = TX + 2 * W;
constexpr int RY = TY + 2 * W;
constexpr int NPT = RX * RY;

enum Plane {
  P_H, P_U, P_V, P_M, P_MU, P_MV, P_MQ, P_FQ, P_TX, P_TY,
  P_HX, P_HY, P_PHI, P_Q, P_DENU, P_DENV, P_DUC, P_DVC, P_A1, P_A2,
  N_PLANES
};

template <typename T>
struct Params {
  const T *h, *u, *v, *mask, *mask_u, *mask_v, *mask_q, *f_q, *taux, *tauy;
  T *us, *vs, *div;
  int ny, nx;
  int u_first, sadourny, free_slip, visc, wind;
  T dt, inv_dx, inv_dy, nu2, rho0, h_min, r_bot;
};

template <typename T>
__global__ void __launch_bounds__(THREADS) kernel(const Params<T> p) {
  extern __shared__ unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* h = sm + P_H * NPT;
  T* u = sm + P_U * NPT;
  T* v = sm + P_V * NPT;
  T* mask = sm + P_M * NPT;
  T* mu = sm + P_MU * NPT;
  T* mv = sm + P_MV * NPT;
  T* mq = sm + P_MQ * NPT;
  T* fq = sm + P_FQ * NPT;
  T* tx = sm + P_TX * NPT;
  T* ty = sm + P_TY * NPT;
  T* hx = sm + P_HX * NPT;
  T* hy = sm + P_HY * NPT;
  T* phi = sm + P_PHI * NPT;
  T* q = sm + P_Q * NPT;
  T* denu = sm + P_DENU * NPT;
  T* denv = sm + P_DENV * NPT;
  T* duc = sm + P_DUC * NPT;
  T* dvc = sm + P_DVC * NPT;
  T* a1 = sm + P_A1 * NPT;
  T* a2 = sm + P_A2 * NPT;

  const T half = T(0.5);
  const T one = T(1.0);
  const int x0 = blockIdx.x * TX - W;
  const int y0 = blockIdx.y * TY - W;

  // S0: the haloed block, periodic on both axes
  for (int s = threadIdx.x; s < NPT; s += THREADS) {
    const int gj = wrap(y0 + s / RX, p.ny);
    const int gi = wrap(x0 + s % RX, p.nx);
    const long g = long(gj) * p.nx + gi;
    h[s] = p.h[g];
    u[s] = p.u[g];
    v[s] = p.v[g];
    mask[s] = p.mask[g];
    mu[s] = p.mask_u[g];
    mv[s] = p.mask_v[g];
    mq[s] = p.mask_q[g];
    fq[s] = p.f_q[g];
    tx[s] = p.taux[g];
    ty[s] = p.tauy[g];
  }
  __syncthreads();

  // S1: face thicknesses, phi = M (0 without the surface term) + K, PV,
  // implicit-drag denominators
  REGION(RX, RY, 1, 1, {
    const T hxs = half * (h[s] + h[s + 1]);
    const T hys = half * (h[s] + h[s + RX]);
    hx[s] = hxs;
    hy[s] = hys;
    T ph = T(0);
    if (p.sadourny) {
      const T ke = half * (half * (u[s] * u[s] + u[s - 1] * u[s - 1]) +
                           half * (v[s] * v[s] + v[s - RX] * v[s - RX]));
      ph = ph + ke;
      const T zeta = ((v[s + 1] - v[s]) * p.inv_dx -
                      (u[s + RX] - u[s]) * p.inv_dy) * mq[s];
      const T hq = vmax(
          half * (hys + half * (h[s + 1] + h[s + 1 + RX])), p.h_min);
      q[s] = (fq[s] + zeta) / hq;
    } else {
      q[s] = fq[s];
    }
    phi[s] = ph;
    denu[s] = one + p.dt * (p.r_bot / vmax(hxs, p.h_min));
    denv[s] = one + p.dt * (p.r_bot / vmax(hys, p.h_min));
  })

  // S2: -grad(phi) + nu2 lap + wind, at u and v points
  REGION(RX, RY, 1, 2, {
    T du = -((phi[s + 1] - phi[s]) * p.inv_dx);
    T dv = -((phi[s + RX] - phi[s]) * p.inv_dy);
    if (p.visc) {
      const T gx1 = ((u[s + 1] - u[s]) * p.inv_dx) * mask[s + 1];
      const T gx0 = ((u[s] - u[s - 1]) * p.inv_dx) * mask[s];
      T gy0 = (u[s + RX] - u[s]) * p.inv_dy;
      T gym = (u[s] - u[s - RX]) * p.inv_dy;
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

  // S3: the first FB-Coriolis sweep, u on even steps, v on odd ones
  if (p.u_first) {
    REGION(RX, RY, 2, 2, {
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
    REGION(RX, RY, 2, 2, {
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

  // S4: the second sweep, from the first one's result
  if (p.u_first) {
    REGION(RX, RY, 3, 3, {
      const T U0 = p.sadourny ? hx[s] * a1[s] : a1[s];
      const T U1 = p.sadourny ? hx[s + RX] * a1[s + RX] : a1[s + RX];
      const T Um0 = p.sadourny ? hx[s - 1] * a1[s - 1] : a1[s - 1];
      const T Um1 = p.sadourny ? hx[s - 1 + RX] * a1[s - 1 + RX]
                               : a1[s - 1 + RX];
      const T dvq = -(half * (q[s] * (half * (U0 + U1)) +
                              q[s - 1] * (half * (Um0 + Um1))));
      a2[s] = ((v[s] + p.dt * (dvc[s] + dvq)) / denv[s]) * mv[s];
    })
  } else {
    REGION(RX, RY, 3, 3, {
      const T V0 = p.sadourny ? hy[s] * a1[s] : a1[s];
      const T V1 = p.sadourny ? hy[s + 1] * a1[s + 1] : a1[s + 1];
      const T Vm0 = p.sadourny ? hy[s - RX] * a1[s - RX] : a1[s - RX];
      const T Vm1 = p.sadourny ? hy[s - RX + 1] * a1[s - RX + 1]
                               : a1[s - RX + 1];
      const T duq = half * (q[s] * (half * (V0 + V1)) +
                            q[s - RX] * (half * (Vm0 + Vm1)));
      a2[s] = ((u[s] + p.dt * (duc[s] + duq)) / denu[s]) * mu[s];
    })
  }

  // S5: transport divergence on the interior; write u*, v*, div
  const T* us = p.u_first ? a1 : a2;
  const T* vs = p.u_first ? a2 : a1;
  for (int k = threadIdx.x; k < TX * TY; k += THREADS) {
    const int jj = k / TX;
    const int ii = k % TX;
    const int gj = blockIdx.y * TY + jj;
    const int gi = blockIdx.x * TX + ii;
    if (gj >= p.ny || gi >= p.nx) continue;
    const int s = (W + jj) * RX + W + ii;
    const T U = (hx[s] * us[s]) * mu[s];
    const T Uw = (hx[s - 1] * us[s - 1]) * mu[s - 1];
    const T V = (hy[s] * vs[s]) * mv[s];
    const T Vs = (hy[s - RX] * vs[s - RX]) * mv[s - RX];
    const long g = long(gj) * p.nx + gi;
    p.us[g] = us[s];
    p.vs[g] = vs[s];
    p.div[g] = ((U - Uw) * p.inv_dx + (V - Vs) * p.inv_dy) * mask[s];
  }
}

}  // namespace pa

// ---------------------------------------------------------------- K3b

namespace pb {

constexpr int W = 1;
constexpr int RX = TX + 2 * W;
constexpr int RY = TY + 2 * W;
constexpr int NPT = RX * RY;

enum Plane { P_H, P_US, P_VS, P_P, P_M, P_MU, P_MV, P_U1, P_V1, N_PLANES };

template <typename T>
struct Params {
  const T *h, *us, *vs, *pr, *mask, *mask_u, *mask_v;
  T *h1, *u1, *v1;
  int ny, nx;
  T dt, inv_dx, inv_dy, corr;
};

template <typename T>
__global__ void __launch_bounds__(THREADS) kernel(const Params<T> p) {
  extern __shared__ unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* h = sm + P_H * NPT;
  T* us = sm + P_US * NPT;
  T* vs = sm + P_VS * NPT;
  T* pr = sm + P_P * NPT;
  T* mask = sm + P_M * NPT;
  T* mu = sm + P_MU * NPT;
  T* mv = sm + P_MV * NPT;
  T* u1 = sm + P_U1 * NPT;
  T* v1 = sm + P_V1 * NPT;

  const T half = T(0.5);
  const int x0 = blockIdx.x * TX - W;
  const int y0 = blockIdx.y * TY - W;

  for (int s = threadIdx.x; s < NPT; s += THREADS) {
    const int gj = wrap(y0 + s / RX, p.ny);
    const int gi = wrap(x0 + s % RX, p.nx);
    const long g = long(gj) * p.nx + gi;
    h[s] = p.h[g];
    us[s] = p.us[g];
    vs[s] = p.vs[g];
    pr[s] = p.pr[g];
    mask[s] = p.mask[g];
    mu[s] = p.mask_u[g];
    mv[s] = p.mask_v[g];
  }
  __syncthreads();

  // S1: the barotropic correction, the same in every layer
  REGION(RX, RY, 0, 1, {
    const T dpx = mu[s] * ((pr[s + 1] - pr[s]) * p.inv_dx);
    const T dpy = mv[s] * ((pr[s + RX] - pr[s]) * p.inv_dy);
    u1[s] = (us[s] - p.corr * dpx) * mu[s];
    v1[s] = (vs[s] - p.corr * dpy) * mv[s];
  })

  // S2: continuity with the corrected velocities; write h1, u1, v1
  for (int k = threadIdx.x; k < TX * TY; k += THREADS) {
    const int jj = k / TX;
    const int ii = k % TX;
    const int gj = blockIdx.y * TY + jj;
    const int gi = blockIdx.x * TX + ii;
    if (gj >= p.ny || gi >= p.nx) continue;
    const int s = (W + jj) * RX + W + ii;
    const T fx = mu[s] * (half * (h[s] + h[s + 1])) * u1[s];
    const T fxm = mu[s - 1] * (half * (h[s - 1] + h[s])) * u1[s - 1];
    const T fy = mv[s] * (half * (h[s] + h[s + RX])) * v1[s];
    const T fym = mv[s - RX] * (half * (h[s - RX] + h[s])) * v1[s - RX];
    const T dh = -((fx - fxm) * p.inv_dx + (fy - fym) * p.inv_dy) * mask[s];
    const long g = long(gj) * p.nx + gi;
    p.h1[g] = (h[s] + p.dt * dh) * mask[s];
    p.u1[g] = u1[s];
    p.v1[g] = v1[s];
  }
}

}  // namespace pb

#undef REGION

template <typename K, typename P>
int launch(K kernel, const P& p, int n_planes, size_t elem, int rx, int ry,
           cudaStream_t stream) {
  const int smem = int(n_planes * rx * ry * elem);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return int(e);
  const dim3 grid((p.nx + TX - 1) / TX, (p.ny + TY - 1) / TY);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return int(cudaGetLastError());
}

template <typename T>
int proj_a(const T* h, const T* u, const T* v, const T* mask,
           const T* mask_u, const T* mask_v, const T* mask_q, const T* f_q,
           const T* taux, const T* tauy, T* us, T* vs, T* div, int ny,
           int nx, int u_first, int sadourny, int free_slip, int visc,
           int wind, double dt, double inv_dx, double inv_dy, double nu2,
           double rho0, double h_min, double r_bot, void* stream) {
  pa::Params<T> p{h,      u,    v,      mask,     mask_u,    mask_v, mask_q,
                  f_q,    taux, tauy,   us,       vs,        div,    ny,
                  nx,     u_first, sadourny, free_slip, visc, wind,
                  T(dt),  T(inv_dx), T(inv_dy), T(nu2), T(rho0), T(h_min),
                  T(r_bot)};
  return launch(pa::kernel<T>, p, pa::N_PLANES, sizeof(T), pa::RX, pa::RY,
                static_cast<cudaStream_t>(stream));
}

template <typename T>
int proj_b(const T* h, const T* us, const T* vs, const T* pr, const T* mask,
           const T* mask_u, const T* mask_v, T* h1, T* u1, T* v1, int ny,
           int nx, double dt, double inv_dx, double inv_dy, double corr,
           void* stream) {
  pb::Params<T> p{h,  us, vs, pr,    mask,      mask_u,    mask_v, h1,
                  u1, v1, ny, nx, T(dt), T(inv_dx), T(inv_dy), T(corr)};
  return launch(pb::kernel<T>, p, pb::N_PLANES, sizeof(T), pb::RX, pb::RY,
                static_cast<cudaStream_t>(stream));
}

}  // namespace

#define PROJ_ENTRY(NAME_A, NAME_B, T)                                        \
  extern "C" int NAME_A(                                                     \
      const T* h, const T* u, const T* v, const T* mask, const T* mask_u,    \
      const T* mask_v, const T* mask_q, const T* f_q, const T* taux,         \
      const T* tauy, T* us, T* vs, T* div, int ny, int nx, int u_first,      \
      int sadourny, int free_slip, int visc, int wind, double dt,            \
      double inv_dx, double inv_dy, double nu2, double rho0, double h_min,   \
      double r_bot, void* stream) {                                          \
    return proj_a<T>(h, u, v, mask, mask_u, mask_v, mask_q, f_q, taux, tauy, \
                     us, vs, div, ny, nx, u_first, sadourny, free_slip,      \
                     visc, wind, dt, inv_dx, inv_dy, nu2, rho0, h_min,       \
                     r_bot, stream);                                         \
  }                                                                          \
  extern "C" int NAME_B(const T* h, const T* us, const T* vs, const T* pr,   \
                        const T* mask, const T* mask_u, const T* mask_v,     \
                        T* h1, T* u1, T* v1, int ny, int nx, double dt,      \
                        double inv_dx, double inv_dy, double corr,           \
                        void* stream) {                                      \
    return proj_b<T>(h, us, vs, pr, mask, mask_u, mask_v, h1, u1, v1, ny,    \
                     nx, dt, inv_dx, inv_dy, corr, stream);                  \
  }

PROJ_ENTRY(beom_proj_a_f32, beom_proj_b_f32, float)
PROJ_ENTRY(beom_proj_a_f64, beom_proj_b_f64, double)

extern "C" const char* beom_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
