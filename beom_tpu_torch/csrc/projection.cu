// K3a and K3b: the two phases of a rigid-lid / implicit-free-surface step
// (stepping/projection.py) of nz layers with every term of the eager step,
// each fused into one launch.
//
// Replace beom_tpu/stencils/band.py::_band_kernel running the bodies
// body_a and body_b of
// beom_tpu/stencils/fused_projection.py::make_pallas_projection_stepper.
//
//   proj_a (K3a): the provisional momentum of fb.momentum_update with
//     free_surface=False from the old thickness (the Montgomery potential
//     without its surface term, K, PV, viscosity and biharmonic, wind,
//     interfacial and bottom drag, sponge), then the barotropic transport
//     U, V = sum_k a_xp(h_k) u*_k, sum_k a_yp(h_k) v*_k (masked) and its
//     divergence div = (d_xm U + d_ym V) mask.
//   proj_b (K3b): u1 = (u* - corr mask_u d_xp p) mask_u (v1 likewise, the
//     same correction in every layer), the per-layer continuity
//     h1 = (h + dt dh(h, u1, v1)) mask with the wet/dry limiter, then
//     fb.finalize: the wet/dry gates and Flather with the tides at t + dt.
//
// The term code is that of the fused forward-backward step
// (fb_terms.cuh), under the same compile-time switches: one build per
// combination of layer count, terms and tile.
//
// Bound: device-memory bytes, as K1 (csrc/fb_step.cu).  K3a reads
// 3 nz + 7 fields (plus the sponge) and writes 2 nz + 1; K3b reads
// 3 nz + 4 (plus H and the open-boundary and tide operands) and writes
// 3 nz.  Every intermediate stays in shared memory: one CTA per 2-D tile,
// loaded with a periodic halo on both axes that covers the phase's
// dependence cone, so a point costs one read of each operand and one
// write of each result.  Phase A stores nothing it can recompute: like
// K1 it keeps phi, q and the two sweeps as planes and evaluates the
// tendencies where they are used.
//
// K3a's stages, as [lo, R - hi) on both axes of the R-point block (h is
// loaded, so there is no continuity stage before the momentum):
//   S1 lap(u), lap(v) for nu4; phi = M + K, q        [1, R-1)
//   S2 first Coriolis sweep with its tendencies, drag [2, R-2)
//   S3 second sweep                                   [3, R-3)
//   S4 U, V, div on the interior                      [W, R-W), which
//      reads u*, v* one cell west and south: W = 4.
// K3b's: S1 u1, v1 on [0, R-1); S2 h1 on [LO, R-LO); S3 gates and Flather
// on the interior, which reads h1 one cell east and north: W = LO + 1, or
// 1 when neither wet/dry nor the open boundary is on (finalize is then the
// identity).

#include "fb_terms.cuh"

namespace {

using namespace beom;

// ---------------------------------------------------------------- K3a
namespace pa {

constexpr int W = 4;
constexpr int RX = TX + 2 * W;
constexpr int RY = TY + 2 * W;
constexpr int NPT = RX * RY;
enum Plane {
  P_H = 0,
  P_U = NZ,
  P_V = 2 * NZ,
  P_M = 3 * NZ,
  P_MU,
  P_MV,
  P_MQ,
  P_PHI,
  P_Q = P_PHI + NZ,
  P_A1 = P_Q + NZ,
  P_A2 = P_A1 + NZ,
  P_LU = P_A2 + NZ,
  P_LV = P_LU + (NU4 ? NZ : 0),
  N_PLANES = P_LV + (NU4 ? NZ : 0)
};

template <typename T>
constexpr int smem_bytes() {
  return int(N_PLANES * NPT * sizeof(T) + NPT * sizeof(int));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
kernel(const Params<T> p, T* out_us, T* out_vs, T* out_div) {
  extern __shared__ unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  int* gidx = reinterpret_cast<int*>(sm + N_PLANES * NPT);
  T* h = sm + P_H * NPT;
  T* u = sm + P_U * NPT;
  T* v = sm + P_V * NPT;
  T* mask = sm + P_M * NPT;
  T* mu = sm + P_MU * NPT;
  T* mv = sm + P_MV * NPT;
  T* mq = sm + P_MQ * NPT;
  T* phi = sm + P_PHI * NPT;
  T* q = sm + P_Q * NPT;
  T* a1 = sm + P_A1 * NPT;
  T* a2 = sm + P_A2 * NPT;
  T* lu = sm + P_LU * NPT;
  T* lv = sm + P_LV * NPT;
  const int tid = threadIdx.x;

  load_offsets<T, RX, RY, W>(p, gidx);
  __syncthreads();
  for (int s = tid; s < NPT; s += THREADS) {
    const int g = gidx[s];
    for (int k = 0; k < NZ; ++k) {
      h[k * NPT + s] = p.in[I_H][k * p.plane + g];
      u[k * NPT + s] = p.in[I_U][k * p.plane + g];
      v[k * NPT + s] = p.in[I_V][k * p.plane + g];
    }
    mask[s] = p.in[I_MASK][g];
    mu[s] = p.in[I_MASK_U][g];
    mv[s] = p.in[I_MASK_V][g];
    mq[s] = p.in[I_MASK_Q][g];
  }
  __syncthreads();

  const Tile<T, RX, NPT> c{p, gidx, u, v, mask, mu, mv, mq, h,
                           phi, q, lu, lv, nullptr};

  // S1: lap planes for the biharmonic; phi = M (no surface term) + K, PV
  if (NU4) {
    REGION_NS(1, 1, {
      for (int k = 0; k < NZ; ++k) {
        lu[k * NPT + s] = c.lap_u(u + k * NPT, s);
        lv[k * NPT + s] = c.lap_v(v + k * NPT, s);
      }
    })
  }
  REGION(1, 1, { c.phi_q(s, false, phi, q); })

  // S2: the first FB-Coriolis sweep, u on even steps, v on odd ones
  REGION(2, 2, {
    for (int k = 0; k < NZ; ++k) {
      T a;
      if (p.u_first) {
        a = u[k * NPT + s] +
            p.dt * (c.tend_u(k, s) + c.cor_u(k, s, v + k * NPT));
        if (k == NZ - 1) a = a / (T(1) + p.dt * c.drag_u(s));
        a = a * mu[s];
      } else {
        a = v[k * NPT + s] +
            p.dt * (c.tend_v(k, s) + (-c.cor_v(k, s, u + k * NPT)));
        if (k == NZ - 1) a = a / (T(1) + p.dt * c.drag_v(s));
        a = a * mv[s];
      }
      a1[k * NPT + s] = a;
    }
  })

  // S3: the second sweep, from the first one's result
  REGION(3, 3, {
    for (int k = 0; k < NZ; ++k) {
      T b;
      if (p.u_first) {
        b = v[k * NPT + s] +
            p.dt * (c.tend_v(k, s) + (-c.cor_v(k, s, a1 + k * NPT)));
        if (k == NZ - 1) b = b / (T(1) + p.dt * c.drag_v(s));
        b = b * mv[s];
      } else {
        b = u[k * NPT + s] +
            p.dt * (c.tend_u(k, s) + c.cor_u(k, s, a1 + k * NPT));
        if (k == NZ - 1) b = b / (T(1) + p.dt * c.drag_u(s));
        b = b * mu[s];
      }
      a2[k * NPT + s] = b;
    }
  })

  // S4: transport divergence on the interior; write u*, v*, div
  const T* us = p.u_first ? a1 : a2;
  const T* vs = p.u_first ? a2 : a1;
  for (int k_ = tid; k_ < TX * TY; k_ += THREADS) {
    const int jj = k_ / TX;
    const int ii = k_ % TX;
    const int gj = blockIdx.y * TY + jj;
    const int gi = blockIdx.x * TX + ii;
    if (gj >= p.ny || gi >= p.nx) continue;
    const int s = (W + jj) * RX + W + ii;
    const long g = long(gj) * p.nx + gi;
    T U, Uw, V, Vs;
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
      const T* uk = us + k * NPT;
      const T* vk = vs + k * NPT;
      const T a = c.hx(k, s) * uk[s];
      const T aw = c.hx(k, s - 1) * uk[s - 1];
      const T b = c.hy(k, s) * vk[s];
      const T bs = c.hy(k, s - RX) * vk[s - RX];
      U = (k > 0) ? U + a : a;
      Uw = (k > 0) ? Uw + aw : aw;
      V = (k > 0) ? V + b : b;
      Vs = (k > 0) ? Vs + bs : bs;
      out_us[k * p.plane + g] = uk[s];
      out_vs[k * p.plane + g] = vk[s];
    }
    U = U * mu[s];
    Uw = Uw * mu[s - 1];
    V = V * mv[s];
    Vs = Vs * mv[s - RX];
    out_div[g] = ((U - Uw) * p.inv_dx + (V - Vs) * p.inv_dy) * mask[s];
  }
}

}  // namespace pa

// ---------------------------------------------------------------- K3b
namespace pb {

constexpr int W = (WETDRY || OBC) ? LO + 1 : 1;
constexpr int RX = TX + 2 * W;
constexpr int RY = TY + 2 * W;
constexpr int NPT = RX * RY;
enum Plane {
  P_H = 0,
  P_UA = NZ,
  P_VA = 2 * NZ,
  P_P = 3 * NZ,
  P_M,
  P_MU,
  P_MV,
  P_H1,
  P_FX = P_H1 + NZ,
  P_FY = P_FX + (WETDRY ? NZ : 0),
  P_SC = P_FY + (WETDRY ? NZ : 0),
  P_EE = P_SC + (WETDRY ? NZ : 0),
  N_PLANES = P_EE + (OBC ? 1 : 0)
};

template <typename T>
constexpr int smem_bytes() {
  return int(N_PLANES * NPT * sizeof(T) + NPT * sizeof(int));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
kernel(const Params<T> p, const T* pres, T corr, T* out_h, T* out_u,
       T* out_v) {
  extern __shared__ unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  int* gidx = reinterpret_cast<int*>(sm + N_PLANES * NPT);
  T* h = sm + P_H * NPT;
  T* ua = sm + P_UA * NPT;
  T* va = sm + P_VA * NPT;
  T* pr = sm + P_P * NPT;
  T* mask = sm + P_M * NPT;
  T* mu = sm + P_MU * NPT;
  T* mv = sm + P_MV * NPT;
  T* h1 = sm + P_H1 * NPT;
  T* fx = sm + P_FX * NPT;
  T* fy = sm + P_FY * NPT;
  T* sc = sm + P_SC * NPT;
  T* ee = sm + P_EE * NPT;
  const int tid = threadIdx.x;

  load_offsets<T, RX, RY, W>(p, gidx);
  __syncthreads();
  for (int s = tid; s < NPT; s += THREADS) {
    const int g = gidx[s];
    for (int k = 0; k < NZ; ++k) {
      h[k * NPT + s] = p.in[I_H][k * p.plane + g];
      ua[k * NPT + s] = p.in[I_U][k * p.plane + g];
      va[k * NPT + s] = p.in[I_V][k * p.plane + g];
    }
    pr[s] = pres[g];
    mask[s] = p.in[I_MASK][g];
    mu[s] = p.in[I_MASK_U][g];
    mv[s] = p.in[I_MASK_V][g];
  }
  if (OBC) load_eta_ext<T, NPT>(p, gidx, ee);
  __syncthreads();

  // S1: the barotropic correction, the same in every layer, in place
  REGION(0, 1, {
    const T dpx = mu[s] * ((pr[s + 1] - pr[s]) * p.inv_dx);
    const T dpy = mv[s] * ((pr[s + RX] - pr[s]) * p.inv_dy);
    for (int k = 0; k < NZ; ++k) {
      ua[k * NPT + s] = (ua[k * NPT + s] - corr * dpx) * mu[s];
      va[k * NPT + s] = (va[k * NPT + s] - corr * dpy) * mv[s];
    }
  })

  // S2: the layer continuity with the corrected velocities
  const Tile<T, RX, NPT> c{p, gidx, ua, va, mask, mu, mv, nullptr, h1,
                           nullptr, nullptr, nullptr, nullptr, ee};
  continuity_stage<T, RX, RY>(c, h, ua, va, h1, fx, fy, sc, false);

  // S3: the gates and Flather on the interior; write h1, u1, v1
  for (int k_ = tid; k_ < TX * TY; k_ += THREADS) {
    const int jj = k_ / TX;
    const int ii = k_ % TX;
    const int gj = blockIdx.y * TY + jj;
    const int gi = blockIdx.x * TX + ii;
    if (gj >= p.ny || gi >= p.nx) continue;
    const int s = (W + jj) * RX + W + ii;
    const long g = long(gj) * p.nx + gi;
    T uo[NZ], vo[NZ];
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
      uo[k] = ua[k * NPT + s];
      vo[k] = va[k * NPT + s];
    }
    finalize_point<T, RX, NPT>(c, h1, s, uo, vo);
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
      out_h[k * p.plane + g] = h1[k * NPT + s];
      out_u[k * p.plane + g] = uo[k];
      out_v[k * p.plane + g] = vo[k];
    }
  }
}

}  // namespace pb

template <typename T>
int proj_a(const void* const* ptrs, const int* ints, const double* dbls,
           void* us, void* vs, void* div, void* stream) {
  const Params<T> p = make_params<T>(ptrs, ints, dbls);
  constexpr int smem = pa::smem_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(
      pa::kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return int(e);
  const dim3 grid((p.nx + TX - 1) / TX, (p.ny + TY - 1) / TY);
  pa::kernel<T><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<T*>(us), static_cast<T*>(vs), static_cast<T*>(div));
  return int(cudaGetLastError());
}

template <typename T>
int proj_b(const void* const* ptrs, const int* ints, const double* dbls,
           const void* pres, double corr, void* h1, void* u1, void* v1,
           void* stream) {
  const Params<T> p = make_params<T>(ptrs, ints, dbls);
  constexpr int smem = pb::smem_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(
      pb::kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return int(e);
  const dim3 grid((p.nx + TX - 1) / TX, (p.ny + TY - 1) / TY);
  pb::kernel<T><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const T*>(pres), T(corr), static_cast<T*>(h1),
      static_cast<T*>(u1), static_cast<T*>(v1));
  return int(cudaGetLastError());
}

}  // namespace

#define PROJ_ENTRIES(SUFFIX, T)                                              \
  extern "C" int beom_proj_a_##SUFFIX(                                       \
      const void* const* ptrs, const int* ints, const double* dbls,          \
      void* us, void* vs, void* div, void* stream) {                         \
    return proj_a<T>(ptrs, ints, dbls, us, vs, div, stream);                 \
  }                                                                          \
  extern "C" int beom_proj_b_##SUFFIX(                                       \
      const void* const* ptrs, const int* ints, const double* dbls,          \
      const void* pres, double corr, void* h1, void* u1, void* v1,           \
      void* stream) {                                                        \
    return proj_b<T>(ptrs, ints, dbls, pres, corr, h1, u1, v1, stream);      \
  }

PROJ_ENTRIES(f32, float)
PROJ_ENTRIES(f64, double)

// dynamic shared memory of one CTA of proj_a (0) and proj_b (1), for the
// wrapper's choice of tile
extern "C" int beom_smem_bytes(int which, int is_f64) {
  if (which == 0)
    return is_f64 ? pa::smem_bytes<double>() : pa::smem_bytes<float>();
  return is_f64 ? pb::smem_bytes<double>() : pb::smem_bytes<float>();
}

extern "C" const char* beom_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
