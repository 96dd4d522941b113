// The stage bodies of the two phases of a rigid-lid / implicit-free-surface
// step, shared by the single-device kernels (projection.cu, K3a and K3b)
// and the phases on the shards of a device mesh (shard_projection.cu, K7
// around the projection bodies).  Each body takes a source
// (shard_addr.cuh: where the tile's haloed points come from) and an Out
// (which interior points are written, and where); the arithmetic is the
// same for both, so a shard's result equals the single-device kernel's on
// the same points bit for bit.  projection.cu describes the stages.

#pragma once

#include "shard_addr.cuh"

namespace beom {
namespace prj {

// the source fields: phase A reads h, u, v; phase B h, u*, v* and p
enum In { F_H, F_U, F_V, F_P, N_IN_A = F_P, N_IN_B };

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

template <typename T, typename Src>
__device__ __forceinline__ void run(const Params<T>& p, const Src& src,
                                    const Out& o, T* out_us, T* out_vs,
                                    T* out_div) {
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

  const int x0 = o.x0 - W;
  const int y0 = o.y0 - W;
  for (int s = tid; s < NPT; s += THREADS) {
    const Loc l = src.at(y0 + s / RX, x0 + s % RX);
    gidx[s] = l.stat;
    const T* hn = src.template ptr<F_H>(l);
    const T* un = src.template ptr<F_U>(l);
    const T* vn = src.template ptr<F_V>(l);
    for (int k = 0; k < NZ; ++k) {
      h[k * NPT + s] = hn[k * src.plane];
      u[k * NPT + s] = un[k * src.plane];
      v[k * NPT + s] = vn[k * src.plane];
    }
    mask[s] = p.in[I_MASK][l.stat];
    mu[s] = p.in[I_MASK_U][l.stat];
    mv[s] = p.in[I_MASK_V][l.stat];
    mq[s] = p.in[I_MASK_Q][l.stat];
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
    if (!o.valid(jj, ii)) continue;
    const int s = (W + jj) * RX + W + ii;
    const long g = o.at(jj, ii);
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
      out_us[k * o.plane + g] = uk[s];
      out_vs[k * o.plane + g] = vk[s];
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

template <typename T, typename Src>
__device__ __forceinline__ void run(const Params<T>& p, const Src& src,
                                    const Out& o, T corr, T* out_h, T* out_u,
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

  const int x0 = o.x0 - W;
  const int y0 = o.y0 - W;
  for (int s = tid; s < NPT; s += THREADS) {
    const Loc l = src.at(y0 + s / RX, x0 + s % RX);
    gidx[s] = l.stat;
    const T* hn = src.template ptr<F_H>(l);
    const T* un = src.template ptr<F_U>(l);
    const T* vn = src.template ptr<F_V>(l);
    for (int k = 0; k < NZ; ++k) {
      h[k * NPT + s] = hn[k * src.plane];
      ua[k * NPT + s] = un[k * src.plane];
      va[k * NPT + s] = vn[k * src.plane];
    }
    pr[s] = src.template get<F_P>(0, l);
    mask[s] = p.in[I_MASK][l.stat];
    mu[s] = p.in[I_MASK_U][l.stat];
    mv[s] = p.in[I_MASK_V][l.stat];
  }
  // load_eta_ext visits the points this thread loaded
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
    if (!o.valid(jj, ii)) continue;
    const int s = (W + jj) * RX + W + ii;
    const long g = o.at(jj, ii);
    T uo[NZ], vo[NZ];
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
      uo[k] = ua[k * NPT + s];
      vo[k] = va[k * NPT + s];
    }
    finalize_point<T, RX, NPT>(c, h1, s, uo, vo);
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
      out_h[k * o.plane + g] = h1[k * NPT + s];
      out_u[k * o.plane + g] = uo[k];
      out_v[k * o.plane + g] = vo[k];
    }
  }
}

}  // namespace pb

}  // namespace prj
}  // namespace beom
