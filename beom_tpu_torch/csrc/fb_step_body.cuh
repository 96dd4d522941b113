// The stages of one fused forward-backward step on a haloed tile in shared
// memory, shared by the single-device step (fb_step.cu, K1) and the shard
// step under a mesh (shard_step.cu, K7).  The two kernels differ in where a
// tile's points come from and where its results go (shard_addr.cuh): each
// loads the planes of h, u, v, the masks and the block's table of offsets
// into the statics (stage S0) and hands `fb_stages` a Store3 whose Out says
// which interior points are written and where.
//
// Stage regions, as [lo, R - hi) on both axes of the R-point block, with
// LO = 1, or 2 under wet/dry (the limiter's scale reaches one cell more):
//   S1  lap(u), lap(v) for nu4               [1, R-1)
//       fluxes [0, R-1), scales [1, R-1)     (wet/dry only)
//       h1 (+ sponge, exterior clamp)        [LO, R-LO)
//   S2  phi = M + K, q                       [LO, R-LO-1)
//   S3  first Coriolis sweep (u1 or v1) with its tendencies, drag
//                                            [LO+1, R-LO-2)
//   S4  second sweep, wet/dry gates, Flather, on the interior [W, R-W):
//       it reads S3 on [W-1, R-W+1), so W = LO + 3: 4, or 5 under wet/dry.
//       The biharmonic reads lap on [W-1, R-W+1) and adds no width.

#pragma once

#include "shard_addr.cuh"

namespace beom {
namespace fbk {

constexpr int W = LO + 3;
constexpr int RX = TX + 2 * W;
constexpr int RY = TY + 2 * W;
constexpr int NPT = RX * RY;

// shared-memory planes (fluxes and scales alias phi, q and a1)
enum Plane {
  P_H = 0,
  P_U = NZ,
  P_V = 2 * NZ,
  P_M = 3 * NZ,
  P_MU,
  P_MV,
  P_MQ,
  P_H1,
  P_PHI = P_H1 + NZ,
  P_Q = P_PHI + NZ,
  P_A1 = P_Q + NZ,
  P_LU = P_A1 + NZ,
  P_LV = P_LU + (NU4 ? NZ : 0),
  P_EE = P_LV + (NU4 ? NZ : 0),
  N_PLANES = P_EE + (OBC ? 1 : 0)
};

template <typename T>
constexpr int smem_bytes() {
  return int(N_PLANES * NPT * sizeof(T) + NPT * sizeof(int));
}

// the step's h, u, v of a tile's interior points, written through an Out
template <typename T>
struct Store3 {
  T *h, *u, *v;
  Out o;
  __device__ __forceinline__ bool valid(int jj, int ii) const {
    return o.valid(jj, ii);
  }
  __device__ __forceinline__ void put(int jj, int ii, int k, T hv, T uv,
                                      T vv) const {
    const long g = k * o.plane + o.at(jj, ii);
    h[g] = hv;
    u[g] = uv;
    v[g] = vv;
  }
};

// S1 to S4 on the block whose planes of h, u, v and the masks (and ee under
// the open boundary) are loaded.  store.valid(jj, ii) says whether the
// interior point (jj, ii) of the tile is written; store.put(jj, ii, k, h, u,
// v) writes layer k of it.
template <typename T, typename Store>
__device__ __forceinline__ void fb_stages(const Params<T>& p, T* sm,
                                          const int* gidx,
                                          const Store& store) {
  T* h = sm + P_H * NPT;
  T* u = sm + P_U * NPT;
  T* v = sm + P_V * NPT;
  T* mask = sm + P_M * NPT;
  T* mu = sm + P_MU * NPT;
  T* mv = sm + P_MV * NPT;
  T* mq = sm + P_MQ * NPT;
  T* h1 = sm + P_H1 * NPT;
  T* phi = sm + P_PHI * NPT;
  T* q = sm + P_Q * NPT;
  T* a1 = sm + P_A1 * NPT;
  T* lu = sm + P_LU * NPT;
  T* lv = sm + P_LV * NPT;
  T* ee = sm + P_EE * NPT;
  const int tid = threadIdx.x;
  const Tile<T, RX, NPT> c{p, gidx, u, v, mask, mu, mv, mq, h1,
                           phi, q, lu, lv, ee};

  // S1: lap planes for the biharmonic, then the continuity
  if (NU4) {
    REGION_NS(1, 1, {
      for (int k = 0; k < NZ; ++k) {
        lu[k * NPT + s] = c.lap_u(u + k * NPT, s);
        lv[k * NPT + s] = c.lap_v(v + k * NPT, s);
      }
    })
  }
  continuity_stage<T, RX, RY>(c, h, u, v, h1, phi, q, a1, true);

  // S2: phi = M (+ K) and the PV from the new thickness
  REGION(LO, LO + 1, { c.phi_q(s, true, phi, q); })

  // S3: the first FB-Coriolis sweep, u on even steps, v on odd ones
  REGION(LO + 1, LO + 2, {
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

  // S4: the second sweep on the interior, the gates, Flather, write back
  for (int k_ = tid; k_ < TX * TY; k_ += THREADS) {
    const int jj = k_ / TX;
    const int ii = k_ % TX;
    if (!store.valid(jj, ii)) continue;
    const int s = (W + jj) * RX + W + ii;
    T uo[NZ], vo[NZ];
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
      if (p.u_first) {
        T b = v[k * NPT + s] +
              p.dt * (c.tend_v(k, s) + (-c.cor_v(k, s, a1 + k * NPT)));
        if (k == NZ - 1) b = b / (T(1) + p.dt * c.drag_v(s));
        uo[k] = a1[k * NPT + s];
        vo[k] = b * mv[s];
      } else {
        T b = u[k * NPT + s] +
              p.dt * (c.tend_u(k, s) + c.cor_u(k, s, a1 + k * NPT));
        if (k == NZ - 1) b = b / (T(1) + p.dt * c.drag_u(s));
        uo[k] = b * mu[s];
        vo[k] = a1[k * NPT + s];
      }
    }
    finalize_point<T, RX, NPT>(c, h1, s, uo, vo);
#pragma unroll
    for (int k = 0; k < NZ; ++k)
      store.put(jj, ii, k, h1[k * NPT + s], uo[k], vo[k]);
  }
}

}  // namespace fbk
}  // namespace beom
