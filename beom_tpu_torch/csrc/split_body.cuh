// The stage bodies of the split step's three kernels (slow phase, barotropic
// subcycle, recomposition with fb.finalize), shared by the single-device
// step (split_step.cu, K1s) and the step on the shards of a device mesh
// (shard_split.cu, K7 around the split body).  Each body takes a source
// (shard_addr.cuh: where the tile's haloed points come from) and an Out
// (which interior points are written, and where); the arithmetic is the
// same for both, so a shard's result equals the single-device kernel's on
// the same points bit for bit.  split_step.cu says why three kernels and
// not one.

#pragma once

#include "shard_addr.cuh"

namespace beom {
namespace spk {

// outputs of the slow phase (SlowPhase's fields; cu and cv hold the bottom
// layer only, the others are zero) and of the subcycle
enum Slow {
  S_UP, S_VP, S_DUP, S_DVP, S_DUBAR, S_DVBAR, S_UBAR, S_VBAR, S_HU, S_HV,
  S_ETA0, S_CU, S_CV, N_SLOW
};
enum Sub { B_ETA, B_UB, B_VB, B_UAVG, B_VAVG, N_SUB };
// the source fields of each kernel: the slow phase reads h, u, v; the
// subcycle the slow phase's fields; the recomposition h, the slow phase's
// and the subcycle's fields
enum SlowIn { D_H, D_U, D_V, N_SLOW_IN };
enum RecIn {
  R_H = 0, R_SP = 1, R_SB = R_SP + N_SLOW, N_REC_IN = R_SB + N_SUB
};

template <typename T, int N>
struct Ptrs {
  T* p[N];
};

// ---------------------------------------------------------------- slow phase
namespace slow {

constexpr int W = 2;
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
  P_LU = P_Q + NZ,
  P_LV = P_LU + (NU4 ? NZ : 0),
  N_PLANES = P_LV + (NU4 ? NZ : 0)
};

template <typename T>
constexpr int smem_bytes() {
  return int(N_PLANES * NPT * sizeof(T) + NPT * sizeof(int));
}

// Stage regions: phi, q (and lap for nu4) on [1, R-1); the tendencies with
// the PV cross terms on the interior [2, R-2).
template <typename T, typename Src>
__device__ __forceinline__ void run(const Params<T>& p, const Src& src,
                                    const Ptrs<T, N_SLOW>& out,
                                    const Out& o) {
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
  T* lu = sm + P_LU * NPT;
  T* lv = sm + P_LV * NPT;
  const int tid = threadIdx.x;

  const int x0 = o.x0 - W;
  const int y0 = o.y0 - W;
  for (int s = tid; s < NPT; s += THREADS) {
    const Loc l = src.at(y0 + s / RX, x0 + s % RX);
    gidx[s] = l.stat;
    const T* hn = src.template ptr<D_H>(l);
    const T* un = src.template ptr<D_U>(l);
    const T* vn = src.template ptr<D_V>(l);
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
  if (NU4) {
    REGION_NS(1, 1, {
      for (int k = 0; k < NZ; ++k) {
        lu[k * NPT + s] = c.lap_u(u + k * NPT, s);
        lv[k * NPT + s] = c.lap_v(v + k * NPT, s);
      }
    })
  }
  REGION(1, 1, { c.phi_q(s, false, phi, q); })

  for (int k_ = tid; k_ < TX * TY; k_ += THREADS) {
    const int jj = k_ / TX;
    const int ii = k_ % TX;
    if (!o.valid(jj, ii)) continue;
    const int s = (W + jj) * RX + W + ii;
    const long g = o.at(jj, ii);
    T hu[NZ], hv[NZ], dus[NZ], dvs[NZ];
    T Hu, Hv, nu_, nv_, hs;
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
      hu[k] = c.hx(k, s) * mu[s];
      hv[k] = c.hy(k, s) * mv[s];
      const T uu = hu[k] * u[k * NPT + s];
      const T vv = hv[k] * v[k * NPT + s];
      Hu = (k > 0) ? Hu + hu[k] : hu[k];
      Hv = (k > 0) ? Hv + hv[k] : hv[k];
      nu_ = (k > 0) ? nu_ + uu : uu;
      nv_ = (k > 0) ? nv_ + vv : vv;
      hs = (k > 0) ? hs + h[k * NPT + s] : h[k * NPT + s];
      dus[k] = c.tend_u(k, s) + c.cor_u(k, s, v + k * NPT);
      dvs[k] = c.tend_v(k, s) - c.cor_v(k, s, u + k * NPT);
    }
    Hu = vmax(Hu, p.h_min);
    Hv = vmax(Hv, p.h_min);
    const T ubar = nu_ / Hu;
    const T vbar = nv_ / Hv;
    T du_bar, dv_bar;
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
      const T a = hu[k] * dus[k];
      const T b = hv[k] * dvs[k];
      du_bar = (k > 0) ? du_bar + a : a;
      dv_bar = (k > 0) ? dv_bar + b : b;
    }
    du_bar = du_bar / Hu;
    dv_bar = dv_bar / Hv;
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
      const long gk = k * o.plane + g;
      out.p[S_UP][gk] = u[k * NPT + s] - ubar;
      out.p[S_VP][gk] = v[k * NPT + s] - vbar;
      out.p[S_DUP][gk] = dus[k] - du_bar;
      out.p[S_DVP][gk] = dvs[k] - dv_bar;
    }
    out.p[S_DUBAR][g] = du_bar;
    out.p[S_DVBAR][g] = dv_bar;
    out.p[S_UBAR][g] = ubar;
    out.p[S_VBAR][g] = vbar;
    out.p[S_HU][g] = Hu;
    out.p[S_HV][g] = Hv;
    out.p[S_ETA0][g] = (hs - c.glob(I_HB, s)) * mask[s];
    out.p[S_CU][g] = c.drag_u(s);
    out.p[S_CV][g] = c.drag_v(s);
  }
}

}  // namespace slow

// ------------------------------------------------------------------ subcycle
namespace sub {

constexpr int THREADS_SUB = 1024;
constexpr int W = NSUB;
constexpr int RX = SX + 2 * W;
constexpr int RY = SY + 2 * W;
constexpr int NPT = RX * RY;
constexpr int PER = (NPT + THREADS_SUB - 1) / THREADS_SUB;
// shared-memory planes: the seven fields a substep only reads, and the
// three it exchanges between neighbours (U = Hu ubar, V = Hv vbar, eta)
enum Plane { P_HU, P_HV, P_DUB, P_DVB, P_M, P_MU, P_MV, P_U, P_V, P_ETA,
             N_PLANES };

template <typename T>
constexpr int smem_bytes() {
  return int(N_PLANES * NPT * sizeof(T));
}

// nsub forward-backward substeps of (eta, ubar, vbar) on a tile of SY x SX
// points with a halo of nsub on both axes.  Every substep is evaluated on
// the whole block, with the neighbour index held inside the block at its
// rim: what the rim lacks spoils one more ring of points per substep, and
// after nsub substeps the interior is untouched.  A thread owns the points
// tid + i * THREADS_SUB and keeps their ubar, vbar, eta and running sums
// in registers; a substep costs it two reads and one write of the
// exchanged planes in its first half, two reads and two writes in its
// second, and the read-only planes.
template <typename T, typename Src>
__device__ __forceinline__ void run(const Params<T>& p, const Src& src,
                                    const Ptrs<T, N_SUB>& out, const Out& o,
                                    T dte, T inv_nsub) {
  extern __shared__ unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const T* Hu = sm + P_HU * NPT;
  const T* Hv = sm + P_HV * NPT;
  const T* dub = sm + P_DUB * NPT;
  const T* dvb = sm + P_DVB * NPT;
  const T* m = sm + P_M * NPT;
  const T* mu = sm + P_MU * NPT;
  const T* mv = sm + P_MV * NPT;
  T* U = sm + P_U * NPT;
  T* V = sm + P_V * NPT;
  T* eta = sm + P_ETA * NPT;
  const int tid = threadIdx.x;
  const int x0 = o.x0 - W;
  const int y0 = o.y0 - W;
  T ub[PER], vb[PER], su[PER], sv[PER], et[PER], Uo[PER], Vo[PER];

#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int s = tid + i * THREADS_SUB;
    if (s >= NPT) continue;
    const Loc l = src.at(y0 + s / RX, x0 + s % RX);
    const T hu = src.template get<S_HU>(0, l);
    const T hv = src.template get<S_HV>(0, l);
    ub[i] = src.template get<S_UBAR>(0, l);
    vb[i] = src.template get<S_VBAR>(0, l);
    et[i] = src.template get<S_ETA0>(0, l);
    su[i] = T(0);
    sv[i] = T(0);
    Uo[i] = hu * ub[i];
    Vo[i] = hv * vb[i];
    sm[P_HU * NPT + s] = hu;
    sm[P_HV * NPT + s] = hv;
    sm[P_DUB * NPT + s] = src.template get<S_DUBAR>(0, l);
    sm[P_DVB * NPT + s] = src.template get<S_DVBAR>(0, l);
    sm[P_M * NPT + s] = p.in[I_MASK][l.stat];
    sm[P_MU * NPT + s] = p.in[I_MASK_U][l.stat];
    sm[P_MV * NPT + s] = p.in[I_MASK_V][l.stat];
    U[s] = Uo[i];
    V[s] = Vo[i];
  }
  __syncthreads();

  const T mg = -p.g;
  for (int it = 0; it < NSUB; ++it) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int s = tid + i * THREADS_SUB;
      if (s >= NPT) continue;
      const int sxm = (s % RX > 0) ? s - 1 : s;
      const int sym = (s >= RX) ? s - RX : s;
      const T div =
          (Uo[i] - U[sxm]) * p.inv_dx + (Vo[i] - V[sym]) * p.inv_dy;
      et[i] = (et[i] - dte * div) * m[s];
      eta[s] = et[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int s = tid + i * THREADS_SUB;
      if (s >= NPT) continue;
      const int sxp = (s % RX < RX - 1) ? s + 1 : s;
      const int syp = (s < NPT - RX) ? s + RX : s;
      ub[i] = (ub[i] +
               dte * (mg * ((eta[sxp] - et[i]) * p.inv_dx) + dub[s])) * mu[s];
      vb[i] = (vb[i] +
               dte * (mg * ((eta[syp] - et[i]) * p.inv_dy) + dvb[s])) * mv[s];
      su[i] = su[i] + ub[i];
      sv[i] = sv[i] + vb[i];
      Uo[i] = Hu[s] * ub[i];
      Vo[i] = Hv[s] * vb[i];
      U[s] = Uo[i];
      V[s] = Vo[i];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int s = tid + i * THREADS_SUB;
    const int jj = s / RX - W;
    const int ii = s % RX - W;
    if (s >= NPT || jj < 0 || jj >= SY || ii < 0 || ii >= SX) continue;
    if (!o.valid(jj, ii)) continue;
    const long g = o.at(jj, ii);
    out.p[B_ETA][g] = et[i];
    out.p[B_UB][g] = ub[i];
    out.p[B_VB][g] = vb[i];
    out.p[B_UAVG][g] = su[i] * inv_nsub;
    out.p[B_VAVG][g] = sv[i] * inv_nsub;
  }
}

}  // namespace sub

// ----------------------------------------------------------------- recompose
namespace rec {

constexpr int W = LO + 1;
constexpr int RX = TX + 2 * W;
constexpr int RY = TY + 2 * W;
constexpr int NPT = RX * RY;
enum Plane {
  P_H = 0,
  P_UA = NZ,
  P_VA = 2 * NZ,
  P_M = 3 * NZ,
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

// Stage regions: the advecting velocities on the whole block; the
// continuity and the column rescale on [LO, R-LO); the layer velocities,
// the gates and Flather on the interior [LO+1, R-LO-1), which reads the
// new thickness one cell to the east and north.  The source's fields are
// RecIn's: h, then the slow phase's, then the subcycle's.
template <typename T, typename Src>
__device__ __forceinline__ void run(const Params<T>& p, const Src& src,
                                    const Out& o, T* out_h, T* out_u,
                                    T* out_v) {
  extern __shared__ unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  int* gidx = reinterpret_cast<int*>(sm + N_PLANES * NPT);
  T* h = sm + P_H * NPT;
  T* ua = sm + P_UA * NPT;
  T* va = sm + P_VA * NPT;
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
    const T m_u = p.in[I_MASK_U][l.stat];
    const T m_v = p.in[I_MASK_V][l.stat];
    const T ubar_a = src.template get<R_SB + B_UAVG>(0, l);
    const T vbar_a = src.template get<R_SB + B_VAVG>(0, l);
    const T* hn = src.template ptr<R_H>(l);
    const T* upn = src.template ptr<R_SP + S_UP>(l);
    const T* vpn = src.template ptr<R_SP + S_VP>(l);
    for (int k = 0; k < NZ; ++k) {
      h[k * NPT + s] = hn[k * src.plane];
      ua[k * NPT + s] = (upn[k * src.plane] + ubar_a) * m_u;
      va[k * NPT + s] = (vpn[k * src.plane] + vbar_a) * m_v;
    }
    mask[s] = p.in[I_MASK][l.stat];
    mu[s] = m_u;
    mv[s] = m_v;
  }
  // load_eta_ext visits the points this thread loaded
  if (OBC) load_eta_ext<T, NPT>(p, gidx, ee);
  __syncthreads();

  const Tile<T, RX, NPT> c{p, gidx, ua, va, mask, mu, mv, nullptr, h1,
                           nullptr, nullptr, nullptr, nullptr, ee};
  continuity_stage<T, RX, RY>(c, h, ua, va, h1, fx, fy, sc, false);

  // pin the column to the subcycled free surface
  REGION(LO, LO, {
    T col = h1[s];
    for (int k = 1; k < NZ; ++k) col = col + h1[k * NPT + s];
    col = vmax(col, p.h_min);
    const Loc l = src.at(gidx[s], y0 + s / RX, x0 + s % RX);
    const T target =
        vmax(c.glob(I_HB, s) + src.template get<R_SB + B_ETA>(0, l), T(0)) *
        mask[s];
    const T fac = (col > p.h_min) ? target / col : T(1);
    for (int k = 0; k < NZ; ++k) h1[k * NPT + s] = h1[k * NPT + s] * fac;
  })

  const T* sp_up = src.template own<R_SP + S_UP>();
  const T* sp_vp = src.template own<R_SP + S_VP>();
  const T* sp_dup = src.template own<R_SP + S_DUP>();
  const T* sp_dvp = src.template own<R_SP + S_DVP>();
  const T* sp_cu = src.template own<R_SP + S_CU>();
  const T* sp_cv = src.template own<R_SP + S_CV>();
  const T* sb_ub = src.template own<R_SB + B_UB>();
  const T* sb_vb = src.template own<R_SB + B_VB>();
  for (int k_ = tid; k_ < TX * TY; k_ += THREADS) {
    const int jj = k_ / TX;
    const int ii = k_ % TX;
    if (!o.valid(jj, ii)) continue;
    const int s = (W + jj) * RX + W + ii;
    const long g = o.at(jj, ii);
    const T ubar_f = sb_ub[g];
    const T vbar_f = sb_vb[g];
    T uo[NZ], vo[NZ];
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
      const long gk = k * o.plane + g;
      T a = (sp_up[gk] + p.dt * sp_dup[gk]) + ubar_f;
      T b = (sp_vp[gk] + p.dt * sp_dvp[gk]) + vbar_f;
      if (k == NZ - 1) {
        a = a / (T(1) + p.dt * sp_cu[g]);
        b = b / (T(1) + p.dt * sp_cv[g]);
      }
      uo[k] = a * mu[s];
      vo[k] = b * mv[s];
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

}  // namespace rec

}  // namespace spk
}  // namespace beom
