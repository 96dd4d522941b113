// The stage bodies of the split step's kernels: the slow phase, the
// barotropic subcycle and the recomposition with fb.finalize, shared by the
// single-device step (split_step.cu, K1s's route 3) and the step on the
// shards of a device mesh (shard_split.cu, K7 around the split body); and
// the tail of K1s's route 2 (namespace tail: the subcycle, the
// recomposition and finalize in one launch, after the slow phase writes
// only its tendencies; on the shards too); and the layer-streamed slow
// phase and recomposition (namespace sps, where the planes of every layer
// make the tiles small or do not fit; on the shards too, their tile's
// origin and the stacked layout given).  Each of the three takes a
// source (shard_addr.cuh: where the tile's haloed points come from) and an
// Out (which interior points are written, and where), the tail reads
// through a block's row and column offsets of either layout; the
// arithmetic is the same for both, so a shard's result equals the
// single-device kernel's on the same points bit for bit.  split_step.cu
// says why two routes.

#pragma once

#include "fb_step_body.cuh"   // fbs: Column, point
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
// outputs of the slow phase of the two-launch step: the layer tendencies
// du_s, dv_s (nz planes each), from which the tail rebuilds SlowPhase
enum Tend { T_DUS, T_DVS, N_TEND };
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
// the stacked fields a kernel reads around its block, besides the operand
// table (Bases: across cards, the nine stacks of each)
template <typename T, int N>
struct Ins {
  Bases<T> p[N];
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
  return table_bytes(N_PLANES * NPT * long(sizeof(T)), NPT);
}

// Stage regions: phi, q (and lap for nu4) on [1, R-1); the tendencies with
// the PV cross terms on the interior [2, R-2).  NO = N_SLOW writes
// SlowPhase's fields; NO = N_TEND writes only the layer tendencies.
template <typename T, typename Src, int NO>
__device__ __forceinline__ void run(const Params<T>& p, const Src& src,
                                    const Ptrs<T, NO>& out, const Out& o) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  Off* gidx = off_table(sm, N_PLANES * NPT);
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

  if constexpr (NO == N_TEND) {
    for (int k_ = tid; k_ < TX * TY; k_ += THREADS) {
      const int jj = k_ / TX;
      const int ii = k_ % TX;
      if (!o.valid(jj, ii)) continue;
      const int s = (W + jj) * RX + W + ii;
      const long g = o.at(jj, ii);
LAYER_LOOP
      for (int k = 0; k < NZ; ++k) {
        out.p[T_DUS][k * o.plane + g] =
            c.tend_u(k, s) + c.cor_u(k, s, v + k * NPT);
        out.p[T_DVS][k * o.plane + g] =
            c.tend_v(k, s) - c.cor_v(k, s, u + k * NPT);
      }
    }
  } else {
    for (int k_ = tid; k_ < TX * TY; k_ += THREADS) {
      const int jj = k_ / TX;
      const int ii = k_ % TX;
      if (!o.valid(jj, ii)) continue;
      const int s = (W + jj) * RX + W + ii;
      const long g = o.at(jj, ii);
      T hu[NZ], hv[NZ], dus[NZ], dvs[NZ];
      T Hu, Hv, nu_, nv_, hs;
LAYER_LOOP
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
LAYER_LOOP
      for (int k = 0; k < NZ; ++k) {
        const T a = hu[k] * dus[k];
        const T b = hv[k] * dvs[k];
        du_bar = (k > 0) ? du_bar + a : a;
        dv_bar = (k > 0) ? dv_bar + b : b;
      }
      du_bar = du_bar / Hu;
      dv_bar = dv_bar / Hv;
LAYER_LOOP
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
  return table_bytes(N_PLANES * NPT * long(sizeof(T)), NPT);
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
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  Off* gidx = off_table(sm, N_PLANES * NPT);
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
LAYER_LOOP
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
LAYER_LOOP
    for (int k = 0; k < NZ; ++k) {
      out_h[k * o.plane + g] = h1[k * NPT + s];
      out_u[k * o.plane + g] = uo[k];
      out_v[k * o.plane + g] = vo[k];
    }
  }
}

}  // namespace rec

// ---------------------------------------------------------------------- tail
// The subcycle, the recomposition and fb.finalize of one split step in one
// launch, from h, u, v and the slow phase's layer tendencies (Tend).  A CTA
// steps a tile of QX x QY points on a block with a halo of NSUB + LO + E:
// after NSUB substeps eta_f, ubar_avg and vbar_avg are exact on the
// recomposition's block [A, R - A) (A = NSUB, a halo of LO + E), whose
// stages then read them from shared memory.  The continuity reaches LO
// points; E = 1 where fb.finalize reads the new thickness one point east
// and north (the wet/dry gates, Flather), else 0.  The block's rim is
// spoilt one ring per substep, whatever it held (the substeps read
// neighbours past the rim from the adjacent planes).
//
// A thread owns a strip of QP points of one column (column tid % RX, rows
// QP (tid / RX) ..), and keeps their barotropic state (eta, ubar, vbar, the
// running sums) and what a substep reads at its own point only (Hu, Hv,
// du_bar, dv_bar) in registers.  Shared memory holds the three fields that
// neighbours read, U = Hu ubar, V = Hv vbar and eta, and the masks; a
// substep reads V and eta of the strip's own rows from registers, so it
// costs the thread two shared-memory reads of neighbours per point (U to
// the west, eta to the east) and one at each end of its strip.
//
// Phase A rebuilds SlowPhase at each point from h, u, v and du_s, dv_s, op
// for op as slow::run computes it, so each value is bitwise the stored
// one: Hu, Hv, ubar, vbar, eta0, du_bar, dv_bar on the block; up, vp, dup,
// dvp and the bottom drag where the recomposition reads them.
namespace tail {

constexpr int HALO = NSUB + LO + ((WETDRY || OBC) ? 1 : 0);
constexpr int RX = QX + 2 * HALO;
constexpr int QT = RX * QS;            // threads: QS strips of each column
constexpr int RY = QS * QP;
constexpr int QY = RY - 2 * HALO;
constexpr int NPT = RX * RY;
constexpr int A = NSUB;
constexpr int THREADS = QT;            // the stride of the REGION loops
static_assert(QY > 0, "the tail's block holds no tile");
static_assert(QT <= 1024, "the tail's CTA has more than 1024 threads");

// shared-memory planes: the masks and eta throughout; U, V during the
// substeps, and in their place after them the advecting velocities, h, h1
// (and the limiter's fluxes and scales, the tidal elevation)
enum Plane {
  P_M, P_MU, P_MV, P_ETA, P_U, P_V,
  P_UA = P_U,
  P_VA = P_UA + NZ,
  P_H = P_VA + NZ,
  P_H1 = P_H + NZ,
  P_FX = P_H1 + NZ,
  P_FY = P_FX + (WETDRY ? NZ : 0),
  P_SC = P_FY + (WETDRY ? NZ : 0),
  P_EE = P_SC + (WETDRY ? NZ : 0),
  N_PLANES = P_EE + (OBC ? 1 : 0)
};

// the planes, then the block's row and column offsets into the grid (one
// more of each: the east and north neighbours of the block's last points)
template <typename T>
constexpr int smem_bytes() {
  return table_bytes(N_PLANES * NPT * sizeof(T), RX + RY + 2);
}

// the statics through the block's row and column offsets
template <typename T>
struct RowColStat {
  const Off *roff, *coff;
  __device__ __forceinline__ T get(const Params<T>& p, int i, int s) const {
    return p.in[i][roff[s / RX] + coff[s % RX]];
  }
  __device__ __forceinline__ T get(const Params<T>& p, int i, int k,
                                   int s) const {
    return p.in[i][k * p.plane + roff[s / RX] + coff[s % RX]];
  }
};

// The tile at o, whose first point in the grid is (gy0, gx0).  With SH
// every operand is stacked over the shards of a mesh (shard_addr.cuh:
// Stack), and o is the tile in its shard's block.
template <typename T, bool SH, typename Tend>
__device__ __forceinline__ void run_at(const Params<T>& p, const Tend& tend,
                                       const Out& o, T* out_h, T* out_u,
                                       T* out_v, T dte, T inv_nsub, int gy0,
                                       int gx0, const Stack& m) {
  extern __shared__ unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  Off* roff = off_table(sm, N_PLANES * NPT);
  Off* coff = roff + RY + 1;
  T* mask = sm + P_M * NPT;
  T* mu = sm + P_MU * NPT;
  T* mv = sm + P_MV * NPT;
  T* eta = sm + P_ETA * NPT;
  T* U = sm + P_U * NPT;
  T* V = sm + P_V * NPT;
  T* ua = sm + P_UA * NPT;
  T* va = sm + P_VA * NPT;
  T* h = sm + P_H * NPT;
  T* h1 = sm + P_H1 * NPT;
  T* fx = sm + P_FX * NPT;
  T* fy = sm + P_FY * NPT;
  T* sc = sm + P_SC * NPT;
  T* ee = sm + P_EE * NPT;
  const int tid = threadIdx.x;
  const int x = tid % RX;
  const int y0 = (tid / RX) * QP;        // the strip's first row
  const int s0 = y0 * RX + x;            // its first point; row r at s0 + r RX
  for (int r = tid; r <= RY; r += QT) {
    const int gy = wrap(gy0 - HALO + r, p.ny);
    roff[r] = SH ? m.row(gy) : Off(gy * p.nx);
  }
  for (int c = tid; c <= RX; c += QT) {
    const int gx = wrap(gx0 - HALO + c, p.nx);
    coff[c] = SH ? m.col(gx) : Off(gx);
  }
  __syncthreads();
  BasesArg<T> hin = p.in[I_H];
  BasesArg<T> uin = p.in[I_U];
  BasesArg<T> vin = p.in[I_V];
  const Off cx = coff[x];
  const Off cx1 = coff[x + 1];

  // phase A: SlowPhase's barotropic fields at the strip's points, as
  // slow::run computes them (hx, hy from h at the east and north points)
  T ub[QP], vb[QP], et[QP], su[QP], sv[QP], Hu[QP], Hv[QP], dub[QP],
      dvb[QP];
#pragma unroll
  for (int r = 0; r < QP; ++r) {
    const int s = s0 + r * RX;
    const Off g = roff[y0 + r] + cx;
    const Off gx = roff[y0 + r] + cx1;
    const Off gy = roff[y0 + r + 1] + cx;
    const T m_ = p.in[I_MASK][g];
    const T mu_ = p.in[I_MASK_U][g];
    const T mv_ = p.in[I_MASK_V][g];
    T hU, hV, nu_, nv_, hs, du_, dv_;
LAYER_LOOP
    for (int k = 0; k < NZ; ++k) {
      const long ko = k * p.plane;
      const T h0 = hin[ko + g];
      const T hu = (T(0.5) * (h0 + hin[ko + gx])) * mu_;
      const T hv = (T(0.5) * (h0 + hin[ko + gy])) * mv_;
      const T uu = hu * uin[ko + g];
      const T vv = hv * vin[ko + g];
      const T a = hu * tend.p[T_DUS][ko + g];
      const T b = hv * tend.p[T_DVS][ko + g];
      hU = (k > 0) ? hU + hu : hu;
      hV = (k > 0) ? hV + hv : hv;
      nu_ = (k > 0) ? nu_ + uu : uu;
      nv_ = (k > 0) ? nv_ + vv : vv;
      hs = (k > 0) ? hs + h0 : h0;
      du_ = (k > 0) ? du_ + a : a;
      dv_ = (k > 0) ? dv_ + b : b;
      h[k * NPT + s] = h0;
    }
    hU = vmax(hU, p.h_min);
    hV = vmax(hV, p.h_min);
    ub[r] = nu_ / hU;
    vb[r] = nv_ / hV;
    dub[r] = du_ / hU;
    dvb[r] = dv_ / hV;
    et[r] = (hs - p.in[I_HB][g]) * m_;
    Hu[r] = hU;
    Hv[r] = hV;
    su[r] = T(0);
    sv[r] = T(0);
    mask[s] = m_;
    mu[s] = mu_;
    mv[s] = mv_;
    U[s] = hU * ub[r];
    V[s] = hV * vb[r];
  }
  __syncthreads();

  // the substeps, as sub::run
  const T mg = -p.g;
  for (int it = 0; it < NSUB; ++it) {
#pragma unroll
    for (int r = 0; r < QP; ++r) {
      const int s = s0 + r * RX;
      const T vs = (r > 0) ? Hv[r - 1] * vb[r - 1] : V[s - RX];
      const T div = (Hu[r] * ub[r] - U[s - 1]) * p.inv_dx +
                    (Hv[r] * vb[r] - vs) * p.inv_dy;
      et[r] = (et[r] - dte * div) * mask[s];
      eta[s] = et[r];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < QP; ++r) {
      const int s = s0 + r * RX;
      const T en = (r < QP - 1) ? et[r + 1] : eta[s + RX];
      ub[r] = (ub[r] + dte * (mg * ((eta[s + 1] - et[r]) * p.inv_dx) +
                              dub[r])) * mu[s];
      vb[r] = (vb[r] + dte * (mg * ((en - et[r]) * p.inv_dy) + dvb[r])) *
              mv[s];
      su[r] = su[r] + ub[r];
      sv[r] = sv[r] + vb[r];
      U[s] = Hu[r] * ub[r];
      if (r == QP - 1) V[s] = Hv[r] * vb[r];
    }
    __syncthreads();
  }

  // the advecting velocities on the recomposition's block, as rec::run
  // loads them: (up + ubar_avg) mu, up = u - ubar rebuilt from h and u
  auto in_block = [](int yy, int xx, int lo, int hi) {
    return yy >= lo && yy < RY - hi && xx >= lo && xx < RX - hi;
  };
  T ubar[QP], vbar[QP];
#pragma unroll
  for (int r = 0; r < QP; ++r) {
    const int s = s0 + r * RX;
    if (!in_block(y0 + r, x, A, A)) continue;
    const Off g = roff[y0 + r] + cx;
    T nu_, nv_;
LAYER_LOOP
    for (int k = 0; k < NZ; ++k) {
      const T* hk = h + k * NPT;
      const T uu = ((T(0.5) * (hk[s] + hk[s + 1])) * mu[s]) *
                   uin[k * p.plane + g];
      const T vv = ((T(0.5) * (hk[s] + hk[s + RX])) * mv[s]) *
                   vin[k * p.plane + g];
      nu_ = (k > 0) ? nu_ + uu : uu;
      nv_ = (k > 0) ? nv_ + vv : vv;
    }
    ubar[r] = nu_ / Hu[r];
    vbar[r] = nv_ / Hv[r];
    const T ubar_a = su[r] * inv_nsub;
    const T vbar_a = sv[r] * inv_nsub;
LAYER_LOOP
    for (int k = 0; k < NZ; ++k) {
      ua[k * NPT + s] = ((uin[k * p.plane + g] - ubar[r]) + ubar_a) * mu[s];
      va[k * NPT + s] = ((vin[k * p.plane + g] - vbar[r]) + vbar_a) * mv[s];
    }
  }
  using TileT = Tile<T, RX, NPT, RowColStat<T>>;
  const TileT c{p, RowColStat<T>{roff, coff}, ua, va, mask, mu, mv, nullptr,
                h1, nullptr, nullptr, nullptr, nullptr, ee};
  // obc.eta_ext at t1, as load_eta_ext
  if (OBC) {
    REGION_NS(A, A, {
      T e = T(0);
      for (int cc = 0; cc < NTIDE; ++cc) {
        const auto g = long(cc) * p.plane + roff[s / RX] + coff[s % RX];
        e = e + p.in[I_TIDE_AMP][g] *
                    tcos(p.omega[cc] * p.t1 - p.in[I_TIDE_PHASE][g]);
      }
      ee[s] = e;
    })
  }
  __syncthreads();

  continuity_stage<T, RX, RY, TileT, A, QT>(c, h, ua, va, h1, fx, fy, sc,
                                            false);

  // pin the column to the subcycled free surface
  REGION(A + LO, A + LO, {
    T col = h1[s];
    for (int k = 1; k < NZ; ++k) col = col + h1[k * NPT + s];
    col = vmax(col, p.h_min);
    const T target = vmax(c.glob(I_HB, s) + eta[s], T(0)) * mask[s];
    const T fac = (col > p.h_min) ? target / col : T(1);
    for (int k = 0; k < NZ; ++k) h1[k * NPT + s] = h1[k * NPT + s] * fac;
  })

  // the layer velocities at the tile's points, as rec::run, then finalize
  const T half = T(0.5);
#pragma unroll
  for (int r = 0; r < QP; ++r) {
    const int s = s0 + r * RX;
    const int jj = y0 + r - HALO;
    const int ii = x - HALO;
    if (jj < 0 || jj >= QY || ii < 0 || ii >= QX || !o.valid(jj, ii))
      continue;
    const Off g = roff[y0 + r] + cx;
    // drag.bottom_drag_coeff of the bottom layer, as Tile::drag_u / drag_v
    constexpr int kb = NZ - 1;
    const T* hb = h + kb * NPT;
    const T hu_b = vmax(half * (hb[s] + hb[s + 1]), p.h_min);
    const T hv_b = vmax(half * (hb[s] + hb[s + RX]), p.h_min);
    T cu, cv;
    if (!CDBOT) {
      cu = p.r_bot / hu_b;
      cv = p.r_bot / hv_b;
    } else {
      const auto ubt = uin + kb * p.plane;
      const auto vbt = vin + kb * p.plane;
      const Off gs = roff[y0 + r - 1] + cx;     // south
      const Off ge = roff[y0 + r] + cx1;        // east
      const Off gse = roff[y0 + r - 1] + cx1;   // south-east
      const Off gw = roff[y0 + r] + coff[x - 1];
      const Off gn = roff[y0 + r + 1] + cx;
      const Off gnw = roff[y0 + r + 1] + coff[x - 1];
      const T v4 = half * (half * (vbt[g] + vbt[gs]) +
                           half * (vbt[ge] + vbt[gse]));
      cu = (p.r_bot + p.cd_bot * tsqrt(ubt[g] * ubt[g] + v4 * v4)) / hu_b;
      const T u4 = half * (half * (ubt[g] + ubt[gw]) +
                           half * (ubt[gn] + ubt[gnw]));
      cv = (p.r_bot + p.cd_bot * tsqrt(vbt[g] * vbt[g] + u4 * u4)) / hv_b;
    }
    T uo[NZ], vo[NZ];
LAYER_LOOP
    for (int k = 0; k < NZ; ++k) {
      const auto gk = k * p.plane + g;
      const T up = uin[gk] - ubar[r];
      const T vp = vin[gk] - vbar[r];
      const T dup = tend.p[T_DUS][gk] - dub[r];
      const T dvp = tend.p[T_DVS][gk] - dvb[r];
      T a = (up + p.dt * dup) + ub[r];
      T b = (vp + p.dt * dvp) + vb[r];
      if (k == NZ - 1) {
        a = a / (T(1) + p.dt * cu);
        b = b / (T(1) + p.dt * cv);
      }
      uo[k] = a * mu[s];
      vo[k] = b * mv[s];
    }
    finalize_point<T, RX, NPT>(c, h1, s, uo, vo);
    const long go = o.at(jj, ii);
LAYER_LOOP
    for (int k = 0; k < NZ; ++k) {
      out_h[k * o.plane + go] = h1[k * NPT + s];
      out_u[k * o.plane + go] = uo[k];
      out_v[k * o.plane + go] = vo[k];
    }
  }
}

// the tile at o of one device's grid
template <typename T>
__device__ __forceinline__ void run(const Params<T>& p,
                                    const Ptrs<T, N_TEND>& tend, const Out& o,
                                    T* out_h, T* out_u, T* out_v, T dte,
                                    T inv_nsub) {
  run_at<T, false>(p, tend, o, out_h, out_u, out_v, dte, inv_nsub, o.y0,
                   o.x0, Stack{});
}

}  // namespace tail

// ------------------------------------------------------- layer-streamed
// The slow phase and the recomposition of route 3 (and the slow phase's
// tendencies of route 2) one layer at a time (split_step.cu built with
// BEOM_STREAM = 1): where the planes of every layer leave only small tiles
// or none (split_plan).  Shared memory holds a few planes of one layer,
// whatever NZ; each kernel loops over the layers from the surface
// (`#pragma unroll 1`, so that a build's code does not grow with NZ) with
// the arithmetic of slow::run and rec::run in their order, so each output
// equals theirs bit for bit.  A thread keeps the same interior points of
// its tile in every layer (fbs::point), and their column sums in
// registers.
//   slow   per layer: h, u, v on blocks with a halo of 2 (copied by
//          cp.async into one of two buffers while the layer before is
//          computed), S1's biharmonic
//          planes, Montgomery's running sums z and acc in two planes (no
//          free surface: z is 0 at the top), the layer's phi and q, then
//          its tendencies du_s, dv_s at the interior, written where
//          SlowPhase's du', dv' go; the column's Hu, Hv, u and v
//          transports, h and tendency transports summed as they come; the
//          bottom drag written from the last layer.  Then a second loop over the
//          thread's points writes u' = u - ubar, v' from u, v read again,
//          and du' = du_s - du_bar, dv' from what the first loop wrote,
//          the same one subtraction on the same value.  With NO = N_TEND
//          (route 2) it writes du_s, dv_s alone.
//   rch    the recomposition's continuity: per layer h, u' and v' on
//          blocks with a halo of LO (copied by cp.async into one of two
//          buffers while the layer before is computed), the advecting
//          velocities in place and the
//          layer's h1 on the tile, written into out_h, the column's sum
//          kept; then each point's h1 times the column's rescale factor,
//          read back and written again (the same one multiplication).
//   ruv    the layer velocities and fb.finalize: per layer the rescaled h1
//          read back on blocks with a halo of 1 (only where the gates or
//          Flather read it), u1, v1 at the interior, the gates, Flather's
//          sums in registers and its increment added afterwards
//          (fbs::Column).
namespace sps {

using fbs::point;
using fbs::PPT;

// CTAs per SM the slow phase's kernels are held to (one device and the
// shards alike): at f32 64 registers, four CTAs per SM; on the H100 that
// beat the 69 registers and three CTAs per SM the compiler takes on its
// own (the shelf at 2048^2, 32 layers; PERF.md)
template <typename T>
constexpr int SLOW_CTAS = sizeof(T) == 4 ? 4 : 1;

namespace slow {

constexpr int W = spk::slow::W;
constexpr int RX = TX + 2 * W;
constexpr int RY = TY + 2 * W;
constexpr int NPT = RX * RY;
// h, u, v of two layers (layer k at + (k % 2) NPT), the layer's
// intermediates, the masks
enum Plane {
  P_H = 0,
  P_U = 2,
  P_V = 4,
  P_PHI = 6,
  P_Q,
  P_LU,
  P_LV = P_LU + (NU4 ? 1 : 0),
  P_Z = P_LV + (NU4 ? 1 : 0),
  P_ACC,
  P_M,
  P_MU,
  P_MV,
  P_MQ,
  N_PLANES
};

template <typename T>
constexpr int smem_bytes() {
  return table_bytes(N_PLANES * NPT * long(sizeof(T)), NPT);
}

// layer k's h, u, v of the block into their planes of buffer k % 2, by
// cp.async, one group
template <typename T>
__device__ __forceinline__ void fetch(const Params<T>& p, const Off* gidx,
                                      T* sm, int k) {
  T* h = sm + (P_H + k % 2) * NPT;
  T* u = sm + (P_U + k % 2) * NPT;
  T* v = sm + (P_V + k % 2) * NPT;
  for (int s = threadIdx.x; s < NPT; s += THREADS) {
    const auto g = k * p.plane + gidx[s];
    fbp::cp_async<int(sizeof(T))>(h + s, p.in[I_H] + g);
    fbp::cp_async<int(sizeof(T))>(u + s, p.in[I_U] + g);
    fbp::cp_async<int(sizeof(T))>(v + s, p.in[I_V] + g);
  }
  fbp::cp_async_commit();
}

// The tile whose first point is the grid's (gy0, gx0), its interior
// points written through o into `out` (the outputs at the tile's shard's
// block, or the grid's); with SH every operand is stacked over the shards
// of m, and base is the offset of the tile's shard's block in a plane of
// the stack (0 on one device), where u and v are read at the tile's points
template <typename T, int NO, bool SH>
__device__ __forceinline__ void run_at(const Params<T>& p, const Stack& m,
                                       int gy0, int gx0, const Out& o,
                                       const Ptrs<T, NO>& out, int base) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  Off* gidx = off_table(sm, N_PLANES * NPT);
  T* phi = sm + P_PHI * NPT;
  T* q = sm + P_Q * NPT;
  T* lu = sm + P_LU * NPT;
  T* lv = sm + P_LV * NPT;
  T* zp = sm + P_Z * NPT;
  T* acc = sm + P_ACC * NPT;
  T* mask = sm + P_M * NPT;
  T* mu = sm + P_MU * NPT;
  T* mv = sm + P_MV * NPT;
  T* mq = sm + P_MQ * NPT;
  const int tid = threadIdx.x;
  block_offsets<T, RX, RY, SH>(p, m, gidx, gy0 - W, gx0 - W);
  __syncthreads();
  fetch<T>(p, gidx, sm, 0);
  for (int s = tid; s < NPT; s += THREADS) {
    const Off g = gidx[s];
    mask[s] = p.in[I_MASK][g];
    mu[s] = p.in[I_MASK_U][g];
    mv[s] = p.in[I_MASK_V][g];
    mq[s] = p.in[I_MASK_Q][g];
  }
  // phi_q without the free surface: z = 0 at the top
  REGION_NS(1, 1, {
    const T z = T(0);
    zp[s] = z;
    acc[s] = p.gp[0] * z;
  })
  using TileT = Tile<T, RX, NPT, GlobStat<T>, 0>;
  // the column's sums at the thread's points
  T Hu[PPT], Hv[PPT], nu_[PPT], nv_[PPT], hs[PPT], dub[PPT], dvb[PPT];

#pragma unroll 1
  for (int k = 0; k < NZ; ++k) {
    // the next layer's copies go out while this one is computed: into
    // the buffer the last layer used, which the barrier ending it freed
    if (k + 1 < NZ) {
      fetch<T>(p, gidx, sm, k + 1);
      fbp::cp_async_wait<1>();
    } else {
      fbp::cp_async_wait<0>();
    }
    __syncthreads();
    const T* h = sm + (P_H + k % 2) * NPT;
    const T* u = sm + (P_U + k % 2) * NPT;
    const T* v = sm + (P_V + k % 2) * NPT;
    const TileT c{p, gidx, u, v, mask, mu, mv, mq, h,
                  phi, q, lu, lv, nullptr};

    // S1's lap planes for the biharmonic; phi and q, and the running sums
    // of the next layer
    REGION(1, 1, {
      if (NU4) {
        lu[s] = c.lap_u(u, s);
        lv[s] = c.lap_v(v, s);
      }
      c.phi_q_layer(k, s, acc[s], c.glob(I_FQ, s), phi, q);
      if (k + 1 < NZ) {
        const T z = zp[s] - h[s];
        zp[s] = z;
        acc[s] = acc[s] + p.gp[k + 1] * z;
      }
    })

    // the layer's tendencies with the PV cross terms at the interior
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      int jj, ii, s;
      if (!point<W, RX>(o, i, jj, ii, s)) continue;
      const T dus = c.tend_u(k, s) + c.cor_u(k, s, v);
      const T dvs = c.tend_v(k, s) - c.cor_v(k, s, u);
      const long g = k * o.plane + o.at(jj, ii);
      if constexpr (NO == N_TEND) {
        out.p[T_DUS][g] = dus;
        out.p[T_DVS][g] = dvs;
      } else {
        const T hu = c.hx(k, s) * mu[s];
        const T hv = c.hy(k, s) * mv[s];
        const T uu = hu * u[s];
        const T vv = hv * v[s];
        const T a = hu * dus;
        const T b = hv * dvs;
        Hu[i] = (k > 0) ? Hu[i] + hu : hu;
        Hv[i] = (k > 0) ? Hv[i] + hv : hv;
        nu_[i] = (k > 0) ? nu_[i] + uu : uu;
        nv_[i] = (k > 0) ? nv_[i] + vv : vv;
        hs[i] = (k > 0) ? hs[i] + h[s] : h[s];
        dub[i] = (k > 0) ? dub[i] + a : a;
        dvb[i] = (k > 0) ? dvb[i] + b : b;
        if (k == NZ - 1) {
          out.p[S_CU][o.at(jj, ii)] = c.drag_u(s);
          out.p[S_CV][o.at(jj, ii)] = c.drag_v(s);
        }
        out.p[S_DUP][g] = dus;
        out.p[S_DVP][g] = dvs;
      }
    }
    // before the next layer's loads overwrite the planes
    __syncthreads();
  }

  if constexpr (NO == N_SLOW) {
    const T* u_own = own_base(p.in[I_U]) + base;
    const T* v_own = own_base(p.in[I_V]) + base;
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      int jj, ii, s;
      if (!point<W, RX>(o, i, jj, ii, s)) continue;
      const long g = o.at(jj, ii);
      const T Hu_ = vmax(Hu[i], p.h_min);
      const T Hv_ = vmax(Hv[i], p.h_min);
      const T ubar = nu_[i] / Hu_;
      const T vbar = nv_[i] / Hv_;
      const T du_bar = dub[i] / Hu_;
      const T dv_bar = dvb[i] / Hv_;
#pragma unroll 1
      for (int k = 0; k < NZ; ++k) {
        const long gk = k * o.plane + g;
        out.p[S_UP][gk] = u_own[gk] - ubar;
        out.p[S_VP][gk] = v_own[gk] - vbar;
        out.p[S_DUP][gk] = out.p[S_DUP][gk] - du_bar;
        out.p[S_DVP][gk] = out.p[S_DVP][gk] - dv_bar;
      }
      out.p[S_DUBAR][g] = du_bar;
      out.p[S_DVBAR][g] = dv_bar;
      out.p[S_UBAR][g] = ubar;
      out.p[S_VBAR][g] = vbar;
      out.p[S_HU][g] = Hu_;
      out.p[S_HV][g] = Hv_;
      out.p[S_ETA0][g] = (hs[i] - p.in[I_HB][gidx[s]]) * mask[s];
    }
  }
}

}  // namespace slow

// the recomposition's continuity and column rescale into out_h
namespace rch {

constexpr int W = LO;
constexpr int RX = TX + 2 * W;
constexpr int RY = TY + 2 * W;
constexpr int NPT = RX * RY;
enum Plane {
  P_H = 0,
  P_UA = 2,
  P_VA = 4,
  P_H1 = 6,
  P_M,
  P_MU,
  P_MV,
  P_UBA,
  P_VBA,
  P_FX,
  P_FY = P_FX + (WETDRY ? 1 : 0),
  P_SC = P_FY + (WETDRY ? 1 : 0),
  N_PLANES = P_SC + (WETDRY ? 1 : 0)
};

template <typename T>
constexpr int smem_bytes() {
  return table_bytes(N_PLANES * NPT * long(sizeof(T)), NPT);
}

// The tile whose first point is the grid's (gy0, gx0), its interior
// points written through o into out_h (the output at the tile's shard's
// block, or the grid's); with SH every operand is stacked over the shards
// of m.  src: RecIn's fields (h, SlowPhase's, the subcycle's), read at
// the block's points through their stacks (Src::base) and at the tile's
// through its shard's block (Src::own)
template <typename T, bool SH, typename Src>
__device__ __forceinline__ void run_at(const Params<T>& p, const Stack& m,
                                       int gy0, int gx0, const Out& o,
                                       const Src& src, T* out_h) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  Off* gidx = off_table(sm, N_PLANES * NPT);
  T* h1 = sm + P_H1 * NPT;
  T* mask = sm + P_M * NPT;
  T* mu = sm + P_MU * NPT;
  T* mv = sm + P_MV * NPT;
  T* uba = sm + P_UBA * NPT;
  T* vba = sm + P_VBA * NPT;
  BasesArg<T> hin = src.template base<R_H>();
  BasesArg<T> up = src.template base<R_SP + S_UP>();
  BasesArg<T> vp = src.template base<R_SP + S_VP>();
  const int tid = threadIdx.x;
  block_offsets<T, RX, RY, SH>(p, m, gidx, gy0 - W, gx0 - W);
  __syncthreads();
  // layer k's h, u', v' into buffer k % 2 by cp.async, one group
  auto fetch = [&](int k) {
    for (int s = tid; s < NPT; s += THREADS) {
      const auto g = k * p.plane + gidx[s];
      fbp::cp_async<int(sizeof(T))>(sm + (P_H + k % 2) * NPT + s, hin + g);
      fbp::cp_async<int(sizeof(T))>(sm + (P_UA + k % 2) * NPT + s, up + g);
      fbp::cp_async<int(sizeof(T))>(sm + (P_VA + k % 2) * NPT + s, vp + g);
    }
    fbp::cp_async_commit();
  };
  fetch(0);
  for (int s = tid; s < NPT; s += THREADS) {
    const Off g = gidx[s];
    mask[s] = p.in[I_MASK][g];
    mu[s] = p.in[I_MASK_U][g];
    mv[s] = p.in[I_MASK_V][g];
    uba[s] = src.template base<R_SB + B_UAVG>()[g];
    vba[s] = src.template base<R_SB + B_VAVG>()[g];
  }
  using TileT = Tile<T, RX, NPT, GlobStat<T>, 0>;
  T col[PPT];

#pragma unroll 1
  for (int k = 0; k < NZ; ++k) {
    // the next layer's copies go out while this one is computed: into
    // the buffers the last layer used, which the barriers after its
    // continuity freed
    if (k + 1 < NZ) {
      fetch(k + 1);
      fbp::cp_async_wait<1>();
    } else {
      fbp::cp_async_wait<0>();
    }
    __syncthreads();
    const T* h = sm + (P_H + k % 2) * NPT;
    T* ua = sm + (P_UA + k % 2) * NPT;
    T* va = sm + (P_VA + k % 2) * NPT;
    // the advecting velocities, in place
    for (int s = tid; s < NPT; s += THREADS) {
      ua[s] = (ua[s] + uba[s]) * mu[s];
      va[s] = (va[s] + vba[s]) * mv[s];
    }
    __syncthreads();
    const TileT c{p, gidx, ua, va, mask, mu, mv, nullptr, h1,
                  nullptr, nullptr, nullptr, nullptr, nullptr};
    continuity_stage<T, RX, RY, TileT, 0, THREADS, 1>(
        c, h, ua, va, h1, sm + P_FX * NPT, sm + P_FY * NPT, sm + P_SC * NPT,
        false, k);
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      int jj, ii, s;
      if (!point<W, RX>(o, i, jj, ii, s)) continue;
      col[i] = (k > 0) ? col[i] + h1[s] : h1[s];
      out_h[k * o.plane + o.at(jj, ii)] = h1[s];
    }
  }

  // pin the column to the subcycled free surface
  const T* eta_f = src.template own<R_SB + B_ETA>();
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    int jj, ii, s;
    if (!point<W, RX>(o, i, jj, ii, s)) continue;
    const long g = o.at(jj, ii);
    const T cl = vmax(col[i], p.h_min);
    const T target = vmax(p.in[I_HB][gidx[s]] + eta_f[g], T(0)) * mask[s];
    const T fac = (cl > p.h_min) ? target / cl : T(1);
#pragma unroll 1
    for (int k = 0; k < NZ; ++k) {
      const long gk = k * o.plane + g;
      out_h[gk] = out_h[gk] * fac;
    }
  }
}

}  // namespace rch

// the layer velocities and fb.finalize, from rch's h1
namespace ruv {

// the gates and Flather read h1 at the point and east and north of it
constexpr bool H1 = WETDRY || OBC;
constexpr int W = 1;
constexpr int RX = TX + 2 * W;
constexpr int RY = TY + 2 * W;
constexpr int NPT = RX * RY;
enum Plane {
  P_H1 = 0,
  P_M = P_H1 + (H1 ? 1 : 0),
  P_MU,
  P_MV,
  P_EE,
  N_PLANES = P_EE + (OBC ? 1 : 0)
};

template <typename T>
constexpr int smem_bytes() {
  return table_bytes(N_PLANES * NPT * long(sizeof(T)), NPT);
}

// The tile whose first point is the grid's (gy0, gx0), as rch::run_at;
// h1g is rch's output, read at the block's points (across cards its nine
// stacks: the halo may lie on a neighbour card)
template <typename T, bool SH, typename Src>
__device__ __forceinline__ void run_at(const Params<T>& p, const Stack& m,
                                       int gy0, int gx0, const Out& o,
                                       const Src& src, BasesArg<T> h1g,
                                       T* out_u, T* out_v) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  Off* gidx = off_table(sm, N_PLANES * NPT);
  T* h1 = sm + P_H1 * NPT;
  T* mask = sm + P_M * NPT;
  T* mu = sm + P_MU * NPT;
  T* mv = sm + P_MV * NPT;
  T* ee = sm + P_EE * NPT;
  const T* sp_up = src.template own<R_SP + S_UP>();
  const T* sp_vp = src.template own<R_SP + S_VP>();
  const T* sp_dup = src.template own<R_SP + S_DUP>();
  const T* sp_dvp = src.template own<R_SP + S_DVP>();
  const T* sp_cu = src.template own<R_SP + S_CU>();
  const T* sp_cv = src.template own<R_SP + S_CV>();
  const T* sb_ub = src.template own<R_SB + B_UB>();
  const T* sb_vb = src.template own<R_SB + B_VB>();
  const int tid = threadIdx.x;
  block_offsets<T, RX, RY, SH>(p, m, gidx, gy0 - W, gx0 - W);
  __syncthreads();
  for (int s = tid; s < NPT; s += THREADS) {
    const Off g = gidx[s];
    mask[s] = p.in[I_MASK][g];
    mu[s] = p.in[I_MASK_U][g];
    mv[s] = p.in[I_MASK_V][g];
  }
  if (OBC) load_eta_ext<T, NPT>(p, gidx, ee);
  __syncthreads();
  using TileT = Tile<T, RX, NPT, GlobStat<T>, 0>;
  const TileT c{p, gidx, nullptr, nullptr, mask, mu, mv, nullptr, h1,
                nullptr, nullptr, nullptr, nullptr, ee};
  fbs::Column<T, W, RX> col;

#pragma unroll 1
  for (int k = 0; k < NZ; ++k) {
    if (H1) {
      for (int s = tid; s < NPT; s += THREADS)
        h1[s] = h1g[k * p.plane + gidx[s]];
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      int jj, ii, s;
      if (!point<W, RX>(o, i, jj, ii, s)) continue;
      const long g = o.at(jj, ii);
      const long gk = k * o.plane + g;
      T a = (sp_up[gk] + p.dt * sp_dup[gk]) + sb_ub[g];
      T b = (sp_vp[gk] + p.dt * sp_dvp[gk]) + sb_vb[g];
      if (k == NZ - 1) {
        a = a / (T(1) + p.dt * sp_cu[g]);
        b = b / (T(1) + p.dt * sp_cv[g]);
      }
      T uo = a * mu[s];
      T vo = b * mv[s];
      if (WETDRY) gate_point<T, RX>(c, h1, s, uo, vo);
      if (OBC) col.add(p, i, k, h1, s, uo, vo);
      out_u[gk] = uo;
      out_v[gk] = vo;
    }
    // before the next layer's loads overwrite the plane
    if (H1) __syncthreads();
  }
  if (OBC) col.fix(c, o, out_u, out_v);
}

}  // namespace ruv
}  // namespace sps

}  // namespace spk
}  // namespace beom
