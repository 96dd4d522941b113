// K1s: one split barotropic / baroclinic step (stepping/split.py::
// split_step) of nz layers, as three kernels: the slow phase, the
// barotropic subcycle, and the recomposition with fb.finalize.
//
// Replaces beom_tpu/stencils/band.py::_band_kernel running the split body
// of beom_tpu/stencils/fused_fb.py::make_pallas_stepper.
//
// Why three launches and not one.  The TPU kernel absorbs the subcycle in a
// halo of 2 nsub rows on a full-width band of 128 rows (a halo in y only,
// 12 % more rows at nsub = 8).  A CTA's tile is 32 x 16 points with a halo
// on both axes: one fused launch would need a halo of nsub + 3 points, so
// at nsub = 8 it would evaluate the whole slow phase, by far the most
// expensive part, on 54 x 38 points for 32 x 16 results, four times over.
// Here the slow phase and the recomposition run on tiles with halos of 2
// and 2 (3 under wet/dry) points, and only the subcycle, a dozen
// operations per point and substep on three 2-D fields, pays for the wide
// halo, on larger tiles (64 x 32 points at f32) that hold nothing but its
// ten 2-D planes, with nsub and that tile compile-time too.  The price is one trip of the SlowPhase fields
// (4 nz + 9 planes) through device memory.  A cooperative launch with a
// grid-wide barrier per substep was the other candidate: its 2 nsub
// passes over the 2-D fields would each stream about a dozen planes from
// device memory (2048^2 f32: 200 MB, four times the L2), against one read
// of them here.
//
// Bound: device-memory bytes, for each of the three.  Arithmetic mirrors
// the eager split_step op for op (fb_terms.cuh), so each kernel equals its
// plain version (slow_phase, subcycle_phase, recompose + finalize) bit for
// bit on the card.

#include "fb_terms.cuh"

namespace {

using namespace beom;

// outputs of the slow phase (SlowPhase's fields; cu and cv hold the bottom
// layer only, the others are zero) and of the subcycle
enum Slow {
  S_UP, S_VP, S_DUP, S_DVP, S_DUBAR, S_DVBAR, S_UBAR, S_VBAR, S_HU, S_HV,
  S_ETA0, S_CU, S_CV, N_SLOW
};
enum Sub { B_ETA, B_UB, B_VB, B_UAVG, B_VAVG, N_SUB };

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
template <typename T>
__global__ void __launch_bounds__(THREADS)
kernel(const Params<T> p, const Ptrs<T, N_SLOW> out) {
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
    const int gj = blockIdx.y * TY + jj;
    const int gi = blockIdx.x * TX + ii;
    if (gj >= p.ny || gi >= p.nx) continue;
    const int s = (W + jj) * RX + W + ii;
    const long g = long(gj) * p.nx + gi;
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
      const long gk = k * p.plane + g;
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
template <typename T>
__global__ void __launch_bounds__(THREADS_SUB)
kernel(const Params<T> p, const Ptrs<const T, N_SLOW> in,
       const Ptrs<T, N_SUB> out, T dte, T inv_nsub) {
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
  const int x0 = blockIdx.x * SX - W;
  const int y0 = blockIdx.y * SY - W;
  T ub[PER], vb[PER], su[PER], sv[PER], et[PER], Uo[PER], Vo[PER];

#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int s = tid + i * THREADS_SUB;
    if (s >= NPT) continue;
    const long g = long(wrap(y0 + s / RX, p.ny)) * p.nx +
                   wrap(x0 + s % RX, p.nx);
    const T hu = in.p[S_HU][g];
    const T hv = in.p[S_HV][g];
    ub[i] = in.p[S_UBAR][g];
    vb[i] = in.p[S_VBAR][g];
    et[i] = in.p[S_ETA0][g];
    su[i] = T(0);
    sv[i] = T(0);
    Uo[i] = hu * ub[i];
    Vo[i] = hv * vb[i];
    sm[P_HU * NPT + s] = hu;
    sm[P_HV * NPT + s] = hv;
    sm[P_DUB * NPT + s] = in.p[S_DUBAR][g];
    sm[P_DVB * NPT + s] = in.p[S_DVBAR][g];
    sm[P_M * NPT + s] = p.in[I_MASK][g];
    sm[P_MU * NPT + s] = p.in[I_MASK_U][g];
    sm[P_MV * NPT + s] = p.in[I_MASK_V][g];
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
    const int gj = blockIdx.y * SY + jj;
    const int gi = blockIdx.x * SX + ii;
    if (gj >= p.ny || gi >= p.nx) continue;
    const long g = long(gj) * p.nx + gi;
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
// new thickness one cell to the east and north.
template <typename T>
__global__ void __launch_bounds__(THREADS)
kernel(const Params<T> p, const Ptrs<const T, N_SLOW> sp,
       const Ptrs<const T, N_SUB> sb, T* out_h, T* out_u, T* out_v) {
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

  load_offsets<T, RX, RY, W>(p, gidx);
  __syncthreads();
  for (int s = tid; s < NPT; s += THREADS) {
    const int g = gidx[s];
    const T m_u = p.in[I_MASK_U][g];
    const T m_v = p.in[I_MASK_V][g];
    const T ubar_a = sb.p[B_UAVG][g];
    const T vbar_a = sb.p[B_VAVG][g];
    for (int k = 0; k < NZ; ++k) {
      h[k * NPT + s] = p.in[I_H][k * p.plane + g];
      ua[k * NPT + s] = (sp.p[S_UP][k * p.plane + g] + ubar_a) * m_u;
      va[k * NPT + s] = (sp.p[S_VP][k * p.plane + g] + vbar_a) * m_v;
    }
    mask[s] = p.in[I_MASK][g];
    mu[s] = m_u;
    mv[s] = m_v;
  }
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
    const T target =
        vmax(c.glob(I_HB, s) + sb.p[B_ETA][gidx[s]], T(0)) * mask[s];
    const T fac = (col > p.h_min) ? target / col : T(1);
    for (int k = 0; k < NZ; ++k) h1[k * NPT + s] = h1[k * NPT + s] * fac;
  })

  for (int k_ = tid; k_ < TX * TY; k_ += THREADS) {
    const int jj = k_ / TX;
    const int ii = k_ % TX;
    const int gj = blockIdx.y * TY + jj;
    const int gi = blockIdx.x * TX + ii;
    if (gj >= p.ny || gi >= p.nx) continue;
    const int s = (W + jj) * RX + W + ii;
    const long g = long(gj) * p.nx + gi;
    const T ubar_f = sb.p[B_UB][g];
    const T vbar_f = sb.p[B_VB][g];
    T uo[NZ], vo[NZ];
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
      const long gk = k * p.plane + g;
      T a = (sp.p[S_UP][gk] + p.dt * sp.p[S_DUP][gk]) + ubar_f;
      T b = (sp.p[S_VP][gk] + p.dt * sp.p[S_DVP][gk]) + vbar_f;
      if (k == NZ - 1) {
        a = a / (T(1) + p.dt * sp.p[S_CU][g]);
        b = b / (T(1) + p.dt * sp.p[S_CV][g]);
      }
      uo[k] = a * mu[s];
      vo[k] = b * mv[s];
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

}  // namespace rec

template <typename T, int N>
Ptrs<T, N> pack(void* const* a) {
  Ptrs<T, N> r;
  for (int i = 0; i < N; ++i) r.p[i] = static_cast<T*>(a[i]);
  return r;
}

template <typename T>
int split_slow(const void* const* ptrs, const int* ints, const double* dbls,
               void* const* outs, void* stream) {
  const Params<T> p = make_params<T>(ptrs, ints, dbls);
  constexpr int smem = slow::smem_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(
      slow::kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return int(e);
  const dim3 grid((p.nx + TX - 1) / TX, (p.ny + TY - 1) / TY);
  slow::kernel<T><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      p, pack<T, N_SLOW>(outs));
  return int(cudaGetLastError());
}

template <typename T>
int split_subcycle(const void* const* ptrs, const int* ints,
                   const double* dbls, void* const* slow_fields,
                   void* const* outs, void* stream) {
  const Params<T> p = make_params<T>(ptrs, ints, dbls);
  if (p.nsub != NSUB) return int(cudaErrorInvalidValue);
  constexpr int smem = sub::smem_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(
      sub::kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return int(e);
  const dim3 grid((p.nx + SX - 1) / SX, (p.ny + SY - 1) / SY);
  const T dte = T(dbls[D_DT] / NSUB);
  const T inv_nsub = T(1) / T(NSUB);
  sub::kernel<T><<<grid, sub::THREADS_SUB, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      p, pack<const T, N_SLOW>(slow_fields), pack<T, N_SUB>(outs), dte,
      inv_nsub);
  return int(cudaGetLastError());
}

template <typename T>
int split_recompose(const void* const* ptrs, const int* ints,
                    const double* dbls, void* const* slow_fields,
                    void* const* sub_fields, void* h1, void* u1, void* v1,
                    void* stream) {
  const Params<T> p = make_params<T>(ptrs, ints, dbls);
  constexpr int smem = rec::smem_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(
      rec::kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return int(e);
  const dim3 grid((p.nx + TX - 1) / TX, (p.ny + TY - 1) / TY);
  rec::kernel<T><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      p, pack<const T, N_SLOW>(slow_fields), pack<const T, N_SUB>(sub_fields),
      static_cast<T*>(h1), static_cast<T*>(u1), static_cast<T*>(v1));
  return int(cudaGetLastError());
}

}  // namespace

#define SPLIT_ENTRIES(SUFFIX, T)                                             \
  extern "C" int beom_split_slow_##SUFFIX(                                   \
      const void* const* ptrs, const int* ints, const double* dbls,          \
      void* const* outs, void* stream) {                                     \
    return split_slow<T>(ptrs, ints, dbls, outs, stream);                    \
  }                                                                          \
  extern "C" int beom_split_subcycle_##SUFFIX(                               \
      const void* const* ptrs, const int* ints, const double* dbls,          \
      void* const* slow_fields, void* const* outs, void* stream) {           \
    return split_subcycle<T>(ptrs, ints, dbls, slow_fields, outs, stream);   \
  }                                                                          \
  extern "C" int beom_split_recompose_##SUFFIX(                              \
      const void* const* ptrs, const int* ints, const double* dbls,          \
      void* const* slow_fields, void* const* sub_fields, void* h1, void* u1, \
      void* v1, void* stream) {                                              \
    return split_recompose<T>(ptrs, ints, dbls, slow_fields, sub_fields, h1, \
                              u1, v1, stream);                               \
  }

SPLIT_ENTRIES(f32, float)
SPLIT_ENTRIES(f64, double)

// dynamic shared memory of one CTA of the slow (0), recompose (1) and
// subcycle (2) kernels, for the wrapper's choice of tiles
extern "C" int beom_smem_bytes(int which, int is_f64) {
  if (which == 0)
    return is_f64 ? slow::smem_bytes<double>() : slow::smem_bytes<float>();
  if (which == 1)
    return is_f64 ? rec::smem_bytes<double>() : rec::smem_bytes<float>();
  return is_f64 ? sub::smem_bytes<double>() : sub::smem_bytes<float>();
}

extern "C" const char* beom_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
