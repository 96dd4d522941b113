// The stage bodies of the two phases of a rigid-lid / implicit-free-surface
// step: the single-step bodies pa, pb (projection.cu's proj_a, proj_b),
// each taking a source (shard_addr.cuh: where the tile's haloed points come
// from) and an Out (which interior points are written, and where), their
// layer-streamed twins pal, pbl and the staged bodies pas, pbs, shared by
// the single-device kernels (projection.cu, K3a and K3b) and the phases on
// the shards of a device mesh (shard_projection.cu, K7 around the
// projection bodies), which read through a block's offsets of either
// layout.  The arithmetic is the same for every layout, so a shard's
// result equals the single-device kernel's on the same points bit for bit.
// projection.cu describes the stages.

#pragma once

#include "fb_step_body.cuh"   // cp.async (namespace fbp)
#include "shard_addr.cuh"

// the staged phase kernels' geometry (pas, pbs below): each one's tile
// and threads per CTA, and whether the staggered masks are rebuilt from
// the centre mask (BEOM_DMASK, where the grid's masks are make_grid's)
#ifndef BEOM_ATX
#define BEOM_ATX 32
#endif
#ifndef BEOM_ATY
#define BEOM_ATY 16
#endif
#ifndef BEOM_ANT
#define BEOM_ANT 256
#endif
#ifndef BEOM_BTX
#define BEOM_BTX 32
#endif
#ifndef BEOM_BTY
#define BEOM_BTY 16
#endif
#ifndef BEOM_BNT
#define BEOM_BNT 256
#endif
#ifndef BEOM_DMASK
#define BEOM_DMASK 0
#endif

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
  return table_bytes(N_PLANES * NPT * long(sizeof(T)), NPT);
}

template <typename T, typename Src>
__device__ __forceinline__ void run(const Params<T>& p, const Src& src,
                                    const Out& o, T* out_us, T* out_vs,
                                    T* out_div) {
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
LAYER_LOOP
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
  return table_bytes(N_PLANES * NPT * long(sizeof(T)), NPT);
}

template <typename T, typename Src>
__device__ __forceinline__ void run(const Params<T>& p, const Src& src,
                                    const Out& o, T corr, T* out_h, T* out_u,
                                    T* out_v) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  Off* gidx = off_table(sm, N_PLANES * NPT);
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
LAYER_LOOP
    for (int k = 0; k < NZ; ++k) {
      uo[k] = ua[k * NPT + s];
      vo[k] = va[k * NPT + s];
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

}  // namespace pb

// ------------------------------------------------- K3b, layer-streamed
//
// pb's stages one layer at a time (projection.cu's proj_b and
// shard_projection.cu's phase B in a build with BEOM_STREAM = 1): per
// tile, p, the masks and the tide's elevation are loaded once; for each
// layer from the surface its h, u*, v* on the block, S1's correction, S2's
// continuity, and S3's gates on the interior, writing the layer's h1, u1,
// v1.  Only Flather couples the column: its sums are kept in registers
// (a thread keeps the same interior points in every layer) and its
// increment added to every layer's u1, v1 afterwards, as fbs::mom does.
// Shared memory: 8 + 3 (wet/dry) + 1 (the open boundary) planes of one
// layer, whatever NZ.
namespace pbl {

constexpr int W = pb::W;
constexpr int RX = TX + 2 * W;
constexpr int RY = TY + 2 * W;
constexpr int NPT = RX * RY;
enum Plane {
  P_H = 0,
  P_UA,
  P_VA,
  P_P,
  P_M,
  P_MU,
  P_MV,
  P_H1,
  P_FX,
  P_FY = P_FX + (WETDRY ? 1 : 0),
  P_SC = P_FY + (WETDRY ? 1 : 0),
  P_EE = P_SC + (WETDRY ? 1 : 0),
  N_PLANES = P_EE + (OBC ? 1 : 0)
};

template <typename T>
constexpr int smem_bytes() {
  return table_bytes(N_PLANES * NPT * long(sizeof(T)), NPT);
}

// The tile whose first point is the grid's (gy0, gx0), its interior
// points written through o (the outputs at the tile's shard's block, or
// the grid's); with SH every operand is stacked over the shards of m
template <typename T, bool SH>
__device__ __forceinline__ void run_at(const Params<T>& p, const Stack& m,
                                       int gy0, int gx0, const Out& o,
                                       BasesArg<T> pres, T corr, T* out_h,
                                       T* out_u, T* out_v) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  Off* gidx = off_table(sm, N_PLANES * NPT);
  T* h = sm + P_H * NPT;
  T* ua = sm + P_UA * NPT;
  T* va = sm + P_VA * NPT;
  T* pr = sm + P_P * NPT;
  T* mask = sm + P_M * NPT;
  T* mu = sm + P_MU * NPT;
  T* mv = sm + P_MV * NPT;
  T* h1 = sm + P_H1 * NPT;
  T* ee = sm + P_EE * NPT;
  const int tid = threadIdx.x;
  block_offsets<T, RX, RY, SH>(p, m, gidx, gy0 - W, gx0 - W);
  __syncthreads();
  for (int s = tid; s < NPT; s += THREADS) {
    const Off g = gidx[s];
    pr[s] = pres[g];
    mask[s] = p.in[I_MASK][g];
    mu[s] = p.in[I_MASK_U][g];
    mv[s] = p.in[I_MASK_V][g];
  }
  if (OBC) load_eta_ext<T, NPT>(p, gidx, ee);
  using TileT = Tile<T, RX, NPT, GlobStat<T>, 0>;
  const TileT c{p, gidx, ua, va, mask, mu, mv, nullptr, h1,
                nullptr, nullptr, nullptr, nullptr, ee};
  fbs::Column<T, W, RX> col;

#pragma unroll 1
  for (int k = 0; k < NZ; ++k) {
    for (int s = tid; s < NPT; s += THREADS) {
      const auto g = k * p.plane + gidx[s];
      h[s] = p.in[I_H][g];
      ua[s] = p.in[I_U][g];
      va[s] = p.in[I_V][g];
    }
    __syncthreads();

    // S1: the barotropic correction, in place
    REGION(0, 1, {
      const T dpx = mu[s] * ((pr[s + 1] - pr[s]) * p.inv_dx);
      const T dpy = mv[s] * ((pr[s + RX] - pr[s]) * p.inv_dy);
      ua[s] = (ua[s] - corr * dpx) * mu[s];
      va[s] = (va[s] - corr * dpy) * mv[s];
    })

    // S2: the layer's continuity with the corrected velocities
    continuity_stage<T, RX, RY, TileT, 0, THREADS, 1>(
        c, h, ua, va, h1, sm + P_FX * NPT, sm + P_FY * NPT, sm + P_SC * NPT,
        false, k);

    // S3: the gates on the interior; the layer written, Flather's sums
    // taken
#pragma unroll
    for (int i = 0; i < fbs::PPT; ++i) {
      int jj, ii, s;
      if (!fbs::point<W, RX>(o, i, jj, ii, s)) continue;
      T uo = ua[s], vo = va[s];
      if (WETDRY) gate_point<T, RX>(c, h1, s, uo, vo);
      if (OBC) col.add(p, i, k, h1, s, uo, vo);
      const long g = k * o.plane + o.at(jj, ii);
      out_h[g] = h1[s];
      out_u[g] = uo;
      out_v[g] = vo;
    }
    // before the next layer's loads overwrite the planes
    __syncthreads();
  }

  if (OBC) col.fix(c, o, out_u, out_v);
}

}  // namespace pbl

// ------------------------------------------------- K3a, layer-streamed
//
// pa's stages one layer at a time (projection.cu's proj_a and
// shard_projection.cu's phase A in a build with BEOM_STREAM = 1), after
// split_body.cuh's sps::slow, the slow phase that also builds phi and q
// from running sums without a surface term: per tile, the offsets and the
// four masks are loaded once; h, u, v of each layer from the surface are
// copied by cp.async into one of two buffers while the layer before is
// computed; Montgomery's running sums z, acc (z is 0 at the top) are
// carried from layer to layer in two planes.  Per layer, in pa's order,
// so that u*, v* and div are pa's bit for bit:
//   S1 the biharmonic's lap planes, phi and q, the next layer's sums
//                                                     [1, R-1)
//   S2 the first sweep (the bottom drag on the last layer) [2, R-2)
//   S3 the second sweep, from S2's plane              [3, R-3)
//   S4 at the thread's own interior points (fbs::point): u*_k, v*_k
//      written, and hx u*, hx u* one cell west, hy v*, hy v* one cell
//      south added into the column's sums in registers.
// The interfacial drag reads u, v of the layers beside from device memory
// through the offsets (Tile's LS = 0), as sps::slow does.  After the last
// layer div, with pa's masks and order.  Shared memory: 16 planes of one
// layer (+ lap(u), lap(v) with nu4) and the offsets, whatever NZ.
namespace pal {

constexpr int W = pa::W;
constexpr int RX = TX + 2 * W;
constexpr int RY = TY + 2 * W;
constexpr int NPT = RX * RY;
// h, u, v of two layers (layer k at + (k % 2) NPT), the layer's
// intermediates, the running sums, the masks
enum Plane {
  P_H = 0,
  P_U = 2,
  P_V = 4,
  P_PHI = 6,
  P_Q,
  P_A1,
  P_A2,
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

// The tile whose first point is the grid's (gy0, gx0), as pbl::run_at
template <typename T, bool SH>
__device__ __forceinline__ void run_at(const Params<T>& p, const Stack& m,
                                       int gy0, int gx0, const Out& o,
                                       T* out_us, T* out_vs, T* out_div) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  Off* gidx = off_table(sm, N_PLANES * NPT);
  T* phi = sm + P_PHI * NPT;
  T* q = sm + P_Q * NPT;
  T* a1 = sm + P_A1 * NPT;
  T* a2 = sm + P_A2 * NPT;
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
  const bool uf = p.u_first;
  // the column's transports at the thread's points: U, U one cell west, V,
  // V one cell south
  T U[fbs::PPT], Uw[fbs::PPT], V[fbs::PPT], Vs[fbs::PPT];

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

    // S1: the lap planes for the biharmonic; phi = M (no surface term) +
    // K and the PV, and the running sums of the next layer
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

    // S2: the first FB-Coriolis sweep, u on even steps, v on odd ones
    REGION(2, 2, {
      T a;
      if (uf) {
        a = u[s] + p.dt * (c.tend_u(k, s) + c.cor_u(k, s, v));
        if (k == NZ - 1) a = a / (T(1) + p.dt * c.drag_u(s));
        a = a * mu[s];
      } else {
        a = v[s] + p.dt * (c.tend_v(k, s) + (-c.cor_v(k, s, u)));
        if (k == NZ - 1) a = a / (T(1) + p.dt * c.drag_v(s));
        a = a * mv[s];
      }
      a1[s] = a;
    })

    // S3: the second sweep, from the first one's result
    REGION(3, 3, {
      T b;
      if (uf) {
        b = v[s] + p.dt * (c.tend_v(k, s) + (-c.cor_v(k, s, a1)));
        if (k == NZ - 1) b = b / (T(1) + p.dt * c.drag_v(s));
        b = b * mv[s];
      } else {
        b = u[s] + p.dt * (c.tend_u(k, s) + c.cor_u(k, s, a1));
        if (k == NZ - 1) b = b / (T(1) + p.dt * c.drag_u(s));
        b = b * mu[s];
      }
      a2[s] = b;
    })

    // S4: the layer's u*, v* written, its transports added
    const T* us = uf ? a1 : a2;
    const T* vs = uf ? a2 : a1;
#pragma unroll
    for (int i = 0; i < fbs::PPT; ++i) {
      int jj, ii, s;
      if (!fbs::point<W, RX>(o, i, jj, ii, s)) continue;
      const T a = c.hx(k, s) * us[s];
      const T aw = c.hx(k, s - 1) * us[s - 1];
      const T b = c.hy(k, s) * vs[s];
      const T bs = c.hy(k, s - RX) * vs[s - RX];
      U[i] = (k > 0) ? U[i] + a : a;
      Uw[i] = (k > 0) ? Uw[i] + aw : aw;
      V[i] = (k > 0) ? V[i] + b : b;
      Vs[i] = (k > 0) ? Vs[i] + bs : bs;
      const long g = k * o.plane + o.at(jj, ii);
      out_us[g] = us[s];
      out_vs[g] = vs[s];
    }
    // before the next layer's copies overwrite the planes
    __syncthreads();
  }

  // div of the column's transports, pa's masks and order
#pragma unroll
  for (int i = 0; i < fbs::PPT; ++i) {
    int jj, ii, s;
    if (!fbs::point<W, RX>(o, i, jj, ii, s)) continue;
    const T Uc = U[i] * mu[s];
    const T Uwc = Uw[i] * mu[s - 1];
    const T Vc = V[i] * mv[s];
    const T Vsc = Vs[i] * mv[s - RX];
    out_div[o.at(jj, ii)] =
        ((Uc - Uwc) * p.inv_dx + (Vc - Vsc) * p.inv_dy) * mask[s];
  }
}

}  // namespace pal


// ------------------------------------------- the staged phase kernels
//
// K3a and K3b as the single-device kernels run them by default: the same
// stages and arithmetic as pa and pb, on tiles of their own geometry
// (BEOM_ATX x BEOM_ATY with BEOM_ANT threads, BEOM_BTX x BEOM_BTY with
// BEOM_BNT), every operand a stage reads copied into shared memory by
// cp.async (rows in 16-byte pieces where the block lies inside the grid,
// else point by point through the block's row and column offsets, periodic
// on both axes), the staggered masks rebuilt from the centre mask under
// BEOM_DMASK, and each stage computed only where the next one reads it.
namespace stg {

// layers [0, nl) of the field at src (layer stride `plane`) into the
// planes from dst of an RX x RY block; with SH a 16-byte piece's offset is
// its first column's (fbp::stage)
template <typename T, int RX, int RY, int NT, bool SH = false>
__device__ __forceinline__ void stage(BasesArg<T> src, long plane, int nl,
                                      T* dst, const Off* roff,
                                      const Off* coff, int x0, bool vec) {
  constexpr int NPT = RX * RY;
  constexpr int VW = 16 / int(sizeof(T));
  if (RX % VW == 0 && vec) {
    constexpr int NV = RX / VW;
    for (int e = threadIdx.x; e < nl * RY * NV; e += NT) {
      const int k = e / (RY * NV);
      const int r = (e / NV) % RY;
      const int c = (e % NV) * VW;
      fbp::cp_async<16>(dst + k * NPT + r * RX + c,
                        src + (k * plane + roff[r] +
                               (SH ? coff[c] : Off(x0 + c))));
    }
    return;
  }
  for (int e = threadIdx.x; e < nl * NPT; e += NT) {
    const int k = e / NPT;
    const int s = e % NPT;
    fbp::cp_async<int(sizeof(T))>(
        dst + e, src + (k * plane + roff[s / RX] + coff[s % RX]));
  }
}

// the block's row and column offsets into the grid (periodic), its first
// point at (y0, x0); returns whether its rows can be copied in 16-byte
// pieces.  With SH every operand is stacked over the shards of a mesh
// (shard_addr.cuh: Stack), and every block whose x0 and the shards' width
// are multiples of a piece copies in pieces (stage).  Ends with a
// __syncthreads().
template <typename T, int RX, int RY, int NT, bool SH = false>
__device__ __forceinline__ bool offsets(const Params<T>& p, Off* roff,
                                        Off* coff, int y0, int x0,
                                        const Stack& m = Stack{}) {
  for (int r = threadIdx.x; r < RY; r += NT)
    roff[r] = SH ? m.row(wrap(y0 + r, p.ny)) : Off(wrap(y0 + r, p.ny) * p.nx);
  for (int c = threadIdx.x; c < RX; c += NT)
    coff[c] = SH ? m.col(wrap(x0 + c, p.nx)) : Off(wrap(x0 + c, p.nx));
  __syncthreads();
  constexpr int VW = 16 / int(sizeof(T));
  if (SH) return p.aligned && x0 % VW == 0 && m.lx % VW == 0;
  return p.aligned && x0 >= 0 && x0 + RX <= p.nx && x0 % VW == 0 &&
         p.nx % VW == 0;
}


// mask_u, mask_v, mask_q of make_grid from the centre mask, on [0, R - 1)
template <typename T, int RX, int RY, int NT>
__device__ __forceinline__ void rebuild_masks(const T* m, T* mu, T* mv,
                                              T* mq) {
  constexpr int nx_ = RX - 1;
  for (int k_ = threadIdx.x; k_ < nx_ * (RY - 1); k_ += NT) {
    const int s = (k_ / nx_) * RX + k_ % nx_;
    mu[s] = m[s] * m[s + 1];
    mv[s] = m[s] * m[s + RX];
    if (mq) mq[s] = ((m[s] * m[s + 1]) * m[s + RX]) * m[s + RX + 1];
  }
}

}  // namespace stg

// The epilogue of the staged K3a: what it writes at each point besides u*,
// v* (a null pointer: not written).  div = div(U*); eta = (sum_k h - H)
// mask, the implicit free surface's eta^n and the rigid lid's column
// anomaly before its de-mean; b = lam_neg (eta - dt div), the implicit
// free surface's right-hand side (stepping/projection.py: implicit_rhs);
// x0 = 2 phi - phi_prev, the solve's warm start (warm_x0).
template <typename T>
struct Epi {
  T *div, *eta, *b, *x0;
  const T *phi, *phi_prev;
  T lam_neg;
};

// ------------------------------------------------------ K3a, staged
namespace pas {

constexpr int W = 4;
constexpr int TX = BEOM_ATX;
constexpr int TY = BEOM_ATY;
constexpr int THREADS = BEOM_ANT;
// CTAs per SM the registers must allow: at most 64 registers a thread
constexpr int MINB = THREADS >= 1024 ? 1 : 1024 / THREADS;
constexpr int RX = TX + 2 * W;
constexpr int RY = TY + 2 * W;
constexpr int NPT = RX * RY;
// the input planes: the fields, the masks, the statics
enum In {
  Q_H = 0,
  Q_U = NZ,
  Q_V = 2 * NZ,
  Q_M = 3 * NZ,
  Q_MU,
  Q_MV,
  Q_MQ,
  Q_FQ,
  Q_TAUX,
  Q_TAUY = Q_TAUX + (WIND ? 1 : 0),
  Q_SPONGE = Q_TAUY + (WIND ? 1 : 0),
  N_IN = Q_SPONGE + (SPONGE ? 1 : 0)
};
// the work planes after them; the transports the Coriolis sweeps read
// (Sadourny's scheme): T1 that of the field the first sweep reads, T2 that
// of its result
enum Work {
  Q_PHI = N_IN,
  Q_Q = Q_PHI + NZ,
  Q_A1 = Q_Q + NZ,
  Q_A2 = Q_A1 + NZ,
  Q_T1 = Q_A2 + NZ,
  Q_T2 = Q_T1 + NZ,
  Q_LU = Q_T2 + NZ,
  Q_LV = Q_LU + (NU4 ? NZ : 0),
  N_PLANES = Q_LV + (NU4 ? NZ : 0)
};

// the planes, then the block's row and column offsets
template <typename T>
constexpr int smem_bytes() {
  return table_bytes(N_PLANES * NPT * sizeof(T), RX + RY);
}

// the statics the stages read (f, the wind, the sponge), from their planes
template <typename T>
struct Stat {
  const T* sm;
  __device__ __forceinline__ T get(const Params<T>&, int i, int s) const {
    const int q = i == I_FQ     ? Q_FQ
                  : i == I_TAUX ? Q_TAUX
                  : i == I_TAUY ? Q_TAUY
                                : Q_SPONGE;
    return sm[q * NPT + s];
  }
  __device__ __forceinline__ T get(const Params<T>& p, int i, int,
                                   int s) const {
    return get(p, i, s);
  }
};

// Tile::cor_u / cor_v from the transport plane t of the field (w itself
// without Sadourny's scheme): the same products, made once per point
template <typename T, typename TileT>
__device__ __forceinline__ T cor_u_t(const TileT& c, int k, int s,
                                     const T* t) {
  const T half = T(0.5);
  const T* qk = c.q + k * NPT;
  return half * (qk[s] * (half * (t[s] + t[s + 1])) +
                 qk[s - RX] * (half * (t[s - RX] + t[s - RX + 1])));
}
template <typename T, typename TileT>
__device__ __forceinline__ T cor_v_t(const TileT& c, int k, int s,
                                     const T* t) {
  const T half = T(0.5);
  const T* qk = c.q + k * NPT;
  return half * (qk[s] * (half * (t[s] + t[s + RX])) +
                 qk[s - 1] * (half * (t[s - 1] + t[s - 1 + RX])));
}

// S0 of the tile at (ty0, tx0) of the grid: its row and column offsets
// into roff and coff, and its copies into the input planes at `in`, in two
// groups: what S1 reads, then the wind (S2, S3).  With SH the operands are
// stacked over the shards of a mesh.
template <typename T, bool SH = false>
__device__ __forceinline__ void stage_tile(const Params<T>& p, T* in,
                                           Off* roff, Off* coff, int ty0,
                                           int tx0,
                                           const Stack& m = Stack{}) {
  const int x0 = tx0 - W;
  const bool vec =
      stg::offsets<T, RX, RY, THREADS, SH>(p, roff, coff, ty0 - W, x0, m);
  auto stage = [&](BasesArg<T> src, int nl, T* dst) {
    stg::stage<T, RX, RY, THREADS, SH>(src, p.plane, nl, dst, roff, coff,
                                       x0, vec);
  };
  stage(p.in[I_H], NZ, in + Q_H * NPT);
  stage(p.in[I_U], NZ, in + Q_U * NPT);
  stage(p.in[I_V], NZ, in + Q_V * NPT);
  stage(p.in[I_MASK], 1, in + Q_M * NPT);
  if (!BEOM_DMASK) {
    stage(p.in[I_MASK_U], 1, in + Q_MU * NPT);
    stage(p.in[I_MASK_V], 1, in + Q_MV * NPT);
    stage(p.in[I_MASK_Q], 1, in + Q_MQ * NPT);
  }
  stage(p.in[I_FQ], 1, in + Q_FQ * NPT);
  if (SPONGE) stage(p.in[I_SPONGE], 1, in + Q_SPONGE * NPT);
  fbp::cp_async_commit();
  if (WIND) {
    stage(p.in[I_TAUX], 1, in + Q_TAUX * NPT);
    stage(p.in[I_TAUY], 1, in + Q_TAUY * NPT);
  }
  fbp::cp_async_commit();
}

// S1 to S4 of the tile at o (at ob + o.at(jj, ii) of every operand's
// layout) from the input planes at `in` (the first group of its copies
// arrived; the wind's waited for after S1) and the work planes of sm.  The
// stages, as [lo, R - hi) on both axes: S1 phi, q, the first sweep's
// transport (and the biharmonic's lap) on [1, R - 2), S2 the first sweep
// and its result's transport on [2, R - 3), S3 on [3, R - 4), S4 on the
// tile [4, R - 4), which reads S3 one point west and south; the block's
// last row and column feed only S1's reads of h one point north-east (hy
// at s + 1).
template <typename T>
__device__ __forceinline__ void stages(const Params<T>& p, T* in, T* sm,
                                       const Out& o, long ob, T* out_us,
                                       T* out_vs, const Epi<T>& ep) {
  T* h = in + Q_H * NPT;
  T* u = in + Q_U * NPT;
  T* v = in + Q_V * NPT;
  T* mask = in + Q_M * NPT;
  T* mu = in + Q_MU * NPT;
  T* mv = in + Q_MV * NPT;
  T* mq = in + Q_MQ * NPT;
  T* phi = sm + Q_PHI * NPT;
  T* q = sm + Q_Q * NPT;
  T* a1 = sm + Q_A1 * NPT;
  T* a2 = sm + Q_A2 * NPT;
  T* t1 = sm + Q_T1 * NPT;
  T* t2 = sm + Q_T2 * NPT;
  T* lu = sm + Q_LU * NPT;
  T* lv = sm + Q_LV * NPT;
  const int tid = threadIdx.x;
  if (BEOM_DMASK) {
    stg::rebuild_masks<T, RX, RY, THREADS>(mask, mu, mv, mq);
    __syncthreads();
  }

  using TileT = Tile<T, RX, NPT, Stat<T>>;
  const TileT c{p, Stat<T>{in}, u, v, mask, mu, mv, mq, h,
                phi, q, lu, lv, nullptr};
  const bool sad = p.sadourny;
  const bool uf = p.u_first;

  // S1: lap planes for the biharmonic; phi = M (no surface term) + K, PV;
  // the transport of the field the first sweep's Coriolis term reads
  if (NU4) {
    REGION_NS(1, 2, {
      for (int k = 0; k < NZ; ++k) {
        lu[k * NPT + s] = c.lap_u(u + k * NPT, s);
        lv[k * NPT + s] = c.lap_v(v + k * NPT, s);
      }
    })
  }
  REGION_NS(1, 2, {
    c.phi_q(s, false, phi, q);
    if (sad)
      for (int k = 0; k < NZ; ++k)
        t1[k * NPT + s] = uf ? c.hy(k, s) * v[k * NPT + s]
                             : c.hx(k, s) * u[k * NPT + s];
  })
  fbp::cp_async_wait<0>();
  __syncthreads();

  // S2: the first FB-Coriolis sweep, u on even steps, v on odd ones, and
  // its result's transport
  REGION(2, 3, {
    for (int k = 0; k < NZ; ++k) {
      const T* tk = sad ? t1 + k * NPT : (uf ? v : u) + k * NPT;
      T a;
      if (uf) {
        a = u[k * NPT + s] + p.dt * (c.tend_u(k, s) + cor_u_t(c, k, s, tk));
        if (k == NZ - 1) a = a / (T(1) + p.dt * c.drag_u(s));
        a = a * mu[s];
      } else {
        a = v[k * NPT + s] +
            p.dt * (c.tend_v(k, s) + (-cor_v_t(c, k, s, tk)));
        if (k == NZ - 1) a = a / (T(1) + p.dt * c.drag_v(s));
        a = a * mv[s];
      }
      a1[k * NPT + s] = a;
      if (sad) t2[k * NPT + s] = uf ? c.hx(k, s) * a : c.hy(k, s) * a;
    }
  })

  // S3: the second sweep, from the first one's result
  REGION(3, 4, {
    for (int k = 0; k < NZ; ++k) {
      const T* tk = (sad ? t2 : a1) + k * NPT;
      T b;
      if (uf) {
        b = v[k * NPT + s] +
            p.dt * (c.tend_v(k, s) + (-cor_v_t(c, k, s, tk)));
        if (k == NZ - 1) b = b / (T(1) + p.dt * c.drag_v(s));
        b = b * mv[s];
      } else {
        b = u[k * NPT + s] + p.dt * (c.tend_u(k, s) + cor_u_t(c, k, s, tk));
        if (k == NZ - 1) b = b / (T(1) + p.dt * c.drag_u(s));
        b = b * mu[s];
      }
      a2[k * NPT + s] = b;
    }
  })

  // S4: the transport divergence on the tile, u*, v* and the epilogue
  const T* us = uf ? a1 : a2;
  const T* vs = uf ? a2 : a1;
  for (int k_ = tid; k_ < TX * TY; k_ += THREADS) {
    const int jj = k_ / TX;
    const int ii = k_ % TX;
    if (!o.valid(jj, ii)) continue;
    const int s = (W + jj) * RX + W + ii;
    const long g = ob + o.at(jj, ii);
    T U, Uw, V, Vs;
LAYER_LOOP
    for (int k = 0; k < NZ; ++k) {
      const T* uk = us + k * NPT;
      const T* vk = vs + k * NPT;
      const T* tk = t2 + k * NPT;    // the first sweep's transport
      const T a = (sad && uf) ? tk[s] : c.hx(k, s) * uk[s];
      const T aw = (sad && uf) ? tk[s - 1] : c.hx(k, s - 1) * uk[s - 1];
      const T b = (sad && !uf) ? tk[s] : c.hy(k, s) * vk[s];
      const T bs = (sad && !uf) ? tk[s - RX] : c.hy(k, s - RX) * vk[s - RX];
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
    const T dv = ((U - Uw) * p.inv_dx + (V - Vs) * p.inv_dy) * mask[s];
    if (ep.div) ep.div[g] = dv;
    if (ep.eta || ep.b) {
      T hs = h[s];
      for (int k = 1; k < NZ; ++k) hs = hs + h[k * NPT + s];
      const T eta = (hs - own_base(p.in[I_HB])[g]) * mask[s];
      if (ep.eta) ep.eta[g] = eta;
      if (ep.b) ep.b[g] = ep.lam_neg * (eta - p.dt * dv);
    }
    if (ep.x0) ep.x0[g] = T(2) * ep.phi[g] - ep.phi_prev[g];
  }
}

// One CTA per tile
template <typename T>
__device__ __forceinline__ void run(const Params<T>& p, T* out_us,
                                    T* out_vs, const Epi<T>& ep) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  Off* roff = off_table(sm, N_PLANES * NPT);
  const int ty0 = int(blockIdx.y) * TY;
  const int tx0 = int(blockIdx.x) * TX;
  stage_tile(p, sm, roff, roff + RY, ty0, tx0);
  fbp::cp_async_wait<1>();
  __syncthreads();
  stages(p, sm, sm, Out{ty0, tx0, p.ny, p.nx, p.plane}, 0, out_us, out_vs,
         ep);
}

// One CTA per tile of every shard of a mesh on one device (shard_addr.cuh:
// ShardTile), every operand stacked
template <typename T>
__device__ __forceinline__ void run_shards(const Params<T>& p,
                                           const Stack& m, T* out_us,
                                           T* out_vs, const Epi<T>& ep) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  Off* roff = off_table(sm, N_PLANES * NPT);
  const ShardTile t = shard_tile(m, TX, TY);
  stage_tile<T, true>(p, sm, roff, roff + RY, t.gy0, t.gx0, m);
  fbp::cp_async_wait<1>();
  __syncthreads();
  stages(p, sm, sm, t.out(m, p.plane), t.base(m), out_us, out_vs, ep);
}

}  // namespace pas

// ------------------------------------------------------ K3b, staged
namespace pbs {

// the halo of pb on y; on x rounded up to 4, so that the block's rows start
// 16-byte aligned where the tile's do
constexpr int W = pb::W;
constexpr int WX = 4;
constexpr int TX = BEOM_BTX;
constexpr int TY = BEOM_BTY;
constexpr int THREADS = BEOM_BNT;
constexpr int MINB = THREADS >= 1024 ? 1 : 1024 / THREADS;
constexpr int RX = TX + 2 * WX;
constexpr int RY = TY + 2 * W;
constexpr int NPT = RX * RY;
enum Plane {
  Q_H = 0,
  Q_UA = NZ,
  Q_VA = 2 * NZ,
  Q_P = 3 * NZ,
  Q_M,
  Q_MU,
  Q_MV,
  Q_H1,
  Q_FX = Q_H1 + NZ,
  Q_FY = Q_FX + (WETDRY ? NZ : 0),
  Q_SC = Q_FY + (WETDRY ? NZ : 0),
  Q_EE = Q_SC + (WETDRY ? NZ : 0),
  N_PLANES = Q_EE + (OBC ? 1 : 0)
};

template <typename T>
constexpr int smem_bytes() {
  return table_bytes(N_PLANES * NPT * sizeof(T), RX + RY);
}

// the statics finalize reads under the open boundary (H, the face maps),
// from device memory through the block's offsets (staged, their three
// planes cost the shelf a CTA per SM: 0.31 ms against 0.25 on the H100)
template <typename T>
struct Stat {
  const Off *roff, *coff;
  __device__ __forceinline__ T get(const Params<T>& p, int i, int s) const {
    return p.in[i][roff[s / RX] + coff[s % RX]];
  }
  __device__ __forceinline__ T get(const Params<T>& p, int i, int,
                                   int s) const {
    return get(p, i, s);
  }
};

// The tile at o (at ob + o.at(jj, ii) of every operand's layout), whose
// first point in the grid is (ty0, tx0): S1 the correction on [0, R - 1),
// S2 the continuity (h1 on [LO, R - LO)), S3 finalize on the tile, reading
// h1 and the tide's elevation one point east and north.  With SH every
// operand is stacked over the shards of a mesh (shard_addr.cuh: Stack).
template <typename T, bool SH>
__device__ __forceinline__ void run_at(const Params<T>& p,
                                       BasesArg<T> pres, T corr, T* out_h,
                                       T* out_u, T* out_v,
                                       const Out& o, long ob, int ty0,
                                       int tx0, const Stack& m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  Off* roff = off_table(sm, N_PLANES * NPT);
  Off* coff = roff + RY;
  T* h = sm + Q_H * NPT;
  T* ua = sm + Q_UA * NPT;
  T* va = sm + Q_VA * NPT;
  T* pr = sm + Q_P * NPT;
  T* mask = sm + Q_M * NPT;
  T* mu = sm + Q_MU * NPT;
  T* mv = sm + Q_MV * NPT;
  T* h1 = sm + Q_H1 * NPT;
  T* fx = sm + Q_FX * NPT;
  T* fy = sm + Q_FY * NPT;
  T* sc = sm + Q_SC * NPT;
  T* ee = sm + Q_EE * NPT;
  const int tid = threadIdx.x;
  const int x0 = tx0 - WX;
  const bool vec =
      stg::offsets<T, RX, RY, THREADS, SH>(p, roff, coff, ty0 - W, x0, m);
  auto stage = [&](BasesArg<T> src, int nl, T* dst) {
    stg::stage<T, RX, RY, THREADS, SH>(src, p.plane, nl, dst, roff, coff,
                                       x0, vec);
  };
  stage(p.in[I_H], NZ, h);
  stage(p.in[I_U], NZ, ua);
  stage(p.in[I_V], NZ, va);
  stage(pres, 1, pr);
  stage(p.in[I_MASK], 1, mask);
  if (!BEOM_DMASK) {
    stage(p.in[I_MASK_U], 1, mu);
    stage(p.in[I_MASK_V], 1, mv);
  }
  fbp::cp_async_commit();
  // obc.eta_ext at t1 where finalize reads it, as load_eta_ext
  if (OBC) {
    for (int k_ = tid; k_ < (TX + 1) * (TY + 1); k_ += THREADS) {
      const int r = W + k_ / (TX + 1);
      const int cc = WX + k_ % (TX + 1);
      const Off g = roff[r] + coff[cc];
      T e = T(0);
      for (int c = 0; c < NTIDE; ++c) {
        const auto gc = c * p.plane + g;
        e = e + p.in[I_TIDE_AMP][gc] *
                    tcos(p.omega[c] * p.t1 - p.in[I_TIDE_PHASE][gc]);
      }
      ee[r * RX + cc] = e;
    }
  }
  fbp::cp_async_wait<0>();
  __syncthreads();
  if (BEOM_DMASK) {
    stg::rebuild_masks<T, RX, RY, THREADS>(mask, mu, mv,
                                           static_cast<T*>(nullptr));
    __syncthreads();
  }

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
  using TileT = Tile<T, RX, NPT, Stat<T>>;
  const TileT c{p, Stat<T>{roff, coff}, ua, va, mask, mu, mv, nullptr, h1,
                nullptr, nullptr, nullptr, nullptr, ee};
  continuity_stage<T, RX, RY, TileT, 0, THREADS>(c, h, ua, va, h1, fx, fy,
                                                 sc, false);

  // S3: the gates and Flather on the tile; write h1, u1, v1
  for (int k_ = tid; k_ < TX * TY; k_ += THREADS) {
    const int jj = k_ / TX;
    const int ii = k_ % TX;
    if (!o.valid(jj, ii)) continue;
    const int s = (W + jj) * RX + WX + ii;
    const long g = ob + o.at(jj, ii);
    T uo[NZ], vo[NZ];
LAYER_LOOP
    for (int k = 0; k < NZ; ++k) {
      uo[k] = ua[k * NPT + s];
      vo[k] = va[k * NPT + s];
    }
    finalize_point<T, RX, NPT>(c, h1, s, uo, vo);
LAYER_LOOP
    for (int k = 0; k < NZ; ++k) {
      out_h[k * p.plane + g] = h1[k * NPT + s];
      out_u[k * p.plane + g] = uo[k];
      out_v[k * p.plane + g] = vo[k];
    }
  }
}

// One CTA per tile of one device's grid
template <typename T>
__device__ __forceinline__ void run(const Params<T>& p, const T* pres,
                                    T corr, T* out_h, T* out_u, T* out_v) {
  const int ty0 = int(blockIdx.y) * TY;
  const int tx0 = int(blockIdx.x) * TX;
  run_at<T, false>(p, pres, corr, out_h, out_u, out_v,
                   Out{ty0, tx0, p.ny, p.nx, p.plane}, 0, ty0, tx0, Stack{});
}

// One CTA per tile of every shard of a mesh on one device, every operand
// stacked
template <typename T>
__device__ __forceinline__ void run_shards(const Params<T>& p,
                                           const Stack& m,
                                           BasesArg<T> pres, T corr,
                                           T* out_h, T* out_u, T* out_v) {
  const ShardTile t = shard_tile(m, TX, TY);
  run_at<T, true>(p, pres, corr, out_h, out_u, out_v, t.out(m, p.plane),
                  t.base(m), t.gy0, t.gx0, m);
}

}  // namespace pbs

}  // namespace prj
}  // namespace beom
