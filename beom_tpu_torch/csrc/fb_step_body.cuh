// The stages of one fused forward-backward step on a haloed tile in shared
// memory, shared by the single-device step (fb_step.cu, K1) and the shard
// step under a mesh (shard_step.cu, K7); the pass of KB steps on one tile
// (namespace fbp), which runs the same stages on the shrinking regions of
// a block with a halo of KB W; and the layer-streamed step (namespace
// fbs).  The two kernels differ in where a
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
  return table_bytes(N_PLANES * NPT * long(sizeof(T)), NPT);
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
                                          const Off* gidx,
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
    for (int k = 0; k < NZ; ++k) a1[k * NPT + s] = c.sweep1(k, s, p.u_first);
  })

  // S4: the second sweep on the interior, the gates, Flather, write back
  for (int k_ = tid; k_ < TX * TY; k_ += THREADS) {
    const int jj = k_ / TX;
    const int ii = k_ % TX;
    if (!store.valid(jj, ii)) continue;
    const int s = (W + jj) * RX + W + ii;
    T uo[NZ], vo[NZ];
LAYER_LOOP
    for (int k = 0; k < NZ; ++k) c.sweep2(k, s, p.u_first, a1, uo[k], vo[k]);
    finalize_point<T, RX, NPT>(c, h1, s, uo, vo);
LAYER_LOOP
    for (int k = 0; k < NZ; ++k)
      store.put(jj, ii, k, h1[k * NPT + s], uo[k], vo[k]);
  }
}

}  // namespace fbk

// The pass: KB fb steps of one TY x TX tile in one CTA.  The block holds the
// tile with a halo of KB W points on both axes; step i runs S1 to S4 on the
// block's region [i W, R - i W), so its new h, u, v are valid on
// [(i + 1) W, R - (i + 1) W), and the last step's interior is the tile.
// Every static the switches read is staged into a shared-memory plane once
// per launch; h, u, v, h1 and a spare are five groups of NZ planes whose
// roles rotate from step to step (after S1 the old h is free and takes the
// new u, the spare the new v, so S4 reads the old u and v at neighbouring
// points while it writes).
namespace fbp {

using fbk::W;
constexpr int HALO = KB * W;
constexpr int RX = TX + 2 * HALO;
constexpr int RY = TY + 2 * HALO;
constexpr int NPT = RX * RY;
constexpr int NTD = OBC ? NTIDE : 0;

// shared-memory planes: the five rotating groups, the step's intermediates
// (fluxes and scales alias phi, q and a1 as in K1), then the statics
enum Plane {
  Q_DYN = 0,
  Q_PHI = 5 * NZ,
  Q_Q = Q_PHI + NZ,
  Q_A1 = Q_Q + NZ,
  Q_LU = Q_A1 + NZ,
  Q_LV = Q_LU + (NU4 ? NZ : 0),
  Q_EE = Q_LV + (NU4 ? NZ : 0),
  Q_M = Q_EE + (OBC ? 1 : 0),
  Q_MU,
  Q_MV,
  Q_MQ,
  Q_HB,
  Q_FQ,
  Q_TAUX,
  Q_TAUY = Q_TAUX + (WIND ? 1 : 0),
  Q_SPONGE = Q_TAUY + (WIND ? 1 : 0),
  Q_HEXT = Q_SPONGE + (SPONGE ? 1 : 0),
  Q_OBCU = Q_HEXT + ((SPONGE || OBC) ? NZ : 0),
  Q_OBCV = Q_OBCU + (OBC ? 1 : 0),
  Q_OBCH = Q_OBCV + (OBC ? 1 : 0),
  Q_AMP = Q_OBCH + (OBC ? 1 : 0),
  Q_PHASE = Q_AMP + NTD,
  N_PLANES = Q_PHASE + NTD
};

// the plane that stages operand slot i (fb_terms.cuh: Ptr)
__host__ __device__ constexpr int plane_of(int i) {
  return i == I_MASK     ? Q_M
         : i == I_MASK_U ? Q_MU
         : i == I_MASK_V ? Q_MV
         : i == I_MASK_Q ? Q_MQ
         : i == I_HB     ? Q_HB
         : i == I_FQ     ? Q_FQ
         : i == I_TAUX   ? Q_TAUX
         : i == I_TAUY   ? Q_TAUY
         : i == I_SPONGE ? Q_SPONGE
         : i == I_HEXT   ? Q_HEXT
         : i == I_OBC_U  ? Q_OBCU
         : i == I_OBC_V  ? Q_OBCV
         : i == I_OBC_H  ? Q_OBCH
         : i == I_TIDE_AMP ? Q_AMP
                           : Q_PHASE;
}

// the block's row and column offsets into the grid follow the planes
template <typename T>
constexpr int smem_bytes() {
  return table_bytes(N_PLANES * NPT * sizeof(T), RX + RY);
}

// the statics as the stages read them: from their staged planes
template <typename T>
struct PlaneStat {
  const T* sm;
  __device__ __forceinline__ T get(const Params<T>&, int i, int s) const {
    return sm[plane_of(i) * NPT + s];
  }
  __device__ __forceinline__ T get(const Params<T>&, int i, int k,
                                   int s) const {
    return sm[(plane_of(i) + k) * NPT + s];
  }
};

// an asynchronous copy of BYTES (4, 8 or 16) from global to shared memory
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(BYTES)
                 : "memory");
#else
  __builtin_memcpy(dst, src, BYTES);
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// wait until at most N committed groups of copies are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// S0: layers [0, nl) of operand slot i into the planes from dst, every
// block point.  A block that lies inside the grid on x, in a grid whose
// rows start 16-byte aligned (its width and the operands' addresses),
// copies its rows in 16-byte pieces from column x0 on; any other block
// point by point through the offsets (periodic on both axes).  With SH
// (the stacked shards of a mesh, shard_addr.cuh: Stack) a piece's offset
// is its first column's: where x0 and the shards' width are multiples of
// the piece, no piece straddles a shard's edge or the grid's, so every
// block copies in pieces.
template <typename T, bool SH = false>
__device__ __forceinline__ void stage(const Params<T>& p, int i, int nl,
                                      T* dst, const Off* roff,
                                      const Off* coff, int x0, bool vec) {
  constexpr int VW = 16 / int(sizeof(T));
  BasesArg<T> src = p.in[i];
  if (RX % VW == 0 && vec) {
    constexpr int NV = RX / VW;
    for (int e = threadIdx.x; e < nl * RY * NV; e += THREADS) {
      const int k = e / (RY * NV);
      const int r = (e / NV) % RY;
      const int c = (e % NV) * VW;
      cp_async<16>(dst + k * NPT + r * RX + c,
                   src + (k * p.plane + roff[r] +
                          (SH ? coff[c] : Off(x0 + c))));
    }
    return;
  }
  for (int e = threadIdx.x; e < nl * NPT; e += THREADS) {
    const int k = e / NPT;
    const int s = e % NPT;
    cp_async<int(sizeof(T))>(
        dst + e, src + (k * p.plane + roff[s / RX] + coff[s % RX]));
  }
}

// S0 of the pass: h, u, v into groups 0, 1, 2 and every static the
// switches read into its plane, in two groups of copies: what step 0's S1
// reads, then mask_q (unless the biharmonic's S1 reads it), H, f_q, the
// wind and the Flather maps, which S2 to S4 read (pass_step waits for them
// after S1, so that they arrive while S1 computes).  (y0, x0) is the
// block's first point in the grid.  With SH every operand is stacked over
// the shards of a mesh (shard_addr.cuh: Stack).  Returns after a
// __syncthreads() that follows the first group.
template <typename T, bool SH = false>
__device__ __forceinline__ void load_block(const Params<T>& p, T* sm,
                                           int y0, int x0,
                                           const Stack& m = Stack{}) {
  Off* roff = off_table(sm, N_PLANES * NPT);
  Off* coff = roff + RY;
  for (int r = threadIdx.x; r < RY; r += THREADS)
    roff[r] = SH ? m.row(wrap(y0 + r, p.ny)) : Off(wrap(y0 + r, p.ny) * p.nx);
  for (int c = threadIdx.x; c < RX; c += THREADS)
    coff[c] = SH ? m.col(wrap(x0 + c, p.nx)) : Off(wrap(x0 + c, p.nx));
  __syncthreads();
  constexpr int VW = 16 / int(sizeof(T));
  const bool vec =
      SH ? p.aligned && x0 % VW == 0 && m.lx % VW == 0
         : p.aligned && x0 >= 0 && x0 + RX <= p.nx && x0 % VW == 0 &&
               p.nx % VW == 0;
  stage<T, SH>(p, I_H, NZ, sm + 0 * NZ * NPT, roff, coff, x0, vec);
  stage<T, SH>(p, I_U, NZ, sm + 1 * NZ * NPT, roff, coff, x0, vec);
  stage<T, SH>(p, I_V, NZ, sm + 2 * NZ * NPT, roff, coff, x0, vec);
  stage<T, SH>(p, I_MASK, 1, sm + Q_M * NPT, roff, coff, x0, vec);
  stage<T, SH>(p, I_MASK_U, 1, sm + Q_MU * NPT, roff, coff, x0, vec);
  stage<T, SH>(p, I_MASK_V, 1, sm + Q_MV * NPT, roff, coff, x0, vec);
  if (NU4) stage<T, SH>(p, I_MASK_Q, 1, sm + Q_MQ * NPT, roff, coff, x0, vec);
  if (SPONGE) stage<T, SH>(p, I_SPONGE, 1, sm + Q_SPONGE * NPT, roff, coff, x0, vec);
  if (SPONGE || OBC)
    stage<T, SH>(p, I_HEXT, NZ, sm + Q_HEXT * NPT, roff, coff, x0, vec);
  if (OBC) {
    stage<T, SH>(p, I_OBC_H, 1, sm + Q_OBCH * NPT, roff, coff, x0, vec);
    stage<T, SH>(p, I_TIDE_AMP, NTD, sm + Q_AMP * NPT, roff, coff, x0, vec);
    stage<T, SH>(p, I_TIDE_PHASE, NTD, sm + Q_PHASE * NPT, roff, coff, x0, vec);
  }
  cp_async_commit();
  if (!NU4) stage<T, SH>(p, I_MASK_Q, 1, sm + Q_MQ * NPT, roff, coff, x0, vec);
  stage<T, SH>(p, I_HB, 1, sm + Q_HB * NPT, roff, coff, x0, vec);
  stage<T, SH>(p, I_FQ, 1, sm + Q_FQ * NPT, roff, coff, x0, vec);
  if (WIND) {
    stage<T, SH>(p, I_TAUX, 1, sm + Q_TAUX * NPT, roff, coff, x0, vec);
    stage<T, SH>(p, I_TAUY, 1, sm + Q_TAUY * NPT, roff, coff, x0, vec);
  }
  if (OBC) {
    stage<T, SH>(p, I_OBC_U, 1, sm + Q_OBCU * NPT, roff, coff, x0, vec);
    stage<T, SH>(p, I_OBC_V, 1, sm + Q_OBCV * NPT, roff, coff, x0, vec);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
}

// Step i of the pass (A = i W): S1 to S4 of fb_step on the region
// [A, R - A) from the planes h, u, v, with the sweep order u_first and the
// tides at t1.  The last step writes the tile's interior through `store`;
// any other writes the new u and v into the planes nu and nv on
// [A + W, R - A - W) (the new h is h1) and ends with a __syncthreads().
template <typename T, int A, bool LAST, typename Store>
__device__ __forceinline__ void pass_step(const Params<T>& p, T* sm,
                                          int u_first, T t1, const T* h,
                                          const T* u, const T* v, T* h1,
                                          T* nu, T* nv, const Store& store) {
  T* mask = sm + Q_M * NPT;
  T* mu = sm + Q_MU * NPT;
  T* mv = sm + Q_MV * NPT;
  T* mq = sm + Q_MQ * NPT;
  T* phi = sm + Q_PHI * NPT;
  T* q = sm + Q_Q * NPT;
  T* a1 = sm + Q_A1 * NPT;
  T* lu = sm + Q_LU * NPT;
  T* lv = sm + Q_LV * NPT;
  T* ee = sm + Q_EE * NPT;
  const int tid = threadIdx.x;
  using TileT = Tile<T, RX, NPT, PlaneStat<T>>;
  const TileT c{p, PlaneStat<T>{sm}, u, v, mask, mu, mv, mq, h1,
                phi, q, lu, lv, ee};

  // obc.eta_ext at this step's t1, as load_eta_ext
  if (OBC) {
    REGION(A, A, {
      T e = T(0);
      for (int cc = 0; cc < NTIDE; ++cc)
        e = e + sm[(Q_AMP + cc) * NPT + s] *
                    tcos(p.omega[cc] * t1 - sm[(Q_PHASE + cc) * NPT + s]);
      ee[s] = e;
    })
  }

  // S1: lap planes for the biharmonic, then the continuity
  if (NU4) {
    REGION_NS(A + 1, A + 1, {
      for (int k = 0; k < NZ; ++k) {
        lu[k * NPT + s] = c.lap_u(u + k * NPT, s);
        lv[k * NPT + s] = c.lap_v(v + k * NPT, s);
      }
    })
  }
  continuity_stage<T, RX, RY, TileT, A>(c, h, u, v, h1, phi, q, a1, true);
  if (A == 0) {       // S0's second group of copies
    cp_async_wait<0>();
    __syncthreads();
  }

  // S2: phi = M (+ K) and the PV from the new thickness
  REGION(A + LO, A + LO + 1, { c.phi_q(s, true, phi, q); })

  // S3: the first FB-Coriolis sweep, u on even steps, v on odd ones
  REGION(A + LO + 1, A + LO + 2, {
    for (int k = 0; k < NZ; ++k) {
      T a;
      if (u_first) {
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

  // S4: the second sweep, the gates, Flather
  auto second = [&](int s, T* uo, T* vo) {
LAYER_LOOP
    for (int k = 0; k < NZ; ++k) {
      if (u_first) {
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
  };
  if (LAST) {
    for (int k_ = tid; k_ < TX * TY; k_ += THREADS) {
      const int jj = k_ / TX;
      const int ii = k_ % TX;
      if (!store.valid(jj, ii)) continue;
      const int s = (HALO + jj) * RX + HALO + ii;
      T uo[NZ], vo[NZ];
      second(s, uo, vo);
LAYER_LOOP
      for (int k = 0; k < NZ; ++k)
        store.put(jj, ii, k, h1[k * NPT + s], uo[k], vo[k]);
    }
  } else {
    REGION(A + W, A + W, {
      T uo[NZ], vo[NZ];
      second(s, uo, vo);
      for (int k = 0; k < NZ; ++k) {
        nu[k * NPT + s] = uo[k];
        nv[k * NPT + s] = vo[k];
      }
    })
  }
}

// steps I.. of the pass, with the groups of planes that hold h, u, v, h1
// and the spare at step I; step I alternates the sweep order of step 0
template <typename T, int I, int GH, int GU, int GV, int GH1, int GSP,
          typename Store>
__device__ __forceinline__ void pass_steps(const Params<T>& p, T* sm,
                                           const Store& store) {
  if constexpr (I < KB) {
    T* g = sm;
    constexpr int G = NZ * NPT;
    pass_step<T, I * W, I == KB - 1>(
        p, sm, (I % 2 == 0) ? p.u_first : 1 - p.u_first, p.ts[I], g + GH * G,
        g + GU * G, g + GV * G, g + GH1 * G, g + GH * G, g + GSP * G, store);
    pass_steps<T, I + 1, GH1, GH, GSP, GU, GV>(p, sm, store);
  }
}

}  // namespace fbp

// The layer-streamed single step (fb_step.cu with BEOM_STREAM = 1, and
// K7's on the shards, shard_step.cu): K1 where no tile's planes of every
// layer fit a CTA's shared memory.  Its
// shared memory holds a few planes of one layer, whatever NZ, and a step
// is two launches over the tiles, each looping over the layers from the
// surface (`#pragma unroll 1`, so that a build's code does not grow with
// NZ) with the arithmetic of fbk in its order:
//   cont  S1's continuity of layer k on blocks with a halo of LO, its h1
//         written on the tile: after the launch out_h holds h1 everywhere;
//   mom   the column's sum of h1 read from out_h; then for each layer its
//         h1, u and v on blocks with a halo of 3 (h1 is read, not
//         computed, so S2 to S4 need no more), S1's biharmonic planes, S2
//         with the Montgomery potential's running sums z and acc in two
//         planes, S3, and S4 with the gates, writing the layer's u and v;
//         Flather's column sums are kept in registers (a thread keeps the
//         same interior points in every layer) and its increment added to
//         every layer's u and v afterwards, the same one addition
//         uo[k] + u_inc of finalize_point.  The interfacial drag's old u
//         and v of layers k +- 1 come from device memory.
namespace fbs {

// the tile's points each thread keeps: point i is tid + i THREADS
constexpr int PPT = (TX * TY + THREADS - 1) / THREADS;

// The interior point i of this thread in a block of halo W and width RX:
// whether it is written (o.valid), and its row, column and block index
template <int W, int RX>
__device__ __forceinline__ bool point(const Out& o, int i, int& jj, int& ii,
                                      int& s) {
  const int k_ = int(threadIdx.x) + i * THREADS;
  jj = k_ / TX;
  ii = k_ % TX;
  s = (W + jj) * RX + W + ii;
  return k_ < TX * TY && o.valid(jj, ii);
}

// Flather over a streamed column at a thread's interior points: the sums
// of each layer's gated u and v as they are written (add), then the
// increment added to every layer's u and v written there (fix), the same
// one addition uo[k] + u_inc of finalize_point, skipped only where it
// changes no value (a zero increment leaves any value but -0 and a NaN as
// it is)
template <typename T, int W, int RX>
struct Column {
  Flather<T> fl[PPT];
  bool redo_u[PPT], redo_v[PPT];

  __device__ __forceinline__ static bool not_fixed(T x) {
    return x != x || (x == T(0) && T(1) / x < T(0));
  }
  __device__ __forceinline__ void add(const Params<T>& p, int i, int k,
                                      const T* h1, int s, T uo, T vo) {
    fl[i].add(p, k, h1[s], h1[s + 1], h1[s + RX], uo, vo);
    redo_u[i] = (k > 0 && redo_u[i]) || not_fixed(uo);
    redo_v[i] = (k > 0 && redo_v[i]) || not_fixed(vo);
  }
  template <typename TileT>
  __device__ __forceinline__ void fix(const TileT& c, const Out& o, T* out_u,
                                      T* out_v) const {
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      int jj, ii, s;
      if (!point<W, RX>(o, i, jj, ii, s)) continue;
      T u_inc, v_inc;
      fl[i].template incs<RX>(c, s, u_inc, v_inc);
      const bool du = !(u_inc == T(0)) || redo_u[i];
      const bool dv = !(v_inc == T(0)) || redo_v[i];
      if (!du && !dv) continue;
      const long g = o.at(jj, ii);
#pragma unroll 1
      for (int k = 0; k < NZ; ++k) {
        const long gk = k * o.plane + g;
        if (du) out_u[gk] = out_u[gk] + u_inc;
        if (dv) out_v[gk] = out_v[gk] + v_inc;
      }
    }
  }
};

namespace cont {

constexpr int W = LO;
constexpr int RX = TX + 2 * W;
constexpr int RY = TY + 2 * W;
constexpr int NPT = RX * RY;
enum Plane {
  P_H = 0,
  P_U,
  P_V,
  P_H1,
  P_M,
  P_MU,
  P_MV,
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
// points written through o into out_h (the output at the tile's shard's
// block, or the grid's); with SH every operand is stacked over the shards
// of m (shard_addr.cuh: block_offsets)
template <typename T, bool SH>
__device__ __forceinline__ void run_at(const Params<T>& p, const Stack& m,
                                       int gy0, int gx0, const Out& o,
                                       T* out_h) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  Off* gidx = off_table(sm, N_PLANES * NPT);
  T* h = sm + P_H * NPT;
  T* u = sm + P_U * NPT;
  T* v = sm + P_V * NPT;
  T* h1 = sm + P_H1 * NPT;
  T* mask = sm + P_M * NPT;
  T* mu = sm + P_MU * NPT;
  T* mv = sm + P_MV * NPT;
  T* ee = sm + P_EE * NPT;
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
  using TileT = Tile<T, RX, NPT, GlobStat<T>, 0>;
  const TileT c{p, gidx, u, v, mask, mu, mv, nullptr, h1,
                nullptr, nullptr, nullptr, nullptr, ee};
#pragma unroll 1
  for (int k = 0; k < NZ; ++k) {
    // the loads write no plane the last layer's store reads, and the
    // barrier below orders that store before this layer's continuity
    for (int s = tid; s < NPT; s += THREADS) {
      const auto g = k * p.plane + gidx[s];
      h[s] = p.in[I_H][g];
      u[s] = p.in[I_U][g];
      v[s] = p.in[I_V][g];
    }
    __syncthreads();
    continuity_stage<T, RX, RY, TileT, 0, THREADS, 1>(
        c, h, u, v, h1, sm + P_FX * NPT, sm + P_FY * NPT, sm + P_SC * NPT,
        true, k);
    for (int k_ = tid; k_ < TX * TY; k_ += THREADS) {
      const int jj = k_ / TX;
      const int ii = k_ % TX;
      if (o.valid(jj, ii))
        out_h[k * o.plane + o.at(jj, ii)] = h1[(W + jj) * RX + W + ii];
    }
  }
}

}  // namespace cont

namespace mom {

constexpr int W = 3;
constexpr int RX = TX + 2 * W;
constexpr int RY = TY + 2 * W;
constexpr int NPT = RX * RY;
enum Plane {
  P_H1 = 0,
  P_U,
  P_V,
  P_PHI,
  P_Q,
  P_A1,
  P_LU,
  P_LV = P_LU + (NU4 ? 1 : 0),
  P_Z = P_LV + (NU4 ? 1 : 0),
  P_ACC,
  P_M,
  P_MU,
  P_MV,
  P_MQ,
  P_EE,
  N_PLANES = P_EE + (OBC ? 1 : 0)
};

template <typename T>
constexpr int smem_bytes() {
  return table_bytes(N_PLANES * NPT * long(sizeof(T)), NPT);
}

// The tile whose first point is the grid's (gy0, gx0), as cont::run_at;
// h1g is cont's output, read at the block's points (across cards its nine
// stacks: the halo may lie on a neighbour card)
template <typename T, bool SH>
__device__ __forceinline__ void run_at(const Params<T>& p, const Stack& m,
                                       int gy0, int gx0, const Out& o,
                                       BasesArg<T> h1g, T* out_u, T* out_v) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  Off* gidx = off_table(sm, N_PLANES * NPT);
  T* h1 = sm + P_H1 * NPT;
  T* u = sm + P_U * NPT;
  T* v = sm + P_V * NPT;
  T* phi = sm + P_PHI * NPT;
  T* q = sm + P_Q * NPT;
  T* a1 = sm + P_A1 * NPT;
  T* lu = sm + P_LU * NPT;
  T* lv = sm + P_LV * NPT;
  T* zp = sm + P_Z * NPT;
  T* acc = sm + P_ACC * NPT;
  T* mask = sm + P_M * NPT;
  T* mu = sm + P_MU * NPT;
  T* mv = sm + P_MV * NPT;
  T* mq = sm + P_MQ * NPT;
  T* ee = sm + P_EE * NPT;
  const int tid = threadIdx.x;
  block_offsets<T, RX, RY, SH>(p, m, gidx, gy0 - W, gx0 - W);
  __syncthreads();
  for (int s = tid; s < NPT; s += THREADS) {
    const Off g = gidx[s];
    mask[s] = p.in[I_MASK][g];
    mu[s] = p.in[I_MASK_U][g];
    mv[s] = p.in[I_MASK_V][g];
    mq[s] = p.in[I_MASK_Q][g];
  }
  if (OBC) load_eta_ext<T, NPT>(p, gidx, ee);
  // phi_q's z and acc of layer 0 on S2's region: the column's h1 summed
  // from the surface
  REGION_NS(1, 1, {
    const Off g = gidx[s];
    T hs = h1g[g];
    for (int k = 1; k < NZ; ++k) hs = hs + h1g[k * p.plane + g];
    const T z = hs - p.in[I_HB][g];
    zp[s] = z;
    acc[s] = p.gp[0] * z;
  })
  using TileT = Tile<T, RX, NPT, GlobStat<T>, 0>;
  const TileT c{p, gidx, u, v, mask, mu, mv, mq, h1,
                phi, q, lu, lv, ee};
  Column<T, W, RX> col;

#pragma unroll 1
  for (int k = 0; k < NZ; ++k) {
    for (int s = tid; s < NPT; s += THREADS) {
      const auto g = k * p.plane + gidx[s];
      h1[s] = h1g[g];
      u[s] = p.in[I_U][g];
      v[s] = p.in[I_V][g];
    }
    __syncthreads();

    // S1's lap planes for the biharmonic; S2, phi = M + K and the PV, and
    // the running sums of the next layer
    REGION(1, 1, {
      if (NU4) {
        lu[s] = c.lap_u(u, s);
        lv[s] = c.lap_v(v, s);
      }
      c.phi_q_layer(k, s, acc[s], c.glob(I_FQ, s), phi, q);
      if (k + 1 < NZ) {
        const T z = zp[s] - h1[s];
        zp[s] = z;
        acc[s] = acc[s] + p.gp[k + 1] * z;
      }
    })

    // S3: the first FB-Coriolis sweep, u on even steps, v on odd ones
    REGION(2, 2, { a1[s] = c.sweep1(k, s, p.u_first); })

    // S4: the second sweep on the interior and the gates; the layer's u
    // and v written, Flather's sums taken
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      int jj, ii, s;
      if (!point<W, RX>(o, i, jj, ii, s)) continue;
      T uo, vo;
      c.sweep2(k, s, p.u_first, a1, uo, vo);
      if (WETDRY) gate_point<T, RX>(c, h1, s, uo, vo);
      if (OBC) col.add(p, i, k, h1, s, uo, vo);
      const long g = k * o.plane + o.at(jj, ii);
      out_u[g] = uo;
      out_v[g] = vo;
    }
    // before the next layer's loads overwrite the planes
    __syncthreads();
  }
  if (OBC) col.fix(c, o, out_u, out_v);
}

}  // namespace mom
}  // namespace fbs
}  // namespace beom
