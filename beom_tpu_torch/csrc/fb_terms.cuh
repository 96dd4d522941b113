// Term code shared by the fused forward-backward step (fb_step.cu) and the
// split step's kernels (split_step.cu): the operands of a step, the haloed
// tile in shared memory, and one __device__ function for each term of
// beom_tpu_torch/stepping/fb.py and the physics modules under it.
//
// A build is made for one combination of compile-time switches (-D flags,
// set by stencils/fused_fb.py from the Config): the layer count, the term
// switches and the tile.  A switch that is off costs no shared-memory
// plane, no operand and no instruction.
//
// Arithmetic mirrors the eager port op for op, in its association, with the
// scalars rounded from the host's doubles as PyTorch rounds a Python scalar
// to the tensor's type, and --fmad=false at build time.  Each kernel is
// then equal to its plain version on the card bit for bit.  Three rules of
// PyTorch's own CUDA kernels are mirrored where they show:
//   * clamp_min / clamp_max pass a NaN in the tensor on (vmax, vmin),
//     torch.minimum passes a NaN on either side (tmin);
//   * `tensor / python_scalar` multiplies by the reciprocal rounded in the
//     tensor's type (rdx, rdy, 1 / nsub), and `python_scalar / tensor` is
//     tensor.reciprocal() * scalar (Flather's sqrt(g / H));
//   * a layer sum adds the layers in order from the surface (ops.sum_k).

#pragma once

#include <cuda_runtime.h>

#ifndef BEOM_NZ
#define BEOM_NZ 1
#endif
#ifndef BEOM_WETDRY
#define BEOM_WETDRY 0
#endif
#ifndef BEOM_OBC
#define BEOM_OBC 0
#endif
#ifndef BEOM_SPONGE
#define BEOM_SPONGE 0
#endif
#ifndef BEOM_NTIDE
#define BEOM_NTIDE 0
#endif
#ifndef BEOM_NU4
#define BEOM_NU4 0
#endif
#ifndef BEOM_CDBOT
#define BEOM_CDBOT 0
#endif
#ifndef BEOM_RINT
#define BEOM_RINT 0
#endif
#ifndef BEOM_NSUB
#define BEOM_NSUB 8
#endif
#ifndef BEOM_SX
#define BEOM_SX 64
#endif
#ifndef BEOM_SY
#define BEOM_SY 32
#endif
#ifndef BEOM_TX
#define BEOM_TX 32
#endif
#ifndef BEOM_TY
#define BEOM_TY 16
#endif
#ifndef BEOM_THREADS
#define BEOM_THREADS 256
#endif
// the split step's tail (subcycle + recomposition in one launch): its tile
// width, and its strips per column and rows per strip (split_body.cuh)
#ifndef BEOM_QX
#define BEOM_QX 44
#endif
#ifndef BEOM_QS
#define BEOM_QS 16
#endif
#ifndef BEOM_QP
#define BEOM_QP 4
#endif
// the fb pass kernel: its steps per launch, and whether the wind planes are
// staged (the Config's wind)
#ifndef BEOM_KB
#define BEOM_KB 1
#endif
#ifndef BEOM_WIND
#define BEOM_WIND 1
#endif
// the shard kernels of a mesh over several cards (shard_addr.cuh)
#ifndef BEOM_CARDS
#define BEOM_CARDS 0
#endif
// the layer-streamed route: K1's single step, K1s's slow phase and
// recomposition and both projection phases one layer at a time, their
// shared memory a few planes of one layer whatever NZ (fb_step_body.cuh:
// fbs; split_body.cuh: sps; projection_body.cuh: pal, pbl; the shard
// kernels of K7 run them too), where no tile's planes of every layer fit a
// CTA's shared memory or the plans take it
#ifndef BEOM_STREAM
#define BEOM_STREAM 0
#endif

namespace beom {

constexpr int NZ = BEOM_NZ;
constexpr bool WETDRY = BEOM_WETDRY;
constexpr bool OBC = BEOM_OBC;
constexpr bool SPONGE = BEOM_SPONGE;
constexpr int NTIDE = BEOM_NTIDE;
constexpr bool NU4 = BEOM_NU4;
constexpr bool CDBOT = BEOM_CDBOT;
constexpr bool RINT = BEOM_RINT && BEOM_NZ > 1;
constexpr int TX = BEOM_TX;
constexpr int TY = BEOM_TY;
// the split step's subcycle: its substeps and its own tile
constexpr int NSUB = BEOM_NSUB;
constexpr int SX = BEOM_SX;
constexpr int SY = BEOM_SY;
constexpr int THREADS = BEOM_THREADS;
constexpr int QX = BEOM_QX;
constexpr int QS = BEOM_QS;
constexpr int QP = BEOM_QP;
constexpr int KB = BEOM_KB;
constexpr bool WIND = BEOM_WIND;
constexpr bool STREAM = BEOM_STREAM;
// first block index at which the continuity's h1 is valid: the limiter
// reaches one cell further than the plain flux divergence
constexpr int LO = WETDRY ? 2 : 1;

// The loops over the layers whose values a point keeps in arrays (its new
// velocities, the column sums): unrolled up to 8 layers, the arrays in
// registers; beyond, loops, the arrays in local memory, so that a build's
// code and its compile time do not grow with NZ.  The operations and
// their order are the same either way.
#if BEOM_NZ <= 8
#define LAYER_LOOP _Pragma("unroll")
#else
#define LAYER_LOOP _Pragma("unroll 1")
#endif

// Operand slots of the C entry points; stencils/fused_fb.py fills them by
// these names, in this order.  A host table holds the N_PTR operands.
enum Ptr {
  I_H, I_U, I_V, I_HB, I_MASK, I_MASK_U, I_MASK_V, I_MASK_Q, I_FQ, I_TAUX,
  I_TAUY, I_SPONGE, I_HEXT, I_OBC_U, I_OBC_V, I_OBC_H, I_TIDE_AMP,
  I_TIDE_PHASE, N_PTR
};
enum Int { J_NY, J_NX, J_U_FIRST, J_SADOURNY, J_FREE_SLIP, J_VISC, J_WIND,
           J_NSUB, J_ALIGNED, N_INT };
// steps a launch of the fb pass kernel may advance: the slots of Params::ts
constexpr int MAX_KB = 8;
// the slots of the tidal frequencies: one per constituent, at least one
constexpr int NTIDE_SLOTS = NTIDE > 0 ? NTIDE : 1;
// The double slots, sized by the build: NZ reduced gravities, NTIDE_SLOTS
// tidal frequencies, MAX_KB step times (fused_fb.slot_layout mirrors it)
enum Dbl {
  D_DT, D_DX, D_DY, D_G, D_NU2, D_NU4, D_RHO0, D_HMIN, D_HDRY, D_RBOT,
  D_CDBOT, D_RINT, D_T1, D_GP0, D_OMEGA0 = D_GP0 + NZ,
  D_TS0 = D_OMEGA0 + NTIDE_SLOTS, N_DBL = D_TS0 + MAX_KB
};

// Where a point of an operand lies: its offset, and the pointer it is
// taken from.  On one device, and for the shards of a mesh that lie on one
// card, an offset is an int and an operand one pointer.  Across cards
// (a build with BEOM_CARDS = 1, shard_addr.cuh) an offset is card-local and
// carries the card class of the point in its bits from CLASS_SHIFT: 3 rc +
// cc for the card rc, cc in {0: this card, 1: the next, 2: the previous}
// along y and x, so that a row term and a column term add into the class,
// and an operand is the nine base pointers of its stacks on the card and
// its neighbours (Bases).  An offset with no class bits is on the card.
#if BEOM_CARDS
constexpr int CLASS_SHIFT = 40;
struct Off {
  long long v;
  Off() = default;
  __host__ __device__ explicit constexpr Off(long long x) : v(x) {}
};
__device__ __forceinline__ Off operator+(Off a, Off b) {
  return Off(a.v + b.v);
}
__device__ __forceinline__ Off operator+(long long k, Off a) {
  return Off(k + a.v);
}
__device__ __forceinline__ Off operator+(Off a, long long k) {
  return Off(a.v + k);
}
template <typename T>
struct Bases {
  const T* b[9];
  // the point at o, in the stack of its class
  __device__ __forceinline__ const T* operator+(Off o) const {
    return b[o.v >> CLASS_SHIFT] + (o.v & ((1LL << CLASS_SHIFT) - 1));
  }
  __device__ __forceinline__ const T& operator[](Off o) const {
    return *(*this + o);
  }
  // every stack d values on (a layer's offset)
  __device__ __forceinline__ Bases operator+(long long d) const {
    Bases r;
#pragma unroll
    for (int c = 0; c < 9; ++c) r.b[c] = b[c] + d;
    return r;
  }
};
// the card's own stack of an operand
template <typename T>
__device__ __forceinline__ const T* own_base(const Bases<T>& a) {
  return a.b[0];
}
// how a stage function takes an operand: its nine bases in place
template <typename T>
using BasesArg = const Bases<T>&;
#else
using Off = int;
template <typename T>
using Bases = const T*;
template <typename T>
__device__ __forceinline__ const T* own_base(const T* a) {
  return a;
}
// a pointer by value, in a register
template <typename T>
using BasesArg = const T*;
#endif

// The bytes of a CTA's shared memory: `planes` bytes of planes, then n
// offsets (8-byte aligned across cards)
__host__ __device__ constexpr int table_bytes(long planes, int n) {
  return int((planes + alignof(Off) - 1) / alignof(Off) * alignof(Off) +
             n * long(sizeof(Off)));
}
// the first offset of the table that follows the planes at sm
template <typename T>
__device__ __forceinline__ Off* off_table(T* sm, long planes) {
  return reinterpret_cast<Off*>(reinterpret_cast<unsigned char*>(sm) +
                                table_bytes(planes * long(sizeof(T)), 0));
}

template <typename T>
struct Params {
  Bases<T> in[N_PTR];
  int ny, nx, u_first, sadourny, free_slip, visc, wind, nsub;
  int aligned;    // every operand starts 16-byte aligned
  T dt, inv_dx, inv_dy, rdx, rdy, g, nu2, nu4, rho0, h_min, h_dry, thin,
      r_bot, cd_bot, r_int, t1;
  T gp[NZ];
  T omega[NTIDE_SLOTS];
  T ts[MAX_KB];   // the fb pass kernel's t1 of each of its steps
  long plane;     // ny * nx
};

// Params is passed by value and grows with NZ and NTIDE.  A kernel's
// parameters may take 4096 bytes on every CUDA version and driver; Params
// leaves 1536 of them to a launch's other arguments, the largest of which
// are the shard recomposition's streamed velocity kernel's: its source of
// 19 stacked operands across cards, h1's nine stacks and two outputs,
// 1512 bytes (shard_split.cu checks the sum).  A build too large fails
// here, at compile time.  fused_fb.params_bytes mirrors the size.
constexpr int PARAM_LIMIT = 4096;
constexpr int PARAMS_MAX = PARAM_LIMIT - 1536;
static_assert(sizeof(Params<double>) <= PARAMS_MAX,
              "Params of this many layers and tidal constituents exceed "
              "the kernel-parameter budget");

template <typename T>
__host__ Params<T> make_params(const void* const* ptrs, const int* ints,
                               const double* d) {
  Params<T> p;
#if BEOM_CARDS
  // ptrs: the host tables of the nine classes, one after another
  for (int c = 0; c < 9; ++c)
    for (int i = 0; i < N_PTR; ++i)
      p.in[i].b[c] = static_cast<const T*>(ptrs[c * N_PTR + i]);
#else
  for (int i = 0; i < N_PTR; ++i) p.in[i] = static_cast<const T*>(ptrs[i]);
#endif
  p.ny = ints[J_NY];
  p.nx = ints[J_NX];
  p.u_first = ints[J_U_FIRST];
  p.sadourny = ints[J_SADOURNY];
  p.free_slip = ints[J_FREE_SLIP];
  p.visc = ints[J_VISC];
  p.wind = ints[J_WIND];
  p.nsub = ints[J_NSUB];
  p.aligned = ints[J_ALIGNED];
  p.dt = T(d[D_DT]);
  p.inv_dx = T(1.0 / d[D_DX]);
  p.inv_dy = T(1.0 / d[D_DY]);
  p.rdx = T(1) / T(d[D_DX]);
  p.rdy = T(1) / T(d[D_DY]);
  p.g = T(d[D_G]);
  p.nu2 = T(d[D_NU2]);
  p.nu4 = T(d[D_NU4]);
  p.rho0 = T(d[D_RHO0]);
  p.h_min = T(d[D_HMIN]);
  p.h_dry = T(d[D_HDRY]);
  p.thin = T(2.0 * d[D_HDRY]);
  p.r_bot = T(d[D_RBOT]);
  p.cd_bot = T(d[D_CDBOT]);
  p.r_int = T(d[D_RINT]);
  p.t1 = T(d[D_T1]);
  for (int k = 0; k < NZ; ++k) p.gp[k] = T(d[D_GP0 + k]);
  for (int c = 0; c < NTIDE; ++c) p.omega[c] = T(d[D_OMEGA0 + c]);
  for (int i = 0; i < MAX_KB; ++i) p.ts[i] = T(d[D_TS0 + i]);
  p.plane = long(p.ny) * p.nx;
  return p;
}

// tiles of tx x ty on a grid of ny x nx points
__host__ __device__ inline dim3 tiles_of(int ny, int nx, int tx, int ty) {
  return dim3((nx + tx - 1) / tx, (ny + ty - 1) / ty);
}

__device__ __forceinline__ int wrap(int a, int n) {
  a %= n;
  return a < 0 ? a + n : a;
}

// torch.clamp_min(a, b) / clamp_max(a, b): a NaN in a propagates
template <typename T>
__device__ __forceinline__ T vmax(T a, T b) {
  return (a > b || a != a) ? a : b;
}
template <typename T>
__device__ __forceinline__ T vmin(T a, T b) {
  return (a < b || a != a) ? a : b;
}
// torch.minimum(a, b): a NaN on either side propagates
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}
__device__ __forceinline__ float tcos(float x) { return cosf(x); }
__device__ __forceinline__ double tcos(double x) { return cos(x); }
__device__ __forceinline__ float tsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double tsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float tabs(float x) { return fabsf(x); }
__device__ __forceinline__ double tabs(double x) { return fabs(x); }

// loop over the region [lo, R - hi) of the block on both axes; RX, RY and
// tid are in scope
#define REGION_NS(lo, hi, ...)                                      \
  {                                                                 \
    constexpr int nx_ = RX - (lo) - (hi);                           \
    constexpr int ny_ = RY - (lo) - (hi);                           \
    for (int k_ = tid; k_ < nx_ * ny_; k_ += THREADS) {             \
      const int s = ((lo) + k_ / nx_) * RX + (lo) + k_ % nx_;       \
      __VA_ARGS__                                                   \
    }                                                               \
  }
#define REGION(lo, hi, ...)       \
  REGION_NS(lo, hi, __VA_ARGS__)  \
  __syncthreads();

// Where a tile reads the statics (the operand slots past I_V): through the
// block's table of global offsets, one per point
template <typename T>
struct GlobStat {
  const Off* gidx;
  __device__ __forceinline__ T get(const Params<T>& p, int i, int s) const {
    return p.in[i][gidx[s]];
  }
  __device__ __forceinline__ T get(const Params<T>& p, int i, int k,
                                   int s) const {
    return p.in[i][k * p.plane + gidx[s]];
  }
};

// A haloed tile: shared-memory planes of NPT = RX * RY points, the layer k
// of a field at + k * LS (LS = NPT: every layer's planes; LS = 0: the
// planes of the one layer a layer-streamed body holds), and where its
// statics are read (Stat: GlobStat, or planes staged in shared memory).
template <typename T, int RX_, int NPT_, typename Stat = GlobStat<T>,
          int LS = NPT_>
struct Tile {
  static constexpr int RX = RX_;
  static constexpr int NPT = NPT_;
  const Params<T>& p;
  Stat st;
  const T *u, *v;            // (NZ planes) the velocities at time n
  const T *mask, *mu, *mv, *mq;
  const T* hn;               // (NZ planes) the thickness the terms see
  const T *phi, *q;          // (NZ planes)
  const T *lu, *lv;          // (NZ planes) lap(u), lap(v), with nu4
  const T* ee;               // tidal elevation at t1, with obc

  __device__ __forceinline__ T glob(int i, int s) const {
    return st.get(p, i, s);
  }
  __device__ __forceinline__ T glob(int i, int k, int s) const {
    return st.get(p, i, k, s);
  }

  // viscosity.lap_u / lap_v of a plane w
  __device__ __forceinline__ T lap_u(const T* w, int s) const {
    const T gx1 = ((w[s + 1] - w[s]) * p.inv_dx) * mask[s + 1];
    const T gx0 = ((w[s] - w[s - 1]) * p.inv_dx) * mask[s];
    T gy0 = (w[s + RX] - w[s]) * p.inv_dy;
    T gym = (w[s] - w[s - RX]) * p.inv_dy;
    if (p.free_slip) {
      gy0 = gy0 * mq[s];
      gym = gym * mq[s - RX];
    }
    return ((gx1 - gx0) * p.inv_dx + (gy0 - gym) * p.inv_dy) * mu[s];
  }
  __device__ __forceinline__ T lap_v(const T* w, int s) const {
    const T ey1 = ((w[s + RX] - w[s]) * p.inv_dy) * mask[s + RX];
    const T ey0 = ((w[s] - w[s - RX]) * p.inv_dy) * mask[s];
    T ex0 = (w[s + 1] - w[s]) * p.inv_dx;
    T exm = (w[s] - w[s - 1]) * p.inv_dx;
    if (p.free_slip) {
      ex0 = ex0 * mq[s];
      exm = exm * mq[s - 1];
    }
    return ((ey1 - ey0) * p.inv_dy + (ex0 - exm) * p.inv_dx) * mv[s];
  }

  __device__ __forceinline__ T hx(int k, int s) const {   // a_xp(hn)
    return T(0.5) * (hn[k * LS + s] + hn[k * LS + s + 1]);
  }
  __device__ __forceinline__ T hy(int k, int s) const {   // a_yp(hn)
    return T(0.5) * (hn[k * LS + s] + hn[k * LS + s + RX]);
  }

  // pressure.montgomery (+ momentum.kinetic_energy) and momentum.pv_corner
  // of every layer at s, into the planes phi_out and q_out
  __device__ __forceinline__ void phi_q(int s, bool free_surface, T* phi_out,
                                        T* q_out) const {
    T z = T(0);
    if (free_surface) {
      T hs = hn[s];
      for (int k = 1; k < NZ; ++k) hs = hs + hn[k * LS + s];
      z = hs - glob(I_HB, s);
    }
    T acc = p.gp[0] * z;
    const T fq = glob(I_FQ, s);
LAYER_LOOP
    for (int k = 0; k < NZ; ++k) {
      if (k > 0) {
        z = z - hn[(k - 1) * LS + s];
        acc = acc + p.gp[k] * z;
      }
      phi_q_layer(k, s, acc, fq, phi_out, q_out);
    }
  }
  // phi and q of layer k at s, from the Montgomery potential's running sum
  // acc there and f at the corner
  __device__ __forceinline__ void phi_q_layer(int k, int s, T acc, T fq,
                                              T* phi_out, T* q_out) const {
    const T half = T(0.5);
    const T* uk = u + k * LS;
    const T* vk = v + k * LS;
    T ph = acc;
    if (p.sadourny) {
      const T ke = half * (half * (uk[s] * uk[s] + uk[s - 1] * uk[s - 1]) +
                           half * (vk[s] * vk[s] + vk[s - RX] * vk[s - RX]));
      ph = ph + ke;
      const T zeta = ((vk[s + 1] - vk[s]) * p.inv_dx -
                      (uk[s + RX] - uk[s]) * p.inv_dy) * mq[s];
      const T hq = vmax(half * (hy(k, s) + hy(k, s + 1)), p.h_min);
      q_out[k * LS + s] = (fq + zeta) / hq;
    } else {
      q_out[k * LS + s] = fq;
    }
    phi_out[k * LS + s] = ph;
  }

  // the velocities at time n of layer j at s (the interfacial drag's
  // neighbours): from the block's planes, or where they hold one layer
  // (LS = 0) from device memory through the block's offsets
  __device__ __forceinline__ T u_of(int j, int s) const {
    if constexpr (LS == 0)
      return glob(I_U, j, s);
    else
      return u[j * LS + s];
  }
  __device__ __forceinline__ T v_of(int j, int s) const {
    if constexpr (LS == 0)
      return glob(I_V, j, s);
    else
      return v[j * LS + s];
  }

  // fb._common_tendencies at a u point of layer k
  __device__ __forceinline__ T tend_u(int k, int s) const {
    const T* uk = u + k * LS;
    T du = -((phi[k * LS + s + 1] - phi[k * LS + s]) * p.inv_dx);
    if (p.visc || NU4) {
      T dvis = T(0);
      if (p.visc) dvis = p.nu2 * lap_u(uk, s);
      if (NU4) dvis = dvis - p.nu4 * lap_u(lu + k * LS, s);
      du = du + dvis;
    }
    if (k == 0 && p.wind)
      du = du + mu[s] * glob(I_TAUX, s) / (p.rho0 * vmax(hx(0, s), p.h_min));
    if (RINT) {
      T sh = T(0);
      if (k > 0) sh = u_of(k - 1, s) - uk[s];
      if (k < NZ - 1) {
        const T below = u_of(k + 1, s) - uk[s];
        sh = (k > 0) ? sh + below : below;
      }
      du = du + p.r_int * sh / vmax(hx(k, s), p.h_min);
    }
    if (SPONGE)
      du = du + (-(T(0.5) * (glob(I_SPONGE, s) + glob(I_SPONGE, s + 1)))) *
                    uk[s];
    return du;
  }
  __device__ __forceinline__ T tend_v(int k, int s) const {
    const T* vk = v + k * LS;
    T dv = -((phi[k * LS + s + RX] - phi[k * LS + s]) * p.inv_dy);
    if (p.visc || NU4) {
      T dvis = T(0);
      if (p.visc) dvis = p.nu2 * lap_v(vk, s);
      if (NU4) dvis = dvis - p.nu4 * lap_v(lv + k * LS, s);
      dv = dv + dvis;
    }
    if (k == 0 && p.wind)
      dv = dv + mv[s] * glob(I_TAUY, s) / (p.rho0 * vmax(hy(0, s), p.h_min));
    if (RINT) {
      T sh = T(0);
      if (k > 0) sh = v_of(k - 1, s) - vk[s];
      if (k < NZ - 1) {
        const T below = v_of(k + 1, s) - vk[s];
        sh = (k > 0) ? sh + below : below;
      }
      dv = dv + p.r_int * sh / vmax(hy(k, s), p.h_min);
    }
    if (SPONGE)
      dv = dv + (-(T(0.5) * (glob(I_SPONGE, s) + glob(I_SPONGE, s + RX)))) *
                    vk[s];
    return dv;
  }

  // the PV cross terms: a_ym(q a_xp(V)) at a u point from the plane w of
  // v, and a_xm(q a_yp(U)) at a v point from the plane w of u
  __device__ __forceinline__ T cor_u(int k, int s, const T* w) const {
    const T half = T(0.5);
    const T* qk = q + k * LS;
    const bool sad = p.sadourny;
    const T V0 = sad ? hy(k, s) * w[s] : w[s];
    const T V1 = sad ? hy(k, s + 1) * w[s + 1] : w[s + 1];
    const T Vm0 = sad ? hy(k, s - RX) * w[s - RX] : w[s - RX];
    const T Vm1 = sad ? hy(k, s - RX + 1) * w[s - RX + 1] : w[s - RX + 1];
    return half * (qk[s] * (half * (V0 + V1)) +
                   qk[s - RX] * (half * (Vm0 + Vm1)));
  }
  __device__ __forceinline__ T cor_v(int k, int s, const T* w) const {
    const T half = T(0.5);
    const T* qk = q + k * LS;
    const bool sad = p.sadourny;
    const T U0 = sad ? hx(k, s) * w[s] : w[s];
    const T U1 = sad ? hx(k, s + RX) * w[s + RX] : w[s + RX];
    const T Um0 = sad ? hx(k, s - 1) * w[s - 1] : w[s - 1];
    const T Um1 = sad ? hx(k, s - 1 + RX) * w[s - 1 + RX] : w[s - 1 + RX];
    return half * (qk[s] * (half * (U0 + U1)) +
                   qk[s - 1] * (half * (Um0 + Um1)));
  }

  // fb.momentum_update's first FB-Coriolis sweep of layer k at s: u from
  // v (u_first, even steps), else v from u, with the bottom layer's drag
  // and the face mask
  __device__ __forceinline__ T sweep1(int k, int s, bool u_first) const {
    T a;
    if (u_first) {
      a = u[k * LS + s] + p.dt * (tend_u(k, s) + cor_u(k, s, v + k * LS));
      if (k == NZ - 1) a = a / (T(1) + p.dt * drag_u(s));
      a = a * mu[s];
    } else {
      a = v[k * LS + s] +
          p.dt * (tend_v(k, s) + (-cor_v(k, s, u + k * LS)));
      if (k == NZ - 1) a = a / (T(1) + p.dt * drag_v(s));
      a = a * mv[s];
    }
    return a;
  }
  // the second sweep of layer k at s from the first's planes a1: the
  // layer's new (u, v) before finalize
  __device__ __forceinline__ void sweep2(int k, int s, bool u_first,
                                         const T* a1, T& uo, T& vo) const {
    if (u_first) {
      T b = v[k * LS + s] +
            p.dt * (tend_v(k, s) + (-cor_v(k, s, a1 + k * LS)));
      if (k == NZ - 1) b = b / (T(1) + p.dt * drag_v(s));
      uo = a1[k * LS + s];
      vo = b * mv[s];
    } else {
      T b = u[k * LS + s] + p.dt * (tend_u(k, s) + cor_u(k, s, a1 + k * LS));
      if (k == NZ - 1) b = b / (T(1) + p.dt * drag_u(s));
      uo = b * mu[s];
      vo = a1[k * LS + s];
    }
  }

  // drag.bottom_drag_coeff of the bottom layer at a u / v point
  __device__ __forceinline__ T drag_u(int s) const {
    constexpr int kb = NZ - 1;
    const T half = T(0.5);
    const T hu = vmax(hx(kb, s), p.h_min);
    if (!CDBOT) return p.r_bot / hu;
    const T* ub = u + kb * LS;
    const T* vb = v + kb * LS;
    const T v4 = half * (half * (vb[s] + vb[s - RX]) +
                         half * (vb[s + 1] + vb[s + 1 - RX]));
    return (p.r_bot + p.cd_bot * tsqrt(ub[s] * ub[s] + v4 * v4)) / hu;
  }
  __device__ __forceinline__ T drag_v(int s) const {
    constexpr int kb = NZ - 1;
    const T half = T(0.5);
    const T hv = vmax(hy(kb, s), p.h_min);
    if (!CDBOT) return p.r_bot / hv;
    const T* ub = u + kb * LS;
    const T* vb = v + kb * LS;
    const T u4 = half * (half * (ub[s] + ub[s - 1]) +
                         half * (ub[s + RX] + ub[s + RX - 1]));
    return (p.r_bot + p.cd_bot * tsqrt(vb[s] * vb[s] + u4 * u4)) / hv;
  }
};

// continuity.mass_fluxes before the limiter, at one face
template <typename T>
__device__ __forceinline__ T face_flux(const Params<T>& p, T hc, T hp, T w,
                                       T m) {
  T hf = T(0.5) * (hc + hp);
  if (WETDRY) {
    const T up = (w > T(0)) ? hc : hp;
    hf = (tmin(hc, hp) < p.thin) ? up : hf;
    hf = vmax(hf, T(0));
  }
  return (m * hf) * w;
}

// wetdry.wet_mask at one cell and wetdry._gate at one face
template <typename T>
__device__ __forceinline__ T wet_of(const Params<T>& p, T h, T m) {
  return ((h > p.h_dry) ? T(1) : T(0)) * m;
}
template <typename T>
__device__ __forceinline__ T gate(T w, T wl, T wr, T fm) {
  const T both = wl * wr;
  const T only_l = wl * (T(1) - wr);
  const T only_r = wr * (T(1) - wl);
  return fm * ((both * w + only_l * vmax(w, T(0))) + only_r * vmin(w, T(0)));
}

// obc.eta_ext at t1 on the whole block (zeros without tides)
template <typename T, int NPT>
__device__ __forceinline__ void load_eta_ext(const Params<T>& p,
                                             const Off* gidx, T* ee) {
  for (int s = threadIdx.x; s < NPT; s += THREADS) {
    T e = T(0);
    for (int c = 0; c < NTIDE; ++c) {
      const auto g = c * p.plane + gidx[s];
      e = e + p.in[I_TIDE_AMP][g] *
                  tcos(p.omega[c] * p.t1 - p.in[I_TIDE_PHASE][g]);
    }
    ee[s] = e;
  }
}

// The layer continuity of the NL layers from k0 (every layer by default):
// h1 = (h + dt (-div F [+ sponge])) mask [clamped to the exterior] on
// [A + LO, R - A - LO), from the planes h and the advecting velocities ua,
// va, valid on [A, R - A), layer k0 + j at + j * NPT.  fx, fy, sc are NL
// scratch planes each, used under wet/dry only.  `fb` adds the sponge and
// the exterior clamp of fb.continuity_update.  NT is the CTA's thread
// count.  Ends with a __syncthreads().
template <typename T, int RX, int RY, typename TileT, int A = 0,
          int NT = THREADS, int NL = NZ>
__device__ __forceinline__ void continuity_stage(
    const TileT& c, const T* h, const T* ua, const T* va, T* h1, T* fx, T* fy,
    T* sc, bool fb, int k0 = 0) {
  constexpr int NPT = RX * RY;
  constexpr int THREADS = NT;    // the stride of the REGION loops below
  const Params<T>& p = c.p;
  const int tid = threadIdx.x;
  if (WETDRY) {
    REGION(A, A + 1, {
      for (int j = 0; j < NL; ++j) {
        const T* hk = h + j * NPT;
        fx[j * NPT + s] =
            face_flux(p, hk[s], hk[s + 1], ua[j * NPT + s], c.mu[s]);
        fy[j * NPT + s] =
            face_flux(p, hk[s], hk[s + RX], va[j * NPT + s], c.mv[s]);
      }
    })
    REGION(A + 1, A + 1, {
      for (int j = 0; j < NL; ++j) {
        const T* f = fx + j * NPT;
        const T* g = fy + j * NPT;
        const T out =
            (vmax(f[s], T(0)) + vmax(-f[s - 1], T(0))) * p.rdx +
            (vmax(g[s], T(0)) + vmax(-g[s - RX], T(0))) * p.rdy;
        const T avail = vmax(h[j * NPT + s] - p.h_min, T(0));
        const T need = out * p.dt;
        sc[j * NPT + s] =
            (need > avail) ? avail / vmax(need, T(1e-30)) : T(1);
      }
    })
  }
  REGION(A + LO, A + LO, {
    for (int j = 0; j < NL; ++j) {
      const int k = k0 + j;
      const T* hk = h + j * NPT;
      T f0, fm, g0, gm;
      if (WETDRY) {
        const T* f = fx + j * NPT;
        const T* g = fy + j * NPT;
        const T* w = sc + j * NPT;
        f0 = f[s] * ((f[s] > T(0)) ? w[s] : w[s + 1]);
        fm = f[s - 1] * ((f[s - 1] > T(0)) ? w[s - 1] : w[s]);
        g0 = g[s] * ((g[s] > T(0)) ? w[s] : w[s + RX]);
        gm = g[s - RX] * ((g[s - RX] > T(0)) ? w[s - RX] : w[s]);
      } else {
        f0 = face_flux(p, hk[s], hk[s + 1], ua[j * NPT + s], c.mu[s]);
        fm = face_flux(p, hk[s - 1], hk[s], ua[j * NPT + s - 1], c.mu[s - 1]);
        g0 = face_flux(p, hk[s], hk[s + RX], va[j * NPT + s], c.mv[s]);
        gm = face_flux(p, hk[s - RX], hk[s], va[j * NPT + s - RX],
                       c.mv[s - RX]);
      }
      T dh = -((f0 - fm) * p.inv_dx + (g0 - gm) * p.inv_dy) * c.mask[s];
      if (SPONGE && fb)
        dh = dh + c.glob(I_SPONGE, s) * (c.glob(I_HEXT, k, s) - hk[s]);
      T hv = (hk[s] + p.dt * dh) * c.mask[s];
      if (OBC && fb) {
        T tgt = c.glob(I_HEXT, k, s);
        if (k == 0) tgt = tgt + c.ee[s];
        hv = (c.glob(I_OBC_H, s) > T(0)) ? tgt : hv;
      }
      h1[j * NPT + s] = hv;
    }
  })
}

// wetdry._gate of one layer's u and v at s, from its new thickness plane
// hk (valid at s, s + 1 and s + RX)
template <typename T, int RX, typename TileT>
__device__ __forceinline__ void gate_point(const TileT& c, const T* hk, int s,
                                           T& uo, T& vo) {
  const Params<T>& p = c.p;
  const T wl = wet_of(p, hk[s], c.mask[s]);
  const T wx = wet_of(p, hk[s + 1], c.mask[s + 1]);
  const T wy = wet_of(p, hk[s + RX], c.mask[s + RX]);
  uo = gate(uo, wl, wx, c.mu[s]);
  vo = gate(vo, wl, wy, c.mv[s]);
}

// obc.flather's column sums at one point, the layers added in order from
// the surface (add, layer k's new thickness at the point and east and
// north of it and its gated velocities), and the increment it adds to
// every layer's u and v there (incs)
template <typename T>
struct Flather {
  T hs0, hsx, hsy, nu, du, nv, dv;

  __device__ __forceinline__ void add(const Params<T>& p, int k, T h0, T hx,
                                      T hy, T uo, T vo) {
    const T half = T(0.5);
    if (k > 0) {
      hs0 = hs0 + h0;
      hsx = hsx + hx;
      hsy = hsy + hy;
    } else {
      hs0 = h0;
      hsx = hx;
      hsy = hy;
    }
    const T hu = vmax(half * (h0 + hx), p.h_min);
    const T hv = vmax(half * (h0 + hy), p.h_min);
    nu = (k > 0) ? nu + hu * uo : hu * uo;
    du = (k > 0) ? du + hu : hu;
    nv = (k > 0) ? nv + hv * vo : hv * vo;
    dv = (k > 0) ? dv + hv : hv;
  }

  template <int RX, typename TileT>
  __device__ __forceinline__ void incs(const TileT& c, int s, T& u_inc,
                                       T& v_inc) const {
    const Params<T>& p = c.p;
    const T half = T(0.5);
    const T ubar = nu / du;
    const T vbar = nv / dv;
    const T m0 = c.mask[s], mx = c.mask[s + 1], my = c.mask[s + RX];
    const T e0 = (hs0 - c.glob(I_HB, s)) * m0;
    const T ex = (hsx - c.glob(I_HB, s + 1)) * mx;
    const T ey = (hsy - c.glob(I_HB, s + RX)) * my;
    const T s0 = vmax(hs0, p.h_min);
    const T Hu = vmax(half * (s0 + vmax(hsx, p.h_min)), p.h_min);
    const T Hv = vmax(half * (s0 + vmax(hsy, p.h_min)), p.h_min);
    // `cfg.g / Hu`: a Python scalar over a tensor is reciprocal() * scalar
    const T cu = tsqrt((T(1) / Hu) * p.g);
    const T cv = tsqrt((T(1) / Hv) * p.g);
    const T eta_u = (half * (e0 + ex)) * T(2) / vmax(m0 + mx, T(1));
    const T eta_v = (half * (e0 + ey)) * T(2) / vmax(m0 + my, T(1));
    const T eext_u = half * (c.ee[s] + c.ee[s + 1]);
    const T eext_v = half * (c.ee[s] + c.ee[s + RX]);
    const T ou = c.glob(I_OBC_U, s);
    const T ov = c.glob(I_OBC_V, s);
    u_inc = tabs(ou) * ((ou * cu) * (eta_u - eext_u) - ubar);
    v_inc = tabs(ov) * ((ov * cv) * (eta_v - eext_v) - vbar);
  }
};

// fb.finalize at one point: the wet/dry gates and the Flather correction
// of uo[], vo[] (every layer at s), given the new thickness planes h1
// (valid at s, s + 1 and s + RX)
template <typename T, int RX, int NPT, typename TileT>
__device__ __forceinline__ void finalize_point(const TileT& c, const T* h1,
                                               int s, T* uo, T* vo) {
  if (WETDRY) {
LAYER_LOOP
    for (int k = 0; k < NZ; ++k)
      gate_point<T, RX>(c, h1 + k * NPT, s, uo[k], vo[k]);
  }
  if (OBC) {
    Flather<T> f;
LAYER_LOOP
    for (int k = 0; k < NZ; ++k) {
      const T* hk = h1 + k * NPT;
      f.add(c.p, k, hk[s], hk[s + 1], hk[s + RX], uo[k], vo[k]);
    }
    T u_inc, v_inc;
    f.template incs<RX>(c, s, u_inc, v_inc);
LAYER_LOOP
    for (int k = 0; k < NZ; ++k) {
      uo[k] = uo[k] + u_inc;
      vo[k] = vo[k] + v_inc;
    }
  }
}

}  // namespace beom
