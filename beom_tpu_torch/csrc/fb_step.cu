// K1: one free-surface forward-backward step (stepping/fb.py::fb_step) of
// nz layers with every term of the eager step, fused into one launch.
//
// Replaces beom_tpu/stencils/band.py::_band_kernel running the fb body of
// beom_tpu/stencils/fused_fb.py::make_pallas_stepper.
//
// Bound: device-memory bytes.  A step reads 3 nz + 8 fields (plus the
// sponge, open-boundary and tide operands of the switches that are on) and
// writes 3 nz, and does a few hundred flops per point, far below the
// H100's ratio of operations to bytes.  The design keeps every
// intermediate of the step (h1, the Montgomery + kinetic potential, the
// PV, the limiter's fluxes and scales, the first Coriolis sweep) in shared
// memory, so a point costs one read of each operand and one write of each
// result.
//
// Shape: one CTA per 2-D tile of TY x TX interior points with a W-point
// halo on both axes, loaded with periodic wrap (exact for any ny, nx).
// Shared memory holds the planes that are read at neighbouring points:
// h, u, v, the four masks, and the intermediates; operands that are read
// at the point itself (H, f, wind, sponge, boundary maps) come from global
// memory through the block's table of offsets.  The layer count, the term
// switches and the tile are compile-time (fb_terms.cuh), so the double
// gyre's build carries 11 planes and the two-layer shelf's 19.
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

#include "fb_terms.cuh"

namespace {

using namespace beom;

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
fb_step_kernel(const Params<T> p, T* out_h, T* out_u, T* out_v) {
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
  T* h1 = sm + P_H1 * NPT;
  T* phi = sm + P_PHI * NPT;
  T* q = sm + P_Q * NPT;
  T* a1 = sm + P_A1 * NPT;
  T* lu = sm + P_LU * NPT;
  T* lv = sm + P_LV * NPT;
  T* ee = sm + P_EE * NPT;
  const int tid = threadIdx.x;

  // S0: the haloed block
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
  if (OBC) load_eta_ext<T, NPT>(p, gidx, ee);
  __syncthreads();

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
    const int gj = blockIdx.y * TY + jj;
    const int gi = blockIdx.x * TX + ii;
    if (gj >= p.ny || gi >= p.nx) continue;
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
    const long g = long(gj) * p.nx + gi;
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
      out_h[k * p.plane + g] = h1[k * NPT + s];
      out_u[k * p.plane + g] = uo[k];
      out_v[k * p.plane + g] = vo[k];
    }
  }
}

template <typename T>
int fb_step(const void* const* ptrs, const int* ints, const double* dbls,
            void* h1, void* u1, void* v1, void* stream) {
  const Params<T> p = make_params<T>(ptrs, ints, dbls);
  constexpr int smem = smem_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(
      fb_step_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return int(e);
  const dim3 grid((p.nx + TX - 1) / TX, (p.ny + TY - 1) / TY);
  fb_step_kernel<T><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<T*>(h1), static_cast<T*>(u1), static_cast<T*>(v1));
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int beom_fb_step_f32(const void* const* ptrs, const int* ints,
                                const double* dbls, void* h1, void* u1,
                                void* v1, void* stream) {
  return fb_step<float>(ptrs, ints, dbls, h1, u1, v1, stream);
}

extern "C" int beom_fb_step_f64(const void* const* ptrs, const int* ints,
                                const double* dbls, void* h1, void* u1,
                                void* v1, void* stream) {
  return fb_step<double>(ptrs, ints, dbls, h1, u1, v1, stream);
}

// dynamic shared memory of one CTA of kernel `which` (only 0, fb_step), for
// the wrapper's choice of tile
extern "C" int beom_smem_bytes(int which, int is_f64) {
  return is_f64 ? smem_bytes<double>() : smem_bytes<float>();
}

extern "C" const char* beom_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
