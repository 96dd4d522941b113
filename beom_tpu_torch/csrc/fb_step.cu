// K1: free-surface forward-backward steps (stepping/fb.py::fb_step) of nz
// layers with every term of the eager step, fused: one step per launch (a
// build with BEOM_KB = 1), or a pass of KB steps per launch.
//
// Replaces beom_tpu/stencils/band.py::_band_kernel running the fb body of
// beom_tpu/stencils/fused_fb.py::make_pallas_stepper, which advances the
// steps_per_pass steps of a pass in one trip through memory with a halo
// that many times as wide: the pass kernel below.
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
// The stages after the load (S1 to S4) are those of csrc/fb_step_body.cuh,
// which the shard step under a mesh (shard_step.cu) runs too.
//
// The pass kernel (BEOM_KB = KB > 1).  On the H100 the single step costs
// its loads (~0.11 ms at 2048^2 f32 alone) and its stages (~0.12 ms alone)
// nearly one after the other; the table of offsets costs nothing.  The pass
// loads a block with a halo of KB W once, stages every static the switches
// read beside h, u and v (16-byte cp.async copies where a block's rows are
// aligned and lie inside the grid, point by point through row and column
// offsets elsewhere), and runs the KB steps on it in shared memory, step i
// on [i W, R - i W) (fb_step_body.cuh, namespace fbp), so that a pass pays
// one load and one store of each field per KB steps.  Its loads hide
// behind its stages, which set its time on the H100 (their instructions
// and shared-memory reads at one CTA per SM: a 2-step launch at 2048^2 f32
// 0.344 ms, its stages alone 0.291, 0.265 without their barriers; the
// byte bound 0.070, tools/k1_probes.py --pass).  The tile, KB and the
// CTA's threads are the wrapper's plan (stencils/fused_fb.py::plan): the
// halo costs stage work that grows with KB, and a CTA uses one SM's shared
// memory.

#include "fb_step_body.cuh"

namespace {

using namespace beom;
using namespace beom::fbk;

#if BEOM_KB == 1

template <typename T>
__global__ void __launch_bounds__(THREADS)
fb_step_kernel(const Params<T> p, T* out_h, T* out_u, T* out_v) {
  T* sm = block_planes<T>(p, N_PLANES * NPT);
  Off* gidx = block_table<T>(sm, N_PLANES * NPT);
  T* h = sm + P_H * NPT;
  T* u = sm + P_U * NPT;
  T* v = sm + P_V * NPT;
  const int tid = threadIdx.x;

  for_tiles(tiles_of(p.ny, p.nx, TX, TY), [&](int bx, int by) {
    // S0: the haloed block
    load_offsets<T, RX, RY, W>(p, gidx, bx, by);
    __syncthreads();
    for (int s = tid; s < NPT; s += THREADS) {
      const int g = gidx[s];
      for (int k = 0; k < NZ; ++k) {
        h[k * NPT + s] = p.in[I_H][k * p.plane + g];
        u[k * NPT + s] = p.in[I_U][k * p.plane + g];
        v[k * NPT + s] = p.in[I_V][k * p.plane + g];
      }
      sm[P_M * NPT + s] = p.in[I_MASK][g];
      sm[P_MU * NPT + s] = p.in[I_MASK_U][g];
      sm[P_MV * NPT + s] = p.in[I_MASK_V][g];
      sm[P_MQ * NPT + s] = p.in[I_MASK_Q][g];
    }
    if (OBC) load_eta_ext<T, NPT>(p, gidx, sm + P_EE * NPT);
    __syncthreads();

    fb_stages<T>(p, sm, gidx,
                 Store3<T>{out_h, out_u, out_v,
                           Out{by * TY, bx * TX, p.ny, p.nx, p.plane}});
  });
}

template <typename T>
int fb_step(const void* const* ptrs, const int* ints, const double* dbls,
            void* h1, void* u1, void* v1, void* stream) {
  const Params<T> p = make_params<T>(ptrs, ints, dbls);
  constexpr int smem = smem_bytes<T>();
  const dim3 grid = tile_grid(tiles_of(p.ny, p.nx, TX, TY), p);
  if (grid.x == 0) return int(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      fb_step_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return int(e);
  fb_step_kernel<T><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<T*>(h1), static_cast<T*>(u1), static_cast<T*>(v1));
  return int(cudaGetLastError());
}

constexpr int kernel_smem(bool f64) {
  return f64 ? smem_bytes<double>() : smem_bytes<float>();
}

// the spill route: bytes of a CTA's slice of the scratch, and the CTAs the
// current device holds at once
constexpr long kernel_work(bool f64) {
  return f64 ? work_bytes<double>() : work_bytes<float>();
}
int kernel_ctas(bool f64) {
  return f64 ? resident_ctas(fb_step_kernel<double>, THREADS,
                             smem_bytes<double>())
             : resident_ctas(fb_step_kernel<float>, THREADS,
                             smem_bytes<float>());
}

#else

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
fb_pass_kernel(const Params<T> p, T* out_h, T* out_u, T* out_v) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int y0 = int(blockIdx.y) * TY;
  const int x0 = int(blockIdx.x) * TX;
  fbp::load_block<T>(p, sm, y0 - fbp::HALO, x0 - fbp::HALO);
  fbp::pass_steps<T, 0, 0, 1, 2, 3, 4>(
      p, sm, Store3<T>{out_h, out_u, out_v, Out{y0, x0, p.ny, p.nx, p.plane}});
}

template <typename T>
int fb_step(const void* const* ptrs, const int* ints, const double* dbls,
            void* h1, void* u1, void* v1, void* stream) {
  const Params<T> p = make_params<T>(ptrs, ints, dbls);
  constexpr int smem = fbp::smem_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(
      fb_pass_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return int(e);
  const dim3 grid((p.nx + TX - 1) / TX, (p.ny + TY - 1) / TY);
  fb_pass_kernel<T><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<T*>(h1), static_cast<T*>(u1), static_cast<T*>(v1));
  return int(cudaGetLastError());
}

constexpr int kernel_smem(bool f64) {
  return f64 ? fbp::smem_bytes<double>() : fbp::smem_bytes<float>();
}
constexpr long kernel_work(bool) { return 0; }
int kernel_ctas(bool) { return 0; }

#endif

}  // namespace

// one launch: one step (BEOM_KB = 1), or a pass of KB steps with step i's
// time in dbls[D_TS0 + i]

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

// dynamic shared memory of one CTA of kernel `which` (only 0: the build's
// step or pass kernel), for the wrapper's plan
extern "C" int beom_smem_bytes(int which, int is_f64) {
  return kernel_smem(is_f64);
}

// the spill route (a build with BEOM_SPILL = 1, the single-step kernel):
// bytes of a CTA's slice of the scratch (0 in any other build), and the
// CTAs of kernel `which` the current device holds at once
extern "C" long beom_work_bytes(int which, int is_f64) {
  return kernel_work(is_f64);
}
extern "C" int beom_spill_ctas(int which, int is_f64) {
  return kernel_ctas(is_f64);
}

extern "C" const char* beom_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
