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
//
// The layer-streamed step (BEOM_KB = 1 with BEOM_STREAM = 1), where no
// tile's planes of every layer fit a CTA (7 NZ + 5 planes: the shelf past
// 24 layers at f32, 12 at f64).  It replaces the spill route, which kept
// those planes in a device-memory scratch far larger than the L2 (29.6 ms
// a step at 32 layers on 2048^2 f32, 23 x the byte bound).  Nearly all of
// the step is layer-local; the layers couple only at the point itself
// (the Montgomery potential's sums, the interfacial drag, Flather's
// sums), so two launches stream the layers through a few shared-memory
// planes of one layer: the continuity of each layer into out_h, then the
// momentum, which reads the column's h1 back (fb_step_body.cuh, fbs).  It
// moves h1 once more and u, v once more where Flather corrects them, and
// no scratch: at 32 layers on the shelf 1.6 x the function's bytes, and
// 6.66 ms a step on the H100 (tools/kernel_times.py --layers).

#include "fb_step_body.cuh"

namespace {

using namespace beom;
using namespace beom::fbk;

#if BEOM_KB == 1 && BEOM_STREAM

// The layer-streamed step (fb_step_body.cuh, namespace fbs): K1 where no
// tile's planes of every layer fit a CTA's shared memory (many layers).
// Two launches on PyTorch's stream, each one CTA per tile: the continuity
// of every layer into out_h, then the momentum from it.
// the interior points of the CTA's tile in the whole grid
template <typename T>
__device__ __forceinline__ Out grid_out(const Params<T>& p) {
  return Out{int(blockIdx.y) * TY, int(blockIdx.x) * TX, p.ny, p.nx,
             p.plane};
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fb_cont_kernel(const Params<T> p, T* out_h) {
  const Out o = grid_out(p);
  fbs::cont::run_at<T, false>(p, Stack{}, o.y0, o.x0, o, out_h);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fb_mom_kernel(const Params<T> p, const T* h1, T* out_u, T* out_v) {
  const Out o = grid_out(p);
  fbs::mom::run_at<T, false>(p, Stack{}, o.y0, o.x0, o, h1, out_u, out_v);
}

template <typename T>
int fb_step(const void* const* ptrs, const int* ints, const double* dbls,
            void* h1, void* u1, void* v1, void* stream) {
  const Params<T> p = make_params<T>(ptrs, ints, dbls);
  constexpr int smem_c = fbs::cont::smem_bytes<T>();
  constexpr int smem_m = fbs::mom::smem_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(
      fb_cont_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_c);
  if (e != cudaSuccess) return int(e);
  e = cudaFuncSetAttribute(fb_mom_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_m);
  if (e != cudaSuccess) return int(e);
  const dim3 grid = tiles_of(p.ny, p.nx, TX, TY);
  const auto st = static_cast<cudaStream_t>(stream);
  fb_cont_kernel<T><<<grid, THREADS, smem_c, st>>>(p, static_cast<T*>(h1));
  e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  fb_mom_kernel<T><<<grid, THREADS, smem_m, st>>>(
      p, static_cast<const T*>(h1), static_cast<T*>(u1),
      static_cast<T*>(v1));
  return int(cudaGetLastError());
}

// 0: the momentum kernel, 1: the continuity kernel
constexpr int kernel_smem(int which, bool f64) {
  if (which == 1)
    return f64 ? fbs::cont::smem_bytes<double>()
               : fbs::cont::smem_bytes<float>();
  return f64 ? fbs::mom::smem_bytes<double>() : fbs::mom::smem_bytes<float>();
}

#elif BEOM_KB == 1

template <typename T>
__global__ void __launch_bounds__(THREADS)
fb_step_kernel(const Params<T> p, T* out_h, T* out_u, T* out_v) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  Off* gidx = off_table(sm, N_PLANES * NPT);
  T* h = sm + P_H * NPT;
  T* u = sm + P_U * NPT;
  T* v = sm + P_V * NPT;
  const int tid = threadIdx.x;
  const int bx = int(blockIdx.x), by = int(blockIdx.y);

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
}

template <typename T>
int fb_step(const void* const* ptrs, const int* ints, const double* dbls,
            void* h1, void* u1, void* v1, void* stream) {
  const Params<T> p = make_params<T>(ptrs, ints, dbls);
  constexpr int smem = smem_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(
      fb_step_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return int(e);
  const dim3 grid = tiles_of(p.ny, p.nx, TX, TY);
  fb_step_kernel<T><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<T*>(h1), static_cast<T*>(u1), static_cast<T*>(v1));
  return int(cudaGetLastError());
}

constexpr int kernel_smem(int, bool f64) {
  return f64 ? smem_bytes<double>() : smem_bytes<float>();
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

constexpr int kernel_smem(int, bool f64) {
  return f64 ? fbp::smem_bytes<double>() : fbp::smem_bytes<float>();
}

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

// dynamic shared memory of one CTA of kernel `which` (0: the build's step
// or pass kernel, in a layer-streamed build its momentum kernel; 1: that
// build's continuity kernel), for the wrapper's plan
extern "C" int beom_smem_bytes(int which, int is_f64) {
  return kernel_smem(which, is_f64);
}

extern "C" const char* beom_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
