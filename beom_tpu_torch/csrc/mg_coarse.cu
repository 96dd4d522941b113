// K5: the whole recursive multigrid cycle on a tail of the level
// hierarchy (solvers/multigrid.py::_vcycle on levels[j0:]) in one
// persistent cooperative launch: smoothing, residuals, restriction, the
// optional de-mean, the recursion and the coarsest level's sweeps.
//
// Replaces beom_tpu/stencils/mg_pallas.py::_coarse_kernel, built by
// make_coarse_stack_call.  The reference keeps every level in VMEM and
// does its transfers as matmuls against banded matrices (Mosaic lowers no
// strided gathers); here the transfers are direct stencils with the same
// weights, 3/8 and 1/8.
//
// Bound: latency, not bytes.  A cycle is hundreds of dependent passes
// over levels of 16^2 to 512^2 points, and a grid-wide sync between two
// costs more than a pass over a small level.  The design (the walk of
// csrc/mg_cycle.cuh): the levels small enough to fit one CTA's shared
// memory together (64^2 and below at f32 on the H100, 32^2 at f64; the
// reference's VMEM holds all of them) run on one CTA out of shared memory
// with block barriers, one grid sync per visit of the tier; each visit of
// a larger level is two tiled passes with their halo in shared memory.
// 512 threads and the card's opt-in shared memory per CTA, one CTA per
// SM.  A visit of the 512^2 tail of the 2048^2 hierarchy costs 33 grid
// syncs (335 in the walk before the tier and the tiled passes).

#include "coop_stamps.cuh"
#include "mg_cycle.cuh"

namespace {

using mgc::CYCLE_THREADS;

template <typename T>
__global__ void __launch_bounds__(CYCLE_THREADS, 1)
    coarse_kernel(const mgc::Cycle<T> c, T* partials,
                  unsigned long long* stamps) {
  stamp::entry(stamps);
  mgc::cg::grid_group grid = mgc::cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int round = 0;
  mgc::run_cycle<T, CYCLE_THREADS>(c, smem_raw, partials, round, grid);
  stamp::leave(stamps);
}

template <typename T>
int mg_coarse(const long long* ptrs, const int* dims, const T* scal,
              const int* steps, int nsteps, int nlev, int nu, int tier,
              int tier_bytes, double lam, T* partials, int partials_len,
              unsigned long long* stamps, void* stream) {
  const void* kernel = reinterpret_cast<const void*>(coarse_kernel<T>);
  int blocks = 0, smem = 0, room = 0;
  cudaError_t e = mgc::cycle_launch(kernel, &blocks, &smem);
  if (e == cudaSuccess)
    e = mgc::cycle_room<T>(smem, nlev, nu, tier_bytes, &room);
  if (e != cudaSuccess) return int(e);
  if (2 * blocks * mgc::NDOT > partials_len) return int(cudaErrorInvalidValue);
  mgc::Cycle<T> c{ptrs, dims, scal, steps, nsteps, nlev, nu, tier, room,
                  T(lam)};
  void* args[] = {&c, &partials, &stamps};
  e = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(CYCLE_THREADS),
                                  args, size_t(smem),
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return int(e);
  return int(cudaGetLastError());
}

// the CTAs a launch uses on the current device, or the dynamic shared
// memory each has
template <typename T>
int coarse_query(int which, int* out) {
  int blocks = 0, smem = 0;
  const cudaError_t e = mgc::cycle_launch(
      reinterpret_cast<const void*>(coarse_kernel<T>), &blocks, &smem);
  *out = which ? smem : blocks;
  return int(e);
}

}  // namespace

#define MG_COARSE_ENTRY(NAME, BLOCKS, SMEM, T)                               \
  extern "C" int NAME(const long long* ptrs, const int* dims, const T* scal, \
                      const int* steps, int nsteps, int nlev, int nu,        \
                      int tier, int tier_bytes, double lam, T* partials,     \
                      int partials_len, unsigned long long* stamps,          \
                      void* stream) {                                        \
    return mg_coarse<T>(ptrs, dims, scal, steps, nsteps, nlev, nu, tier,     \
                        tier_bytes, lam, partials, partials_len, stamps,     \
                        stream);                                             \
  }                                                                          \
  extern "C" int BLOCKS(int* blocks) { return coarse_query<T>(0, blocks); }  \
  extern "C" int SMEM(int* bytes) { return coarse_query<T>(1, bytes); }

MG_COARSE_ENTRY(beom_mg_coarse_f32, beom_mg_coarse_blocks_f32,
                beom_mg_coarse_smem_f32, float)
MG_COARSE_ENTRY(beom_mg_coarse_f64, beom_mg_coarse_blocks_f64,
                beom_mg_coarse_smem_f64, double)

extern "C" const char* beom_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
