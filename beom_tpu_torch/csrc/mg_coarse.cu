// K5: the whole recursive multigrid cycle on a tail of the level
// hierarchy (solvers/multigrid.py::_vcycle on levels[j0:]) in one
// persistent cooperative launch: smoothing, residuals, restriction, the
// optional de-mean, the recursion and the coarsest level's sweeps.
//
// Replaces beom_tpu/stencils/mg_pallas.py::_coarse_kernel, built by
// make_coarse_stack_call.  The reference keeps every level in VMEM and
// does its transfers as matmuls against banded matrices (Mosaic lowers no
// strided gathers); here the levels stay in device memory (the L2 holds
// them: 512^2 f32 is 1 MB a field) and the transfers are direct stencils
// with the same weights, 3/8 and 1/8.
//
// Bound: latency, not bytes.  A cycle is hundreds of dependent passes
// over levels of 16^2 to 512^2 points; each needs every neighbour of the
// pass before, so passes are separated by grid syncs.  The design:
// the host's flattened step list (csrc/mg_cycle.cuh) walked by one
// cooperative grid, and the smallest levels (16^2 at most, the host's
// choice), which the W-cycle visits most often, run on one CTA with
// __syncthreads in place of grid syncs.

#include "mg_cycle.cuh"

namespace {

using mgc::THREADS;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    coarse_kernel(const mgc::Cycle<T> c, T* partials) {
  mgc::cg::grid_group grid = mgc::cg::this_grid();
  __shared__ T sh[mgc::NDOT * THREADS];
  int round = 0;
  mgc::run_cycle(c, sh, partials, round, grid);
}

template <typename T>
int mg_coarse(const long long* ptrs, const int* dims, const T* scal,
              const int* steps, int nsteps, double lam, T* partials,
              int partials_len, void* stream) {
  int blocks = 0;
  cudaError_t e = mgc::coop_blocks(
      reinterpret_cast<const void*>(coarse_kernel<T>), &blocks);
  if (e != cudaSuccess) return int(e);
  if (2 * blocks * mgc::NDOT > partials_len) return int(cudaErrorInvalidValue);
  mgc::Cycle<T> c{ptrs, dims, scal, steps, nsteps, T(lam)};
  void* args[] = {&c, &partials};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(coarse_kernel<T>),
                                  dim3(blocks), dim3(THREADS), args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return int(e);
  return int(cudaGetLastError());
}

template <typename T>
int coarse_blocks(int* blocks) {
  return int(mgc::coop_blocks(reinterpret_cast<const void*>(coarse_kernel<T>),
                              blocks));
}

}  // namespace

#define MG_COARSE_ENTRY(NAME, BLOCKS, T)                                    \
  extern "C" int NAME(const long long* ptrs, const int* dims, const T* scal, \
                      const int* steps, int nsteps, double lam, T* partials, \
                      int partials_len, void* stream) {                     \
    return mg_coarse<T>(ptrs, dims, scal, steps, nsteps, lam, partials,     \
                        partials_len, stream);                              \
  }                                                                         \
  extern "C" int BLOCKS(int* blocks) { return coarse_blocks<T>(blocks); }

MG_COARSE_ENTRY(beom_mg_coarse_f32, beom_mg_coarse_blocks_f32, float)
MG_COARSE_ENTRY(beom_mg_coarse_f64, beom_mg_coarse_blocks_f64, double)

extern "C" const char* beom_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
