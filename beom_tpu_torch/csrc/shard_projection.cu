// K7 around the projection bodies: the two phases of a rigid-lid /
// implicit-free-surface step (stepping/projection.py) on one shard of a
// device mesh, each on the shard's local block (nz, ly, lx).  A halo point
// beyond the block's edge is the neighbour shard's, read from its block
// through its pointer (csrc/shard_addr.cuh); a shard that is its own
// neighbour along a mesh axis reads its own periodic wrap.
//
// Replaces beom_tpu/stencils/dist_band.py::_dist_band_kernel built twice by
// beom_tpu/parallel/dist.py::make_dist_pallas_projection_stepper, with the
// bodies body_a (phase A) and body_b (phase B).
//
//   phase A: the provisional momentum u*, v* without the surface term and
//     the divergence of the barotropic transport, from h, u, v (halo 4);
//   phase B: the correction by grad p, the layer continuity and finalize,
//     from h, u*, v* and the solved p (halo 1, 2 or 3 by build).
//
// The elliptic solve between the phases joins every shard (it is the
// mesh's own solver, stencils/dist_band.py), and the next step's phase A
// starts after phase B's join, so no input of either phase is in flight
// when it launches: each phase is one launch per shard over every tile,
// with no interior / frame split.
//
// Bound: device-memory bytes, as K3a / K3b.  The stage bodies are theirs
// (csrc/projection_body.cuh), so each phase equals the single-device kernel
// on the same points bit for bit.  The statics are the shard's blocks
// padded once with PAD = 4 points from the neighbours (phase A's halo, the
// wider), so the boundary maps, the sponge and the tides keep their global
// positions.

#include "projection_body.cuh"

namespace {

using namespace beom;
using namespace beom::prj;

constexpr int PAD = pa::W > pb::W ? pa::W : pb::W;

template <typename T>
__global__ void __launch_bounds__(THREADS)
shard_pa_kernel(const Params<T> p, const NbrSrc<T, N_IN_A, PAD> src,
                const TileMap m, T* out_us, T* out_vs, T* out_div) {
  int tx, ty;
  m.tile(tx, ty);
  pa::run<T>(p, src, Out{ty * TY, tx * TX, src.ly, src.lx, src.plane},
             out_us, out_vs, out_div);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
shard_pb_kernel(const Params<T> p, const NbrSrc<T, N_IN_B, PAD> src,
                const TileMap m, T corr, T* out_h, T* out_u, T* out_v) {
  int tx, ty;
  m.tile(tx, ty);
  pb::run<T>(p, src, Out{ty * TY, tx * TX, src.ly, src.lx, src.plane},
             corr, out_h, out_u, out_v);
}

// Both entries take: ptrs, the operand table of fb_terms.cuh with the
// statics padded by PAD (its h, u, v slots are unused), ints[J_NY] and
// ints[J_NX] the padded extent; dyn, 9 pointers per source field (the
// field's 3 x 3 neighbourhood, row-major from (-1, -1)), field-major: h,
// u, v (phase A) or h, u*, v*, p (phase B); geom = ly, lx.  Every tile of
// the block is one CTA of the one launch.

template <typename T>
int shard_proj_a(const void* const* ptrs, const int* ints, const double* dbls,
                 const void* const* dyn, const int* geom, void* us, void* vs,
                 void* div, void* stream) {
  const Params<T> p = make_params<T>(ptrs, ints, dbls);
  const int ly = geom[0], lx = geom[1];
  const TileMap m = make_tiles(ly, lx, TX, TY, pa::W, 2);
  if (!shard_geometry_ok(p, ly, lx, PAD, pa::W, m))
    return int(cudaErrorInvalidValue);
  constexpr int smem = pa::smem_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(
      shard_pa_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return int(e);
  shard_pa_kernel<T><<<m.grid(), THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      p, make_nbr<T, N_IN_A, PAD>(dyn, ly, lx), m, static_cast<T*>(us),
      static_cast<T*>(vs), static_cast<T*>(div));
  return int(cudaGetLastError());
}

template <typename T>
int shard_proj_b(const void* const* ptrs, const int* ints, const double* dbls,
                 const void* const* dyn, const int* geom, double corr,
                 void* h1, void* u1, void* v1, void* stream) {
  const Params<T> p = make_params<T>(ptrs, ints, dbls);
  const int ly = geom[0], lx = geom[1];
  const TileMap m = make_tiles(ly, lx, TX, TY, pb::W, 2);
  if (!shard_geometry_ok(p, ly, lx, PAD, pb::W, m))
    return int(cudaErrorInvalidValue);
  constexpr int smem = pb::smem_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(
      shard_pb_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return int(e);
  shard_pb_kernel<T><<<m.grid(), THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      p, make_nbr<T, N_IN_B, PAD>(dyn, ly, lx), m, T(corr),
      static_cast<T*>(h1), static_cast<T*>(u1), static_cast<T*>(v1));
  return int(cudaGetLastError());
}

}  // namespace

#define SHARD_PROJ_ENTRIES(SUFFIX, T)                                         \
  extern "C" int beom_shard_proj_a_##SUFFIX(                                  \
      const void* const* ptrs, const int* ints, const double* dbls,           \
      const void* const* dyn, const int* geom, void* us, void* vs, void* div, \
      void* stream) {                                                         \
    return shard_proj_a<T>(ptrs, ints, dbls, dyn, geom, us, vs, div, stream); \
  }                                                                           \
  extern "C" int beom_shard_proj_b_##SUFFIX(                                  \
      const void* const* ptrs, const int* ints, const double* dbls,           \
      const void* const* dyn, const int* geom, double corr, void* h1,         \
      void* u1, void* v1, void* stream) {                                     \
    return shard_proj_b<T>(ptrs, ints, dbls, dyn, geom, corr, h1, u1, v1,     \
                           stream);                                           \
  }

SHARD_PROJ_ENTRIES(f32, float)
SHARD_PROJ_ENTRIES(f64, double)

// the halo of a shard's padded statics, and per phase (A 0, B 1) its own
// halo, for the wrapper
extern "C" int beom_shard_halo() { return PAD; }
extern "C" int beom_kernel_halo(int which) {
  return which == 0 ? pa::W : pb::W;
}

// dynamic shared memory of one CTA of phase A (0) and B (1): the
// single-device kernels' (fused_projection.smem_bytes)
extern "C" int beom_smem_bytes(int which, int is_f64) {
  if (which == 0)
    return is_f64 ? pa::smem_bytes<double>() : pa::smem_bytes<float>();
  return is_f64 ? pb::smem_bytes<double>() : pb::smem_bytes<float>();
}

extern "C" const char* beom_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
