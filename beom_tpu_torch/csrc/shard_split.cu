// K7 around the split body: one split barotropic / baroclinic step
// (stepping/split.py::split_step) on one shard of a device mesh, as the
// three kernels of the single-device split step (split_step.cu): the slow
// phase, the barotropic subcycle and the recomposition with fb.finalize,
// each on the shard's local block (nz, ly, lx).  A halo point beyond the
// block's edge is the neighbour shard's, read from its block through its
// pointer (csrc/shard_addr.cuh); a shard that is its own neighbour along a
// mesh axis reads its own periodic wrap.
//
// Replaces beom_tpu/stencils/dist_band.py::_dist_band_kernel running the
// split body of beom_tpu/parallel/dist.py::make_dist_pallas_stepper.
//
// The TPU kernel runs the whole step in one launch over a y halo of
// ceil8(8 + 2 nsub) rows, exchanged in-kernel.  Here each of the three
// kernels reads the halo its own stages need, as on one device: the slow
// phase 2 points of h, u, v; the subcycle nsub points of the slow phase's
// 2-D fields (one ring of error per substep from an unknown rim); the
// recomposition 2 (3 under wet/dry) points of h, the shear velocities and
// the subcycle's mean velocities, and 1 of its free surface.  So every
// field a later kernel reads across a block edge is written to a tensor of
// its own that the neighbours read: the slow phase's 4 nz + 9 planes and
// the subcycle's five.  Each kernel is two launches per shard and step, the
// interior tiles (whose haloed block lies inside the shard's own block) and
// the frame of tiles around them; the wrapper (stencils/dist_band.py)
// orders a frame launch after the neighbours' previous kernel by CUDA
// events, and no kernel waits on a flag.
//
// Bound: device-memory bytes, as K1s.  The stage bodies are K1s's
// (csrc/split_body.cuh), so each kernel equals the single-device kernel on
// the same points bit for bit.  The statics are the shard's blocks padded
// once with PAD = max(2, nsub, LO + 1) points from the neighbours, the
// widest halo of the three, so the boundary maps, the sponge and the tides
// keep their global positions.

#include "split_body.cuh"

namespace {

using namespace beom;
using namespace beom::spk;

constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int PAD = cmax(cmax(slow::W, rec::W), sub::W);

template <typename T>
__global__ void __launch_bounds__(THREADS)
shard_slow_kernel(const Params<T> p, const NbrSrc<T, N_SLOW_IN, PAD> src,
                  const TileMap m, const Ptrs<T, N_SLOW> out) {
  int tx, ty;
  m.tile(tx, ty);
  slow::run<T>(p, src, out, Out{ty * TY, tx * TX, src.ly, src.lx,
                                src.plane});
}

template <typename T>
__global__ void __launch_bounds__(sub::THREADS_SUB)
shard_sub_kernel(const Params<T> p, const NbrSrc<T, N_SLOW, PAD> src,
                 const TileMap m, const Ptrs<T, N_SUB> out, T dte,
                 T inv_nsub) {
  int tx, ty;
  m.tile(tx, ty);
  sub::run<T>(p, src, out, Out{ty * SY, tx * SX, src.ly, src.lx, src.plane},
              dte, inv_nsub);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
shard_rec_kernel(const Params<T> p, const NbrSrc<T, N_REC_IN, PAD> src,
                 const TileMap m, T* out_h, T* out_u, T* out_v) {
  int tx, ty;
  m.tile(tx, ty);
  rec::run<T>(p, src, Out{ty * TY, tx * TX, src.ly, src.lx, src.plane},
              out_h, out_u, out_v);
}

template <typename T, int N>
Ptrs<T, N> pack(void* const* a) {
  Ptrs<T, N> r;
  for (int i = 0; i < N; ++i) r.p[i] = static_cast<T*>(a[i]);
  return r;
}

// Every entry takes: ptrs, the operand table of fb_terms.cuh with the
// statics padded by PAD (its h, u, v slots are unused), ints[J_NY] and
// ints[J_NX] the padded extent; dyn, 9 pointers per source field (the
// field's 3 x 3 neighbourhood, row-major from (-1, -1)), field-major in the
// order of split_body.cuh's SlowIn, Slow or RecIn; geom = ly, lx, part
// (shard_addr.cuh's TileMap).

template <typename T>
int shard_slow(const void* const* ptrs, const int* ints, const double* dbls,
               const void* const* dyn, const int* geom, void* const* outs,
               void* stream) {
  const Params<T> p = make_params<T>(ptrs, ints, dbls);
  const int ly = geom[0], lx = geom[1];
  const TileMap m = make_tiles(ly, lx, TX, TY, slow::W, geom[2]);
  if (!shard_geometry_ok(p, ly, lx, PAD, slow::W, m))
    return int(cudaErrorInvalidValue);
  constexpr int smem = slow::smem_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(
      shard_slow_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return int(e);
  shard_slow_kernel<T><<<m.grid(), THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      p, make_nbr<T, N_SLOW_IN, PAD>(dyn, ly, lx), m,
      pack<T, N_SLOW>(outs));
  return int(cudaGetLastError());
}

template <typename T>
int shard_subcycle(const void* const* ptrs, const int* ints,
                   const double* dbls, const void* const* dyn,
                   const int* geom, void* const* outs, void* stream) {
  const Params<T> p = make_params<T>(ptrs, ints, dbls);
  const int ly = geom[0], lx = geom[1];
  const TileMap m = make_tiles(ly, lx, SX, SY, sub::W, geom[2]);
  if (p.nsub != NSUB || !shard_geometry_ok(p, ly, lx, PAD, sub::W, m))
    return int(cudaErrorInvalidValue);
  constexpr int smem = sub::smem_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(
      shard_sub_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return int(e);
  const T dte = T(dbls[D_DT] / NSUB);
  const T inv_nsub = T(1) / T(NSUB);
  shard_sub_kernel<T><<<m.grid(), sub::THREADS_SUB, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      p, make_nbr<T, N_SLOW, PAD>(dyn, ly, lx), m, pack<T, N_SUB>(outs), dte,
      inv_nsub);
  return int(cudaGetLastError());
}

template <typename T>
int shard_recompose(const void* const* ptrs, const int* ints,
                    const double* dbls, const void* const* dyn,
                    const int* geom, void* h1, void* u1, void* v1,
                    void* stream) {
  const Params<T> p = make_params<T>(ptrs, ints, dbls);
  const int ly = geom[0], lx = geom[1];
  const TileMap m = make_tiles(ly, lx, TX, TY, rec::W, geom[2]);
  if (!shard_geometry_ok(p, ly, lx, PAD, rec::W, m))
    return int(cudaErrorInvalidValue);
  constexpr int smem = rec::smem_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(
      shard_rec_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return int(e);
  shard_rec_kernel<T><<<m.grid(), THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      p, make_nbr<T, N_REC_IN, PAD>(dyn, ly, lx), m, static_cast<T*>(h1),
      static_cast<T*>(u1), static_cast<T*>(v1));
  return int(cudaGetLastError());
}

}  // namespace

#define SHARD_SPLIT_ENTRIES(SUFFIX, T)                                        \
  extern "C" int beom_shard_split_slow_##SUFFIX(                              \
      const void* const* ptrs, const int* ints, const double* dbls,           \
      const void* const* dyn, const int* geom, void* const* outs,             \
      void* stream) {                                                         \
    return shard_slow<T>(ptrs, ints, dbls, dyn, geom, outs, stream);          \
  }                                                                           \
  extern "C" int beom_shard_split_subcycle_##SUFFIX(                          \
      const void* const* ptrs, const int* ints, const double* dbls,           \
      const void* const* dyn, const int* geom, void* const* outs,             \
      void* stream) {                                                         \
    return shard_subcycle<T>(ptrs, ints, dbls, dyn, geom, outs, stream);      \
  }                                                                           \
  extern "C" int beom_shard_split_recompose_##SUFFIX(                         \
      const void* const* ptrs, const int* ints, const double* dbls,           \
      const void* const* dyn, const int* geom, void* h1, void* u1, void* v1,  \
      void* stream) {                                                         \
    return shard_recompose<T>(ptrs, ints, dbls, dyn, geom, h1, u1, v1,        \
                              stream);                                        \
  }

SHARD_SPLIT_ENTRIES(f32, float)
SHARD_SPLIT_ENTRIES(f64, double)

// the halo of a shard's padded statics, and per kernel (slow 0, recompose
// 1, subcycle 2) its own halo, for the wrapper
extern "C" int beom_shard_halo() { return PAD; }
extern "C" int beom_kernel_halo(int which) {
  return which == 0 ? slow::W : which == 1 ? rec::W : sub::W;
}

// dynamic shared memory of one CTA of the slow (0), recompose (1) and
// subcycle (2) kernels: the single-device kernels' (fused_fb.smem_bytes)
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
