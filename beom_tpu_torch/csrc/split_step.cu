// K1s: one split barotropic / baroclinic step (stepping/split.py::
// split_step) of nz layers, as three kernels: the slow phase, the
// barotropic subcycle, and the recomposition with fb.finalize.
//
// Replaces beom_tpu/stencils/band.py::_band_kernel running the split body
// of beom_tpu/stencils/fused_fb.py::make_pallas_stepper.
//
// Why three launches and not one.  The TPU kernel absorbs the subcycle in a
// halo of 2 nsub rows on a full-width band of 128 rows (a halo in y only,
// 12 % more rows at nsub = 8).  A CTA's tile is 32 x 16 points with a halo
// on both axes: one fused launch would need a halo of nsub + 3 points, so
// at nsub = 8 it would evaluate the whole slow phase, by far the most
// expensive part, on 54 x 38 points for 32 x 16 results, four times over.
// Here the slow phase and the recomposition run on tiles with halos of 2
// and 2 (3 under wet/dry) points, and only the subcycle, a dozen
// operations per point and substep on three 2-D fields, pays for the wide
// halo, on larger tiles (64 x 32 points at f32) that hold nothing but its
// ten 2-D planes, with nsub and that tile compile-time too.  The price is one trip of the SlowPhase fields
// (4 nz + 9 planes) through device memory.  A cooperative launch with a
// grid-wide barrier per substep was the other candidate: its 2 nsub
// passes over the 2-D fields would each stream about a dozen planes from
// device memory (2048^2 f32: 200 MB, four times the L2), against one read
// of them here.
//
// Bound: device-memory bytes, for each of the three.  Arithmetic mirrors
// the eager split_step op for op (fb_terms.cuh), so each kernel equals its
// plain version (slow_phase, subcycle_phase, recompose + finalize) bit for
// bit on the card.  The stage bodies are csrc/split_body.cuh's, which the
// same three kernels on the shards of a device mesh (shard_split.cu) run
// too; here a tile's points come from the whole grid with periodic wrap.

#include "split_body.cuh"

namespace {

using namespace beom;
using namespace beom::spk;

// a tile's interior points in the whole grid
template <typename T, int TX_, int TY_>
__device__ __forceinline__ Out grid_out(const Params<T>& p) {
  return Out{int(blockIdx.y) * TY_, int(blockIdx.x) * TX_, p.ny, p.nx,
             p.plane};
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
split_slow_kernel(const Params<T> p, const GridSrc<T, N_SLOW_IN> src,
                  const Ptrs<T, N_SLOW> out) {
  slow::run<T>(p, src, out, grid_out<T, TX, TY>(p));
}

template <typename T>
__global__ void __launch_bounds__(sub::THREADS_SUB)
split_sub_kernel(const Params<T> p, const GridSrc<T, N_SLOW> src,
                 const Ptrs<T, N_SUB> out, T dte, T inv_nsub) {
  sub::run<T>(p, src, out, grid_out<T, SX, SY>(p), dte, inv_nsub);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
split_rec_kernel(const Params<T> p, const GridSrc<T, N_REC_IN> src,
                 T* out_h, T* out_u, T* out_v) {
  rec::run<T>(p, src, grid_out<T, TX, TY>(p), out_h, out_u, out_v);
}

template <typename T, int N>
Ptrs<T, N> pack(void* const* a) {
  Ptrs<T, N> r;
  for (int i = 0; i < N; ++i) r.p[i] = static_cast<T*>(a[i]);
  return r;
}

// a source over the whole grid of the fields `f`
template <typename T, int NF>
GridSrc<T, NF> grid_src(const Params<T>& p, const void* const* f) {
  GridSrc<T, NF> s;
  for (int i = 0; i < NF; ++i) s.f[i] = static_cast<const T*>(f[i]);
  s.ny = p.ny;
  s.nx = p.nx;
  s.plane = p.plane;
  return s;
}

template <typename T>
int split_slow(const void* const* ptrs, const int* ints, const double* dbls,
               void* const* outs, void* stream) {
  const Params<T> p = make_params<T>(ptrs, ints, dbls);
  constexpr int smem = slow::smem_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(
      split_slow_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return int(e);
  const dim3 grid((p.nx + TX - 1) / TX, (p.ny + TY - 1) / TY);
  split_slow_kernel<T><<<grid, THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      p, grid_src<T, N_SLOW_IN>(p, ptrs), pack<T, N_SLOW>(outs));
  return int(cudaGetLastError());
}

template <typename T>
int split_subcycle(const void* const* ptrs, const int* ints,
                   const double* dbls, void* const* slow_fields,
                   void* const* outs, void* stream) {
  const Params<T> p = make_params<T>(ptrs, ints, dbls);
  if (p.nsub != NSUB) return int(cudaErrorInvalidValue);
  constexpr int smem = sub::smem_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(
      split_sub_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return int(e);
  const dim3 grid((p.nx + SX - 1) / SX, (p.ny + SY - 1) / SY);
  const T dte = T(dbls[D_DT] / NSUB);
  const T inv_nsub = T(1) / T(NSUB);
  split_sub_kernel<T><<<grid, sub::THREADS_SUB, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      p, grid_src<T, N_SLOW>(p, slow_fields), pack<T, N_SUB>(outs), dte,
      inv_nsub);
  return int(cudaGetLastError());
}

template <typename T>
int split_recompose(const void* const* ptrs, const int* ints,
                    const double* dbls, void* const* slow_fields,
                    void* const* sub_fields, void* h1, void* u1, void* v1,
                    void* stream) {
  const Params<T> p = make_params<T>(ptrs, ints, dbls);
  constexpr int smem = rec::smem_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(
      split_rec_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return int(e);
  const void* fields[N_REC_IN];
  fields[R_H] = ptrs[I_H];
  for (int i = 0; i < N_SLOW; ++i) fields[R_SP + i] = slow_fields[i];
  for (int i = 0; i < N_SUB; ++i) fields[R_SB + i] = sub_fields[i];
  const dim3 grid((p.nx + TX - 1) / TX, (p.ny + TY - 1) / TY);
  split_rec_kernel<T><<<grid, THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      p, grid_src<T, N_REC_IN>(p, fields), static_cast<T*>(h1),
      static_cast<T*>(u1), static_cast<T*>(v1));
  return int(cudaGetLastError());
}

}  // namespace

#define SPLIT_ENTRIES(SUFFIX, T)                                             \
  extern "C" int beom_split_slow_##SUFFIX(                                   \
      const void* const* ptrs, const int* ints, const double* dbls,          \
      void* const* outs, void* stream) {                                     \
    return split_slow<T>(ptrs, ints, dbls, outs, stream);                    \
  }                                                                          \
  extern "C" int beom_split_subcycle_##SUFFIX(                               \
      const void* const* ptrs, const int* ints, const double* dbls,          \
      void* const* slow_fields, void* const* outs, void* stream) {           \
    return split_subcycle<T>(ptrs, ints, dbls, slow_fields, outs, stream);   \
  }                                                                          \
  extern "C" int beom_split_recompose_##SUFFIX(                              \
      const void* const* ptrs, const int* ints, const double* dbls,          \
      void* const* slow_fields, void* const* sub_fields, void* h1, void* u1, \
      void* v1, void* stream) {                                              \
    return split_recompose<T>(ptrs, ints, dbls, slow_fields, sub_fields, h1, \
                              u1, v1, stream);                               \
  }

SPLIT_ENTRIES(f32, float)
SPLIT_ENTRIES(f64, double)

// dynamic shared memory of one CTA of the slow (0), recompose (1) and
// subcycle (2) kernels, for the wrapper's choice of tiles
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
