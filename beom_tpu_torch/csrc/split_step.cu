// K1s: one split barotropic / baroclinic step (stepping/split.py::
// split_step) of nz layers, by one of two routes (stencils/fused_fb.py::
// split_plan picks one per case):
//   route 2, two launches: the slow phase's layer tendencies (split_tend:
//     slow::run writing du_s, dv_s only), then the tail (split_tail:
//     SlowPhase rebuilt from h, u, v and them, the barotropic subcycle, the
//     recomposition and fb.finalize on blocks with a halo of nsub + LO +
//     E, csrc/split_body.cuh namespace tail);
//   route 3, three launches: the slow phase (all of SlowPhase), the
//     subcycle and the recomposition with fb.finalize, each through device
//     memory.
//
// Replaces beom_tpu/stencils/band.py::_band_kernel running the split body
// of beom_tpu/stencils/fused_fb.py::make_pallas_stepper.
//
// Why not one launch, as the TPU kernel's band does.  The slow phase is
// the most expensive part per point, and a halo of nsub + 3 around a tile
// would evaluate it on several times the tile's points.  Its loads and
// stores set its time (on the H100 at 2048^2 f32: 0.175 ms, its loads
// and stores alone 0.183, its stages alone 0.084; tools/k1s_probes.py), so
// it runs on small tiles with a halo of 2 and writes as little as it can.
// Route 3 writes SlowPhase (4 nz + 9 planes) and has the recomposition
// read it back; route 2 writes 2 nz planes and has the tail rebuild the
// rest from h, u, v at each point, op for op, so each value is bitwise the
// stored one, and keeps the subcycle's outputs in shared memory.  The
// tail's block holds only what neighbours read: route 2 pays for the
// halo with stage work on blocks of 1.4 to 3 times the tile's points, and
// where that exceeds what route 3's trips through memory cost (the shelf
// at nsub 8: its planes allow only small tiles), the plan keeps route 3.
// A cooperative launch with a grid-wide barrier per substep was the other
// candidate: its 2 nsub passes over the 2-D fields would each stream about
// a dozen planes from device memory (2048^2 f32: 200 MB, four times the
// L2).
//
// The layer-streamed route (a build with BEOM_STREAM = 1, where
// fused_fb.split_plan takes it: many layers).  Route 3's slow phase and
// recomposition hold every layer's planes of their block in shared memory,
// so past a few layers their tiles shrink (the shelf at 32 layers f32: 8 x
// 8, a block of 14 x 14 points and 228 planes per CTA for 64 interior
// points; slow 8.78 ms, recompose 26.57 on the H100 at 2048^2, 6 and 20 x
// their byte bounds) and past 41 none fits.  The layers couple only at the
// point itself (Montgomery's running sums, the depth means and the column
// sums of the rescale and of Flather), so the streamed kernels hold a few
// planes of one layer on 32 x 16 tiles, whatever NZ, and keep the column
// sums of the points a thread owns in registers (split_body.cuh, sps): the
// slow phase in one launch, its depth means subtracted in a second loop
// over each thread's points; the recomposition in two, the continuity and
// the column rescale into out_h, then the velocities and finalize from the
// rescaled h1 read back.  The subcycle and route 2's tail are the same
// kernels in either build; K7 (shard_split.cu) runs the same streamed
// bodies on the shards.
//
// Bound: device-memory bytes, for each kernel.  Arithmetic mirrors the
// eager split_step op for op (fb_terms.cuh), so each kernel equals its
// plain version (slow_tendencies, slow_phase, subcycle_phase, recompose +
// finalize, depth_means + fast_phase) bit for bit on the card.  The stage
// bodies are csrc/split_body.cuh's, whose three route-3 bodies the same
// kernels on the shards of a device mesh (shard_split.cu) run too; here a
// tile's points come from the whole grid with periodic wrap.  Where no
// tile fits, the layers stream.

#include "split_body.cuh"

namespace {

using namespace beom;
using namespace beom::spk;

// the interior points of the CTA's tile of TX_ x TY_ in the whole grid
template <typename T, int TX_, int TY_>
__device__ __forceinline__ Out grid_out(const Params<T>& p) {
  return Out{int(blockIdx.y) * TY_, int(blockIdx.x) * TX_, p.ny, p.nx,
             p.plane};
}

#if BEOM_STREAM

// the slow phase (NO = N_SLOW) or its tendencies (NO = N_TEND), streamed
template <typename T, int NO>
__global__ void __launch_bounds__(THREADS, sps::SLOW_CTAS<T>)
split_slow_layers_kernel(const Params<T> p, const Ptrs<T, NO> out) {
  const Out o = grid_out<T, TX, TY>(p);
  sps::slow::run_at<T, NO, false>(p, Stack{}, o.y0, o.x0, o, out, 0);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
split_rec_h_layers_kernel(const Params<T> p, const GridSrc<T, N_REC_IN> src,
                          T* out_h) {
  const Out o = grid_out<T, TX, TY>(p);
  sps::rch::run_at<T, false>(p, Stack{}, o.y0, o.x0, o, src, out_h);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
split_rec_uv_layers_kernel(const Params<T> p,
                           const GridSrc<T, N_REC_IN> src, const T* h1,
                           T* out_u, T* out_v) {
  const Out o = grid_out<T, TX, TY>(p);
  sps::ruv::run_at<T, false>(p, Stack{}, o.y0, o.x0, o, src, h1, out_u,
                             out_v);
}

#else

template <typename T>
__global__ void __launch_bounds__(THREADS)
split_slow_kernel(const Params<T> p, const GridSrc<T, N_SLOW_IN> src,
                  const Ptrs<T, N_SLOW> out) {
  slow::run<T>(p, src, out, grid_out<T, TX, TY>(p));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
split_tend_kernel(const Params<T> p, const GridSrc<T, N_SLOW_IN> src,
                  const Ptrs<T, N_TEND> out) {
  slow::run<T>(p, src, out, grid_out<T, TX, TY>(p));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
split_rec_kernel(const Params<T> p, const GridSrc<T, N_REC_IN> src,
                 T* out_h, T* out_u, T* out_v) {
  rec::run<T>(p, src, grid_out<T, TX, TY>(p), out_h, out_u, out_v);
}

#endif

template <typename T>
__global__ void __launch_bounds__(sub::THREADS_SUB)
split_sub_kernel(const Params<T> p, const GridSrc<T, N_SLOW> src,
                 const Ptrs<T, N_SUB> out, T dte, T inv_nsub) {
  sub::run<T>(p, src, out, grid_out<T, SX, SY>(p), dte, inv_nsub);
}

template <typename T>
__global__ void __launch_bounds__(tail::QT)
split_tail_kernel(const Params<T> p, const Ptrs<T, N_TEND> tend, T* out_h,
                  T* out_u, T* out_v, T dte, T inv_nsub) {
  tail::run<T>(p, tend, grid_out<T, QX, tail::QY>(p), out_h, out_u, out_v,
               dte, inv_nsub);
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

// allow a kernel its dynamic shared memory
template <typename K>
cudaError_t allow(K kernel, int smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// The slow phase's kernels: SlowPhase's fields (NO = N_SLOW) or the layer
// tendencies (NO = N_TEND) into outs
template <typename T, int NO>
int split_slow(const void* const* ptrs, const int* ints, const double* dbls,
               void* const* outs, void* stream) {
  const Params<T> p = make_params<T>(ptrs, ints, dbls);
  const dim3 grid = tiles_of(p.ny, p.nx, TX, TY);
  const auto st = static_cast<cudaStream_t>(stream);
#if BEOM_STREAM
  constexpr int smem = sps::slow::smem_bytes<T>();
  cudaError_t e = allow(split_slow_layers_kernel<T, NO>, smem);
  if (e != cudaSuccess) return int(e);
  split_slow_layers_kernel<T, NO><<<grid, THREADS, smem, st>>>(
      p, pack<T, NO>(outs));
#else
  constexpr int smem = slow::smem_bytes<T>();
  if constexpr (NO == N_SLOW) {
    cudaError_t e = allow(split_slow_kernel<T>, smem);
    if (e != cudaSuccess) return int(e);
    split_slow_kernel<T><<<grid, THREADS, smem, st>>>(
        p, grid_src<T, N_SLOW_IN>(p, ptrs), pack<T, N_SLOW>(outs));
  } else {
    cudaError_t e = allow(split_tend_kernel<T>, smem);
    if (e != cudaSuccess) return int(e);
    split_tend_kernel<T><<<grid, THREADS, smem, st>>>(
        p, grid_src<T, N_SLOW_IN>(p, ptrs), pack<T, N_TEND>(outs));
  }
#endif
  return int(cudaGetLastError());
}

template <typename T>
int split_subcycle(const void* const* ptrs, const int* ints,
                   const double* dbls, void* const* slow_fields,
                   void* const* outs, void* stream) {
  const Params<T> p = make_params<T>(ptrs, ints, dbls);
  if (p.nsub != NSUB) return int(cudaErrorInvalidValue);
  constexpr int smem = sub::smem_bytes<T>();
  cudaError_t e = allow(split_sub_kernel<T>, smem);
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

// The recomposition with fb.finalize: one launch, or in the streamed build
// two (the continuity and the rescale into h1, then the velocities and
// finalize reading h1 back)
template <typename T>
int split_recompose(const void* const* ptrs, const int* ints,
                    const double* dbls, void* const* slow_fields,
                    void* const* sub_fields, void* h1, void* u1, void* v1,
                    void* stream) {
  const Params<T> p = make_params<T>(ptrs, ints, dbls);
  const void* fields[N_REC_IN];
  fields[R_H] = ptrs[I_H];
  for (int i = 0; i < N_SLOW; ++i) fields[R_SP + i] = slow_fields[i];
  for (int i = 0; i < N_SUB; ++i) fields[R_SB + i] = sub_fields[i];
  const GridSrc<T, N_REC_IN> src = grid_src<T, N_REC_IN>(p, fields);
  const dim3 grid = tiles_of(p.ny, p.nx, TX, TY);
  const auto st = static_cast<cudaStream_t>(stream);
#if BEOM_STREAM
  constexpr int smem_h = sps::rch::smem_bytes<T>();
  constexpr int smem_uv = sps::ruv::smem_bytes<T>();
  cudaError_t e = allow(split_rec_h_layers_kernel<T>, smem_h);
  if (e != cudaSuccess) return int(e);
  e = allow(split_rec_uv_layers_kernel<T>, smem_uv);
  if (e != cudaSuccess) return int(e);
  split_rec_h_layers_kernel<T><<<grid, THREADS, smem_h, st>>>(
      p, src, static_cast<T*>(h1));
  e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  split_rec_uv_layers_kernel<T><<<grid, THREADS, smem_uv, st>>>(
      p, src, static_cast<const T*>(h1), static_cast<T*>(u1),
      static_cast<T*>(v1));
#else
  constexpr int smem = rec::smem_bytes<T>();
  cudaError_t e = allow(split_rec_kernel<T>, smem);
  if (e != cudaSuccess) return int(e);
  split_rec_kernel<T><<<grid, THREADS, smem, st>>>(
      p, src, static_cast<T*>(h1), static_cast<T*>(u1), static_cast<T*>(v1));
#endif
  return int(cudaGetLastError());
}

template <typename T>
int split_tail(const void* const* ptrs, const int* ints, const double* dbls,
               void* const* tend, void* h1, void* u1, void* v1,
               void* stream) {
  const Params<T> p = make_params<T>(ptrs, ints, dbls);
  if (p.nsub != NSUB) return int(cudaErrorInvalidValue);
  constexpr int smem = tail::smem_bytes<T>();
  cudaError_t e = allow(split_tail_kernel<T>, smem);
  if (e != cudaSuccess) return int(e);
  const dim3 grid((p.nx + QX - 1) / QX, (p.ny + tail::QY - 1) / tail::QY);
  const T dte = T(dbls[D_DT] / NSUB);
  const T inv_nsub = T(1) / T(NSUB);
  split_tail_kernel<T><<<grid, tail::QT, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      p, pack<T, N_TEND>(tend), static_cast<T*>(h1), static_cast<T*>(u1),
      static_cast<T*>(v1), dte, inv_nsub);
  return int(cudaGetLastError());
}

// dynamic shared memory of one CTA of the slow (0), recompose (1),
// subcycle (2) and tail (3) kernels, for the wrapper's plan (the slow
// phase's tendencies, split_tend, run in the slow kernel's body); in the
// streamed build 1 is the recomposition's continuity kernel and 4 its
// velocity kernel (0 elsewhere)
template <typename T>
constexpr int kernel_smem(int which) {
#if BEOM_STREAM
  if (which == 0) return sps::slow::smem_bytes<T>();
  if (which == 1) return sps::rch::smem_bytes<T>();
  if (which == 4) return sps::ruv::smem_bytes<T>();
#else
  if (which == 0) return slow::smem_bytes<T>();
  if (which == 1) return rec::smem_bytes<T>();
  if (which == 4) return 0;
#endif
  if (which == 2) return sub::smem_bytes<T>();
  return tail::smem_bytes<T>();
}

}  // namespace

#define SPLIT_ENTRIES(SUFFIX, T)                                             \
  extern "C" int beom_split_slow_##SUFFIX(                                   \
      const void* const* ptrs, const int* ints, const double* dbls,          \
      void* const* outs, void* stream) {                                     \
    return split_slow<T, N_SLOW>(ptrs, ints, dbls, outs, stream);            \
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
  }                                                                          \
  extern "C" int beom_split_tend_##SUFFIX(                                   \
      const void* const* ptrs, const int* ints, const double* dbls,          \
      void* const* outs, void* stream) {                                     \
    return split_slow<T, N_TEND>(ptrs, ints, dbls, outs, stream);            \
  }                                                                          \
  extern "C" int beom_split_tail_##SUFFIX(                                   \
      const void* const* ptrs, const int* ints, const double* dbls,          \
      void* const* tend, void* h1, void* u1, void* v1, void* stream) {       \
    return split_tail<T>(ptrs, ints, dbls, tend, h1, u1, v1, stream);        \
  }

SPLIT_ENTRIES(f32, float)
SPLIT_ENTRIES(f64, double)

extern "C" int beom_smem_bytes(int which, int is_f64) {
  return is_f64 ? kernel_smem<double>(which) : kernel_smem<float>(which);
}

extern "C" const char* beom_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
