// K7 around the split body: one split barotropic / baroclinic step
// (stepping/split.py::split_step) on the shards of a device mesh that lie
// on one card, by the routes of the single-device step (split_step.cu,
// K1s), each kernel one launch per card over its shards:
//   route 2, two launches: the slow phase's layer tendencies (tend), then
//     the tail (the depth means rebuilt, the subcycle, the recomposition
//     and fb.finalize on blocks with a halo of nsub + LO + E);
//   route 3, three launches: the slow phase, the subcycle and the
//     recomposition with fb.finalize, each through device memory.
//
// Replaces beom_tpu/stencils/dist_band.py::_dist_band_kernel running the
// split body of beom_tpu/parallel/dist.py::make_dist_pallas_stepper.
//
// The TPU kernel runs the whole step in one launch over a y halo of
// ceil8(8 + 2 nsub) rows, exchanged in-kernel.  Here the shards share one
// card, so a kernel's launch covers the tiles of every shard (shard_addr.cuh:
// ShardTile) and one stream orders the kernels: a CTA reads what a
// neighbour shard's CTAs wrote in the previous kernel.  Every operand is
// one allocation of (L, S, ly, lx) in mesh order (Stack): the statics, the
// step's h, u, v, the tendencies, and route 3's SlowPhase (4 nz + 9 planes)
// and subcycle fields (5 planes).
//
// Across cards (BEOM_CARDS = 1) each card launches over its own shards and
// reads a neighbour card's points through the nine stacks of each operand
// (shard_addr.cuh), SlowPhase's, the subcycle's and the tendencies' too.
//
// Bound: device-memory bytes for the slow phase, its stages for the tail,
// as K1s.  The stage bodies are K1s's (csrc/split_body.cuh), so each kernel
// equals the single-device kernel on the same points bit for bit.

#include "split_body.cuh"

namespace {

using namespace beom;
using namespace beom::spk;

// the outputs of the CTA's shard: each stacked field from the shard's block
template <typename T, int N>
__device__ __forceinline__ Ptrs<T, N> at(Ptrs<T, N> o, int base) {
#pragma unroll
  for (int i = 0; i < N; ++i) o.p[i] += base;
  return o;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
shard_slow_kernel(const BEOM_CLASSED Params<T> p,
                  const BEOM_CLASSED StackSrc<T, N_SLOW_IN> src,
                  const Ptrs<T, N_SLOW> out) {
  for_tiles(src.m.grid(TX, TY), [&](int bx, int by) {
    const ShardTile t = shard_tile(src.m, TX, TY, bx, by);
    slow::run<T>(p, src.from(t), at(out, t.base(src.m)),
                 t.out(src.m, p.plane));
  });
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
shard_tend_kernel(const BEOM_CLASSED Params<T> p,
                  const BEOM_CLASSED StackSrc<T, N_SLOW_IN> src,
                  const Ptrs<T, N_TEND> out) {
  for_tiles(src.m.grid(TX, TY), [&](int bx, int by) {
    const ShardTile t = shard_tile(src.m, TX, TY, bx, by);
    slow::run<T>(p, src.from(t), at(out, t.base(src.m)),
                 t.out(src.m, p.plane));
  });
}

template <typename T>
__global__ void __launch_bounds__(sub::THREADS_SUB)
shard_sub_kernel(const BEOM_CLASSED Params<T> p,
                 const BEOM_CLASSED StackSrc<T, N_SLOW> src,
                 const Ptrs<T, N_SUB> out, T dte, T inv_nsub) {
  const ShardTile t = shard_tile(src.m, SX, SY);
  sub::run<T>(p, src.from(t), at(out, t.base(src.m)), t.out(src.m, p.plane),
              dte, inv_nsub);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
shard_rec_kernel(const BEOM_CLASSED Params<T> p,
                 const BEOM_CLASSED StackSrc<T, N_REC_IN> src,
                 T* out_h, T* out_u, T* out_v) {
  for_tiles(src.m.grid(TX, TY), [&](int bx, int by) {
    const ShardTile t = shard_tile(src.m, TX, TY, bx, by);
    const int b = t.base(src.m);
    rec::run<T>(p, src.from(t), t.out(src.m, p.plane), out_h + b,
                out_u + b, out_v + b);
  });
}

template <typename T>
__global__ void __launch_bounds__(tail::QT)
shard_tail_kernel(const BEOM_CLASSED Params<T> p, const Stack m,
                  const BEOM_CLASSED Ins<T, N_TEND> tend, T* out_h, T* out_u,
                  T* out_v, T dte, T inv_nsub) {
  const ShardTile t = shard_tile(m, QX, tail::QY);
  const int b = t.base(m);
  tail::run_at<T, true>(p, tend, t.out(m, p.plane), out_h + b, out_u + b,
                        out_v + b, dte, inv_nsub, t.gy0, t.gx0, m);
}

template <typename T, int N>
Ptrs<T, N> pack(void* const* a) {
  Ptrs<T, N> r;
  for (int i = 0; i < N; ++i) r.p[i] = static_cast<T*>(a[i]);
  return r;
}

// the stacked fields of a kernel's input table (set_bases' layout)
template <typename T, int N>
Ins<T, N> ins(const void* const* a) {
  Ins<T, N> r;
  set_bases<T, N>(r.p, a);
  return r;
}

template <typename K>
cudaError_t allow(K kernel, int smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// Every entry takes: ptrs, the host table of fb_terms.cuh, every operand
// stacked (L, S, ly, lx); ints[J_NY], ints[J_NX] the grid; geom =
// ly, lx, my, mx, cy, cx, a, b (shard_addr.cuh: make_stack); the stacked
// fields each kernel reads besides (SlowPhase's 13, the subcycle's 5, the
// tendencies' 2) as pointer tables in the order of split_body.cuh's enums
// (across cards, these tables and ptrs hold the nine card classes' one
// after another); then its outputs, stacked.

template <typename T>
int shard_slow(const void* const* ptrs, const int* ints, const double* dbls,
               const int* geom, void* const* outs, void* stream) {
  Params<T> p = make_params<T>(ptrs, ints, dbls);
  Stack m;
  cudaError_t e =
      make_stack(p, geom, slow::W, m) ? cudaSuccess : cudaErrorInvalidValue;
  if (e == cudaSuccess)
    e = allow(shard_slow_kernel<T>, slow::smem_bytes<T>());
  if (e != cudaSuccess) return int(e);
  const dim3 grid = tile_grid(m.grid(TX, TY), p);
  if (grid.x == 0) return int(cudaErrorInvalidValue);
  shard_slow_kernel<T><<<grid, THREADS, slow::smem_bytes<T>(),
                         static_cast<cudaStream_t>(stream)>>>(
      p, make_stack_src<T, N_SLOW_IN>(ptrs, m, p.plane, N_TABLE),
      pack<T, N_SLOW>(outs));
  return int(cudaGetLastError());
}

template <typename T>
int shard_tend(const void* const* ptrs, const int* ints, const double* dbls,
               const int* geom, void* const* outs, void* stream) {
  Params<T> p = make_params<T>(ptrs, ints, dbls);
  Stack m;
  cudaError_t e =
      make_stack(p, geom, slow::W, m) ? cudaSuccess : cudaErrorInvalidValue;
  if (e == cudaSuccess)
    e = allow(shard_tend_kernel<T>, slow::smem_bytes<T>());
  if (e != cudaSuccess) return int(e);
  const dim3 grid = tile_grid(m.grid(TX, TY), p);
  if (grid.x == 0) return int(cudaErrorInvalidValue);
  shard_tend_kernel<T><<<grid, THREADS, slow::smem_bytes<T>(),
                         static_cast<cudaStream_t>(stream)>>>(
      p, make_stack_src<T, N_SLOW_IN>(ptrs, m, p.plane, N_TABLE),
      pack<T, N_TEND>(outs));
  return int(cudaGetLastError());
}

template <typename T>
int shard_subcycle(const void* const* ptrs, const int* ints,
                   const double* dbls, const int* geom,
                   void* const* slow_fields, void* const* outs,
                   void* stream) {
  Params<T> p = make_params<T>(ptrs, ints, dbls);
  Stack m;
  cudaError_t e =
      make_stack(p, geom, sub::W, m) ? cudaSuccess : cudaErrorInvalidValue;
  if (e == cudaSuccess && p.nsub != NSUB) e = cudaErrorInvalidValue;
  if (e == cudaSuccess)
    e = allow(shard_sub_kernel<T>, sub::smem_bytes<T>());
  if (e != cudaSuccess) return int(e);
  const T dte = T(dbls[D_DT] / NSUB);
  const T inv_nsub = T(1) / T(NSUB);
  shard_sub_kernel<T><<<m.grid(SX, SY), sub::THREADS_SUB,
                        sub::smem_bytes<T>(),
                        static_cast<cudaStream_t>(stream)>>>(
      p, make_stack_src<T, N_SLOW>(slow_fields, m, p.plane),
      pack<T, N_SUB>(outs), dte, inv_nsub);
  return int(cudaGetLastError());
}

template <typename T>
int shard_recompose(const void* const* ptrs, const int* ints,
                    const double* dbls, const int* geom,
                    void* const* slow_fields, void* const* sub_fields,
                    void* h1, void* u1, void* v1, void* stream) {
  Params<T> p = make_params<T>(ptrs, ints, dbls);
  Stack m;
  cudaError_t e =
      make_stack(p, geom, rec::W, m) ? cudaSuccess : cudaErrorInvalidValue;
  if (e == cudaSuccess)
    e = allow(shard_rec_kernel<T>, rec::smem_bytes<T>());
  if (e != cudaSuccess) return int(e);
  const void* fields[NCLS * N_REC_IN];
  for (int c = 0; c < NCLS; ++c) {
    const void** f = fields + c * N_REC_IN;
    f[R_H] = ptrs[c * N_TABLE + I_H];
    for (int i = 0; i < N_SLOW; ++i) f[R_SP + i] = slow_fields[c * N_SLOW + i];
    for (int i = 0; i < N_SUB; ++i) f[R_SB + i] = sub_fields[c * N_SUB + i];
  }
  const dim3 grid = tile_grid(m.grid(TX, TY), p);
  if (grid.x == 0) return int(cudaErrorInvalidValue);
  shard_rec_kernel<T><<<grid, THREADS, rec::smem_bytes<T>(),
                        static_cast<cudaStream_t>(stream)>>>(
      p, make_stack_src<T, N_REC_IN>(fields, m, p.plane),
      static_cast<T*>(h1), static_cast<T*>(u1), static_cast<T*>(v1));
  return int(cudaGetLastError());
}

template <typename T>
int shard_tail(const void* const* ptrs, const int* ints, const double* dbls,
               const int* geom, void* const* tend, void* h1, void* u1,
               void* v1, void* stream) {
  Params<T> p = make_params<T>(ptrs, ints, dbls);
  Stack m;
  cudaError_t e =
      make_stack(p, geom, tail::HALO, m) ? cudaSuccess : cudaErrorInvalidValue;
  if (e == cudaSuccess && p.nsub != NSUB) e = cudaErrorInvalidValue;
  constexpr int smem = tail::smem_bytes<T>();
  if (e == cudaSuccess) e = allow(shard_tail_kernel<T>, smem);
  if (e != cudaSuccess) return int(e);
  const T dte = T(dbls[D_DT] / NSUB);
  const T inv_nsub = T(1) / T(NSUB);
  shard_tail_kernel<T><<<m.grid(QX, tail::QY), tail::QT, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      p, m, ins<T, N_TEND>(tend), static_cast<T*>(h1), static_cast<T*>(u1),
      static_cast<T*>(v1), dte, inv_nsub);
  return int(cudaGetLastError());
}

}  // namespace

#define SHARD_SPLIT_ENTRIES(SUFFIX, T)                                        \
  extern "C" int beom_shard_split_slow_##SUFFIX(                              \
      const void* const* ptrs, const int* ints, const double* dbls,           \
      const int* geom, void* const* outs, void* stream) {                     \
    return shard_slow<T>(ptrs, ints, dbls, geom, outs, stream);               \
  }                                                                           \
  extern "C" int beom_shard_split_tend_##SUFFIX(                              \
      const void* const* ptrs, const int* ints, const double* dbls,           \
      const int* geom, void* const* outs, void* stream) {                     \
    return shard_tend<T>(ptrs, ints, dbls, geom, outs, stream);               \
  }                                                                           \
  extern "C" int beom_shard_split_subcycle_##SUFFIX(                          \
      const void* const* ptrs, const int* ints, const double* dbls,           \
      const int* geom, void* const* slow_fields, void* const* outs,           \
      void* stream) {                                                         \
    return shard_subcycle<T>(ptrs, ints, dbls, geom, slow_fields, outs,       \
                             stream);                                         \
  }                                                                           \
  extern "C" int beom_shard_split_recompose_##SUFFIX(                         \
      const void* const* ptrs, const int* ints, const double* dbls,           \
      const int* geom, void* const* slow_fields, void* const* sub_fields,     \
      void* h1, void* u1, void* v1, void* stream) {                           \
    return shard_recompose<T>(ptrs, ints, dbls, geom, slow_fields,            \
                              sub_fields, h1, u1, v1, stream);                \
  }                                                                           \
  extern "C" int beom_shard_split_tail_##SUFFIX(                              \
      const void* const* ptrs, const int* ints, const double* dbls,           \
      const int* geom, void* const* tend, void* h1, void* u1, void* v1,       \
      void* stream) {                                                         \
    return shard_tail<T>(ptrs, ints, dbls, geom, tend, h1, u1, v1, stream);   \
  }

SHARD_SPLIT_ENTRIES(f32, float)
SHARD_SPLIT_ENTRIES(f64, double)

// per kernel (slow 0, recompose 1, subcycle 2, tail 3) the halo it reads
// around a tile, for the wrapper
extern "C" int beom_kernel_halo(int which) {
  return which == 0   ? slow::W
         : which == 1 ? rec::W
         : which == 2 ? sub::W
                      : tail::HALO;
}

// dynamic shared memory of one CTA of the slow (0), recompose (1),
// subcycle (2) and tail (3) kernels: the single-device kernels'
// (fused_fb.smem_bytes)
extern "C" int beom_smem_bytes(int which, int is_f64) {
  if (which == 0)
    return is_f64 ? slow::smem_bytes<double>() : slow::smem_bytes<float>();
  if (which == 1)
    return is_f64 ? rec::smem_bytes<double>() : rec::smem_bytes<float>();
  if (which == 2)
    return is_f64 ? sub::smem_bytes<double>() : sub::smem_bytes<float>();
  return is_f64 ? tail::smem_bytes<double>() : tail::smem_bytes<float>();
}

// the spill route: bytes of a CTA's slice of the scratch of the slow (0)
// and recompose (1) kernels (0 in any other build, and for the others),
// and the CTAs of the slow (0), recompose (1) and tendency (4) kernels the
// current device holds at once
extern "C" long beom_work_bytes(int which, int is_f64) {
  if (which == 0 || which == 4)
    return is_f64 ? slow::work_bytes<double>() : slow::work_bytes<float>();
  if (which == 1)
    return is_f64 ? rec::work_bytes<double>() : rec::work_bytes<float>();
  return 0;
}
template <typename T>
int spill_ctas(int which) {
  if (which == 0)
    return resident_ctas(shard_slow_kernel<T>, THREADS,
                         slow::smem_bytes<T>());
  if (which == 1)
    return resident_ctas(shard_rec_kernel<T>, THREADS, rec::smem_bytes<T>());
  if (which == 4)
    return resident_ctas(shard_tend_kernel<T>, THREADS,
                         slow::smem_bytes<T>());
  return 0;
}
extern "C" int beom_spill_ctas(int which, int is_f64) {
  return is_f64 ? spill_ctas<double>(which) : spill_ctas<float>(which);
}

// The largest kernel parameters of the port: the recomposition's, Params,
// its source of N_REC_IN stacked operands and three outputs, within the
// 4096 bytes of fb_terms.cuh's PARAM_LIMIT
static_assert(sizeof(Params<double>) + sizeof(StackSrc<double, N_REC_IN>) +
                      3 * sizeof(void*) <=
                  PARAM_LIMIT,
              "the recomposition's kernel parameters exceed the limit");

extern "C" const char* beom_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
