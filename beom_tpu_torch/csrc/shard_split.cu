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
// Where K1s streams its layers (a build with BEOM_STREAM = 1: route 3 from
// fused_fb._STREAM_FROM layers, and wherever no tile fits), the slow phase
// (route 2's tendencies) and the recomposition run K1s's streamed bodies
// (split_body.cuh, namespace sps) over one CTA per tile of every shard,
// each block's offsets from the stacked layout: the slow phase in one
// launch, the recomposition in two (the continuity and the rescale into
// h1, then the velocities and finalize reading h1 back at their block's
// points, across cards through its nine stacks, ordered after the
// neighbour card's first launch by the wrapper).  No build keeps a
// block's planes in device memory.
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

#if BEOM_STREAM

// The layer-streamed slow phase (NO = N_SLOW) or its tendencies (NO =
// N_TEND) and recomposition (split_body.cuh, namespace sps), as K1s's:
// one CTA per tile of every shard, the block's offsets from the stacked
// layout
template <typename T, int NO>
__global__ void __launch_bounds__(THREADS, sps::SLOW_CTAS<T>)
shard_slow_layers_kernel(const BEOM_CLASSED Params<T> p, const Stack m,
                         const Ptrs<T, NO> out) {
  const ShardTile t = shard_tile(m, TX, TY);
  const int b = t.base(m);
  sps::slow::run_at<T, NO, true>(p, m, t.gy0, t.gx0, t.out(m, p.plane),
                                 at(out, b), b);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
shard_rec_h_layers_kernel(const BEOM_CLASSED Params<T> p,
                          const BEOM_CLASSED StackSrc<T, N_REC_IN> src_,
                          T* out_h) {
  const ShardTile t = shard_tile(src_.m, TX, TY);
  sps::rch::run_at<T, true>(p, src_.m, t.gy0, t.gx0, t.out(src_.m, p.plane),
                            src_.from(t), out_h + t.base(src_.m));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
shard_rec_uv_layers_kernel(const BEOM_CLASSED Params<T> p,
                           const BEOM_CLASSED StackSrc<T, N_REC_IN> src_,
                           const BEOM_CLASSED Field<T> h1, T* out_u,
                           T* out_v) {
  const ShardTile t = shard_tile(src_.m, TX, TY);
  const int b = t.base(src_.m);
  sps::ruv::run_at<T, true>(p, src_.m, t.gy0, t.gx0, t.out(src_.m, p.plane),
                            src_.from(t), h1.f, out_u + b, out_v + b);
}

#else

template <typename T>
__global__ void __launch_bounds__(THREADS)
shard_slow_kernel(const BEOM_CLASSED Params<T> p,
                  const BEOM_CLASSED StackSrc<T, N_SLOW_IN> src,
                  const Ptrs<T, N_SLOW> out) {
  const ShardTile t = shard_tile(src.m, TX, TY);
  slow::run<T>(p, src.from(t), at(out, t.base(src.m)), t.out(src.m, p.plane));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
shard_tend_kernel(const BEOM_CLASSED Params<T> p,
                  const BEOM_CLASSED StackSrc<T, N_SLOW_IN> src,
                  const Ptrs<T, N_TEND> out) {
  const ShardTile t = shard_tile(src.m, TX, TY);
  slow::run<T>(p, src.from(t), at(out, t.base(src.m)), t.out(src.m, p.plane));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
shard_rec_kernel(const BEOM_CLASSED Params<T> p,
                 const BEOM_CLASSED StackSrc<T, N_REC_IN> src,
                 T* out_h, T* out_u, T* out_v) {
  const ShardTile t = shard_tile(src.m, TX, TY);
  const int b = t.base(src.m);
  rec::run<T>(p, src.from(t), t.out(src.m, p.plane), out_h + b, out_u + b,
              out_v + b);
}

#endif

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

// The slow phase's kernels: SlowPhase's fields (NO = N_SLOW) or the layer
// tendencies (NO = N_TEND) into outs
template <typename T, int NO>
int shard_slow(const void* const* ptrs, const int* ints, const double* dbls,
               const int* geom, void* const* outs, void* stream) {
  Params<T> p = make_params<T>(ptrs, ints, dbls);
  Stack m;
  if (!make_stack(p, geom, slow::W, m)) return int(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
#if BEOM_STREAM
  constexpr int smem = sps::slow::smem_bytes<T>();
  const cudaError_t e = allow(shard_slow_layers_kernel<T, NO>, smem);
  if (e != cudaSuccess) return int(e);
  shard_slow_layers_kernel<T, NO><<<m.grid(TX, TY), THREADS, smem, st>>>(
      p, m, pack<T, NO>(outs));
#else
  constexpr int smem = slow::smem_bytes<T>();
  const auto src = make_stack_src<T, N_SLOW_IN>(ptrs, m, p.plane, N_PTR);
  if constexpr (NO == N_SLOW) {
    const cudaError_t e = allow(shard_slow_kernel<T>, smem);
    if (e != cudaSuccess) return int(e);
    shard_slow_kernel<T><<<m.grid(TX, TY), THREADS, smem, st>>>(
        p, src, pack<T, N_SLOW>(outs));
  } else {
    const cudaError_t e = allow(shard_tend_kernel<T>, smem);
    if (e != cudaSuccess) return int(e);
    shard_tend_kernel<T><<<m.grid(TX, TY), THREADS, smem, st>>>(
        p, src, pack<T, N_TEND>(outs));
  }
#endif
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

// RecIn's fields of card c's table: h from the operand table, then the
// slow phase's and the subcycle's (across cards the nine classes', one
// table after another)
inline void rec_fields(const void** fields, const void* const* ptrs,
                       void* const* slow_fields, void* const* sub_fields) {
  for (int c = 0; c < NCLS; ++c) {
    const void** f = fields + c * N_REC_IN;
    f[R_H] = ptrs[c * N_PTR + I_H];
    for (int i = 0; i < N_SLOW; ++i) f[R_SP + i] = slow_fields[c * N_SLOW + i];
    for (int i = 0; i < N_SUB; ++i) f[R_SB + i] = sub_fields[c * N_SUB + i];
  }
}

#if BEOM_STREAM

// The streamed recomposition's two launches, one entry each: the
// continuity and the column rescale into h1, then the velocities and
// finalize, which take h1 back (across cards a host table of its nine
// stacks)
template <typename T>
int shard_rec_h(const void* const* ptrs, const int* ints, const double* dbls,
                const int* geom, void* const* slow_fields,
                void* const* sub_fields, void* h1, void* stream) {
  Params<T> p = make_params<T>(ptrs, ints, dbls);
  Stack m;
  if (!make_stack(p, geom, sps::rch::W, m))
    return int(cudaErrorInvalidValue);
  constexpr int smem = sps::rch::smem_bytes<T>();
  const cudaError_t e = allow(shard_rec_h_layers_kernel<T>, smem);
  if (e != cudaSuccess) return int(e);
  const void* fields[NCLS * N_REC_IN];
  rec_fields(fields, ptrs, slow_fields, sub_fields);
  shard_rec_h_layers_kernel<T><<<m.grid(TX, TY), THREADS, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      p, make_stack_src<T, N_REC_IN>(fields, m, p.plane),
      static_cast<T*>(h1));
  return int(cudaGetLastError());
}

template <typename T>
int shard_rec_uv(const void* const* ptrs, const int* ints,
                 const double* dbls, const int* geom,
                 void* const* slow_fields, void* const* sub_fields,
                 const void* h1, void* u1, void* v1, void* stream) {
  Params<T> p = make_params<T>(ptrs, ints, dbls);
  Stack m;
  if (!make_stack(p, geom, sps::ruv::W, m))
    return int(cudaErrorInvalidValue);
  constexpr int smem = sps::ruv::smem_bytes<T>();
  const cudaError_t e = allow(shard_rec_uv_layers_kernel<T>, smem);
  if (e != cudaSuccess) return int(e);
  const void* fields[NCLS * N_REC_IN];
  rec_fields(fields, ptrs, slow_fields, sub_fields);
  shard_rec_uv_layers_kernel<T><<<m.grid(TX, TY), THREADS, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      p, make_stack_src<T, N_REC_IN>(fields, m, p.plane), field_of<T>(h1),
      static_cast<T*>(u1), static_cast<T*>(v1));
  return int(cudaGetLastError());
}

#else

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
  rec_fields(fields, ptrs, slow_fields, sub_fields);
  shard_rec_kernel<T><<<m.grid(TX, TY), THREADS, rec::smem_bytes<T>(),
                        static_cast<cudaStream_t>(stream)>>>(
      p, make_stack_src<T, N_REC_IN>(fields, m, p.plane),
      static_cast<T*>(h1), static_cast<T*>(u1), static_cast<T*>(v1));
  return int(cudaGetLastError());
}

#endif

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

#if BEOM_STREAM
// the streamed recomposition's two entries
#define SHARD_REC_ENTRIES(SUFFIX, T)                                          \
  extern "C" int beom_shard_split_rec_h_##SUFFIX(                             \
      const void* const* ptrs, const int* ints, const double* dbls,           \
      const int* geom, void* const* slow_fields, void* const* sub_fields,     \
      void* h1, void* stream) {                                               \
    return shard_rec_h<T>(ptrs, ints, dbls, geom, slow_fields, sub_fields,    \
                          h1, stream);                                        \
  }                                                                           \
  extern "C" int beom_shard_split_rec_uv_##SUFFIX(                            \
      const void* const* ptrs, const int* ints, const double* dbls,           \
      const int* geom, void* const* slow_fields, void* const* sub_fields,     \
      const void* h1, void* u1, void* v1, void* stream) {                     \
    return shard_rec_uv<T>(ptrs, ints, dbls, geom, slow_fields, sub_fields,   \
                           h1, u1, v1, stream);                               \
  }
#else
#define SHARD_REC_ENTRIES(SUFFIX, T)                                          \
  extern "C" int beom_shard_split_recompose_##SUFFIX(                         \
      const void* const* ptrs, const int* ints, const double* dbls,           \
      const int* geom, void* const* slow_fields, void* const* sub_fields,     \
      void* h1, void* u1, void* v1, void* stream) {                           \
    return shard_recompose<T>(ptrs, ints, dbls, geom, slow_fields,            \
                              sub_fields, h1, u1, v1, stream);                \
  }
#endif

#define SHARD_SPLIT_ENTRIES(SUFFIX, T)                                        \
  extern "C" int beom_shard_split_slow_##SUFFIX(                              \
      const void* const* ptrs, const int* ints, const double* dbls,           \
      const int* geom, void* const* outs, void* stream) {                     \
    return shard_slow<T, N_SLOW>(ptrs, ints, dbls, geom, outs, stream);       \
  }                                                                           \
  extern "C" int beom_shard_split_tend_##SUFFIX(                              \
      const void* const* ptrs, const int* ints, const double* dbls,           \
      const int* geom, void* const* outs, void* stream) {                     \
    return shard_slow<T, N_TEND>(ptrs, ints, dbls, geom, outs, stream);       \
  }                                                                           \
  extern "C" int beom_shard_split_subcycle_##SUFFIX(                          \
      const void* const* ptrs, const int* ints, const double* dbls,           \
      const int* geom, void* const* slow_fields, void* const* outs,           \
      void* stream) {                                                         \
    return shard_subcycle<T>(ptrs, ints, dbls, geom, slow_fields, outs,       \
                             stream);                                         \
  }                                                                           \
  extern "C" int beom_shard_split_tail_##SUFFIX(                              \
      const void* const* ptrs, const int* ints, const double* dbls,           \
      const int* geom, void* const* tend, void* h1, void* u1, void* v1,       \
      void* stream) {                                                         \
    return shard_tail<T>(ptrs, ints, dbls, geom, tend, h1, u1, v1, stream);   \
  }                                                                           \
  SHARD_REC_ENTRIES(SUFFIX, T)

SHARD_SPLIT_ENTRIES(f32, float)
SHARD_SPLIT_ENTRIES(f64, double)

// per kernel (slow 0, recompose 1, subcycle 2, tail 3) the halo it reads
// around a tile, for the wrapper (the streamed recomposition's two
// launches together: the continuity's LO, then the velocities' 1 around
// that)
extern "C" int beom_kernel_halo(int which) {
  return which == 0   ? slow::W
         : which == 1 ? rec::W
         : which == 2 ? sub::W
                      : tail::HALO;
}

// dynamic shared memory of one CTA of the slow (0), recompose (1),
// subcycle (2) and tail (3) kernels: the single-device kernels'
// (fused_fb.smem_bytes); in the streamed build 1 is the recomposition's
// continuity kernel and 4 its velocity kernel (fused_fb.split_stream_smem)
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
extern "C" int beom_smem_bytes(int which, int is_f64) {
  return is_f64 ? kernel_smem<double>(which) : kernel_smem<float>(which);
}

// The largest kernel parameters of the port: the recomposition's, Params
// and its source of N_REC_IN stacked operands with three outputs (the
// streamed velocity kernel's: with h1's stacks and two outputs), within
// the 4096 bytes of fb_terms.cuh's PARAM_LIMIT
static_assert(sizeof(Params<double>) + sizeof(StackSrc<double, N_REC_IN>) +
                      sizeof(Field<double>) + 2 * sizeof(void*) <=
                  PARAM_LIMIT,
              "the recomposition's kernel parameters exceed the limit");

extern "C" const char* beom_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
