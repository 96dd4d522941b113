// K7 around the projection bodies: the two phases of a rigid-lid /
// implicit-free-surface step (stepping/projection.py) on the shards of a
// device mesh that lie on one card, each phase one launch per card over
// its shards:
//
//   phase A: the provisional momentum u*, v* without the surface term and
//     the divergence of the barotropic transport, from h, u, v (halo 4);
//   phase B: the correction by grad p, the layer continuity and finalize,
//     from h, u*, v* and the solved p (halo 1, 2 or 3 by build).
//
// Replaces beom_tpu/stencils/dist_band.py::_dist_band_kernel built twice by
// beom_tpu/parallel/dist.py::make_dist_pallas_projection_stepper, with the
// bodies body_a (phase A) and body_b (phase B).
//
// Each phase runs the kernel the single-device plan takes for it
// (fused_projection.plan): K3a's / K3b's staged kernel (projection_body.cuh:
// pas, pbs; every operand copied into shared memory by cp.async) at the
// plan's geometry; where no staged geometry fits a CTA, the single-step
// body (pa, pb) on the build's tile, every haloed point read through
// StackSrc from the shard it falls into; or, in a build with BEOM_STREAM
// (many layers), the layer-streamed bodies (pal, pbl), whose offset table
// is filled from the stacked layout (shard_addr.cuh: block_offsets).  Each
// runs over the tiles of every shard (ShardTile), one CTA per tile.  Every
// operand, the statics too, is one allocation of (L, S, ly, lx) in mesh
// order (Stack), so a block reads a neighbour shard's rows through its row
// and column offsets as on one device.  The elliptic solve between the
// phases is the mesh's own solver (stencils/dist_band.py); one stream
// orders the phases and the solve.  Across cards (BEOM_CARDS = 1) a card
// reads its neighbour cards' points, p's too, through their stacks'
// pointers (shard_addr.cuh), and events order the cards' streams.
//
// Bound: device-memory bytes, as K3a / K3b.  The stage bodies are theirs,
// so each phase equals the single-device kernel on the same points bit for
// bit.

#include "projection_body.cuh"

namespace {

using namespace beom;
using namespace beom::prj;

template <typename T>
__global__ void __launch_bounds__(THREADS)
shard_pa_kernel(const BEOM_CLASSED Params<T> p,
                const BEOM_CLASSED StackSrc<T, N_IN_A> src_, T* out_us,
                T* out_vs, T* out_div) {
  const ShardTile t = shard_tile(src_.m, TX, TY);
  const auto src = src_.from(t);
  const int b = t.base(src.m);
  pa::run<T>(p, src, t.out(src.m, p.plane), out_us + b, out_vs + b,
             out_div + b);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
shard_pb_kernel(const BEOM_CLASSED Params<T> p,
                const BEOM_CLASSED StackSrc<T, N_IN_B> src_, T corr,
                T* out_h, T* out_u, T* out_v) {
  const ShardTile t = shard_tile(src_.m, TX, TY);
  const auto src = src_.from(t);
  const int b = t.base(src.m);
  pb::run<T>(p, src, t.out(src.m, p.plane), corr, out_h + b, out_u + b,
             out_v + b);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
shard_pal_kernel(const BEOM_CLASSED Params<T> p, const Stack m, T* out_us,
                 T* out_vs, T* out_div) {
  const ShardTile t = shard_tile(m, TX, TY);
  const int b = t.base(m);
  pal::run_at<T, true>(p, m, t.gy0, t.gx0, t.out(m, p.plane), out_us + b,
                       out_vs + b, out_div + b);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
shard_pbl_kernel(const BEOM_CLASSED Params<T> p, const Stack m,
                 const BEOM_CLASSED Field<T> pres, T corr, T* out_h,
                 T* out_u, T* out_v) {
  const ShardTile t = shard_tile(m, TX, TY);
  const int b = t.base(m);
  pbl::run_at<T, true>(p, m, t.gy0, t.gx0, t.out(m, p.plane), pres.f, corr,
                       out_h + b, out_u + b, out_v + b);
}

template <typename T>
__global__ void __launch_bounds__(pas::THREADS, pas::MINB)
shard_pas_kernel(const BEOM_CLASSED Params<T> p, const Stack m, T* out_us,
                 T* out_vs, const Epi<T> ep) {
  pas::run_shards<T>(p, m, out_us, out_vs, ep);
}

template <typename T>
__global__ void __launch_bounds__(pbs::THREADS, pbs::MINB)
shard_pbs_kernel(const BEOM_CLASSED Params<T> p, const Stack m,
                 const BEOM_CLASSED Field<T> pres, T corr, T* out_h, T* out_u,
                 T* out_v) {
  pbs::run_shards<T>(p, m, pres.f, corr, out_h, out_u, out_v);
}

template <typename K>
cudaError_t allow(K kernel, int smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// Every entry takes: ptrs, the host table of fb_terms.cuh, every operand
// stacked (L, S, ly, lx) (h, u*, v* for phase B); ints[J_NY],
// ints[J_NX] the grid; geom = ly, lx, my, mx, cy, cx, a, b (shard_addr.cuh:
// make_stack); then phase A's outputs u*, v*, div or phase B's p, the
// correction factor and the outputs h1, u1, v1, all stacked.  Across cards
// ptrs holds the operand tables of the nine card classes one after another
// and p is a host table of its nine stacks.  shard_proj_a / _b launch the
// single-step bodies (layer-streamed in a build with BEOM_STREAM),
// shard_proj_as / _bs the staged ones.

// dynamic shared memory of one CTA of the build's single-step phases
template <typename T>
constexpr int a_smem() {
  return STREAM ? pal::smem_bytes<T>() : pa::smem_bytes<T>();
}
template <typename T>
constexpr int b_smem() {
  return STREAM ? pbl::smem_bytes<T>() : pb::smem_bytes<T>();
}

template <typename T>
int shard_proj_a(const void* const* ptrs, const int* ints, const double* dbls,
                 const int* geom, void* us, void* vs, void* div,
                 void* stream) {
  Params<T> p = make_params<T>(ptrs, ints, dbls);
  Stack m;
  if (!make_stack(p, geom, pa::W, m)) return int(cudaErrorInvalidValue);
  constexpr int smem = a_smem<T>();
  const auto st = static_cast<cudaStream_t>(stream);
  if constexpr (STREAM) {
    const cudaError_t e = allow(shard_pal_kernel<T>, smem);
    if (e != cudaSuccess) return int(e);
    shard_pal_kernel<T><<<m.grid(TX, TY), THREADS, smem, st>>>(
        p, m, static_cast<T*>(us), static_cast<T*>(vs),
        static_cast<T*>(div));
  } else {
    const cudaError_t e = allow(shard_pa_kernel<T>, smem);
    if (e != cudaSuccess) return int(e);
    shard_pa_kernel<T><<<m.grid(TX, TY), THREADS, smem, st>>>(
        p, make_stack_src<T, N_IN_A>(ptrs, m, p.plane, N_PTR),
        static_cast<T*>(us), static_cast<T*>(vs), static_cast<T*>(div));
  }
  return int(cudaGetLastError());
}

template <typename T>
int shard_proj_b(const void* const* ptrs, const int* ints, const double* dbls,
                 const int* geom, const void* pres, double corr, void* h1,
                 void* u1, void* v1, void* stream) {
  Params<T> p = make_params<T>(ptrs, ints, dbls);
  Stack m;
  if (!make_stack(p, geom, pb::W, m)) return int(cudaErrorInvalidValue);
  constexpr int smem = b_smem<T>();
  const auto st = static_cast<cudaStream_t>(stream);
  if constexpr (STREAM) {
    const cudaError_t e = allow(shard_pbl_kernel<T>, smem);
    if (e != cudaSuccess) return int(e);
    shard_pbl_kernel<T><<<m.grid(TX, TY), THREADS, smem, st>>>(
        p, m, field_of<T>(pres), T(corr), static_cast<T*>(h1),
        static_cast<T*>(u1), static_cast<T*>(v1));
  } else {
    const cudaError_t e = allow(shard_pb_kernel<T>, smem);
    if (e != cudaSuccess) return int(e);
    // h, u*, v* from the operand table, p after them
    const void* f[NCLS * N_IN_B];
    for (int c = 0; c < NCLS; ++c) {
      for (int k = 0; k < F_P; ++k)
        f[c * N_IN_B + k] = ptrs[c * N_PTR + k];
      f[c * N_IN_B + F_P] =
          BEOM_CARDS ? static_cast<const void* const*>(pres)[c] : pres;
    }
    shard_pb_kernel<T><<<m.grid(TX, TY), THREADS, smem, st>>>(
        p, make_stack_src<T, N_IN_B>(f, m, p.plane), T(corr),
        static_cast<T*>(h1), static_cast<T*>(u1), static_cast<T*>(v1));
  }
  return int(cudaGetLastError());
}

template <typename T>
int shard_proj_as(const void* const* ptrs, const int* ints,
                  const double* dbls, const int* geom, void* us, void* vs,
                  void* div, void* stream) {
  Params<T> p = make_params<T>(ptrs, ints, dbls);
  Stack m;
  if (!make_stack(p, geom, pas::W, m)) return int(cudaErrorInvalidValue);
  constexpr int smem = pas::smem_bytes<T>();
  const cudaError_t e = allow(shard_pas_kernel<T>, smem);
  if (e != cudaSuccess) return int(e);
  const Epi<T> ep{static_cast<T*>(div), nullptr, nullptr, nullptr, nullptr,
                  nullptr, T(0)};
  shard_pas_kernel<T><<<m.grid(pas::TX, pas::TY), pas::THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      p, m, static_cast<T*>(us), static_cast<T*>(vs), ep);
  return int(cudaGetLastError());
}

template <typename T>
int shard_proj_bs(const void* const* ptrs, const int* ints,
                  const double* dbls, const int* geom, const void* pres,
                  double corr, void* h1, void* u1, void* v1, void* stream) {
  Params<T> p = make_params<T>(ptrs, ints, dbls);
  Stack m;
  if (!make_stack(p, geom, pbs::WX, m)) return int(cudaErrorInvalidValue);
  constexpr int smem = pbs::smem_bytes<T>();
  const cudaError_t e = allow(shard_pbs_kernel<T>, smem);
  if (e != cudaSuccess) return int(e);
  shard_pbs_kernel<T><<<m.grid(pbs::TX, pbs::TY), pbs::THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      p, m, field_of<T>(pres), T(corr), static_cast<T*>(h1),
      static_cast<T*>(u1), static_cast<T*>(v1));
  return int(cudaGetLastError());
}

}  // namespace

#define SHARD_PHASE_ENTRIES(NAME, SUFFIX, T)                                  \
  extern "C" int beom_##NAME##_##SUFFIX(                                      \
      const void* const* ptrs, const int* ints, const double* dbls,           \
      const int* geom, void* us, void* vs, void* div, void* stream) {         \
    return NAME<T>(ptrs, ints, dbls, geom, us, vs, div, stream);              \
  }
#define SHARD_PHASE_B_ENTRIES(NAME, SUFFIX, T)                                \
  extern "C" int beom_##NAME##_##SUFFIX(                                      \
      const void* const* ptrs, const int* ints, const double* dbls,           \
      const int* geom, const void* pres, double corr, void* h1, void* u1,     \
      void* v1, void* stream) {                                               \
    return NAME<T>(ptrs, ints, dbls, geom, pres, corr, h1, u1, v1, stream);   \
  }

SHARD_PHASE_ENTRIES(shard_proj_a, f32, float)
SHARD_PHASE_ENTRIES(shard_proj_a, f64, double)
SHARD_PHASE_ENTRIES(shard_proj_as, f32, float)
SHARD_PHASE_ENTRIES(shard_proj_as, f64, double)
SHARD_PHASE_B_ENTRIES(shard_proj_b, f32, float)
SHARD_PHASE_B_ENTRIES(shard_proj_b, f64, double)
SHARD_PHASE_B_ENTRIES(shard_proj_bs, f32, float)
SHARD_PHASE_B_ENTRIES(shard_proj_bs, f64, double)

// per phase (A 0, B 1) the halo it reads on y, for the wrapper (the
// single-step and the staged body read the same)
extern "C" int beom_kernel_halo(int which) {
  return which == 0 ? pa::W : pb::W;
}

// dynamic shared memory of one CTA of the single-step phase A (0) and B
// (1; layer-streamed in a build with BEOM_STREAM) and of the staged ones
// (2, 3): the single-device kernels' (fused_projection.smem_bytes,
// stream_smem, staged_smem)
extern "C" int beom_smem_bytes(int which, int is_f64) {
  switch (which) {
    case 0:
      return is_f64 ? a_smem<double>() : a_smem<float>();
    case 1:
      return is_f64 ? b_smem<double>() : b_smem<float>();
    case 2:
      return is_f64 ? pas::smem_bytes<double>() : pas::smem_bytes<float>();
    default:
      return is_f64 ? pbs::smem_bytes<double>() : pbs::smem_bytes<float>();
  }
}

extern "C" const char* beom_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
