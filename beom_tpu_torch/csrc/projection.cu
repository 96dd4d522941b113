// K3a and K3b: the two phases of a rigid-lid / implicit-free-surface step
// (stepping/projection.py) of nz layers with every term of the eager step,
// each fused into one launch.
//
// Replace beom_tpu/stencils/band.py::_band_kernel running the bodies
// body_a and body_b of
// beom_tpu/stencils/fused_projection.py::make_pallas_projection_stepper.
//
//   proj_a (K3a): the provisional momentum of fb.momentum_update with
//     free_surface=False from the old thickness (the Montgomery potential
//     without its surface term, K, PV, viscosity and biharmonic, wind,
//     interfacial and bottom drag, sponge), then the barotropic transport
//     U, V = sum_k a_xp(h_k) u*_k, sum_k a_yp(h_k) v*_k (masked) and its
//     divergence div = (d_xm U + d_ym V) mask.
//   proj_b (K3b): u1 = (u* - corr mask_u d_xp p) mask_u (v1 likewise, the
//     same correction in every layer), the per-layer continuity
//     h1 = (h + dt dh(h, u1, v1)) mask with the wet/dry limiter, then
//     fb.finalize: the wet/dry gates and Flather with the tides at t + dt.
//
// The term code is that of the fused forward-backward step
// (fb_terms.cuh), under the same compile-time switches: one build per
// combination of layer count, terms and tile.
//
// Bound: device-memory bytes, as K1 (csrc/fb_step.cu).  K3a reads
// 3 nz + 7 fields (plus the sponge) and writes 2 nz + 1; K3b reads
// 3 nz + 4 (plus H and the open-boundary and tide operands) and writes
// 3 nz.  Every intermediate stays in shared memory: one CTA per 2-D tile,
// loaded with a periodic halo on both axes that covers the phase's
// dependence cone, so a point costs one read of each operand and one
// write of each result.  Phase A stores nothing it can recompute: like
// K1 it keeps phi, q and the two sweeps as planes and evaluates the
// tendencies where they are used.
//
// K3a's stages, as [lo, R - hi) on both axes of the R-point block (h is
// loaded, so there is no continuity stage before the momentum):
//   S1 lap(u), lap(v) for nu4; phi = M + K, q        [1, R-1)
//   S2 first Coriolis sweep with its tendencies, drag [2, R-2)
//   S3 second sweep                                   [3, R-3)
//   S4 U, V, div on the interior                      [W, R-W), which
//      reads u*, v* one cell west and south: W = 4.
// K3b's: S1 u1, v1 on [0, R-1); S2 h1 on [LO, R-LO); S3 gates and Flather
// on the interior, which reads h1 one cell east and north: W = LO + 1, or
// 1 when neither wet/dry nor the open boundary is on (finalize is then the
// identity).  The stage bodies are csrc/projection_body.cuh's, which the
// phases on the shards of a device mesh (shard_projection.cu) run too;
// here a tile's points come from the whole grid with periodic wrap.
//
// Where no tile's planes of every layer fit a CTA (many layers), and from
// the layer count fused_projection.plan streams at, both phases stream the
// layers through a few planes of one layer (a build with BEOM_STREAM,
// projection_body.cuh: pal, pbl).  K3a's stages couple the layers only by
// Montgomery's running sums, the interfacial drag and the column's
// transports: the sums are carried in two planes, the drag's neighbours
// read from device memory, the transports summed in registers at each
// thread's own points.  K3b's only by Flather, whose sums are kept in
// registers and whose increment is added to u1, v1 afterwards.  They
// replace the spill route (the planes in a device-memory scratch beyond
// the L2: 15.0 ms for K3a and 19.4 for K3b a step at 32 layers on 2048^2
// f32 on the H100; K3b 3.8 streamed), which the projection no longer has.
//
// The phases run by default as the staged kernels proj_as and
// proj_bs (projection_body.cuh: namespaces pas, pbs), on tiles of their
// own geometry chosen per case by stencils/fused_projection.py::plan.  On
// the H100 (tools/k3_probes.py) the single-step K3a was bound by its stages,
// with its loads (gathers through a per-point offset table) adding to them
// nearly in full, and K3b by its loads: the staged kernels copy every
// operand a stage reads by cp.async, on tiles with fewer block points per
// tile point, rebuild the staggered masks from the centre mask where the
// grid's are make_grid's, cut each stage to the points the next one reads,
// and compute the tide's elevation on the tile's points only.  proj_as
// also writes, in its epilogue, the solve's right-hand side and warm start
// (Epi), so the step needs no elementwise pass between K3a and the solve.

#include "projection_body.cuh"

namespace {

using namespace beom;
using namespace beom::prj;

// the interior points of tile (bx, by) in the whole grid
template <typename T>
__device__ __forceinline__ Out grid_out(const Params<T>& p, int bx, int by) {
  return Out{by * TY, bx * TX, p.ny, p.nx, p.plane};
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
proj_a_kernel(const Params<T> p, const GridSrc<T, N_IN_A> src, T* out_us,
              T* out_vs, T* out_div) {
  pa::run<T>(p, src, grid_out(p, int(blockIdx.x), int(blockIdx.y)), out_us,
             out_vs, out_div);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
proj_a_layers_kernel(const Params<T> p, T* out_us, T* out_vs, T* out_div) {
  const int bx = int(blockIdx.x), by = int(blockIdx.y);
  pal::run_at<T, false>(p, Stack{}, by * TY, bx * TX, grid_out(p, bx, by),
                        out_us, out_vs, out_div);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
proj_b_kernel(const Params<T> p, const GridSrc<T, N_IN_B> src, T corr,
              T* out_h, T* out_u, T* out_v) {
  pb::run<T>(p, src, grid_out(p, int(blockIdx.x), int(blockIdx.y)), corr,
             out_h, out_u, out_v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
proj_b_layers_kernel(const Params<T> p, const T* pres, T corr, T* out_h,
                     T* out_u, T* out_v) {
  const int bx = int(blockIdx.x), by = int(blockIdx.y);
  pbl::run_at<T, false>(p, Stack{}, by * TY, bx * TX, grid_out(p, bx, by),
                        pres, corr, out_h, out_u, out_v);
}

template <typename T>
__global__ void __launch_bounds__(pas::THREADS, pas::MINB)
proj_as_kernel(const Params<T> p, T* out_us, T* out_vs, const Epi<T> ep) {
  pas::run<T>(p, out_us, out_vs, ep);
}

template <typename T>
__global__ void __launch_bounds__(pbs::THREADS, pbs::MINB)
proj_bs_kernel(const Params<T> p, const T* pres, T corr, T* out_h, T* out_u,
               T* out_v) {
  pbs::run<T>(p, pres, corr, out_h, out_u, out_v);
}

// a source over the whole grid: h, u, v of the operand table, and p
template <typename T, int NF>
GridSrc<T, NF> grid_src(const Params<T>& p, const void* pres) {
  GridSrc<T, NF> s;
  s.f[F_H] = p.in[I_H];
  s.f[F_U] = p.in[I_U];
  s.f[F_V] = p.in[I_V];
  if constexpr (NF == N_IN_B) s.f[F_P] = static_cast<const T*>(pres);
  s.ny = p.ny;
  s.nx = p.nx;
  s.plane = p.plane;
  return s;
}

// dynamic shared memory of one CTA of the build's proj_a and proj_b
template <typename T>
constexpr int a_smem() {
  return STREAM ? pal::smem_bytes<T>() : pa::smem_bytes<T>();
}
template <typename T>
constexpr int b_smem() {
  return STREAM ? pbl::smem_bytes<T>() : pb::smem_bytes<T>();
}

template <typename T>
int proj_a(const void* const* ptrs, const int* ints, const double* dbls,
           void* us, void* vs, void* div, void* stream) {
  const Params<T> p = make_params<T>(ptrs, ints, dbls);
  constexpr int smem = a_smem<T>();
  const dim3 grid = tiles_of(p.ny, p.nx, TX, TY);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if constexpr (STREAM) {
    e = cudaFuncSetAttribute(proj_a_layers_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return int(e);
    proj_a_layers_kernel<T><<<grid, THREADS, smem, st>>>(
        p, static_cast<T*>(us), static_cast<T*>(vs), static_cast<T*>(div));
  } else {
    e = cudaFuncSetAttribute(proj_a_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return int(e);
    proj_a_kernel<T><<<grid, THREADS, smem, st>>>(
        p, grid_src<T, N_IN_A>(p, nullptr), static_cast<T*>(us),
        static_cast<T*>(vs), static_cast<T*>(div));
  }
  return int(cudaGetLastError());
}

template <typename T>
int proj_b(const void* const* ptrs, const int* ints, const double* dbls,
           const void* pres, double corr, void* h1, void* u1, void* v1,
           void* stream) {
  const Params<T> p = make_params<T>(ptrs, ints, dbls);
  constexpr int smem = b_smem<T>();
  const dim3 grid = tiles_of(p.ny, p.nx, TX, TY);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if constexpr (STREAM) {
    e = cudaFuncSetAttribute(proj_b_layers_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return int(e);
    proj_b_layers_kernel<T><<<grid, THREADS, smem, st>>>(
        p, static_cast<const T*>(pres), T(corr), static_cast<T*>(h1),
        static_cast<T*>(u1), static_cast<T*>(v1));
  } else {
    e = cudaFuncSetAttribute(proj_b_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return int(e);
    proj_b_kernel<T><<<grid, THREADS, smem, st>>>(
        p, grid_src<T, N_IN_B>(p, pres), T(corr), static_cast<T*>(h1),
        static_cast<T*>(u1), static_cast<T*>(v1));
  }
  return int(cudaGetLastError());
}

// epi: div, eta, b, x0, phi, phi_prev (Epi; null: not written or read)
template <typename T>
int proj_as(const void* const* ptrs, const int* ints, const double* dbls,
            void* us, void* vs, void* const* epi, double lam_neg,
            void* stream) {
  const Params<T> p = make_params<T>(ptrs, ints, dbls);
  constexpr int smem = pas::smem_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(
      proj_as_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return int(e);
  const Epi<T> ep{static_cast<T*>(epi[0]), static_cast<T*>(epi[1]),
                  static_cast<T*>(epi[2]), static_cast<T*>(epi[3]),
                  static_cast<const T*>(epi[4]),
                  static_cast<const T*>(epi[5]), T(lam_neg)};
  const dim3 grid((p.nx + pas::TX - 1) / pas::TX,
                  (p.ny + pas::TY - 1) / pas::TY);
  proj_as_kernel<T><<<grid, pas::THREADS, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<T*>(us), static_cast<T*>(vs), ep);
  return int(cudaGetLastError());
}

template <typename T>
int proj_bs(const void* const* ptrs, const int* ints, const double* dbls,
            const void* pres, double corr, void* h1, void* u1, void* v1,
            void* stream) {
  const Params<T> p = make_params<T>(ptrs, ints, dbls);
  constexpr int smem = pbs::smem_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(
      proj_bs_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return int(e);
  const dim3 grid((p.nx + pbs::TX - 1) / pbs::TX,
                  (p.ny + pbs::TY - 1) / pbs::TY);
  proj_bs_kernel<T><<<grid, pbs::THREADS, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const T*>(pres), T(corr), static_cast<T*>(h1),
      static_cast<T*>(u1), static_cast<T*>(v1));
  return int(cudaGetLastError());
}

}  // namespace

#define PROJ_ENTRIES(SUFFIX, T)                                              \
  extern "C" int beom_proj_a_##SUFFIX(                                       \
      const void* const* ptrs, const int* ints, const double* dbls,          \
      void* us, void* vs, void* div, void* stream) {                         \
    return proj_a<T>(ptrs, ints, dbls, us, vs, div, stream);                 \
  }                                                                          \
  extern "C" int beom_proj_b_##SUFFIX(                                       \
      const void* const* ptrs, const int* ints, const double* dbls,          \
      const void* pres, double corr, void* h1, void* u1, void* v1,           \
      void* stream) {                                                        \
    return proj_b<T>(ptrs, ints, dbls, pres, corr, h1, u1, v1, stream);      \
  }                                                                          \
  extern "C" int beom_proj_as_##SUFFIX(                                      \
      const void* const* ptrs, const int* ints, const double* dbls,          \
      void* us, void* vs, void* const* epi, double lam_neg, void* stream) {  \
    return proj_as<T>(ptrs, ints, dbls, us, vs, epi, lam_neg, stream);       \
  }                                                                          \
  extern "C" int beom_proj_bs_##SUFFIX(                                      \
      const void* const* ptrs, const int* ints, const double* dbls,          \
      const void* pres, double corr, void* h1, void* u1, void* v1,           \
      void* stream) {                                                        \
    return proj_bs<T>(ptrs, ints, dbls, pres, corr, h1, u1, v1, stream);     \
  }

PROJ_ENTRIES(f32, float)
PROJ_ENTRIES(f64, double)

// dynamic shared memory of one CTA of proj_a (0), proj_b (1; both
// layer-streamed in a build with BEOM_STREAM), proj_as (2) and proj_bs
// (3), for the wrapper's check of its tile
extern "C" int beom_smem_bytes(int which, int is_f64) {
  if (which == 0)
    return is_f64 ? a_smem<double>() : a_smem<float>();
  if (which == 1)
    return is_f64 ? b_smem<double>() : b_smem<float>();
  if (which == 2)
    return is_f64 ? pas::smem_bytes<double>() : pas::smem_bytes<float>();
  return is_f64 ? pbs::smem_bytes<double>() : pbs::smem_bytes<float>();
}

extern "C" const char* beom_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
