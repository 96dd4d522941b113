// K7: free-surface forward-backward steps (stepping/fb.py::fb_step) on
// the shards of a device mesh that lie on one card, in one launch per
// card: one step per launch (a build with BEOM_KB = 1), or a pass of KB
// steps per launch, as K1 (fb_step.cu) runs them on the whole grid; or,
// in the layer-streamed build (BEOM_KB = 1 with BEOM_STREAM = 1, where K1
// streams its layers: no tile's planes of every layer fit a CTA), K1's
// streamed step in two launches per card.
//
// Replaces beom_tpu/stencils/dist_band.py::_dist_band_kernel running the
// fb body of beom_tpu/parallel/dist.py::make_dist_pallas_stepper, which
// steps a shard's band with a halo exchanged in-kernel, KB steps per
// exchange (its temporal blocking): the pass kernel below.
//
// The TPU kernel overlaps its halo exchange with the interior bands.  On
// one card there is nothing to overlap: every shard's block is in the
// card's memory.  So one launch covers the tiles of every shard (the grid's
// x blocks are the shards' columns times their tiles, its y blocks the
// rows), each CTA finds its shard and tile from its block index
// (shard_addr.cuh: ShardTile), and one stream orders the launches.  Every
// operand, h, u, v and the statics alike, is one allocation of (L, S, ly,
// lx) in mesh order (Stack), so a neighbour shard's point is a row term
// plus a column term away and Flather, the sponge and the exterior clamp
// see the statics of their global positions.  A mesh over several cards
// (BEOM_CARDS = 1) launches once per card over the card's shards and reads
// a neighbour card's points in its stacks through their pointers, the
// tables' terms card-local and their card class picking the stack
// (shard_addr.cuh); events order the cards' streams.
//
// The layer-streamed step runs K1's bodies (fb_step_body.cuh, namespace
// fbs) over one CTA per tile of every shard, each block's offsets filled
// from the stacked layout (shard_addr.cuh: block_offsets): the continuity
// of every layer into h1, then the momentum, which reads h1 back at its
// block's points, a neighbour shard's too.  Across cards that second
// launch reads a neighbour card's h1 through its nine stacks (Field), and
// the wrapper orders it after the neighbour card's first launch
// (stencils/dist_band.py: MeshKernels.fb, mesh.CardStreams).  No build
// keeps a block's planes in device memory.
//
// Bound: device-memory bytes for the single step, the stages for the
// pass, as K1.  The arithmetic per point is K1's (csrc/fb_step_body.cuh),
// so a shard's result equals the single-device step's on the same points
// bit for bit.

#include "fb_step_body.cuh"

namespace {

using namespace beom;
using namespace beom::fbk;

#if BEOM_KB == 1 && BEOM_STREAM

// The layer-streamed step (fb_step_body.cuh, namespace fbs), as K1's: the
// continuity of every layer into out_h, then the momentum, which reads h1
// back at its block's points; each one launch per card, one CTA per tile
// of every shard
template <typename T>
__global__ void __launch_bounds__(THREADS)
shard_cont_layers_kernel(const BEOM_CLASSED Params<T> p, const Stack m,
                     T* out_h) {
  const ShardTile t = shard_tile(m, TX, TY);
  fbs::cont::run_at<T, true>(p, m, t.gy0, t.gx0, t.out(m, p.plane),
                             out_h + t.base(m));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
shard_mom_layers_kernel(const BEOM_CLASSED Params<T> p, const Stack m,
                    const BEOM_CLASSED Field<T> h1, T* out_u, T* out_v) {
  const ShardTile t = shard_tile(m, TX, TY);
  const int b = t.base(m);
  fbs::mom::run_at<T, true>(p, m, t.gy0, t.gx0, t.out(m, p.plane), h1.f,
                            out_u + b, out_v + b);
}

template <typename K>
cudaError_t allow(K kernel, int smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename T>
int shard_fb_cont(const void* const* ptrs, const int* ints,
                  const double* dbls, const int* geom, void* h1,
                  void* stream) {
  Params<T> p = make_params<T>(ptrs, ints, dbls);
  Stack m;
  if (!make_stack(p, geom, fbs::cont::W, m))
    return int(cudaErrorInvalidValue);
  constexpr int smem = fbs::cont::smem_bytes<T>();
  const cudaError_t e = allow(shard_cont_layers_kernel<T>, smem);
  if (e != cudaSuccess) return int(e);
  shard_cont_layers_kernel<T><<<m.grid(TX, TY), THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      p, m, static_cast<T*>(h1));
  return int(cudaGetLastError());
}

template <typename T>
int shard_fb_mom(const void* const* ptrs, const int* ints,
                 const double* dbls, const int* geom, const void* h1,
                 void* u1, void* v1, void* stream) {
  Params<T> p = make_params<T>(ptrs, ints, dbls);
  Stack m;
  if (!make_stack(p, geom, fbs::mom::W, m))
    return int(cudaErrorInvalidValue);
  constexpr int smem = fbs::mom::smem_bytes<T>();
  const cudaError_t e = allow(shard_mom_layers_kernel<T>, smem);
  if (e != cudaSuccess) return int(e);
  shard_mom_layers_kernel<T><<<m.grid(TX, TY), THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      p, m, field_of<T>(h1), static_cast<T*>(u1), static_cast<T*>(v1));
  return int(cudaGetLastError());
}

// 0: the momentum kernel, 1: the continuity kernel (as fb_step.cu's)
constexpr int kernel_smem(int which, bool f64) {
  if (which == 1)
    return f64 ? fbs::cont::smem_bytes<double>()
               : fbs::cont::smem_bytes<float>();
  return f64 ? fbs::mom::smem_bytes<double>() : fbs::mom::smem_bytes<float>();
}

#elif BEOM_KB == 1

template <typename T>
__global__ void __launch_bounds__(THREADS)
shard_step_kernel(const BEOM_CLASSED Params<T> p,
                  const BEOM_CLASSED StackSrc<T, 3> src_, T* h1, T* u1,
                  T* v1) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  Off* gidx = off_table(sm, N_PLANES * NPT);
  const int tid = threadIdx.x;
  const ShardTile t = shard_tile(src_.m, TX, TY);
  const auto src = src_.from(t);

  // S0: the haloed block, each point from the shard it falls into
  const int x0 = t.x0 - W;
  const int y0 = t.y0 - W;
  for (int s = tid; s < NPT; s += THREADS) {
    const Loc l = src.at(y0 + s / RX, x0 + s % RX);
    gidx[s] = l.stat;
    const T* hn = src.template ptr<0>(l);
    const T* un = src.template ptr<1>(l);
    const T* vn = src.template ptr<2>(l);
    for (int k = 0; k < NZ; ++k) {
      sm[(P_H + k) * NPT + s] = hn[k * src.plane];
      sm[(P_U + k) * NPT + s] = un[k * src.plane];
      sm[(P_V + k) * NPT + s] = vn[k * src.plane];
    }
    sm[P_M * NPT + s] = p.in[I_MASK][l.stat];
    sm[P_MU * NPT + s] = p.in[I_MASK_U][l.stat];
    sm[P_MV * NPT + s] = p.in[I_MASK_V][l.stat];
    sm[P_MQ * NPT + s] = p.in[I_MASK_Q][l.stat];
  }
  __syncthreads();
  if (OBC) {
    load_eta_ext<T, NPT>(p, gidx, sm + P_EE * NPT);
    __syncthreads();
  }

  const int b = t.base(src.m);
  fb_stages<T>(p, sm, gidx,
               Store3<T>{h1 + b, u1 + b, v1 + b, t.out(src.m, p.plane)});
}

template <typename T>
int shard_step(const void* const* ptrs, const int* ints, const double* dbls,
               const int* geom, void* h1, void* u1, void* v1, void* stream) {
  Params<T> p = make_params<T>(ptrs, ints, dbls);
  Stack m;
  if (!make_stack(p, geom, W, m)) return int(cudaErrorInvalidValue);
  constexpr int smem = smem_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(
      shard_step_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return int(e);
  shard_step_kernel<T><<<m.grid(TX, TY), THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      p, make_stack_src<T, 3>(ptrs, m, p.plane, N_PTR), static_cast<T*>(h1),
      static_cast<T*>(u1), static_cast<T*>(v1));
  return int(cudaGetLastError());
}

constexpr int kernel_smem(int, bool f64) {
  return f64 ? smem_bytes<double>() : smem_bytes<float>();
}

#else

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
shard_pass_kernel(const BEOM_CLASSED Params<T> p, const Stack m, T* h1,
                  T* u1, T* v1) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const ShardTile t = shard_tile(m, TX, TY);
  fbp::load_block<T, true>(p, sm, t.gy0 - fbp::HALO, t.gx0 - fbp::HALO, m);
  const int b = t.base(m);
  fbp::pass_steps<T, 0, 0, 1, 2, 3, 4>(
      p, sm, Store3<T>{h1 + b, u1 + b, v1 + b, t.out(m, p.plane)});
}

template <typename T>
int shard_step(const void* const* ptrs, const int* ints, const double* dbls,
               const int* geom, void* h1, void* u1, void* v1, void* stream) {
  Params<T> p = make_params<T>(ptrs, ints, dbls);
  Stack m;
  if (!make_stack(p, geom, fbp::HALO, m)) return int(cudaErrorInvalidValue);
  constexpr int smem = fbp::smem_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(
      shard_pass_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return int(e);
  shard_pass_kernel<T><<<m.grid(TX, TY), THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      p, m, static_cast<T*>(h1), static_cast<T*>(u1), static_cast<T*>(v1));
  return int(cudaGetLastError());
}

constexpr int kernel_smem(int, bool f64) {
  return f64 ? fbp::smem_bytes<double>() : fbp::smem_bytes<float>();
}

#endif

}  // namespace

// ptrs: the host table of fb_terms.cuh (N_PTR pointers), every operand
// stacked (L, S, ly, lx; across cards the nine card classes' tables one
// after another);
// ints[J_NY], ints[J_NX] the grid; geom: ly, lx, my, mx, cy, cx, a, b
// (shard_addr.cuh: make_stack).  One launch: one step (BEOM_KB = 1), or a
// pass of KB steps with step i's time in dbls[D_TS0 + i]; in the
// layer-streamed build two entries, one launch each: the continuity into
// h1, then the momentum, which takes h1 (across cards a host table of its
// nine stacks) back.  The outputs are stacked as h, u, v.

#if BEOM_KB == 1 && BEOM_STREAM

extern "C" int beom_shard_fb_cont_f32(const void* const* ptrs,
                                      const int* ints, const double* dbls,
                                      const int* geom, void* h1,
                                      void* stream) {
  return shard_fb_cont<float>(ptrs, ints, dbls, geom, h1, stream);
}

extern "C" int beom_shard_fb_cont_f64(const void* const* ptrs,
                                      const int* ints, const double* dbls,
                                      const int* geom, void* h1,
                                      void* stream) {
  return shard_fb_cont<double>(ptrs, ints, dbls, geom, h1, stream);
}

extern "C" int beom_shard_fb_mom_f32(const void* const* ptrs,
                                     const int* ints, const double* dbls,
                                     const int* geom, const void* h1,
                                     void* u1, void* v1, void* stream) {
  return shard_fb_mom<float>(ptrs, ints, dbls, geom, h1, u1, v1, stream);
}

extern "C" int beom_shard_fb_mom_f64(const void* const* ptrs,
                                     const int* ints, const double* dbls,
                                     const int* geom, const void* h1,
                                     void* u1, void* v1, void* stream) {
  return shard_fb_mom<double>(ptrs, ints, dbls, geom, h1, u1, v1, stream);
}

#else

extern "C" int beom_shard_step_f32(const void* const* ptrs, const int* ints,
                                   const double* dbls, const int* geom,
                                   void* h1, void* u1, void* v1,
                                   void* stream) {
  return shard_step<float>(ptrs, ints, dbls, geom, h1, u1, v1, stream);
}

extern "C" int beom_shard_step_f64(const void* const* ptrs, const int* ints,
                                   const double* dbls, const int* geom,
                                   void* h1, void* u1, void* v1,
                                   void* stream) {
  return shard_step<double>(ptrs, ints, dbls, geom, h1, u1, v1, stream);
}

#endif

// the halo a launch of KB steps reads around a tile, KB W (the streamed
// step's two launches together: the continuity's LO, then the momentum's
// 3 around that)
extern "C" int beom_shard_halo() { return KB * W; }

// dynamic shared memory of one CTA of kernel `which` (0: the build's step
// or pass kernel, in the layer-streamed build its momentum kernel; 1: that
// build's continuity kernel), for the wrapper's plan
extern "C" int beom_smem_bytes(int which, int is_f64) {
  return kernel_smem(which, is_f64);
}

extern "C" const char* beom_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
