// K7: one free-surface forward-backward step (stepping/fb.py::fb_step) on
// one shard of a device mesh: the shard's local block (nz, ly, lx) of h, u
// and v, whose halo points beyond the block's edge are the neighbour
// shards' edge points, read from the neighbours' blocks through their
// pointers (a shard that is its own neighbour along a mesh axis reads its
// own periodic wrap).
//
// Replaces beom_tpu/stencils/dist_band.py::_dist_band_kernel running the
// fb body of beom_tpu/parallel/dist.py::make_dist_pallas_stepper.
//
// What the TPU kernel does for overlap (sends started in the first grid
// step, edge bands ordered last behind receive semaphores, a barrier
// handshake between launches) becomes two launches per shard and step on
// the shard's stream: the interior tiles, whose haloed blocks lie inside
// the shard's own block and depend on nothing remote, and the edge tiles,
// ordered by CUDA events after the neighbours' previous step
// (stencils/dist_band.py).  No kernel waits on a flag written by another:
// with several shards on one card a spinning CTA could hold the slot the
// kernel it waits for needs.
//
// Bound: device-memory bytes, as K1 (csrc/fb_step.cu); the arithmetic per
// point is K1's (csrc/fb_step_body.cuh), so a shard's result equals the
// single-device step's on the same points bit for bit.  The statics
// (masks, H, f, wind, sponge, boundary maps, tides) are the shard's blocks
// padded once at setup with a halo of W from the neighbours, so Flather,
// the sponge and the exterior clamp see global positions.  The addressing
// (the neighbour loader, the interior / frame split of the tiles) is
// csrc/shard_addr.cuh's, shared with the split and projection kernels
// under a mesh.

#include "fb_step_body.cuh"

namespace {

using namespace beom;
using namespace beom::fbk;

template <typename T>
__global__ void __launch_bounds__(THREADS)
shard_step_kernel(const Params<T> p, const NbrSrc<T, 3, W> src,
                  const TileMap m, T* h1, T* u1, T* v1) {
  extern __shared__ unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  int* gidx = reinterpret_cast<int*>(sm + N_PLANES * NPT);
  const int tid = threadIdx.x;
  int tx, ty;
  m.tile(tx, ty);

  // S0: the haloed block, each point from the block of the neighbour it
  // falls into; the statics from the shard's own padded arrays
  const int x0 = tx * TX - W;
  const int y0 = ty * TY - W;
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

  fb_stages<T>(p, sm, gidx,
               Store3<T>{h1, u1, v1,
                         Out{ty * TY, tx * TX, src.ly, src.lx, src.plane}});
}

// ptrs: the operand table of fb_terms.cuh with the statics padded by W (its
// h, u, v slots are unused); ints[J_NY], ints[J_NX] the padded extent.
// dyn: 27 pointers, h then u then v of the 3 x 3 neighbourhood.  geom:
// ly, lx, part (shard_addr.cuh's TileMap).
template <typename T>
int shard_step(const void* const* ptrs, const int* ints, const double* dbls,
               const void* const* dyn, const int* geom, void* h1, void* u1,
               void* v1, void* stream) {
  const Params<T> p = make_params<T>(ptrs, ints, dbls);
  const int ly = geom[0], lx = geom[1];
  const TileMap m = make_tiles(ly, lx, TX, TY, W, geom[2]);
  if (!shard_geometry_ok(p, ly, lx, W, W, m))
    return int(cudaErrorInvalidValue);
  constexpr int smem = smem_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(
      shard_step_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return int(e);
  shard_step_kernel<T><<<m.grid(), THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      p, make_nbr<T, 3, W>(dyn, ly, lx), m, static_cast<T*>(h1),
      static_cast<T*>(u1), static_cast<T*>(v1));
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int beom_shard_step_f32(const void* const* ptrs, const int* ints,
                                   const double* dbls,
                                   const void* const* dyn, const int* geom,
                                   void* h1, void* u1, void* v1,
                                   void* stream) {
  return shard_step<float>(ptrs, ints, dbls, dyn, geom, h1, u1, v1, stream);
}

extern "C" int beom_shard_step_f64(const void* const* ptrs, const int* ints,
                                   const double* dbls,
                                   const void* const* dyn, const int* geom,
                                   void* h1, void* u1, void* v1,
                                   void* stream) {
  return shard_step<double>(ptrs, ints, dbls, dyn, geom, h1, u1, v1, stream);
}

// the halo of a shard's padded statics, for the wrapper
extern "C" int beom_shard_halo() { return W; }

// dynamic shared memory of one CTA, for the wrapper's choice of tile
extern "C" int beom_smem_bytes(int which, int is_f64) {
  return is_f64 ? smem_bytes<double>() : smem_bytes<float>();
}

extern "C" const char* beom_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
