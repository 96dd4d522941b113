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
// the sponge and the exterior clamp see global positions.

#include "fb_step_body.cuh"

namespace {

using namespace beom;
using namespace beom::fbk;

template <typename T>
struct ShardArgs {
  const T* dyn[3][9];   // h, u, v of the 3 x 3 neighbourhood, [dj+1][di+1]
  T* out[3];
  int ly, lx;           // the local block
  int nbx, nby;         // tiles over the block
  int bx0, bx1, by0, by1;   // the interior tiles: [bx0, bx1) x [by0, by1)
  int edge;             // 0: the interior tiles; 1: all the others
};

// entry [dj][di] of a field's 3 x 3 neighbourhood, chosen with constant
// indices so that the pointers stay in the kernel's parameter space
template <typename T>
__device__ __forceinline__ const T* neighbour(const T* const (&p)[9], int dj,
                                              int di) {
  const T* r0 = di == 0 ? p[0] : di == 1 ? p[1] : p[2];
  const T* r1 = di == 0 ? p[3] : di == 1 ? p[4] : p[5];
  const T* r2 = di == 0 ? p[6] : di == 1 ? p[7] : p[8];
  return dj == 0 ? r0 : dj == 1 ? r1 : r2;
}

// the interior points inside the block, written at their local offset
template <typename T>
struct BlockStore {
  T *h, *u, *v;
  int ty, tx, ly, lx;
  __device__ __forceinline__ bool valid(int jj, int ii) const {
    return ty * TY + jj < ly && tx * TX + ii < lx;
  }
  __device__ __forceinline__ void put(int jj, int ii, int k, T hv, T uv,
                                      T vv) const {
    const long g = (long(k) * ly + ty * TY + jj) * lx + tx * TX + ii;
    h[g] = hv;
    u[g] = uv;
    v[g] = vv;
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
shard_step_kernel(const Params<T> p, const ShardArgs<T> a) {
  extern __shared__ unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  int* gidx = reinterpret_cast<int*>(sm + N_PLANES * NPT);
  const int tid = threadIdx.x;

  // which tile: the interior rectangle, or the frame of tiles around it in
  // row-major order
  int tx, ty;
  if (!a.edge) {
    tx = a.bx0 + blockIdx.x;
    ty = a.by0 + blockIdx.y;
  } else {
    int id = blockIdx.x;
    const int low = a.by0 * a.nbx;
    const int mid_w = a.bx0 + (a.nbx - a.bx1);
    const int mid = (a.by1 - a.by0) * mid_w;
    if (id < low) {
      ty = id / a.nbx;
      tx = id % a.nbx;
    } else if (id < low + mid) {
      id -= low;
      ty = a.by0 + id / mid_w;
      const int c = id % mid_w;
      tx = c < a.bx0 ? c : a.bx1 + (c - a.bx0);
    } else {
      id -= low + mid;
      ty = a.by1 + id / a.nbx;
      tx = id % a.nbx;
    }
  }

  // S0: the haloed block.  A point at local (y, x) with y in [-W, ly + W)
  // comes from the block of the neighbour it falls into; the statics from
  // the shard's own padded arrays, p.nx = lx + 2 W wide.  Points past the
  // block's halo (ragged last tiles) are clamped: they feed no result.
  const int x0 = tx * TX - W;
  const int y0 = ty * TY - W;
  const long lplane = long(a.ly) * a.lx;
  for (int s = tid; s < NPT; s += THREADS) {
    int y = y0 + s / RX;
    int x = x0 + s % RX;
    y = y < a.ly + W ? y : a.ly + W - 1;
    x = x < a.lx + W ? x : a.lx + W - 1;
    const int g = (y + W) * p.nx + (x + W);
    gidx[s] = g;
    int dj = 1, di = 1;
    if (y < 0) {
      dj = 0;
      y += a.ly;
    } else if (y >= a.ly) {
      dj = 2;
      y -= a.ly;
    }
    if (x < 0) {
      di = 0;
      x += a.lx;
    } else if (x >= a.lx) {
      di = 2;
      x -= a.lx;
    }
    const long off = long(y) * a.lx + x;
    const T* hn = neighbour<T>(a.dyn[0], dj, di);
    const T* un = neighbour<T>(a.dyn[1], dj, di);
    const T* vn = neighbour<T>(a.dyn[2], dj, di);
    for (int k = 0; k < NZ; ++k) {
      sm[(P_H + k) * NPT + s] = hn[k * lplane + off];
      sm[(P_U + k) * NPT + s] = un[k * lplane + off];
      sm[(P_V + k) * NPT + s] = vn[k * lplane + off];
    }
    sm[P_M * NPT + s] = p.in[I_MASK][g];
    sm[P_MU * NPT + s] = p.in[I_MASK_U][g];
    sm[P_MV * NPT + s] = p.in[I_MASK_V][g];
    sm[P_MQ * NPT + s] = p.in[I_MASK_Q][g];
  }
  __syncthreads();
  if (OBC) {
    load_eta_ext<T, NPT>(p, gidx, sm + P_EE * NPT);
    __syncthreads();
  }

  fb_stages<T>(p, sm, gidx,
               BlockStore<T>{a.out[0], a.out[1], a.out[2], ty, tx, a.ly,
                             a.lx});
}

// ptrs: the operand table of fb_terms.cuh with the statics padded by W (its
// h, u, v slots are unused); ints[J_NY], ints[J_NX] the padded extent.
// dyn: 27 pointers, h then u then v of the 3 x 3 neighbourhood.  geom:
// ly, lx, edge.
template <typename T>
int shard_step(const void* const* ptrs, const int* ints, const double* dbls,
               const void* const* dyn, const int* geom, void* h1, void* u1,
               void* v1, void* stream) {
  const Params<T> p = make_params<T>(ptrs, ints, dbls);
  ShardArgs<T> a;
  for (int f = 0; f < 3; ++f)
    for (int n = 0; n < 9; ++n)
      a.dyn[f][n] = static_cast<const T*>(dyn[f * 9 + n]);
  a.out[0] = static_cast<T*>(h1);
  a.out[1] = static_cast<T*>(u1);
  a.out[2] = static_cast<T*>(v1);
  a.ly = geom[0];
  a.lx = geom[1];
  a.edge = geom[2];
  if (p.ny != a.ly + 2 * W || p.nx != a.lx + 2 * W || a.ly < W || a.lx < W)
    return int(cudaErrorInvalidValue);
  a.nbx = (a.lx + TX - 1) / TX;
  a.nby = (a.ly + TY - 1) / TY;
  // tile t is interior iff t * T - W >= 0 and (t + 1) * T + W <= l
  a.bx0 = (W + TX - 1) / TX;
  a.bx1 = (a.lx - W) / TX;
  a.by0 = (W + TY - 1) / TY;
  a.by1 = (a.ly - W) / TY;
  if (a.bx1 <= a.bx0 || a.by1 <= a.by0) a.bx0 = a.bx1 = a.by0 = a.by1 = 0;
  const int n_in = (a.bx1 - a.bx0) * (a.by1 - a.by0);
  const int n_edge = a.nbx * a.nby - n_in;
  const dim3 grid = a.edge ? dim3(n_edge) : dim3(a.bx1 - a.bx0,
                                                 a.by1 - a.by0);
  if (grid.x == 0 || grid.y == 0) return int(cudaErrorInvalidValue);
  constexpr int smem = smem_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(
      shard_step_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return int(e);
  shard_step_kernel<T><<<grid, THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(p, a);
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

// the halo of a shard's padded statics and the tile, for the wrapper
extern "C" int beom_shard_halo() { return W; }
extern "C" int beom_tile_x() { return TX; }
extern "C" int beom_tile_y() { return TY; }

// dynamic shared memory of one CTA, for the wrapper's choice of tile
extern "C" int beom_smem_bytes(int which, int is_f64) {
  return is_f64 ? smem_bytes<double>() : smem_bytes<float>();
}

extern "C" const char* beom_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
