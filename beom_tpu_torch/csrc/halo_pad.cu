// K8: the halo pad of one shard of a device mesh: its block (L, ly, lx)
// written into (L, ly + 2 w, lx + 2 w) with the w-wide halo taken from the
// eight neighbour shards' blocks, in one launch and with no intermediate
// copies: the function parallel/halo.py::pad2d computes with slices and
// concatenations.
//
// Replaces beom_tpu/parallel/rdma_halo.py::_halo_kernel (rdma_pad2d).
//
// The TPU kernel pushes its edges to the neighbours in two phases (rows,
// then full-height columns of the row-padded block) because a corner has
// to travel two hops over the chip interconnect.  Here every block of the
// mesh is addressable, so the pad is a gather: each output point reads its
// source from the shard's own block or from the neighbour it falls into,
// corners from the diagonal neighbour directly.  Along a mesh axis with
// one shard the neighbour is the shard itself and the halo is its periodic
// wrap.  The neighbours' blocks are complete before the launch: they are
// ordered on the stream (one device) or by stream waits (several).
//
// Bound: device-memory bytes, L (ly lx + (ly + 2 w)(lx + 2 w)) values per
// shard: a copy.  One thread per output value along x, so reads and writes
// of a warp are contiguous; rows of the padded block start w values off
// the block's rows, so the accesses stay one value wide (16-byte accesses
// would need both aligned).

#include <cuda_runtime.h>

namespace {

struct Nbr {
  const void* p[9];   // the 3 x 3 neighbourhood, [dj + 1][di + 1]
};

template <typename V>
__global__ void __launch_bounds__(256)
halo_pad_kernel(const Nbr nbr, V* out, int L, int ly, int lx, int w) {
  const int PX = lx + 2 * w;
  const int PY = ly + 2 * w;
  const int X = blockIdx.x * blockDim.x + threadIdx.x;
  if (X >= PX) return;
  int gx = X - w;
  int di = 1;
  if (gx < 0) {
    gx += lx;
    di = 0;
  } else if (gx >= lx) {
    gx -= lx;
    di = 2;
  }
  // the column's three candidate sources, chosen with constant indices so
  // that the pointers stay in the kernel's parameter space
  const void* s0 = di == 0 ? nbr.p[0] : di == 1 ? nbr.p[1] : nbr.p[2];
  const void* s1 = di == 0 ? nbr.p[3] : di == 1 ? nbr.p[4] : nbr.p[5];
  const void* s2 = di == 0 ? nbr.p[6] : di == 1 ? nbr.p[7] : nbr.p[8];
  const long rows = long(L) * PY;
  for (long r = blockIdx.y; r < rows; r += gridDim.y) {
    const int l = int(r / PY);
    int gy = int(r % PY) - w;
    int dj = 1;
    if (gy < 0) {
      gy += ly;
      dj = 0;
    } else if (gy >= ly) {
      gy -= ly;
      dj = 2;
    }
    const V* src =
        static_cast<const V*>(dj == 0 ? s0 : dj == 1 ? s1 : s2);
    out[r * PX + X] = src[(long(l) * ly + gy) * lx + gx];
  }
}

template <typename V>
int launch(const void* const* nbr9, void* out, int L, int ly, int lx, int w,
           cudaStream_t stream) {
  Nbr nbr;
  for (int i = 0; i < 9; ++i) nbr.p[i] = nbr9[i];
  const long rows = long(L) * (ly + 2 * w);
  const dim3 grid((lx + 2 * w + 255) / 256,
                  unsigned(rows < 32768 ? rows : 32768));
  halo_pad_kernel<V><<<grid, 256, 0, stream>>>(nbr, static_cast<V*>(out), L,
                                               ly, lx, w);
  return int(cudaGetLastError());
}

}  // namespace

// nbr9: the blocks of the 3 x 3 neighbourhood (the shard's own in the
// middle); elem: bytes per value, 4 or 8
extern "C" int beom_halo_pad(const void* const* nbr9, void* out, int L,
                             int ly, int lx, int w, int elem, void* stream) {
  if (w < 1 || w > ly || w > lx || L < 1) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem == 4) return launch<unsigned int>(nbr9, out, L, ly, lx, w, s);
  if (elem == 8)
    return launch<unsigned long long>(nbr9, out, L, ly, lx, w, s);
  return int(cudaErrorInvalidValue);
}

extern "C" const char* beom_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
