// K8: the halo pad of the shards of a device mesh that lie on one card,
// in one launch: each shard's block (L, ly, lx) written into (L, ly + 2 w,
// lx + 2 w) with the w-wide halo taken from the eight neighbour shards'
// blocks, the padded blocks one allocation of (S, L, ly + 2 w, lx + 2 w) in
// the mesh order of the card's shards: the function parallel/halo.py::pad2d
// computes with slices and concatenations.  A mesh over several cards
// gives each card a rectangle of cmy x cmx shards, its first at mesh row
// cj0 and column ci0, and one launch per card; a neighbour shard on another
// card is read through its pointer (peer access).  One card: cmy x cmx is
// the mesh.
//
// Replaces beom_tpu/parallel/rdma_halo.py::_halo_kernel (rdma_pad2d).
//
// The TPU kernel pushes its edges to the neighbours in two phases (rows,
// then full-height columns of the row-padded block) because a corner has
// to travel two hops over the chip interconnect.  Here every block of the
// mesh is in the card's memory, so the pad is a gather: each output point
// reads its source from the shard's own block or from the neighbour it
// falls into, corners from the diagonal neighbour directly.  Along a mesh
// axis with one shard the neighbour is the shard itself and the halo is its
// periodic wrap.  The blocks are complete before the launch: one stream
// orders them on one card, events across cards.
//
// Bound: device-memory bytes, S L (ly lx + (ly + 2 w)(lx + 2 w)) values: a
// copy.  One launch for every shard of the card keeps the whole copy in
// flight (a launch per shard left the card idle between eight small
// grids): its z blocks are the card's shards, a CTA takes 256 columns of
// RB rows of a shard's padded block, so a warp's reads and writes are
// contiguous and each thread has RB loads in flight before its stores.
// The rows of the padded block start w values off the block's rows, so the
// accesses stay one value wide (16-byte accesses would need both
// aligned).  The blocks are
// addressed through a table of their pointers in the kernel's parameters,
// so they need not share an allocation; a CTA looks up its shard's 3 x 3
// neighbourhood once, with constant indices into the table, into shared
// memory.  A mesh of more shards than the parameters hold passes the table
// in device memory instead.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_SHARDS = 64;

struct Blocks {
  const void* p[MAX_SHARDS];   // shard s = j mx + i in mesh order
};

constexpr int RB = 8;         // rows per CTA

template <typename V>
__global__ void __launch_bounds__(256)
halo_pad_kernel(const Blocks blk, const void* const* table,
                V* __restrict__ out, int L, int ly, int lx, int w, int my,
                int mx, int cmx, int cj0, int ci0) {
  __shared__ const V* nb[9];    // the shard's 3 x 3 neighbourhood
  const int q = blockIdx.z;     // the shard among the card's
  const int j = cj0 + q / cmx;
  const int i = ci0 + q % cmx;
  if (threadIdx.x < 9) {
    int J = j + int(threadIdx.x) / 3 - 1;
    int I = i + int(threadIdx.x) % 3 - 1;
    J = J < 0 ? my - 1 : J == my ? 0 : J;
    I = I < 0 ? mx - 1 : I == mx ? 0 : I;
    const int want = J * mx + I;
    const void* p = nullptr;
    if (table) {
      p = table[want];
    } else {
#pragma unroll
      for (int k = 0; k < MAX_SHARDS; ++k)
        if (k == want) p = blk.p[k];
    }
    nb[threadIdx.x] = static_cast<const V*>(p);
  }
  __syncthreads();
  const int PX = lx + 2 * w;
  const int PY = ly + 2 * w;
  const int X = blockIdx.x * blockDim.x + threadIdx.x;
  if (X >= PX) return;
  // the column's source: the neighbour column di and the column in it
  int gx = X - w;
  int di = 1;
  if (gx < 0) {
    gx += lx;
    di = 0;
  } else if (gx >= lx) {
    gx -= lx;
    di = 2;
  }
  const V* const src[3] = {nb[di], nb[3 + di], nb[6 + di]};
  const int rows = L * PY;
  V* dst = out + long(q) * rows * PX + X;
  for (int r0 = blockIdx.y * RB; r0 < rows; r0 += gridDim.y * RB) {
    V v[RB];
#pragma unroll
    for (int q = 0; q < RB; ++q) {
      const int r = r0 + q;
      if (r >= rows) break;
      const int l = r / PY;
      int gy = r - l * PY - w;
      int dj = 1;
      if (gy < 0) {
        gy += ly;
        dj = 0;
      } else if (gy >= ly) {
        gy -= ly;
        dj = 2;
      }
      v[q] = src[dj][(long(l) * ly + gy) * lx + gx];
    }
#pragma unroll
    for (int q = 0; q < RB; ++q)
      if (r0 + q < rows) dst[long(r0 + q) * PX] = v[q];
  }
}

template <typename V>
int launch(const void* const* blocks, const void* const* table, void* out,
           int L, int ly, int lx, int w, int my, int mx, const int* card,
           cudaStream_t stream) {
  Blocks b{};
  if (!table)
    for (int s = 0; s < my * mx; ++s) b.p[s] = blocks[s];
  const long bands = (long(L) * (ly + 2 * w) + RB - 1) / RB;
  const dim3 grid((lx + 2 * w + 255) / 256,
                  unsigned(bands < 65535 ? bands : 65535),
                  card[0] * card[1]);
  halo_pad_kernel<V><<<grid, 256, 0, stream>>>(
      b, table, static_cast<V*>(out), L, ly, lx, w, my, mx, card[1], card[2],
      card[3]);
  return int(cudaGetLastError());
}

}  // namespace

// blocks: the my x mx shards' blocks in mesh order (every card's), a host
// array of at most MAX_SHARDS pointers, or null and table the same
// pointers in device memory; card: cmy, cmx, cj0, ci0, the card's
// rectangle of shards; out: (cmy cmx, L, ly + 2 w, lx + 2 w); elem: bytes
// per value, 4 or 8
extern "C" int beom_halo_pad(const void* const* blocks,
                             const void* const* table, void* out, int L,
                             int ly, int lx, int w, int my, int mx,
                             const int* card, int elem, void* stream) {
  if (w < 1 || w > ly || w > lx || L < 1 || my < 1 || mx < 1 ||
      (!table && (!blocks || my * mx > MAX_SHARDS)) || card[0] < 1 ||
      card[1] < 1 || card[2] < 0 || card[3] < 0 || card[2] + card[0] > my ||
      card[3] + card[1] > mx)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem == 4)
    return launch<unsigned int>(blocks, table, out, L, ly, lx, w, my, mx,
                                card, s);
  if (elem == 8)
    return launch<unsigned long long>(blocks, table, out, L, ly, lx, w, my,
                                      mx, card, s);
  return int(cudaErrorInvalidValue);
}

// the most shards whose pointers the launch's parameters hold, for the
// wrapper
extern "C" int beom_max_shards() { return MAX_SHARDS; }

extern "C" const char* beom_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
