// Where a tile's haloed points come from, for the kernels that run one
// stage body on the whole grid of one device and on the shards of a device
// mesh: the fb step (fb_step.cu, shard_step.cu), the split step's three
// kernels (split_step.cu, shard_split.cu) and the projection phases
// (projection.cu, shard_projection.cu).
//
// A stage body asks a source `src` for the location of the point (y, x) of
// its haloed block (`src.at(y, x)`), reads the statics (masks, H, f, wind,
// sponge, boundary maps, tides: the operand table of fb_terms.cuh) at the
// location's `stat` offset, and reads the step's dynamic fields with
// `src.get<I>(k, loc)` (layer k of field I), or, for several layers, from
// `src.ptr<I>(loc)`, the point's layer 0, chosen once per point.  Interior
// points are written through an `Out` at their offset in the output's
// layout, and fields that are read only at the point itself come from
// `src.own<I>()` at that offset.
//
//   GridSrc  one device: the whole grid, periodic on both axes; statics and
//            fields share one layout.
//   NbrSrc   one shard of a mesh: the local block (ly, lx) of each field,
//            and the blocks of its 3 x 3 neighbourhood through their
//            pointers.  A point beyond the block's edge is read from the
//            neighbour block it falls into (a shard that is its own
//            neighbour along a mesh axis reads its own periodic wrap); the
//            statics are the shard's blocks padded once with PAD points of
//            the neighbours', so the boundary maps, the sponge and the tides
//            keep their global positions.
//
// TileMap splits a shard's tiles into the interior ones, whose haloed block
// lies inside the shard's own block and needs nothing remote, and the frame
// of tiles around them, which reads the neighbours (the launcher orders it
// after their previous kernel by events).

#pragma once

#include "fb_terms.cuh"

namespace beom {

// the location of one point of a haloed block: its offset into the statics,
// and the neighbour block (dj, di in 0..2, 1 is the shard itself) and offset
// in it that hold its dynamic fields
struct Loc {
  int stat;
  int dj, di;
  long off;
};

template <typename T, int NF>
struct GridSrc {
  const T* f[NF];
  int ny, nx;
  long plane;
  // the offset in 64 bits, as the single-device kernels had it before they
  // shared this source: with a 32-bit product ptxas schedules K1s's
  // subcycle 2 % slower (tools/kernel_times.py on an H100)
  __device__ __forceinline__ Loc at(int y, int x) const {
    const long g = long(wrap(y, ny)) * nx + wrap(x, nx);
    return Loc{int(g), 1, 1, g};
  }
  // the location of a point whose statics offset is known
  __device__ __forceinline__ Loc at(int stat, int, int) const {
    return Loc{stat, 1, 1, stat};
  }
  template <int I>
  __device__ __forceinline__ const T* ptr(const Loc& l) const {
    return f[I] + l.off;
  }
  template <int I>
  __device__ __forceinline__ T get(int k, const Loc& l) const {
    return f[I][k * plane + l.off];
  }
  template <int I>
  __device__ __forceinline__ const T* own() const {
    return f[I];
  }
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

// PAD, the statics' halo, is the kernel's compile-time constant
template <typename T, int NF, int PAD>
struct NbrSrc {
  const T* f[NF][9];    // per field, the 3 x 3 neighbourhood, [dj][di]
  int ly, lx;           // the local block
  long plane;           // ly * lx
  // A point at local (y, x), y in [-PAD, ly + PAD): points past the
  // statics' halo (ragged last tiles, beyond every kernel's own halo) are
  // clamped; they feed no result.
  __device__ __forceinline__ Loc at(int y, int x) const {
    y = y < ly + PAD ? y : ly + PAD - 1;
    x = x < lx + PAD ? x : lx + PAD - 1;
    const int stat = (y + PAD) * (lx + 2 * PAD) + (x + PAD);
    int dj = 1, di = 1;
    if (y < 0) {
      dj = 0;
      y += ly;
    } else if (y >= ly) {
      dj = 2;
      y -= ly;
    }
    if (x < 0) {
      di = 0;
      x += lx;
    } else if (x >= lx) {
      di = 2;
      x -= lx;
    }
    return Loc{stat, dj, di, long(y) * lx + x};
  }
  __device__ __forceinline__ Loc at(int, int y, int x) const {
    return at(y, x);
  }
  // layer 0 of field I at the point: the neighbour block is chosen once,
  // and layer k is ptr[k * plane]
  template <int I>
  __device__ __forceinline__ const T* ptr(const Loc& l) const {
    return neighbour<T>(f[I], l.dj, l.di) + l.off;
  }
  template <int I>
  __device__ __forceinline__ T get(int k, const Loc& l) const {
    return ptr<I>(l)[k * plane];
  }
  template <int I>
  __device__ __forceinline__ const T* own() const {
    return f[I][4];
  }
};

// Where a tile's interior points go: rows y0.., columns x0.. of an
// (ny, nx) layout with layers plane apart; points outside it are not
// written (ragged last tiles).
struct Out {
  int y0, x0, ny, nx;
  long plane;
  __device__ __forceinline__ bool valid(int jj, int ii) const {
    return y0 + jj < ny && x0 + ii < nx;
  }
  __device__ __forceinline__ long at(int jj, int ii) const {
    return long(y0 + jj) * nx + x0 + ii;
  }
};

// The tiles of a shard's block for one launch: part 0 the interior
// rectangle [bx0, bx1) x [by0, by1), part 1 the frame of tiles around it in
// row-major order (every tile when the rectangle is empty), part 2 every
// tile.
struct TileMap {
  int nbx, nby, bx0, bx1, by0, by1, part;

  __device__ __forceinline__ void tile(int& tx, int& ty) const {
    if (part == 0) {
      tx = bx0 + blockIdx.x;
      ty = by0 + blockIdx.y;
      return;
    }
    int id = blockIdx.x;
    const int low = by0 * nbx;
    const int mid_w = bx0 + (nbx - bx1);
    const int mid = (by1 - by0) * mid_w;
    if (id < low) {
      ty = id / nbx;
      tx = id % nbx;
    } else if (id < low + mid) {
      id -= low;
      ty = by0 + id / mid_w;
      const int c = id % mid_w;
      tx = c < bx0 ? c : bx1 + (c - bx0);
    } else {
      id -= low + mid;
      ty = by1 + id / nbx;
      tx = id % nbx;
    }
  }

  // the launch grid; 0 blocks when the part is empty
  __host__ dim3 grid() const {
    if (part == 0) return dim3(bx1 - bx0, by1 - by0);
    return dim3(nbx * nby - (bx1 - bx0) * (by1 - by0));
  }
};

// tile t of T points is interior iff t T - w >= 0 and (t + 1) T + w <= l
__host__ inline TileMap make_tiles(int ly, int lx, int tx, int ty, int w,
                                   int part) {
  TileMap m;
  m.nbx = (lx + tx - 1) / tx;
  m.nby = (ly + ty - 1) / ty;
  m.bx0 = (w + tx - 1) / tx;
  m.bx1 = (lx - w) / tx;
  m.by0 = (w + ty - 1) / ty;
  m.by1 = (ly - w) / ty;
  if (m.bx1 <= m.bx0 || m.by1 <= m.by0 || part == 2)
    m.bx0 = m.bx1 = m.by0 = m.by1 = 0;
  m.part = part;
  return m;
}

// Checks of a shard launch's geometry: the statics padded by pad around
// the (ly, lx) block, a block that holds the kernel's halo w, a known part
// and a launch with blocks in it.
template <typename T>
__host__ inline bool shard_geometry_ok(const Params<T>& p, int ly, int lx,
                                       int pad, int w, const TileMap& m) {
  const dim3 g = m.grid();
  return p.ny == ly + 2 * pad && p.nx == lx + 2 * pad && ly >= pad &&
         lx >= pad && pad >= w && m.part >= 0 && m.part <= 2 && g.x > 0 &&
         g.y > 0;
}

// an NbrSrc of the block (ly, lx) from nf x 9 pointers, field-major
template <typename T, int NF, int PAD>
__host__ inline NbrSrc<T, NF, PAD> make_nbr(const void* const* dyn, int ly,
                                            int lx) {
  NbrSrc<T, NF, PAD> s;
  for (int f = 0; f < NF; ++f)
    for (int n = 0; n < 9; ++n)
      s.f[f][n] = static_cast<const T*>(dyn[f * 9 + n]);
  s.ly = ly;
  s.lx = lx;
  s.plane = long(ly) * lx;
  return s;
}

}  // namespace beom
