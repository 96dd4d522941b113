// Where a tile's haloed points come from, for the kernels that run one
// stage body on the whole grid of one device and on the shards of a device
// mesh: the fb step (fb_step.cu, shard_step.cu), the split step's kernels
// (split_step.cu, shard_split.cu) and the projection phases
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
// `src.own<I>()` at that offset.  The layer-streamed bodies read a field at
// their block's offsets (block_offsets) from `src.base<I>()`, its whole
// stack (across cards its nine).
//
//   GridSrc   one device: the whole grid, periodic on both axes; statics
//             and fields share one layout.
//   StackSrc  the shards of a mesh that lie on one card, in one launch:
//             every field, the statics too, is one allocation of (L, S,
//             ly, lx), layer k of shard s = j mx + i the block s of the
//             card's plane k (Stack), and statics and fields share one
//             layout.  A CTA's tile lies in one shard (ShardTile), and a
//             point past the shard's edge is read from the neighbour shard
//             it falls into (the shard itself along a mesh axis of one
//             shard): the periodic grid, as on one device.
//
// The staged bodies (the fb pass, the split tail, the staged projection
// phases) read through a block's row and column offsets instead.  In the
// stacked layout a point's offset in a plane is still a row term plus a
// column term, (J mx + I) ly lx + y lx + x for the point (y, x) of shard
// (J, I): Stack::row and Stack::col fill the same tables.
//
// A mesh over several cards (a build with BEOM_CARDS = 1) gives each card a
// rectangle of my x mx shards, all of one shape, the cards a grid of cy x
// cx; the card (a, b) holds the shards (a my + j, b mx + i) in its own
// stack (L, my mx, ly, lx), launches over them alone, and reads a point of
// a neighbour card's shard in that card's stack through its pointer (peer
// access).  Offsets stay card-local, 32-bit products: Stack::row gives the
// row term in the card that holds the row and its card class along y, col
// the same along x, and their sum carries the class of the point
// (fb_terms.cuh: Off), which picks one of an operand's nine bases (Bases:
// the card's own stack and its eight neighbours', wrapping periodically; a
// mesh axis of one card points at the card itself).  One card is the build
// without the switch, whose offsets are ints and operands single pointers.

#pragma once

#include "fb_terms.cuh"

namespace beom {

// the location of one point of a haloed block: its offset into the statics
// and into the dynamic fields
#if BEOM_CARDS
struct Loc {
  Off stat;
  Off off;
};
#else
struct Loc {
  int stat;
  long off;
};
#endif

#if !BEOM_CARDS
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
    return Loc{int(g), g};
  }
  // the location of a point whose statics offset is known
  __device__ __forceinline__ Loc at(int stat, int, int) const {
    return Loc{stat, stat};
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
  template <int I>
  __device__ __forceinline__ const T* base() const {
    return f[I];
  }
};
#endif

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

// The stacked layout of a card's fields: shard (j, i) of the card holds
// the block of rows [j ly, (j + 1) ly) and columns [i lx, (i + 1) lx) of
// the card's part of the grid, and each plane of a field holds the card's
// shards' blocks one after another in mesh order.  On one card the card's
// part is the grid.
struct Stack {
  int ly, lx, my, mx;   // the card's shards: my x mx blocks of ly x lx
  int plane;            // ly * lx: a shard's block of one plane
#if BEOM_CARDS
  int cy, cx;           // the cards on each axis
  int a, b;             // this card's place among them
  // the card class of the card c, d cards along an axis of n from this one
  __device__ __forceinline__ static int cls(int d, int n) {
    return d == 0 ? 0 : (d == 1 || d == 1 - n) ? 1 : 2;
  }
  // the row and column terms of the offset of grid row gy in [0, ny) and
  // column gx in [0, nx), in the card that holds them, with their classes
  __device__ __forceinline__ Off row(int gy) const {
    const int J = gy / ly;
    const int C = J / my;
    return Off((long long)(3 * cls(C - a, cy)) << CLASS_SHIFT |
               ((J - C * my) * mx * plane + (gy - J * ly) * lx));
  }
  __device__ __forceinline__ Off col(int gx) const {
    const int I = gx / lx;
    const int C = I / mx;
    return Off((long long)cls(C - b, cx) << CLASS_SHIFT |
               ((I - C * mx) * plane + (gx - I * lx)));
  }
  // the card's first shard row and column in the mesh
  __device__ __forceinline__ int j0() const { return a * my; }
  __device__ __forceinline__ int i0() const { return b * mx; }
#else
  __device__ __forceinline__ int row(int gy) const {
    const int J = gy / ly;
    return J * mx * plane + (gy - J * ly) * lx;
  }
  __device__ __forceinline__ int col(int gx) const {
    const int I = gx / lx;
    return I * plane + (gx - I * lx);
  }
  __device__ __forceinline__ int j0() const { return 0; }
  __device__ __forceinline__ int i0() const { return 0; }
#endif
  // tiles of TX x TY points per shard, on each axis
  __host__ __device__ int tiles_x(int tx) const { return (lx + tx - 1) / tx; }
  __host__ __device__ int tiles_y(int ty) const { return (ly + ty - 1) / ty; }
  // the launch grid: the tiles of a shard times the card's shards, on each
  // axis
  __host__ __device__ dim3 grid(int tx, int ty) const {
    return dim3(mx * tiles_x(tx), my * tiles_y(ty));
  }
};

// The offsets of the RX x RY block whose first point is the grid's (y0,
// x0), one per point, periodic on both axes: of the whole grid, or with
// SH of the stacked layout (Stack::row + Stack::col, the staged bodies'
// row and column terms summed).  Every layer-streamed body fills it once
// per tile, on one device and on the shards.
template <typename T, int RX, int RY, bool SH>
__device__ __forceinline__ void block_offsets(const Params<T>& p,
                                              const Stack& m, Off* gidx,
                                              int y0, int x0) {
  for (int s = threadIdx.x; s < RX * RY; s += THREADS) {
    const int y = wrap(y0 + s / RX, p.ny);
    const int x = wrap(x0 + s % RX, p.nx);
    if constexpr (SH)
      gidx[s] = m.row(y) + m.col(x);
    else
      gidx[s] = Off(y * p.nx + x);
  }
}
// ... of tile (bx, by) of the whole grid, with a halo of W
template <typename T, int RX, int RY, int W>
__device__ __forceinline__ void load_offsets(const Params<T>& p, Off* gidx,
                                             int bx, int by) {
  block_offsets<T, RX, RY, false>(p, Stack{}, gidx, by * TY - W,
                                  bx * TX - W);
}

// The tile of block (bx, by) of a launch over every shard of a card: it is
// tile (bx mod nbx, by mod nby) of the card's shard (by / nby,
// bx / nbx).
struct ShardTile {
  int j, i;             // the shard's coordinates in the card
  int y0, x0;           // the tile's first point in the shard's block
  int gy0, gx0;         // ... and in the grid
  // the offset of the shard's block in a plane of the card's stack
  __device__ __forceinline__ int base(const Stack& m) const {
    return (j * m.mx + i) * m.plane;
  }
  // the tile's interior points in the shard's block, planes `plane` apart
  // (the card's my mx ly lx), from base(m)
  __device__ __forceinline__ Out out(const Stack& m, long plane) const {
    return Out{y0, x0, m.ly, m.lx, plane};
  }
};

__device__ __forceinline__ ShardTile shard_tile(const Stack& m, int tx,
                                                int ty, int bx, int by) {
  const int nbx = m.tiles_x(tx);
  const int nby = m.tiles_y(ty);
  ShardTile t;
  t.i = bx / nbx;
  t.j = by / nby;
  t.x0 = (bx - t.i * nbx) * tx;
  t.y0 = (by - t.j * nby) * ty;
  t.gy0 = (m.j0() + t.j) * m.ly + t.y0;
  t.gx0 = (m.i0() + t.i) * m.lx + t.x0;
  return t;
}
// ... of the CTA's own block (bx, by) of the launch grid
__device__ __forceinline__ ShardTile shard_tile(const Stack& m, int tx,
                                                int ty) {
  return shard_tile(m, tx, ty, int(blockIdx.x), int(blockIdx.y));
}

// The stacked fields seen from the CTA's shard (j, i): a point at local
// (y, x) lies in the shard of the 3 x 3 neighbourhood it falls into.
// Points past the neighbour's block (ragged last tiles of blocks narrower
// than a tile and its halo) are clamped to its edge: they feed no result.
// Statics and fields share the offset, as in GridSrc.  Across cards the
// fields are Bases, and a CTA keeps its shard beside a pointer to the
// launch's source (StackSrc::View), which stays in the kernel's parameters.
template <typename T, int NF>
struct StackSrc {
  Bases<T> f[NF];
  Stack m;
  long plane;           // the card's my mx ly lx: the layer stride
  int j, i;             // the CTA's shard
#if BEOM_CARDS
  // the point (y, x) of the card's shard (j, i)
  __device__ __forceinline__ Loc at(int j, int i, int y, int x) const {
    const int GY = m.cy * m.my;
    const int GX = m.cx * m.mx;
    int J = m.j0() + j, I = m.i0() + i;
    if (y < 0) {
      J = J == 0 ? GY - 1 : J - 1;
      y += m.ly;
    } else if (y >= m.ly) {
      J = J == GY - 1 ? 0 : J + 1;
      y -= m.ly;
    }
    if (x < 0) {
      I = I == 0 ? GX - 1 : I - 1;
      x += m.lx;
    } else if (x >= m.lx) {
      I = I == GX - 1 ? 0 : I + 1;
      x -= m.lx;
    }
    y = y < 0 ? 0 : y < m.ly ? y : m.ly - 1;
    x = x < 0 ? 0 : x < m.lx ? x : m.lx - 1;
    const Off o = m.row(J * m.ly + y) + m.col(I * m.lx + x);
    return Loc{o, o};
  }
  struct View {
    const StackSrc* s;
    int j, i;
    Stack m;
    long plane;
    __device__ __forceinline__ Loc at(int y, int x) const {
      return s->at(j, i, y, x);
    }
    __device__ __forceinline__ Loc at(Off, int y, int x) const {
      return at(y, x);
    }
    template <int I>
    __device__ __forceinline__ const T* ptr(const Loc& l) const {
      return s->f[I] + l.off;
    }
    template <int I>
    __device__ __forceinline__ T get(int k, const Loc& l) const {
      return s->f[I][k * plane + l.off];
    }
    template <int I>
    __device__ __forceinline__ const T* own() const {
      return own_base(s->f[I]) + (j * m.mx + i) * m.plane;
    }
    template <int I>
    __device__ __forceinline__ BasesArg<T> base() const {
      return s->f[I];
    }
  };
  // this source seen from the CTA's shard; `this` must stay in the
  // kernel's parameters (__grid_constant__)
  __device__ __forceinline__ View from(const ShardTile& t) const {
    return View{this, t.j, t.i, m, plane};
  }
#else
  __device__ __forceinline__ Loc at(int y, int x) const {
    int J = j, I = i;
    if (y < 0) {
      J = j == 0 ? m.my - 1 : j - 1;
      y += m.ly;
    } else if (y >= m.ly) {
      J = j == m.my - 1 ? 0 : j + 1;
      y -= m.ly;
    }
    if (x < 0) {
      I = i == 0 ? m.mx - 1 : i - 1;
      x += m.lx;
    } else if (x >= m.lx) {
      I = i == m.mx - 1 ? 0 : i + 1;
      x -= m.lx;
    }
    y = y < 0 ? 0 : y < m.ly ? y : m.ly - 1;
    x = x < 0 ? 0 : x < m.lx ? x : m.lx - 1;
    const int g = (J * m.mx + I) * m.plane + y * m.lx + x;
    return Loc{g, g};
  }
  __device__ __forceinline__ Loc at(int, int y, int x) const {
    return at(y, x);
  }
  template <int I>
  __device__ __forceinline__ const T* ptr(const Loc& l) const {
    return f[I] + l.off;
  }
  template <int I>
  __device__ __forceinline__ T get(int k, const Loc& l) const {
    return f[I][k * plane + l.off];
  }
  // the field at the CTA's shard's block, read at Out offsets
  template <int I>
  __device__ __forceinline__ const T* own() const {
    return f[I] + (j * m.mx + i) * m.plane;
  }
  // the field's stack, read at offsets of the stacked layout (Stack::row
  // + Stack::col)
  template <int I>
  __device__ __forceinline__ BasesArg<T> base() const {
    return f[I];
  }
  // this source seen from the CTA's shard
  __device__ __forceinline__ StackSrc from(const ShardTile& t) const {
    StackSrc s = *this;
    s.j = t.j;
    s.i = t.i;
    return s;
  }
#endif
};

// The kernels' parameters that a CTA indexes by a point's card class: a
// __grid_constant__ parameter across cards, so that they are read in
// place, not copied per thread
#if BEOM_CARDS
#define BEOM_CLASSED __grid_constant__
#else
#define BEOM_CLASSED
#endif

// the card classes a host table of pointers holds: nine across cards
constexpr int NCLS = BEOM_CARDS ? 9 : 1;

// NF operands from a host table of pointers: f[c * stride + k] the stack
// of operand k in the card of class c (c = 0 alone on one card)
template <typename T, int NF>
__host__ inline void set_bases(Bases<T> (&out)[NF], const void* const* f,
                               int stride = NF) {
  for (int k = 0; k < NF; ++k) {
#if BEOM_CARDS
    for (int c = 0; c < 9; ++c)
      out[k].b[c] = static_cast<const T*>(f[c * stride + k]);
#else
    out[k] = static_cast<const T*>(f[k]);
#endif
  }
}

// A StackSrc over the stacked fields `f` (set_bases' table of that stride)
template <typename T, int NF>
__host__ inline StackSrc<T, NF> make_stack_src(const void* const* f,
                                               const Stack& m, long plane,
                                               int stride = NF) {
  StackSrc<T, NF> s;
  set_bases<T, NF>(s.f, f, stride);
  s.m = m;
  s.plane = plane;
  s.j = s.i = 0;
  return s;
}

// One stacked field a kernel reads at its block's offsets besides the
// operand table (a launch's output that the next launch reads back: K7's
// h1 between its streamed launches, phase B's p): its stack, across cards
// the nine stacks of its card classes
template <typename T>
struct Field {
  Bases<T> f;
};
// ... from the host's argument: the field's stack, or across cards a host
// table of the nine classes' stacks (set_bases' layout)
template <typename T>
__host__ inline Field<T> field_of(const void* a) {
  Field<T> r;
#if BEOM_CARDS
  Bases<T> one[1];
  set_bases<T, 1>(one, static_cast<const void* const*>(a));
  r.f = one[0];
#else
  r.f = static_cast<const T*>(a);
#endif
  return r;
}

// The Stack of geom = ly, lx, my, mx, cy, cx, a, b (the card's shards, the
// cards, the card's place; one card: cy = cx = 1, a = b = 0), checked
// against the grid (the Params' ny, nx); false where it does not tile the
// grid or a block cannot hold a halo of w.  p's layer stride becomes the
// card's plane.
template <typename T>
__host__ inline bool make_stack(Params<T>& p, const int* geom, int w,
                                Stack& m) {
  m.ly = geom[0];
  m.lx = geom[1];
  m.my = geom[2];
  m.mx = geom[3];
  m.plane = m.ly * m.lx;
  const int cy = geom[4], cx = geom[5], a = geom[6], b = geom[7];
#if BEOM_CARDS
  m.cy = cy;
  m.cx = cx;
  m.a = a;
  m.b = b;
#else
  if (cy != 1 || cx != 1 || a != 0 || b != 0) return false;
#endif
  const bool ok = m.ly >= w && m.lx >= w && m.my > 0 && m.mx > 0 &&
                  cy > 0 && cx > 0 && a >= 0 && a < cy && b >= 0 &&
                  b < cx && p.ny == m.ly * m.my * cy &&
                  p.nx == m.lx * m.mx * cx;
  p.plane = long(m.plane) * m.my * m.mx;
  return ok;
}

}  // namespace beom
