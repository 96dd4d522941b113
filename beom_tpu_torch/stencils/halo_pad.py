"""The halo pad of a sharded field (K8) and its plain PyTorch version.

The CUDA kernel of `csrc/halo_pad.cu` replaces the TPU kernel
beom_tpu/parallel/rdma_halo.py::_halo_kernel (`rdma_pad2d`).  It computes
`parallel/halo.py::pad2d(a, w)`: every shard's block (.., ly, lx) written
into (.., ly + 2 w, lx + 2 w) with the halo from the neighbour shards (the
periodic self-wrap along a mesh axis with one shard), in one launch for
every shard of the card, the padded blocks views of one allocation of (S,
.., ly + 2 w, lx + 2 w), with no concatenation copies.  It is bounded by
device-memory bytes (a copy); `csrc/halo_pad.cu` says what the design does
about that.  `halo_pad_gather` runs the kernel's index arithmetic on the
host, for the tests.

`halo_pad` runs the kernel on CUDA blocks and the plain version,
`halo_pad_plain`, on CPU blocks.  It never falls back from one to the
other: on CUDA blocks it launches the kernel or raises.  The kernel reads
the shards' blocks through their pointers, so every shard must lie on one
CUDA device; a mesh over several devices raises.  It is wired as
Config.halo_impl = 'rdma' (parallel/halo.py::impl).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from beom_tpu_torch.parallel.mesh import Sharded

# kernel launches (one per pad, for every shard); a run reads the count to
# show that its path went through the kernel
LAUNCHES = 0

_P, _I = ctypes.c_void_p, ctypes.c_int


def halo_pad_plain(a: Sharded, w: int) -> Sharded:
    """pad2d by slices, copies and concatenations: y phase, then x phase
    on the y-padded block."""
    from beom_tpu_torch.parallel import halo

    a = halo.pad_axis(a, w, axis=a.ndim - 2, axis_name="y")
    return halo.pad_axis(a, w, axis=a.ndim - 1, axis_name="x")


def halo_pad_gather(a: Sharded, w: int) -> Sharded:
    """The kernel's schedule on the host: for each shard (the launch's z
    blocks), each output row and column, the source shard and point as
    csrc/halo_pad.cu computes them, gathered into one allocation of (S,
    .., ly + 2 w, lx + 2 w).  Equal to pad2d for 1 <= w <= ly, lx."""
    mesh = a.mesh
    my, mx = mesh.shape["y"], mesh.shape["x"]
    lead, (ly, lx) = tuple(a.shape[:-2]), tuple(a.shape[-2:])
    L = 1
    for n in lead:
        L *= n
    src = torch.stack([b.reshape(L, ly, lx) for b in a.blocks])
    X = torch.arange(lx + 2 * w) - w
    di = (X >= lx).long() - (X < 0).long()
    gx = X - di * lx
    r = torch.arange(ly + 2 * w) - w
    dj = (r >= ly).long() - (r < 0).long()
    gy = r - dj * ly
    out = torch.empty((mesh.n, L, ly + 2 * w, lx + 2 * w), dtype=a.dtype)
    for s in range(mesh.n):
        j, i = divmod(s, mx)
        J = (j + dj) % my
        I = (i + di) % mx
        shard = J[:, None] * mx + I[None, :]
        out[s] = src[shard[None], torch.arange(L)[:, None, None],
                     gy[None, :, None], gx[None, None, :]]
    out = out.reshape((mesh.n,) + lead + (ly + 2 * w, lx + 2 * w))
    return Sharded(list(out.unbind(0)), mesh)


@functools.lru_cache(maxsize=None)
def _entry():
    """(library, entry point, the most shards whose pointers a launch
    takes in its parameters)."""
    from beom_tpu_torch.stencils import build

    lib = build.load("halo_pad")
    fn = lib.beom_halo_pad
    fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return lib, fn, lib.beom_max_shards()


def halo_pad(a: Sharded, w: int) -> Sharded:
    """pad2d(a, w) of a sharded field: the kernel on CUDA blocks, the
    plain version on CPU blocks."""
    global LAUNCHES
    if w == 0:
        return a
    if a.device.type == "cpu":
        return halo_pad_plain(a, w)
    if a.device.type != "cuda":
        raise NotImplementedError(
            f"halo_pad runs on cuda or cpu, not {a.device.type}")
    from beom_tpu_torch.parallel import halo
    from beom_tpu_torch.stencils import build

    mesh = a.mesh
    dev = mesh.single_device("halo_pad")
    b0 = a.blocks[0]
    elem = b0.element_size()
    lead, (ly, lx) = tuple(b0.shape[:-2]), b0.shape[-2:]
    lib, fn, most = _entry()
    if elem not in (4, 8) or w > ly or w > lx:
        raise ValueError(
            f"halo_pad: blocks of {elem}-byte values and ({ly}, {lx}) "
            f"points with a halo of {w}: the values must have 4 or 8 "
            "bytes and the halo fit the block")
    L = 1
    for n in lead:
        L *= n
    # the device's current stream orders the blocks before the launch
    blocks = [b.contiguous() for b in a.blocks]
    out = torch.empty((mesh.n,) + lead + (ly + 2 * w, lx + 2 * w),
                      dtype=a.dtype, device=dev)
    ptrs = [b.data_ptr() for b in blocks]
    # more shards than the launch's parameters hold: their pointers in
    # the device's memory (`ptrs` is then ignored)
    table = None if mesh.n <= most else torch.tensor(ptrs, device=dev)
    with build.on_device(dev):
        if table is None:
            code = fn((_P * mesh.n)(*ptrs), None, out.data_ptr(), L, ly,
                      lx, w, mesh.shape["y"], mesh.shape["x"], elem,
                      torch.cuda.current_stream(dev).cuda_stream)
        else:
            code = fn(None, table.data_ptr(), out.data_ptr(), L, ly, lx, w,
                      mesh.shape["y"], mesh.shape["x"], elem,
                      torch.cuda.current_stream(dev).cuda_stream)
    if code:
        build.check(lib, code, "halo_pad kernel launch")
    LAUNCHES += 1
    halo.COUNTS["moved"] += mesh.n * L * (
        (ly + 2 * w) * (lx + 2 * w) - ly * lx)
    return Sharded(list(out.unbind(0)), mesh)
