"""The halo pad of a sharded field (K8) and its plain PyTorch version.

The CUDA kernel of `csrc/halo_pad.cu` replaces the TPU kernel
beom_tpu/parallel/rdma_halo.py::_halo_kernel (`rdma_pad2d`).  It computes
`parallel/halo.py::pad2d(a, w)`: every shard's block (.., ly, lx) written
into (.., ly + 2 w, lx + 2 w) with the halo from the neighbour shards (the
periodic self-wrap along a mesh axis with one shard), one launch per shard
and no concatenation copies.  It is bounded by device-memory bytes (a
copy); `csrc/halo_pad.cu` says what the design does about that.

`halo_pad` runs the kernel on CUDA blocks and the plain version,
`halo_pad_plain`, on CPU blocks.  It never falls back from one to the
other: on CUDA blocks it launches the kernel or raises.  The kernel reads
the neighbours' blocks through raw pointers, so every shard must lie on
one CUDA device; a mesh over several devices raises.  It is wired as
Config.halo_impl = 'rdma' (parallel/halo.py::impl).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from beom_tpu_torch.parallel.mesh import Sharded

# kernel launches (one per shard and pad); a run reads the count to show
# that its path went through the kernel
LAUNCHES = 0

_P, _I = ctypes.c_void_p, ctypes.c_int


def halo_pad_plain(a: Sharded, w: int) -> Sharded:
    """pad2d by slices, copies and concatenations: y phase, then x phase
    on the y-padded block."""
    from beom_tpu_torch.parallel import halo

    a = halo.pad_axis(a, w, axis=a.ndim - 2, axis_name="y")
    return halo.pad_axis(a, w, axis=a.ndim - 1, axis_name="x")


@functools.lru_cache(maxsize=None)
def _entry():
    from beom_tpu_torch.stencils import build

    lib = build.load("halo_pad")
    fn = lib.beom_halo_pad
    fn.argtypes = [_P, _P, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return lib, fn


def halo_pad(a: Sharded, w: int) -> Sharded:
    """pad2d(a, w) of a sharded field: the kernel on CUDA blocks, the
    plain version on CPU blocks."""
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
    elem = a.blocks[0].element_size()
    lead, (ly, lx) = tuple(a.shape[:-2]), a.shape[-2:]
    if elem not in (4, 8) or w > ly or w > lx:
        raise ValueError(
            f"halo_pad: blocks of {elem}-byte values and ({ly}, {lx}) "
            f"points with a halo of {w}: the values must have 4 or 8 "
            "bytes and the halo fit the block")
    blocks = [b.contiguous() for b in a.blocks]
    src = [b.data_ptr() for b in blocks]
    L = 1
    for n in lead:
        L *= n
    lib, fn = _entry()
    shape = lead + (ly + 2 * w, lx + 2 * w)

    def launch(s):
        global LAUNCHES
        out = torch.empty(shape, dtype=a.dtype, device=dev)
        code = fn((_P * 9)(*[src[n] for n in mesh.neighbourhoods[s]]),
                  out.data_ptr(), L, ly, lx, w, elem,
                  torch.cuda.current_stream(dev).cuda_stream)
        if code:
            build.check(lib, code, "halo_pad kernel launch")
        LAUNCHES += 1
        return out

    # the device's current stream orders the blocks before every launch
    with torch.cuda.device(dev):
        outs = [launch(s) for s in range(mesh.n)]
    halo.COUNTS["moved"] += mesh.n * L * (
        (ly + 2 * w) * (lx + 2 * w) - ly * lx)
    return Sharded(outs, mesh)
