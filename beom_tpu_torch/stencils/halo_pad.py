"""The halo pad of a sharded field (K8) and its plain PyTorch version.

The CUDA kernel of `csrc/halo_pad.cu` replaces the TPU kernel
beom_tpu/parallel/rdma_halo.py::_halo_kernel (`rdma_pad2d`).  It computes
`parallel/halo.py::pad2d(a, w)`: every shard's block (.., ly, lx) written
into (.., ly + 2 w, lx + 2 w) with the halo from the neighbour shards (the
periodic self-wrap along a mesh axis with one shard), in one launch per
card for the card's shards (parallel/mesh.py: card_groups), the padded
blocks of a card views of one allocation of (S_c, .., ly + 2 w, lx + 2 w)
on it, with no concatenation copies.  A neighbour shard on another card is
read through its pointer (peer access, enabled here), and the launches
follow mesh.CardStreams' order.  It is bounded by device-memory bytes (a
copy); `csrc/halo_pad.cu` says what the design does about that.
`halo_pad_gather` runs the kernel's index arithmetic on the host, for the
tests.

`halo_pad` runs the kernel on CUDA blocks and the plain version,
`halo_pad_plain`, on CPU blocks.  It never falls back from one to the
other: on CUDA blocks it launches the kernel or raises, and a mesh that
mixes CPU and CUDA shards raises.  It is wired as Config.halo_impl =
'rdma' (parallel/halo.py::impl).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from beom_tpu_torch.parallel.mesh import (Card, CardStreams, Sharded,
                                          check_peers, device_type)

# kernel launches (one per card and pad, for the card's shards); a run
# reads the count to show that its path went through the kernel
LAUNCHES = 0

_P, _I = ctypes.c_void_p, ctypes.c_int


def halo_pad_plain(a: Sharded, w: int) -> Sharded:
    """pad2d by slices, copies and concatenations: y phase, then x phase
    on the y-padded block."""
    from beom_tpu_torch.parallel import halo

    a = halo.pad_axis(a, w, axis=a.ndim - 2, axis_name="y")
    return halo.pad_axis(a, w, axis=a.ndim - 1, axis_name="x")


def halo_pad_gather(a: Sharded, w: int, cards=None) -> Sharded:
    """The kernel's schedule on the host: for each card (`cards`, default
    the mesh as one) and each of its shards (the launch's z blocks), each
    output row and column, the source shard and point as csrc/halo_pad.cu
    computes them, gathered into one allocation of (S_c, .., ly + 2 w, lx
    + 2 w) per card.  Equal to pad2d for 1 <= w <= ly, lx."""
    mesh = a.mesh
    my, mx = mesh.shape["y"], mesh.shape["x"]
    cards = cards or [Card(None, tuple(range(mesh.n)), (0, 0), (my, mx),
                           (0, 0))]
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
    blocks = [None] * mesh.n
    for card in cards:
        (cmy, cmx), (cj0, ci0) = card.shape, card.origin
        out = torch.empty((cmy * cmx, L, ly + 2 * w, lx + 2 * w),
                          dtype=a.dtype)
        for q in range(cmy * cmx):
            j, i = cj0 + q // cmx, ci0 + q % cmx
            J = (j + dj) % my
            I = (i + di) % mx
            shard = J[:, None] * mx + I[None, :]
            out[q] = src[shard[None], torch.arange(L)[:, None, None],
                         gy[None, :, None], gx[None, None, :]]
        out = out.reshape((cmy * cmx,) + lead + (ly + 2 * w, lx + 2 * w))
        for s, b in zip(card.shards, out.unbind(0)):
            blocks[s] = b
    return Sharded(blocks, mesh)


@functools.lru_cache(maxsize=None)
def _entry():
    """(library, entry point, the most shards whose pointers a launch
    takes in its parameters)."""
    from beom_tpu_torch.stencils import build

    lib = build.load("halo_pad")
    fn = lib.beom_halo_pad
    fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _P]
    fn.restype = _I
    return lib, fn, lib.beom_max_shards()


@functools.lru_cache(maxsize=None)
def _launcher(cards: tuple):
    """(card rectangles as the kernel takes them, the cards' streams and
    their order) of a mesh's cards, with the peers enabled: made once."""
    from beom_tpu_torch.stencils import build

    order = None
    if len(cards) > 1:
        build.enable_peers(check_peers(list(cards)))
        order = CardStreams(list(cards))
    return [(_I * 4)(*c.shape, *c.origin) for c in cards], order


def halo_pad(a: Sharded, w: int, cards=None) -> Sharded:
    """pad2d(a, w) of a sharded field: the kernel on CUDA blocks (one
    launch per card of `cards`, default the mesh's own), the plain version
    on CPU blocks."""
    global LAUNCHES
    if w == 0:
        return a
    mesh = a.mesh
    kind = device_type(mesh)
    if kind == "cpu":
        return halo_pad_plain(a, w)
    if kind != "cuda":
        raise NotImplementedError(
            f"halo_pad runs on cuda or cpu, not {kind}")
    from beom_tpu_torch.parallel import halo
    from beom_tpu_torch.stencils import build

    cards = mesh.cards if cards is None else tuple(cards)
    rects, order = _launcher(cards)
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
    ptrs = [b.data_ptr() for b in blocks]
    streams = [torch.cuda.current_stream(cards[0].device)] if order is None \
        else order.before([[[blocks[s] for s in c.shards] for c in cards]])
    out = [None] * mesh.n
    for c, card in enumerate(cards):
        dev = torch.device(card.device)
        part = torch.empty((len(card.shards),) + lead
                           + (ly + 2 * w, lx + 2 * w), dtype=a.dtype,
                           device=dev)
        # more shards than the launch's parameters hold: their pointers in
        # the card's memory (`ptrs` is then ignored)
        table = None if mesh.n <= most else torch.tensor(ptrs, device=dev)
        with build.on_device(dev):
            code = fn(None if table is not None else (_P * mesh.n)(*ptrs),
                      None if table is None else table.data_ptr(),
                      part.data_ptr(), L, ly, lx, w, mesh.shape["y"],
                      mesh.shape["x"], rects[c], elem,
                      streams[c].cuda_stream)
        if code:
            build.check(lib, code, "halo_pad kernel launch")
        LAUNCHES += 1
        for s, b in zip(card.shards, part.unbind(0)):
            out[s] = b
    if order is not None:
        order.after()
    halo.COUNTS["moved"] += mesh.n * L * (
        (ly + 2 * w) * (lx + 2 * w) - ly * lx)
    return Sharded(out, mesh)
