"""Halo exchange over the mesh: the port's twin of
beom_tpu/parallel/halo.py.

Two-phase neighbour exchange: pad y first, then pad x on the y-padded
block, so the corner halos are carried for free.  The mesh wraps
(periodic), which matches the periodic-roll operators of core/ops.py:
physical walls come from the mask, so a wrapped halo never transports
signal across land.

The collectives are functions over a sharded field's list of blocks
(parallel/mesh.py): a ring permutation is an index shift of that list,
and a block that changes device is copied with `Tensor.to`.  `pad2d` has
two implementations, chosen by `impl(name)` as the reference chooses at
trace time:

  'ppermute'  slices, copies and concatenations op by op (the default);
  'rdma'      the halo-pad kernel of stencils/halo_pad.py (K8): one launch
              per shard writes the padded block in place, reading the
              neighbours' blocks directly.

`COUNTS` counts the mesh reductions made and the elements that moved
between shards, so a test can pin that a CG iteration costs one reduction
and that the pipelined matvec moves thin slices only.
"""

from __future__ import annotations

import contextlib

import torch

from beom_tpu_torch.parallel.mesh import Sharded

_PAD_IMPL = "ppermute"
COUNTS = {"reductions": 0, "moved": 0}


def reset_counts() -> None:
    COUNTS["reductions"] = COUNTS["moved"] = 0


@contextlib.contextmanager
def impl(name: str):
    """Select the pad2d implementation for the block (see
    dist.make_dist_stepper, which applies Config.halo_impl)."""
    global _PAD_IMPL
    if name not in ("ppermute", "rdma"):
        raise ValueError(f"unknown halo impl {name!r}")
    old, _PAD_IMPL = _PAD_IMPL, name
    try:
        yield
    finally:
        _PAD_IMPL = old


def send(a: Sharded, axis_name: str, up: bool) -> Sharded:
    """Every shard's block to its next-higher (`up`) or next-lower
    neighbour along a mesh axis, wrapping: the reference's ppermute over
    _ring_perm."""
    COUNTS["moved"] += sum(b.numel() for b in a.blocks)
    return a.mesh.shift(a, axis_name, 1 if up else -1)


def pad_axis(a: Sharded, w: int, axis: int, axis_name: str) -> Sharded:
    """Pad each local block with w neighbour cells on each side along
    `axis`."""
    if w == 0:
        return a
    lo = a.narrow(axis, 0, w)                       # my low edge
    hi = a.narrow(axis, a.shape[axis] - w, w)
    if a.mesh.shape[axis_name] == 1:
        # single shard along this axis: the halo is my own wrap
        return torch.cat([hi, a, lo], dim=axis)
    from_low = send(hi, axis_name, up=True)
    from_high = send(lo, axis_name, up=False)
    return torch.cat([from_low, a, from_high], dim=axis)


def pad2d(a: Sharded, w: int) -> Sharded:
    """Halo-pad the trailing (y, x) axes: y phase then x phase (corners
    ride the x phase of the already y-padded block)."""
    if _PAD_IMPL == "rdma" and w > 0:
        from beom_tpu_torch.stencils.halo_pad import halo_pad
        return halo_pad(a, w)
    a = pad_axis(a, w, axis=a.ndim - 2, axis_name="y")
    return pad_axis(a, w, axis=a.ndim - 1, axis_name="x")


def crop2d(a, w: int):
    """Drop the w-wide halo ring from the trailing (y, x) axes."""
    if w == 0:
        return a
    return a[..., w:-w, w:-w]


def _reduce(x: Sharded, op) -> Sharded:
    """One mesh reduction: the blocks (of any one shape) combined in mesh
    order, the result placed on every shard."""
    COUNTS["reductions"] += 1
    dev = x.blocks[0].device
    total = x.blocks[0]
    for b in x.blocks[1:]:
        total = op(total, b.to(dev))
    return Sharded([total.to(d) for d in x.mesh.devices], x.mesh)


def psum2(x: Sharded) -> Sharded:
    """Global sum over the full ('y', 'x') mesh."""
    return _reduce(x, torch.add)


def pmax2(x: Sharded) -> Sharded:
    return _reduce(x, torch.maximum)


def pmin2(x: Sharded) -> Sharded:
    return _reduce(x, torch.minimum)


def dist_dot(a, b):
    """Global dot product of unpadded local blocks (CG reductions)."""
    return psum2(torch.sum(a * b))


def dist_dots(pairs):
    """Batched global dots with one reduction of the stacked partial
    sums: a whole CG iteration's scalars (solvers/elliptic.cg_solve
    `dots`)."""
    return psum2(torch.stack([torch.sum(a * b) for a, b in pairs]))
