"""The device mesh: the port's twin of beom_tpu/parallel/mesh.py.

The model is the reference's: one controlling process and a mesh of
NY x NX shards with axes ('y', 'x') matching the grid axes.  Fields
(.., ny, nx) are cut into local blocks (.., ny / NY, nx / NX); layers
always stay local.  Each shard has a `torch.device`.  Several shards may
share one device: `make_mesh(2, 4, devices=[dev])` is the counterpart of
the reference's virtual devices, and how the CPU tests and a one-card run
drive an eight-shard mesh.

A sharded field is the mesh's list of local blocks, in row-major order of
the mesh, held in a `Sharded`.  `Sharded` maps every torch function,
tensor method and operator over its blocks, so code written for one
tensor (the steps, the solvers) runs once per shard, as the body of the
reference's `shard_map` does; what crosses shards goes through the
collectives of parallel/halo.py, which are functions over the list.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from beom_tpu_torch.core.state import State


def _with_index(d: torch.device) -> torch.device:
    """'cuda' as the current CUDA device, so devices compare equal to
    their tensors'."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """NY x NX shards; shard (j, i) is entry j * NX + i of every list."""

    def __init__(self, devices, mesh_y: int, mesh_x: int):
        self.shape = {"y": mesh_y, "x": mesh_x}
        self.devices = [_with_index(torch.device(d)) for d in devices]
        self.n = mesh_y * mesh_x
        self._one_device = len(set(self.devices)) == 1

    def single_device(self, what: str) -> torch.device:
        """The one device that holds every shard.  The kernels that run
        one launch for every shard of a card and read the neighbour
        shards' blocks (the shard step, the halo pad) need it: between
        several cards they would need a launch per card and peer access
        for the neighbours' edges (ROADMAP queue 1 item 6)."""
        if not self._one_device:
            raise NotImplementedError(
                f"{what} takes a mesh whose shards lie on one device, not "
                f"on {sorted(set(map(str, self.devices)))}: a mesh over "
                "several devices is ROADMAP queue 1 item 6 (use "
                "backend='eager' with halo_impl='ppermute')")
        return self.devices[0]

    def coords(self, s: int):
        return divmod(s, self.shape["x"])

    def index(self, j: int, i: int) -> int:
        """The shard at mesh coordinates (j, i), wrapped periodically."""
        return (j % self.shape["y"]) * self.shape["x"] + i % self.shape["x"]

    def neighbour(self, s: int, dj: int, di: int) -> int:
        j, i = self.coords(s)
        return self.index(j + dj, i + di)

    def shift(self, a: "Sharded", axis_name: str, step: int) -> "Sharded":
        """The ring permutation along a mesh axis: the block of shard c
        moves to shard c + step (wrapping), onto that shard's device."""
        d = (step, 0) if axis_name == "y" else (0, step)
        return Sharded([a.blocks[self.neighbour(s, -d[0], -d[1])]
                        .to(self.devices[s]) for s in range(self.n)], self)


def make_mesh(mesh_y: int, mesh_x: int,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of mesh_y x mesh_x shards.  `devices` names one device per
    shard, or one device for every shard; with None the shards take the
    visible CUDA devices, one each."""
    n = mesh_y * mesh_x
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise ValueError(f"need {n} devices, have {have}")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = list(devices)
    if len(devices) == 1:
        devices = devices * n
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    return Mesh(devices[:n], mesh_y, mesh_x)


def _pick(obj, s: int, device):
    """obj with every Sharded replaced by its block s; a plain tensor on
    another device follows the block."""
    if isinstance(obj, Sharded):
        return obj.blocks[s]
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pick(o, s, device) for o in obj)
    if isinstance(obj, torch.Tensor) and obj.device != device:
        return obj.to(device)
    return obj


def _find(obj):
    if isinstance(obj, Sharded):
        return obj
    if isinstance(obj, (list, tuple)):
        for o in obj:
            if (f := _find(o)) is not None:
                return f
    return None


def _map(func, args, kwargs):
    mesh = _find((args, tuple(kwargs.values()))).mesh
    outs = []
    for s in range(mesh.n):
        dev = mesh.devices[s]
        outs.append(func(*_pick(args, s, dev),
                         **{k: _pick(v, s, dev) for k, v in kwargs.items()}))
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return Sharded(outs, mesh)
    if isinstance(first, (tuple, list)) and first \
            and isinstance(first[0], torch.Tensor):
        return tuple(Sharded([o[k] for o in outs], mesh)
                     for k in range(len(first)))
    return first        # a shape, a dtype, a bool: the same on every shard


class Sharded:
    """A field sharded over a mesh: `blocks[s]` is shard s's local block."""

    __array_ufunc__ = None      # numpy scalars defer to the operators below
    __hash__ = None

    def __init__(self, blocks, mesh: Mesh):
        self.blocks = list(blocks)
        self.mesh = mesh

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return _map(func, args, kwargs or {})

    def __getattr__(self, name):
        attr = getattr(torch.Tensor, name)
        if callable(attr):
            return lambda *a, **k: _map(attr, (self,) + a, k)
        return getattr(self.blocks[0], name)    # shape, dtype, device, ndim

    def __bool__(self):
        return bool(self.blocks[0])

    def __float__(self):
        return float(self.blocks[0])

    def __repr__(self):
        return f"Sharded({self.mesh.shape}, block {tuple(self.shape)})"


def _operator(name):
    attr = getattr(torch.Tensor, name)

    def op(self, *args):
        return _map(attr, (self,) + args, {})
    op.__name__ = name
    return op


for _name in ("add", "radd", "sub", "rsub", "mul", "rmul", "truediv",
              "rtruediv", "pow", "rpow", "neg", "abs", "mod", "and", "or",
              "invert", "gt", "ge", "lt", "le", "eq", "ne", "getitem",
              "setitem", "iadd", "isub", "imul"):
    setattr(Sharded, f"__{_name}__", _operator(f"__{_name}__"))


def shard(a: torch.Tensor, mesh: Mesh) -> Sharded:
    """Cut the trailing (ny, nx) axes of a global tensor into the mesh's
    blocks, each a contiguous copy on its shard's device."""
    NY, NX = mesh.shape["y"], mesh.shape["x"]
    ny, nx = a.shape[-2:]
    if ny % NY or nx % NX:
        raise ValueError(f"({ny}, {nx}) does not divide over the "
                         f"({NY}, {NX}) mesh")
    ly, lx = ny // NY, nx // NX
    return Sharded([
        a[..., j * ly:(j + 1) * ly, i * lx:(i + 1) * lx]
        .to(mesh.devices[j * NX + i]).contiguous()
        for j in range(NY) for i in range(NX)], mesh)


def gather(a, device=None) -> torch.Tensor:
    """The global tensor of a sharded field (a plain tensor passes), on
    `device` (default: the first shard's): what np.asarray of a sharded
    array is in the reference."""
    if not isinstance(a, Sharded):
        return a if device is None else a.to(device)
    NX = a.mesh.shape["x"]
    device = a.blocks[0].device if device is None else device
    rows = [torch.cat([b.to(device) for b in a.blocks[j:j + NX]], dim=-1)
            for j in range(0, a.mesh.n, NX)]
    return torch.cat(rows, dim=-2)


def host_array(a) -> np.ndarray:
    """A field as a global numpy array on the host; a sharded field is
    gathered."""
    return gather(a).detach().cpu().numpy()


def _map_fields(tree, fn):
    return dataclasses.replace(tree, **{
        f.name: fn(getattr(tree, f.name)) for f in dataclasses.fields(tree)})


def shard_pytree(tree, mesh: Mesh):
    """Shard every field (.., ny, nx) of a Grid / Forcing / State; scalars
    and None stay as they are."""
    def put(a):
        if isinstance(a, torch.Tensor) and a.ndim >= 2:
            return shard(a, mesh)
        return a
    return _map_fields(tree, put)


def shard_state(state: State, mesh: Mesh) -> State:
    """Place the State's fields on the mesh; t and n stay on the host."""
    return shard_pytree(state, mesh)


def gather_pytree(tree, device=None):
    """The inverse of shard_pytree: every sharded field as one global
    tensor."""
    return _map_fields(tree, lambda a: gather(a, device)
                       if isinstance(a, Sharded) else a)


def gather_state(state: State, device=None) -> State:
    return gather_pytree(state, device)
