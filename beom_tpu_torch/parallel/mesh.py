"""The device mesh: the port's twin of beom_tpu/parallel/mesh.py.

The model is the reference's: one controlling process and a mesh of
NY x NX shards with axes ('y', 'x') matching the grid axes.  Fields
(.., ny, nx) are cut into local blocks (.., ny / NY, nx / NX); layers
always stay local.  Each shard has a `torch.device`.  Several shards may
share one device: `make_mesh(2, 4, devices=[dev])` is the counterpart of
the reference's virtual devices, and how the CPU tests and a one-card run
drive an eight-shard mesh.

The shards of one device form that device's card (`card_groups`): a
rectangle of the mesh, the same shape on every card, so that the cards are
a grid of their own.  The fused backend's kernels run one launch per card
over its shards and read the neighbour cards' edges through peer access
(`check_peers`); `make_mesh(2, 4)` on eight cards gives each one shard,
`devices=[cuda:0] * 4 + [cuda:1] * 4` two cards of a row of four shards.

A sharded field is the mesh's list of local blocks, in row-major order of
the mesh, held in a `Sharded`.  `Sharded` maps every torch function,
tensor method and operator over its blocks, so code written for one
tensor (the steps, the solvers) runs once per shard, as the body of the
reference's `shard_map` does; what crosses shards goes through the
collectives of parallel/halo.py, which are functions over the list.
"""

from __future__ import annotations

import dataclasses
import functools
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
        self._types = sorted({d.type for d in self.devices})

    @functools.cached_property
    def cards(self) -> tuple:
        """The mesh's cards: card_groups of its devices, found once."""
        return tuple(card_groups(self.devices, self.shape["y"],
                                 self.shape["x"]))

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


@dataclasses.dataclass(frozen=True)
class Card:
    """One card's part of a mesh: the rectangle of shape = (cmy, cmx)
    shards from mesh row and column origin = (j0, i0), its shards' mesh
    indices in mesh order; place = (a, b) in the grid of cards."""
    device: object
    shards: tuple
    origin: tuple
    shape: tuple
    place: tuple


def card_groups(devices, mesh_y: int, mesh_x: int) -> list:
    """The cards of a mesh of mesh_y x mesh_x shards whose shard s lies on
    devices[s] (any labels: the tests give strings), in the row-major order
    of the grid of cards.  Raise ValueError, naming the devices, where the
    shards of a device are not a rectangle of the mesh or the rectangles
    differ in shape."""
    n = mesh_y * mesh_x
    devices = list(devices)
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices for a mesh of {n} shards")
    groups: dict = {}
    for s, d in enumerate(devices):
        groups.setdefault(d, []).append(s)
    rects = []
    for d, ss in groups.items():
        js = [s // mesh_x for s in ss]
        iss = [s % mesh_x for s in ss]
        j0, i0 = min(js), min(iss)
        shape = (max(js) + 1 - j0, max(iss) + 1 - i0)
        if shape[0] * shape[1] != len(ss):
            raise ValueError(
                f"the shards {ss} on {d} are not a rectangle of the "
                f"({mesh_y}, {mesh_x}) mesh: each card must hold one")
        rects.append((d, tuple(ss), (j0, i0), shape))
    shapes = {r[3] for r in rects}
    if len(shapes) > 1:
        raise ValueError(
            "the cards hold rectangles of different shapes: "
            + ", ".join(f"{d}: {sh[0]} x {sh[1]}" for d, _, _, sh in rects)
            + "; every card must hold the same")
    cmy, cmx = shapes.pop()
    rects.sort(key=lambda r: r[2])
    return [Card(d, ss, o, (cmy, cmx), (o[0] // cmy, o[1] // cmx))
            for d, ss, o, _ in rects]


# a card class's step along an axis: this card, the next, the previous
# (csrc/shard_addr.cuh: Stack::cls)
CLASS_STEP = (0, 1, -1)


def card_classes(cards: list) -> list:
    """For each card, the indices into `cards` of the card of each class
    3 rc + cc: the card CLASS_STEP[rc] cards along y and CLASS_STEP[cc]
    along x, wrapping (a mesh axis of one card points at the card
    itself)."""
    cy = 1 + max(c.place[0] for c in cards)
    cx = 1 + max(c.place[1] for c in cards)
    at = {c.place: k for k, c in enumerate(cards)}
    return [tuple(at[(c.place[0] + dy) % cy, (c.place[1] + dx) % cx]
                  for dy in CLASS_STEP for dx in CLASS_STEP) for c in cards]


def device_type(mesh: "Mesh") -> str:
    """The one device type of the mesh's shards; a mesh that mixes CPU and
    CUDA shards raises ValueError."""
    types = mesh._types
    if len(types) > 1:
        raise ValueError(
            f"the mesh mixes devices of types {types} "
            f"({sorted(set(map(str, mesh.devices)))}): its shards must all "
            "lie on CPUs or all on CUDA cards")
    return types[0]


def peer_pairs(cards: list) -> list:
    """The (reader, holder) pairs of devices of neighbouring cards on
    different devices: the reader's kernels read the holder's memory."""
    pairs = []
    for c, nbs in zip(cards, card_classes(cards)):
        for k in nbs:
            d = cards[k].device
            if d != c.device and (c.device, d) not in pairs:
                pairs.append((c.device, d))
    return pairs


def check_peers(cards: list) -> list:
    """Raise RuntimeError, naming the pair, where a card cannot read a
    neighbour card's memory (torch.cuda.can_device_access_peer): the
    kernels read the neighbours' edges in place and have no host-staged
    path.  Returns peer_pairs(cards)."""
    pairs = peer_pairs(cards)
    for d, e in pairs:
        if not torch.cuda.can_device_access_peer(d, e):
            raise RuntimeError(
                f"{d} cannot read the memory of {e} (no peer access "
                "between them): a mesh's neighbour cards must have it")
    return pairs


class CardStreams:
    """The streams of one launch per card and their order (the fused
    backend's kernels, K7 and K8).  A card launches on its device's
    current stream; a second card on one device (the tests' and the chip
    check's split of one card's shards) on a side stream of its own.
    Before the launches (`before`), each card's stream waits for the
    streams of its neighbour cards and the current streams of their
    devices (what they wrote, their previous kernel and the caller's work
    alike), and a tensor a card reads on another device is recorded on the
    reading card's stream, so that the caching allocator keeps it until
    that stream has read it; after them (`after`), a device's current
    stream waits for its side streams.  Outside a launch, tensors follow
    PyTorch's stream rules."""

    def __init__(self, cards: list):
        self.cards = cards
        self.classes = card_classes(cards)
        self.side = []
        for c in cards:
            twin = any(k.device == c.device for k in cards[:len(self.side)])
            self.side.append(torch.cuda.Stream(c.device) if twin else None)
        self._kept = set()

    def streams(self) -> list:
        return [s if s is not None else torch.cuda.current_stream(c.device)
                for s, c in zip(self.side, self.cards)]

    def before(self, inputs, kept=()) -> list:
        """Order the cards' streams before their launches and return them.
        inputs[i][k]: what card k holds of the i-th input (a tensor or a
        list of tensors); kept[k]: card k's tensors that live as long as
        the launcher (recorded once per stream)."""
        streams = self.streams()
        for c, card in enumerate(self.cards):
            mine = streams[c]
            feeds = {}
            for k in self.classes[c]:
                dev = self.cards[k].device
                for s in (streams[k], torch.cuda.current_stream(dev)):
                    feeds[s.cuda_stream] = s
            for s in feeds.values():
                if s.cuda_stream != mine.cuda_stream:
                    mine.wait_stream(s)
            for k in set(self.classes[c]):
                if self.cards[k].device == card.device:
                    continue
                for f in inputs:
                    for a in (f[k] if isinstance(f[k], (list, tuple))
                              else [f[k]]):
                        a.record_stream(mine)
                if kept and (k, mine.cuda_stream) not in self._kept:
                    for a in kept[k]:
                        a.record_stream(mine)
                    self._kept.add((k, mine.cuda_stream))
        return streams

    def after(self) -> None:
        """A device's current stream waits for its side streams."""
        for s, c in zip(self.side, self.cards):
            if s is not None:
                torch.cuda.current_stream(c.device).wait_stream(s)


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
