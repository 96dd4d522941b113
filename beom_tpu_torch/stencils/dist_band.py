"""The fused steps on the shards of a device mesh (K7) and their plain
PyTorch versions: the forward-backward step, the split step and the two
phases of the projection steps.

The CUDA kernels replace the TPU kernel beom_tpu/stencils/dist_band.py::
_dist_band_kernel with the bodies it runs in beom_tpu/parallel/dist.py:
`csrc/shard_step.cu` the fb body of make_dist_pallas_stepper,
`csrc/shard_split.cu` its split body, `csrc/shard_projection.cu` body_a
and body_b of make_dist_pallas_projection_stepper.  Each computes on every
shard's local block (nz, ly, lx) what the single-device kernel computes on
the grid (K1's step or pass; K1s's two or three kernels; K3a, K3b), with
the same stage code (`csrc/fb_step_body.cuh`, `split_body.cuh`,
`projection_body.cuh`), so a shard's result equals the single-device
kernel's bit for bit.

The shards of a device are its card (parallel/mesh.py: card_groups, a
rectangle of the mesh, the same shape on every card), and each kernel is
one launch per card over the tiles of its shards.  Every operand of a
card is one allocation of (L, S_c, ly, lx): layer k of the card's shard q
is its block in the card's plane k (`stack_part`), so a point's offset on
the card is a row term plus a column term, whichever of the card's shards
holds it (csrc/shard_addr.cuh: Stack).  On one card that is the whole mesh
(`stack`), one stream orders a kernel after the previous one of its
neighbours, and there is no remote transfer to overlap.  Across cards
(the builds with BEOM_CARDS = 1) a point of a neighbour card's shard is
read in that card's stacks through their pointers (peer access): the
tables' terms stay card-local and carry the point's card class, which
picks one of the nine stacks of an operand; each card launches on its own
stream, ordered against its neighbours' by events (mesh.CardStreams).  The
statics are stacked once per card and MeshKernels, the sharded fields a
kernel returns are views of its stacked outputs, and fields that are not
yet stacked are copied once into the layout.  A MeshKernels keeps what a
launch does not change: the builds, the operand tables of the statics,
the scalar slots and the geometry of each card.

  fb     a pass of k steps is `mesh_plan`'s launches: kb steps per launch
         (the pass kernel, fused_fb.plan's kb, at most what a block's
         neighbours hold: kb W <= ly, lx), the single-step kernel at kb = 1,
         or where fused_fb.launch_plan streams the layers its two launches
         per step (the continuity, then the momentum reading h1 back);
  split  a step is fused_fb.split_plan's route: route 2, the slow phase's
         tendencies then the tail (halo nsub + LO + E); route 3, the slow
         phase, the subcycle and the recomposition; where the plan streams
         the layers, the slow phase (its tendencies) in one launch and the
         recomposition in two (the continuity and the rescale, then the
         velocities reading h1 back);
  rigid_lid / implicit_fs  phase A and phase B, each the kernel
         fused_projection.plan takes on one device: the staged kernel at
         its geometry, or the single-step one where no staged geometry
         fits a CTA; around the mesh's elliptic solve (its right-hand side
         on the shards, parallel/dist.py's pressure_rhs; the solve on the
         gathered grid of the shards through K6 or K4a's sweeps,
         stencils/mesh_solve.py).

A mesh over several devices takes equal rectangles of shards per device;
another placement, and a mesh that mixes CPU and CUDA shards, raises
ValueError, and neighbour cards without peer access raise RuntimeError.
No path stages a neighbour's edge through the host.

Each wrapper runs its kernel on CUDA blocks, through the MeshKernels it is
given (the fused mesh steppers launch through the same wrappers), and its
plain version (pad2d by the kernel's halo, the eager function on the
padded blocks, crop2d) on CPU blocks; it never falls back from one to the
other.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from beom_tpu_torch.core.config import Config
from beom_tpu_torch.core.grid import Grid, Forcing
from beom_tpu_torch.core.state import State, advance_time
from beom_tpu_torch.parallel import halo
from beom_tpu_torch.parallel.mesh import (Card, CardStreams, Mesh, Sharded,
                                          _with_index, card_classes,
                                          check_peers, device_type)
from beom_tpu_torch.physics import drag
from beom_tpu_torch.stencils import build, fused_fb, fused_projection
from beom_tpu_torch.stepping import fb as fb_mod
from beom_tpu_torch.stepping import projection
from beom_tpu_torch.stepping import split as split_mod

# kernel launches, one per kernel and card for the card's shards: the fb
# launches (fb_pass those of the pass kernel among them), the split step's
# kernels and the projection phases; a run reads them to show that its
# main path went through the kernels
LAUNCHES = {"fb": 0, "fb_pass": 0, "split_slow": 0, "split_subcycle": 0,
            "split_recompose": 0, "split_tend": 0, "split_tail": 0,
            "proj_a": 0, "proj_b": 0}
# the layer-streamed kernels' launches, one per kernel and card (MeshPlan.
# streamed): K7-fb's two per step (LAUNCHES counts the step once), K7-split's
# slow phase or its tendencies and the recomposition's two per step
# (LAUNCHES counts them once), and the projection phases
STREAM_LAUNCHES = {"fb_continuity": 0, "fb_momentum": 0, "split_slow": 0,
                   "split_tend": 0, "split_recompose": 0, "proj_a": 0,
                   "proj_b": 0}
# the STREAM_LAUNCHES kind of each entry of a streamed build
_STREAMED = {"fb_cont": "fb_continuity", "fb_mom": "fb_momentum",
             "split_slow": "split_slow", "split_tend": "split_tend",
             "split_rec_h": "split_recompose",
             "split_rec_uv": "split_recompose", "proj_a": "proj_a",
             "proj_b": "proj_b"}

_PROJECTION = ("rigid_lid", "implicit_fs")
# the split kernels in the order of csrc/shard_split.cu's beom_smem_bytes
# (and beom_kernel_halo: its first four), and of its streamed build
_SPLIT = ("slow", "recompose", "subcycle", "tail")
_SPLIT_STREAMED = ("split_slow", "split_rec_h", "split_subcycle",
                   "split_tail", "split_rec_uv")
# the phase kernels in the order of csrc/shard_projection.cu's: the
# single-step ones, then the staged ones
_PHASES = fused_projection._KERNELS + fused_projection._STAGED
# the LAUNCHES kind of an entry point whose name is not its kind
_KIND = {"step": "fb", "fb_cont": "fb", "fb_mom": "fb",
         "split_rec_h": "split_recompose", "split_rec_uv": "split_recompose",
         "proj_as": "proj_a", "proj_bs": "proj_b"}
_P, _I = ctypes.c_void_p, ctypes.c_int


def check_config(cfg: Config) -> None:
    """Raise on what the shard kernels cannot run: what the single-device
    kernels of the scheme refuse."""
    if cfg.scheme in _PROJECTION:
        fused_projection.check_config(cfg)
    else:
        fused_fb.check_config(cfg)


def kernel_halos(cfg: Config) -> dict:
    """The halo each kernel of the scheme reads around a tile (the fb pass
    kernel of kb steps reads kb times "fb")."""
    lo = 2 if cfg.wetdry else 1
    if cfg.scheme == "split":
        return {"slow": 2, "subcycle": cfg.nsub, "recompose": lo + 1,
                "tail": fused_fb.tail_halo(cfg)}
    if cfg.scheme in _PROJECTION:
        return {"proj_a": 4, "proj_b": fused_projection.halo_b(cfg)}
    return {"fb": lo + 3}


def shard_halo(cfg: Config) -> int:
    """The halo the plain versions' statics are padded to, and the least a
    shard's block must hold: the widest a kernel of the scheme reads."""
    return max(kernel_halos(cfg).values())


def pad_statics(grid: Grid, forcing: Forcing, cfg: Config, mesh: Mesh):
    """(grid, forcing) with every field sharded and padded by the scheme's
    widest halo from the neighbour shards, once."""
    from beom_tpu_torch.parallel import dist

    return dist.pad_statics(grid, forcing, cfg, mesh, shard_halo(cfg))


def _statics_at(pstatics, cfg: Config, w: int):
    """The padded statics cropped to a halo of w."""
    from beom_tpu_torch.parallel import dist

    cut = shard_halo(cfg) - w
    return tuple(dist._crop_tree(a, cut) for a in pstatics)


# ---------------------------------------------------------------- plain

def _fb_plain(h, u, v, pstatics, n: int, t, cfg: Config, k: int):
    w = shard_halo(cfg)
    for i in range(k):
        hp, up, vp = fused_fb.fused_fb_step_plain(
            halo.pad2d(h, w), halo.pad2d(u, w), halo.pad2d(v, w), pstatics,
            n + i, t, cfg, 1)
        h, u, v = halo.crop2d(hp, w), halo.crop2d(up, w), halo.crop2d(vp, w)
        t = advance_time(t, cfg.dt, cfg.npdtype)
    return h, u, v


def split_slow_plain(h, u, v, pstatics, cfg: Config):
    """The slow phase of the split step on the shards: pad2d by its halo,
    split.slow_phase on the padded blocks, crop2d.  Returns SlowPhase's 13
    fields as the kernels pass them (cu, cv as the bottom plane)."""
    w = kernel_halos(cfg)["slow"]
    grid, forcing = _statics_at(pstatics, cfg, w)
    sp = split_mod.slow_phase(State(
        h=halo.pad2d(h, w), u=halo.pad2d(u, w), v=halo.pad2d(v, w), t=0.0,
        n=0), grid, forcing, cfg)
    return [halo.crop2d(a, w) for a in fused_fb._slow_fields(sp, cfg)]


def _slow_phase_of(slow, cfg: Config, pad) -> split_mod.SlowPhase:
    """SlowPhase from the kernels' 13 fields, each through pad(); cu, cv
    back on their layer."""
    f = [pad(a) for a in slow]
    kb = cfg.nz - 1
    return split_mod.SlowPhase(*f[:11], cu=drag._on_layer(f[11], kb, cfg.nz),
                               cv=drag._on_layer(f[12], kb, cfg.nz))


def split_subcycle_plain(slow, pstatics, cfg: Config):
    """The barotropic subcycle on the shards: pad2d of the slow phase's
    fields by nsub, split.subcycle_phase, crop2d.  Returns (eta_f, ubar_f,
    vbar_f, ubar_avg, vbar_avg)."""
    w = kernel_halos(cfg)["subcycle"]
    grid, _ = _statics_at(pstatics, cfg, w)
    sp = _slow_phase_of(slow, cfg, lambda a: halo.pad2d(a, w))
    return [halo.crop2d(a, w)
            for a in split_mod.subcycle_phase(sp, grid, cfg)]


def split_recompose_plain(slow, sub, h, pstatics, t, cfg: Config):
    """split.recompose and fb.finalize on the shards, from time t: pad2d
    of h, the slow phase's and the subcycle's fields by the halo, the eager
    functions on the padded blocks, crop2d.  Returns (h1, u1, v1)."""
    w = kernel_halos(cfg)["recompose"]
    grid, forcing = _statics_at(pstatics, cfg, w)
    sp = _slow_phase_of(slow, cfg, lambda a: halo.pad2d(a, w))
    hp = halo.pad2d(h, w)
    h1, u1, v1 = split_mod.recompose(sp, *[halo.pad2d(a, w) for a in sub],
                                     hp, grid, cfg)
    out = fb_mod.finalize(h1, u1, v1, State(h=hp, u=None, v=None, t=t, n=0),
                          grid, forcing, cfg)
    return tuple(halo.crop2d(a, w) for a in (out.h, out.u, out.v))


def shard_step_plain(h, u, v, pstatics, n: int, t, cfg: Config, k: int):
    """k eager steps of cfg.scheme ('fb' or 'split') on the sharded
    (h, u, v), each kernel's plain version in turn: pad2d by its halo, the
    eager function on the padded blocks, crop2d."""
    if cfg.scheme != "split":
        return _fb_plain(h, u, v, pstatics, n, t, cfg, k)
    for _ in range(k):
        slow = split_slow_plain(h, u, v, pstatics, cfg)
        sub = split_subcycle_plain(slow, pstatics, cfg)
        h, u, v = split_recompose_plain(slow, sub, h, pstatics, t, cfg)
        t = advance_time(t, cfg.dt, cfg.npdtype)
    return h, u, v


def proj_a_plain(h, u, v, pstatics, n: int, cfg: Config):
    """Phase A on the shards: pad2d by its halo, fused_projection's plain
    phase A on the padded blocks, crop2d.  Returns (u*, v*, div)."""
    w = kernel_halos(cfg)["proj_a"]
    statics = _statics_at(pstatics, cfg, w)
    out = fused_projection.proj_a_plain(
        halo.pad2d(h, w), halo.pad2d(u, w), halo.pad2d(v, w), statics, n,
        cfg)
    return tuple(halo.crop2d(a, w) for a in out)


def proj_b_plain(h, u_s, v_s, p, pstatics, t, cfg: Config):
    """Phase B on the shards from time t: pad2d by its halo,
    fused_projection's plain phase B, crop2d.  Returns (h1, u1, v1)."""
    w = kernel_halos(cfg)["proj_b"]
    statics = _statics_at(pstatics, cfg, w)
    out = fused_projection.proj_b_plain(
        *[halo.pad2d(a, w) for a in (h, u_s, v_s, p)], statics, t, cfg)
    return tuple(halo.crop2d(a, w) for a in out)


def split_tend_plain(h, u, v, pstatics, cfg: Config):
    """The slow phase's layer tendencies of the two-launch split step on
    the shards: pad2d by its halo, split.slow_tendencies, crop2d.  Returns
    (du_s, dv_s)."""
    w = kernel_halos(cfg)["slow"]
    grid, forcing = _statics_at(pstatics, cfg, w)
    tend = split_mod.slow_tendencies(State(
        h=halo.pad2d(h, w), u=halo.pad2d(u, w), v=halo.pad2d(v, w), t=0.0,
        n=0), grid, forcing, cfg)
    return [halo.crop2d(a, w) for a in tend]


def split_tail_plain(tend, h, u, v, pstatics, t, cfg: Config):
    """The tail of the two-launch split step on the shards from time t:
    pad2d of h, u, v and the tendencies by the tail's halo (nsub + LO +
    E), split.depth_means and split.fast_phase on the padded blocks,
    crop2d.  Returns (h1, u1, v1)."""
    w = kernel_halos(cfg)["tail"]
    grid, forcing = _statics_at(pstatics, cfg, w)
    s = State(h=halo.pad2d(h, w), u=halo.pad2d(u, w), v=halo.pad2d(v, w),
              t=t, n=0)
    s = split_mod.fast_phase(
        split_mod.depth_means(s, *[halo.pad2d(a, w) for a in tend], grid,
                              cfg), s, grid, forcing, cfg)
    return tuple(halo.crop2d(a, w) for a in (s.h, s.u, s.v))


# ---------------------------------------------------------------- layout

def whole_card(mesh: Mesh) -> Card:
    """The one card of a mesh whose shards all lie on one device."""
    NY, NX = mesh.shape["y"], mesh.shape["x"]
    return Card(mesh.devices[0], tuple(range(mesh.n)), (0, 0), (NY, NX),
                (0, 0))


def _stacked(blocks, base) -> torch.Tensor:
    """The allocation (L.., len(blocks), ly, lx) whose slice q along axis
    -3 is blocks[q]: `base` where the blocks are still its slices, else
    the one they are views of (no copy), else a stacked copy of them."""
    if base is not None:
        # unstack's field: its blocks are still the slices of `base`
        p, step = base.data_ptr(), base.stride(-3) * base.element_size()
        if [b.data_ptr() for b in blocks] \
                == list(range(p, p + base.shape[-3] * step, step)):
            return base
    b0 = blocks[0]
    lead, (ly, lx) = tuple(b0.shape[:-2]), tuple(b0.shape[-2:])
    n, plane = len(blocks), ly * lx
    want = (n * plane,) * len(lead) + (lx, 1)
    store = b0.untyped_storage().data_ptr()
    if all(b.shape == b0.shape and b.dtype == b0.dtype
           and b.device == b0.device and tuple(b.stride()) == want
           and b.untyped_storage().data_ptr() == store
           and b.storage_offset() == b0.storage_offset() + q * plane
           for q, b in enumerate(blocks)):
        return b0.as_strided(lead + (n, ly, lx), want[:-2] + (plane, lx, 1),
                             b0.storage_offset())
    return torch.stack(blocks, dim=-3)


# the key of `stacked` under which unstack keeps a whole mesh's allocation
_WHOLE = "mesh"


def stack_part(a: Sharded, shards) -> torch.Tensor:
    """The allocation (L.., len(shards), ly, lx) whose slice q along axis
    -3 is shard shards[q]'s block of a: the one those blocks are views of
    (no copy), else a stacked copy of them."""
    shards = tuple(shards)
    return _stacked([a.blocks[s] for s in shards],
                    a.__dict__.get("stacked", {}).get(shards))


def stack(a: Sharded) -> torch.Tensor:
    """The allocation (L.., S, ly, lx) whose slice s along axis -3 is
    shard s's block of a: the one a's blocks are views of (no copy), else a
    stacked copy of them."""
    return _stacked(a.blocks, a.__dict__.get("stacked", {}).get(_WHOLE))


def unstack_parts(parts, mesh: Mesh, cards) -> Sharded:
    """The sharded field whose blocks are the slices of the cards' stacked
    parts (part c holds cards[c]'s shards; kept as its `stacked`, which
    stack_part returns without a search)."""
    blocks = [None] * mesh.n
    for part, card in zip(parts, cards):
        if part.shape[-3] != len(card.shards):
            raise ValueError(f"a stacked field of {part.shape[-3]} blocks "
                             f"on a card of {len(card.shards)} shards")
        for s, b in zip(card.shards, part.unbind(-3)):
            blocks[s] = b
    if any(b is None for b in blocks):
        raise ValueError(f"the cards do not cover the mesh of {mesh.n} "
                         "shards")
    out = Sharded(blocks, mesh)
    out.stacked = {card.shards: part for part, card in zip(parts, cards)}
    return out


def unstack(a: torch.Tensor, mesh: Mesh) -> Sharded:
    """The sharded field whose blocks are the slices of the stacked a (kept
    as its `stacked`, which stack returns without a search)."""
    if a.shape[-3] != mesh.n:
        raise ValueError(f"a stacked field of {a.shape[-3]} blocks on a mesh "
                         f"of {mesh.n} shards")
    out = Sharded(a.unbind(-3), mesh)
    out.stacked = {_WHOLE: a}
    return out


def stack_card(a: torch.Tensor, mesh: Mesh, card: Card) -> torch.Tensor:
    """A global field (.., ny, nx) in the stacked layout of a card (..,
    cmy cmx, ly, lx): its rectangle of shards in their mesh order."""
    NY, NX = mesh.shape["y"], mesh.shape["x"]
    lead, (ny, nx) = tuple(a.shape[:-2]), tuple(a.shape[-2:])
    ly, lx = ny // NY, nx // NX
    (j0, i0), (cmy, cmx) = card.origin, card.shape
    a = a[..., j0 * ly:(j0 + cmy) * ly, i0 * lx:(i0 + cmx) * lx]
    return a.reshape(lead + (cmy, ly, cmx, lx)).transpose(-3, -2) \
        .reshape(lead + (cmy * cmx, ly, lx)).contiguous()


def stack_global(a: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A global field (.., ny, nx) in the stacked layout (.., S, ly, lx)."""
    return stack_card(a, mesh, whole_card(mesh))


def stack_offsets(gy, gx, ly: int, lx: int, mx: int):
    """The row and column terms of the stacked offsets of grid rows gy and
    columns gx (in [0, ny), [0, nx)) in one plane: csrc/shard_addr.cuh's
    Stack::row and Stack::col."""
    J, I = gy // ly, gx // lx
    plane = ly * lx
    return J * mx * plane + (gy - J * ly) * lx, I * plane + (gx - I * lx)


def _cls(d, n: int):
    """The card class code of the card d cards along an axis of n cards
    (csrc/shard_addr.cuh: Stack::cls): 0 the card, 1 the next, 2 the
    previous."""
    return torch.where(d == 0, 0, torch.where((d == 1) | (d == 1 - n), 1, 2))


def card_offsets(gy, gx, ly: int, lx: int, card: Card, ncards):
    """Stack::row and Stack::col of a build across cards, for the card
    `card` among ncards = (cy, cx): grid rows gy and columns gx (in [0,
    ny), [0, nx)) as (row class, row term, column class, column term), the
    terms card-local offsets in one plane of the card that holds them; the
    point (gy, gx) lies in the stack of the card of class 3 rc + cc."""
    (cmy, cmx), (a, b) = card.shape, card.place
    plane = ly * lx
    J, I = gy // ly, gx // lx
    C, D = J // cmy, I // cmx
    return (_cls(C - a, ncards[0]),
            (J - C * cmy) * cmx * plane + (gy - J * ly) * lx,
            _cls(D - b, ncards[1]), (I - D * cmx) * plane + (gx - I * lx))


def stack_statics(grid: Grid, forcing: Forcing, mesh: Mesh,
                  card: Card = None):
    """(grid, forcing) of the whole grid with every field stacked (in the
    layout of `card`, default the whole mesh)."""
    card = card or whole_card(mesh)

    def put(tree):
        return type(tree)(**{
            f.name: stack_card(getattr(tree, f.name), mesh, card)
            for f in dataclasses.fields(tree)})
    return put(grid), put(forcing)


def _launch_tiled(fn, fields, statics, cfg: Config, mesh: Mesh, tile, halo,
                  ring: bool = False, dmask: bool = False, cards=None):
    """A launch's schedule on the host, for the tests: for every card
    (`cards`, default the whole mesh as one), every shard of the card and
    each of its tiles of tile = (tx, ty) points (ShardTile's order; ragged
    last tiles where they do not divide the block), the haloed block, halo =
    (lo_y, hi_y, lo_x, hi_x) points around the tile, gathered through the
    card's row and column tables (card_offsets) from the stacks of the
    nine card classes (ring: in a ring of NaN that stands for whatever lies
    past a CTA's block, the staggered masks rebuilt from the block's mask
    where dmask); fn(block fields, block statics, block cfg) on it as a grid
    of its own; the tile's interior points of each result written into the
    card's stacked outputs at the tile's place in its shard's block.
    Without `cards`, fields are stacked tensors and statics one (grid,
    forcing), and the outputs stacked tensors; with them, each field is the
    cards' parts, statics the cards' (grid, forcing), and each output the
    cards' parts."""
    one = cards is None
    if one:
        cards = [whole_card(mesh)]
        fields = [[a] for a in fields]
        statics = [statics]
    classes = card_classes(cards)
    ncards = (1 + max(c.place[0] for c in cards),
              1 + max(c.place[1] for c in cards))
    NY, NX = mesh.shape["y"], mesh.shape["x"]
    ny, nx = cfg.ny, cfg.nx
    ly, lx = ny // NY, nx // NX
    tx, ty = tile
    lo_y, hi_y, lo_x, hi_x = halo
    dev = fields[0][0].device
    e = int(ring)
    outs = None
    for c, card in enumerate(cards):
        nbs = classes[c]

        def cut(parts, idx):
            # the nine classes' stacks, flat per layer, read at idx
            lead = tuple(parts[0].shape[:-3])
            flat = torch.stack([parts[k].reshape(lead + (-1,)) for k in nbs])
            b = flat[(idx[0],) + (slice(None),) * len(lead) + (idx[1],)]
            b = b.movedim(tuple(range(2)), tuple(range(-2, 0))) \
                if lead else b
            if ring:
                b = torch.nn.functional.pad(b, (1, 1, 1, 1),
                                            value=float("nan"))
            return b

        def part(tree, name):
            return [getattr(statics[k][tree], name) for k in range(len(cards))]

        (cmy, cmx), (j0, i0) = card.shape, card.origin
        for q in range(cmy * cmx):
            j, i = j0 + q // cmx, i0 + q % cmx
            for y0 in range(0, ly, ty):
                for x0 in range(0, lx, tx):
                    gy = (j * ly + y0 - lo_y
                          + torch.arange(ty + lo_y + hi_y, device=dev)) % ny
                    gx = (i * lx + x0 - lo_x
                          + torch.arange(tx + lo_x + hi_x, device=dev)) % nx
                    rc, roff, cc, coff = card_offsets(gy, gx, ly, lx, card,
                                                      ncards)
                    idx = (3 * rc[:, None] + cc[None, :],
                           roff[:, None] + coff[None, :])
                    g = {f.name: cut(part(0, f.name), idx)
                         for f in dataclasses.fields(Grid)}
                    if dmask:
                        m = g["mask"]
                        sx, sy = torch.roll(m, -1, -1), torch.roll(m, -1, -2)
                        g.update(mask_u=m * sx, mask_v=m * sy,
                                 mask_q=m * sx * sy * torch.roll(sy, -1, -1))
                    fo = Forcing(**{f.name: cut(part(1, f.name), idx)
                                    for f in dataclasses.fields(Forcing)})
                    sub = dataclasses.replace(cfg, ny=idx[1].shape[0] + 2 * e,
                                              nx=idx[1].shape[1] + 2 * e)
                    res = fn([cut(a, idx) for a in fields],
                             (Grid(**g), fo), sub)
                    if outs is None:
                        outs = [[torch.full(
                            tuple(r.shape[:-2]) + (len(k.shards), ly, lx),
                            float("nan"), dtype=r.dtype, device=dev)
                            for k in cards] for r in res]
                    ye, xe = min(ty, ly - y0), min(tx, lx - x0)
                    for o, r in zip(outs, res):
                        o[c][..., q, y0:y0 + ye, x0:x0 + xe] = \
                            r[..., lo_y + e:lo_y + e + ye,
                              lo_x + e:lo_x + e + xe]
    return [o[0] for o in outs] if one else outs


def fb_launch_tiled(h, u, v, statics, n: int, t, cfg: Config, mesh: Mesh,
                    kb: int, tile, cards=None):
    """The fb pass kernel's launch of kb steps over every shard, on the host
    (_launch_tiled): kb eager fb steps on each tile's block with a halo of
    kb W.  h, u, v and statics (stack_statics) stacked (the cards' parts
    with `cards`); returns the stacked (h, u, v)."""
    w = kb * fused_fb.halo_width(cfg)

    def fn(f, st, c):
        s = State(h=f[0], u=f[1], v=f[2], t=t, n=n)
        for _ in range(kb):
            s = fb_mod.fb_step(s, *st, c)
        return s.h, s.u, s.v
    return _launch_tiled(fn, (h, u, v), statics, cfg, mesh, tile,
                         (w, w, w, w), cards=cards)


def split_launch_tiled(h, u, v, statics, t, cfg: Config, mesh: Mesh,
                       tile, tail_tile, cards=None):
    """Route 2's two launches over every shard, on the host: the slow
    phase's tendencies on tiles of `tile` (halo 2), then the tail on tiles
    of `tail_tile` (halo tail_halo, in a ring of NaN): split.depth_means and
    split.fast_phase on each block.  Stacked in and out; (h, u, v) at
    t + dt."""
    def tend(f, st, c):
        return split_mod.slow_tendencies(
            State(h=f[0], u=f[1], v=f[2], t=0.0, n=0), *st, c)

    du, dv = _launch_tiled(tend, (h, u, v), statics, cfg, mesh, tile,
                           (2, 2, 2, 2), cards=cards)

    def tail(f, st, c):
        s = State(h=f[0], u=f[1], v=f[2], t=t, n=0)
        s = split_mod.fast_phase(split_mod.depth_means(s, f[3], f[4], st[0],
                                                       c), s, *st, c)
        return s.h, s.u, s.v

    w = fused_fb.tail_halo(cfg)
    return _launch_tiled(tail, (h, u, v, du, dv), statics, cfg, mesh,
                         tail_tile, (w, w, w, w), ring=True, cards=cards)


def split3_launch_tiled(h, u, v, statics, t, cfg: Config, mesh: Mesh,
                        tile, sub_tile, cards=None):
    """Route 3's three launches over every shard, on the host, each haloed
    point read from the shard it falls into: the slow phase on tiles of
    `tile` (halo 2; SlowPhase's 13 fields), the subcycle on tiles of
    `sub_tile` (halo nsub), the recomposition with fb.finalize on tiles of
    `tile` (halo LO + 1).  Stacked in and out; (h, u, v) at t + dt."""
    def slow(f, st, c):
        return fused_fb._slow_fields(split_mod.slow_phase(
            State(h=f[0], u=f[1], v=f[2], t=0.0, n=0), *st, c), c)

    sl = _launch_tiled(slow, (h, u, v), statics, cfg, mesh, tile,
                       (2, 2, 2, 2), cards=cards)

    def sub(f, st, c):
        return split_mod.subcycle_phase(_slow_phase_of(f, c, lambda a: a),
                                        st[0], c)

    w = cfg.nsub
    sb = _launch_tiled(sub, sl, statics, cfg, mesh, sub_tile, (w, w, w, w),
                       cards=cards)

    def rec(f, st, c):
        sp = _slow_phase_of(f[:13], c, lambda a: a)
        h1, u1, v1 = split_mod.recompose(sp, *f[13:18], f[18], st[0], c)
        out = fb_mod.finalize(h1, u1, v1, State(h=f[18], u=None, v=None,
                                                 t=t, n=0), *st, c)
        return out.h, out.u, out.v

    w = kernel_halos(cfg)["recompose"]
    return _launch_tiled(rec, list(sl) + list(sb) + [h], statics, cfg, mesh,
                         tile, (w, w, w, w), cards=cards)


def fb_stream_launch_tiled(h, u, v, statics, n: int, t, cfg: Config,
                           mesh: Mesh, tile, cards=None, halos=None):
    """The layer-streamed fb step n's two launches over every shard, on the
    host (_launch_tiled, each block in a ring of NaN): the continuity on
    blocks with the halo LO, then the momentum on blocks with the halo 3
    from h1 read back, a neighbour shard's or card's too
    (fused_fb.fb_stream_launches); `halos` overrides (LO, 3).  Stacked in
    and out (the cards' parts with `cards`): (h1, u1, v1)."""
    cont, mom = fused_fb.fb_stream_launches(n, t, cfg)
    lo, hw = halos or fused_fb.stream_halos(cfg)[:2]
    h1, = _launch_tiled(cont, (h, u, v), statics, cfg, mesh, tile,
                        (lo,) * 4, ring=True, cards=cards)
    return (h1,) + tuple(_launch_tiled(mom, (h1, u, v), statics, cfg, mesh,
                                       tile, (hw,) * 4, ring=True,
                                       cards=cards))


def split_stream_launch_tiled(h, u, v, statics, t, cfg: Config, mesh: Mesh,
                              tile, sub_tile, cards=None, halos=None):
    """The layer-streamed split step's launches over every shard, on the
    host (fused_fb.split_stream_launches, each block in a ring of NaN): the
    slow phase on blocks with the halo 2, route 3's subcycle on tiles of
    `sub_tile` (halo nsub), the recomposition's continuity on blocks with
    the halo LO and its velocities on blocks with the halo 1, each reading
    what the launch before wrote at its neighbour shards' and cards'
    points; `halos` overrides (2, LO, 1).  Stacked in and out: ((h1, u1,
    v1), SlowPhase's 13 fields)."""
    slow_l, rec_h, rec_uv = fused_fb.split_stream_launches(t, cfg)
    hw, lo, hv = halos or fused_fb.stream_halos(cfg)[2:]
    sl = _launch_tiled(slow_l, (h, u, v), statics, cfg, mesh, tile,
                       (hw,) * 4, ring=True, cards=cards)

    def sub(f, st, c):
        return split_mod.subcycle_phase(_slow_phase_of(f, c, lambda a: a),
                                        st[0], c)

    w = cfg.nsub
    eta_f, ub_f, vb_f, ub_a, vb_a = _launch_tiled(
        sub, sl, statics, cfg, mesh, sub_tile, (w, w, w, w), cards=cards)
    h1, = _launch_tiled(rec_h, (h, sl[0], sl[1], ub_a, vb_a, eta_f), statics,
                        cfg, mesh, tile, (lo,) * 4, ring=True, cards=cards)
    u1, v1 = _launch_tiled(rec_uv, (h1, sl[0], sl[1], sl[2], sl[3], sl[11],
                                    sl[12], ub_f, vb_f), statics, cfg, mesh,
                           tile, (hv,) * 4, ring=True, cards=cards)
    return (h1, u1, v1), sl


def proj_a_launch_tiled(h, u, v, statics, n: int, cfg: Config, mesh: Mesh,
                        tile, dmask: bool, staged: bool = True, cards=None):
    """Phase A over every shard, on the host: proj_a_plain on each tile's
    block; staged, 4 points below and 3 above the tile on both axes, in a
    ring of NaN; single-step, 4 points around it.  Stacked in and out:
    (u*, v*, div)."""
    return _launch_tiled(
        lambda f, st, c: fused_projection.proj_a_plain(*f, st, n, c),
        (h, u, v), statics, cfg, mesh, tile,
        (4, 3, 4, 3) if staged else (4, 4, 4, 4), ring=staged,
        dmask=dmask and staged, cards=cards)


def proj_b_launch_tiled(h, u_s, v_s, p, statics, t, cfg: Config,
                        mesh: Mesh, tile, dmask: bool, staged: bool = True,
                        cards=None):
    """Phase B over every shard, on the host: proj_b_plain on each tile's
    block, halo_b points around the tile on y and, staged, 4 on x in a ring
    of NaN; single-step, halo_b on x.  Stacked in and out: (h1, u1,
    v1)."""
    w = fused_projection.halo_b(cfg)
    return _launch_tiled(
        lambda f, st, c: fused_projection.proj_b_plain(*f, st, t, c),
        (h, u_s, v_s, p), statics, cfg, mesh, tile,
        (w, w, 4, 4) if staged else (w, w, w, w), ring=staged,
        dmask=dmask and staged, cards=cards)


# ---------------------------------------------------------------- plan

@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """How the shard kernels run cfg at `dtype` on a mesh of (ly, lx)
    blocks: the single-device kernels' plans (fused_fb.plan, split_plan,
    fused_projection.plan), with the fb pass kernel's steps per launch at
    most max_kb, the most whose halo kb W a neighbour's block holds;
    `off_smem` forces the single-step bodies off shared memory (their
    layers streamed) where a tile fits them too."""
    cfg: Config
    dtype: torch.dtype
    ly: int
    lx: int
    off_smem: bool = False

    @property
    def max_kb(self) -> int:
        return max(1, min(self.ly, self.lx) // fused_fb.halo_width(self.cfg))

    def kb(self, k: int) -> int:
        """Steps per launch of a pass of k fb steps."""
        return min(fused_fb.plan(self.cfg, self.dtype, k,
                                 self.off_smem).kb,
                   self.max_kb)

    @property
    def streamed(self) -> bool:
        """Whether the scheme's single-step kernels stream their layers, as
        the single-device plans have them: K1's single step
        (fused_fb.launch_plan), the split step's slow phase and
        recomposition (fused_fb.split_plan), the projection phases
        (fused_projection.plan)."""
        if self.cfg.scheme in _PROJECTION:
            return self.phases.stream
        if self.cfg.scheme == "split":
            return self.split.stream
        return fused_fb.launch_plan(self.cfg, self.dtype, 1,
                                    self.off_smem).stream

    def fb_launches(self, k: int) -> list:
        """Steps of each launch of a pass of k fb steps."""
        return fused_fb.launch_steps(k, self.kb(k))

    @property
    def split(self) -> fused_fb.SplitPlan:
        """The single-device split plan whose route, tail and streamed
        kernels the shard kernels take."""
        return fused_fb.split_plan(self.cfg, self.dtype, self.off_smem)

    @property
    def phases(self) -> fused_projection.PhasePlan:
        return fused_projection.plan(self.cfg, self.dtype, self.off_smem)

    def launches(self, k: int = None) -> dict:
        """Launches of each kind for one call of the stepper (a pass of k
        steps, default steps_per_pass; one projection step)."""
        k = k or self.cfg.steps_per_pass
        if self.cfg.scheme == "fb":
            m = self.fb_launches(k)
            return {"fb": len(m), "fb_pass": sum(x > 1 for x in m)}
        if self.cfg.scheme == "split":
            if self.split.route == 2:
                return {"split_tend": k, "split_tail": k}
            return {f"split_{x}": k for x in ("slow", "subcycle",
                                              "recompose")}
        return {"proj_a": 1, "proj_b": 1}

    def describe(self) -> str:
        lead = f"blocks of {self.ly} x {self.lx}, one launch per kernel " \
               "for every shard"
        if self.cfg.scheme == "fb":
            k = self.cfg.steps_per_pass
            kb = self.kb(k)
            pl = fused_fb.launch_plan(self.cfg, self.dtype, kb,
                                      self.off_smem)
            return f"{lead}; fb: {pl.describe()}; launches of a {k}-step " \
                   f"pass: {self.fb_launches(k)}"
        if self.cfg.scheme == "split":
            return f"{lead}; split: {self.split.describe()}"
        from beom_tpu_torch.parallel.dist import pressure_lam
        from beom_tpu_torch.stencils import mesh_solve

        solve = mesh_solve.describe(
            self.cfg, (self.cfg.ny // self.ly, self.cfg.nx // self.lx),
            pressure_lam(self.cfg))
        # the mesh forms the solve's right-hand side in torch on the
        # shards (phase A has no epilogue there)
        phases = dataclasses.replace(self.phases, rhs=False).describe()
        return f"{lead}; projection: {phases}; solve: {solve}"


@functools.lru_cache(maxsize=None)
def _mesh_plan(cfg: Config, dtype, ly: int, lx: int,
               off_smem: bool) -> MeshPlan:
    return MeshPlan(cfg, dtype, ly, lx, off_smem)


def mesh_plan(cfg: Config, dtype, mesh: Mesh,
              off_smem: bool = False) -> MeshPlan:
    """The MeshPlan of cfg on `mesh` (check_mesh's blocks); off_smem=True
    forces the layer-streamed kernels where the single-step bodies would
    fit shared memory too."""
    check_config(cfg)
    return _mesh_plan(cfg, dtype or cfg.tdtype, *check_mesh(cfg, mesh),
                      bool(off_smem))


def check_mesh(cfg: Config, mesh: Mesh):
    """(ly, lx) of a shard's block; raise if it cannot hold the widest halo
    the scheme's kernels read (for split, the tail's nsub + LO + E)."""
    NY, NX = mesh.shape["y"], mesh.shape["x"]
    ly, lx = cfg.ny // NY, cfg.nx // NX
    w = shard_halo(cfg)
    if ly < w or lx < w:
        raise ValueError(
            f"local block of ({ly}, {lx}) points cannot hold the {w}-point "
            f"halo of the {cfg.scheme} shard kernels; use fewer shards or a "
            "larger grid")
    if ly * NY != cfg.ny or lx * NX != cfg.nx:
        raise ValueError(f"({cfg.ny}, {cfg.nx}) does not divide over the "
                         f"({NY}, {NX}) mesh")
    return ly, lx


# ---------------------------------------------------------------- kernels

def build_spec(cfg: Config, dtype=None, kb: int = 1, dmask: bool = False,
               cards: bool = False, off_smem: bool = False):
    """(source, defines) of a build that runs cfg on shards: csrc/
    shard_step.cu (the single-step kernel or its layer-streamed pair, or
    at kb > 1 the pass kernel of kb steps), shard_split.cu or
    shard_projection.cu, with the switches, tiles, geometries and routes
    of the single-device kernels' builds (dmask: the staged phases rebuild
    the staggered masks; cards: the build for a mesh over several cards,
    BEOM_CARDS = 1; off_smem: force the layer-streamed kernels, which the
    plans take anyway where no tile fits the single-step bodies)."""
    check_config(cfg)
    if cfg.scheme in _PROJECTION:
        name, defines = "shard_projection", fused_projection.build_spec(
            cfg, dtype, fused_projection.plan(cfg, dtype, off_smem),
            dmask)[1]
    elif cfg.scheme == "split":
        name, defines = "shard_split", fused_fb.build_spec(
            cfg, dtype, off_smem=off_smem)[1]
    else:
        name, defines = "shard_step", fused_fb.build_spec(
            cfg, dtype, kb, off_smem=off_smem)[1]
    return name, tuple(defines) + (("BEOM_CARDS=1",) if cards else ())


def build_specs(cfg: Config, dtype, mesh: Mesh, dmask: bool = False,
                cards: bool = False, off_smem: bool = False) -> set:
    """Every build a stepper of cfg on `mesh` launches (its passes of
    steps_per_pass steps and, for run()'s remainder, of one)."""
    if cfg.scheme != "fb":
        return {build_spec(cfg, dtype, dmask=dmask, cards=cards,
                           off_smem=off_smem)}
    pl = mesh_plan(cfg, dtype, mesh, off_smem)
    steps = set(pl.fb_launches(cfg.steps_per_pass)) | {1}
    return {build_spec(cfg, dtype, m, cards=cards, off_smem=off_smem)
            for m in steps}


def _want_smem(cfg: Config, name: str, defines, elem: int, kb: int):
    """Shared memory per CTA of each kernel of a build, by the index of its
    beom_smem_bytes: the single-device kernels' counts, with offsets of 8
    bytes in a build across cards."""
    value = {d.split("=")[0]: int(d.split("=")[1]) for d in defines}
    off = 8 if value.get("BEOM_CARDS") else 4
    stream = bool(value.get("BEOM_STREAM"))
    tile = (value["BEOM_TX"], value["BEOM_TY"])
    if name == "shard_step":
        if kb > 1:
            return [fused_fb.pass_smem(cfg, kb, tile, elem, off)]
        if stream:
            want = fused_fb.stream_smem(cfg, tile, elem, off)
            return [want["fb_momentum"], want["fb_continuity"]]
        return [fused_fb.smem_bytes(cfg, tile, tile, elem,
                                    off=off)["fb_step"]]
    if name == "shard_split":
        want = fused_fb.smem_bytes(
            cfg, tile, (value["BEOM_SX"], value["BEOM_SY"]), elem,
            (value["BEOM_QX"], value["BEOM_QS"], value["BEOM_QP"]), off)
        if stream:
            want.update(fused_fb.split_stream_smem(cfg, tile, elem, off))
            return [want[k] for k in _SPLIT_STREAMED]
        return [want[f"split_{k}"] for k in _SPLIT]
    geo = fused_projection.Geometry
    want = (fused_projection.stream_smems if value.get("BEOM_STREAM")
            else fused_projection.smem_bytes)(cfg, tile, elem, off)
    want.update(fused_projection.staged_smem(
        cfg, geo(value["BEOM_ATX"], value["BEOM_ATY"], value["BEOM_ANT"]),
        geo(value["BEOM_BTX"], value["BEOM_BTY"], value["BEOM_BNT"]), elem,
        off))
    return [want[k] for k in _PHASES]


# each entry's argument types: the operand table, ints, dbls, geom, then
# its own (csrc/shard_*.cu)
_ARGTYPES = {
    "step": [_P] * 8, "fb_cont": [_P] * 6, "fb_mom": [_P] * 8,
    "split_slow": [_P] * 6, "split_tend": [_P] * 6,
    "split_subcycle": [_P] * 7, "split_recompose": [_P] * 10,
    "split_rec_h": [_P] * 8, "split_rec_uv": [_P] * 10,
    "split_tail": [_P] * 9,
    "proj_a": [_P] * 8, "proj_as": [_P] * 8,
    "proj_b": [_P] * 5 + [ctypes.c_double] + [_P] * 4,
    "proj_bs": [_P] * 5 + [ctypes.c_double] + [_P] * 4}


@functools.lru_cache(maxsize=None)
def _entry(cfg: Config, dtype, kb: int = 1, dmask: bool = False,
           cards: bool = False, off_smem: bool = False):
    """(library, entry points by kernel) of build_spec(cfg, dtype, kb,
    dmask, cards, off_smem), built on first use and checked against the
    single-device kernels' shared memory and the wrapper's halos."""
    name, defines = build_spec(cfg, dtype, kb, dmask, cards, off_smem)
    lib = build.load((name, defines))
    elem = torch.empty((), dtype=dtype).element_size()
    for i, want in enumerate(_want_smem(cfg, name, defines, elem, kb)):
        have = lib.beom_smem_bytes(i, int(elem == 8))
        if have != want:
            raise RuntimeError(f"{name}: kernel {i}'s shared memory ({have} "
                               f"bytes) is not the single-device kernel's "
                               f"({want})")
    halos = kernel_halos(cfg)
    stream = "BEOM_STREAM=1" in defines
    if name == "shard_step":
        keys = ("fb_cont", "fb_mom") if stream and kb == 1 else ("step",)
        ok = lib.beom_shard_halo() == kb * halos["fb"]
    elif name == "shard_split":
        keys = tuple(f"split_{k}" for k in (
            ("slow", "tend", "subcycle", "rec_h", "rec_uv", "tail") if stream
            else ("slow", "tend", "subcycle", "recompose", "tail")))
        ok = all(lib.beom_kernel_halo(i) == halos[k]
                 for i, k in enumerate(_SPLIT))
    else:
        keys = _PHASES
        ok = all(lib.beom_kernel_halo(i) == halos[k]
                 for i, k in enumerate(("proj_a", "proj_b")))
    if not ok:
        raise RuntimeError(f"{name}: the kernels' halos are not the "
                           "wrapper's")
    fns = {}
    for key in keys:
        sym = {"step": "shard_step"}.get(key, f"shard_{key}")
        fn = getattr(lib, f"beom_{sym}_{fused_fb._SUFFIX[dtype]}")
        fn.argtypes, fn.restype = _ARGTYPES[key], _I
        fns[key] = fn
    return lib, fns


def _global_masks(statics) -> bool:
    """fused_projection.derived_masks of the whole grid's masks."""
    from beom_tpu_torch.parallel.mesh import gather

    grid = statics[0]
    return fused_projection.derived_masks(Grid(**{
        f.name: gather(getattr(grid, f.name))
        for f in dataclasses.fields(Grid)}))


def _cards_of(mesh: Mesh, cards) -> list:
    """The cards a MeshKernels launches on (default the mesh's own),
    checked: they cover the mesh, each shard once, on its shard's device,
    rectangles of one shape in their grid's row-major order."""
    if cards is None:
        return list(mesh.cards)
    cards = list(cards)
    seen = sorted(s for c in cards for s in c.shards)
    if seen != list(range(mesh.n)):
        raise ValueError(f"the cards hold the shards {seen}, not each of "
                         f"the mesh's {mesh.n} once")
    shapes = {c.shape for c in cards}
    NX = mesh.shape["x"]
    for c in cards:
        (j0, i0), (cmy, cmx) = c.origin, c.shape
        want = tuple((j0 + q // cmx) * NX + i0 + q % cmx
                     for q in range(cmy * cmx))
        if c.shards != want or len(shapes) > 1 \
                or c.place != (j0 // cmy, i0 // cmx):
            raise ValueError(f"card {c} is not a rectangle of the mesh's "
                             "shards of the cards' one shape")
        if any(mesh.devices[s] != _with_index(torch.device(c.device))
               for s in c.shards):
            raise ValueError(f"card {c} names another device than its "
                             "shards'")
    if [c.place for c in cards] != sorted(c.place for c in cards):
        raise ValueError("the cards must come in row-major order of their "
                         "grid")
    return cards


class MeshKernels:
    """The shard kernels of cfg on the shards of `mesh`, which lie on CUDA
    devices: each kernel one launch per card over the card's shards (the
    mesh's cards: the shards of one device, parallel/mesh.py card_groups),
    on the card's stream.  `statics` is (grid, forcing) of the whole grid,
    or of the shards (unpadded sharded fields); they are stacked once per
    card over its shards, with the operand table and scalar slots
    (fused_fb.Operands) and the geometry.  Every field a method takes or
    returns is stacked: one tensor (`stack`) on one card, the cards' parts
    (`stack_part` of each card's shards) on several.

    Several cards launch the build with BEOM_CARDS = 1, whose kernels read a
    neighbour card's stacks through their pointers (peer access, enabled
    here); one card launches the build without it.  `cards` is for the
    tests and the chip check alone: it splits the shards of one device into
    several cards, each its own stacks, the first launching on the device's
    current stream and each other on a side stream of its own.

    The order across cards is parallel/mesh.py's CardStreams.  `pl` is the
    MeshPlan to launch by (default: mesh_plan's), as mesh_plan(...,
    off_smem=True) gives it to force the layer-streamed kernels."""

    def __init__(self, statics, cfg: Config, mesh: Mesh, dtype=None,
                 cards=None, pl: Optional[MeshPlan] = None):
        check_config(cfg)
        self.cfg, self.mesh = cfg, mesh
        kind = device_type(mesh)
        if kind != "cuda":
            raise NotImplementedError(
                f"the shard kernels run on cuda or cpu, not {kind}")
        self.cards = _cards_of(mesh, cards)
        self.multi = len(self.cards) > 1
        self.classes = card_classes(self.cards)
        self.dev = self.cards[0].device
        if self.multi:
            build.enable_peers(check_peers(self.cards))
        self.dtype = dtype or cfg.tdtype
        if self.dtype not in fused_fb._SUFFIX or self.dtype != cfg.tdtype:
            raise ValueError(f"shard kernels: dtype {self.dtype} with "
                             f"cfg.dtype {cfg.dtype}")
        self.plan = mesh_plan(cfg, self.dtype, mesh, pl and pl.off_smem)
        if pl is not None and pl != self.plan:
            raise ValueError(f"the plan {pl} is not one of cfg on this mesh")
        self.ly, self.lx = self.plan.ly, self.plan.lx
        self.dmask = cfg.scheme in _PROJECTION and _global_masks(statics)
        cy = 1 + max(c.place[0] for c in self.cards)
        cx = 1 + max(c.place[1] for c in self.cards)
        self.ops, self._ops, self.geom = [], [], []
        self._devs = [torch.device(c.device) for c in self.cards]
        self._blocks = [(len(c.shards), self.ly, self.lx) for c in self.cards]
        for c in self.cards:
            with torch.cuda.device(c.device):
                ops = [stack_card(a, mesh, c).to(c.device)
                       if isinstance(a, torch.Tensor)
                       else stack_part(a, c.shards)
                       for a in fused_fb._operands(statics)]
            for a in ops:
                self._check("a static", a, a.shape[:-3], len(self.ops))
            self.ops.append(ops)
            self._ops.append(fused_fb.Operands(ops, cfg))
            self.geom.append((_I * 8)(self.ly, self.lx, *c.shape, cy, cx,
                                      *c.place))
        self.order = CardStreams(self.cards) if self.multi else None
        self._fn = {}

    def _check(self, what, a, lead, c: int):
        """Raise unless a is card c's part of a stacked field."""
        shape = tuple(lead) + self._blocks[c]
        if a.device != self._devs[c] or a.dtype != self.dtype \
                or not a.is_contiguous() or tuple(a.shape) != shape:
            raise ValueError(
                f"shard kernels: {what} must be a contiguous {self.dtype} "
                f"tensor of {shape} on {self._devs[c]}, not {a.dtype} "
                f"{tuple(a.shape)} on {a.device}")

    def stack(self, a: Sharded):
        """A sharded field in the layout the methods take."""
        if not self.multi:
            return stack(a)
        return [stack_part(a, c.shards) for c in self.cards]

    def unstack(self, a, mesh: Mesh) -> Sharded:
        """The sharded field of a method's stacked result."""
        if not self.multi:
            return unstack(a, mesh)
        return unstack_parts(a, mesh, self.cards)

    def _parts(self, a) -> list:
        return list(a) if self.multi else [a]

    def _whole(self, parts):
        return parts if self.multi else parts[0]

    def fns(self, kb: int = 1):
        """(library, entry points) of the build of kb fb steps per launch
        (the scheme's build otherwise)."""
        if kb not in self._fn:
            self._fn[kb] = _entry(self.cfg, self.dtype, kb, self.dmask,
                                  self.multi,
                                  self.plan.off_smem and kb == 1)
        return self._fn[kb]

    def _table(self, c: int, fields) -> ctypes.Array:
        """The stacked fields' pointers as card c's kernels take them: on
        one card each field's, across cards each field's in the card of
        each class, class after class."""
        if not self.multi:
            return fused_fb._pointers([f[0] for f in fields])
        return fused_fb._array(_P, [f[k].data_ptr() for k in self.classes[c]
                                    for f in fields])

    def _field(self, c: int, f):
        """One stacked field (the cards' parts) as card c's kernels take a
        field they read back at their blocks' points (csrc/shard_addr.cuh:
        field_of): its stack on one card, a table of its nine across
        cards."""
        return self._table(c, [f]) if self.multi else f[0].data_ptr()

    def _round(self, kb: int, key: str, parity: int, fields, args,
               t1=0.0, ts=(), reads=(), count: bool = True):
        """One launch of entry `key` of the build of kb steps (or the
        scheme's) per card, counted under its LAUNCHES kind (unless
        `count` is false: the second launch of a streamed step or
        recomposition) and, in a streamed build, its STREAM_LAUNCHES kind.
        fields: the stacked fields in the operand table (h, u, v; every one
        counts for the aligned switch), each as the cards' parts; reads:
        the other stacked fields the launch reads; args(c): card c's
        arguments from its geometry up to the stream."""
        lib, fn = self.fns(kb)
        entry = fn[key]
        nz = (self.cfg.nz,)
        for f in fields[:3]:
            for c, a in enumerate(f):
                self._check("h, u, v", a, nz, c)
        kind = _KIND.get(key, key)
        streamed = self.plan.streamed and key in _STREAMED

        def counted():
            LAUNCHES[kind] += count
            if streamed:
                STREAM_LAUNCHES[_STREAMED[key]] += 1

        if not self.multi:
            ptrs, ints, dbls = self._ops[0].set(
                parity, [f[0] for f in fields], t1, ts)
            code = entry(ptrs, ints, dbls, *args(0),
                         torch.cuda.current_stream(self.dev).cuda_stream)
            if code:
                build.check(lib, code, f"shard {key} kernel launch")
            counted()
            return
        aligned = all(ops._aligned for ops in self._ops) and all(
            a.data_ptr() % 16 == 0 for f in fields for a in f)
        streams = self.order.before(list(fields) + list(reads), self.ops)
        sets = [ops.set(parity, [f[c] for f in fields], t1, ts,
                        aligned=aligned)
                for c, ops in enumerate(self._ops)]
        for c, card in enumerate(self.cards):
            ptrs = fused_fb._array(_P, [x for k in self.classes[c]
                                        for x in sets[k][0]])
            with build.on_device(torch.device(card.device)):
                code = entry(ptrs, sets[c][1], sets[c][2], *args(c),
                             streams[c].cuda_stream)
            if code:
                build.check(lib, code, f"shard {key} kernel launch on "
                            f"{card.device}")
            counted()
        self.order.after()

    def _planes(self, n: int):
        """n stacked planes of (S_c, ly, lx) per card: n lists of the
        cards' parts."""
        return [[torch.empty(b, dtype=self.dtype, device=d)
                 for b, d in zip(self._blocks, self._devs)]
                for _ in range(n)]

    @staticmethod
    def _like(n: int, parts):
        """n stacked fields shaped as `parts` (the cards' parts)."""
        return [[torch.empty_like(a) for a in parts] for _ in range(n)]

    def fb(self, h, u, v, n: int, t, k: int, kb: int = None):
        """k fb steps from step n at time t: the plan's launches (kb steps
        per launch where given)."""
        steps = fused_fb.launch_steps(k, kb) if kb else \
            self.plan.fb_launches(k)
        f = [self._parts(a) for a in (h, u, v)]
        for m in steps:
            ts = fused_fb._times(t, self.cfg, m)
            outs = self._like(3, f[0])
            if m == 1 and self.plan.streamed:
                # the continuity into h1, then the momentum reading it back
                # at its blocks' points, a neighbour card's too
                h1, u1, v1 = outs
                self._round(1, "fb_cont", n % 2, f,
                            lambda c: [self.geom[c], h1[c].data_ptr()],
                            ts[0], ts)
                self._round(1, "fb_mom", n % 2, f,
                            lambda c: [self.geom[c], self._field(c, h1),
                                       u1[c].data_ptr(), v1[c].data_ptr()],
                            ts[0], ts, reads=[h1], count=False)
            else:
                self._round(m, "step", n % 2, f,
                            lambda c: [self.geom[c]] + [o[c].data_ptr()
                                                        for o in outs],
                            ts[0], ts)
            LAUNCHES["fb_pass"] += (m > 1) * len(self.cards)
            f = outs
            n, t = n + m, ts[-1]
        return tuple(self._whole(a) for a in f)

    def tend(self, h, u, v):
        """The slow phase's layer tendencies (du_s, dv_s)."""
        f = [self._parts(a) for a in (h, u, v)]
        outs = self._like(2, f[0])
        self._round(1, "split_tend", 0, f,
                    lambda c: [self.geom[c],
                               fused_fb._pointers([o[c] for o in outs])])
        return [self._whole(o) for o in outs]

    def tail(self, tend, h, u, v, t1):
        """The tail of the two-launch split step: (h, u, v) at t1."""
        td = [self._parts(a) for a in tend]
        for a in td:
            for c, x in enumerate(a):
                self._check("du_s, dv_s", x, (self.cfg.nz,), c)
        f = [self._parts(a) for a in (h, u, v)] + td
        outs = self._like(3, f[0])
        self._round(1, "split_tail", 0, f,
                    lambda c: [self.geom[c], self._table(c, td)]
                    + [o[c].data_ptr() for o in outs], t1)
        return [self._whole(o) for o in outs]

    def slow(self, h, u, v):
        """The slow phase: SlowPhase's 13 fields, cu and cv as the bottom
        plane."""
        f = [self._parts(a) for a in (h, u, v)]
        outs = self._like(4, f[0]) + self._planes(9)
        self._round(1, "split_slow", 0, f,
                    lambda c: [self.geom[c],
                               fused_fb._pointers([o[c] for o in outs])])
        return [self._whole(o) for o in outs]

    def _slow_parts(self, slow):
        nz = (self.cfg.nz,)
        sl = [self._parts(a) for a in slow]
        for i, a in enumerate(sl):
            for c, x in enumerate(a):
                self._check(f"slow phase field {i}", x, nz if i < 4 else (),
                            c)
        return sl

    def subcycle(self, slow, h, u, v):
        """(eta_f, ubar_f, vbar_f, ubar_avg, vbar_avg) from slow's 13
        fields."""
        sl = self._slow_parts(slow)
        outs = self._planes(5)
        self._round(1, "split_subcycle", 0,
                    [self._parts(a) for a in (h, u, v)],
                    lambda c: [self.geom[c], self._table(c, sl),
                               fused_fb._pointers([o[c] for o in outs])],
                    reads=sl)
        return [self._whole(o) for o in outs]

    def recompose(self, slow, sub, h, u, v, t1):
        """The recomposition and fb.finalize: (h, u, v) at t1."""
        sl = self._slow_parts(slow)
        sb = [self._parts(a) for a in sub]
        for i, a in enumerate(sb):
            for c, x in enumerate(a):
                self._check(f"subcycle field {i}", x, (), c)
        f = [self._parts(a) for a in (h, u, v)]
        outs = self._like(3, f[0])
        if not self.plan.streamed:
            self._round(1, "split_recompose", 0, f,
                        lambda c: [self.geom[c], self._table(c, sl),
                                   self._table(c, sb)]
                        + [o[c].data_ptr() for o in outs], t1, reads=sl + sb)
            return [self._whole(o) for o in outs]
        # the continuity and the rescale into h1, then the velocities
        # reading it back at their blocks' points, a neighbour card's too
        h1, u1, v1 = outs
        self._round(1, "split_rec_h", 0, f,
                    lambda c: [self.geom[c], self._table(c, sl),
                               self._table(c, sb), h1[c].data_ptr()], t1,
                    reads=sl + sb)
        self._round(1, "split_rec_uv", 0, f,
                    lambda c: [self.geom[c], self._table(c, sl),
                               self._table(c, sb), self._field(c, h1),
                               u1[c].data_ptr(), v1[c].data_ptr()], t1,
                    reads=sl + sb + [h1], count=False)
        return [self._whole(o) for o in outs]

    def split(self, h, u, v, t, k: int):
        """k split steps from time t by the plan's route."""
        two = self.plan.split.route == 2
        for _ in range(k):
            t1 = advance_time(t, self.cfg.dt, self.cfg.npdtype)
            if two:
                h, u, v = self.tail(self.tend(h, u, v), h, u, v, t1)
            else:
                slow = self.slow(h, u, v)
                sub = self.subcycle(slow, h, u, v)
                h, u, v = self.recompose(slow, sub, h, u, v, t1)
            t = t1
        return h, u, v

    def step(self, h, u, v, n: int, t, k: int):
        """k steps of cfg.scheme ('fb' or 'split')."""
        if self.cfg.scheme == "fb":
            return self.fb(h, u, v, n, t, k)
        return self.split(h, u, v, t, k)

    def proj_a(self, h, u, v, n: int):
        """Phase A of step n: (u*, v*, div)."""
        f = [self._parts(a) for a in (h, u, v)]
        outs = self._like(2, f[0]) + self._planes(1)
        key = "proj_a" if self.plan.phases.a is None else "proj_as"
        self._round(1, key, n % 2, f,
                    lambda c: [self.geom[c]] + [o[c].data_ptr()
                                                for o in outs])
        return tuple(self._whole(o) for o in outs)

    def proj_b(self, h, u_s, v_s, p, t):
        """Phase B of the step from time t: (h1, u1, v1)."""
        ps = self._parts(p)
        for c, x in enumerate(ps):
            self._check("p", x, (), c)
        f = [self._parts(a) for a in (h, u_s, v_s)] + [ps]
        outs = self._like(3, f[0])
        t1 = advance_time(t, self.cfg.dt, self.cfg.npdtype)
        key = "proj_b" if self.plan.phases.b is None else "proj_bs"
        corr = fused_projection._corr(self.cfg)
        self._round(1, key, 0, f,
                    lambda c: [self.geom[c], self._field(c, ps), corr]
                    + [o[c].data_ptr() for o in outs], t1)
        return tuple(self._whole(o) for o in outs)


def _k(K: Optional[MeshKernels]) -> MeshKernels:
    """K, the MeshKernels the caller holds for CUDA blocks."""
    if K is None:
        raise ValueError("CUDA blocks launch through the MeshKernels of "
                         "their mesh: pass kernels=MeshKernels(...)")
    return K


def _run(K: MeshKernels, method: str, *args):
    """K.method(*args) with K's first device current (a launch on one
    card takes its stream; several cards switch device per launch)."""
    with build.on_device(torch.device(K.dev)):
        return getattr(K, method)(*args)


# Each wrapper takes `kernels`: None for CPU blocks (the plain version,
# from pstatics, pad_statics' (grid, forcing)), the MeshKernels of the
# blocks' mesh for CUDA blocks (the kernels; pstatics is then not read).

def shard_step(h, u, v, pstatics, n: int, t, cfg: Config, k: int, *,
               kernels: Optional[MeshKernels]):
    """Advance the sharded (h, u, v) by k steps of cfg.scheme ('fb' or
    'split') from step n at time t: on CUDA blocks one launch per kernel
    for every shard (`mesh_plan`)."""
    if h.device.type == "cpu":
        return shard_step_plain(h, u, v, pstatics, n, t, cfg, k)
    if cfg.scheme not in ("fb", "split"):
        raise ValueError("shard_step takes scheme='fb' or 'split'; the "
                         "projection schemes step through "
                         "make_dist_fused_projection_stepper")
    out = _run(kernels, "step", _k(kernels).stack(h), _k(kernels).stack(u),
               _k(kernels).stack(v), n, t, k)
    return tuple(kernels.unstack(a, h.mesh) for a in out)


def shard_split_tend(h, u, v, pstatics, cfg: Config, *, kernels):
    """The slow phase's layer tendencies of the two-launch split step on the
    shards: (du_s, dv_s)."""
    if h.device.type == "cpu":
        return split_tend_plain(h, u, v, pstatics, cfg)
    out = _run(kernels, "tend", _k(kernels).stack(h), _k(kernels).stack(u),
               _k(kernels).stack(v))
    return [kernels.unstack(a, h.mesh) for a in out]


def shard_split_tail(tend, h, u, v, pstatics, t, cfg: Config, *, kernels):
    """The tail of the two-launch split step on the shards from time t:
    (h1, u1, v1)."""
    if h.device.type == "cpu":
        return split_tail_plain(tend, h, u, v, pstatics, t, cfg)
    out = _run(kernels, "tail", [_k(kernels).stack(a) for a in tend],
               _k(kernels).stack(h), _k(kernels).stack(u),
               _k(kernels).stack(v),
               advance_time(t, cfg.dt, cfg.npdtype))
    return tuple(kernels.unstack(a, h.mesh) for a in out)


def shard_split_slow(h, u, v, pstatics, cfg: Config, *, kernels):
    """The slow phase of the split step on the shards: SlowPhase's 13
    fields as sharded fields (cu, cv as the bottom plane)."""
    if h.device.type == "cpu":
        return split_slow_plain(h, u, v, pstatics, cfg)
    out = _run(kernels, "slow", _k(kernels).stack(h), _k(kernels).stack(u),
               _k(kernels).stack(v))
    return [kernels.unstack(a, h.mesh) for a in out]


def shard_split_subcycle(slow, pstatics, cfg: Config, *, kernels):
    """The barotropic subcycle on the shards from the slow phase's 13
    sharded fields: (eta_f, ubar_f, vbar_f, ubar_avg, vbar_avg)."""
    if slow[0].device.type == "cpu":
        return split_subcycle_plain(slow, pstatics, cfg)
    f = [_k(kernels).stack(a) for a in slow]
    out = _run(kernels, "subcycle", f, f[0], f[0], f[0])
    return [kernels.unstack(a, slow[0].mesh) for a in out]


def shard_split_recompose(slow, sub, h, pstatics, t, cfg: Config, *,
                          kernels):
    """The recomposition with fb.finalize on the shards, from time t:
    (h1, u1, v1)."""
    if h.device.type == "cpu":
        return split_recompose_plain(slow, sub, h, pstatics, t, cfg)
    hs = _k(kernels).stack(h)
    out = _run(kernels, "recompose",
               [_k(kernels).stack(a) for a in slow],
               [_k(kernels).stack(a) for a in sub], hs, hs, hs,
               advance_time(t, cfg.dt, cfg.npdtype))
    return tuple(kernels.unstack(a, h.mesh) for a in out)


def shard_proj_a(h, u, v, pstatics, n: int, cfg: Config, *, kernels):
    """Phase A of the projection step n on the shards: (u*, v*, div), one
    launch for every shard on CUDA blocks."""
    if h.device.type == "cpu":
        return proj_a_plain(h, u, v, pstatics, n, cfg)
    out = _run(kernels, "proj_a", _k(kernels).stack(h), _k(kernels).stack(u),
               _k(kernels).stack(v), n)
    return tuple(kernels.unstack(a, h.mesh) for a in out)


def shard_proj_b(h, u_s, v_s, p, pstatics, t, cfg: Config, *, kernels):
    """Phase B of the projection step from time t on the shards: (h1, u1,
    v1) after the correction by grad p; one launch for every shard."""
    if h.device.type == "cpu":
        return proj_b_plain(h, u_s, v_s, p, pstatics, t, cfg)
    out = _run(kernels, "proj_b", _k(kernels).stack(h), _k(kernels).stack(u_s),
               _k(kernels).stack(v_s), _k(kernels).stack(p), t)
    return tuple(kernels.unstack(a, h.mesh) for a in out)


def _pass_time(t, cfg: Config, k: int):
    for _ in range(k):
        t = advance_time(t, cfg.dt, cfg.npdtype)
    return t


def _held(grid: Grid, forcing: Forcing, cfg: Config, mesh: Mesh,
          cards=None):
    """What a stepper's wrappers take: (pstatics, None) on CPU shards,
    (None, MeshKernels) on CUDA shards (`cards`: MeshKernels')."""
    if device_type(mesh) == "cpu":
        return pad_statics(grid, forcing, cfg, mesh), None
    return None, MeshKernels((grid, forcing), cfg, mesh, cards=cards)


def make_dist_fused_stepper(grid: Grid, forcing: Forcing, cfg: Config,
                            mesh: Mesh, cards=None):
    """step(state) -> state advancing cfg.steps_per_pass fb or split
    steps of a sharded State through shard_step (on CPU shards the plain
    versions); step.plan is the MeshPlan it launches by, step.kernels its
    MeshKernels (over `cards`, default the mesh's)."""
    check_config(cfg)
    k = cfg.steps_per_pass
    plan = mesh_plan(cfg, None, mesh)
    pstatics, K = _held(grid, forcing, cfg, mesh, cards)

    def step(state: State) -> State:
        h, u, v = shard_step(state.h, state.u, state.v, pstatics, state.n,
                             state.t, cfg, k, kernels=K)
        return State(h=h, u=u, v=v, t=_pass_time(state.t, cfg, k),
                     n=state.n + k)

    step.plan = plan
    step.kernels = K
    return step


def make_dist_fused_projection_stepper(grid: Grid, forcing: Forcing,
                                       cfg: Config, mesh: Mesh, cards=None):
    """step(state) -> state advancing one rigid-lid / implicit-FS step of a
    sharded State: phase A on the shards, the right-hand side on the
    shards (parallel/dist.py, as the eager mesh step forms it), the mesh's
    elliptic solve (stencils/mesh_solve.py: on CUDA shards one K6 launch,
    or K4a's sweeps, on the gathered grid; on CPU shards the eager mesh
    solve), phase B on the shards, and the warm-start carry (the kernels
    over `cards`, default the mesh's).  As the reference's composed tier,
    it has no stall guard: the mesh's solve has none either."""
    from beom_tpu_torch.parallel import dist
    from beom_tpu_torch.stencils import mesh_solve
    from beom_tpu_torch.stepping import prepare_state

    check_config(cfg)
    plan = mesh_plan(cfg, None, mesh)
    pstatics, K = _held(grid, forcing, cfg, mesh, cards)
    pgrid1, _ = dist.pad_statics(grid, forcing, cfg, mesh, 1)
    grid_l = dist._crop_tree(pgrid1, 1)
    solve = mesh_solve.make_mesh_solve(grid_l, pgrid1, cfg, mesh,
                                       dist.pressure_lam(cfg), cards)

    def step(state: State) -> State:
        state = prepare_state(state, cfg)
        u_s, v_s, div = shard_proj_a(state.h, state.u, state.v, pstatics,
                                     state.n, cfg, kernels=K)
        with halo.impl(cfg.halo_impl):
            p = solve(*dist.pressure_rhs(state, div, grid_l, cfg))
        h1, u1, v1 = shard_proj_b(state.h, u_s, v_s, p, pstatics, state.t,
                                  cfg, kernels=K)
        out = State(h=h1, u=u1, v=v1, t=_pass_time(state.t, cfg, 1),
                    n=state.n + 1)
        return projection.with_carry(out, state, p)

    step.plan = plan
    step.kernels = K
    return step
