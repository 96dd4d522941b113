"""The fused forward-backward step on the shards of a device mesh (K7)
and its plain PyTorch version.

The CUDA kernel of `csrc/shard_step.cu` replaces the TPU kernel
beom_tpu/stencils/dist_band.py::_dist_band_kernel running the fb body of
beom_tpu/parallel/dist.py::make_dist_pallas_stepper.  It computes one
`fb_step` on each shard's local block (nz, ly, lx), whose halo points
beyond the block's edge are the neighbour shards' edge points (the
periodic wrap where a mesh axis has one shard), against statics padded
once at setup with the halo W of the single-device kernel (4, 5 under
wet/dry), so the boundary maps, the sponge and the tides keep their global
positions.  It is bounded by device-memory bytes, like K1, whose
arithmetic it shares (`csrc/fb_step_body.cuh`).

A step is two launches per shard on the shard's stream:

  interior  the tiles whose haloed block lies inside the shard's own
            block: they depend on nothing remote and start at once;
  edge      the frame of tiles around them, which read the neighbours'
            blocks through their pointers, ordered by a CUDA event after
            the neighbours' previous step.

The kernel reads the neighbours' blocks through raw pointers, so every
shard must lie on one CUDA device: a mesh over several devices raises
(peer access between cards comes with the multi-process bootstrap).  No
kernel waits on a flag written by another kernel.  Every step writes
fresh tensors, all of a pass are kept until the pass ends, and the pass
ends by joining the shards' streams into the current stream, so outside a
pass the tensors follow PyTorch's usual stream rules.

`shard_step` runs the kernel on CUDA blocks and the plain version,
`shard_step_plain` (pad2d, the eager step on the padded block, crop2d), on
CPU blocks; it never falls back from one to the other.  The split scheme
and the projection schemes are not taken yet: `make_dist_fused_stepper`
raises for them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from beom_tpu_torch.core.config import Config
from beom_tpu_torch.core.grid import Grid, Forcing
from beom_tpu_torch.core.state import State, advance_time
from beom_tpu_torch.parallel import halo
from beom_tpu_torch.parallel.mesh import Mesh, Sharded
from beom_tpu_torch.stencils import fused_fb

# kernel launches by kind; a run reads them to show that its main path
# went through the kernel
LAUNCHES = {"interior": 0, "edge": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int


def check_config(cfg: Config) -> None:
    """Raise on what the shard step cannot run yet: any scheme but fb."""
    if cfg.scheme == "split":
        raise NotImplementedError(
            "backend='fused' under a mesh takes scheme='fb'; the split "
            "step on shards is ROADMAP queue 1 item 14a (use "
            "backend='eager')")
    if cfg.scheme != "fb":
        raise NotImplementedError(
            "backend='fused' under a mesh takes scheme='fb'; the "
            "projection phases on shards are ROADMAP queue 1 item 14b (use "
            "backend='eager')")
    fused_fb.check_config(cfg)


def shard_halo(cfg: Config) -> int:
    """The halo W of the fused step's tile: the width the statics are
    padded to and the neighbours' edges are read to."""
    return 5 if cfg.wetdry else 4


def build_spec(cfg: Config, dtype=None):
    """(source, defines) of the build of csrc/shard_step.cu that runs cfg:
    the switches and the tile of the single-device fused step."""
    check_config(cfg)
    _, defines = fused_fb.build_spec(cfg, dtype)
    return "shard_step", defines


def pad_statics(grid: Grid, forcing: Forcing, cfg: Config, mesh: Mesh):
    """(grid, forcing) with every field sharded and padded by the step's
    halo from the neighbour shards, once."""
    from beom_tpu_torch.parallel import dist

    return dist.pad_statics(grid, forcing, cfg, mesh, shard_halo(cfg))


def shard_step_plain(h, u, v, pstatics, n: int, t, cfg: Config, k: int):
    """k eager fb steps of the sharded (h, u, v): each pads the fields by
    the halo, steps the padded blocks against the padded statics and crops
    the halo off."""
    w = shard_halo(cfg)
    for i in range(k):
        hp, up, vp = fused_fb.fused_fb_step_plain(
            halo.pad2d(h, w), halo.pad2d(u, w), halo.pad2d(v, w), pstatics,
            n + i, t, cfg, 1)
        h, u, v = halo.crop2d(hp, w), halo.crop2d(up, w), halo.crop2d(vp, w)
        t = advance_time(t, cfg.dt, cfg.npdtype)
    return h, u, v


@functools.lru_cache(maxsize=None)
def _entry(cfg: Config, dtype):
    from beom_tpu_torch.stencils import build

    lib = build.load(build_spec(cfg, dtype))
    if lib.beom_shard_halo() != shard_halo(cfg):
        raise RuntimeError("shard_step: the kernel's halo is not "
                           "shard_halo's")
    fn = getattr(lib, f"beom_shard_step_{fused_fb._SUFFIX[dtype]}")
    fn.argtypes = [_P] * 9
    fn.restype = _I
    return lib, fn, (lib.beom_tile_x(), lib.beom_tile_y())


def has_interior(ly: int, lx: int, w: int, tile) -> bool:
    """Whether a block of (ly, lx) points has a tile whose halo lies
    inside it (csrc/shard_step.cu's interior rectangle)."""
    tx, ty = tile
    return ((lx - w) // tx > (w + tx - 1) // tx
            and (ly - w) // ty > (w + ty - 1) // ty)


def _check_blocks(fields, pstatics, cfg: Config):
    h = fields[0]
    mesh, w = h.mesh, shard_halo(cfg)
    ly, lx = cfg.ny // mesh.shape["y"], cfg.nx // mesh.shape["x"]
    if h.dtype not in fused_fb._SUFFIX or h.dtype != cfg.tdtype:
        raise ValueError(f"shard step: dtype {h.dtype} with cfg.dtype "
                         f"{cfg.dtype}")
    if ly < w or lx < w:
        raise ValueError(
            f"local block of ({ly}, {lx}) points cannot hold the {w}-point "
            "halo; use fewer shards or a larger grid")
    for s, dev in enumerate(mesh.devices):
        if dev.type != "cuda":
            raise NotImplementedError(
                f"the shard step runs on cuda or cpu, not {dev.type}")
        for a in fields:
            b = a.blocks[s]
            if b.device != dev or b.dtype != h.dtype \
                    or tuple(b.shape) != (cfg.nz, ly, lx):
                raise ValueError(
                    f"shard step: shard {s} must hold {h.dtype} blocks of "
                    f"{(cfg.nz, ly, lx)} on {dev}, not {b.dtype} "
                    f"{tuple(b.shape)} on {b.device}")
    return ly, lx, w


def _static_blocks(pstatics, mesh: Mesh):
    """Per shard, the padded statics in the order of the operand table,
    contiguous."""
    ops = fused_fb._operands(pstatics)
    return [[a.blocks[s].contiguous() for a in ops] for s in range(mesh.n)]


def shard_step(h, u, v, pstatics, n: int, t, cfg: Config, k: int,
               static_blocks=None):
    """Advance the sharded (h, u, v) by k fb steps from step n at time t.

    CPU blocks take the plain version.  CUDA blocks take the kernel: two
    launches per shard and step (one where a block has no interior tile);
    a configuration the kernel cannot run raises.  pstatics is
    pad_statics' (grid, forcing).
    """
    if h.device.type == "cpu":
        return shard_step_plain(h, u, v, pstatics, n, t, cfg, k)
    from beom_tpu_torch.stencils import build

    check_config(cfg)
    ly, lx, w = _check_blocks((h, u, v), pstatics, cfg)
    mesh = h.mesh
    dev = mesh.single_device("the shard step")
    lib, fn, tile = _entry(cfg, h.dtype)
    interior = has_interior(ly, lx, w, tile)
    statics = static_blocks or _static_blocks(pstatics, mesh)
    tables = [fused_fb._pointers([st[0]] * 3 + st) for st in statics]
    nbrs = mesh.neighbourhoods
    streams = mesh.streams
    geom = {e: fused_fb._array(_I, [ly, lx, e]) for e in (0, 1)}

    # the pass starts after what the device's current stream holds
    start = torch.cuda.current_stream(dev).record_event()
    for s in range(mesh.n):
        streams[s].wait_event(start)
    fields = [[a.blocks[s].contiguous() for s in range(mesh.n)]
              for a in (h, u, v)]
    keep = [fields]         # a pass's tensors live until its streams join
    done = [None] * mesh.n

    raw = [st.cuda_stream for st in streams]

    def launch(s, dyn, out, scal, edge):
        code = fn(tables[s], scal[0], scal[1], dyn[s], geom[edge], *out[s],
                  raw[s])
        if code:
            build.check(lib, code, "shard_step kernel launch")
        LAUNCHES["edge" if edge else "interior"] += 1

    with torch.cuda.device(dev):
        for i in range(k):
            t1 = advance_time(t, cfg.dt, cfg.npdtype)
            scal = fused_fb._scalars(cfg, (n + i) % 2, t1, ny=ly + 2 * w,
                                     nx=lx + 2 * w)
            outs = [[torch.empty_like(b) for b in fields[f]] for f in range(3)]
            src = [[b.data_ptr() for b in fields[f]] for f in range(3)]
            # per shard: h, u, v of its 3 x 3 neighbourhood, and its outputs
            dyn = [fused_fb._array(_P, [src[f][nb] for f in range(3)
                                        for nb in nbrs[s]])
                   for s in range(mesh.n)]
            out = [[outs[f][s].data_ptr() for f in range(3)]
                   for s in range(mesh.n)]
            if interior:
                for s in range(mesh.n):
                    launch(s, dyn, out, scal, 0)
            finished = []
            for s in range(mesh.n):
                if i:
                    for nb in set(nbrs[s]) - {s}:
                        streams[s].wait_event(done[nb])
                launch(s, dyn, out, scal, 1)
                finished.append(streams[s].record_event())
            done, fields, t = finished, outs, t1
            keep.append(outs)

    for s in range(mesh.n):
        torch.cuda.current_stream(dev).wait_event(done[s])
    return tuple(Sharded(f, mesh) for f in fields)


def make_dist_fused_stepper(grid: Grid, forcing: Forcing, cfg: Config,
                            mesh: Mesh):
    """step(state) -> state advancing cfg.steps_per_pass fb steps of a
    sharded State through the shard step."""
    check_config(cfg)
    k = cfg.steps_per_pass
    pstatics = pad_statics(grid, forcing, cfg, mesh)
    blocks = None if mesh.devices[0].type == "cpu" \
        else _static_blocks(pstatics, mesh)

    def step(state: State) -> State:
        h, u, v = shard_step(state.h, state.u, state.v, pstatics, state.n,
                             state.t, cfg, k, static_blocks=blocks)
        t = state.t
        for _ in range(k):
            t = advance_time(t, cfg.dt, cfg.npdtype)
        return State(h=h, u=u, v=v, t=t, n=state.n + k)

    return step
