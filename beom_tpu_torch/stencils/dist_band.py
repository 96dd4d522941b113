"""The fused steps on the shards of a device mesh (K7) and their plain
PyTorch versions: the forward-backward step, the split step and the two
phases of the projection steps.

The CUDA kernels replace the TPU kernel beom_tpu/stencils/dist_band.py::
_dist_band_kernel with the bodies it runs in beom_tpu/parallel/dist.py:
`csrc/shard_step.cu` the fb body of make_dist_pallas_stepper,
`csrc/shard_split.cu` its split body, `csrc/shard_projection.cu` body_a
and body_b of make_dist_pallas_projection_stepper.  Each computes on every
shard's local block (nz, ly, lx) what the single-device kernel computes on
the grid (K1; K1s's slow phase, subcycle and recomposition; K3a, K3b),
with the same stage code (`csrc/fb_step_body.cuh`, `split_body.cuh`,
`projection_body.cuh`), so a shard's result equals the single-device
kernel's bit for bit.  A halo point beyond the block's edge is the
neighbour shard's, read from its block through its pointer (the periodic
wrap where a mesh axis has one shard); the statics are padded once at
setup with the widest halo the scheme's kernels read, so the boundary
maps, the sponge and the tides keep their global positions
(`csrc/shard_addr.cuh`).  They are bounded by device-memory bytes.

  fb     a step is one kernel, halo W = 4 (5 under wet/dry);
  split  a step is three kernels: the slow phase (halo 2) writes the
         SlowPhase fields (4 nz + 9 planes), the subcycle (halo nsub) reads
         the neighbours' and writes five 2-D fields, the recomposition
         (halo 2, 3 under wet/dry) reads the neighbours' h, SlowPhase and
         subcycle fields; the statics are padded by the widest,
         max(2, nsub, 3 under wet/dry);
  fb and split kernels are two launches per shard on the shard's stream:
         interior  the tiles whose haloed block lies inside the shard's own
                   block: they depend on nothing remote and start at once;
         edge      the frame of tiles around them, which read the
                   neighbours' blocks, ordered by CUDA events after the
                   neighbours' previous kernel (the next step's slow phase
                   after their recomposition);
  rigid_lid / implicit_fs  phase A (halo 4) and phase B (halo 1 to 3) on the
         shards around the mesh's elliptic solve (parallel/dist.py's
         _dist_solve, eager over the shards), one launch per shard and
         phase: `shard_proj_a` says why no split is needed.

The kernels read the neighbours' blocks through raw pointers, so every
shard must lie on one CUDA device: a mesh over several devices raises
(peer access between cards comes with the multi-process bootstrap).  No
kernel waits on a flag written by another kernel.  Every kernel writes
fresh tensors, all of a pass are kept until the pass ends, and the pass
ends by joining the shards' streams into the current stream, so outside a
pass the tensors follow PyTorch's usual stream rules.

Each wrapper runs its kernel on CUDA blocks and its plain version (pad2d by
the kernel's halo, the eager function on the padded blocks, crop2d) on CPU
blocks; it never falls back from one to the other.
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
from beom_tpu_torch.physics import drag
from beom_tpu_torch.stencils import fused_fb, fused_projection
from beom_tpu_torch.stepping import fb as fb_mod
from beom_tpu_torch.stepping import projection
from beom_tpu_torch.stepping import split as split_mod

# kernel launches by kind: the fb step's interior and edge launches, and
# per kernel of the split step and the projection phases (interior and
# edge together); a run reads them to show that its main path went through
# the kernels
LAUNCHES = {"interior": 0, "edge": 0, "split_slow": 0, "split_subcycle": 0,
            "split_recompose": 0, "proj_a": 0, "proj_b": 0}

_PROJECTION = ("rigid_lid", "implicit_fs")
# the split kernels in the order of csrc/shard_split.cu's beom_smem_bytes
_SPLIT = ("slow", "recompose", "subcycle")
_P, _I = ctypes.c_void_p, ctypes.c_int


def check_config(cfg: Config) -> None:
    """Raise on what the shard kernels cannot run: what the single-device
    kernels of the scheme refuse."""
    if cfg.scheme in _PROJECTION:
        fused_projection.check_config(cfg)
    else:
        fused_fb.check_config(cfg)


def kernel_halos(cfg: Config) -> dict:
    """The halo each kernel of the scheme reads around a tile."""
    lo = 2 if cfg.wetdry else 1
    if cfg.scheme == "split":
        return {"slow": 2, "subcycle": cfg.nsub, "recompose": lo + 1}
    if cfg.scheme in _PROJECTION:
        return {"proj_a": 4,
                "proj_b": lo + 1 if (cfg.wetdry or cfg.obc) else 1}
    return {"fb": lo + 3}


def shard_halo(cfg: Config) -> int:
    """The halo the statics are padded to: the widest the scheme's
    kernels read."""
    return max(kernel_halos(cfg).values())


def build_spec(cfg: Config, dtype=None):
    """(source, defines) of the build that runs cfg on shards:
    csrc/shard_step.cu, shard_split.cu or shard_projection.cu with the
    switches and the tiles of the single-device kernels."""
    check_config(cfg)
    if cfg.scheme in _PROJECTION:
        return "shard_projection", fused_projection.build_spec(cfg, dtype)[1]
    _, defines = fused_fb.build_spec(cfg, dtype)
    return ("shard_split" if cfg.scheme == "split" else "shard_step"), \
        defines


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


# ---------------------------------------------------------------- kernels

# the C entries' argument types: the statics table, ints, dbls, the
# neighbour pointers and geom, then the kernel's own outputs (a pointer
# table for the slow phase and the subcycle; phase B takes corr first)
_ARGTYPES = {"fb": [_P] * 9, "slow": [_P] * 7, "subcycle": [_P] * 7,
             "recompose": [_P] * 9, "proj_a": [_P] * 9,
             "proj_b": [_P] * 5 + [ctypes.c_double] + [_P] * 4}


@functools.lru_cache(maxsize=None)
def _entry(cfg: Config, dtype):
    """(library, entry points by kernel, tiles by kernel) of cfg's build,
    built on first use and checked against the wrapper's halos and the
    single-device kernels' shared memory."""
    from beom_tpu_torch.stencils import build

    name, defines = build_spec(cfg, dtype)
    lib = build.load((name, defines))
    if lib.beom_shard_halo() != shard_halo(cfg):
        raise RuntimeError(f"{name}: the kernel's halo is not shard_halo's")
    value = {d.split("=")[0]: int(d.split("=")[1]) for d in defines}
    tile = (value["BEOM_TX"], value["BEOM_TY"])
    elem = torch.empty((), dtype=dtype).element_size()
    halos = kernel_halos(cfg)
    if name == "shard_step":
        symbols, want = {"fb": "shard_step"}, {}
        tiles = {"fb": tile}
    elif name == "shard_split":
        sub_tile = (value["BEOM_SX"], value["BEOM_SY"])
        symbols = {k: f"shard_split_{k}" for k in _SPLIT}
        want = fused_fb.smem_bytes(cfg, tile, sub_tile, elem)
        want = {k: want[f"split_{k}"] for k in _SPLIT}
        tiles = dict.fromkeys(_SPLIT, tile)
        tiles["subcycle"] = sub_tile
    else:
        symbols = {k: f"shard_{k}" for k in fused_projection._KERNELS}
        want = fused_projection.smem_bytes(cfg, tile, elem)
        tiles = dict.fromkeys(fused_projection._KERNELS, tile)
    entries = {}
    for i, key in enumerate(symbols):
        if key in want and (lib.beom_smem_bytes(i, int(elem == 8))
                            != want[key]
                            or lib.beom_kernel_halo(i) != halos[key]):
            raise RuntimeError(f"{symbols[key]}: the kernel's shared memory "
                               "or halo is not the wrapper's")
        fn = getattr(lib, f"beom_{symbols[key]}_{fused_fb._SUFFIX[dtype]}")
        fn.argtypes, fn.restype = _ARGTYPES[key], _I
        entries[key] = fn
    return lib, entries, tiles


def has_interior(ly: int, lx: int, w: int, tile) -> bool:
    """Whether a block of (ly, lx) points has a tile whose halo w lies
    inside it (csrc/shard_addr.cuh's interior rectangle)."""
    tx, ty = tile
    return ((lx - w) // tx > (w + tx - 1) // tx
            and (ly - w) // ty > (w + ty - 1) // ty)


def _check_blocks(fields, cfg: Config, mesh: Mesh):
    """(ly, lx) of the blocks; raise unless each shard holds blocks of
    cfg's type and shape on its CUDA device and a block holds the widest
    halo."""
    h = fields[0]
    ly, lx = check_mesh(cfg, mesh)
    if h.dtype not in fused_fb._SUFFIX or h.dtype != cfg.tdtype:
        raise ValueError(f"shard kernels: dtype {h.dtype} with cfg.dtype "
                         f"{cfg.dtype}")
    for s, dev in enumerate(mesh.devices):
        if dev.type != "cuda":
            raise NotImplementedError(
                f"the shard kernels run on cuda or cpu, not {dev.type}")
        for a in fields:
            b = a.blocks[s]
            shape = tuple(a.shape[:-2]) + (ly, lx)
            if b.device != dev or b.dtype != h.dtype \
                    or tuple(b.shape) != shape \
                    or shape[:-2] not in ((), (cfg.nz,)):
                raise ValueError(
                    f"shard kernels: shard {s} must hold {h.dtype} blocks "
                    f"of {(cfg.nz, ly, lx)} or {(ly, lx)} on {dev}, not "
                    f"{b.dtype} {tuple(b.shape)} on {b.device}")
    return ly, lx


def check_mesh(cfg: Config, mesh: Mesh):
    """(ly, lx) of a shard's block; raise if it cannot hold the widest halo
    the scheme's kernels read (for split, the subcycle's nsub)."""
    ly, lx = cfg.ny // mesh.shape["y"], cfg.nx // mesh.shape["x"]
    w = shard_halo(cfg)
    if ly < w or lx < w:
        raise ValueError(
            f"local block of ({ly}, {lx}) points cannot hold the {w}-point "
            f"halo of the {cfg.scheme} shard kernels; use fewer shards or a "
            "larger grid")
    return ly, lx


def _static_blocks(pstatics, mesh: Mesh):
    """Per shard, the padded statics in the order of the operand table,
    contiguous."""
    ops = fused_fb._operands(pstatics)
    return [[a.blocks[s].contiguous() for a in ops] for s in range(mesh.n)]


class _Pass:
    """Kernels on the shards' streams of one device, from an event after
    what the device's current stream holds (the contiguous copies of the
    inputs included) to the join of the streams into it.  `inputs` are the
    sharded fields' blocks; every tensor the pass makes is kept until the
    join."""

    def __init__(self, fields):
        self.mesh = mesh = fields[0].mesh
        self.dev = mesh.single_device("the shard kernels")
        self.streams = mesh.streams
        self.raw = [st.cuda_stream for st in self.streams]
        with torch.cuda.device(self.dev):
            self.inputs = [[b.contiguous() for b in a.blocks]
                           for a in fields]
            start = torch.cuda.current_stream(self.dev).record_event()
        for st in self.streams:
            st.wait_event(start)
        self.done = None
        self.keep = [self.inputs]

    def empty(self, like, n: int):
        """n fresh per-shard blocks shaped as the blocks `like`."""
        out = [[torch.empty_like(b) for b in like] for _ in range(n)]
        self.keep.append(out)
        return out

    def tables(self, fields):
        """Per shard, the 3 x 3 neighbourhood pointers of each field (a
        list of per-shard blocks), field-major."""
        ptr = [[b.data_ptr() for b in f] for f in fields]
        return [fused_fb._array(_P, [p[nb] for p in ptr
                                     for nb in self.mesh.neighbourhoods[s]])
                for s in range(self.mesh.n)]

    def phase(self, launch, interior: bool):
        """One kernel on every shard: launch(s, part).  With `interior`,
        the interior tiles (part 0) at once on each shard's stream, then
        the frame (part 1); without, every tile (part 2).  The frame or the
        whole launch waits on the neighbours' previous kernel of the
        pass."""
        mesh = self.mesh
        if interior:
            for s in range(mesh.n):
                launch(s, 0)
        done = []
        for s in range(mesh.n):
            if self.done is not None:
                for nb in set(mesh.neighbourhoods[s]) - {s}:
                    self.streams[s].wait_event(self.done[nb])
            launch(s, 1 if interior else 2)
            done.append(self.streams[s].record_event())
        self.done = done

    def join(self):
        cur = torch.cuda.current_stream(self.dev)
        for ev in self.done:
            cur.wait_event(ev)


class _Shards:
    """What the kernels of one call share: the entry points, the statics'
    tables and the block geometry."""

    def __init__(self, fields, pstatics, cfg: Config, static_blocks=None):
        check_config(cfg)
        mesh = fields[0].mesh
        self.ly, self.lx = _check_blocks(fields, cfg, mesh)
        self.lib, self.fn, self.tiles = _entry(cfg, fields[0].dtype)
        statics = static_blocks or _static_blocks(pstatics, mesh)
        self.statics = statics
        self.tables = [fused_fb._pointers([st[0]] * 3 + st)
                       for st in statics]
        self.geom = {p: fused_fb._array(_I, [self.ly, self.lx, p])
                     for p in (0, 1, 2)}
        self.pad = shard_halo(cfg)
        self.halos = kernel_halos(cfg)
        self.cfg = cfg

    def scalars(self, parity: int, t1):
        return fused_fb._scalars(self.cfg, parity, t1,
                                 ny=self.ly + 2 * self.pad,
                                 nx=self.lx + 2 * self.pad)

    def interior(self, key: str) -> bool:
        return has_interior(self.ly, self.lx, self.halos[key],
                            self.tiles[key])

    def run(self, P: _Pass, key: str, scal, ins, outs, *extra):
        """Kernel `key` on every shard of the pass: fn(statics table, ints,
        dbls, neighbour pointers of `ins`, geom, *extra, outputs, stream).
        ins and outs are lists of per-shard blocks; the slow phase and the
        subcycle take their outputs as a pointer table."""
        from beom_tpu_torch.stencils import build

        fn = self.fn[key]
        dyn = P.tables(ins)
        per_shard = list(zip(*outs))
        if key in ("slow", "subcycle"):
            out_args = [(fused_fb._pointers(o),) for o in per_shard]
        else:
            out_args = [tuple(b.data_ptr() for b in o) for o in per_shard]
        kind = key if key in ("fb", "proj_a", "proj_b") else f"split_{key}"

        def launch(s, part):
            code = fn(self.tables[s], scal[0], scal[1], dyn[s],
                      self.geom[part], *extra, *out_args[s], P.raw[s])
            if code:
                build.check(self.lib, code, f"shard {kind} kernel launch")
            if key == "fb":
                LAUNCHES["edge" if part else "interior"] += 1
            else:
                LAUNCHES[kind] += 1

        P.phase(launch, key not in ("proj_a", "proj_b")
                and self.interior(key))


def _split_slow(S: _Shards, P: _Pass, f):
    """The slow phase's 13 fields (per-shard blocks) from h, u, v."""
    slow = P.empty(f[0], 4) + P.empty([b[0] for b in f[0]], 9)
    S.run(P, "slow", S.scalars(0, 0.0), f, slow)
    return slow


def _split_subcycle(S: _Shards, P: _Pass, slow):
    sub = P.empty(slow[-1], 5)
    S.run(P, "subcycle", S.scalars(0, 0.0), slow, sub)
    return sub


def _split_recompose(S: _Shards, P: _Pass, slow, sub, h, t1):
    out = P.empty(h, 3)
    S.run(P, "recompose", S.scalars(0, t1),
          [h] + slow + sub, out)
    return out


def _sharded(blocks, mesh):
    return [Sharded(b, mesh) for b in blocks]


def shard_step(h, u, v, pstatics, n: int, t, cfg: Config, k: int,
               static_blocks=None):
    """Advance the sharded (h, u, v) by k steps of cfg.scheme ('fb' or
    'split') from step n at time t.

    CPU blocks take the plain version.  CUDA blocks take the kernels: per
    shard and step two launches of each kernel (one where a block has no
    interior tile); a configuration the kernels cannot run raises.
    pstatics is pad_statics' (grid, forcing).
    """
    if h.device.type == "cpu":
        return shard_step_plain(h, u, v, pstatics, n, t, cfg, k)
    if cfg.scheme not in ("fb", "split"):
        raise ValueError("shard_step takes scheme='fb' or 'split'; the "
                         "projection schemes step through "
                         "make_dist_fused_projection_stepper")
    S = _Shards((h, u, v), pstatics, cfg, static_blocks)
    P = _Pass((h, u, v))
    with torch.cuda.device(P.dev):
        f = P.inputs
        for i in range(k):
            t1 = advance_time(t, cfg.dt, cfg.npdtype)
            if cfg.scheme == "fb":
                outs = P.empty(f[0], 3)
                S.run(P, "fb", S.scalars((n + i) % 2, t1), f, outs)
                f = outs
            else:
                slow = _split_slow(S, P, f)
                sub = _split_subcycle(S, P, slow)
                f = _split_recompose(S, P, slow, sub, f[0], t1)
            t = t1
        P.join()
    return tuple(_sharded(f, h.mesh))


def shard_split_slow(h, u, v, pstatics, cfg: Config):
    """The slow phase of the split step on the shards: SlowPhase's 13
    fields as sharded fields (cu, cv as the bottom plane).  The kernel on
    CUDA blocks, the plain version on CPU blocks."""
    if h.device.type == "cpu":
        return split_slow_plain(h, u, v, pstatics, cfg)
    S = _Shards((h, u, v), pstatics, cfg)
    P = _Pass((h, u, v))
    with torch.cuda.device(P.dev):
        slow = _split_slow(S, P, P.inputs)
        P.join()
    return _sharded(slow, h.mesh)


def shard_split_subcycle(slow, pstatics, cfg: Config):
    """The barotropic subcycle on the shards from the slow phase's 13
    sharded fields: (eta_f, ubar_f, vbar_f, ubar_avg, vbar_avg)."""
    if slow[0].device.type == "cpu":
        return split_subcycle_plain(slow, pstatics, cfg)
    S = _Shards(slow, pstatics, cfg)
    P = _Pass(slow)
    with torch.cuda.device(P.dev):
        sub = _split_subcycle(S, P, P.inputs)
        P.join()
    return _sharded(sub, slow[0].mesh)


def shard_split_recompose(slow, sub, h, pstatics, t, cfg: Config):
    """The recomposition with fb.finalize on the shards, from time t:
    (h1, u1, v1)."""
    if h.device.type == "cpu":
        return split_recompose_plain(slow, sub, h, pstatics, t, cfg)
    fields = [h] + list(slow) + list(sub)
    S = _Shards(fields, pstatics, cfg)
    P = _Pass(fields)
    with torch.cuda.device(P.dev):
        f = P.inputs
        out = _split_recompose(S, P, f[1:14], f[14:], f[0],
                               advance_time(t, cfg.dt, cfg.npdtype))
        P.join()
    return tuple(_sharded(out, h.mesh))


def shard_proj_a(h, u, v, pstatics, n: int, cfg: Config,
                 static_blocks=None):
    """Phase A of the projection step n on the shards: (u*, v*, div).

    CUDA blocks take the kernel, one launch per shard over every tile,
    after one start event.  The interior / edge split of the fb and split
    kernels buys nothing here: the elliptic solve between the phases joins
    every shard, and the next step's phase A starts after phase B's join,
    so no input of either phase is in flight when it launches.
    """
    if h.device.type == "cpu":
        return proj_a_plain(h, u, v, pstatics, n, cfg)
    S = _Shards((h, u, v), pstatics, cfg, static_blocks)
    P = _Pass((h, u, v))
    with torch.cuda.device(P.dev):
        f = P.inputs
        outs = P.empty(f[0], 2) + P.empty([b[0] for b in f[0]], 1)
        S.run(P, "proj_a", S.scalars(n % 2, 0.0), f, outs)
        P.join()
    return tuple(_sharded(outs, h.mesh))


def shard_proj_b(h, u_s, v_s, p, pstatics, t, cfg: Config,
                 static_blocks=None):
    """Phase B of the projection step from time t on the shards: (h1, u1,
    v1) after the correction by grad p; one launch per shard, as
    shard_proj_a."""
    if h.device.type == "cpu":
        return proj_b_plain(h, u_s, v_s, p, pstatics, t, cfg)
    S = _Shards((h, u_s, v_s, p), pstatics, cfg, static_blocks)
    P = _Pass((h, u_s, v_s, p))
    with torch.cuda.device(P.dev):
        f = P.inputs
        outs = P.empty(f[0], 3)
        t1 = advance_time(t, cfg.dt, cfg.npdtype)
        S.run(P, "proj_b", S.scalars(0, t1), f, outs,
              fused_projection._corr(cfg))
        P.join()
    return tuple(_sharded(outs, h.mesh))


def _pass_time(t, cfg: Config, k: int):
    for _ in range(k):
        t = advance_time(t, cfg.dt, cfg.npdtype)
    return t


def make_dist_fused_stepper(grid: Grid, forcing: Forcing, cfg: Config,
                            mesh: Mesh):
    """step(state) -> state advancing cfg.steps_per_pass fb or split
    steps of a sharded State through the shard kernels."""
    check_config(cfg)
    check_mesh(cfg, mesh)
    k = cfg.steps_per_pass
    pstatics = pad_statics(grid, forcing, cfg, mesh)
    blocks = None if mesh.devices[0].type == "cpu" \
        else _static_blocks(pstatics, mesh)

    def step(state: State) -> State:
        h, u, v = shard_step(state.h, state.u, state.v, pstatics, state.n,
                             state.t, cfg, k, static_blocks=blocks)
        return State(h=h, u=u, v=v, t=_pass_time(state.t, cfg, k),
                     n=state.n + k)

    return step


def make_dist_fused_projection_stepper(grid: Grid, forcing: Forcing,
                                       cfg: Config, mesh: Mesh):
    """step(state) -> state advancing one rigid-lid / implicit-FS step of a
    sharded State: phase A on the shards, the right-hand side and the
    mesh's elliptic solve (parallel/dist.py, as the eager mesh step has
    them), phase B on the shards, and the warm-start carry.  As the
    reference's composed tier, it has no stall guard: the mesh's solve has
    none either."""
    from beom_tpu_torch.parallel import dist
    from beom_tpu_torch.stepping import prepare_state

    check_config(cfg)
    check_mesh(cfg, mesh)
    pstatics = pad_statics(grid, forcing, cfg, mesh)
    blocks = None if mesh.devices[0].type == "cpu" \
        else _static_blocks(pstatics, mesh)
    pgrid1, _ = dist.pad_statics(grid, forcing, cfg, mesh, 1)
    grid_l = dist._crop_tree(pgrid1, 1)

    def step(state: State) -> State:
        state = prepare_state(state, cfg)
        u_s, v_s, div = shard_proj_a(state.h, state.u, state.v, pstatics,
                                     state.n, cfg, static_blocks=blocks)
        with halo.impl(cfg.halo_impl):
            p = dist.solve_pressure(state, div, grid_l, pgrid1, cfg)
        h1, u1, v1 = shard_proj_b(state.h, u_s, v_s, p, pstatics, state.t,
                                  cfg, static_blocks=blocks)
        out = State(h=h1, u=u1, v=v1, t=_pass_time(state.t, cfg, 1),
                    n=state.n + 1)
        return projection.with_carry(out, state, p)

    return step
