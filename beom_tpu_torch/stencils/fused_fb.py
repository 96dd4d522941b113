"""The fused forward-backward step (K1), the fused split step (K1s) and
their plain PyTorch versions.

The CUDA kernels replace the TPU kernel beom_tpu/stencils/band.py::
_band_kernel running the bodies of beom_tpu/stencils/fused_fb.py::
make_pallas_stepper: `csrc/fb_step.cu` its fb body, `csrc/split_step.cu`
its split body.  Both take every case: any layer count and every term of
the eager step (wet/dry, open boundary, sponge, tides, nu4, quadratic
bottom drag, interfacial drag), sharing the term code of
`csrc/fb_terms.cuh`.

  * scheme='fb': a pass of k steps is ceil(k / kb) launches of K1: a
    launch advances kb steps of (h, u, v) on blocks with a halo kb times
    as wide (`plan`; the single-step build for kb = 1, the pass kernel
    otherwise).
  * scheme='split': one split_step is two launches (`split_plan`'s route
    2): the slow phase's layer tendencies, then the tail, which rebuilds
    the depth means from h, u, v and them and runs the barotropic subcycle
    (nsub substeps of three 2-D fields inside shared memory), the
    recomposition with the continuity, the column rescale and fb.finalize
    on blocks with a halo of `tail_halo`; or three (route 3): the slow
    phase (tendencies, depth means), the subcycle and the recomposition,
    each through device memory.  `csrc/split_step.cu` says why.

A pass of k = cfg.steps_per_pass steps is k such steps, each with its own
FB-Coriolis sweep order (n + i) % 2 and its own time for the tides.
`fused_fb_step_tiled` runs the fb pass's blocked schedule on the host, and
`split_step_tiled` the split tail's, for the tests.

The single-step kernels are bounded by device-memory bytes, the fb pass
kernel by its stages (csrc/fb_step.cu).  The layer count, the term
switches and the tile are compile-time: a configuration's kernels are
built at its first step, one library per combination, and a switch that
is off costs neither shared memory nor an operand.  The scalar slots of
the gprime and the tidal frequencies are sized by the build too
(`slot_layout`), so any number of layers and constituents runs.  The tile
is the largest of `_TILES` whose shared-memory planes fit a CTA (for the
subcycle, whose halo is nsub, of `_SUB_TILES`; nsub is compile-time too).
Where none fits (many layers), K1's single step streams the layers: a
build with BEOM_STREAM = 1 holds a few planes of one layer in shared
memory, whatever nz, and runs a step as two launches, the continuity of
every layer, then the momentum (csrc/fb_step_body.cuh: fbs).  The split
step's slow phase and recomposition stream their layers too, on route 3
from _STREAM_FROM layers and wherever no tile fits them (split_plan):
the slow phase in one launch, the recomposition in two
(csrc/split_body.cuh: sps).  The plans choose these routes
(`launch_plan`, `split_plan`; their `off_smem` forces the route off
shared memory where the shared-memory route fits too), `describe()`
names them, and STREAM_LAUNCHES counts the streamed kernels' launches.
The shard kernels (K7, stencils/dist_band.py) take the same routes through
the same bodies.  `fb_step_streamed` and `split_step_streamed` run the
streamed schedules on the host, for the tests.

`fused_fb_step` runs the kernels on CUDA tensors and the plain version,
`fused_fb_step_plain`, on CPU tensors.  It never falls back from one to
the other: on a CUDA tensor it launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from beom_tpu_torch.core.config import Config
from beom_tpu_torch.core.grid import Grid, Forcing
from beom_tpu_torch.core.state import State, advance_time
from beom_tpu_torch.physics import drag
from beom_tpu_torch.stepping import fb as fb_mod
from beom_tpu_torch.stepping import split as split_mod
from beom_tpu_torch.stepping.split import SlowPhase

# kernel launches: K1's by fused_fb_step (PASS_LAUNCHES those of the pass
# kernel among them), and those of the split step's three kernels; a run
# reads them to show that its main path went through the kernels
LAUNCHES = 0
PASS_LAUNCHES = 0
SPLIT_LAUNCHES = {"slow": 0, "subcycle": 0, "recompose": 0, "tend": 0,
                  "tail": 0}
# the layer-streamed kernels' launches: K1's two (LAUNCHES counts such a
# step as one), and the split step's among SPLIT_LAUNCHES (the slow phase,
# its tendencies, and the recomposition: one entry call that launches its
# two kernels, split_rec_h_layers_kernel and split_rec_uv_layers_kernel,
# counted once)
STREAM_LAUNCHES = {"fb_continuity": 0, "fb_momentum": 0, "split_slow": 0,
                   "split_tend": 0, "split_recompose": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# operand slots, in the order of csrc/fb_terms.cuh's enums Ptr, Int and Dbl
_GRID_NAMES = ("H", "mask", "mask_u", "mask_v", "mask_q", "f_q")
_FORCING_NAMES = ("taux", "tauy", "sponge", "h_ext", "obc_u", "obc_v",
                  "obc_h", "tide_amp", "tide_phase")
_MAX_SMEM = 232448       # bytes of shared memory a CTA can use on sm_90
_TILES = ((32, 16), (32, 8), (16, 8), (8, 8))
# the fb pass kernel: the slots of its per-step times
# (csrc/fb_terms.cuh: MAX_KB), the most steps a plan gives one launch, and
# its tiles (tx a multiple of 4, so f32 rows start 16-byte aligned)
_MAX_KB = 8
_PLAN_KB = 4
_PASS_TILES = tuple((tx, ty) for tx in (32, 48, 64, 96, 128)
                    for ty in range(4, 65, 4))
# the cost model of a plan, in units of one stage-point (one point of one
# of S1 to S4): a point of one field staged costs _LOAD_COST of it (the
# H100's single-step K1 at 2048^2 f32: stages alone 0.118 ms for 2790
# stage-points per 32 x 16 tile, S0's loads of every operand alone 0.114
# ms for 960 points x 11 fields per tile, tools/k1_probes.py); the pass
# kernel's stage-point costs _PASS_FACTOR of the single step's (its
# stages at one CTA per SM, the statics read from shared memory:
# tools/k1_plans.py on the H100, 1.12 on the f32 gyre, 1.19-1.3 with
# wet/dry, 1.35 with two layers)
_LOAD_COST = 0.25
_PASS_FACTOR = 1.25
_SUB_TILES = ((64, 32), (32, 32), (32, 16), (16, 16), (16, 8))
# the kernels of each source, in the order of its beom_smem_bytes
_TILED = {"fb_step": ("fb_step",),
          "split_step": ("split_slow", "split_recompose", "split_subcycle",
                         "split_tail")}
# the split tail's blocks: widths RX = qx + 2 halo of whole warps, strips of
# qp rows per column, at least 512 threads; registers per thread it needs
# (its nine barotropic values per point, plus _TAIL_REGS of its own) within
# the 65536 of an SM at one CTA per SM (csrc/split_body.cuh: namespace tail)
_TAIL_WIDTHS = (32, 64, 96, 128)
_TAIL_STRIPS = (4, 8, 12, 16, 24, 32)
_TAIL_REGS = 24
# the cost model of a tail geometry, fitted on the H100 (2048^2, the f32
# gyre at nsub 4, 8, 12, two_layer, coastal_wetdry, shelf_forced at nsub
# 8, the f64 gyre: tools/k1s_probes.py --tail): per tile point, the block's
# points per tile point times (1 + _TAIL_STRIP / qp) for the strips' ends,
# times (1024 / threads) ** _TAIL_THREADS; and the route: two launches
# where the geometry's block has at most _TAIL_MAX_FACTOR points per tile
# point and the case has no open boundary (the coast at nsub 12 f32, 3.5
# points: the three kernels 0.717 ms, two launches 0.739; the shelf, whose
# 19 planes allow only small tiles: nsub 4 f32, 2.3 points, 0.763 against
# 0.733-0.799 by the geometry, nsub 8, 3.9 points, 0.847 against 1.11)
_TAIL_STRIP = 0.5
_TAIL_THREADS = 0.6
_TAIL_MAX_FACTOR = 3.0
# the single-step kernels of each source whose planes decide whether a
# tile fits (off shared memory K1 and the split step stream their layers,
# on one device and on the shards)
_SINGLE = {"fb_step": ("fb_step",),
            "split_step": ("split_slow", "split_recompose")}
# the layer-streamed builds' kernels, by their index in beom_smem_bytes
_STREAMED = {"fb_step": ("fb_momentum", "fb_continuity"),
             "split_step": ("split_slow", "split_rec_h", "split_subcycle",
                            "split_tail", "split_rec_uv")}
# Route 3 streams the split step's layers from _STREAM_FROM layers (and
# wherever no tile fits its slow phase and recomposition).  On the H100 at
# 2048^2 f32 on the shelf with 13 constituents, nsub 8, the slow phase and
# the recomposition on the device (tools/kernel_times.py --layers split,
# parent / change / change / parent), streamed against shared memory: nz
# 2 1.07 ms against 1.05 (32 x 16 tiles), nz 4 1.45 against 1.70, nz 8
# 2.46 against 3.63, nz 16 4.49 against 10.85 (16 x 8), nz 32 8.53
# against 35.0 (8 x 8).  The streamed recomposition wins at every nz, the
# streamed slow phase loses to the shared-memory one up to nz 8 (0.35
# against 0.28 ms at nz 2, 1.17 against 1.09 at nz 8): one build takes
# both, so the rule is their sum's.  At 2048^2 f64 on the same shelf (the
# same tool, the two routes of one checkout, slow + recompose between
# CUDA events) the streamed route wins from nz 2: nz 2 2.40 against 3.04
# ms (32 x 16 tiles), nz 4 3.38 against 4.18, nz 8 5.68 against 8.42
# (16 x 8), nz 16 10.36 against 25.7 (8 x 8).  The rule streams from 4
# layers at both types; below 4 at f64 it is not yet measured on the
# cases at their own sizes (ROADMAP L2).
_STREAM_FROM = 4
_P, _I = ctypes.c_void_p, ctypes.c_int


def check_config(cfg: Config) -> None:
    """Raise on what the kernels cannot run: a scheme other than fb or
    split.  Every term of the eager step is implemented, at any number of
    layers and tidal constituents."""
    if cfg.scheme not in ("fb", "split"):
        raise NotImplementedError(
            f"the fused step implements scheme='fb' and 'split', not "
            f"{cfg.scheme!r}: the projection schemes run through "
            "stencils/fused_projection.py")


def tables(planes: int, n: int, off: int = 4) -> int:
    """Bytes of `planes` bytes of planes and a table of n offsets of `off`
    bytes after them (8 across cards, aligned: fb_terms.cuh table_bytes)."""
    return -(-planes // off) * off + n * off


def single_planes(cfg: Config) -> dict:
    """(halo, planes) of each single-step body (csrc/fb_step_body.cuh fbk,
    split_body.cuh slow and rec): the points a tile's block reaches beyond
    it and the block's planes."""
    nz, wd, obc, nu4 = cfg.nz, cfg.wetdry, cfg.obc, cfg.nu4 != 0.0
    lo = 2 if wd else 1
    return {"fb_step": (lo + 3, 7 * nz + 4 + 2 * nz * nu4 + obc),
            "split_slow": (2, 5 * nz + 4 + 2 * nz * nu4),
            "split_recompose": (lo + 1, 4 * nz + 3 + 3 * nz * wd + obc)}


def smem_bytes(cfg: Config, tile, sub_tile, elem: int, tail=None,
               off: int = 4) -> dict:
    """Dynamic shared memory of one CTA of each kernel at `tile` = (tx, ty)
    (`sub_tile` for the subcycle, whose halo is nsub; `tail` = (qx, qs, qp)
    for the split tail) and `elem` bytes per value: the planes of
    csrc/fb_step.cu and csrc/split_step.cu times the haloed tile, plus the
    table of offsets of `off` bytes where the kernel has one."""
    out = {}
    for kernel, (w, planes) in single_planes(cfg).items():
        npt = (tile[0] + 2 * w) * (tile[1] + 2 * w)
        out[kernel] = tables(npt * planes * elem, npt, off)
    sub = (sub_tile[0] + 2 * cfg.nsub) * (sub_tile[1] + 2 * cfg.nsub)
    out["split_subcycle"] = sub * 10 * elem
    out["split_tail"] = tail_smem(cfg, tail, elem, off) if tail else 0
    return out


def stream_smem(cfg: Config, tile, elem: int, off: int = 4) -> dict:
    """Dynamic shared memory of one CTA of each layer-streamed K1 kernel at
    `tile` (csrc/fb_step_body.cuh: fbs::cont, fbs::mom): planes of one
    layer and the table of offsets.  The continuity's block has the halo
    LO and h, u, v, h1, three masks (+ the fluxes and scales under wet/dry,
    + ee under the open boundary); the momentum's the halo 3 and h1, u, v,
    phi, q, a1, z, acc, four masks (+ lap(u), lap(v) with nu4, + ee)."""
    lo, nu4 = (2 if cfg.wetdry else 1), cfg.nu4 != 0.0
    out = {}
    for kernel, w, planes in (
            ("fb_continuity", lo, 7 + 3 * cfg.wetdry + cfg.obc),
            ("fb_momentum", 3, 12 + 2 * nu4 + cfg.obc)):
        npt = (tile[0] + 2 * w) * (tile[1] + 2 * w)
        out[kernel] = tables(npt * planes * elem, npt, off)
    return out


def split_stream_smem(cfg: Config, tile, elem: int, off: int = 4) -> dict:
    """Dynamic shared memory of one CTA of each layer-streamed split kernel
    at `tile` (csrc/split_body.cuh: sps): planes of one or two layers and
    the table of offsets.  The slow phase's block has the halo 2 and h,
    u, v of two layers, phi, q, z, acc, four masks (+ lap(u), lap(v) with
    nu4); the recomposition's continuity the halo LO and h, u', v' of two
    layers, h1, three masks, the mean advecting velocities (+ the fluxes
    and scales under wet/dry); its velocities the halo 1 and three masks
    (+ h1 where the gates or Flather read it, + ee under the open
    boundary)."""
    lo, nu4 = (2 if cfg.wetdry else 1), cfg.nu4 != 0.0
    out = {}
    for kernel, w, planes in (
            ("split_slow", 2, 14 + 2 * nu4),
            ("split_rec_h", lo, 12 + 3 * cfg.wetdry),
            ("split_rec_uv", 1, 3 + (cfg.wetdry or cfg.obc) + cfg.obc)):
        npt = (tile[0] + 2 * w) * (tile[1] + 2 * w)
        out[kernel] = tables(npt * planes * elem, npt, off)
    return out


def tile_or_stream(need, off_smem: bool = False):
    """(tile, stream) of single-step kernels whose CTA at a tile needs
    need(tile) bytes of shared memory: the first of _TILES that fits;
    where none fits, or where `off_smem` is true (to force it), the route
    off shared memory, layer-streamed on one device and on the shards alike,
    at the largest tile."""
    fits = [t for t in _TILES if need(t) <= _MAX_SMEM]
    off = bool(off_smem) or not fits
    return (_TILES[0] if off else fits[0]), off


def single_tile(cfg: Config, dtype=None, off_smem: bool = False):
    """tile_or_stream of the single-step kernels of cfg's scheme (K1's, or
    the split step's slow phase and recomposition)."""
    elem = torch.empty((), dtype=dtype or cfg.tdtype).element_size()
    name = "fb_step" if cfg.scheme == "fb" else "split_step"
    return tile_or_stream(lambda t: max(
        smem_bytes(cfg, t, t, elem)[k] for k in _SINGLE[name]), off_smem)


def tail_halo(cfg: Config) -> int:
    """The split tail's halo, nsub + LO + E: after nsub substeps the
    barotropic fields are exact on the recomposition's block, whose halo
    is the continuity's LO (2 under wet/dry, else 1) and E = 1 where
    fb.finalize reads the new thickness east and north (wet/dry, the open
    boundary), else 0."""
    return cfg.nsub + (2 if cfg.wetdry else 1) + int(cfg.wetdry or cfg.obc)


def tail_smem(cfg: Config, tail, elem: int, off: int = 4) -> int:
    """Shared memory of one CTA of the split tail of geometry tail = (qx,
    qs, qp): 4 + 4 nz (+ 3 nz wet/dry, + 1 open boundary) planes of its
    block and its row and column offsets (csrc/split_body.cuh, tail)."""
    qx, qs, qp = tail
    rx, ry = qx + 2 * tail_halo(cfg), qs * qp
    planes = 4 + 4 * cfg.nz + 3 * cfg.nz * cfg.wetdry + cfg.obc
    return tables(planes * rx * ry * elem, rx + ry + 2, off)


def _pick(tiles, need, what):
    """The first of `tiles` whose need(tile) bytes fit a CTA."""
    for tile in tiles:
        if need(tile) <= _MAX_SMEM:
            return tile
    raise NotImplementedError(
        f"{what} needs {need(tiles[-1])} bytes of shared memory at its "
        f"smallest tile {tiles[-1]}, above the {_MAX_SMEM} a CTA can use")


def halo_width(cfg: Config) -> int:
    """W, the points one fb step reads beyond the points it writes on each
    axis (csrc/fb_step_body.cuh): 4, or 5 under wet/dry."""
    return 5 if cfg.wetdry else 4


def pass_planes(cfg: Config) -> int:
    """Shared-memory planes of the fb pass kernel (csrc/fb_step_body.cuh,
    fbp::Plane): five rotating groups of nz and the step's three
    intermediates, the statics the switches read."""
    nz, obc = cfg.nz, cfg.obc
    ntide = len(cfg.tides) if obc else 0
    return (8 * nz + 2 * nz * (cfg.nu4 != 0.0) + obc + 6 + 2 * cfg.wind
            + cfg.sponge + nz * (cfg.sponge or obc) + 3 * obc + 2 * ntide)


def pass_smem(cfg: Config, kb: int, tile, elem: int, off: int = 4) -> int:
    """Dynamic shared memory of one CTA of the pass kernel of kb steps at
    `tile`: its planes of the block with a halo of kb W, and the block's
    row and column offsets."""
    h = kb * halo_width(cfg)
    rx, ry = tile[0] + 2 * h, tile[1] + 2 * h
    return tables(pass_planes(cfg) * rx * ry * elem, rx + ry, off)


def stage_points(cfg: Config, kb: int, tile) -> int:
    """Points the stages S1 to S4 compute in one launch of kb steps on one
    block (the single-step kernel's block at kb = 1): step i on
    [i W, R - i W), its last step's S4 on the tile."""
    w, lo = halo_width(cfg), 2 if cfg.wetdry else 1
    h = kb * w
    rx, ry = tile[0] + 2 * h, tile[1] + 2 * h
    total = 0
    for i in range(kb):
        a = i * w
        cuts = [2 * lo, 2 * lo + 1, 2 * lo + 3]
        if cfg.wetdry:
            cuts += [1, 2]
        total += sum((rx - 2 * a - c) * (ry - 2 * a - c) for c in cuts)
        total += tile[0] * tile[1] if i == kb - 1 else \
            (rx - 2 * a - 2 * w) * (ry - 2 * a - 2 * w)
    return total


def plan_cost(cfg: Config, kb: int, tile) -> float:
    """The cost model of a launch plan per point and step, in stage-points:
    the stages' work and the block's loads (every field once), over the
    kb steps of the tile's points."""
    h = kb * halo_width(cfg)
    block = (tile[0] + 2 * h) * (tile[1] + 2 * h)
    fields = 3 * cfg.nz + pass_planes(cfg) - 8 * cfg.nz \
        - 2 * cfg.nz * (cfg.nu4 != 0.0) - cfg.obc
    work = (stage_points(cfg, kb, tile) + _LOAD_COST * block * fields) \
        / (kb * tile[0] * tile[1])
    return work * (_PASS_FACTOR if kb > 1 else 1.0)


def launch_steps(k: int, kb: int) -> list:
    """Steps of each launch of a pass of k steps at kb steps per launch:
    ceil(k / kb) launches, the last of k mod kb steps."""
    return [kb] * (k // kb) + ([k % kb] if k % kb else [])


@dataclasses.dataclass(frozen=True)
class Plan:
    """How K1 runs the steps of one launch: kb steps in the pass kernel on
    `tile` with `threads` per CTA, or at kb = 1 the single-step kernel at
    its own tile, or where no tile's planes of every layer fit a CTA
    (`stream`) the layer-streamed kernels, two launches per step; `smem`
    bytes of shared memory per CTA (the larger of the two streamed
    kernels')."""
    kb: int
    tile: tuple
    threads: int
    smem: int
    stream: bool = False

    def launches(self, k: int) -> list:
        return launch_steps(k, self.kb)

    def describe(self) -> str:
        kernel = "the single-step kernel" if self.kb == 1 else \
            f"the pass kernel (halo {self.kb} W)"
        if self.stream:
            kernel = ("the layer-streamed kernels (two launches per step: "
                      "the continuity, then the momentum, one layer at a "
                      "time in shared memory)")
        return (f"kb {self.kb}: {kernel}, tile {self.tile[0]} x "
                f"{self.tile[1]}, {self.threads} threads, {self.smem} bytes "
                "of shared memory per CTA")


@functools.lru_cache(maxsize=None)
def launch_plan(cfg: Config, dtype, m: int, off_smem: bool = False):
    """The build that advances m fb steps in one launch, or None where no
    block with a halo of m W fits a CTA: at m = 1 the single-step kernel
    (single_tile: layer-streamed where no tile fits, or where `off_smem`
    forces it), else the pass kernel at the tile of least plan_cost whose
    CTA fits one SM's shared memory, with 1024 threads where one CTA fits
    an SM and 512 where two do."""
    check_config(cfg)
    elem = torch.empty((), dtype=dtype or cfg.tdtype).element_size()
    if m == 1:
        one, stream = single_tile(cfg, dtype, off_smem)
        smem = max(stream_smem(cfg, one, elem).values()) if stream else \
            smem_bytes(cfg, one, one, elem)["fb_step"]
        return Plan(1, one, 256, smem, stream)
    fits = [t for t in _PASS_TILES if pass_smem(cfg, m, t, elem) <= _MAX_SMEM]
    if not fits:
        return None
    tile = min(fits, key=lambda t: plan_cost(cfg, m, t))
    need = pass_smem(cfg, m, tile, elem)
    return Plan(m, tile, 512 if 2 * (need + 1024) <= 233472 else 1024, need)


@functools.lru_cache(maxsize=None)
def plan(cfg: Config, dtype=None, k: int = None,
         off_smem: bool = False) -> Plan:
    """The launch plan of a pass of k fb steps (default: steps_per_pass):
    the kb <= k whose launches (Plan.launches) cost the least by plan_cost
    at their builds' tiles; with off_smem=True the layer-streamed kernels
    (to hold them against the shared-memory route where both build)."""
    k = k or cfg.steps_per_pass
    if off_smem:
        return launch_plan(cfg, dtype, 1, True)

    def cost(kb):
        pl = launch_plan(cfg, dtype, kb)
        if pl is None:
            return math.inf
        return sum(m * plan_cost(cfg, m, launch_plan(cfg, dtype, m).tile)
                   for m in pl.launches(k))

    return launch_plan(cfg, dtype, min(range(1, min(k, _PLAN_KB) + 1),
                                       key=cost))


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """How K1s runs a split step: route 2, two launches (the slow phase's
    tendencies, then the tail on blocks of rx x ry points around tiles of
    qx x qy, qs strips of qp rows per column, rx qs threads), or route 3,
    the three kernels; `smem` the tail's bytes per CTA.  The tail's
    geometry is built into the library either way.  With `stream` the slow
    phase (its tendencies) and the recomposition stream their layers (the
    recomposition in two launches)."""
    route: int
    qx: int
    qs: int
    qp: int
    halo: int
    smem: int
    stream: bool = False

    @property
    def rx(self) -> int:
        return self.qx + 2 * self.halo

    @property
    def qy(self) -> int:
        return self.qs * self.qp - 2 * self.halo

    @property
    def threads(self) -> int:
        return self.rx * self.qs

    @property
    def tail(self) -> tuple:
        return (self.qx, self.qs, self.qp)

    def launches(self) -> int:
        return 2 if self.route == 2 else 3 + self.stream

    def describe(self) -> str:
        if self.route == 3:
            stream = "; the slow phase and the recomposition " \
                "layer-streamed (one layer at a time in shared memory, the " \
                "recomposition in two launches)" if self.stream else ""
            return ("route 3: the slow phase, the subcycle, the "
                    f"recomposition{stream}")
        stream = "; the tendencies layer-streamed (one layer at a time in " \
            "shared memory)" if self.stream else ""
        return (f"route 2: the slow phase's tendencies, then the tail on "
                f"{self.qx} x {self.qy} tiles (blocks of {self.rx} x "
                f"{self.qs * self.qp}, halo {self.halo}), {self.threads} "
                f"threads ({self.qs} strips of {self.qp} rows per column), "
                f"{self.smem} bytes of shared memory per CTA{stream}")


def tail_geometries(cfg: Config, dtype=None) -> list:
    """Every tail geometry (qx, qs, qp) that builds and fits one CTA per
    SM: rx a whole number of warps, 512 to 1024 threads, a tile of at
    least 8 rows, its shared memory and its registers within the SM's."""
    elem = torch.empty((), dtype=dtype or cfg.tdtype).element_size()
    words = elem // 4
    h = tail_halo(cfg)
    out = []
    for rx in _TAIL_WIDTHS:
        for qs in _TAIL_STRIPS:
            threads = rx * qs
            if rx <= 2 * h or not 512 <= threads <= 1024:
                continue
            budget = min(255, 65536 // threads // 8 * 8)
            for qp in range(1, 33):
                tail = (rx - 2 * h, qs, qp)
                if qs * qp - 2 * h >= 8 \
                        and 9 * qp * words + _TAIL_REGS <= budget \
                        and tail_smem(cfg, tail, elem) <= _MAX_SMEM:
                    out.append(tail)
    return out


def tail_factor(cfg: Config, tail) -> float:
    """Block points the tail computes per tile point: its halo's cost."""
    qx, qs, qp = tail
    h = tail_halo(cfg)
    return (qx + 2 * h) * qs * qp / (qx * (qs * qp - 2 * h))


def tail_cost(cfg: Config, tail) -> float:
    """The cost model of a tail geometry per tile point (_TAIL_STRIP,
    _TAIL_THREADS)."""
    qx, qs, qp = tail
    threads = (qx + 2 * tail_halo(cfg)) * qs
    return tail_factor(cfg, tail) * (1 + _TAIL_STRIP / qp) \
        * (1024 / threads) ** _TAIL_THREADS


@functools.lru_cache(maxsize=None)
def split_plan(cfg: Config, dtype=None, off_smem: bool = False) -> SplitPlan:
    """The route of a split step and the tail's geometry: the geometry of
    least tail_cost; route 2 where it fits with at most _TAIL_MAX_FACTOR
    block points per tile point and there is no open boundary, else route
    3 (where no geometry fits, the build's tail is one column wide with
    as many strips of one row as a CTA holds: it is never launched, and
    strips of one row keep it quick to compile).  Route 3's slow phase and
    recomposition stream their layers from _STREAM_FROM layers and where
    no tile fits them (single_tile); route 2's tendencies keep shared
    memory.  `off_smem` forces the streamed kernels on either route."""
    check_config(cfg)
    dtype = dtype or cfg.tdtype
    elem = torch.empty((), dtype=dtype).element_size()
    h = tail_halo(cfg)
    off = single_tile(cfg, dtype, off_smem)[1]
    stream = off or cfg.nz >= _STREAM_FROM
    fits = tail_geometries(cfg, dtype)
    if not fits:
        rows = 2 * h + 1
        qs = min(rows, 1024 // rows)
        qp = -(-rows // qs)
        return SplitPlan(3, 1, qs, qp, h, tail_smem(cfg, (1, qs, qp), elem),
                         stream)
    tail = min(fits, key=lambda g: (tail_cost(cfg, g), -g[1]))
    route = 2 if tail_factor(cfg, tail) <= _TAIL_MAX_FACTOR \
        and not cfg.obc else 3
    return SplitPlan(route, *tail, h, tail_smem(cfg, tail, elem),
                     off or (route == 3 and stream))


def term_defines(cfg: Config, tile):
    """The compile-time switches of csrc/fb_terms.cuh for cfg, and the
    tile."""
    return (f"BEOM_NZ={cfg.nz}", f"BEOM_WETDRY={int(cfg.wetdry)}",
            f"BEOM_OBC={int(cfg.obc)}", f"BEOM_SPONGE={int(cfg.sponge)}",
            f"BEOM_NTIDE={len(cfg.tides) if cfg.obc else 0}",
            f"BEOM_NU4={int(cfg.nu4 != 0.0)}",
            f"BEOM_CDBOT={int(cfg.cd_bot != 0.0)}",
            f"BEOM_RINT={int(cfg.r_int != 0.0 and cfg.nz > 1)}",
            f"BEOM_TX={tile[0]}", f"BEOM_TY={tile[1]}")


def build_spec(cfg: Config, dtype=None, kb: int = 1, sp=None,
               off_smem: bool = False):
    """(source, defines) of the build that runs cfg: fb_step.cu or
    split_step.cu with the compile-time switches and the tile; off shared
    memory BEOM_STREAM=1, layer-streamed: K1 where no tile fits
    (single_tile, `off_smem` forces it), the split step where the split
    plan `sp` streams (default split_plan(cfg, dtype, off_smem)), which
    also gives the tail's geometry; with kb > 1 the fb pass kernel of kb
    steps at the plan's tile and threads.  The shard kernels' builds
    (dist_band.build_spec) take these defines."""
    check_config(cfg)
    if kb > 1:
        pl = launch_plan(cfg, dtype, kb)
        if pl is None:
            raise ValueError(f"no pass kernel of kb = {kb} steps fits a "
                             "CTA")
        return "fb_step", term_defines(cfg, pl.tile) + (
            f"BEOM_KB={kb}", f"BEOM_THREADS={pl.threads}",
            f"BEOM_WIND={int(cfg.wind)}")
    elem = torch.empty((), dtype=dtype or cfg.tdtype).element_size()
    name = "fb_step" if cfg.scheme == "fb" else "split_step"
    if sp is not None and off_smem:
        raise ValueError("a split plan and off_smem both given: the plan "
                         "names the route")
    tile, off = single_tile(cfg, dtype, off_smem)
    if name == "split_step":
        sp = sp or split_plan(cfg, dtype, off_smem)
        off = sp.stream
        tile = _TILES[0] if off else single_tile(cfg, dtype)[0]
    defines = term_defines(cfg, tile) + (("BEOM_STREAM=1",) if off else ())
    if name == "split_step":
        sub = _pick(_SUB_TILES, lambda t: smem_bytes(
            cfg, tile, t, elem)["split_subcycle"],
            f"the subcycle of nsub = {cfg.nsub} substeps")
        qx, qs, qp = sp.tail
        defines += (f"BEOM_NSUB={cfg.nsub}", f"BEOM_SX={sub[0]}",
                    f"BEOM_SY={sub[1]}", f"BEOM_QX={qx}", f"BEOM_QS={qs}",
                    f"BEOM_QP={qp}")
    return name, defines


def pass_specs(cfg: Config, k: int, dtype=None) -> set:
    """The builds a pass of k fb steps launches."""
    return {build_spec(cfg, dtype, m)
            for m in set(plan(cfg, dtype, k).launches(k))}


def fused_fb_step_plain(h, u, v, statics, n: int, t, cfg: Config, k: int):
    """k eager steps of cfg.scheme (fb_step or split_step): the plain
    PyTorch version of the kernels.

    statics = (grid, forcing).  Returns (h, u, v) after k steps.
    """
    grid, forcing = statics
    step = split_mod.split_step if cfg.scheme == "split" else fb_mod.fb_step
    s = State(h=h, u=u, v=v, t=t, n=n)
    for _ in range(k):
        s = step(s, grid, forcing, cfg)
    return s.h, s.u, s.v


def _operands(statics):
    grid, forcing = statics
    return ([getattr(grid, name) for name in _GRID_NAMES]
            + [getattr(forcing, name) for name in _FORCING_NAMES])


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _array(ctype, values):
    return (ctype * len(values))(*values)


def _pointers(tensors):
    return _array(_P, [a.data_ptr() for a in tensors])


@functools.lru_cache(maxsize=None)
def _entries(cfg: Config, dtype, kb: int = 1, sp=None,
             off_smem: bool = False):
    """The library of build_spec(cfg, dtype, kb, sp, off_smem) and its
    entry points by kernel name, built on first use."""
    from beom_tpu_torch.stencils import build

    name, defines = build_spec(cfg, dtype, kb, sp, off_smem)
    lib = build.load((name, defines))
    value = {d.split("=")[0]: int(d.split("=")[1]) for d in defines}
    elem = torch.empty((), dtype=dtype).element_size()
    tile = (value["BEOM_TX"], value["BEOM_TY"])
    want = smem_bytes(cfg, tile,
                      (value.get("BEOM_SX", 0), value.get("BEOM_SY", 0)),
                      elem, (value.get("BEOM_QX"), value.get("BEOM_QS"),
                             value.get("BEOM_QP"))
                      if name == "split_step" else None)
    kernels = _TILED[name]
    if kb > 1:
        want["fb_step"] = pass_smem(cfg, kb, tile, elem)
    if "BEOM_STREAM=1" in defines:
        want.update(stream_smem(cfg, tile, elem) if name == "fb_step" else
                    split_stream_smem(cfg, tile, elem))
        kernels = _STREAMED[name]
    for i, kernel in enumerate(kernels):
        have = lib.beom_smem_bytes(i, int(elem == 8))
        if have != want[kernel]:
            raise RuntimeError(
                f"{kernel}: the kernel's shared memory ({have} bytes) is "
                f"not what smem_bytes counts ({want[kernel]})")

    # every argument is a pointer: the operand tables, the outputs, the
    # stream
    n_args = {"fb_step": 7, "split_slow": 5, "split_subcycle": 6,
              "split_recompose": 9, "split_tend": 5, "split_tail": 8}
    entries = {}
    kernels = _TILED[name] + (("split_tend",) if name == "split_step" else ())
    for kernel in kernels:
        fn = getattr(lib, f"beom_{kernel}_{_SUFFIX[dtype]}")
        fn.argtypes = [_P] * n_args[kernel]
        fn.restype = _I
        entries[kernel] = fn
    return lib, entries


@dataclasses.dataclass(frozen=True)
class SlotLayout:
    """The double slots of a build (csrc/fb_terms.cuh: enum Dbl): the
    first of the nz reduced gravities, of the tidal frequencies (one per
    constituent of the build, at least one) and of the fb pass's step
    times, and their count."""
    gp0: int
    omega0: int
    ts0: int
    n: int


# the double slot of t1 (csrc/fb_terms.cuh: Dbl::D_T1), the int slots
# (enum Int) and the host table's pointers (N_PTR: the operands)
D_T1 = 12
N_INT = 9
N_PTR = 3 + len(_GRID_NAMES) + len(_FORCING_NAMES)


def build_tides(cfg: Config) -> int:
    """The tidal constituents a build takes (BEOM_NTIDE): cfg's, where the
    open boundary that reads them is on."""
    return len(cfg.tides) if cfg.obc else 0


def slot_layout(cfg: Config) -> SlotLayout:
    """The double slots of cfg's builds, sized as the build sizes them:
    D_OMEGA0 = D_GP0 + NZ, D_TS0 = D_OMEGA0 + max(NTIDE, 1), N_DBL =
    D_TS0 + MAX_KB."""
    gp0 = D_T1 + 1
    omega0 = gp0 + cfg.nz
    ts0 = omega0 + max(build_tides(cfg), 1)
    return SlotLayout(gp0, omega0, ts0, ts0 + _MAX_KB)


# a kernel's parameters (csrc/fb_terms.cuh: PARAM_LIMIT) and the share of
# them Params may take (PARAMS_MAX)
PARAM_LIMIT = 4096
PARAMS_MAX = PARAM_LIMIT - 1536


def params_bytes(cfg: Config, elem: int, cards: bool = False) -> int:
    """sizeof(Params<T>) of cfg's build for T of `elem` bytes
    (csrc/fb_terms.cuh), laid out by the C rules: each member at a multiple
    of its alignment, the whole a multiple of the largest.  Across cards
    an operand is the nine pointers of its stacks."""
    members = [(N_PTR * (72 if cards else 8), 8), (N_INT * 4, 4),
               (16 * elem, elem), (cfg.nz * elem, elem),
               (max(build_tides(cfg), 1) * elem, elem), (_MAX_KB * elem, elem),
               (8, 8)]
    size = 0
    for n, align in members:
        size = -(-size // align) * align + n
    return -(-size // 8) * 8


def _scalars(cfg: Config, parity: int, t1, ny=None, nx=None, ts=(),
             aligned=False):
    """The int and double operand slots (csrc/fb_terms.cuh: Int, Dbl, the
    doubles laid out by slot_layout); (ny, nx) is the extent of the block
    stepped when it is not the whole grid; ts the time t1 of each step of
    an fb pass launch, `aligned` whether its operands all start 16-byte
    aligned."""
    lay = slot_layout(cfg)
    ints = [ny or cfg.ny, nx or cfg.nx, int(parity == 0),
            int(cfg.adv_scheme == "sadourny_energy"),
            int(cfg.slip == "free"), int(cfg.nu2 != 0.0), int(cfg.wind),
            cfg.nsub, int(aligned)]
    dbls = [cfg.dt, cfg.dx, cfg.dy, cfg.g, cfg.nu2, cfg.nu4, cfg.rho0,
            cfg.h_min, cfg.h_dry, cfg.r_bot, cfg.cd_bot, cfg.r_int,
            float(t1)]
    dbls += list(cfg.gprime)[:cfg.nz]
    dbls += (list(cfg.tides)[:build_tides(cfg)] + [0.0])[
        :lay.ts0 - lay.omega0]
    dbls += ([float(x) for x in ts] + [0.0] * _MAX_KB)[:_MAX_KB]
    assert len(ints) == N_INT and len(dbls) == lay.n
    return _array(_I, ints), _array(ctypes.c_double, dbls)


def _table(fields, statics):
    """The host table of a launch (csrc/fb_terms.cuh: N_PTR pointers): the
    fields h, u, v (or the phase's) and the statics' operands."""
    return _array(_P, [a.data_ptr() for a in list(fields)
                       + _operands(statics)])


class Operands:
    """The operand table and scalar slots of a held launch: what a launch
    does not change is made once (the statics' pointers, whether they all
    start 16-byte aligned, the scalars of both parities aligned or not),
    and `set` fills in the rest."""

    def __init__(self, statics: list, cfg: Config):
        self.ptrs = _array(_P, [0, 0, 0] + [a.data_ptr() for a in statics])
        self._aligned = all(a.data_ptr() % 16 == 0 for a in statics)
        self._sc = {(par, al): _scalars(cfg, par, 0.0, aligned=al)
                    for par in (0, 1) for al in (False, True)}
        self._ts0 = slot_layout(cfg).ts0

    def set(self, parity: int, fields, t1=None, ts=(), aligned=None):
        """(ptrs, ints, dbls) with h, u, v = fields[:3] in the table, the
        aligned switch over every field (and `aligned` where given: the
        other operands a launch reads), and t1 and the step times in their
        slots where given."""
        p = self.ptrs
        p[0], p[1], p[2] = (a.data_ptr() for a in fields[:3])
        aligned = self._aligned and aligned is not False and all(
            a.data_ptr() % 16 == 0 for a in fields)
        ints, dbls = self._sc[parity, aligned]
        if t1 is not None:
            dbls[D_T1] = float(t1)
        for i, x in enumerate(ts):
            dbls[self._ts0 + i] = float(x)
        return p, ints, dbls


def _check_operands(h, u, v, statics, cfg: Config, check=None,
                    extent=None):
    """Raise unless every operand is what the kernels take; `check` is the
    caller's check of the Config (default: check_config), `extent` the
    (ny, nx) of the block stepped (default: the whole grid)."""
    if h.device.type != "cuda":
        raise NotImplementedError(
            f"the fused step runs on cuda or cpu, not {h.device.type}")
    (check or check_config)(cfg)
    if h.dtype not in _SUFFIX or h.dtype != cfg.tdtype:
        raise ValueError(f"fused step: dtype {h.dtype} with cfg.dtype "
                         f"{cfg.dtype}")
    nc = max(len(cfg.tides), 1)
    lead = {"h_ext": (cfg.nz,), "tide_amp": (nc,), "tide_phase": (nc,)}
    names = ("h", "u", "v") + _GRID_NAMES + _FORCING_NAMES
    ny, nx = extent or (cfg.ny, cfg.nx)
    for name, a in zip(names, [h, u, v] + _operands(statics)):
        shape = lead.get(name, (cfg.nz,) if name in ("h", "u", "v") else ()) \
            + (ny, nx)
        if a.device != h.device or a.dtype != h.dtype \
                or not a.is_contiguous() or tuple(a.shape) != shape:
            raise ValueError(
                f"fused step: {name} must be a contiguous {h.dtype} tensor "
                f"of {shape} on {h.device}, not {a.dtype} "
                f"{tuple(a.shape)} on {a.device}")


def _launch_fb(h, u, v, statics, parity: int, ts, cfg: Config, pl=None):
    """One launch of K1 by the launch plan `pl` of len(ts) steps (default:
    launch_plan's), step i to the time ts[i]; a layer-streamed step is the
    entry's two launches, the continuity writing h1 into the first output
    and the momentum reading it there."""
    global LAUNCHES, PASS_LAUNCHES
    from beom_tpu_torch.stencils import build

    pl = pl or launch_plan(cfg, h.dtype, len(ts))
    if pl.kb != len(ts):
        raise ValueError(f"a launch of {len(ts)} steps by a plan of kb = "
                         f"{pl.kb}")
    lib, entry = _entries(cfg, h.dtype, pl.kb, off_smem=pl.stream)
    outs = [torch.empty_like(h) for _ in range(3)]
    operands = [h, u, v] + _operands(statics)
    aligned = all(a.data_ptr() % 16 == 0 for a in operands + outs)
    ints, dbls = _scalars(cfg, parity, ts[0], ts=ts, aligned=aligned)
    code = entry["fb_step"](
        _table((h, u, v), statics), ints, dbls,
        *[a.data_ptr() for a in outs], _stream(h.device))
    build.check(lib, code, "fb_step kernel launch")
    LAUNCHES += 1
    PASS_LAUNCHES += len(ts) > 1
    if pl.stream:
        STREAM_LAUNCHES["fb_continuity"] += 1
        STREAM_LAUNCHES["fb_momentum"] += 1
    return outs


def _split_entries(cfg: Config, dtype, sp):
    """(split plan, library, entry points) of a split launch by the plan
    `sp` (default: split_plan's)."""
    sp = sp or split_plan(cfg, dtype)
    return (sp,) + _entries(cfg, dtype, 1, sp)


def _launch_slow(h, u, v, statics, cfg: Config, sp=None):
    """The slow phase by the split plan `sp` (default: split_plan's):
    SlowPhase's 13 fields in its order, cu and cv as the bottom layer's
    (ny, nx) plane."""
    from beom_tpu_torch.stencils import build

    sp, lib, entry = _split_entries(cfg, h.dtype, sp)
    plane = h[0]
    outs = [torch.empty_like(h) for _ in range(4)] \
        + [torch.empty_like(plane) for _ in range(9)]
    ints, dbls = _scalars(cfg, 0, 0.0)
    code = entry["split_slow"](
        _table((h, u, v), statics), ints, dbls, _pointers(outs),
        _stream(h.device))
    build.check(lib, code, "split_slow kernel launch")
    SPLIT_LAUNCHES["slow"] += 1
    STREAM_LAUNCHES["split_slow"] += sp.stream
    return outs


def _launch_subcycle(slow, h, u, v, statics, cfg: Config, sp=None):
    """(eta_f, ubar_f, vbar_f, ubar_avg, vbar_avg) from _launch_slow's
    fields, in the build of the split plan `sp`."""
    from beom_tpu_torch.stencils import build

    _, lib, entry = _split_entries(cfg, h.dtype, sp)
    outs = [torch.empty_like(slow[-1]) for _ in range(5)]
    ints, dbls = _scalars(cfg, 0, 0.0)
    code = entry["split_subcycle"](
        _table((h, u, v), statics), ints, dbls,
        _pointers(slow), _pointers(outs), _stream(h.device))
    build.check(lib, code, "split_subcycle kernel launch")
    SPLIT_LAUNCHES["subcycle"] += 1
    return outs


def _launch_recompose(slow, sub, h, u, v, statics, t1, cfg: Config,
                      sp=None):
    from beom_tpu_torch.stencils import build

    sp, lib, entry = _split_entries(cfg, h.dtype, sp)
    outs = [torch.empty_like(h) for _ in range(3)]
    ints, dbls = _scalars(cfg, 0, t1)
    code = entry["split_recompose"](
        _table((h, u, v), statics), ints, dbls, _pointers(slow),
        _pointers(sub), *[a.data_ptr() for a in outs], _stream(h.device))
    build.check(lib, code, "split_recompose kernel launch")
    SPLIT_LAUNCHES["recompose"] += 1
    STREAM_LAUNCHES["split_recompose"] += sp.stream
    return outs


def _launch_tend(h, u, v, statics, cfg: Config, sp=None):
    """The slow phase's layer tendencies (du_s, dv_s) of the two-launch
    step, in the build of the split plan `sp`."""
    from beom_tpu_torch.stencils import build

    sp, lib, entry = _split_entries(cfg, h.dtype, sp)
    outs = [torch.empty_like(h) for _ in range(2)]
    ints, dbls = _scalars(cfg, 0, 0.0)
    code = entry["split_tend"](
        _table((h, u, v), statics), ints, dbls, _pointers(outs),
        _stream(h.device))
    build.check(lib, code, "split_tend kernel launch")
    SPLIT_LAUNCHES["tend"] += 1
    STREAM_LAUNCHES["split_tend"] += sp.stream
    return outs


def _launch_tail(tend, h, u, v, statics, t1, cfg: Config, sp=None):
    """The tail of the two-launch step: (h, u, v) at t1 from the state and
    its tendencies, at the tail geometry of the split plan `sp`."""
    from beom_tpu_torch.stencils import build

    _, lib, entry = _split_entries(cfg, h.dtype, sp)
    outs = [torch.empty_like(h) for _ in range(3)]
    ints, dbls = _scalars(cfg, 0, t1)
    code = entry["split_tail"](
        _table((h, u, v), statics), ints, dbls,
        _pointers(tend), *[a.data_ptr() for a in outs], _stream(h.device))
    build.check(lib, code, "split_tail kernel launch")
    SPLIT_LAUNCHES["tail"] += 1
    return outs


def _slow_fields(sp: SlowPhase, cfg: Config):
    """SlowPhase as the kernels pass it: cu, cv as the bottom plane."""
    return [a.contiguous() for a in sp[:11]] + [
        sp.cu[cfg.nz - 1].contiguous(), sp.cv[cfg.nz - 1].contiguous()]


def split_slow(h, u, v, statics, cfg: Config, sp=None) -> SlowPhase:
    """split.slow_phase: the kernel on CUDA tensors (by the split plan
    `sp`, default split_plan's), the eager function on CPU tensors."""
    grid, forcing = statics
    if h.device.type == "cpu":
        return split_mod.slow_phase(State(h=h, u=u, v=v, t=0.0, n=0), grid,
                                    forcing, cfg)
    _check_operands(h, u, v, statics, cfg)
    with torch.cuda.device(h.device):
        f = _launch_slow(h, u, v, statics, cfg, sp)
    kb = cfg.nz - 1
    return SlowPhase(*f[:11], cu=drag._on_layer(f[11], kb, cfg.nz),
                     cv=drag._on_layer(f[12], kb, cfg.nz))


def split_subcycle(slow: SlowPhase, h, u, v, statics, cfg: Config,
                   sp=None):
    """split.subcycle_phase: (eta_f, ubar_f, vbar_f, ubar_avg, vbar_avg),
    in the build of the split plan `sp` (default split_plan's)."""
    grid, _ = statics
    if h.device.type == "cpu":
        return split_mod.subcycle_phase(slow, grid, cfg)
    _check_operands(h, u, v, statics, cfg)
    with torch.cuda.device(h.device):
        return tuple(_launch_subcycle(_slow_fields(slow, cfg), h, u, v,
                                      statics, cfg, sp))


def split_recompose(slow: SlowPhase, sub, h, u, v, statics, t,
                    cfg: Config, sp=None):
    """split.recompose followed by fb.finalize: (h1, u1, v1) at t + dt (by
    the split plan `sp`, default split_plan's)."""
    grid, forcing = statics
    if h.device.type == "cpu":
        h1, u1, v1 = split_mod.recompose(slow, *sub, h, grid, cfg)
        s = fb_mod.finalize(h1, u1, v1, State(h=h, u=u, v=v, t=t, n=0),
                            grid, forcing, cfg)
        return s.h, s.u, s.v
    _check_operands(h, u, v, statics, cfg)
    t1 = advance_time(t, cfg.dt, cfg.npdtype)
    with torch.cuda.device(h.device):
        return tuple(_launch_recompose(
            _slow_fields(slow, cfg), [a.contiguous() for a in sub], h, u,
            v, statics, t1, cfg, sp))


def split_tend(h, u, v, statics, cfg: Config, sp=None):
    """split.slow_tendencies, (du_s, dv_s): the kernel on CUDA tensors (by
    the split plan `sp`, default split_plan's), the eager function on CPU
    tensors."""
    grid, forcing = statics
    if h.device.type == "cpu":
        return split_mod.slow_tendencies(State(h=h, u=u, v=v, t=0.0, n=0),
                                         grid, forcing, cfg)
    _check_operands(h, u, v, statics, cfg)
    with torch.cuda.device(h.device):
        return tuple(_launch_tend(h, u, v, statics, cfg, sp))


def split_tail(tend, h, u, v, statics, t, cfg: Config, sp=None):
    """split.depth_means from (du_s, dv_s) = tend, then split.fast_phase:
    (h1, u1, v1) at t + dt, at the tail geometry of the split plan `sp`
    (default split_plan's)."""
    grid, forcing = statics
    if h.device.type == "cpu":
        s = State(h=h, u=u, v=v, t=t, n=0)
        s = split_mod.fast_phase(split_mod.depth_means(s, *tend, grid, cfg),
                                 s, grid, forcing, cfg)
        return s.h, s.u, s.v
    _check_operands(h, u, v, statics, cfg)
    t1 = advance_time(t, cfg.dt, cfg.npdtype)
    with torch.cuda.device(h.device):
        return tuple(_launch_tail([a.contiguous() for a in tend], h, u, v,
                                  statics, t1, cfg, sp))


def fused_fb_step(h, u, v, statics, n: int, t, cfg: Config, k: int,
                  pl=None):
    """Advance (h, u, v) by k steps of cfg.scheme ('fb' or 'split') from
    step n at time t.

    CPU tensors take the plain version.  CUDA tensors take the kernels by
    the plan `pl` (default: `plan` of k steps for fb, `split_plan` for
    split): ceil(k / kb) launches per pass of fb steps (the layer-streamed
    step two), two or three per split step (four where the slow phase and
    the recomposition stream their layers).
    """
    if h.device.type == "cpu":
        return fused_fb_step_plain(h, u, v, statics, n, t, cfg, k)
    _check_operands(h, u, v, statics, cfg)
    with torch.cuda.device(h.device):
        if cfg.scheme == "fb":
            pl = pl or plan(cfg, h.dtype, k)
            for m in pl.launches(k):
                ts = _times(t, cfg, m)
                h, u, v = _launch_fb(h, u, v, statics, n % 2, ts, cfg,
                                     pl if m == pl.kb else None)
                n, t = n + m, ts[-1]
            return h, u, v
        sp = pl or split_plan(cfg, h.dtype)
        for _ in range(k):
            t1 = advance_time(t, cfg.dt, cfg.npdtype)
            if sp.route == 2:
                tend = _launch_tend(h, u, v, statics, cfg, sp)
                h, u, v = _launch_tail(tend, h, u, v, statics, t1, cfg, sp)
            else:
                slow = _launch_slow(h, u, v, statics, cfg, sp)
                sub = _launch_subcycle(slow, h, u, v, statics, cfg, sp)
                h, u, v = _launch_recompose(slow, sub, h, u, v, statics, t1,
                                            cfg, sp)
            t = t1
    return h, u, v


def _times(t, cfg: Config, m: int) -> list:
    """The times t_1 .. t_m of m steps from t, as State.t runs."""
    ts = []
    for _ in range(m):
        t = advance_time(t, cfg.dt, cfg.npdtype)
        ts.append(t)
    return ts


def _cut(a, rows, cols):
    """The (..., rows, cols) block of a, the indices taken periodically."""
    return a.index_select(-2, rows).index_select(-1, cols)


def fused_fb_step_tiled(h, u, v, statics, n: int, t, cfg: Config, k: int,
                        kb=None, tile=None):
    """The fb pass kernel's schedule on the host, for the tests: each launch
    of a pass of k steps (`plan`'s, or kb steps per launch) of m steps cuts
    the periodic fields, the Grid and the Forcing into blocks of the
    launch's tile (`tile` overrides it) with a halo of m W, runs m eager fb
    steps on each block as a grid of its own, and joins the blocks'
    interiors.  Equal to fused_fb_step_plain bit for bit: what lies
    outside a block's interior after m steps is wrong only within m W of
    its edge, which pins W for every term."""
    if cfg.scheme != "fb":
        raise NotImplementedError("the pass kernel runs scheme='fb'")
    grid, forcing = statics
    ny, nx = cfg.ny, cfg.nx
    dev = h.device
    for m in launch_steps(k, kb or plan(cfg, h.dtype, k).kb):
        tx, ty = tile or launch_plan(cfg, h.dtype, m).tile
        hw = m * halo_width(cfg)
        outs = [torch.empty_like(a) for a in (h, u, v)]
        for y0 in range(0, ny, ty):
            for x0 in range(0, nx, tx):
                rows = torch.arange(y0 - hw, y0 + ty + hw, device=dev) % ny
                cols = torch.arange(x0 - hw, x0 + tx + hw, device=dev) % nx
                sub = dataclasses.replace(cfg, ny=len(rows), nx=len(cols))
                g = Grid(**{f.name: _cut(getattr(grid, f.name), rows, cols)
                            for f in dataclasses.fields(Grid)})
                fo = Forcing(**{
                    f.name: _cut(getattr(forcing, f.name), rows, cols)
                    for f in dataclasses.fields(Forcing)})
                s = State(h=_cut(h, rows, cols), u=_cut(u, rows, cols),
                          v=_cut(v, rows, cols), t=t, n=n)
                for _ in range(m):
                    s = fb_mod.fb_step(s, g, fo, sub)
                ye, xe = min(ty, ny - y0), min(tx, nx - x0)
                for o, a in zip(outs, (s.h, s.u, s.v)):
                    o[..., y0:y0 + ye, x0:x0 + xe] = \
                        a[..., hw:hw + ye, hw:hw + xe]
        h, u, v = outs
        n, t = n + m, _times(t, cfg, m)[-1]
    return h, u, v


def _cut_nan(a, rows, cols):
    """The (..., rows, cols) block of a, periodic, in a ring of NaN."""
    return torch.nn.functional.pad(_cut(a, rows, cols), (1, 1, 1, 1),
                                   value=float("nan"))


def _layer_cfg(cfg: Config, k: int) -> Config:
    """cfg of the one layer k, for the layer-local eager terms."""
    return dataclasses.replace(cfg, nz=1, rho=(cfg.rho[k],))


def _block(statics, cfg: Config, rows, cols, dmask: bool = False):
    """(grid, forcing, cfg) of the block rows x cols (periodic) in a ring of
    NaN that stands for whatever lies past a CTA's block, the staggered
    masks rebuilt from the block's centre mask where dmask."""
    grid, forcing = statics
    cut = lambda a: _cut_nan(a, rows, cols)
    g = {f.name: cut(getattr(grid, f.name)) for f in dataclasses.fields(Grid)}
    if dmask:
        m = g["mask"]
        sx, sy = torch.roll(m, -1, -1), torch.roll(m, -1, -2)
        g.update(mask_u=m * sx, mask_v=m * sy,
                 mask_q=m * sx * sy * torch.roll(sy, -1, -1))
    fo = Forcing(**{f.name: cut(getattr(forcing, f.name))
                    for f in dataclasses.fields(Forcing)})
    return Grid(**g), fo, dataclasses.replace(cfg, ny=len(rows) + 2,
                                              nx=len(cols) + 2)


def _tiled(fn, fields, statics, cfg: Config, tile, halo, dmask=False):
    """fn(block fields, block statics, block cfg) on every tile of the grid
    with the halo (lo_y, hi_y, lo_x, hi_x), each block in a ring of NaN
    (`_block`), the blocks' interiors joined."""
    ty, tx = tile[1], tile[0]
    ly, hy, lx, hx = halo
    ny, nx = cfg.ny, cfg.nx
    dev = fields[0].device
    outs = None
    for y0 in range(0, ny, ty):
        for x0 in range(0, nx, tx):
            rows = torch.arange(y0 - ly, y0 + ty + hy, device=dev) % ny
            cols = torch.arange(x0 - lx, x0 + tx + hx, device=dev) % nx
            g, fo, sub = _block(statics, cfg, rows, cols, dmask)
            res = fn([_cut_nan(a, rows, cols) for a in fields], (g, fo), sub)
            if outs is None:
                outs = [torch.empty(r.shape[:-2] + (ny, nx), dtype=r.dtype,
                                    device=dev) for r in res]
            ye, xe = min(ty, ny - y0), min(tx, nx - x0)
            for o, r in zip(outs, res):
                o[..., y0:y0 + ye, x0:x0 + xe] = \
                    r[..., ly + 1:ly + 1 + ye, lx + 1:lx + 1 + xe]
    return tuple(outs)


def fb_step_streamed(h, u, v, statics, n: int, t, cfg: Config, tile=None,
                     halos=None):
    """The layer-streamed K1's schedule on the host, for the tests: one fb
    step as its two launches (csrc/fb_step_body.cuh: fbs), each block of a
    tile in a ring of NaN.  Launch 1, on blocks with the continuity's halo
    LO (halos[0]), computes each layer's h1 from that layer's h, u, v alone
    into out_h.  Launch 2, on blocks with the halo 3 (halos[1]), sums the
    column's h1 read back from out_h from the surface, and for each layer
    from the surface takes M from the running sums z, acc, then K, the PV,
    the tendencies (the wind on the top layer, the bottom drag on the
    bottom one, the interfacial drag from the old u, v of the layers
    beside it), both Coriolis sweeps and the gates from that layer's h1,
    u, v alone; after the last layer Flather's increments, from its sums
    over the written layers in order from the surface, are added to every
    layer.  Equal to fb_step bit for bit at the kernels' halos."""
    tile = tile or single_tile(cfg, h.dtype, True)[0]
    lo, hw = halos or stream_halos(cfg)[:2]
    cont, mom = fb_stream_launches(n, t, cfg)
    out_h, = _tiled(cont, (h, u, v), statics, cfg, tile, (lo,) * 4)
    return (out_h,) + _tiled(mom, (out_h, u, v), statics, cfg, tile,
                             (hw,) * 4)


def stream_halos(cfg: Config) -> tuple:
    """The halos of the layer-streamed kernels' blocks: K1's continuity
    (LO) and momentum (3); K1s's slow phase (2), recomposition continuity
    (LO) and velocities (1)."""
    lo = 2 if cfg.wetdry else 1
    return lo, 3, 2, lo, 1


def fb_stream_launches(n: int, t, cfg: Config):
    """The two launches of the layer-streamed fb step n from time t, as
    fn(block fields, block statics, block cfg) on one haloed block (what a
    CTA computes, fb_step_streamed): the continuity from (h, u, v) to
    (h1,), the momentum from (h1, u, v) to (u1, v1)."""
    from beom_tpu_torch.core import ops
    from beom_tpu_torch.physics import continuity, obc, wetdry

    t1 = advance_time(t, cfg.dt, cfg.npdtype)
    dt = cfg.dt

    def continuity_launch(fields, st, c):
        (h, u, v), (g, fo) = fields, st
        out = []
        for k in range(c.nz):
            hk = h[k:k + 1]
            dh = continuity.continuity_rhs(hk, u[k:k + 1], v[k:k + 1], g,
                                           _layer_cfg(c, k))
            if c.sponge:
                dh = dh + fo.sponge * (fo.h_ext[k:k + 1] - hk)
            h1 = (hk + dt * dh) * g.mask
            if c.obc:
                tgt = fo.h_ext[k:k + 1]
                if k == 0:
                    tgt = tgt + obc.eta_ext(t1, fo, c, h.dtype)
                h1 = torch.where(fo.obc_h[None] > 0, tgt, h1)
            out.append(h1)
        return (torch.cat(out),)

    def momentum_launch(fields, st, c):
        (h1c, u, v), (g, fo) = fields, st
        nz, gp = c.nz, c.gprime
        z = ops.sum_k(h1c) - g.H
        acc = gp[0] * z
        out_u, out_v = [], []
        for k in range(nz):
            if k > 0:
                z = z - h1c[k - 1]
                acc = acc + gp[k] * z
            u1, v1 = _layer_sweeps(h1c, u, v, g, fo, c, k, acc, n)
            if c.wetdry:
                wet = wetdry.wet_mask(h1c[k:k + 1], g, _layer_cfg(c, k))
                u1, v1 = wetdry.gate_u(u1, wet, g), wetdry.gate_v(v1, wet, g)
            out_u.append(u1)
            out_v.append(v1)
        # Flather's fix-up of what the layers wrote
        return obc.apply_flather(h1c, torch.cat(out_u), torch.cat(out_v), g,
                                 fo, c, t1)

    return continuity_launch, momentum_launch


def _layer_terms(h, u, v, g, fo, c, k: int, acc):
    """The momentum terms of layer k alone, each (1, ny, nx), from that
    layer's h, u, v, the Montgomery potential's running sum acc and the
    old u, v of the layers beside it (the interfacial drag):
    (du, dv, q, U, V), fb._common_tendencies without the free surface and
    fb._pv_and_fluxes, in their order."""
    from beom_tpu_torch.core import ops
    from beom_tpu_torch.physics import momentum, obc, viscosity

    nz, one = c.nz, _layer_cfg(c, k)
    hk, uk, vk = h[k:k + 1], u[k:k + 1], v[k:k + 1]
    phi = acc[None]
    if c.adv_scheme != "linear":
        phi = phi + momentum.kinetic_energy(uk, vk)
    du = -ops.d_xp(phi, c.dx)
    dv = -ops.d_yp(phi, c.dy)
    duv, dvv = viscosity.viscosity(uk, vk, g, one)
    du, dv = du + duv, dv + dvv
    duw, dvw = drag.wind(hk, g, fo, one)
    if k > 0:
        duw, dvw = torch.zeros_like(duw), torch.zeros_like(dvw)
    du, dv = du + duw, dv + dvw
    if c.r_int != 0.0 and nz > 1:
        hu = torch.clamp_min(ops.a_xp(hk), c.h_min)
        hv = torch.clamp_min(ops.a_yp(hk), c.h_min)

        def couple(w, hh):
            a = w[k:k + 1]
            above = w[k - 1:k] - a if k > 0 else torch.zeros_like(a)
            below = w[k + 1:k + 2] - a if k < nz - 1 else \
                torch.zeros_like(a)
            return c.r_int * (above + below) / hh

        du, dv = du + couple(u, hu), dv + couple(v, hv)
    else:
        du, dv = du + torch.zeros_like(du), dv + torch.zeros_like(dv)
    if c.sponge:
        _, dus, dvs = obc.sponge_rhs(hk, uk, vk, fo, one)
        du, dv = du + dus, dv + dvs
    return (du, dv) + fb_mod._pv_and_fluxes(hk, uk, vk, g, one)


def _layer_tendencies(h, u, v, g, fo, c, k: int, acc):
    """The slow phase's tendencies (du_s, dv_s) of layer k alone
    (_layer_terms with the PV cross terms)."""
    from beom_tpu_torch.core import ops

    du, dv, q, U, V = _layer_terms(h, u, v, g, fo, c, k, acc)
    return (du + ops.a_ym(q * ops.a_xp(V)),
            dv - ops.a_xm(q * ops.a_yp(U)))


def _layer_sweeps(h, u, v, g, fo, c, k: int, acc, n: int):
    """fb.momentum_update of layer k alone from _layer_terms: both
    FB-Coriolis sweeps in the order of the parity n % 2, the bottom drag
    on the last layer; (u1, v1) before finalize."""
    from beom_tpu_torch.core import ops

    dt = c.dt
    du, dv, q, U, V = _layer_terms(h, u, v, g, fo, c, k, acc)
    hk, uk, vk = h[k:k + 1], u[k:k + 1], v[k:k + 1]
    cu = cv = torch.zeros_like(uk)
    if k == c.nz - 1:
        cu, cv = drag.bottom_drag_coeff(hk, uk, vk, g, _layer_cfg(c, k))

    def upd_u(uu, VV):
        duq = ops.a_ym(q * ops.a_xp(VV))
        return (uu + dt * (du + duq)) / (1.0 + dt * cu) * g.mask_u

    def upd_v(vv, UU):
        dvq = -ops.a_xm(q * ops.a_yp(UU))
        return (vv + dt * (dv + dvq)) / (1.0 + dt * cv) * g.mask_v

    linear = c.adv_scheme == "linear"
    if n % 2 == 0:
        u1 = upd_u(uk, V)
        v1 = upd_v(vk, u1 if linear else ops.a_xp(hk) * u1)
    else:
        v1 = upd_v(vk, U)
        u1 = upd_u(uk, v1 if linear else ops.a_yp(hk) * v1)
    return u1, v1


def split_step_streamed(h, u, v, statics, n: int, t, cfg: Config,
                        tile=None, halos=None):
    """The layer-streamed K1s's schedule on the host (route 3), for the
    tests: one split step as its four launches (csrc/split_body.cuh: sps),
    each block of a tile in a ring of NaN.  The slow phase, on blocks with
    the halo 2 (halos[0]), takes each layer from the surface: Montgomery's
    running sums without the free surface, the layer's tendencies from its
    h, u, v alone (the interfacial drag from the old u, v of the layers
    beside it), the column's face thicknesses, transports, h and tendency
    transports summed as they come, the bottom drag from the last layer;
    then the depth means, and u', v', du', dv' subtracted layer by layer.
    The subcycle runs on the whole grid (its kernel is route 3's own).  The
    recomposition's continuity, on blocks with the halo LO (halos[1]),
    takes each layer's h1 from that layer's h, u', v' and the mean
    advecting velocities, sums the column and rescales it; its velocities,
    on blocks with the halo 1 (halos[2]), recompose each layer's u, v and
    gate it with the rescaled h1, and Flather's increments, from its sums
    over the layers, are added afterwards.  Returns (h1, u1, v1) and the
    slow phase; equal to the plain split step and slow phase bit for bit
    at the kernels' halos."""
    tile = tile or _TILES[0]
    hw, lo, hv = halos or stream_halos(cfg)[2:]
    slow_l, rec_h, rec_uv = split_stream_launches(t, cfg)
    slow = _tiled(slow_l, (h, u, v), statics, cfg, tile, (hw,) * 4)
    kb = cfg.nz - 1
    slow = SlowPhase(*slow[:11], cu=drag._on_layer(slow[11], kb, cfg.nz),
                     cv=drag._on_layer(slow[12], kb, cfg.nz))
    grid = statics[0]
    eta_f, ub_f, vb_f, ub_a, vb_a = split_mod.subcycle_phase(slow, grid, cfg)
    h1, = _tiled(rec_h, (h, slow.up, slow.vp, ub_a, vb_a, eta_f),
                 statics, cfg, tile, (lo,) * 4)
    u1, v1 = _tiled(rec_uv, (h1, slow.up, slow.vp, slow.du_p, slow.dv_p,
                             slow.cu[kb], slow.cv[kb], ub_f, vb_f), statics,
                    cfg, tile, (hv,) * 4)
    return h1, u1, v1, slow


def split_stream_launches(t, cfg: Config):
    """The launches of the layer-streamed split step from time t, as
    fn(block fields, block statics, block cfg) on one haloed block (what a
    CTA computes, split_step_streamed): the slow phase from (h, u, v) to
    SlowPhase's 13 fields (cu, cv as the bottom plane); the
    recomposition's continuity from (h, u', v', ubar_avg, vbar_avg,
    eta_f) to (h1,); its velocities from (h1, u', v', du', dv', cu, cv,
    ubar_f, vbar_f) to (u1, v1)."""
    from beom_tpu_torch.core import ops
    from beom_tpu_torch.physics import continuity, obc, wetdry

    t1 = advance_time(t, cfg.dt, cfg.npdtype)
    dt = cfg.dt

    def slow_launch(fields, st, c):
        (h, u, v), (g, fo) = fields, st
        z = torch.zeros(h.shape[1:], dtype=h.dtype, device=h.device)
        acc = c.gprime[0] * z
        dup, dvp = [], []
        for k in range(c.nz):
            if k > 0:
                z = z - h[k - 1]
                acc = acc + c.gprime[k] * z
            dus, dvs = _layer_tendencies(h, u, v, g, fo, c, k, acc)
            hu = ops.a_xp(h[k]) * g.mask_u
            hv = ops.a_yp(h[k]) * g.mask_v
            sums = (hu, hv, hu * u[k], hv * v[k], h[k], hu * dus[0],
                    hv * dvs[0])
            col = sums if k == 0 else tuple(a + b for a, b in zip(col, sums))
            dup.append(dus)
            dvp.append(dvs)
        Hu, Hv, nu_, nv_, hs, dub, dvb = col
        Hu = torch.clamp_min(Hu, c.h_min)
        Hv = torch.clamp_min(Hv, c.h_min)
        ubar, vbar = nu_ / Hu, nv_ / Hv
        du_bar, dv_bar = dub / Hu, dvb / Hv
        kb = c.nz - 1
        cu, cv = drag.bottom_drag_coeff(h[kb:], u[kb:], v[kb:], g,
                                        _layer_cfg(c, kb))
        return (u - ubar[None], v - vbar[None],
                torch.cat([d - du_bar[None] for d in dup]),
                torch.cat([d - dv_bar[None] for d in dvp]), du_bar, dv_bar,
                ubar, vbar, Hu, Hv, (hs - g.H) * g.mask, cu[0], cv[0])

    def rec_h_launch(fields, st, c):
        (h, up, vp, ub_a, vb_a, eta_f), (g, _) = fields, st
        out = []
        for k in range(c.nz):
            ua = (up[k:k + 1] + ub_a[None]) * g.mask_u
            va = (vp[k:k + 1] + vb_a[None]) * g.mask_v
            dh = continuity.continuity_rhs(h[k:k + 1], ua, va, g,
                                           _layer_cfg(c, k))
            out.append((h[k:k + 1] + dt * dh) * g.mask)
            col = out[0][0] if k == 0 else col + out[k][0]
        col = torch.clamp_min(col, c.h_min)
        target = torch.clamp_min(g.H + eta_f, 0.0) * g.mask
        fac = torch.where(col > c.h_min, target / col, 1.0)
        return (torch.cat([a * fac[None] for a in out]),)

    def rec_uv_launch(fields, st, c):
        (h1, up, vp, dup, dvp, cu, cv, ub_f, vb_f), (g, fo) = fields, st
        out_u, out_v = [], []
        for k in range(c.nz):
            a = (up[k:k + 1] + dt * dup[k:k + 1]) + ub_f[None]
            b = (vp[k:k + 1] + dt * dvp[k:k + 1]) + vb_f[None]
            if k == c.nz - 1:
                a = a / (1.0 + dt * cu[None])
                b = b / (1.0 + dt * cv[None])
            u1, v1 = a * g.mask_u, b * g.mask_v
            if c.wetdry:
                wet = wetdry.wet_mask(h1[k:k + 1], g, _layer_cfg(c, k))
                u1, v1 = wetdry.gate_u(u1, wet, g), wetdry.gate_v(v1, wet, g)
            out_u.append(u1)
            out_v.append(v1)
        # Flather's fix-up of what the layers wrote
        return obc.apply_flather(h1, torch.cat(out_u), torch.cat(out_v), g,
                                 fo, c, t1)

    return slow_launch, rec_h_launch, rec_uv_launch


def split_step_tiled(h, u, v, statics, n: int, t, cfg: Config, k: int,
                     tile=None, halo=None):
    """The split tail's schedule on the host, for the tests: each of k
    steps takes the slow phase on the whole grid, then cuts h and SlowPhase,
    the Grid and the Forcing into blocks of `tile` (default: split_plan's
    (qx, qy)) with a halo of `halo` (default: tail_halo, nsub + LO + E),
    each in a ring of NaN that stands for whatever lies past a CTA's block,
    runs split.fast_phase (the subcycle, the recomposition, fb.finalize) on
    each as a grid of its own, and joins the blocks' interiors.  Equal to
    fused_fb_step_plain bit for bit at the default halo; a narrower one
    lets the NaN into the interiors, which pins the width."""
    if cfg.scheme != "split":
        raise NotImplementedError("the split tail runs scheme='split'")
    grid, forcing = statics
    ny, nx = cfg.ny, cfg.nx
    dev = h.device
    if tile is None:
        pl = split_plan(cfg, h.dtype)
        tile = (pl.qx, pl.qy)
    tx, ty = tile
    hw = tail_halo(cfg) if halo is None else halo
    for _ in range(k):
        st = State(h=h, u=u, v=v, t=t, n=n)
        sp = split_mod.slow_phase(st, grid, forcing, cfg)
        outs = [torch.empty_like(a) for a in (h, u, v)]
        for y0 in range(0, ny, ty):
            for x0 in range(0, nx, tx):
                rows = torch.arange(y0 - hw, y0 + ty + hw, device=dev) % ny
                cols = torch.arange(x0 - hw, x0 + tx + hw, device=dev) % nx
                cut = lambda a: _cut_nan(a, rows, cols)
                sub = dataclasses.replace(cfg, ny=len(rows) + 2,
                                          nx=len(cols) + 2)
                g = Grid(**{f.name: cut(getattr(grid, f.name))
                            for f in dataclasses.fields(Grid)})
                fo = Forcing(**{f.name: cut(getattr(forcing, f.name))
                                for f in dataclasses.fields(Forcing)})
                s = split_mod.fast_phase(
                    SlowPhase(*[cut(a) for a in sp]),
                    State(h=cut(h), u=cut(u), v=cut(v), t=t, n=n), g, fo,
                    sub)
                ye, xe = min(ty, ny - y0), min(tx, nx - x0)
                for o, a in zip(outs, (s.h, s.u, s.v)):
                    o[..., y0:y0 + ye, x0:x0 + xe] = \
                        a[..., hw + 1:hw + 1 + ye, hw + 1:hw + 1 + xe]
        h, u, v = outs
        n, t = n + 1, advance_time(t, cfg.dt, cfg.npdtype)
    return h, u, v


def make_fused_stepper(grid: Grid, forcing: Forcing, cfg: Config):
    """step(state) -> state advancing cfg.steps_per_pass steps of fb or
    split in one call of the fused step."""
    k = cfg.steps_per_pass
    statics = (grid, forcing)
    check_config(cfg)

    def step(state: State) -> State:
        h, u, v = fused_fb_step(state.h, state.u, state.v, statics,
                                state.n, state.t, cfg, k)
        t = state.t
        for _ in range(k):
            t = advance_time(t, cfg.dt, cfg.npdtype)
        return State(h=h, u=u, v=v, t=t, n=state.n + k)

    return step
