"""The fused rigid-lid / implicit-free-surface step: the phase kernels
(K3a, K3b) around the solver kernels, and their plain PyTorch versions.

The CUDA kernels `proj_a` and `proj_b` of `csrc/projection.cu` replace
the TPU kernel beom_tpu/stencils/band.py::_band_kernel running the
bodies body_a and body_b of
beom_tpu/stencils/fused_projection.py::make_pallas_projection_stepper.
They take every case: any layer count and every term of the eager step,
with the term code and the compile-time switches of the fused
forward-backward step (`csrc/fb_terms.cuh`), one build per combination.
A step decomposes as the reference's does:

  phase A (K3a) : provisional momentum u*, v* without the surface term,
                  and the divergence of the barotropic transport;
  right-hand side and warm start : stepping/projection.py's helpers, in
                  K3a's epilogue where the plan takes it (the rigid
                  lid's global de-mean stays in torch);
  solve         : cfg.solver='redblack' -> passes of the blocked
                  red-black kernel (stencils/redblack.py, K4a);
                  'cg' with precond 'jacobi' (what 'auto' means for the
                  implicit free surface) or 'mg' (what it means for the
                  rigid lid) -> the fused CG kernel with that
                  preconditioner (stencils/cg_fused.py, K6), at every
                  size, with 'mg' behind the reference's stall guard
                  (`_guarded`); 'cg' with 'ssor' -> the plain elliptic.cg_solve
                  (no kernel in the reference either); 'mg' -> the
                  standalone multigrid solver with its fused tier
                  (solvers/multigrid.make_mg_solver, smoother='fused':
                  K4a with its residual, K5, K4b);
  phase B (K3b) : gradient correction, per-layer continuity, finalize.

Each phase runs as one of two kernels of `csrc/projection.cu`, chosen per
case and type by `plan`: the single-step kernels `proj_a` / `proj_b` on
32 x 16 tiles (the stage bodies the shard kernels share; from _STREAM_FROM
layers, and wherever no tile fits a CTA's shared memory, both
layer-streamed, a few planes of one layer in shared memory: PhasePlan.
stream), or the
staged kernels `proj_as` / `proj_bs` on tiles of their own, every
operand staged by cp.async, whose K3a also writes the solve's right-hand
side and warm start in its epilogue (`Phases.a_rhs`: then no elementwise
pass runs between phase A and the solve; the rigid lid's de-mean, a sum
over the grid, stays two torch reductions and four passes).  `Phases`
holds one grid's launches with what each rebuilt per call prepared once
(the library, the statics' operand table and checks, the scalar slots);
the fused stepper keeps one, and `proj_a` / `proj_b` prepare one per
call.  The solve's iteration count is not read back in the step, so the
host queues the next launches while the solve runs.

`proj_a` and `proj_b` run their kernel on CUDA tensors and their plain
versions, `proj_a_plain` and `proj_b_plain`, on CPU tensors.  They never
fall back from one to the other: on a CUDA tensor each launches its
kernel or raises.  `proj_a_tiled` and `proj_b_tiled` run the staged
kernels' tile schedules on the host, and `proj_a_streamed` /
`proj_b_streamed` the layer-streamed kernels', for the tests.
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
from beom_tpu_torch.stencils import fused_fb
from beom_tpu_torch.stepping import fb, projection
from beom_tpu_torch.solvers.elliptic import _local_dot

# kernel launches of phase A and phase B (either kernel of each); a run
# reads them to show that its main path went through the kernels
LAUNCHES = {"proj_a": 0, "proj_b": 0}
# the launches above that took the layer-streamed kernels
STREAM_LAUNCHES = {"proj_a": 0, "proj_b": 0}

# solves that the stall guard of the multigrid-preconditioned CG redid
COUNTS = {"stalled": 0}

K_SWEEPS = 8      # red-black sweeps per pass, as the reference's stepper
_KERNELS = ("proj_a", "proj_b")     # in the order of beom_smem_bytes
_STAGED = ("proj_as", "proj_bs")    # after them
# Both phases stream their layers from _STREAM_FROM layers (and wherever no
# tile fits the single-step kernels).  On the H100 at 2048^2 on the shelf
# with 13 constituents, implicit FS (tools/kernel_times.py --layers
# projection, K3a + K3b on the device, streamed against the plan's
# shared-memory kernels): f32 nz 2 1.17 ms against 0.90 (staged), nz 4
# 1.65 against 1.74 (staged), nz 8 2.63 against 4.44 (K3a single-step on
# 32 x 8, K3b staged), nz 16 4.59 against 11.34 (single-step); f64 nz 2
# 2.66 against 1.93, nz 4 3.78 against 5.35, nz 8 5.87 against 9.15 (both
# single-step).  One rule for both phases and types: from 4 layers.
_STREAM_FROM = 4
# the staged kernels' candidate geometries: (tile width, height, threads);
# the width a multiple of 4, so that a block's rows start 16-byte aligned
_GEOMETRIES = ((32, 16, 256), (64, 16, 512), (32, 32, 512), (64, 32, 512),
               (64, 32, 1024), (128, 16, 512), (128, 32, 1024))
# the cost model of a geometry per tile point: the block's points per tile
# point, times (1 + _ROW / tx) for the rows' ends, times (1 + _ONE_CTA)
# where one CTA alone fits an SM (its loads then overlap no other CTA's
# stages); fitted on the H100 at 2048^2 f32 (tools/k3_probes.py --sweep,
# four cases, seven geometries each: the geometry it picks is within 5 %
# of the fastest for each kernel and case).  The threads per CTA did not
# matter beyond that.
_ROW = 8.0
_ONE_CTA = 0.5
_SM_SMEM = 233472        # shared memory of an SM, 1 KB reserved per CTA


def check_config(cfg: Config) -> None:
    """Raise on what the phase kernels cannot run: a scheme other than
    the projection schemes.  Every term of the eager step is implemented,
    at any number of layers and tidal constituents."""
    if cfg.scheme not in ("rigid_lid", "implicit_fs"):
        raise ValueError("fused_projection implements the projection "
                         "schemes; fb uses stencils/fused_fb.py")


def single_planes(cfg: Config) -> dict:
    """(halo, planes) of each single-step phase body (csrc/
    projection_body.cuh: pa, pb)."""
    nz, wd, obc, nu4 = cfg.nz, cfg.wetdry, cfg.obc, cfg.nu4 != 0.0
    return {"proj_a": (4, 7 * nz + 4 + 2 * nz * nu4),
            "proj_b": (halo_b(cfg), 4 * nz + 4 + 3 * nz * wd + obc)}


def smem_bytes(cfg: Config, tile, elem: int, off: int = 4) -> dict:
    """Dynamic shared memory of one CTA of each single-step phase kernel at
    `tile` = (tx, ty) and `elem` bytes per value: the planes of
    csrc/projection.cu times the haloed tile, plus the table of offsets of
    `off` bytes."""
    out = {}
    for kernel, (w, planes) in single_planes(cfg).items():
        npt = (tile[0] + 2 * w) * (tile[1] + 2 * w)
        out[kernel] = fused_fb.tables(npt * planes * elem, npt, off)
    return out


def stream_smem(cfg: Config, tile, elem: int, off: int = 4,
                kernel: str = "proj_b") -> int:
    """Dynamic shared memory of one CTA of a layer-streamed phase kernel at
    `tile` (csrc/projection_body.cuh), planes of one layer on the block with
    the phase's halo and the table of offsets: K3b's (pbl) h, u*, v*, p,
    three masks and h1 (+ the fluxes and scales under wet/dry, + ee under
    the open boundary) at halo_b; K3a's ("proj_a", pal) h, u, v of two
    layers, phi, q, both sweeps, z, acc and four masks (+ lap(u), lap(v)
    with nu4) at the halo 4."""
    if kernel == "proj_a":
        w, planes = 4, 16 + 2 * (cfg.nu4 != 0.0)
    else:
        w, planes = halo_b(cfg), 8 + 3 * cfg.wetdry + cfg.obc
    npt = (tile[0] + 2 * w) * (tile[1] + 2 * w)
    return fused_fb.tables(npt * planes * elem, npt, off)


def stream_smems(cfg: Config, tile, elem: int, off: int = 4) -> dict:
    """stream_smem of both phases' kernels, by kernel."""
    return {k: stream_smem(cfg, tile, elem, off, k) for k in _KERNELS}


def single_tile(cfg: Config, dtype=None, off_smem: bool = False):
    """fused_fb.tile_or_stream of the single-step phase kernels: (tile,
    off), off where no tile fits them (the phases then stream their
    layers) or where `off_smem` forces it."""
    elem = torch.empty((), dtype=dtype or cfg.tdtype).element_size()
    return fused_fb.tile_or_stream(
        lambda t: max(smem_bytes(cfg, t, elem).values()), off_smem)


def build_spec(cfg: Config, dtype=None, phase_plan=None, dmask=False):
    """(source, defines) of the build of csrc/projection.cu (and of the
    shard kernels' csrc/shard_projection.cu) that runs cfg: the
    compile-time switches and the single-step kernels' tile; where the
    plan streams (`phase_plan`, default `plan`) BEOM_STREAM=1, both phases
    layer-streamed on the largest tile; with a PhasePlan the staged
    kernels' geometry and the masks' rebuild (`staged_defines`)."""
    check_config(cfg)
    stream = (phase_plan or plan(cfg, dtype)).stream
    tile = single_tile(cfg, dtype, stream)[0]
    defines = fused_fb.term_defines(cfg, tile) + (
        ("BEOM_STREAM=1",) if stream else ())
    if phase_plan is not None:
        defines += staged_defines(phase_plan, cfg, dmask)
    return "projection", defines


@dataclasses.dataclass(frozen=True)
class Geometry:
    """A staged phase kernel's tile (tx x ty points) and threads per CTA."""
    tx: int
    ty: int
    threads: int

    def describe(self) -> str:
        return f"{self.tx} x {self.ty} tiles, {self.threads} threads"


@dataclasses.dataclass(frozen=True)
class PhasePlan:
    """How a step's phases run: `a` and `b` the staged kernels' geometries,
    or None for the single-step kernel; `rhs` whether K3a's epilogue writes
    the solve's right-hand side and warm start; `stream` whether the
    single-step kernels stream their layers (a build with BEOM_STREAM: from
    _STREAM_FROM layers, and where no tile fits them), on one device and
    on the shards alike."""
    a: Optional[Geometry]
    b: Optional[Geometry]
    rhs: bool
    stream: bool = False

    @property
    def stream_a(self) -> bool:
        """Whether phase A runs the layer-streamed kernel."""
        return self.stream and self.a is None

    @property
    def stream_b(self) -> bool:
        """Whether phase B runs the layer-streamed kernel."""
        return self.stream and self.b is None

    def describe(self) -> str:
        one = "single-step (32 x 16)"
        streamed = "layer-streamed (32 x 16, one layer at a time in " \
            "shared memory)"
        a = f"K3a {streamed}" if self.stream_a else f"K3a {one}" \
            if self.a is None else f"K3a staged, {self.a.describe()}"
        b = f"K3b {streamed}" if self.stream_b else f"K3b {one}" \
            if self.b is None else f"K3b staged, {self.b.describe()}"
        rhs = "the right-hand side in K3a's epilogue" if self.rhs else \
            "the right-hand side in torch"
        return f"{a}; {b}; {rhs}"


def halo_b(cfg: Config) -> int:
    """Phase B's halo: LO + 1 where finalize reads the new thickness east
    and north (wet/dry, the open boundary), else 1."""
    return (3 if cfg.wetdry else 2) if (cfg.wetdry or cfg.obc) else 1


def staged_smem(cfg: Config, geo_a: Geometry, geo_b: Geometry,
                elem: int, off: int = 4) -> dict:
    """Dynamic shared memory of one CTA of each staged kernel (csrc/
    projection_body.cuh: pas::In and pas::Work, pbs::Plane) and its row
    and column offsets."""
    nz, nu4 = cfg.nz, cfg.nu4 != 0.0
    rx, ry = geo_a.tx + 8, geo_a.ty + 8
    planes_a = 3 * nz + 5 + 2 * cfg.wind + cfg.sponge + 6 * nz + 2 * nz * nu4
    w = halo_b(cfg)
    rxb, ryb = geo_b.tx + 8, geo_b.ty + 2 * w
    planes_b = 4 * nz + 4 + 3 * nz * cfg.wetdry + cfg.obc
    return {"proj_as": fused_fb.tables(planes_a * rx * ry * elem, rx + ry,
                                       off),
            "proj_bs": fused_fb.tables(planes_b * rxb * ryb * elem,
                                       rxb + ryb, off)}


def ctas_per_sm(smem: int, threads: int) -> int:
    """CTAs of `smem` bytes and `threads` threads one SM holds (their
    registers within the kernels' cap: csrc/projection_body.cuh, MINB)."""
    return min(_SM_SMEM // (smem + 1024), 2048 // threads)


def geometry_cost(cfg: Config, geo: Geometry, kernel: str,
                  elem: int) -> float:
    """The cost model of a staged kernel ("proj_as" or "proj_bs") at geo,
    per tile point (_ROW, _ONE_CTA); inf where no CTA fits an SM."""
    smem = staged_smem(cfg, geo, geo, elem)[kernel]
    if smem > fused_fb._MAX_SMEM:
        return float("inf")
    w = 4 if kernel == "proj_as" else halo_b(cfg)
    ratio = (geo.tx + 8) * (geo.ty + 2 * w) / (geo.tx * geo.ty)
    one = ctas_per_sm(smem, geo.threads) == 1
    return ratio * (1 + _ROW / geo.tx) * (1 + _ONE_CTA * one)


def candidates(cfg: Config, dtype=None) -> list:
    """Every pair of staged geometries (K3a's and K3b's, taken in the order
    of _GEOMETRIES) whose CTAs fit an SM, as PhasePlans: what
    tools/k3_probes.py --sweep times."""
    elem = torch.empty((), dtype=dtype or cfg.tdtype).element_size()
    fit = lambda g, k: staged_smem(cfg, g, g, elem)[k] <= fused_fb._MAX_SMEM
    geos = [Geometry(*g) for g in _GEOMETRIES]
    ga = [g for g in geos if fit(g, "proj_as")]
    gb = [g for g in geos if fit(g, "proj_bs")]
    n = max(len(ga), len(gb))
    return [PhasePlan(ga[min(i, len(ga) - 1)] if ga else None,
                      gb[min(i, len(gb) - 1)] if gb else None,
                      bool(ga) and cfg.nz <= 2) for i in range(n)]


@functools.lru_cache(maxsize=None)
def plan(cfg: Config, dtype=None, off_smem: bool = False) -> PhasePlan:
    """The phase kernels of cfg at `dtype`: from _STREAM_FROM layers, and
    wherever no tile fits the single-step kernels (single_tile), both
    phases layer-streamed; else each phase's staged kernel at the geometry
    of least geometry_cost where one fits, else its single-step kernel;
    the right-hand side in K3a's epilogue where K3a is staged and the
    layer sum has at most two terms (any order of two additions is the
    same, so the epilogue's sum is torch.sum's bit for bit).  With
    off_smem=True both phases stream (to hold them against the other
    routes where both build)."""
    check_config(cfg)
    if off_smem or cfg.nz >= _STREAM_FROM or single_tile(cfg, dtype)[1]:
        return PhasePlan(None, None, False, True)
    elem = torch.empty((), dtype=dtype or cfg.tdtype).element_size()
    geos = [Geometry(*g) for g in _GEOMETRIES]

    def pick(kernel):
        cost = {g: geometry_cost(cfg, g, kernel, elem) for g in geos}
        best = min(geos, key=cost.get)
        return None if cost[best] == float("inf") else best

    a = pick("proj_as")
    return PhasePlan(a, pick("proj_bs"), a is not None and cfg.nz <= 2)


def staged_defines(pl: PhasePlan, cfg: Config, dmask: bool) -> tuple:
    """The defines of the staged kernels' geometry (the single-step
    geometry where the plan keeps a single-step kernel, so the build has
    a valid one), the wind switch and the masks' rebuild."""
    a = pl.a or Geometry(32, 16, 256)
    b = pl.b or Geometry(32, 16, 256)
    return (f"BEOM_ATX={a.tx}", f"BEOM_ATY={a.ty}", f"BEOM_ANT={a.threads}",
            f"BEOM_BTX={b.tx}", f"BEOM_BTY={b.ty}", f"BEOM_BNT={b.threads}",
            f"BEOM_WIND={int(cfg.wind)}", f"BEOM_DMASK={int(dmask)}")


def derived_masks(grid: Grid) -> bool:
    """Whether grid's staggered masks are make_grid's products of the
    centre mask, which the staged kernels rebuild under BEOM_DMASK."""
    m = grid.mask
    sx, sy = torch.roll(m, -1, -1), torch.roll(m, -1, -2)
    return (torch.equal(grid.mask_u, m * sx)
            and torch.equal(grid.mask_v, m * sy)
            and torch.equal(grid.mask_q, m * sx * sy
                            * torch.roll(sy, -1, -1)))


def proj_a_plain(h, u, v, statics, n: int, cfg: Config):
    """Phase A, eager: (u*, v*, div(U*)).  statics = (grid, forcing)."""
    grid, forcing = statics
    state = State(h=h, u=u, v=v, t=None, n=n)
    u_s, v_s = fb.momentum_update(h, state, grid, forcing, cfg,
                                  free_surface=False)
    return u_s, v_s, projection.transport_divergence(h, u_s, v_s, grid,
                                                     cfg)


def proj_b_plain(h, u_s, v_s, p, statics, t, cfg: Config):
    """Phase B of the step from time t, eager: (h1, u1, v1) after the
    correction by grad p."""
    grid, forcing = statics
    state = State(h=h, u=u_s, v=v_s, t=t, n=0)
    out = projection.phase_b(h, u_s, v_s, p, _corr(cfg), state, grid,
                             forcing, cfg)
    return out.h, out.u, out.v


def _corr(cfg: Config) -> float:
    """The velocity-correction factor: dt (rigid lid) or g dt."""
    return cfg.dt if cfg.scheme == "rigid_lid" else cfg.g * cfg.dt


@functools.lru_cache(maxsize=None)
def _entries(cfg: Config, dtype, pl: PhasePlan, dmask: bool):
    """The library that runs cfg by the plan `pl` (the masks rebuilt where
    dmask) and its four entry points, built on first use."""
    from beom_tpu_torch.stencils import build

    name, defines = build_spec(cfg, dtype, pl, dmask)
    lib = build.load((name, defines))
    value = {d.split("=")[0]: int(d.split("=")[1]) for d in defines}
    elem = torch.empty((), dtype=dtype).element_size()
    tile = (value["BEOM_TX"], value["BEOM_TY"])
    want = stream_smems(cfg, tile, elem) if pl.stream else \
        smem_bytes(cfg, tile, elem)
    want.update(staged_smem(
        cfg, Geometry(value["BEOM_ATX"], value["BEOM_ATY"],
                      value["BEOM_ANT"]),
        Geometry(value["BEOM_BTX"], value["BEOM_BTY"], value["BEOM_BNT"]),
        elem))
    for i, kernel in enumerate(_KERNELS + _STAGED):
        have = lib.beom_smem_bytes(i, int(elem == 8))
        if have != want[kernel]:
            raise RuntimeError(
                f"{kernel}: the kernel's shared memory ({have} bytes) is "
                f"not what smem_bytes counts ({want[kernel]})")
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    suffix = fused_fb._SUFFIX[dtype]
    fns = {}
    for kernel, args in (("proj_a", [P] * 7), ("proj_b", [P] * 4 + [D]
                                                + [P] * 4),
                         ("proj_as", [P] * 6 + [D, P]),
                         ("proj_bs", [P] * 4 + [D] + [P] * 4)):
        fn = getattr(lib, f"beom_{kernel}_{suffix}")
        fn.argtypes, fn.restype = args, I
        fns[kernel] = fn
    return lib, fns


def _check_field(what, a, shape, dtype, device):
    if a.device != device or a.dtype != dtype or not a.is_contiguous() \
            or tuple(a.shape) != shape:
        raise ValueError(
            f"{what} must be a contiguous {dtype} tensor of {shape} on "
            f"{device}, not {a.dtype} {tuple(a.shape)} on {a.device}")


def _rhs_plain(h, div, grid: Grid, cfg: Config, lam, phi, phi_prev):
    """(rhs, x0) of the solve from phase A's div, eagerly: rigid_rhs or
    implicit_rhs, and warm_x0 (eta^n for the implicit free surface
    without a warm start)."""
    warm = projection.warm_x0(State(h=h, u=None, v=None, t=None, n=0,
                                    phi=phi, phi_prev=phi_prev), cfg)
    if cfg.scheme == "rigid_lid":
        return projection.rigid_rhs(h, div, grid, cfg), warm
    b, eta_n = projection.implicit_rhs(h, div, grid, cfg, lam)
    return b, (eta_n if warm is None else warm)


class Phases:
    """Phases A and B of one grid, forcing and Config at one type, by a
    PhasePlan (default: `plan`).  On CUDA tensors each is one launch, with
    what a launch does not change made once: the library, the statics'
    operand table and their checks, the scalar slots and the test of the
    masks; on CPU tensors the plain versions."""

    def __init__(self, grid: Grid, forcing: Forcing, cfg: Config,
                 dtype=None, phase_plan: Optional[PhasePlan] = None):
        check_config(cfg)
        self.grid, self.forcing, self.cfg = grid, forcing, cfg
        self.statics = (grid, forcing)
        self.dtype = dtype or cfg.tdtype
        self.plan = phase_plan or plan(cfg, self.dtype)
        self.lam = projection.solve_lam(cfg)
        self.rigid = cfg.scheme == "rigid_lid"
        self.device = grid.mask.device
        self.on_cpu = self.device.type == "cpu"
        self._shape3, self._shape2 = (cfg.nz, cfg.ny, cfg.nx), (cfg.ny,
                                                                cfg.nx)
        self._mm = None
        if self.on_cpu:
            return
        from beom_tpu_torch.stencils import build

        z = torch.empty(self._shape3, dtype=self.dtype, device=self.device)
        fused_fb._check_operands(z, z, z, self.statics, cfg,
                                 check=check_config)
        self.dmask = derived_masks(grid)
        with torch.cuda.device(self.device):
            self.lib, self.fn = _entries(cfg, self.dtype, self.plan,
                                         self.dmask)
        self._ops = fused_fb.Operands(fused_fb._operands(self.statics), cfg)
        self._epi = (ctypes.c_void_p * 6)()
        self._check = build.check

    def kernel_keys(self) -> tuple:
        """The names torch.profiler gives the plan's two kernels."""
        a = "proj_as_kernel" if self.plan.a is not None else \
            "proj_a_layers_kernel" if self.plan.stream_a else "proj_a_kernel"
        b = "proj_bs_kernel" if self.plan.b is not None else \
            "proj_b_layers_kernel" if self.plan.stream_b else "proj_b_kernel"
        return a, b

    def _fields(self, what, tensors, shape):
        for name, a in zip(what, tensors):
            _check_field(name, a, shape, self.dtype, self.device)

    def _launch_a(self, h, u, v, n, div=True, eta=False, b=False, phi=None,
                  phi_prev=None):
        """One launch of phase A: (u*, v*, div, eta, b, x0), each output of
        the epilogue None where not asked for (x0: where phi is None)."""
        self._fields(("phase A: h", "phase A: u", "phase A: v"), (h, u, v),
                     self._shape3)
        if phi is not None:
            self._fields(("phi", "phi_prev"), (phi, phi_prev), self._shape2)
        with torch.cuda.device(self.device):
            plane = lambda: torch.empty(self._shape2, dtype=self.dtype,
                                        device=self.device)
            us, vs = torch.empty_like(u), torch.empty_like(v)
            ptrs, ints, dbls = self._ops.set(n % 2, (h, u, v))
            stream = torch.cuda.current_stream(self.device).cuda_stream
            if self.plan.a is None:
                outs = (plane(), None, None, None)
                code = self.fn["proj_a"](ptrs, ints, dbls,
                                         us.data_ptr(), vs.data_ptr(),
                                         outs[0].data_ptr(), stream)
            else:
                outs = tuple(plane() if want else None for want in (
                    div, eta, b, phi is not None))
                e = self._epi
                for i, a in enumerate(outs + (phi, phi_prev)):
                    e[i] = None if a is None else a.data_ptr()
                code = self.fn["proj_as"](ptrs, ints, dbls,
                                          us.data_ptr(), vs.data_ptr(), e,
                                          -self.lam, stream)
            self._check(self.lib, code, "phase A kernel launch")
            LAUNCHES["proj_a"] += 1
            STREAM_LAUNCHES["proj_a"] += self.plan.stream_a
        return (us, vs) + outs

    def a(self, h, u, v, n: int):
        """Phase A of step n: (u*, v*, div(U*)), the sweep order from the
        host parity n % 2."""
        if self.on_cpu:
            return proj_a_plain(h, u, v, self.statics, n, self.cfg)
        return self._launch_a(h, u, v, n)[:3]

    def a_rhs(self, h, u, v, n: int, phi=None, phi_prev=None):
        """Phase A of step n and what the solve takes: (u*, v*, rhs, x0),
        the right-hand side of rigid_rhs or implicit_rhs and the warm start
        of warm_x0 from the carries phi, phi_prev (eta^n for the implicit
        free surface without one), in K3a's epilogue where the plan says
        so, else in torch."""
        cfg = self.cfg
        if self.on_cpu or not self.plan.rhs:
            u_s, v_s, div = self.a(h, u, v, n)
            return (u_s, v_s) + _rhs_plain(h, div, self.grid, cfg, self.lam,
                                           phi, phi_prev)
        warm = phi if cfg.warm_start else None
        two = warm is not None and phi_prev is not None
        u_s, v_s, div, eta, b, x0 = self._launch_a(
            h, u, v, n, div=self.rigid, eta=self.rigid or warm is None,
            b=not self.rigid, phi=warm if two else None,
            phi_prev=phi_prev if two else None)
        if not two:
            x0 = warm
        if self.rigid:
            return u_s, v_s, self._demean(div, eta), x0
        return u_s, v_s, b, (eta if x0 is None else x0)

    def _demean(self, div, anom):
        """rigid_rhs from div and the column anomaly (sum_k h - H) mask: its
        de-mean over wet cells and scaling, op for op."""
        mask, dt = self.grid.mask, self.cfg.dt
        if self._mm is None:
            self._mm = _local_dot(mask, mask)
        anom = anom - mask * (_local_dot(anom, mask) / self._mm)
        return (div - anom / dt) / dt

    def b(self, h, u_s, v_s, p, t):
        """Phase B of the step from time t: (h1, u1, v1); the tides of
        finalize are taken at t + dt."""
        if self.on_cpu:
            return proj_b_plain(h, u_s, v_s, p, self.statics, t, self.cfg)
        self._fields(("phase B: h", "phase B: u*", "phase B: v*"),
                     (h, u_s, v_s), self._shape3)
        self._fields(("phase B: p",), (p,), self._shape2)
        t1 = advance_time(t, self.cfg.dt, self.cfg.npdtype)
        with torch.cuda.device(self.device):
            outs = [torch.empty_like(h) for _ in range(3)]
            args = self._ops.set(0, (h, u_s, v_s, p), t1)
            kernel = "proj_b" if self.plan.b is None else "proj_bs"
            code = self.fn[kernel](
                *args, p.data_ptr(), _corr(self.cfg),
                *[a.data_ptr() for a in outs],
                torch.cuda.current_stream(self.device).cuda_stream)
            self._check(self.lib, code, "phase B kernel launch")
            LAUNCHES["proj_b"] += 1
            STREAM_LAUNCHES["proj_b"] += self.plan.stream_b
        return tuple(outs)


def proj_a(h, u, v, statics, n: int, cfg: Config):
    """Phase A of step n: (u*, v*, div(U*)), one launch on CUDA tensors
    (`plan`'s kernel), the sweep order from the host
    parity n % 2.  It prepares a Phases per call; a caller that launches
    again holds one."""
    if h.device.type == "cpu":
        return proj_a_plain(h, u, v, statics, n, cfg)
    return Phases(*statics, cfg, h.dtype).a(h, u, v, n)


def proj_b(h, u_s, v_s, p, statics, t, cfg: Config):
    """Phase B of the step from time t: (h1, u1, v1), one launch on CUDA
    tensors; the tides of finalize are taken at t + dt.  It prepares a
    Phases per call, as proj_a does."""
    if h.device.type == "cpu":
        return proj_b_plain(h, u_s, v_s, p, statics, t, cfg)
    return Phases(*statics, cfg, h.dtype).b(h, u_s, v_s, p, t)


def proj_a_tiled(h, u, v, statics, n: int, cfg: Config, tile=None,
                 halo=(4, 3), dmask=None):
    """The staged K3a's schedule on the host, for the tests: the fields and
    statics cut into blocks of `tile` (default: the plan's) with halo =
    (lo, hi) points below and above the tile on both axes, in a ring of
    NaN (fused_fb._block; the staggered masks rebuilt from the block's
    mask where dmask, by default where the grid's are make_grid's), phase
    A on each as a grid of its own, the interiors joined: (u*, v*, div).
    Bit for bit proj_a_plain at the kernel's halo (4, 3): its stages reach 4
    points below a tile's points and 3 above (csrc/projection_body.cuh,
    pas); a narrower one lets the NaN in."""
    if tile is None:
        g = plan(cfg, h.dtype).a
        tile = (g.tx, g.ty)
    dmask = derived_masks(statics[0]) if dmask is None else dmask
    lo, hi = halo
    return fused_fb._tiled(lambda f, st, c: proj_a_plain(*f, st, n, c),
                           (h, u, v), statics, cfg, tile, (lo, hi, lo, hi),
                           dmask)


def proj_b_tiled(h, u_s, v_s, p, statics, t, cfg: Config, tile=None,
                 halo=None, dmask=None):
    """The staged K3b's schedule on the host, as proj_a_tiled: halo =
    (y, x) points around the tile (default: the kernel's, halo_b on y and
    4 on x), phase B on each block: (h1, u1, v1)."""
    if tile is None:
        g = plan(cfg, h.dtype).b
        tile = (g.tx, g.ty)
    dmask = derived_masks(statics[0]) if dmask is None else dmask
    hy, hx = halo or (halo_b(cfg), 4)
    return fused_fb._tiled(lambda f, st, c: proj_b_plain(*f, st, t, c),
                           (h, u_s, v_s, p), statics, cfg, tile,
                           (hy, hy, hx, hx), dmask)


def proj_a_streamed(h, u, v, statics, n: int, cfg: Config, tile=None,
                    halo=4):
    """The layer-streamed K3a's schedule on the host, for the tests (csrc/
    projection_body.cuh: pal): each tile's block with the halo 4 (or
    `halo`) in a ring of NaN, and for each layer from the surface
    Montgomery's running sums without the surface term, that layer's
    tendencies and both sweeps from its own h, u, v (the interfacial drag
    from the old u, v of the layers beside it), its u*, v*, and the
    column's transports added as they come; after the last layer div from
    them.  (u*, v*, div): u*, v* bit for bit proj_a_plain at the kernel's
    halo; div adds the layers in order from the surface where the plain
    version's torch.sum takes an order of its own past two layers."""
    from beom_tpu_torch.core import ops

    tile = tile or single_tile(cfg, h.dtype, True)[0]

    def phase_a(fields, st, c):
        (h, u, v), (g, fo) = fields, st
        z = torch.zeros(h.shape[1:], dtype=h.dtype, device=h.device)
        acc = c.gprime[0] * z
        us, vs = [], []
        for k in range(c.nz):
            if k > 0:
                z = z - h[k - 1]
                acc = acc + c.gprime[k] * z
            u1, v1 = fused_fb._layer_sweeps(h, u, v, g, fo, c, k, acc, n)
            U_k, V_k = ops.a_xp(h[k]) * u1[0], ops.a_yp(h[k]) * v1[0]
            U = U_k if k == 0 else U + U_k
            V = V_k if k == 0 else V + V_k
            us.append(u1)
            vs.append(v1)
        U, V = U * g.mask_u, V * g.mask_v
        div = (ops.d_xm(U, c.dx) + ops.d_ym(V, c.dy)) * g.mask
        return torch.cat(us), torch.cat(vs), div

    return fused_fb._tiled(phase_a, (h, u, v), statics, cfg, tile,
                           (halo,) * 4)


def proj_b_streamed(h, u_s, v_s, p, statics, t, cfg: Config, tile=None,
                    halo=None):
    """The layer-streamed K3b's schedule on the host, for the tests (csrc/
    projection_body.cuh: pbl): each tile's block with the halo halo_b (or
    `halo`) in a ring of NaN, and for each layer from the surface that
    layer's correction by grad p, continuity and gates from its own h, u*,
    v* alone; after the last layer Flather's increments, from its sums
    over the written layers, added to every layer.  Equal to proj_b_plain
    bit for bit at the kernel's halo."""
    from beom_tpu_torch.core import ops
    from beom_tpu_torch.physics import continuity, obc, wetdry

    tile = tile or single_tile(cfg, h.dtype, True)[0]
    hw = halo_b(cfg) if halo is None else halo
    t1 = advance_time(t, cfg.dt, cfg.npdtype)
    corr = _corr(cfg)

    def phase_b(fields, st, c):
        (h, u_s, v_s, p), (g, fo) = fields, st
        dpx = g.mask_u * ops.d_xp(p, c.dx)
        dpy = g.mask_v * ops.d_yp(p, c.dy)
        out = ([], [], [])
        for k in range(c.nz):
            one = fused_fb._layer_cfg(c, k)
            hk = h[k:k + 1]
            u1 = (u_s[k:k + 1] - corr * dpx[None]) * g.mask_u
            v1 = (v_s[k:k + 1] - corr * dpy[None]) * g.mask_v
            h1 = (hk + c.dt * continuity.continuity_rhs(hk, u1, v1, g, one)) \
                * g.mask
            if c.wetdry:
                wet = wetdry.wet_mask(h1, g, one)
                u1, v1 = wetdry.gate_u(u1, wet, g), wetdry.gate_v(v1, wet, g)
            for o, a in zip(out, (h1, u1, v1)):
                o.append(a)
        h1, u1, v1 = (torch.cat(o) for o in out)
        # Flather's fix-up of what the layers wrote
        return (h1,) + obc.apply_flather(h1, u1, v1, g, fo, c, t1)

    return fused_fb._tiled(phase_b, (h, u_s, v_s, p), statics, cfg, tile,
                           (hw,) * 4)


def make_solve(grid: Grid, cfg: Config, lam):
    """solve(b, x0=None) -> x, chosen as the reference's stepper chooses
    it, with the fused CG at every size (the reference's VMEM cap is a
    TPU limit, not part of the function)."""
    if cfg.solver == "redblack":
        from beom_tpu_torch.stencils.redblack import make_fused_rb_solve
        # the XLA path's fixed sweep budget: never more sweeps, usually
        # fewer (residual early exit)
        return make_fused_rb_solve(
            grid, cfg, lam=lam, k=K_SWEEPS,
            max_passes=max(1, cfg.solver_maxiter // K_SWEEPS))
    if cfg.solver == "mg":
        from beom_tpu_torch.solvers.multigrid import make_mg_solver
        return make_mg_solver(grid, cfg, lam=lam, smoother="fused")
    pre = projection.effective_precond(cfg, lam)
    if pre in ("jacobi", "mg"):
        from beom_tpu_torch.stencils.cg_fused import make_cg_solve
        fused_solve = make_cg_solve(grid, cfg, lam=lam, precond=pre)

        if pre == "jacobi":
            # the step takes x alone: no read-back of the iteration count,
            # so the host goes on queueing while the solve runs
            def solve(b, x0=None):
                return fused_solve(b, x0=x0, count=False).x
            return solve
        return _guarded(fused_solve, grid, cfg, lam)

    def solve(b, x0=None):     # ssor: the eager solve
        return projection._solve(b, grid, cfg, lam=lam, x0=x0)
    return solve


def _guarded(fused_solve, grid: Grid, cfg: Config, lam):
    """The multigrid-preconditioned fused solve behind the reference
    stepper's stall guard.  The fused tier's cycle runs V on its deepest
    two transitions (multigrid.fused_gamma_schedule), and on some grids
    and masks CG stalls with it (shelf_forced under the rigid lid: in the
    reference too).  When the residual says the solve stalled, it is redone
    with the W-cycle at every transition, the eager tier's preconditioner,
    through the blocked smoother and the coarse-stack kernel."""
    from beom_tpu_torch.solvers import elliptic, multigrid

    tol_eff = max(cfg.solver_tol,
                  30.0 * float(torch.finfo(grid.mask.dtype).eps))
    tiny = float(torch.finfo(grid.mask.dtype).tiny)

    @functools.lru_cache(maxsize=None)
    def symmetric():        # built at the first stall
        # a tuple names gamma per transition and passes the fused schedule
        # untouched; it is longer than any hierarchy
        return multigrid.make_mg_precond(
            grid, cfg, lam=lam, smoother="fused", gamma=(2,) * 32)

    def solve(b, x0=None):
        res = fused_solve(b, x0=x0)
        b2 = torch.sum((b * grid.mask) ** 2)
        thr = tol_eff * tol_eff * torch.clamp_min(b2, tiny)
        if bool(res.resnorm > 100.0 * thr):
            COUNTS["stalled"] += 1
            return elliptic.cg_solve(b, grid, cfg, x0=x0, lam=lam,
                                     precond=symmetric()).x
        return res.x

    return solve


def make_fused_projection_stepper(grid: Grid, forcing: Forcing,
                                  cfg: Config):
    """step(state) -> state advancing one rigid-lid / implicit-FS step
    through the phase kernels and the solver kernels: phase A with the
    solve's right-hand side and warm start (Phases.a_rhs), the solve,
    phase B."""
    check_config(cfg)
    solve = make_solve(grid, cfg, projection.solve_lam(cfg))
    ph = Phases(grid, forcing, cfg)

    def step(state: State) -> State:
        u_s, v_s, rhs, x0 = ph.a_rhs(state.h, state.u, state.v, state.n,
                                     state.phi, state.phi_prev)
        p = solve(rhs, x0=x0)
        h1, u1, v1 = ph.b(state.h, u_s, v_s, p, state.t)
        out = State(h=h1, u=u1, v=v1,
                    t=advance_time(state.t, cfg.dt, cfg.npdtype),
                    n=state.n + 1)
        return projection.with_carry(out, state, p)

    return step
