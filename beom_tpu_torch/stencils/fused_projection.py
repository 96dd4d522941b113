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
  glue (torch)  : the solve's right-hand side (for the rigid lid with
                  one global de-mean), stepping/projection.py's helpers;
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

`proj_a` and `proj_b` run their kernel on CUDA tensors and their plain
versions, `proj_a_plain` and `proj_b_plain`, on CPU tensors.  They never
fall back from one to the other: on a CUDA tensor each launches its
kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from beom_tpu_torch.core.config import Config
from beom_tpu_torch.core.grid import Grid, Forcing
from beom_tpu_torch.core.state import State, advance_time
from beom_tpu_torch.stencils import fused_fb
from beom_tpu_torch.stepping import fb, projection

# kernel launches made by proj_a and proj_b; a run reads them to show
# that its main path went through the kernels
LAUNCHES = {"proj_a": 0, "proj_b": 0}

# solves that the stall guard of the multigrid-preconditioned CG redid
COUNTS = {"stalled": 0}

K_SWEEPS = 8      # red-black sweeps per pass, as the reference's stepper
_KERNELS = ("proj_a", "proj_b")     # in the order of beom_smem_bytes


def check_config(cfg: Config) -> None:
    """Raise on what the phase kernels cannot run: a scheme other than
    the projection schemes, or more layers or tidal constituents than
    their operand slots.  Every term of the eager step is implemented."""
    if cfg.scheme not in ("rigid_lid", "implicit_fs"):
        raise ValueError("fused_projection implements the projection "
                         "schemes; fb uses stencils/fused_fb.py")
    if cfg.nz > fused_fb._MAX_LAYERS \
            or len(cfg.tides) > fused_fb._MAX_LAYERS:
        raise NotImplementedError(
            f"the phase kernels take at most {fused_fb._MAX_LAYERS} layers "
            f"and tidal constituents (nz = {cfg.nz}, {len(cfg.tides)} "
            "constituents)")


def smem_bytes(cfg: Config, tile, elem: int) -> dict:
    """Dynamic shared memory of one CTA of each phase kernel at `tile` =
    (tx, ty) and `elem` bytes per value: the planes of csrc/projection.cu
    times the haloed tile, plus the table of offsets."""
    nz, wd, obc, nu4 = cfg.nz, cfg.wetdry, cfg.obc, cfg.nu4 != 0.0
    wb = (3 if wd else 2) if (wd or obc) else 1

    def block(w, planes):
        return (tile[0] + 2 * w) * (tile[1] + 2 * w) * (planes * elem + 4)

    return {"proj_a": block(4, 7 * nz + 4 + 2 * nz * nu4),
            "proj_b": block(wb, 4 * nz + 4 + 3 * nz * wd + obc)}


def build_spec(cfg: Config, dtype=None):
    """(source, defines) of the build of csrc/projection.cu that runs
    cfg: the compile-time switches and the tile."""
    check_config(cfg)
    elem = torch.empty((), dtype=dtype or cfg.tdtype).element_size()
    tile = fused_fb._pick(
        fused_fb._TILES, lambda t: max(smem_bytes(cfg, t, elem).values()),
        f"the projection phases of nz = {cfg.nz} layers")
    return "projection", fused_fb.term_defines(cfg, tile)


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
def _entries(cfg: Config, dtype):
    """The library that runs cfg and its two entry points, built on first
    use."""
    from beom_tpu_torch.stencils import build

    name, defines = build_spec(cfg, dtype)
    lib = build.load((name, defines))
    value = {d.split("=")[0]: int(d.split("=")[1]) for d in defines}
    elem = torch.empty((), dtype=dtype).element_size()
    want = smem_bytes(cfg, (value["BEOM_TX"], value["BEOM_TY"]), elem)
    for i, kernel in enumerate(_KERNELS):
        have = lib.beom_smem_bytes(i, int(elem == 8))
        if have != want[kernel]:
            raise RuntimeError(
                f"{kernel}: the kernel's shared memory ({have} bytes) is "
                f"not what smem_bytes counts ({want[kernel]})")
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    suffix = fused_fb._SUFFIX[dtype]
    fa = getattr(lib, f"beom_proj_a_{suffix}")
    fa.argtypes, fa.restype = [P] * 7, I
    fb_ = getattr(lib, f"beom_proj_b_{suffix}")
    fb_.argtypes, fb_.restype = [P] * 4 + [D] + [P] * 4, I
    return lib, {"proj_a": fa, "proj_b": fb_}


def _check_plane(what, a, h, cfg: Config):
    if a.device != h.device or a.dtype != h.dtype \
            or not a.is_contiguous() or tuple(a.shape) != (cfg.ny, cfg.nx):
        raise ValueError(
            f"{what} must be a contiguous {h.dtype} tensor of "
            f"({cfg.ny}, {cfg.nx}) on {h.device}")


def proj_a(h, u, v, statics, n: int, cfg: Config):
    """Phase A of step n: (u*, v*, div(U*)), one launch on CUDA tensors,
    the sweep order from the host parity n % 2."""
    if h.device.type == "cpu":
        return proj_a_plain(h, u, v, statics, n, cfg)
    from beom_tpu_torch.stencils import build

    fused_fb._check_operands(h, u, v, statics, cfg, check=check_config)
    with torch.cuda.device(h.device):
        lib, entry = _entries(cfg, h.dtype)
        outs = [torch.empty_like(u), torch.empty_like(v),
                torch.empty_like(h[0])]
        ints, dbls = fused_fb._scalars(cfg, n % 2, 0.0)
        code = entry["proj_a"](
            fused_fb._pointers([h, u, v] + fused_fb._operands(statics)),
            ints, dbls, *[a.data_ptr() for a in outs],
            fused_fb._stream(h.device))
        build.check(lib, code, "proj_a kernel launch")
        LAUNCHES["proj_a"] += 1
    return tuple(outs)


def proj_b(h, u_s, v_s, p, statics, t, cfg: Config):
    """Phase B of the step from time t: (h1, u1, v1), one launch on CUDA
    tensors; the tides of finalize are taken at t + dt."""
    if h.device.type == "cpu":
        return proj_b_plain(h, u_s, v_s, p, statics, t, cfg)
    from beom_tpu_torch.stencils import build

    fused_fb._check_operands(h, u_s, v_s, statics, cfg, check=check_config)
    _check_plane("proj_b: p", p, h, cfg)
    t1 = advance_time(t, cfg.dt, cfg.npdtype)
    with torch.cuda.device(h.device):
        lib, entry = _entries(cfg, h.dtype)
        outs = [torch.empty_like(h) for _ in range(3)]
        ints, dbls = fused_fb._scalars(cfg, 0, t1)
        code = entry["proj_b"](
            fused_fb._pointers([h, u_s, v_s] + fused_fb._operands(statics)),
            ints, dbls, p.data_ptr(), _corr(cfg),
            *[a.data_ptr() for a in outs], fused_fb._stream(h.device))
        build.check(lib, code, "proj_b kernel launch")
        LAUNCHES["proj_b"] += 1
    return tuple(outs)


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
            def solve(b, x0=None):
                return fused_solve(b, x0=x0).x
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
    through the phase kernels and the solver kernels."""
    check_config(cfg)
    rigid = cfg.scheme == "rigid_lid"
    lam = projection.solve_lam(cfg)
    solve = make_solve(grid, cfg, lam)
    statics = (grid, forcing)

    def step(state: State) -> State:
        u_s, v_s, div = proj_a(state.h, state.u, state.v, statics,
                               state.n, cfg)
        warm = projection.warm_x0(state, cfg)
        if rigid:
            rhs = projection.rigid_rhs(state.h, div, grid, cfg)
            p = solve(rhs, x0=warm)
        else:
            b, eta_n = projection.implicit_rhs(state.h, div, grid, cfg, lam)
            p = solve(b, x0=eta_n if warm is None else warm)
        h1, u1, v1 = proj_b(state.h, u_s, v_s, p, statics, state.t, cfg)
        out = State(h=h1, u=u1, v=v1,
                    t=advance_time(state.t, cfg.dt, cfg.npdtype),
                    n=state.n + 1)
        return projection.with_carry(out, state, p)

    return step
