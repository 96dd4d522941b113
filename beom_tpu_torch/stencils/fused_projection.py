"""The fused rigid-lid / implicit-free-surface step: the phase kernels
(K3a, K3b) around the solver kernels, and their plain PyTorch versions.

The CUDA kernels `proj_a` and `proj_b` of `csrc/projection.cu` replace
the TPU kernel beom_tpu/stencils/band.py::_band_kernel running the
bodies body_a and body_b of
beom_tpu/stencils/fused_projection.py::make_pallas_projection_stepper.
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
                  size; 'cg' with 'ssor' -> the plain elliptic.cg_solve
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

import torch

from beom_tpu_torch.core.config import Config
from beom_tpu_torch.core.grid import Grid, Forcing
from beom_tpu_torch.core.state import State, advance_time
from beom_tpu_torch.stepping import fb, projection

# kernel launches made by proj_a and proj_b; a run reads them to show
# that its main path went through the kernels
LAUNCHES = {"proj_a": 0, "proj_b": 0}

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
K_SWEEPS = 8      # red-black sweeps per pass, as the reference's stepper


def _check_scheme(cfg: Config) -> None:
    if cfg.scheme not in ("rigid_lid", "implicit_fs"):
        raise ValueError("fused_projection implements the projection "
                         "schemes; fb uses stencils/fused_fb.py")


def check_config(cfg: Config) -> None:
    """Raise NotImplementedError on any term the phase kernels lack."""
    _check_scheme(cfg)
    unsupported = [name for name, on in (
        ("wetdry", cfg.wetdry), ("obc", cfg.obc), ("sponge", cfg.sponge),
        ("tides", bool(cfg.tides)), ("nu4", cfg.nu4 != 0.0),
        ("cd_bot", cfg.cd_bot != 0.0), ("r_int", cfg.r_int != 0.0),
        ("nz > 1", cfg.nz != 1),
    ) if on]
    if unsupported:
        raise NotImplementedError(
            "the fused projection kernels do not implement: "
            + ", ".join(unsupported))


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


def _entry(which: str, dtype):
    from beom_tpu_torch.stencils import build

    lib = build.load("projection")
    fn = getattr(lib, f"beom_{which}_{_DTYPES[dtype]}")
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    if which == "proj_a":
        fn.argtypes = [P] * 13 + [I] * 7 + [D] * 7 + [P]
    else:
        fn.argtypes = [P] * 10 + [I] * 2 + [D] * 4 + [P]
    fn.restype = I
    return lib, fn


def _check_operands(what, cfg: Config, tensors):
    dev, dtype = tensors[0].device, tensors[0].dtype
    if dev.type != "cuda":
        raise NotImplementedError(f"{what} runs on cuda or cpu, not "
                                  f"{dev.type}")
    check_config(cfg)
    for a in tensors:
        if a.device != dev or a.dtype != dtype or not a.is_contiguous() \
                or a.shape[-2:] != (cfg.ny, cfg.nx):
            raise ValueError(
                f"{what}: every operand must be a contiguous {dtype} "
                f"tensor of (.., {cfg.ny}, {cfg.nx}) on {dev}")
    if dtype not in _DTYPES or dtype != cfg.tdtype:
        raise ValueError(f"{what}: dtype {dtype} with cfg.dtype {cfg.dtype}")


def proj_a(h, u, v, statics, n: int, cfg: Config):
    """Phase A of step n: (u*, v*, div(U*)), one launch on CUDA tensors,
    the sweep order from the host parity n % 2."""
    if h.device.type == "cpu":
        return proj_a_plain(h, u, v, statics, n, cfg)
    from beom_tpu_torch.stencils import build

    grid, forcing = statics
    ins = [h, u, v, grid.mask, grid.mask_u, grid.mask_v, grid.mask_q,
           grid.f_q, forcing.taux, forcing.tauy]
    _check_operands("proj_a", cfg, ins)
    with torch.cuda.device(h.device):
        lib, fn = _entry("proj_a", h.dtype)
        outs = [torch.empty_like(u), torch.empty_like(v),
                torch.empty_like(grid.mask)]
        code = fn(*[a.data_ptr() for a in ins + outs], cfg.ny, cfg.nx,
                  int(n % 2 == 0), int(cfg.adv_scheme == "sadourny_energy"),
                  int(cfg.slip == "free"), int(cfg.nu2 != 0.0),
                  int(cfg.wind), cfg.dt, 1.0 / cfg.dx, 1.0 / cfg.dy,
                  cfg.nu2, cfg.rho0, cfg.h_min, cfg.r_bot,
                  torch.cuda.current_stream(h.device).cuda_stream)
        build.check(lib, code, "proj_a kernel launch")
        LAUNCHES["proj_a"] += 1
    return tuple(outs)


def proj_b(h, u_s, v_s, p, statics, t, cfg: Config):
    """Phase B of the step from time t: (h1, u1, v1), one launch on CUDA
    tensors (finalize, which alone reads t, is the identity for the terms
    the kernel takes)."""
    if h.device.type == "cpu":
        return proj_b_plain(h, u_s, v_s, p, statics, t, cfg)
    from beom_tpu_torch.stencils import build

    grid, _ = statics
    ins = [h, u_s, v_s, p, grid.mask, grid.mask_u, grid.mask_v]
    _check_operands("proj_b", cfg, ins)
    with torch.cuda.device(h.device):
        lib, fn = _entry("proj_b", h.dtype)
        outs = [torch.empty_like(h) for _ in range(3)]
        code = fn(*[a.data_ptr() for a in ins + outs], cfg.ny, cfg.nx,
                  cfg.dt, 1.0 / cfg.dx, 1.0 / cfg.dy, _corr(cfg),
                  torch.cuda.current_stream(h.device).cuda_stream)
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

        def solve(b, x0=None):
            return fused_solve(b, x0=x0).x
        return solve

    def solve(b, x0=None):     # ssor: the eager solve
        return projection._solve(b, grid, cfg, lam=lam, x0=x0)
    return solve


def make_fused_projection_stepper(grid: Grid, forcing: Forcing,
                                  cfg: Config):
    """step(state) -> state advancing one rigid-lid / implicit-FS step
    through the phase kernels and the solver kernels."""
    _check_scheme(cfg)
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
