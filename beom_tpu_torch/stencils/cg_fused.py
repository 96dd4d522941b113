"""The whole preconditioned CG solve in one launch (K6) and its plain
PyTorch version.

The CUDA kernel `csrc/cg_fused.cu` replaces the TPU kernel
beom_tpu/stencils/cg_vmem.py::_cg_kernel: the single-reduction
Chronopoulos-Gear CG of solvers/elliptic.cg_solve, with its nullspace
deflation for lam = 0, runs to convergence in one cooperative launch with
grid-wide syncs, preconditioned by Jacobi or by one multigrid cycle per
iteration (the fused gamma schedule, nu = 2, nu_coarse = 24, min_size 16,
no de-mean, walked in the kernel as stencils/mg_coarse.py flattens it:
two tiled passes per visit of a level above the shared-memory tier, the
tier's levels on one CTA).  The reference keeps the solver state
in VMEM and so runs the kernel only up to about 1024^2 f32; here the
state lives in device memory and the kernel runs at every size.

`make_cg_solve(...)` returns solve(b, x0=None) -> CGResult.  CPU tensors
take the plain version, `cg_solve_plain` (elliptic.cg_solve with the
Jacobi preconditioner or the eager cycle); CUDA tensors take the kernel
or raise.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from beom_tpu_torch.core.config import Config
from beom_tpu_torch.core.grid import Grid
from beom_tpu_torch.solvers import elliptic
from beom_tpu_torch.solvers import multigrid as mg
from beom_tpu_torch.solvers.elliptic import CGResult

# kernel launches made by the solves; a run reads it to show that its
# main path went through the kernel
LAUNCHES = 0

_ENTRY = {torch.float32: "beom_cg_fused_f32",
          torch.float64: "beom_cg_fused_f64"}
_NDOT = 6          # partial sums per CTA (csrc/mg_cycle.cuh NDOT)
# the in-kernel multigrid cycle (the reference's make_vmem_cg_solve)
MG_NU, MG_NU_COARSE, MG_MIN_SIZE = 2, 24, 16


def mg_levels(grid: Grid, cfg: Config, lam):
    """(levels, gamma) of the kernel's multigrid preconditioner."""
    levels = mg.build_levels(grid, cfg, lam, min_size=MG_MIN_SIZE)
    return levels, mg.fused_gamma_schedule(levels, 2)


def cg_solve_plain(b, grid: Grid, cfg: Config, x0=None, lam=0.0,
                   tol: Optional[float] = None,
                   maxiter: Optional[int] = None,
                   precond: str = "jacobi", levels=None) -> CGResult:
    """The plain version of the kernel: elliptic.cg_solve with Jacobi, or
    with one eager cycle on `levels` (default mg_levels) as the
    preconditioner."""
    pre = None
    if precond == "mg":
        levels, gamma = mg_levels(grid, cfg, lam) if levels is None \
            else (levels, mg.fused_gamma_schedule(levels, 2))
        pre = mg.cycle_precond(levels, lam, MG_NU, MG_NU_COARSE, gamma)
    return elliptic.cg_solve(b, grid, cfg, x0=x0, lam=lam, tol=tol,
                             maxiter=maxiter, precond=pre)


def _entry(dtype):
    from beom_tpu_torch.stencils import build

    lib = build.load("cg_fused")
    fn = getattr(lib, _ENTRY[dtype])
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    fn.argtypes = [P] * 13 + [I] + [P] * 2 + [I] * 4 + [D] * 5 + [P] * 4 \
        + [I] * 5 + [P, I, P]
    fn.restype = I
    blocks = getattr(lib, _ENTRY[dtype].replace("fused", "fused_blocks"))
    blocks.argtypes = [I, ctypes.POINTER(ctypes.c_int)]
    blocks.restype = I
    smem = getattr(lib, _ENTRY[dtype].replace("fused", "fused_smem"))
    smem.argtypes = [ctypes.POINTER(ctypes.c_int)]
    smem.restype = I
    return lib, fn, blocks, smem


def _grid_blocks(dtype, use_mg: bool) -> int:
    """The number of CTAs a launch of the kernel (the Jacobi or the
    multigrid instantiation) uses on this card."""
    from beom_tpu_torch.stencils import build

    lib, _, blocks, _ = _entry(dtype)
    n = ctypes.c_int(0)
    build.check(lib, blocks(int(use_mg), ctypes.byref(n)),
                "cg_fused occupancy query")
    return n.value


def _cycle_smem(dtype) -> int:
    """The shared memory each CTA of the multigrid instantiation has on
    this card."""
    from beom_tpu_torch.stencils import build

    lib, _, _, smem = _entry(dtype)
    n = ctypes.c_int(0)
    build.check(lib, smem(ctypes.byref(n)), "cg_fused shared-memory query")
    return n.value


def make_cg_solve(grid: Grid, cfg: Config, lam: float = 0.0,
                  precond: Optional[str] = None,
                  tol: Optional[float] = None,
                  maxiter: Optional[int] = None):
    """solve(b, x0=None) -> CGResult, the whole preconditioned CG in one
    kernel launch.  precond: the cfg.precond='auto' rule by default (mg
    for the lam = 0 solve, jacobi otherwise); 'ssor' is not offered in the
    kernel and becomes 'jacobi', as in the reference.  solve.steps is the
    multigrid cycle's flattened step list (empty with Jacobi), on the CPU
    the H100's."""
    from beom_tpu_torch.stencils.mg_coarse import (BC, H100_SMEM, XC,
                                                   CycleTables, plan)

    precond = cfg.precond if precond is None else precond
    if precond == "auto":
        precond = "mg" if lam == 0.0 else "jacobi"
    if precond == "ssor":
        precond = "jacobi"
    if precond not in ("jacobi", "mg"):
        raise ValueError(f"unknown precond {precond!r}")
    use_mg = precond == "mg"
    mask = grid.mask
    dtype = mask.dtype
    tol_eff = max(cfg.solver_tol if tol is None else tol,
                  30.0 * float(torch.finfo(dtype).eps))
    maxiter = cfg.solver_maxiter if maxiter is None else maxiter
    on_cpu = mask.device.type == "cpu"
    if not on_cpu:
        if mask.device.type != "cuda":
            raise NotImplementedError(
                f"the fused CG runs on cuda or cpu, not {mask.device.type}")
        if dtype not in _ENTRY:
            raise ValueError(f"fused CG: dtype {dtype}")
    steps, levels = [], None
    if use_mg:
        levels, gamma = mg_levels(grid, cfg, lam)
        if on_cpu:
            smem = H100_SMEM
        else:
            with torch.cuda.device(mask.device):
                smem = _cycle_smem(dtype)
        tier, steps = plan(levels, lam, MG_NU, MG_NU_COARSE, gamma, False,
                           smem)
    if not on_cpu:
        Hu, Hv = elliptic.face_depths(grid)
        _, inv_diag = elliptic.jacobi_diag(grid, cfg, lam)
        statics = [t.contiguous() for t in (Hu, Hv, mask, inv_diag)]
        tables = None
        if use_mg:
            with torch.cuda.device(mask.device):
                tables = CycleTables(levels, steps, MG_NU, tier)

    def solve(b, x0=None) -> CGResult:
        global LAUNCHES
        if on_cpu:
            if b.device.type != "cpu":
                raise ValueError("fused CG: b is not on the grid's device")
            return cg_solve_plain(b, grid, cfg, x0=x0, lam=lam, tol=tol,
                                  maxiter=maxiter, precond=precond,
                                  levels=levels)
        from beom_tpu_torch.stencils import build

        x0 = torch.zeros_like(b) if x0 is None else x0
        for a in (b, x0):
            if a.device != mask.device or a.dtype != dtype \
                    or not a.is_contiguous() or a.shape != mask.shape:
                raise ValueError(
                    "fused CG: b and x0 must be contiguous "
                    f"{dtype} tensors of {tuple(mask.shape)} on "
                    f"{mask.device}")
        with torch.cuda.device(b.device):
            lib, fn, _, _ = _entry(dtype)
            work = [torch.empty_like(b) for _ in range(6)]  # x r u w p s
            if use_mg:      # the cycle reads r from BC, writes u in XC
                work[2] = tables.field(0, XC)
                mg_args = (*tables.args(), tables.field(0, BC).data_ptr(), 1)
            else:
                mg_args = (None, None, None, None, 0, 0, 0, 0, 0, None, 0)
            n_part = 2 * _NDOT * _grid_blocks(dtype, use_mg)
            partials = torch.empty(n_part, dtype=dtype, device=b.device)
            iters = torch.empty(1, dtype=torch.int32, device=b.device)
            resnorm = torch.empty(1, dtype=dtype, device=b.device)
            code = fn(*[a.data_ptr() for a in [b, x0] + statics + work],
                      partials.data_ptr(), n_part, iters.data_ptr(),
                      resnorm.data_ptr(), cfg.ny, cfg.nx, maxiter,
                      int(lam == 0.0), 1.0 / cfg.dx, 1.0 / cfg.dy, lam,
                      tol_eff * tol_eff, float(torch.finfo(dtype).tiny),
                      *mg_args,
                      torch.cuda.current_stream(b.device).cuda_stream)
            build.check(lib, code, "cg_fused kernel launch")
            LAUNCHES += 1
        return CGResult(x=work[0], iters=int(iters.item()),
                        resnorm=resnorm[0])

    solve.steps = steps
    return solve
