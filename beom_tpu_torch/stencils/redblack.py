"""Blocked red-black SOR (K4a) and its plain PyTorch version.

The CUDA kernel `csrc/rb_sweep.cu` replaces the TPU kernel
beom_tpu/stencils/redblack_pallas.py::_rb_kernel (make_level_sweep): k
red-black sweeps in one pass over device memory.  Each tile is loaded
with a halo of 2k + 1 cells on both axes, so a launch is exactly k
strict red-black sweeps (the reference's bands lag at their seams); the
plain version is k sweeps of solvers/elliptic.rb_sweeps.

`make_fused_rb_solve` (the reference's make_pallas_rb_solve) runs
passes of k sweeps until ||b - A x|| <= tol ||b||, at most `max_passes`,
with one exact residual (laplacian_H) per pass read on the host: plain
torch, as the reference's loop is XLA.

On CPU tensors the sweep takes the plain version; on CUDA tensors it
launches the kernel or raises.  The reference's fused-residual mode and
its single-pass operator kernel serve multigrid only and are not ported
yet.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from beom_tpu_torch.core.config import Config
from beom_tpu_torch.core.grid import Grid
from beom_tpu_torch.solvers import elliptic

# kernel launches made by rb_sweep, and passes run by the blocked solves'
# loops; a run reads them to show that its main path went through the
# kernel, one launch per pass
LAUNCHES = 0
PASSES = 0

_ENTRY = {torch.float32: "beom_rb_sweep_f32",
          torch.float64: "beom_rb_sweep_f64"}


def rb_sweep_plain(x, b, Hu, Hv, mask, dx: float, dy: float, *,
                   lam=0.0, k: int = 1, omega: float = 1.0,
                   reverse: bool = False):
    """k red-black sweeps: the plain PyTorch version of the kernel."""
    return elliptic.rb_sweeps(x, b, Hu, Hv, mask, dx, dy, lam=lam,
                              omega=omega, sweeps=k, reverse=reverse)


def _entry(dtype):
    from beom_tpu_torch.stencils import build

    lib = build.load("rb_sweep")
    fn = getattr(lib, _ENTRY[dtype])
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    fn.argtypes = [P] * 6 + [I] * 4 + [D] * 5 + [P]
    fn.restype = I
    return lib, fn


def rb_sweep(x, b, Hu, Hv, mask, dx: float, dy: float, *, lam=0.0,
             k: int = 1, omega: float = 1.0, reverse: bool = False):
    """k red-black SOR sweeps of A x = b from x (black-red colour order
    when `reverse`) in one launch; returns the new x."""
    global LAUNCHES
    if x.device.type == "cpu":
        return rb_sweep_plain(x, b, Hu, Hv, mask, dx, dy, lam=lam, k=k,
                              omega=omega, reverse=reverse)
    if x.device.type != "cuda":
        raise NotImplementedError(
            f"the red-black sweep runs on cuda or cpu, not {x.device.type}")
    from beom_tpu_torch.stencils import build

    ny, nx = mask.shape
    for a in (x, b, Hu, Hv, mask):
        if a.device != x.device or a.dtype != x.dtype \
                or not a.is_contiguous() or a.shape != (ny, nx):
            raise ValueError(
                "red-black sweep: every operand must be a contiguous "
                f"{x.dtype} tensor of ({ny}, {nx}) on {x.device}")
    if x.dtype not in _ENTRY:
        raise ValueError(f"red-black sweep: dtype {x.dtype}")
    with torch.cuda.device(x.device):
        lib, fn = _entry(x.dtype)
        out = torch.empty_like(x)
        code = fn(x.data_ptr(), b.data_ptr(), Hu.data_ptr(), Hv.data_ptr(),
                  mask.data_ptr(), out.data_ptr(), ny, nx, k, int(reverse),
                  1.0 / dx ** 2, 1.0 / dy ** 2, lam, omega, 1.0 - omega,
                  torch.cuda.current_stream(x.device).cuda_stream)
        build.check(lib, code, "rb_sweep kernel launch")
        LAUNCHES += 1
    return out


def make_level_sweep(Hu, Hv, mask, dx: float, dy: float, *,
                     lam=0.0, k: int = 1, omega: float = 1.0,
                     reverse: bool = False):
    """sweep(x, b) -> x: k red-black sweeps in one pass on a periodic
    (ny, nx) level given by its face depths and mask."""
    def sweep(x, b):
        return rb_sweep(x, b, Hu, Hv, mask, dx, dy, lam=lam, k=k,
                        omega=omega, reverse=reverse)

    return sweep


def make_rb_solver(grid: Grid, cfg: Config, lam=0.0, k: int = 8,
                   omega: Optional[float] = None):
    """sweep_k(x, b) -> x: k red-black sweeps on the model grid."""
    omega = cfg.sor_omega if omega is None else omega
    Hu, Hv = elliptic.face_depths(grid)
    return make_level_sweep(Hu.contiguous(), Hv.contiguous(), grid.mask,
                            cfg.dx, cfg.dy, lam=lam, k=k, omega=omega)


def make_fused_rb_solve(grid: Grid, cfg: Config, lam=0.0, k: int = 8,
                        tol: Optional[float] = None, max_passes: int = 200):
    """solve(b, x0=None) -> x: passes of k sweeps until
    |b - A x|^2 <= tol^2 |b|^2 (tol clamped to 30 eps of cfg.dtype) or
    max_passes; the residual costs one laplacian_H per pass."""
    tol = cfg.solver_tol if tol is None else tol
    tol = max(tol, 30.0 * float(torch.finfo(cfg.tdtype).eps))
    sweep_k = make_rb_solver(grid, cfg, lam=lam, k=k)
    Hu, Hv = elliptic.face_depths(grid)
    mask = grid.mask

    def solve(b, x0=None):
        global PASSES
        b = b * mask
        x = torch.zeros_like(b) if x0 is None else x0 * mask
        b2 = torch.sum(b * b)
        threshold = (tol * tol) * torch.clamp_min(
            b2, torch.finfo(b.dtype).tiny)
        for _ in range(max_passes):
            r = (b - elliptic.laplacian_H(x, Hu, Hv, grid, cfg,
                                          lam=lam)) * mask
            if not bool(torch.sum(r * r) > threshold):    # host read
                break
            x = sweep_k(x, b)
            PASSES += 1
        return x

    return solve


def solve_fused(b, grid: Grid, cfg: Config, lam=0.0, x0=None, k: int = 8,
                tol: Optional[float] = None, max_passes: int = 200):
    """One-shot convenience wrapper over make_fused_rb_solve."""
    return make_fused_rb_solve(grid, cfg, lam=lam, k=k, tol=tol,
                               max_passes=max_passes)(b, x0=x0)
