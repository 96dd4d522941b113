"""Blocked red-black SOR (K4a), the single-pass operator (K4b), and their
plain PyTorch versions.

The CUDA kernels of `csrc/rb_sweep.cu` replace the TPU kernels of
beom_tpu/stencils/redblack_pallas.py:
  * K4a, `rb_sweep` (the reference's _rb_kernel, make_level_sweep): k
    red-black sweeps in one pass over device memory, with residual=True
    also r = b - A x of the result.  Each tile is loaded with a halo of
    2k + 1 cells on both axes (2k + 2 with the residual), so a launch is
    exactly k strict red-black sweeps and the residual is exact (the
    reference's bands lag at their seams).  The plain version is k sweeps
    of solvers/elliptic.rb_sweeps, then b - multigrid.operator(x);
  * K4b, `apply_op` (make_apply_kernel): A x or b - A x in one pass; the
    plain version is multigrid.operator.

`make_fused_rb_solve` (the reference's make_pallas_rb_solve) runs
passes of k sweeps until ||b - A x|| <= tol ||b||, at most `max_passes`,
with one exact residual (laplacian_H) per pass read on the host: plain
torch, as the reference's loop is XLA.

On CPU tensors each kernel takes its plain version; on CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from beom_tpu_torch.core import ops
from beom_tpu_torch.core.config import Config
from beom_tpu_torch.core.grid import Grid
from beom_tpu_torch.solvers import elliptic
from beom_tpu_torch.solvers.multigrid import operator

# kernel launches made by rb_sweep (K4a) and apply_op (K4b), and passes
# run by the blocked solves' loops; a run reads them to show that its
# main path went through the kernels, one K4a launch per pass
LAUNCHES = 0
APPLY_LAUNCHES = 0
PASSES = 0

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}


def operator_plain(x, Hu, Hv, mask, dx: float, dy: float, lam=0.0):
    """A x, masked, in multigrid.operator's op order."""
    return operator(x, Hu, ops.sxm(Hu), Hv, ops.sym(Hv), mask,
                    1.0 / dx ** 2, 1.0 / dy ** 2, lam)


def rb_sweep_plain(x, b, Hu, Hv, mask, dx: float, dy: float, *,
                   lam=0.0, k: int = 1, omega: float = 1.0,
                   reverse: bool = False, residual: bool = False):
    """k red-black sweeps, and with `residual` (x, (b - A x) mask): the
    plain PyTorch version of the kernel."""
    x = elliptic.rb_sweeps(x, b, Hu, Hv, mask, dx, dy, lam=lam,
                           omega=omega, sweeps=k, reverse=reverse)
    if not residual:
        return x
    return x, (b - operator_plain(x, Hu, Hv, mask, dx, dy, lam)) * mask


def apply_op_plain(x, b, Hu, Hv, mask, dx: float, dy: float, *, lam=0.0,
                   mode: str = "residual"):
    """A x (mode 'matvec') or (b - A x) mask (mode 'residual')."""
    ax = operator_plain(x, Hu, Hv, mask, dx, dy, lam)
    return ax if mode == "matvec" else (b - ax) * mask


def _entry(kind: str, dtype):
    from beom_tpu_torch.stencils import build

    lib = build.load("rb_sweep")
    fn = getattr(lib, f"beom_{kind}_{_DTYPES[dtype]}")
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    if kind == "rb_sweep":
        fn.argtypes = [P] * 7 + [I] * 4 + [D] * 5 + [P]
    else:
        fn.argtypes = [P] * 6 + [I] * 3 + [D] * 3 + [P]
    fn.restype = I
    return lib, fn


def _check_operands(what, x, tensors):
    if x.device.type != "cuda":
        raise NotImplementedError(
            f"{what} runs on cuda or cpu, not {x.device.type}")
    ny, nx = tensors[-1].shape
    for a in tensors:
        if a.device != x.device or a.dtype != x.dtype \
                or not a.is_contiguous() or a.shape != (ny, nx):
            raise ValueError(
                f"{what}: every operand must be a contiguous "
                f"{x.dtype} tensor of ({ny}, {nx}) on {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"{what}: dtype {x.dtype}")
    return ny, nx


def rb_sweep(x, b, Hu, Hv, mask, dx: float, dy: float, *, lam=0.0,
             k: int = 1, omega: float = 1.0, reverse: bool = False,
             residual: bool = False):
    """k red-black SOR sweeps of A x = b from x (black-red colour order
    when `reverse`) in one launch; returns the new x, or with `residual`
    (x, (b - A x) mask)."""
    global LAUNCHES
    if x.device.type == "cpu":
        return rb_sweep_plain(x, b, Hu, Hv, mask, dx, dy, lam=lam, k=k,
                              omega=omega, reverse=reverse,
                              residual=residual)
    from beom_tpu_torch.stencils import build

    ny, nx = _check_operands("red-black sweep", x, (x, b, Hu, Hv, mask))
    with torch.cuda.device(x.device):
        lib, fn = _entry("rb_sweep", x.dtype)
        out = torch.empty_like(x)
        r = torch.empty_like(x) if residual else None
        code = fn(x.data_ptr(), b.data_ptr(), Hu.data_ptr(), Hv.data_ptr(),
                  mask.data_ptr(), out.data_ptr(),
                  r.data_ptr() if residual else None, ny, nx, k,
                  int(reverse), 1.0 / dx ** 2, 1.0 / dy ** 2, lam, omega,
                  1.0 - omega,
                  torch.cuda.current_stream(x.device).cuda_stream)
        build.check(lib, code, "rb_sweep kernel launch")
        LAUNCHES += 1
    return (out, r) if residual else out


def apply_op(x, b, Hu, Hv, mask, dx: float, dy: float, *, lam=0.0,
             mode: str = "residual"):
    """A x (mode 'matvec'; b is not read) or (b - A x) mask (mode
    'residual') in one launch."""
    global APPLY_LAUNCHES
    if mode not in ("residual", "matvec"):
        raise ValueError(f"unknown mode {mode!r}")
    if x.device.type == "cpu":
        return apply_op_plain(x, b, Hu, Hv, mask, dx, dy, lam=lam, mode=mode)
    from beom_tpu_torch.stencils import build

    matvec = mode == "matvec"
    ops_in = (x, Hu, Hv, mask) if matvec else (x, b, Hu, Hv, mask)
    ny, nx = _check_operands("operator pass", x, ops_in)
    with torch.cuda.device(x.device):
        lib, fn = _entry("apply_op", x.dtype)
        out = torch.empty_like(x)
        code = fn(x.data_ptr(), None if matvec else b.data_ptr(),
                  Hu.data_ptr(), Hv.data_ptr(), mask.data_ptr(),
                  out.data_ptr(), ny, nx, int(matvec), 1.0 / dx ** 2,
                  1.0 / dy ** 2, lam,
                  torch.cuda.current_stream(x.device).cuda_stream)
        build.check(lib, code, "apply_op kernel launch")
        APPLY_LAUNCHES += 1
    return out


def make_level_sweep(Hu, Hv, mask, dx: float, dy: float, *,
                     lam=0.0, k: int = 1, omega: float = 1.0,
                     reverse: bool = False, residual: bool = False):
    """sweep(x, b) -> x (or (x, r) with `residual`): k red-black sweeps in
    one pass on a periodic (ny, nx) level given by its face depths and
    mask."""
    def sweep(x, b):
        return rb_sweep(x, b, Hu, Hv, mask, dx, dy, lam=lam, k=k,
                        omega=omega, reverse=reverse, residual=residual)

    return sweep


def make_apply_kernel(Hu, Hv, mask, dx: float, dy: float, *, lam=0.0,
                      mode: str = "residual"):
    """The operator pass on one level: apply(x, b) -> (b - A x) mask for
    mode 'residual', apply(x) -> A x for mode 'matvec'."""
    if mode == "matvec":
        def apply(x):
            return apply_op(x, None, Hu, Hv, mask, dx, dy, lam=lam,
                            mode=mode)
    else:
        def apply(x, b):
            return apply_op(x, b, Hu, Hv, mask, dx, dy, lam=lam, mode=mode)
    return apply


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
