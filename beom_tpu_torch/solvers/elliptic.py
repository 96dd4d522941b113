"""Iterative elliptic solvers for the rigid-lid / implicit-free-surface
pressure: the port's twin of beom_tpu/solvers/elliptic.py.

The operator is the masked variable-coefficient Laplacian at cell centres

    A p = div( H_face * grad p )        [- lam * p  (Helmholtz mode)]

with H averaged to the open faces (mask_u / mask_v), so A is symmetric
negative semi-definite on the wet subspace; closed walls are natural
(zero-flux) boundaries because masked faces drop out of the divergence.

  * `cg_solve`: preconditioned conjugate gradients in the single-
    reduction Chronopoulos-Gear form, with the nullspace deflation of the
    pure-Neumann (lam = 0) problem.  The loop is a Python loop whose
    condition reads |r|^2 to the host once per iteration; it is the plain
    version of the fused CG kernel (stencils/cg_fused.py).
  * `redblack_solve`: checkerboard SOR sweeps; `rb_sweeps` is the sweep
    loop, the plain version of the blocked sweep kernel
    (stencils/redblack.py).

The `dot`/`dots`/`matvec`/`inv_diag` hooks of cg_solve and the
`pad1`/`crop1`/`red` hooks of make_ssor_precond serve the distributed
tier (parallel/dist.py), which passes the mesh reductions, the
halo-pipelined operator and the halo exchange; their defaults are the
single-device operations, and the solver code itself does not know the
topology.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from beom_tpu_torch.core import ops
from beom_tpu_torch.core.config import Config
from beom_tpu_torch.core.grid import Grid


def face_depths(grid: Grid):
    """H averaged to open u/v faces: (Hu, Hv), zero across walls."""
    Hu = grid.mask_u * ops.a_xp(grid.H)
    Hv = grid.mask_v * ops.a_yp(grid.H)
    return Hu, Hv


def laplacian(p, Hu, Hv, mask, dx: float, dy: float, lam=0.0):
    """A p = div(H grad p) - lam p at wet centres (ny, nx), from the face
    depths, the mask and the spacing."""
    gx = Hu * ops.d_xp(p, dx)           # at u faces
    gy = Hv * ops.d_yp(p, dy)           # at v faces
    out = (ops.d_xm(gx, dx) + ops.d_ym(gy, dy))
    if lam != 0.0:
        out = out - lam * p
    return out * mask


def laplacian_H(p, Hu, Hv, grid: Grid, cfg: Config, lam=0.0):
    """A p = div(H grad p) - lam p at wet centres (ny, nx)."""
    return laplacian(p, Hu, Hv, grid.mask, cfg.dx, cfg.dy, lam=lam)


def _local_dot(a, b):
    return torch.sum(a * b)


def _local_dots(pairs):
    """Batched dot products -> stacked 1-d tensor: one reduction covers
    every scalar of a CG iteration."""
    return torch.stack([torch.sum(a * b) for a, b in pairs])


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int               # iterations run
    resnorm: torch.Tensor    # () final |r|^2


def jacobi_diag(grid: Grid, cfg: Config, lam=0.0):
    """Diagonal of A and its safe inverse (Jacobi preconditioner).

    diag(A) = -(Hu + Hu_west)/dx^2 - (Hv + Hv_south)/dy^2 - lam; land /
    isolated cells (diag = 0) get preconditioner 1.
    """
    Hu, Hv = face_depths(grid)
    diag = -((Hu + ops.sxm(Hu)) / cfg.dx ** 2
             + (Hv + ops.sym(Hv)) / cfg.dy ** 2) - lam
    inv_diag = torch.where(diag.abs() > 0,
                           1.0 / torch.where(diag == 0, 1.0, diag), 1.0)
    return diag, inv_diag


def _checkerboard(shape, dtype, device):
    """1 where (row + column) is even (red), else 0."""
    j = torch.arange(shape[-2], device=device)[:, None]
    i = torch.arange(shape[-1], device=device)[None, :]
    return (((i + j) % 2) == 0).to(dtype)


def _rb_inv_diag(Hu, Hv, rdx2: float, rdy2: float, lam):
    """1/diag(A) of the red-black sweeps: 0 where diag = 0."""
    diag = -((Hu + ops.sxm(Hu)) * rdx2 + (Hv + ops.sym(Hv)) * rdy2) - lam
    return torch.where(diag != 0, 1.0 / torch.where(diag == 0, 1.0, diag),
                       0.0)


def make_ssor_precond(grid: Grid, cfg: Config, lam=0.0,
                      sweeps: Optional[int] = None,
                      pad1: Optional[Callable] = None,
                      crop1: Optional[Callable] = None,
                      red=None):
    """Symmetric Gauss-Seidel (red-black ordered) preconditioner
    z = M^{-1} r: `sweeps` forward (red, black) + backward (black, red)
    passes from x = 0, omega = 1 so M is symmetric positive (CG-safe).

    pad1/crop1 (default identity: the periodic rolls wrap by themselves)
    are the distributed 1-halo exchange hooks, and `grid` then arrives
    1-halo padded; `red` overrides the checkerboard (the distributed path
    needs the global colouring).
    """
    sweeps = cfg.precond_sweeps if sweeps is None else sweeps
    Hu, Hv = face_depths(grid)
    rdx2, rdy2 = 1.0 / cfg.dx ** 2, 1.0 / cfg.dy ** 2
    inv_diag = _rb_inv_diag(Hu, Hv, rdx2, rdy2, lam)
    Hu_w = ops.sxm(Hu)
    Hv_s = ops.sym(Hv)
    mask = grid.mask
    if pad1 is None:
        def pad1(a):
            return a

        def crop1(a):
            return a
    else:
        # crop the pointwise factors to the local block
        Hu, Hv, Hu_w, Hv_s = crop1(Hu), crop1(Hv), crop1(Hu_w), crop1(Hv_s)
        inv_diag, mask = crop1(inv_diag), crop1(mask)
    if red is None:
        red = _checkerboard(mask.shape, mask.dtype, mask.device) * mask
    black = (1.0 - red) * mask

    def halfsweep(x, b, colour):
        xp = pad1(x)
        nb = (Hu * crop1(ops.sxp(xp)) + Hu_w * crop1(ops.sxm(xp))) * rdx2 \
           + (Hv * crop1(ops.syp(xp)) + Hv_s * crop1(ops.sym(xp))) * rdy2
        x_gs = (b - nb) * inv_diag
        return torch.where(colour > 0, x_gs, x) * mask

    def apply(r):
        b = r * mask
        x = torch.zeros_like(b)
        for _ in range(sweeps):
            x = halfsweep(x, b, red)     # forward GS
            x = halfsweep(x, b, black)
            x = halfsweep(x, b, black)   # backward GS -> symmetric M
            x = halfsweep(x, b, red)
        return x

    return apply


def cg_solve(b, grid: Grid, cfg: Config, x0=None, lam=0.0,
             dot: Callable = _local_dot, tol: Optional[float] = None,
             maxiter: Optional[int] = None,
             matvec: Optional[Callable] = None,
             inv_diag=None,
             dots: Optional[Callable] = None,
             precond: Optional[Callable] = None) -> CGResult:
    """Preconditioned conjugate gradients on A x = b, A = div(H grad) - lam,
    in the single-reduction Chronopoulos-Gear form: the two CG dot
    products, the convergence norm and the nullspace-deflation means are
    all evaluated in one batched reduction per iteration.  Convergence:
    |r|^2 <= tol^2 |b|^2.

    lam == 0 is the pure-Neumann (rigid-lid) problem: A is singular with
    the wet-constant nullspace.  Both the scalar products and the
    carried vectors are re-projected off that nullspace every iteration
    using means from the same reduction; without it, roundoff lets a
    constant component leak into the search direction and the alpha
    denominator eventually hits ~0.

    precond: z = M^{-1} r callback (make_ssor_precond), default the
    Jacobi inv_diag multiply.  Must be symmetric positive definite on
    the wet subspace.

    Distributed use (parallel/dist.py): `dots` = the batched sum with one
    mesh reduction, so an iteration costs exactly one; `dot` for the
    set-up scalars; `matvec` = the halo-exchanged A; `inv_diag` computed
    on the padded grid; `precond` with its exchange hooks.
    """
    tol = cfg.solver_tol if tol is None else tol
    # f32 cannot reach f64-grade tolerances; clamp to ~30 eps so CG
    # stops at stagnation instead of burning maxiter and diverging
    tol = max(tol, 30.0 * float(torch.finfo(b.dtype).eps))
    maxiter = cfg.solver_maxiter if maxiter is None else maxiter
    if dots is None:
        if dot is not _local_dot:
            def dots(pairs):
                return torch.stack([dot(a, c) for a, c in pairs])
        else:
            dots = _local_dots

    if precond is None:
        if inv_diag is None:
            _, inv_diag = jacobi_diag(grid, cfg, lam)

        def precond(r):
            return inv_diag * r

    if matvec is None:
        Hu, Hv = face_depths(grid)

        def A(p):
            return laplacian_H(p, Hu, Hv, grid, cfg, lam=lam)
    else:
        A = matvec

    mask = grid.mask
    eps = torch.finfo(b.dtype).tiny
    deflating = lam == 0.0
    if deflating:
        nwet = torch.clamp_min(dot(mask, mask), 1.0)

        def fused(r, u, w):
            """(gamma, delta, rr) of the deflated vectors + deflated
            (r, u): one batched reduction covers the CG scalars and the
            nullspace means."""
            d = dots([(r, u), (w, u), (r, r),
                      (r, mask), (u, mask), (w, mask)])
            ru, wu, rr, rm, um, wm = d.unbind()
            gamma = ru - rm * um / nwet
            delta = wu - wm * um / nwet
            rr_d = rr - rm * rm / nwet
            r = (r - (rm / nwet) * mask) * mask
            u = (u - (um / nwet) * mask) * mask
            return gamma, delta, rr_d, r, u
    else:
        def fused(r, u, w):
            d = dots([(r, u), (w, u), (r, r)])
            ru, wu, rr = d.unbind()
            return ru, wu, rr, r * mask, u * mask

    def deflate0(v):
        if not deflating:
            return v * mask
        return (v - mask * (dot(v, mask) / nwet)) * mask

    b = deflate0(b * mask)
    x = torch.zeros_like(b) if x0 is None else deflate0(x0)

    b2 = dot(b, b)
    threshold = (tol * tol) * torch.clamp_min(b2, eps)

    def safe_div(num, den):
        mag = torch.clamp_min(den.abs(), eps)
        return num / torch.where(den < 0, -mag, mag)

    r = (b - A(x)) * mask
    u = precond(r) * mask
    w = A(u)
    gamma, delta, rr, r, u = fused(r, u, w)
    alpha = safe_div(gamma, delta)
    beta = torch.zeros_like(alpha)
    p = s = torch.zeros_like(b)

    k = 0
    # one host read of rr per iteration: the plain version's sync
    while k < maxiter and bool(rr > threshold):
        p = u + beta * p
        s = w + beta * s
        x = x + alpha * p
        r = r - alpha * s
        u = precond(r) * mask
        w = A(u)
        gamma_n, delta, rr, r, u = fused(r, u, w)
        beta_n = safe_div(gamma_n, gamma)
        alpha = safe_div(gamma_n, delta - beta_n * safe_div(gamma_n, alpha))
        beta, gamma = beta_n, gamma_n
        k += 1
    return CGResult(x=x * mask, iters=k, resnorm=rr)


def rb_sweeps(x, b, Hu, Hv, mask, dx: float, dy: float, lam=0.0,
              omega: float = 1.0, sweeps: int = 1, reverse: bool = False):
    """`sweeps` red-black SOR sweeps from x on A x = b, as redblack_solve
    runs them: the red checkerboard (global parity of row + column) then
    the black one, or black then red when `reverse`.  b is taken as
    given (the callers mask it)."""
    rdx2, rdy2 = 1.0 / dx ** 2, 1.0 / dy ** 2
    inv_diag = _rb_inv_diag(Hu, Hv, rdx2, rdy2, lam)
    Hu_w, Hv_s = ops.sxm(Hu), ops.sym(Hv)
    board = _checkerboard(mask.shape, mask.dtype, mask.device)
    red = board * mask
    black = (1.0 - board) * mask
    first, second = (black, red) if reverse else (red, black)

    def halfsweep(x, colour):
        # off-diagonal part: sum of neighbour contributions
        nb = (Hu * ops.sxp(x) + Hu_w * ops.sxm(x)) * rdx2 \
           + (Hv * ops.syp(x) + Hv_s * ops.sym(x)) * rdy2
        x_gs = (b - nb) * inv_diag
        x_new = (1.0 - omega) * x + omega * x_gs
        return torch.where(colour > 0, x_new, x) * mask

    for _ in range(sweeps):
        x = halfsweep(x, first)
        x = halfsweep(x, second)
    return x


def redblack_solve(b, grid: Grid, cfg: Config, x0=None, lam=0.0,
                   sweeps: Optional[int] = None,
                   omega: Optional[float] = None) -> torch.Tensor:
    """Red-black SOR on A x = b, a fixed number of sweeps.

    x_c <- (1-w) x_c + w * (b - sum_faces H x_nb / d^2) / diag
    updated on the red checkerboard then the black one per sweep.
    """
    omega = cfg.sor_omega if omega is None else omega
    sweeps = cfg.solver_maxiter if sweeps is None else sweeps
    Hu, Hv = face_depths(grid)
    b = b * grid.mask
    x = torch.zeros_like(b) if x0 is None else x0 * grid.mask
    return rb_sweeps(x, b, Hu, Hv, grid.mask, cfg.dx, cfg.dy, lam=lam,
                     omega=omega, sweeps=sweeps)
