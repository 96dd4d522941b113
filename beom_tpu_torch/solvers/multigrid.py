"""Geometric multigrid for the masked variable-coefficient Poisson /
Helmholtz operator A p = div(H_face grad p) - lam p: the port's twin of
beom_tpu/solvers/multigrid.py (single device).

  * levels: 2x cell-centred coarsening while ny, nx stay even and
    >= `min_size`, each level defined by its face-coarsened
    transmissibilities (walls stay walls at every level) with any-wet
    cell masks (`build_levels`);
  * smoother: red-black Gauss-Seidel half-sweeps (omega = 1), `nu` pre-
    and post-sweeps, post in reverse colour order so the cycle is a
    symmetric operator;
  * transfers: cell-centred bilinear prolongation and its full-weighting
    adjoint;
  * coarsest level: `nu_coarse` sweeps, half forward and half reversed.

`make_mg_precond` -> z = M^{-1} r, one cycle per application, for
elliptic.cg_solve(precond=...); `make_mg_solver`/`mg_solve` iterate
cycles standalone (cfg.solver = 'mg').  smoother='eager' is op by op
(uniform gamma = 2, the reference's 'xla'); smoother='fused' is the
reference's 'pallas' tier: the fused gamma schedule, the blocked sweep
kernel with its fused residual on the fine levels (K4a), one coarse-stack
kernel per visit of the <= coarse_size tail (K5) and the single-pass
operator kernel for the solver's outer residual (K4b).  On CPU tensors
those kernels run their plain versions.

The standalone solver returns the best iterate seen, taking any
improvement of |r|^2 as the new best; the reference takes a new best only
on a 25 % improvement and can return the initial guess under slow steady
convergence.  Here the 0.75 factor only resets the patience counter.

Under a mesh (parallel/dist.py) the hierarchy is shard-local
(`build_dist_levels`: block-local face coarsening keeps every level on
the same mesh) and the cycle takes the exchange hooks `pad` / `crop`
(the halo exchange), `gsum` (the mesh sum) and `nbr` (the halo-pipelined
neighbour sum); their defaults are the single-device operations.
`make_dist_mg_precond` runs the cycle without the de-mean, so a CG
iteration stays at one mesh reduction.  `mesh_levels` is the same
hierarchy in the global layout, which the mesh's solve on the card
(stencils/mesh_solve.py) hands K6.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from beom_tpu_torch.core import ops
from beom_tpu_torch.core.config import Config
from beom_tpu_torch.core.grid import Grid

PATIENCE = 3         # cycles without a 25 % gain before the solver stops
# cycles run by the standalone solvers; a run reads it to tie the fused
# tier's kernel launches to the cycles
CYCLES = 0


@dataclasses.dataclass(frozen=True)
class Level:
    nwet: torch.Tensor      # () number of wet cells, at least 1
    mask: torch.Tensor      # (ny, nx) wet mask
    Hu: torch.Tensor        # face depths at u faces (masked)
    Hv: torch.Tensor
    Hu_w: torch.Tensor      # west-face depth at the cell (sxm(Hu))
    Hv_s: torch.Tensor
    inv_diag: torch.Tensor  # 1/diag(A), 0 on land
    red: torch.Tensor       # red checkerboard * mask
    black: torch.Tensor
    dx: float
    dy: float
    rdx2: float             # 1/dx^2, as the sweeps and kernels take it
    rdy2: float


def _coarsen2(a):
    """4-cell block average (ny, nx) -> (ny/2, nx/2), for the masks."""
    ny, nx = a.shape
    return a.reshape(ny // 2, 2, nx // 2, 2).mean(dim=(1, 3))


def _prolong_1d(c, axis):
    """Cell-centred linear interpolation along `axis` (n -> 2n):
    f[2j] = 3/4 c[j] + 1/4 c[j-1],  f[2j+1] = 3/4 c[j] + 1/4 c[j+1]
    (periodic wrap; the caller masks land)."""
    even = 0.75 * c + 0.25 * torch.roll(c, 1, axis)
    odd = 0.75 * c + 0.25 * torch.roll(c, -1, axis)
    st = torch.stack([even, odd], dim=axis + 1 if axis >= 0
                     else c.dim() + axis + 1)
    shape = list(c.shape)
    shape[axis] *= 2
    return st.reshape(shape)


def _prolong2(a):
    """Cell-centred bilinear prolongation (ny, nx) -> (2ny, 2nx)."""
    return _prolong_1d(_prolong_1d(a, -2), -1)


def _restrict_1d(g, axis):
    """Adjoint of _prolong_1d scaled to an average (2n -> n):
    r[j] = (3/4 (g[2j] + g[2j+1]) + 1/4 g[2j-1] + 1/4 g[2j+2]) / 2."""
    g = torch.movedim(g, axis, -1)
    even = g[..., 0::2]
    odd = g[..., 1::2]
    r = 0.5 * (0.75 * (even + odd) + 0.25 * torch.roll(odd, 1, -1)
               + 0.25 * torch.roll(even, -1, -1))
    return torch.movedim(r, -1, axis)


def _restrict2(a):
    """Full-weighting restriction (2ny, 2nx) -> (ny, nx)."""
    return _restrict_1d(_restrict_1d(a, -2), -1)


def _checkerboard(shape, dtype, device):
    j = torch.arange(shape[-2], device=device)[:, None]
    i = torch.arange(shape[-1], device=device)[None, :]
    return (((i + j) % 2) == 0).to(dtype)


def _make_level(Hu, Hv, mask, dx: float, dy: float, lam, Hu_w=None,
                Hv_s=None, red=None, gsum=torch.sum) -> Level:
    """A level from its face transmissibilities (Hu at east faces, Hv at
    north faces) and its cell mask.  Hu_w / Hv_s (the west and south faces
    at the cell) default to the periodic local shift; the distributed path
    passes exchanged values, the global colouring as `red` and the mesh
    sum as `gsum`."""
    if Hu_w is None:
        Hu_w = ops.sxm(Hu)
    if Hv_s is None:
        Hv_s = ops.sym(Hv)
    rdx2, rdy2 = 1.0 / dx ** 2, 1.0 / dy ** 2
    diag = -((Hu + Hu_w) * rdx2 + (Hv + Hv_s) * rdy2) - lam
    inv_diag = torch.where(diag != 0,
                           1.0 / torch.where(diag == 0, 1.0, diag),
                           0.0) * mask
    if red is None:
        red = _checkerboard(mask.shape, mask.dtype, mask.device) * mask
    return Level(nwet=torch.clamp_min(gsum(mask), 1.0), mask=mask,
                 Hu=Hu, Hv=Hv, Hu_w=Hu_w, Hv_s=Hv_s, inv_diag=inv_diag,
                 red=red, black=(1.0 - red) * mask, dx=float(dx),
                 dy=float(dy), rdx2=float(rdx2), rdy2=float(rdy2))


def _coarsen_faces(Hu, Hv):
    """FV face coarsening: a coarse face's transmissibility is the mean
    of the two fine faces it covers, so a wall stays a wall."""
    Hu_c = 0.5 * (Hu[0::2, 1::2] + Hu[1::2, 1::2])
    Hv_c = 0.5 * (Hv[1::2, 0::2] + Hv[1::2, 1::2])
    return Hu_c, Hv_c


def build_levels(grid: Grid, cfg: Config, lam=0.0, min_size: int = 16,
                 blocks=(1, 1)):
    """Level 0 = the model grid; each next level halves (ny, nx) while the
    extents of the blocks = (by, bx) blocks the grid is cut into stay even
    and their halves at least min_size (the whole grid by default; a
    mesh's shape in mesh_levels)."""
    mask_u = grid.mask * ops.sxp(grid.mask)
    mask_v = grid.mask * ops.syp(grid.mask)
    Hu = mask_u * ops.a_xp(grid.H)
    Hv = mask_v * ops.a_yp(grid.H)
    mask = grid.mask
    dx, dy = cfg.dx, cfg.dy
    levels = [_make_level(Hu, Hv, mask, dx, dy, lam)]
    for _ in level_shapes(mask.shape, min_size, blocks)[1:]:
        Hu, Hv = _coarsen_faces(Hu, Hv)
        mask = (_coarsen2(mask) > 0).to(mask.dtype)
        dx, dy = 2.0 * dx, 2.0 * dy
        levels.append(_make_level(Hu, Hv, mask, dx, dy, lam))
    return levels


def level_shapes(shape, min_size: int = 16, blocks=(1, 1)) -> list:
    """The (ny, nx) of build_levels' levels of a grid of `shape`: halved
    while the extents of its blocks stay even and their halves at least
    min_size."""
    (ny, nx), (by, bx) = shape, blocks
    out = [(ny, nx)]
    ly, lx = ny // by, nx // bx
    while (ly % 2 == 0 and lx % 2 == 0
           and ly // 2 >= min_size and lx // 2 >= min_size):
        ny, nx, ly, lx = ny // 2, nx // 2, ly // 2, lx // 2
        out.append((ny, nx))
    return out


def mesh_levels(grid: Grid, cfg: Config, lam, mesh_shape,
                min_local: int = 8):
    """build_dist_levels' hierarchy on a mesh of mesh_shape = (NY, NX)
    shards, in the global layout.  Each of its levels is the gathered
    level of the mesh: a shard's block of even extent starts on an even
    row and column, so its face coarsening (the fine pairs (2j, 2j + 1))
    and mask coarsening are the whole grid's; its exchanged west and south
    faces, its global checkerboard and its mesh sum of the mask are the
    whole grid's periodic shifts, checkerboard and sum; and it stops where
    build_dist_levels does, at min_local cells per block side."""
    return build_levels(grid, cfg, lam, min_size=min_local,
                        blocks=tuple(mesh_shape))


def operator(p, Hu, Hu_w, Hv, Hv_s, mask, rdx2: float, rdy2: float, lam):
    """A p with 1/dx^2 factors, masked: the op order every multigrid
    kernel mirrors."""
    out = (Hu * ops.sxp(p) + Hu_w * ops.sxm(p) - (Hu + Hu_w) * p) * rdx2 \
        + (Hv * ops.syp(p) + Hv_s * ops.sym(p) - (Hv + Hv_s) * p) * rdy2
    if lam != 0.0:
        out = out - lam * p
    return out * mask


def _id_pad(a, w):
    """The single-device 'exchange': periodic rolls already wrap, so the
    pad is the identity (and the crop is not called)."""
    return a


def _nbr_shifts(p, pad, crop):
    """(east, west, north, south) neighbour values of p under the exchange
    hooks: local rolls when pad is the identity, a 1-halo exchange under a
    mesh."""
    if pad is _id_pad:
        return ops.sxp(p), ops.sxm(p), ops.syp(p), ops.sym(p)
    pp = pad(p, 1)
    return (crop(ops.sxp(pp), 1), crop(ops.sxm(pp), 1),
            crop(ops.syp(pp), 1), crop(ops.sym(pp), 1))


def _apply_A(lv: Level, p, lam, pad=_id_pad, crop=None, nbr=None):
    """A p.  nbr(lv, p) -> the off-diagonal neighbour sum overrides the
    pad / crop exchange (the distributed path passes the halo-pipelined
    form, parallel/dist._make_mg_nbr)."""
    if nbr is not None:
        out = nbr(lv, p) - ((lv.Hu + lv.Hu_w) * lv.rdx2
                            + (lv.Hv + lv.Hv_s) * lv.rdy2) * p
        if lam != 0.0:
            out = out - lam * p
        return out * lv.mask
    if pad is _id_pad:
        return operator(p, lv.Hu, lv.Hu_w, lv.Hv, lv.Hv_s, lv.mask, lv.rdx2,
                        lv.rdy2, lam)
    e, w, n_, s_ = _nbr_shifts(p, pad, crop)
    out = (lv.Hu * e + lv.Hu_w * w - (lv.Hu + lv.Hu_w) * p) * lv.rdx2 \
        + (lv.Hv * n_ + lv.Hv_s * s_ - (lv.Hv + lv.Hv_s) * p) * lv.rdy2
    if lam != 0.0:
        out = out - lam * p
    return out * lv.mask


def _halfsweep(lv: Level, x, b, colour, pad=_id_pad, crop=None, nbr=None):
    if nbr is None:
        e, w, n_, s_ = _nbr_shifts(x, pad, crop)
        nb = (lv.Hu * e + lv.Hu_w * w) * lv.rdx2 \
            + (lv.Hv * n_ + lv.Hv_s * s_) * lv.rdy2
    else:
        nb = nbr(lv, x)
    x_gs = (b - nb) * lv.inv_diag
    return torch.where(colour > 0, x_gs, x) * lv.mask


def _restrict2_h(a, pad=_id_pad, crop=None):
    """Hooked restriction: a width-2 exchange lets the full-weighting
    stencil see the neighbour shards' edge values; the coarse result is
    cropped back to the local block."""
    if pad is _id_pad:
        return _restrict2(a)
    return crop(_restrict2(pad(a, 2)), 1)


def _prolong2_h(a, pad=_id_pad, crop=None):
    if pad is _id_pad:
        return _prolong2(a)
    return crop(_prolong2(pad(a, 1)), 2)


def _gamma_at(gamma, k: int) -> int:
    """gamma_k: an int is uniform, a tuple a per-transition schedule."""
    return gamma if isinstance(gamma, int) else gamma[min(k, len(gamma) - 1)]


def _vcycle(levels, k, b, lam, nu, nu_coarse, demean=True, gamma=1,
            smooth=None, coarse=None, krylov=0, pad=_id_pad, crop=None,
            gsum=torch.sum, nbr=None):
    """One cycle on levels[k:] from x0 = 0; returns the correction.

    gamma: recursions from level k to k+1, an int (1 = V, 2 = W) or a
    per-transition tuple.  smooth: optional per-level list of None or a
    (forward, reverse) pair of one-launch smoothers sweep(x, b), the
    forward one returning (x, b - A x).  coarse: optional (j0, call): at
    level j0 the whole remaining cycle is call(b) -> x.  krylov > 0: the
    K-cycle, the coarse problem solved by `krylov` flexible-CG iterations
    preconditioned by the recursive cycle (nonlinear: for the standalone
    solver only).  pad / crop / gsum / nbr: the exchange hooks of the
    distributed cycle."""
    hooks = (pad, crop, nbr)
    lv = levels[k]
    if coarse is not None and k == coarse[0]:
        return coarse[1](b)
    x = torch.zeros_like(b)
    if k == len(levels) - 1:
        # half forward, half reversed: the inexact coarse solve is itself
        # symmetric, so the whole cycle is
        nf = nu_coarse // 2
        for _ in range(nf):
            x = _halfsweep(lv, x, b, lv.red, *hooks)
            x = _halfsweep(lv, x, b, lv.black, *hooks)
        for _ in range(nu_coarse - nf):
            x = _halfsweep(lv, x, b, lv.black, *hooks)
            x = _halfsweep(lv, x, b, lv.red, *hooks)
        return x
    sm = None if smooth is None else smooth[k]
    if sm is not None:
        x, r = sm[0](x, b)
    else:
        for _ in range(nu):
            x = _halfsweep(lv, x, b, lv.red, *hooks)
            x = _halfsweep(lv, x, b, lv.black, *hooks)
        r = (b - _apply_A(lv, x, lam, *hooks)) * lv.mask
    lc = levels[k + 1]
    bc = _restrict2_h(r, pad, crop) * lc.mask
    if lam == 0.0 and demean:
        # keep the coarse pure-Neumann problem compatible
        bc = (bc - lc.mask * (gsum(bc) / lc.nwet)) * lc.mask

    def subcycle(rhs):
        return _vcycle(levels, k + 1, rhs, lam, nu, nu_coarse, demean,
                       gamma, smooth, coarse, krylov, pad, crop, gsum, nbr)

    if krylov > 0 and (coarse is None or k + 1 < coarse[0]):
        eps = torch.finfo(bc.dtype).tiny

        def sdiv(a, d):
            mag = torch.clamp_min(d.abs(), eps)
            return a / torch.where(d < 0, -mag, mag)

        z = subcycle(bc)
        p, xc, rc = z, torch.zeros_like(bc), bc
        rz = gsum(rc * z)
        for i in range(krylov):
            q = _apply_A(lc, p, lam, *hooks)
            alpha = sdiv(rz, gsum(p * q))
            xc = xc + alpha * p
            rc = (rc - alpha * q) * lc.mask
            if i < krylov - 1:
                z = subcycle(rc)
                rz2 = gsum(rc * z)
                p = z + sdiv(rz2, rz) * p
                rz = rz2
    else:
        xc = subcycle(bc)
        for _ in range(_gamma_at(gamma, k) - 1):
            rc = (bc - _apply_A(lc, xc, lam, *hooks)) * lc.mask
            xc = xc + subcycle(rc)
    if lam == 0.0 and demean:
        xc = (xc - lc.mask * (gsum(xc) / lc.nwet)) * lc.mask
    x = (x + _prolong2_h(xc, pad, crop)) * lv.mask
    if sm is not None:
        x = sm[1](x, b)
    else:
        for _ in range(nu):
            x = _halfsweep(lv, x, b, lv.black, *hooks)
            x = _halfsweep(lv, x, b, lv.red, *hooks)
    return x


def fused_gamma_schedule(levels, gamma):
    """Uniform gamma = 2 as the fused tier runs it: W at every transition
    but the deepest two, V there.  Other gammas pass through."""
    nt = len(levels) - 1
    if gamma != 2 or nt <= 0:
        return gamma
    return tuple(2 if k < nt - 2 else 1 for k in range(nt))


def make_fused_smoothers(levels, nu: int, lam, min_ny: int = 256,
                         stop: Optional[int] = None):
    """Per-level (forward with residual, reverse) blocked-sweep kernels
    (K4a, k = nu, omega = 1) for the levels with ny >= min_ny above
    `stop`; None elsewhere (half-sweeps op by op)."""
    from beom_tpu_torch.stencils.redblack import make_level_sweep

    stop = len(levels) if stop is None else stop
    out = []
    for j, lv in enumerate(levels):
        if j == len(levels) - 1 or j >= stop or lv.mask.shape[0] < min_ny:
            out.append(None)
            continue
        kw = dict(lam=lam, k=nu, omega=1.0)
        Hu, Hv = lv.Hu.contiguous(), lv.Hv.contiguous()
        out.append((make_level_sweep(Hu, Hv, lv.mask, lv.dx, lv.dy,
                                     residual=True, **kw),
                    make_level_sweep(Hu, Hv, lv.mask, lv.dx, lv.dy,
                                     reverse=True, **kw)))
    return out


def make_fused_coarse(levels, lam, nu: int, nu_coarse: int, demean: bool,
                      coarse_size: int = 512, gamma=2):
    """(j0, call): levels[j0:], from the first level with
    max(ny, nx) <= coarse_size, delegated to one coarse-stack kernel (K5)
    per visit; None when no level qualifies."""
    from beom_tpu_torch.stencils.mg_coarse import make_coarse_stack_call

    for j0, lv in enumerate(levels):
        ny, nx = lv.mask.shape
        if max(ny, nx) <= coarse_size and ny % 2 == 0 and nx % 2 == 0:
            # the tail of the schedule, re-indexed from the kernel's top
            g_k = gamma[j0:] if isinstance(gamma, tuple) else gamma
            if isinstance(g_k, tuple) and not g_k:
                g_k = 1
            return (j0, make_coarse_stack_call(
                levels[j0:], lam, nu=nu, nu_coarse=nu_coarse, gamma=g_k,
                demean=demean))
        if ny % 2 or nx % 2:
            break
    return None


def cycle_precond(levels, lam, nu: int = 2, nu_coarse: int = 24, gamma=2,
                  smooth=None, coarse=None):
    """z = M^{-1} r: one cycle without de-meaning (CG deflates)."""
    mask0 = levels[0].mask

    def apply(r):
        return _vcycle(levels, 0, r * mask0, lam, nu, nu_coarse,
                       demean=False, gamma=gamma, smooth=smooth,
                       coarse=coarse)

    return apply


def make_mg_precond(grid: Grid, cfg: Config, lam=0.0, nu: int = 2,
                    nu_coarse: int = 24, min_size: int = 16, gamma=2,
                    smoother: str = "eager", coarse_size: int = 512):
    """z = M^{-1} r as one symmetric (nu, nu)-cycle, for cg_solve.
    smoother='fused' runs the fused gamma schedule through K4a and K5."""
    levels = build_levels(grid, cfg, lam, min_size=min_size)
    smooth = coarse = None
    if smoother == "fused":
        gamma = fused_gamma_schedule(levels, gamma)
        coarse = make_fused_coarse(levels, lam, nu, nu_coarse, demean=False,
                                   gamma=gamma, coarse_size=coarse_size)
        smooth = make_fused_smoothers(levels, nu, lam,
                                      stop=coarse[0] if coarse else None)
    elif smoother != "eager":
        raise ValueError(f"unknown smoother {smoother!r}")
    return cycle_precond(levels, lam, nu, nu_coarse, gamma, smooth, coarse)


def build_dist_levels(grid_p1: Grid, cfg: Config, lam, pad, crop, gsum,
                      red_fn, min_local: int = 8):
    """The shard-local hierarchy of the distributed cycle.  grid_p1: the
    1-halo padded static Grid of the local blocks (parallel/dist.py).
    Face coarsening is block-local (local extents stay even), so every
    level stays distributed over the same mesh; coarsening stops at
    `min_local` cells per shard side and the coarsest level is smoothed
    with exchanges like any other.

    pad(a, w) / crop(a, w): the mesh halo exchange; gsum: the mesh sum;
    red_fn(shape, dtype): the global checkerboard on local blocks of that
    shape."""
    mask_p = grid_p1.mask
    Hu_p = mask_p * ops.sxp(mask_p) * ops.a_xp(grid_p1.H)
    Hv_p = mask_p * ops.syp(mask_p) * ops.a_yp(grid_p1.H)
    Hu, Hv = crop(Hu_p, 1), crop(Hv_p, 1)
    Hu_w, Hv_s = crop(ops.sxm(Hu_p), 1), crop(ops.sym(Hv_p), 1)
    mask = crop(mask_p, 1)
    dx, dy = cfg.dx, cfg.dy

    def level():
        return _make_level(Hu, Hv, mask, dx, dy, lam, Hu_w=Hu_w, Hv_s=Hv_s,
                           red=red_fn(mask.shape, mask.dtype) * mask,
                           gsum=gsum)

    levels = [level()]
    ny_l, nx_l = mask.shape
    while (ny_l % 2 == 0 and nx_l % 2 == 0
           and ny_l // 2 >= min_local and nx_l // 2 >= min_local):
        Hu, Hv = _coarsen_faces(Hu, Hv)
        Hu_w = crop(ops.sxm(pad(Hu, 1)), 1)
        Hv_s = crop(ops.sym(pad(Hv, 1)), 1)
        mask = (_coarsen2(mask) > 0).to(mask.dtype)
        dx, dy = 2.0 * dx, 2.0 * dy
        ny_l, nx_l = ny_l // 2, nx_l // 2
        levels.append(level())
    return levels


def make_dist_mg_precond(grid_p1: Grid, cfg: Config, lam, pad, crop, gsum,
                         red_fn, nu: int = 2, nu_coarse: int = 24,
                         min_local: int = 8, gamma: int = 2, nbr=None):
    """Distributed z = M^{-1} r: the (nu, nu)-cycle (W by default).  With
    `nbr` (parallel/dist._make_mg_nbr) the half-sweeps and the operator
    use the halo-pipelined neighbour sum, thin-slice edge exchanges,
    instead of a 1-halo pad per sweep; the transfers keep the width-2 / 1
    exchanges, once per level visit.  The cycle runs without the de-mean:
    CG's own deflation keeps the level-0 problem compatible, and dropping
    the per-level means keeps the iteration at one mesh reduction."""
    levels = build_dist_levels(grid_p1, cfg, lam, pad, crop, gsum, red_fn,
                               min_local=min_local)

    def apply(r):
        return _vcycle(levels, 0, r * levels[0].mask, lam, nu, nu_coarse,
                       demean=False, gamma=gamma, pad=pad, crop=crop,
                       gsum=gsum, nbr=nbr)

    return apply


def track_best(rr2: float, best: float, ref: float, since: int):
    """One cycle of the solver's stopping bookkeeping: (is a new best,
    best |r|^2, the |r|^2 patience is measured from, cycles since a 25 %
    gain).  Any improvement is a new best; only a 25 % gain on `ref`
    resets the patience."""
    better = rr2 < best
    if rr2 < 0.75 * ref:
        return better, min(rr2, best), rr2, 0
    return better, min(rr2, best), ref, since + 1


def make_mg_solver(grid: Grid, cfg: Config, lam=0.0,
                   tol: Optional[float] = None,
                   maxiter: Optional[int] = None, nu: int = 2,
                   nu_coarse: int = 24, gamma=2, min_size: int = 16,
                   smoother: str = "eager", coarse_size: int = 512,
                   krylov: int = 2):
    """Standalone multigrid iteration x_{k+1} = x_k + C(b - A x_k), C one
    (nu, nu) K-cycle.  Returns solve(b, x0=None) -> x.  The residual after
    each correction is carried: it is both the convergence check (one
    host read per cycle) and the next cycle's input.  Stops on the
    tolerance, maxiter, or PATIENCE cycles without a 25 % gain, and
    returns the best iterate.  smoother='fused' adds K4a, K5 and, at
    ny >= 256, K4b for the outer residual."""
    levels = build_levels(grid, cfg, lam, min_size=min_size)
    smooth = coarse = None
    lv0 = levels[0]
    if smoother == "fused":
        gamma = fused_gamma_schedule(levels, gamma)
        coarse = make_fused_coarse(levels, lam, nu, nu_coarse, demean=True,
                                   gamma=gamma, coarse_size=coarse_size)
        smooth = make_fused_smoothers(levels, nu, lam,
                                      stop=coarse[0] if coarse else None)
    elif smoother != "eager":
        raise ValueError(f"unknown smoother {smoother!r}")
    if smoother == "fused" and len(levels) > 1 and lv0.mask.shape[0] >= 256:
        from beom_tpu_torch.stencils.redblack import make_apply_kernel
        resid0 = make_apply_kernel(lv0.Hu.contiguous(), lv0.Hv.contiguous(),
                                   lv0.mask, lv0.dx, lv0.dy, lam=lam,
                                   mode="residual")
    else:
        def resid0(x, b):
            return (b - _apply_A(lv0, x, lam)) * lv0.mask
    tol0 = cfg.solver_tol if tol is None else tol
    maxiter = cfg.solver_maxiter if maxiter is None else maxiter

    def solve(b, x0=None):
        global CYCLES
        tol_ = max(tol0, 30.0 * float(torch.finfo(b.dtype).eps))
        mask = lv0.mask
        b = b * mask
        if lam == 0.0:      # pure Neumann: de-mean the right-hand side
            b = (b - mask * (torch.sum(b) / lv0.nwet)) * mask
        x = torch.zeros_like(b) if x0 is None else x0 * mask
        threshold = (tol_ * tol_) * max(float(torch.sum(b * b)),
                                        float(torch.finfo(b.dtype).tiny))
        r = resid0(x, b)
        rr = float(torch.sum(r * r))
        best_x, best, ref, since = x, rr, rr, 0
        for _ in range(maxiter):
            if not (rr > threshold and since < PATIENCE):
                break
            x = (x + _vcycle(levels, 0, r, lam, nu, nu_coarse, gamma=gamma,
                             smooth=smooth, coarse=coarse,
                             krylov=krylov)) * mask
            r = resid0(x, b)
            rr = float(torch.sum(r * r))            # the cycle's host read
            CYCLES += 1
            better, best, ref, since = track_best(rr, best, ref, since)
            if better:
                best_x = x
        return best_x

    return solve


def mg_solve(b, grid: Grid, cfg: Config, lam=0.0, x0=None,
             tol: Optional[float] = None, maxiter: Optional[int] = None,
             nu: int = 2, nu_coarse: int = 24, gamma=2,
             smoother: str = "eager", krylov: int = 2):
    """One-shot convenience wrapper over make_mg_solver (cfg.solver =
    'mg', stepping/projection._solve)."""
    return make_mg_solver(grid, cfg, lam=lam, tol=tol, maxiter=maxiter,
                          nu=nu, nu_coarse=nu_coarse, gamma=gamma,
                          smoother=smoother, krylov=krylov)(b, x0=x0)
