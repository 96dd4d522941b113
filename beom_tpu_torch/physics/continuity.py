"""Layer continuity dh/dt = -div(h u), with the wet/dry flux limiter:
the port's twin of beom_tpu/physics/continuity.py.

Face thickness is the centred average in open water and first-order
upwind where either neighbour is thin.  The limiter rescales each cell's
outgoing fluxes so one forward step cannot take h below cfg.h_min; only
fluxes are scaled, so mass is conserved to round-off.
"""

from __future__ import annotations

import torch

from beom_tpu_torch.core import ops
from beom_tpu_torch.core.config import Config
from beom_tpu_torch.core.grid import Grid


def mass_fluxes(h, u, v, grid: Grid, cfg: Config):
    """Face mass fluxes (Fx at u points, Fy at v points), per layer."""
    hx = ops.a_xp(h)
    hy = ops.a_yp(h)
    if cfg.wetdry:
        thin = 2.0 * cfg.h_dry
        hx_up = torch.where(u > 0, h, ops.sxp(h))
        hy_up = torch.where(v > 0, h, ops.syp(h))
        hx = torch.where(torch.minimum(h, ops.sxp(h)) < thin, hx_up, hx)
        hy = torch.where(torch.minimum(h, ops.syp(h)) < thin, hy_up, hy)
        hx = torch.clamp_min(hx, 0.0)
        hy = torch.clamp_min(hy, 0.0)
    Fx = grid.mask_u * hx * u
    Fy = grid.mask_v * hy * v

    if cfg.wetdry:
        # outflow rate [m/s of thickness] each cell would lose this step
        out = (torch.clamp_min(Fx, 0.0)
               + torch.clamp_min(-ops.sxm(Fx), 0.0)) / cfg.dx \
            + (torch.clamp_min(Fy, 0.0)
               + torch.clamp_min(-ops.sym(Fy), 0.0)) / cfg.dy
        avail = torch.clamp_min(h - cfg.h_min, 0.0)
        need = out * cfg.dt
        scale = torch.where(need > avail,
                            avail / torch.clamp_min(need, 1e-30), 1.0)
        # each flux is scaled by its donor cell's factor
        Fx = Fx * torch.where(Fx > 0, scale, ops.sxp(scale))
        Fy = Fy * torch.where(Fy > 0, scale, ops.syp(scale))
    return Fx, Fy


def continuity_rhs(h, u, v, grid: Grid, cfg: Config):
    """dh/dt = -(dFx/dx + dFy/dy) at centres, per layer (nz, ny, nx)."""
    Fx, Fy = mass_fluxes(h, u, v, grid, cfg)
    return -(ops.d_xm(Fx, cfg.dx) + ops.d_ym(Fy, cfg.dy)) * grid.mask
