"""Laplacian and biharmonic lateral viscosity: the port's twin of
beom_tpu/physics/viscosity.py.

Mask-aware stress form: lap(u) = d/dx(du/dx at centres) + d/dy(du/dy at
corners).  slip='free' zeroes the cross-wall shear at corners through
mask_q; slip='no' keeps the zero land velocities in the shear stencil.
"""

from __future__ import annotations

from beom_tpu_torch.core import ops
from beom_tpu_torch.core.config import Config
from beom_tpu_torch.core.grid import Grid


def lap_u(u, grid: Grid, cfg: Config):
    """Masked Laplacian of a u-point field (per layer)."""
    gx = ops.d_xm(u, cfg.dx) * grid.mask        # at centres
    gy = ops.d_yp(u, cfg.dy)                    # at corners
    if cfg.slip == "free":
        gy = gy * grid.mask_q
    return (ops.d_xp(gx, cfg.dx) + ops.d_ym(gy, cfg.dy)) * grid.mask_u


def lap_v(v, grid: Grid, cfg: Config):
    gy = ops.d_ym(v, cfg.dy) * grid.mask        # at centres
    gx = ops.d_xp(v, cfg.dx)                    # at corners
    if cfg.slip == "free":
        gx = gx * grid.mask_q
    return (ops.d_yp(gy, cfg.dy) + ops.d_xm(gx, cfg.dx)) * grid.mask_v


def viscosity(u, v, grid: Grid, cfg: Config):
    """(du, dv) from nu2 * lap - nu4 * lap(lap)."""
    du = 0.0
    dv = 0.0
    if cfg.nu2 != 0.0:
        du = du + cfg.nu2 * lap_u(u, grid, cfg)
        dv = dv + cfg.nu2 * lap_v(v, grid, cfg)
    if cfg.nu4 != 0.0:
        du = du - cfg.nu4 * lap_u(lap_u(u, grid, cfg), grid, cfg)
        dv = dv - cfg.nu4 * lap_v(lap_v(v, grid, cfg), grid, cfg)
    return du, dv
