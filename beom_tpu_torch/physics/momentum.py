"""Coriolis and nonlinear advection in vector-invariant form: the port's
twin of beom_tpu/physics/momentum.py.

The rotational terms enter through the potential vorticity
q = (f + zeta) / h_q at corners, with the Sadourny (1975) energy-
conserving flux form; the kinetic-energy part of advection enters with
the pressure gradient as -grad(M + K).  `adv_scheme='linear'` drops
zeta, K and the mass weighting (plain C-grid Coriolis f x u).
"""

from __future__ import annotations

import torch

from beom_tpu_torch.core import ops
from beom_tpu_torch.core.config import Config
from beom_tpu_torch.core.grid import Grid


def kinetic_energy(u, v):
    """K at centres: 0.5 (avg_xm(u^2) + avg_ym(v^2))."""
    return 0.5 * (ops.a_xm(u * u) + ops.a_ym(v * v))


def pv_corner(h, u, v, grid: Grid, cfg: Config):
    """Potential vorticity q = (f + zeta)/h at corners, per layer."""
    zeta = ops.d_xp(v, cfg.dx) - ops.d_yp(u, cfg.dy)
    zeta = zeta * grid.mask_q          # free-slip: zeta = 0 at wall corners
    h_q = ops.a_xp(ops.a_yp(h))        # 4-point average to corners
    h_q = torch.clamp_min(h_q, cfg.h_min)
    return (grid.f_q + zeta) / h_q


def coriolis_advection(h, u, v, grid: Grid, cfg: Config):
    """(du, dv) tendencies from rotation + vorticity advection."""
    if cfg.adv_scheme == "linear":
        du = ops.a_ym(grid.f_q * ops.a_xp(v))
        dv = -ops.a_xm(grid.f_q * ops.a_yp(u))
        return du, dv

    q = pv_corner(h, u, v, grid, cfg)
    U = ops.a_xp(h) * u
    V = ops.a_yp(h) * v
    du = ops.a_ym(q * ops.a_xp(V))     # Sadourny energy-conserving
    dv = -ops.a_xm(q * ops.a_yp(U))
    return du, dv
