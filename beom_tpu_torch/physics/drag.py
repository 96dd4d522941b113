"""Bottom / interfacial drag and wind stress: the port's twin of
beom_tpu/physics/drag.py.

Bottom drag -(r + c_d |u|) u / h acts on the deepest layer and is applied
implicitly by the stepper, u <- u / (1 + dt c); this module returns the
coefficients c [1/s].  Wind stress tau / (rho0 h_1) on the top layer and
interfacial drag are explicit tendencies.
"""

from __future__ import annotations

import torch

from beom_tpu_torch.core import ops
from beom_tpu_torch.core.config import Config
from beom_tpu_torch.core.grid import Grid, Forcing


def _speed_u(u, v):
    """|u| at u points: sqrt(u^2 + avg(v)^2), v 4-point averaged."""
    v4 = ops.a_xp(ops.a_ym(v))
    return torch.sqrt(u * u + v4 * v4)


def _speed_v(u, v):
    u4 = ops.a_yp(ops.a_xm(u))
    return torch.sqrt(v * v + u4 * u4)


def _on_layer(x, k: int, nz: int):
    """(nz, ny, nx) holding the 2-D field x in layer k, zeros elsewhere."""
    if nz == 1:
        return x[None]
    out = torch.zeros((nz,) + x.shape, dtype=x.dtype, device=x.device)
    out[k] = x
    return out


def bottom_drag_coeff(h, u, v, grid: Grid, cfg: Config):
    """(cu, cv) [1/s] per layer; nonzero only in the bottom layer."""
    if cfg.r_bot == 0.0 and cfg.cd_bot == 0.0:
        z = torch.zeros_like(u)
        return z, z
    kb = cfg.nz - 1
    ub, vb = u[kb], v[kb]
    hu = torch.clamp_min(ops.a_xp(h[kb]), cfg.h_min)
    hv = torch.clamp_min(ops.a_yp(h[kb]), cfg.h_min)
    cu_b = (cfg.r_bot + cfg.cd_bot * _speed_u(ub, vb)) / hu
    cv_b = (cfg.r_bot + cfg.cd_bot * _speed_v(ub, vb)) / hv
    return _on_layer(cu_b, kb, cfg.nz), _on_layer(cv_b, kb, cfg.nz)


def wind(h, grid: Grid, forcing: Forcing, cfg: Config):
    """(du, dv) wind-stress tendency on layer 1 only."""
    if not cfg.wind:
        z = torch.zeros_like(h)
        return z, z
    hu = torch.clamp_min(ops.a_xp(h[0]), cfg.h_min)
    hv = torch.clamp_min(ops.a_yp(h[0]), cfg.h_min)
    du0 = grid.mask_u * forcing.taux / (cfg.rho0 * hu)
    dv0 = grid.mask_v * forcing.tauy / (cfg.rho0 * hv)
    return _on_layer(du0, 0, cfg.nz), _on_layer(dv0, 0, cfg.nz)


def interfacial_drag(h, u, v, grid: Grid, cfg: Config):
    """Explicit layer-coupling drag r_int (u_adj - u_k) / h_k."""
    if cfg.r_int == 0.0 or cfg.nz < 2:
        z = torch.zeros_like(u)
        return z, z
    hu = torch.clamp_min(ops.a_xp(h), cfg.h_min)
    hv = torch.clamp_min(ops.a_yp(h), cfg.h_min)

    def couple(w, hw):
        # stress from the layer above (k > 0) and below (k < nz-1)
        zero = torch.zeros_like(w[:1])
        above = torch.cat([zero, w[:-1] - w[1:]], dim=0)
        below = torch.cat([w[1:] - w[:-1], zero], dim=0)
        return cfg.r_int * (above + below) / hw

    return couple(u, hu), couple(v, hv)
