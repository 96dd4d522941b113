"""Diagnostics: the port's twin of beom_tpu/diag/__init__.py.

Every scalar is reduced on the device; `diagnostics` moves them to the
host in one transfer and returns a dict of Python floats:
  mass      total water volume  sum h dx dy           [m^3]
  ke        kinetic energy  0.5 rho0 sum h (u^2+v^2)  [J]
  pe        available potential energy of the interfaces [J]
  max_speed max |u|, |v|                              [m/s]
  cfl       max (|u|/dx + |v|/dy) dt                  [-]
  eta_rms   rms free-surface elevation                [m]
  finite    1.0 iff every prognostic value is finite
"""

from __future__ import annotations

import torch

from beom_tpu_torch.core import ops
from beom_tpu_torch.core.config import Config
from beom_tpu_torch.core.grid import Grid
from beom_tpu_torch.core.state import State


def energies(state: State, grid: Grid, cfg: Config):
    """(ke, pe) volume-integrated, as 0-d device tensors.

    PE uses the layered form 0.5 rho0 sum_k g'_k z_k^2 with z_k the
    interface elevations (g'_1 = g, z_1 = eta).
    """
    h, u, v = state.h, state.u, state.v
    dA = cfg.dx * cfg.dy
    ke = 0.5 * cfg.rho0 * torch.sum(
        h * (ops.a_xm(u * u) + ops.a_ym(v * v))) * dA

    eta = torch.sum(h, dim=0) - grid.H
    below = torch.cumsum(h, dim=0) - h
    z_top = (eta[None] - below) * grid.mask
    gp = torch.tensor(cfg.gprime, dtype=h.dtype,
                      device=h.device)[:, None, None]
    pe = 0.5 * cfg.rho0 * torch.sum(gp * z_top * z_top) * dA
    return ke, pe


def diagnostics(state: State, grid: Grid, cfg: Config) -> dict:
    h, u, v = state.h, state.u, state.v
    ke, pe = energies(state, grid, cfg)
    eta = (torch.sum(h, dim=0) - grid.H) * grid.mask
    nwet = torch.clamp_min(torch.sum(grid.mask), 1.0)
    spd = torch.maximum(torch.max(torch.abs(u)), torch.max(torch.abs(v)))
    cfl = torch.max(torch.abs(u) / cfg.dx + torch.abs(v) / cfg.dy) * cfg.dt
    finite = (torch.isfinite(h).all() & torch.isfinite(u).all()
              & torch.isfinite(v).all()).to(h.dtype)
    names = ("mass", "ke", "pe", "max_speed", "cfl", "eta_rms", "finite")
    vals = torch.stack([
        torch.sum(h) * cfg.dx * cfg.dy, ke, pe, spd, cfl,
        torch.sqrt(torch.sum(eta * eta) / nwet), finite,
    ]).cpu().tolist()          # the one device-to-host transfer
    return {"t": float(state.t), "n": float(state.n),
            **dict(zip(names, vals))}
