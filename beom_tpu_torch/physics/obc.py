"""Open boundaries: tides, Flather radiation, sponge nudging: the port's
twin of beom_tpu/physics/obc.py.

  * Tidal elevation eta_ext(t) = sum_c amp_c cos(w_c t - phi_c).
  * Flather radiation on flagged open faces sets the barotropic normal
    velocity to n sqrt(g/H) (eta - eta_ext); layer velocities shift by a
    common barotropic increment.
  * Sponge: Newtonian relaxation of h toward h_ext and of u, v toward
    rest at rate Forcing.sponge [1/s].
"""

from __future__ import annotations

import torch

from beom_tpu_torch.core import ops
from beom_tpu_torch.core.config import Config
from beom_tpu_torch.core.grid import Grid, Forcing


def eta_ext(t, forcing: Forcing, cfg: Config, dtype):
    """External (tidal) elevation map at time t, (ny, nx)."""
    device = forcing.tide_amp.device
    out = torch.zeros(forcing.tide_amp.shape[1:], dtype=dtype, device=device)
    # t as a 0-d tensor of the field dtype: omega * t rounds as the
    # reference's weak-typed product does
    t = torch.tensor(float(t), dtype=dtype, device=device)
    for c, omega in enumerate(cfg.tides):
        out = out + forcing.tide_amp[c] * torch.cos(
            omega * t - forcing.tide_phase[c])
    return out


def sponge_rhs(h, u, v, forcing: Forcing, cfg: Config):
    """(dh, du, dv) Newtonian nudging tendencies (zeros if disabled)."""
    if not cfg.sponge:
        z = torch.zeros_like(h)
        return z, z, z
    g = forcing.sponge
    dh = g * (forcing.h_ext - h)
    du = -ops.a_xp(g) * u
    dv = -ops.a_yp(g) * v
    return dh, du, dv


def apply_flather(h, u, v, grid: Grid, forcing: Forcing, cfg: Config, t):
    """Post-step barotropic Flather correction on open faces."""
    if not cfg.obc:
        return u, v
    eta = ops.sum_k(h) - grid.H
    e_ext = eta_ext(t, forcing, cfg, h.dtype)
    hsum = torch.clamp_min(ops.sum_k(h), cfg.h_min)

    # barotropic (thickness-weighted) velocities at faces
    hu = torch.clamp_min(ops.a_xp(h), cfg.h_min)
    hv = torch.clamp_min(ops.a_yp(h), cfg.h_min)
    ubar = ops.sum_k(hu * u) / ops.sum_k(hu)
    vbar = ops.sum_k(hv * v) / ops.sum_k(hv)

    Hu = torch.clamp_min(ops.a_xp(hsum), cfg.h_min)
    Hv = torch.clamp_min(ops.a_yp(hsum), cfg.h_min)
    cu = torch.sqrt(cfg.g / Hu)
    cv = torch.sqrt(cfg.g / Hv)

    # interior eta seen from the face: the wet-side value
    eta_u = ops.a_xp(eta * grid.mask) * 2.0 / torch.clamp_min(
        grid.mask + ops.sxp(grid.mask), 1.0)
    eta_v = ops.a_yp(eta * grid.mask) * 2.0 / torch.clamp_min(
        grid.mask + ops.syp(grid.mask), 1.0)
    eext_u = ops.a_xp(e_ext)
    eext_v = ops.a_yp(e_ext)

    u_tgt = forcing.obc_u * cu * (eta_u - eext_u)
    v_tgt = forcing.obc_v * cv * (eta_v - eext_v)

    on_u = torch.abs(forcing.obc_u)
    on_v = torch.abs(forcing.obc_v)
    u = u + on_u * (u_tgt - ubar)[None]
    v = v + on_v * (v_tgt - vbar)[None]
    return u, v


def apply_clamp(h, grid: Grid, forcing: Forcing, cfg: Config, t):
    """Clamp exterior (obc_h) cells to h_ext, tidal elevation in layer 1."""
    if not cfg.obc:
        return h
    e = eta_ext(t, forcing, cfg, h.dtype)
    tgt = forcing.h_ext.clone()
    tgt[0] = tgt[0] + e
    return torch.where(forcing.obc_h[None] > 0, tgt, h)
