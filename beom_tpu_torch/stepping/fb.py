"""Forward-backward time stepping: the port's twin of
beom_tpu/stepping/fb.py.

Order per step (free-surface FB):
  1. h^{n+1} = h^n + dt * [ -div(h u)^n + sponge ]           (forward)
  2. Montgomery M(h^{n+1})                                    (backward PG)
  3. momentum with -grad(M + K), viscosity, wind; the Coriolis/PV cross
     terms alternate their sweep order: on even steps u is updated first
     and v sees the new u, on odd steps the reverse.
  4. bottom drag applied implicitly: u <- u / (1 + dt c).
  5. wet/dry gating, Flather OBC, exterior clamp.

The sweep order is one host branch on n % 2: the step counter lives on
the host (core/state.py).
"""

from __future__ import annotations

import torch

from beom_tpu_torch.core import ops
from beom_tpu_torch.core.config import Config
from beom_tpu_torch.core.grid import Grid, Forcing
from beom_tpu_torch.core.state import State, advance_time
from beom_tpu_torch.physics import continuity, drag, momentum, obc, pressure
from beom_tpu_torch.physics import viscosity as visc
from beom_tpu_torch.physics import wetdry


def _pv_and_fluxes(h, u, v, grid: Grid, cfg: Config):
    """PV (or f) at corners + the mass fluxes entering the cross terms."""
    if cfg.adv_scheme == "linear":
        return grid.f_q[None] * torch.ones_like(h), u, v
    q = momentum.pv_corner(h, u, v, grid, cfg)
    return q, ops.a_xp(h) * u, ops.a_yp(h) * v


def _common_tendencies(h_new, u, v, grid: Grid, forcing: Forcing,
                       cfg: Config, free_surface: bool = True):
    """Momentum tendencies independent of the FB-Coriolis sweep order."""
    M = pressure.montgomery(h_new, grid, cfg, free_surface=free_surface)
    phi = M if cfg.adv_scheme == "linear" else M + momentum.kinetic_energy(u, v)
    du = -ops.d_xp(phi, cfg.dx)
    dv = -ops.d_yp(phi, cfg.dy)

    duv, dvv = visc.viscosity(u, v, grid, cfg)
    duw, dvw = drag.wind(h_new, grid, forcing, cfg)
    dui, dvi = drag.interfacial_drag(h_new, u, v, grid, cfg)
    du = du + duv + duw + dui
    dv = dv + dvv + dvw + dvi
    if cfg.sponge:
        _, dus, dvs = obc.sponge_rhs(h_new, u, v, forcing, cfg)
        du = du + dus
        dv = dv + dvs
    return du, dv


def continuity_update(state: State, grid: Grid, forcing: Forcing,
                      cfg: Config):
    """Step 1 of FB: h^{n+1} from old velocities (+ sponge, OBC clamp)."""
    h, u, v = state.h, state.u, state.v
    dh = continuity.continuity_rhs(h, u, v, grid, cfg)
    if cfg.sponge:
        dhs, _, _ = obc.sponge_rhs(h, u, v, forcing, cfg)
        dh = dh + dhs
    h1 = (h + cfg.dt * dh) * grid.mask
    return obc.apply_clamp(h1, grid, forcing, cfg,
                           advance_time(state.t, cfg.dt, cfg.npdtype))


def momentum_update(h1, state: State, grid: Grid, forcing: Forcing,
                    cfg: Config, free_surface: bool = True):
    """Steps 2-4 of FB: (u1, v1) from new thickness h1.

    Backward pressure M(h1), FB-Coriolis sweeps ordered by the parity of
    state.n, implicit bottom drag.  `free_surface=False` drops the g*eta
    surface-pressure term for the projection steps
    (stepping/projection.py), which supply it through the elliptic solve.
    """
    u, v = state.u, state.v
    dt = cfg.dt
    du_c, dv_c = _common_tendencies(h1, u, v, grid, forcing, cfg,
                                    free_surface=free_surface)
    q, U, V = _pv_and_fluxes(h1, u, v, grid, cfg)
    cu, cv = drag.bottom_drag_coeff(h1, u, v, grid, cfg)

    def upd_u(uu, VV):
        duq = ops.a_ym(q * ops.a_xp(VV))
        u_n = (uu + dt * (du_c + duq)) / (1.0 + dt * cu)
        return u_n * grid.mask_u

    def upd_v(vv, UU):
        dvq = -ops.a_xm(q * ops.a_yp(UU))
        v_n = (vv + dt * (dv_c + dvq)) / (1.0 + dt * cv)
        return v_n * grid.mask_v

    linear = cfg.adv_scheme == "linear"
    if state.n % 2 == 0:
        u1 = upd_u(u, V)
        v1 = upd_v(v, u1 if linear else ops.a_xp(h1) * u1)
    else:
        v1 = upd_v(v, U)
        u1 = upd_u(u, v1 if linear else ops.a_yp(h1) * v1)
    return u1, v1


def finalize(h1, u1, v1, state: State, grid: Grid, forcing: Forcing,
             cfg: Config) -> State:
    """Step 5 of FB: wet/dry gating + Flather OBC, then the new State."""
    t1 = advance_time(state.t, cfg.dt, cfg.npdtype)
    if cfg.wetdry:
        wet = wetdry.wet_mask(h1, grid, cfg)
        u1 = wetdry.gate_u(u1, wet, grid)
        v1 = wetdry.gate_v(v1, wet, grid)
    u1, v1 = obc.apply_flather(h1, u1, v1, grid, forcing, cfg, t1)
    return State(h=h1, u=u1, v=v1, t=t1, n=state.n + 1)


def fb_step(state: State, grid: Grid, forcing: Forcing,
            cfg: Config) -> State:
    h1 = continuity_update(state, grid, forcing, cfg)
    u1, v1 = momentum_update(h1, state, grid, forcing, cfg)
    return finalize(h1, u1, v1, state, grid, forcing, cfg)

