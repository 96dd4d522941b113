"""Split barotropic / baroclinic stepping: the port's twin of
beom_tpu/stepping/split.py.

The fast external gravity wave is integrated by an inner forward-backward
subcycle on the barotropic variables (eta, ubar, vbar) with the short step
dt_e = dt / nsub, while the slow dynamics advance with the long dt:

  1. slow tendencies G_k = the momentum right-hand side at time n with the
     surface-pressure term -g grad(eta) excluded;
  2. depth-mean Gbar (thickness-weighted) and shear part G'_k = G_k - Gbar;
  3. nsub FB substeps: eta <- eta - dt_e div(H_face ubar), then
     ubar <- ubar + dt_e (-g grad eta_new + Gbar), accumulating the
     subcycle-mean barotropic velocity;
  4. layer velocities recomposed, u_k = (u'_k + dt G'_k) + ubar_final,
     with the implicit bottom drag division at the end;
  5. layer continuity advects h with u'_k + <ubar>, and a final rescale
     pins sum_k h_k to H + eta.

`slow_phase` and `subcycle_phase` are separate so that a distributed
stepper can run the slow phase on a padded block and the subcycle with one
1-halo exchange per substep (the `pad1` / `crop1` hooks).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from beom_tpu_torch.core import ops
from beom_tpu_torch.core.config import Config
from beom_tpu_torch.core.grid import Grid, Forcing
from beom_tpu_torch.core.state import State
from beom_tpu_torch.physics import continuity, drag
from beom_tpu_torch.stepping import fb


class SlowPhase(NamedTuple):
    """Everything the subcycle + recompose needs, at time n."""
    up: torch.Tensor        # (nz, ny, nx) shear velocities
    vp: torch.Tensor
    du_p: torch.Tensor      # shear tendencies
    dv_p: torch.Tensor
    du_bar: torch.Tensor    # (ny, nx) depth-mean tendencies
    dv_bar: torch.Tensor
    ubar: torch.Tensor      # (ny, nx) barotropic velocities
    vbar: torch.Tensor
    Hu: torch.Tensor        # (ny, nx) face column depths
    Hv: torch.Tensor
    eta0: torch.Tensor      # (ny, nx) free surface
    cu: torch.Tensor        # (nz, ny, nx) implicit drag coefficients
    cv: torch.Tensor


def slow_tendencies(state: State, grid: Grid, forcing: Forcing,
                    cfg: Config):
    """Step 1: the layer momentum tendencies G_k at time n without the
    surface-pressure term, (du_s, dv_s)."""
    h, u, v = state.h, state.u, state.v
    du_c, dv_c = fb._common_tendencies(h, u, v, grid, forcing, cfg,
                                       free_surface=False)
    q, U, V = fb._pv_and_fluxes(h, u, v, grid, cfg)
    return (du_c + ops.a_ym(q * ops.a_xp(V)),
            dv_c - ops.a_xm(q * ops.a_yp(U)))


def depth_means(state: State, du_s, dv_s, grid: Grid,
                cfg: Config) -> SlowPhase:
    """Step 2: SlowPhase from the state and the layer tendencies."""
    h, u, v = state.h, state.u, state.v

    hu = ops.a_xp(h) * grid.mask_u          # face thickness per layer
    hv = ops.a_yp(h) * grid.mask_v
    Hu = torch.clamp_min(ops.sum_k(hu), cfg.h_min)
    Hv = torch.clamp_min(ops.sum_k(hv), cfg.h_min)
    ubar = ops.sum_k(hu * u) / Hu
    vbar = ops.sum_k(hv * v) / Hv

    du_bar = ops.sum_k(hu * du_s) / Hu
    dv_bar = ops.sum_k(hv * dv_s) / Hv

    cu, cv = drag.bottom_drag_coeff(h, u, v, grid, cfg)
    eta0 = (ops.sum_k(h) - grid.H) * grid.mask
    return SlowPhase(up=u - ubar[None], vp=v - vbar[None],
                     du_p=du_s - du_bar[None], dv_p=dv_s - dv_bar[None],
                     du_bar=du_bar, dv_bar=dv_bar, ubar=ubar, vbar=vbar,
                     Hu=Hu, Hv=Hv, eta0=eta0, cu=cu, cv=cv)


def slow_phase(state: State, grid: Grid, forcing: Forcing,
               cfg: Config) -> SlowPhase:
    du_s, dv_s = slow_tendencies(state, grid, forcing, cfg)
    return depth_means(state, du_s, dv_s, grid, cfg)


def subcycle_phase(sp: SlowPhase, grid: Grid, cfg: Config,
                   pad1: Optional[Callable] = None,
                   crop1: Optional[Callable] = None):
    """nsub FB substeps on (eta, ubar, vbar); returns
    (eta_f, ubar_f, vbar_f, ubar_avg, vbar_avg).

    pad1/crop1 (default identity) are the distributed 1-halo exchange
    hooks: each substep's divergence and gradient reach one neighbour
    cell, so one exchange of the three 2-D fields per substep suffices
    whatever nsub is.
    """
    if pad1 is None:
        def pad1(a):
            return a

        def crop1(a):
            return a

    dte = cfg.dt / cfg.nsub
    eta, ub, vb = sp.eta0, sp.ubar, sp.vbar
    su = torch.zeros_like(sp.ubar)
    sv = torch.zeros_like(sp.ubar)
    for _ in range(cfg.nsub):
        Uep = pad1(sp.Hu) * pad1(ub)
        Vep = pad1(sp.Hv) * pad1(vb)
        div = crop1(ops.d_xm(Uep, cfg.dx) + ops.d_ym(Vep, cfg.dy))
        eta = (eta - dte * div) * grid.mask
        etap = pad1(eta)
        ub = (ub + dte * (-cfg.g * crop1(ops.d_xp(etap, cfg.dx))
                          + sp.du_bar)) * grid.mask_u
        vb = (vb + dte * (-cfg.g * crop1(ops.d_yp(etap, cfg.dy))
                          + sp.dv_bar)) * grid.mask_v
        su = su + ub
        sv = sv + vb
    return eta, ub, vb, su / cfg.nsub, sv / cfg.nsub


def recompose(sp: SlowPhase, eta_f, ubar_f, vbar_f, ubar_avg, vbar_avg,
              h, grid: Grid, cfg: Config):
    """Steps 4-5: layer velocities + continuity + column rescale."""
    dt = cfg.dt
    u1 = ((sp.up + dt * sp.du_p + ubar_f[None])
          / (1.0 + dt * sp.cu)) * grid.mask_u
    v1 = ((sp.vp + dt * sp.dv_p + vbar_f[None])
          / (1.0 + dt * sp.cv)) * grid.mask_v

    u_adv = (sp.up + ubar_avg[None]) * grid.mask_u
    v_adv = (sp.vp + vbar_avg[None]) * grid.mask_v
    dh = continuity.continuity_rhs(h, u_adv, v_adv, grid, cfg)
    h1 = (h + dt * dh) * grid.mask

    # pin the column to the subcycled free surface (mass-consistency
    # rescale; exact where the column is wet)
    col = torch.clamp_min(ops.sum_k(h1), cfg.h_min)
    target = torch.clamp_min(grid.H + eta_f, 0.0) * grid.mask
    h1 = h1 * torch.where(col > cfg.h_min, target / col, 1.0)[None]
    return h1, u1, v1


def fast_phase(sp: SlowPhase, state: State, grid: Grid, forcing: Forcing,
               cfg: Config) -> State:
    """Steps 3-5 and fb.finalize: the state at n + 1 from SlowPhase."""
    eta_f, ubar_f, vbar_f, ub_a, vb_a = subcycle_phase(sp, grid, cfg)
    h1, u1, v1 = recompose(sp, eta_f, ubar_f, vbar_f, ub_a, vb_a,
                           state.h, grid, cfg)
    return fb.finalize(h1, u1, v1, state, grid, forcing, cfg)


def split_step(state: State, grid: Grid, forcing: Forcing,
               cfg: Config) -> State:
    return fast_phase(slow_phase(state, grid, forcing, cfg), state, grid,
                      forcing, cfg)
