"""Rigid-lid and implicit-free-surface stepping: the port's twin of
beom_tpu/stepping/projection.py.

Both schemes remove the fast external gravity wave from the explicit CFL
limit by an elliptic solve (solvers/elliptic.py), allowing dt set by the
much slower advective / internal-wave speeds:

  * `rigid_lid_step`: pressure projection.  The provisional momentum
    update runs with the surface term dropped from the Montgomery
    potential (free_surface=False); the surface pressure phi [m^2/s^2]
    is the Lagrange multiplier enforcing a divergence-free barotropic
    transport:

        div( H_face grad phi ) = div(U*) / dt,    u_k <- u*_k - dt grad phi

    (the same correction in every layer).  Because the correction uses
    the same discrete divergence as continuity, sum_k h_k stays = H to
    solver tolerance.

  * `implicit_fs_step`: theta=1 implicit free surface, the Helmholtz
    problem

        div(H grad eta') - eta'/(g dt^2) = -(eta^n - dt div U*)/(g dt^2)

    solved with lam = 1/(g dt^2); then u_k <- u*_k - g dt grad eta', and
    layer thickness follows from per-layer continuity.

A step is phase A (momentum without the surface term, the transport
divergence), the right-hand side, the solve, and phase B (correction,
continuity, finalize).  The fused stepper (stencils/fused_projection.py)
runs the same four parts, with phases A and B and the solve as kernels,
and calls the helpers below for the rest.

The solve follows cfg.solver: 'cg' with the effective preconditioner
(precond='auto' is multigrid for the lam = 0 rigid lid, Jacobi for the
Helmholtz solve), 'redblack', or 'mg' (standalone multigrid cycles).
"""

from __future__ import annotations

import torch

from beom_tpu_torch.core import ops
from beom_tpu_torch.core.config import Config
from beom_tpu_torch.core.grid import Grid, Forcing
from beom_tpu_torch.core.state import State
from beom_tpu_torch.physics import continuity
from beom_tpu_torch.solvers import elliptic, multigrid
from beom_tpu_torch.solvers.elliptic import _local_dot
from beom_tpu_torch.stepping import fb


def solve_lam(cfg: Config) -> float:
    """The Helmholtz shift of the scheme's solve: 0 for the rigid lid,
    1/(g dt^2) for the implicit free surface."""
    return 0.0 if cfg.scheme == "rigid_lid" else 1.0 / (cfg.g * cfg.dt
                                                        * cfg.dt)


def effective_precond(cfg: Config, lam) -> str:
    """cfg.precond with 'auto' resolved (measured in the reference: MG
    pays off only for pure Neumann)."""
    if cfg.precond == "auto":
        return "mg" if lam == 0.0 else "jacobi"
    return cfg.precond


def _solve(b, grid: Grid, cfg: Config, lam=0.0, x0=None):
    if cfg.solver == "redblack":
        return elliptic.redblack_solve(b, grid, cfg, x0=x0, lam=lam)
    if cfg.solver == "mg":
        return multigrid.mg_solve(b, grid, cfg, lam=lam, x0=x0)
    precond = None
    pre = effective_precond(cfg, lam)
    if pre == "ssor":
        precond = elliptic.make_ssor_precond(grid, cfg, lam=lam)
    elif pre == "mg":
        precond = multigrid.make_mg_precond(grid, cfg, lam=lam)
    return elliptic.cg_solve(b, grid, cfg, x0=x0, lam=lam,
                             precond=precond).x


def warm_x0(state: State, cfg: Config):
    """Warm-start guess for the step's elliptic solve: the second-order
    time extrapolation 2 phi^n - phi^{n-1} when both carries exist,
    else phi^n, else None.  The converged solution is x0-independent to
    solver tolerance, so this changes cost, not trajectories."""
    if not cfg.warm_start or state.phi is None:
        return None
    if state.phi_prev is None:
        return state.phi
    return 2.0 * state.phi - state.phi_prev


def barotropic_transport(h, u, v, grid: Grid):
    """(U, V) = sum_k h_face,k * w_k at u/v faces (mask-gated)."""
    U = torch.sum(ops.a_xp(h) * u, dim=0) * grid.mask_u
    V = torch.sum(ops.a_yp(h) * v, dim=0) * grid.mask_v
    return U, V


def transport_divergence(h, u_s, v_s, grid: Grid, cfg: Config):
    """div(U*) at wet centres: the end of phase A."""
    U, V = barotropic_transport(h, u_s, v_s, grid)
    return (ops.d_xm(U, cfg.dx) + ops.d_ym(V, cfg.dy)) * grid.mask


def rigid_rhs(h, div, grid: Grid, cfg: Config):
    """div(H grad phi) = [div(U*) - (sum h - H)/dt] / dt.

    After the correction u <- u* - dt grad(phi) the new transport
    satisfies div(U) = +anom/dt, so the following continuity step
    removes the accumulated column anomaly (sum h1 - H -> 0): finite
    solver tolerance (f32) then causes a bounded error, not a random-walk
    drift.  The anomaly is de-meaned over wet cells: the Neumann problem
    needs a zero-sum right-hand side.
    """
    dt = cfg.dt
    anom = (torch.sum(h, dim=0) - grid.H) * grid.mask
    anom = anom - grid.mask * (_local_dot(anom, grid.mask)
                               / _local_dot(grid.mask, grid.mask))
    return (div - anom / dt) / dt


def implicit_rhs(h, div, grid: Grid, cfg: Config, lam):
    """(b, eta^n) of the Helmholtz solve for eta^{n+1}."""
    eta_n = (torch.sum(h, dim=0) - grid.H) * grid.mask
    return -lam * (eta_n - cfg.dt * div), eta_n


def phase_b(h, u_s, v_s, p, corr: float, state: State, grid: Grid,
            forcing: Forcing, cfg: Config) -> State:
    """The barotropic correction u <- u* - corr grad p (the same in every
    layer), per-layer continuity with the corrected velocities, and
    finalize."""
    dpx = grid.mask_u * ops.d_xp(p, cfg.dx)
    dpy = grid.mask_v * ops.d_yp(p, cfg.dy)
    u1 = (u_s - corr * dpx[None]) * grid.mask_u
    v1 = (v_s - corr * dpy[None]) * grid.mask_v
    dh = continuity.continuity_rhs(h, u1, v1, grid, cfg)
    h1 = (h + cfg.dt * dh) * grid.mask
    return fb.finalize(h1, u1, v1, state, grid, forcing, cfg)


def with_carry(out: State, state: State, p) -> State:
    """Carry the step's solution as the next warm start."""
    if state.phi is None:
        return out
    return out.replace(phi=p, phi_prev=state.phi)


def rigid_lid_step(state: State, grid: Grid, forcing: Forcing,
                   cfg: Config) -> State:
    # 1. provisional momentum from the old h (the column is rigid)
    u_s, v_s = fb.momentum_update(state.h, state, grid, forcing, cfg,
                                  free_surface=False)
    # 2. projection, warm-started from the carried solutions
    div = transport_divergence(state.h, u_s, v_s, grid, cfg)
    rhs = rigid_rhs(state.h, div, grid, cfg)
    phi = _solve(rhs, grid, cfg, x0=warm_x0(state, cfg))
    # 3. correction + layer continuity: internal redistribution only
    out = phase_b(state.h, u_s, v_s, phi, cfg.dt, state, grid, forcing,
                  cfg)
    return with_carry(out, state, phi)


def implicit_fs_step(state: State, grid: Grid, forcing: Forcing,
                     cfg: Config) -> State:
    lam = solve_lam(cfg)
    # 1. provisional momentum: full Montgomery minus the surface part
    #    (applied implicitly below)
    u_s, v_s = fb.momentum_update(state.h, state, grid, forcing, cfg,
                                  free_surface=False)
    # 2. Helmholtz solve for eta^{n+1}, warm-started from the carried
    #    solves when available, else from eta^n
    div = transport_divergence(state.h, u_s, v_s, grid, cfg)
    b, eta_n = implicit_rhs(state.h, div, grid, cfg, lam)
    x0 = warm_x0(state, cfg)
    eta1 = _solve(b, grid, cfg, lam=lam, x0=eta_n if x0 is None else x0)
    # 3. barotropic correction + per-layer continuity
    out = phase_b(state.h, u_s, v_s, eta1, cfg.g * cfg.dt, state, grid,
                  forcing, cfg)
    return with_carry(out, state, eta1)
