"""The rigid-lid gyre: the port's twin of beom_tpu/cases/rigid_lid.py.

Identical physics to the double gyre but scheme='rigid_lid': no external
gravity wave, dt set by advective/Rossby dynamics (here 10x the FB
external CFL), surface pressure from an elliptic solve each step.  Built
in numpy exactly as the reference builds it, so the arrays are
bit-identical, then moved to `device`.  Its default solve
(solver='cg', precond='auto') is the multigrid-preconditioned CG.
"""

from __future__ import annotations

import numpy as np

from beom_tpu_torch.core.config import Config
from beom_tpu_torch.core.grid import make_grid, make_forcing
from beom_tpu_torch.core.state import init_state


def make_case(nx=128, ny=128, L=2000e3, H0=500.0, tau0=0.1,
              f0=5e-5, beta=2e-11, nu2=300.0, r_bot=1e-3,
              dt=None, solver="cg", *, device, **cfg_kw):
    """Returns (cfg, grid, forcing, state) for the rigid-lid gyre."""
    dx = L / nx
    if dt is None:
        c = float(np.sqrt(9.81 * H0))
        dt = 5.0 * dx / (np.sqrt(2.0) * c)   # 10x the FB-stable step
    kw = dict(scheme="rigid_lid", solver=solver, rho=(1027.0,), wind=True)
    kw.update(cfg_kw)
    cfg = Config(nx=nx, ny=ny, dx=dx, dy=dx, nz=1,
                 f0=f0, beta=beta, dt=float(dt),
                 nu2=nu2, r_bot=r_bot, **kw)

    H = np.full((ny, nx), H0)
    grid = make_grid(cfg, H, device=device)   # land ring imposed

    j = np.arange(ny, dtype=cfg.npdtype)
    y = (j - 1.0) / max(ny - 2, 1)
    taux = -tau0 * np.cos(2.0 * np.pi * y)[:, None] * np.ones((ny, nx))
    taux = taux * grid.mask_u.cpu().numpy()
    forcing = make_forcing(cfg, taux=taux, device=device)

    state = init_state(cfg, grid)
    return cfg, grid, forcing, state
