"""The 1-layer barotropic double gyre: the port's twin of
beom_tpu/cases/double_gyre.py.

Flat rectangular basin, beta-plane, steady zonal wind stress
tau_x(y) = -tau0 cos(2 pi y / L) driving a gyre pair, linear bottom drag
and Laplacian viscosity closing the western boundary layer.  Free-surface
forward-backward stepping.  Built in numpy exactly as the reference
builds it, so the arrays are bit-identical, then moved to `device`.
"""

from __future__ import annotations

import numpy as np

from beom_tpu_torch.core.config import Config
from beom_tpu_torch.core.grid import make_grid, make_forcing
from beom_tpu_torch.core.state import init_state


def make_case(nx=128, ny=128, L=2000e3, H0=500.0, tau0=0.1,
              f0=5e-5, beta=2e-11, nu2=300.0, r_bot=1e-3,
              dt=None, *, device, **cfg_kw):
    """Returns (cfg, grid, forcing, state) for the double-gyre run."""
    dx = L / nx
    if dt is None:
        # FB stability: c dt/dx < 1/sqrt(2) with margin for advection
        c = float(np.sqrt(9.81 * H0))
        dt = 0.5 * dx / (np.sqrt(2.0) * c)
    kw = dict(scheme="fb", rho=(1027.0,), wind=True)
    kw.update(cfg_kw)
    cfg = Config(nx=nx, ny=ny, dx=dx, dy=dx, nz=1,
                 f0=f0, beta=beta, dt=float(dt),
                 nu2=nu2, r_bot=r_bot, **kw)

    H = np.full((ny, nx), H0)
    grid = make_grid(cfg, H, device=device)   # land ring imposed

    # wind over the wet interior: y measured across the wet span
    j = np.arange(ny, dtype=cfg.npdtype)
    y = (j - 1.0) / max(ny - 2, 1)     # 0..1 across wet cells
    taux = -tau0 * np.cos(2.0 * np.pi * y)[:, None] * np.ones((ny, nx))
    taux = taux * grid.mask_u.cpu().numpy()
    forcing = make_forcing(cfg, taux=taux, device=device)

    state = init_state(cfg, grid)
    return cfg, grid, forcing, state
