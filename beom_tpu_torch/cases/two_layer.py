"""The 2-layer baroclinic wind-driven gyre: the port's twin of
beom_tpu/cases/two_layer.py.

Same basin and wind as the double gyre, but two layers with reduced
gravity g' = g (rho2 - rho1)/rho0 coupling them through the interfacial
pressure gradient.  The wind spins up the upper layer; the interface tilts
to compensate.  Built in numpy exactly as the reference builds it, so the
arrays are bit-identical, then moved to `device`.
"""

from __future__ import annotations

import numpy as np

from beom_tpu_torch.core.config import Config
from beom_tpu_torch.core.grid import make_grid, make_forcing
from beom_tpu_torch.core.state import init_state


def make_case(nx=128, ny=128, L=2000e3, H0=1000.0, h1_frac=0.25,
              tau0=0.1, f0=5e-5, beta=2e-11, nu2=300.0, r_bot=1e-3,
              rho=(1026.0, 1027.5), dt=None, *, device, **cfg_kw):
    """Returns (cfg, grid, forcing, state) for the 2-layer gyre."""
    dx = L / nx
    if dt is None:
        c = float(np.sqrt(9.81 * H0))
        dt = 0.5 * dx / (np.sqrt(2.0) * c)
    kw = dict(scheme="fb", wind=True)
    kw.update(cfg_kw)
    cfg = Config(nx=nx, ny=ny, dx=dx, dy=dx, nz=2, rho=tuple(rho),
                 f0=f0, beta=beta, dt=float(dt),
                 nu2=nu2, r_bot=r_bot, **kw)

    H = np.full((ny, nx), H0)
    grid = make_grid(cfg, H, device=device)

    j = np.arange(ny, dtype=cfg.npdtype)
    y = (j - 1.0) / max(ny - 2, 1)
    taux = -tau0 * np.cos(2.0 * np.pi * y)[:, None] * np.ones((ny, nx))
    taux = taux * grid.mask_u.cpu().numpy()
    forcing = make_forcing(cfg, taux=taux, device=device)

    # stratification: thin active upper layer over a deep abyss
    h0 = np.zeros((2, ny, nx), cfg.npdtype)
    h0[0] = h1_frac * H
    h0[1] = (1.0 - h1_frac) * H
    state = init_state(cfg, grid, h0=h0)
    return cfg, grid, forcing, state
