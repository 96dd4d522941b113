"""Coastal domain with an irregular land mask and wetting/drying of
shallow cells: the port's twin of beom_tpu/cases/coastal_wetdry.py.

A sloping beach along the northern edge with a headland; the basin starts
with a tilted surface so water sloshes onto and off the shallow shelf,
exercising dry-cell masking, one-sided face gating and the
positive-definite flux limiter.  Built in numpy exactly as the reference
builds it, then moved to `device`.
"""

from __future__ import annotations

import numpy as np

from beom_tpu_torch.core.config import Config
from beom_tpu_torch.core.grid import make_grid, make_forcing
from beom_tpu_torch.core.state import init_state


def make_case(nx=96, ny=64, L=100e3, Hdeep=20.0, beach_frac=0.4,
              eta0=1.0, f0=1e-4, nu2=5.0, cd_bot=2.5e-3,
              dt=None, *, device, **cfg_kw):
    """Tilted-surface slosh over a drying beach; returns the 4-tuple."""
    dx = L / nx
    dy = dx
    if dt is None:
        c = float(np.sqrt(9.81 * Hdeep))
        dt = 0.4 * dx / (np.sqrt(2.0) * c)
    kw = dict(scheme="fb", rho=(1027.0,), wetdry=True, h_dry=0.05,
              h_min=1e-3)
    kw.update(cfg_kw)
    cfg = Config(nx=nx, ny=ny, dx=dx, dy=dy, nz=1,
                 f0=f0, beta=0.0, dt=float(dt),
                 nu2=nu2, cd_bot=cd_bot, **kw)

    # bathymetry: deep basin in the south, linear beach rising through
    # zero in the north third; a headland (land bump) intrudes mid-beach
    y = np.linspace(0.0, 1.0, ny)[:, None]
    x = np.linspace(0.0, 1.0, nx)[None, :]
    beach_start = 1.0 - beach_frac
    H = np.where(y < beach_start, Hdeep,
                 Hdeep * (1.0 - (y - beach_start) / beach_frac * 1.25))
    H = np.broadcast_to(H, (ny, nx)).copy()
    bump = np.exp(-(((x - 0.5) / 0.08) ** 2)) * (y > beach_start)
    H -= 30.0 * bump
    mask = (H > 0).astype(cfg.npdtype)
    mask[0, :] = mask[-1, :] = mask[:, 0] = mask[:, -1] = 0.0
    # NOTE: cells with H <= 0 above the waterline can still wet when the
    # surface rises; model them as very shallow wet-capable cells
    Hc = np.maximum(H, 0.0)
    grid = make_grid(cfg, Hc, mask=mask * (H > -5.0),
                     device=device)

    forcing = make_forcing(cfg, device=device)

    # tilted initial surface: eta = eta0 * (2x - 1); h = max(H + eta, ~0)
    eta = eta0 * (2.0 * x - 1.0) * np.ones((ny, nx))
    h0 = np.maximum(Hc + eta, cfg.h_min)[None] * grid.mask.cpu().numpy()
    state = init_state(cfg, grid, h0=h0)
    return cfg, grid, forcing, state
