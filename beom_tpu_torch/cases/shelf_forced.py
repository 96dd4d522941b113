"""Wind- and tide-forced 2-layer shelf run with bottom drag and an open
boundary: the port's twin of beom_tpu/cases/shelf_forced.py.

A shelf/slope channel: shallow shelf in the south deepening offshore to
the north.  The northern boundary is open with Flather radiation forced by
an M2 tidal elevation; a sponge ramps along it; upwelling-favourable
alongshore wind stress and quadratic bottom drag complete it.  Built in
numpy exactly as the reference builds it, then moved to `device`.
"""

from __future__ import annotations

import numpy as np

from beom_tpu_torch.core.config import Config
from beom_tpu_torch.core.grid import make_grid, make_forcing
from beom_tpu_torch.core.state import init_state

M2 = 2.0 * np.pi / (12.42 * 3600.0)   # [rad/s]


def make_case(nx=128, ny=96, L=300e3, Hshelf=50.0, Hdeep=500.0,
              tau0=0.05, tide_amp0=0.5, f0=1e-4, nu2=20.0,
              cd_bot=2.5e-3, rho=(1026.0, 1027.5), h1_frac=0.3,
              sponge_width=8, dt=None, *, device, **cfg_kw):
    dx = L / nx
    if dt is None:
        c = float(np.sqrt(9.81 * Hdeep))
        dt = 0.4 * dx / (np.sqrt(2.0) * c)
    # wetdry=True: the upwelling-favourable wind OUTCROPS layer 1 at
    # the coast after ~3000 steps; without the positive-definite flux
    # limiter h_1 goes negative and the run blows up (the
    # limiter is the isopycnal-outcropping mechanism)
    kw = dict(scheme="fb", wind=True, obc=True, sponge=True, tides=(M2,),
              wetdry=True)
    kw.update(cfg_kw)
    cfg = Config(nx=nx, ny=ny, dx=dx, dy=dx, nz=2, rho=tuple(rho),
                 f0=f0, beta=0.0, dt=float(dt),
                 nu2=nu2, cd_bot=cd_bot, **kw)
    dtp = cfg.npdtype

    # shelf profile: shallow in the south (coast), tanh slope to deep
    y = np.linspace(0.0, 1.0, ny)[:, None]
    H = Hshelf + 0.5 * (Hdeep - Hshelf) * (1.0 + np.tanh((y - 0.45) / 0.12))
    H = np.broadcast_to(H, (ny, nx)).copy()

    # mask: land along the south; open along the north (row ny-1 is the
    # exterior rim used as OBC ghost cells); periodic-capable in x closed
    # by the default land ring on the east/west here
    mask = np.ones((ny, nx), dtp)
    mask[0, :] = 0.0                     # coast
    mask[:, 0] = mask[:, -1] = 0.0       # side walls
    grid = make_grid(cfg, H, mask=mask, device=device)

    # alongshore (x) wind stress, upwelling-favourable
    taux = tau0 * np.ones((ny, nx)) * grid.mask_u.cpu().numpy()

    # open boundary along the north edge: the outermost wet v-face
    # (between j = ny-2 and j = ny-1) radiates; exterior row clamped
    obc_v = np.zeros((ny, nx), dtp)
    obc_v[ny - 2, :] = 1.0               # outward normal = +y
    obc_h = np.zeros((ny, nx), dtp)
    obc_h[ny - 1, :] = 1.0

    # sponge ramp over the northern sponge_width rows
    sponge = np.zeros((ny, nx), dtp)
    for k in range(sponge_width):
        j = ny - 2 - k
        sponge[j, :] = (1.0 - k / sponge_width) / (20.0 * cfg.dt)

    # target stratification (also the IC): fixed-fraction interface
    h_ext = np.zeros((2, ny, nx), dtp)
    h_ext[0] = h1_frac * H
    h_ext[1] = (1.0 - h1_frac) * H

    # M2 elevation amplitude map (uniform) entering via Flather
    tide_amp = tide_amp0 * np.ones((1, ny, nx), dtp)
    tide_phase = np.zeros((1, ny, nx), dtp)

    forcing = make_forcing(cfg, taux=taux, sponge=sponge, h_ext=h_ext,
                           obc_v=obc_v, obc_h=obc_h, tide_amp=tide_amp,
                           tide_phase=tide_phase, device=device)
    state = init_state(cfg, grid, h0=h_ext * grid.mask.cpu().numpy())
    return cfg, grid, forcing, state


# The constituents of TPXO's tidal forcing: the eight major ones (M2, S2,
# N2, K2, K1, O1, P1, Q1), the shallow-water M4, MS4, MN4 and the
# long-period Mf, Mm; speeds in degrees per hour
TPXO_NAMES = ("M2", "S2", "N2", "K2", "K1", "O1", "P1", "Q1", "M4", "MS4",
              "MN4", "Mf", "Mm")
TPXO_SPEEDS = (28.9841042, 30.0, 28.4397295, 30.0821373, 15.0410686,
               13.9430356, 14.9589314, 13.3986609, 57.9682084, 58.9841042,
               57.4238337, 1.0980331, 0.5443747)


def constituents(n: int, ny: int, nx: int, seed: int, m2_amp: float = 0.5,
                 dtype=np.float64):
    """The first n of TPXO's constituents at the open boundary: (omegas in
    rad/s, amplitudes (n, ny, nx) in m, phases (n, ny, nx) in rad).  M2
    keeps the case's uniform amplitude and phase 0; each other one takes
    amplitudes in [0, 0.1) m and phases in [0, 2 pi) from numpy's
    generator of `seed`, a value per point."""
    if not 1 <= n <= len(TPXO_SPEEDS):
        raise ValueError(f"1 to {len(TPXO_SPEEDS)} constituents, not {n}")
    omegas = tuple(float(np.deg2rad(s) / 3600.0) for s in TPXO_SPEEDS[:n])
    rng = np.random.default_rng(seed)
    amp = np.empty((n, ny, nx), dtype)
    phase = np.empty((n, ny, nx), dtype)
    amp[0], phase[0] = m2_amp, 0.0
    if n > 1:
        amp[1:] = 0.1 * rng.random((n - 1, ny, nx))
        phase[1:] = 2.0 * np.pi * rng.random((n - 1, ny, nx))
    return omegas, amp, phase
