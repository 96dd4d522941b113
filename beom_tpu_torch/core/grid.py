"""Grid masks and forcing fields: the port's twin of beom_tpu/core/grid.py.

`Grid` and `Forcing` are dataclasses of tensors.  Both are built in numpy
exactly as the reference builds them, then moved to `device`, so their
values are bit-identical to the reference's.

Mask convention (see core/ops.py): all operators are periodic; a closed
basin is a wet region surrounded by at least one ring of land cells.
Faces are open iff both adjacent centers are wet; corners are interior
iff all four surrounding centers are wet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from beom_tpu_torch.core.config import Config


@dataclasses.dataclass(frozen=True)
class Grid:
    H: torch.Tensor        # (ny, nx) bottom depth [m], > 0 in ocean
    mask: torch.Tensor     # (ny, nx) 1.0 wet / 0.0 land, at centers
    mask_u: torch.Tensor   # (ny, nx) 1.0 where east  face is open
    mask_v: torch.Tensor   # (ny, nx) 1.0 where north face is open
    mask_q: torch.Tensor   # (ny, nx) 1.0 where a corner has 4 wet cells
    f_q: torch.Tensor      # (ny, nx) Coriolis parameter at corners [1/s]


@dataclasses.dataclass(frozen=True)
class Forcing:
    """Array-valued forcing.  Zeros disable each term."""
    taux: torch.Tensor        # (ny, nx) wind stress [N/m^2] at u points
    tauy: torch.Tensor        # (ny, nx) at v points
    sponge: torch.Tensor      # (ny, nx) nudging rate [1/s] at centers
    h_ext: torch.Tensor       # (nz, ny, nx) sponge/OBC target thickness
    obc_u: torch.Tensor       # (ny, nx) outward-normal sign on open u faces
    obc_v: torch.Tensor       # (ny, nx) outward-normal sign on open v faces
    obc_h: torch.Tensor       # (ny, nx) 1.0 on exterior cells clamped
    tide_amp: torch.Tensor    # (nc, ny, nx) constituent amplitude [m]
    tide_phase: torch.Tensor  # (nc, ny, nx) constituent phase [rad]


def _sxp(a):
    return np.roll(a, -1, -1)


def _syp(a):
    return np.roll(a, -1, -2)


def make_grid(cfg: Config, H, mask=None, *, device) -> Grid:
    """Build a Grid from bathymetry `H` (ny, nx) and an optional wet mask.

    If `mask` is None it is H > 0 with a ring of land imposed on the
    outermost cells.
    """
    dt = cfg.npdtype
    H = np.asarray(H, dt)
    if mask is None:
        mask = (H > 0).astype(dt)
        mask[0, :] = 0
        mask[-1, :] = 0
        mask[:, 0] = 0
        mask[:, -1] = 0
    mask = np.asarray(mask, dt)

    mask_u = mask * _sxp(mask)
    mask_v = mask * _syp(mask)
    mask_q = mask * _sxp(mask) * _syp(mask) * _sxp(_syp(mask))

    # beta-plane: f at corners (x_{i+1/2}, y_{j+1/2}); y measured from
    # the southern edge of the domain
    j = np.arange(cfg.ny, dtype=dt)
    y_q = (j + 0.5) * cfg.dy
    f_q = np.broadcast_to((cfg.f0 + cfg.beta * y_q)[:, None],
                          (cfg.ny, cfg.nx)).astype(dt)

    def t(a):
        return torch.tensor(np.ascontiguousarray(a), device=device)

    return Grid(H=t(H * mask), mask=t(mask), mask_u=t(mask_u),
                mask_v=t(mask_v), mask_q=t(mask_q), f_q=t(f_q))


def make_forcing(cfg: Config, taux=None, tauy=None, sponge=None, h_ext=None,
                 obc_u=None, obc_v=None, obc_h=None, tide_amp=None,
                 tide_phase=None, *, device) -> Forcing:
    dt = cfg.npdtype
    z2 = np.zeros((cfg.ny, cfg.nx), dt)
    z3 = np.zeros((cfg.nz, cfg.ny, cfg.nx), dt)
    nc = max(len(cfg.tides), 1)
    zc = np.zeros((nc, cfg.ny, cfg.nx), dt)

    def arr(x, z):
        a = z if x is None else np.ascontiguousarray(x, dt)
        return torch.tensor(a, device=device)     # a copy: z is shared

    return Forcing(
        taux=arr(taux, z2), tauy=arr(tauy, z2), sponge=arr(sponge, z2),
        h_ext=arr(h_ext, z3), obc_u=arr(obc_u, z2), obc_v=arr(obc_v, z2),
        obc_h=arr(obc_h, z2),
        tide_amp=arr(tide_amp, zc), tide_phase=arr(tide_phase, zc),
    )
