"""Prognostic model state: the port's twin of beom_tpu/core/state.py.

The fields are device tensors.  The step counter `n` is a host int and
the model time `t` a numpy scalar of `cfg.dtype`: the FB-Coriolis sweep
order is then known on the host without a device sync, and `t` rounds
exactly as the reference's `t` does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from beom_tpu_torch.core.config import Config
from beom_tpu_torch.core.grid import Grid


@dataclasses.dataclass(frozen=True)
class State:
    h: torch.Tensor   # (nz, ny, nx) layer thickness [m]
    u: torch.Tensor   # (nz, ny, nx) x-velocity at u points [m/s]
    v: torch.Tensor   # (nz, ny, nx) y-velocity at v points [m/s]
    t: np.floating    # model time [s], of cfg.dtype
    n: int            # step counter
    # (ny, nx) previous elliptic solutions of the projection schemes'
    # warm start; None for the explicit schemes
    phi: Optional[torch.Tensor] = None
    phi_prev: Optional[torch.Tensor] = None

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)


def advance_time(t, dt: float, dtype) -> np.floating:
    """t + dt rounded in `dtype`, as the reference's `state.t + cfg.dt`."""
    dtype = np.dtype(dtype)
    return dtype.type(dtype.type(t) + dtype.type(dt))


def init_state(cfg: Config, grid: Grid, h0=None, u0=None, v0=None) -> State:
    """Rest state with layers splitting the local water column.

    Default initial thicknesses divide H(x, y) evenly across nz layers;
    land cells get zero thickness.  Arrays are given in numpy and land on
    the grid's device.
    """
    dt = cfg.npdtype
    device = grid.H.device
    shape = (cfg.nz, cfg.ny, cfg.nx)

    def t(a):
        return torch.tensor(np.ascontiguousarray(a, dt), device=device)

    if h0 is None:
        H = grid.H.cpu().numpy().astype(dt)
        h0 = np.broadcast_to(H / cfg.nz, shape)
    h = t(h0) * grid.mask
    u = (torch.zeros(shape, dtype=cfg.tdtype, device=device) if u0 is None
         else t(u0) * grid.mask_u)
    v = (torch.zeros(shape, dtype=cfg.tdtype, device=device) if v0 is None
         else t(v0) * grid.mask_v)
    return State(h=h, u=u, v=v, t=dt.type(0), n=0)


def eta(state: State, grid: Grid) -> torch.Tensor:
    """Free-surface elevation eta = sum_k h_k - H."""
    return torch.sum(state.h, dim=0) - grid.H
