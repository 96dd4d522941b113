"""Montgomery potential: the port's twin of beom_tpu/physics/pressure.py.

For layers k = 0..nz-1, interface elevations
    z_0 = eta = sum_k h_k - H            (free surface)
    z_k = z_{k-1} - h_{k-1}
and the Montgomery potential accumulates reduced-gravity contributions
downward: M_0 = g eta, M_k = M_{k-1} + g'_k z_k.
"""

from __future__ import annotations

import torch

from beom_tpu_torch.core import ops
from beom_tpu_torch.core.config import Config
from beom_tpu_torch.core.grid import Grid


def montgomery(h: torch.Tensor, grid: Grid, cfg: Config,
               free_surface: bool = True) -> torch.Tensor:
    """M (nz, ny, nx) at cell centers from thickness h (nz, ny, nx).

    `free_surface=False` is the rigid-lid mode: the g*eta surface term is
    dropped (eta = 0) and only the internal interface terms remain.
    """
    if free_surface:
        eta = ops.sum_k(h) - grid.H
    else:
        eta = torch.zeros(h.shape[1:], dtype=h.dtype, device=h.device)
    gp = cfg.gprime
    z = eta
    acc = gp[0] * z
    M = [acc]
    for k in range(1, cfg.nz):
        z = z - h[k - 1]
        acc = acc + gp[k] * z
        M.append(acc)
    return torch.stack(M, dim=0)
