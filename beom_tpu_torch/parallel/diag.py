"""Distributed diagnostics: the port's twin of beom_tpu/parallel/diag.py.

The scalars of diag/ computed per shard and reduced over the mesh with
the collectives of parallel/halo.py, so one call moves a handful of
floats to the host whatever the mesh size.  run() does not use it: like
the reference's, it takes the diagnostics of the gathered state, so a mesh
run logs the single-device run's numbers bit for bit (a per-shard sum
reduces in another order); this is for a caller that must not gather.
"""

from __future__ import annotations

import torch

from beom_tpu_torch.core import ops
from beom_tpu_torch.core.config import Config
from beom_tpu_torch.core.grid import Grid
from beom_tpu_torch.core.state import State
from beom_tpu_torch.parallel import halo
from beom_tpu_torch.parallel.mesh import Mesh, shard


def make_dist_diagnostics(grid: Grid, cfg: Config, mesh: Mesh):
    """diag(state) -> dict of Python floats (t, n, mass, ke, max_speed,
    cfl, eta_rms, finite) of a sharded State."""
    H, mask = shard(grid.H, mesh), shard(grid.mask, mesh)
    dA = cfg.dx * cfg.dy

    def diag(state: State) -> dict:
        h, u, v = state.h, state.u, state.v
        # the face-to-centre averages reach one cell west / south:
        # exchange a 1-halo so the distributed KE equals the single-device
        # scalar (a local wrap would differ at every shard edge)
        uu = halo.crop2d(ops.a_xm(halo.pad2d(u * u, 1)), 1)
        vv = halo.crop2d(ops.a_ym(halo.pad2d(v * v, 1)), 1)
        eta = (torch.sum(h, dim=0) - H) * mask
        sums = halo.psum2(torch.stack([
            torch.sum(h * (uu + vv)) * dA, torch.sum(h) * dA,
            torch.sum(mask), torch.sum(eta * eta)]))
        tops = halo.pmax2(torch.stack([
            torch.maximum(torch.max(torch.abs(u)), torch.max(torch.abs(v))),
            torch.max(torch.abs(u) / cfg.dx + torch.abs(v) / cfg.dy)
            * cfg.dt]))
        finite = halo.pmin2(
            (torch.isfinite(h).all() & torch.isfinite(u).all()
             & torch.isfinite(v).all()).to(h.dtype))
        ke, mass, nwet, eta2 = sums.blocks[0].tolist()
        spd, cfl = tops.blocks[0].tolist()
        return {"t": float(state.t), "n": float(state.n), "mass": mass,
                "ke": 0.5 * cfg.rho0 * ke, "max_speed": spd, "cfl": cfl,
                "eta_rms": (eta2 / max(nwet, 1.0)) ** 0.5,
                "finite": float(finite.blocks[0])}

    return diag
