"""Post-processing quicklooks: the port's twin of beom_tpu/viz/__init__.py.

`quicklook(state, grid, cfg, path)` renders the standard 4-panel view
(surface elevation, layer speed, vorticity, layer thickness anomaly) to
a PNG; `plot_series(jsonl_path, path)` plots the `diag` records of a
run.py log (ke, max_speed, eta_rms and cfl against time).  Fields come to
the host first, a sharded field gathered, and the arithmetic is the
reference's, in numpy.

This module is for a host with matplotlib (Agg backend, headless-safe),
which it imports at its own import; no other module of the port imports
it, so the package runs where matplotlib is missing.
"""

from __future__ import annotations

import json

import numpy as np

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from beom_tpu_torch.core.config import Config     # noqa: E402
from beom_tpu_torch.core.grid import Grid         # noqa: E402
from beom_tpu_torch.core.state import State       # noqa: E402
from beom_tpu_torch.parallel.mesh import host_array  # noqa: E402


def quicklook(state: State, grid: Grid, cfg: Config, path,
              layer: int = 0) -> None:
    h, u, v = (host_array(a) for a in (state.h, state.u, state.v))
    m = host_array(grid.mask)
    land = np.where(m > 0, 1.0, np.nan)

    eta = (h.sum(0) - host_array(grid.H)) * land
    uc = 0.5 * (u[layer] + np.roll(u[layer], 1, -1))
    vc = 0.5 * (v[layer] + np.roll(v[layer], 1, -2))
    speed = np.hypot(uc, vc) * land
    zeta = ((np.roll(v[layer], -1, -1) - v[layer]) / cfg.dx
            - (np.roll(u[layer], -1, -2) - u[layer]) / cfg.dy) * land
    hanom = (h[layer] - np.nanmean(h[layer] * land)) * land

    fig, axes = plt.subplots(2, 2, figsize=(11, 8), constrained_layout=True)
    for ax, (fld, title, cmap) in zip(axes.flat, [
            (eta, "surface elevation [m]", "RdBu_r"),
            (speed, f"layer-{layer + 1} speed [m/s]", "viridis"),
            (zeta, f"layer-{layer + 1} vorticity [1/s]", "RdBu_r"),
            (hanom, f"layer-{layer + 1} thickness anom [m]", "RdBu_r")]):
        vmax = np.nanmax(np.abs(fld)) or 1.0
        kw = ({"vmin": -vmax, "vmax": vmax} if cmap == "RdBu_r"
              else {"vmin": 0.0, "vmax": vmax})
        im = ax.pcolormesh(fld, cmap=cmap, **kw)
        ax.set_title(title)
        ax.set_aspect("equal")
        fig.colorbar(im, ax=ax, shrink=0.8)
    fig.suptitle(f"step {int(state.n)}   t = {float(state.t) / 86400:.2f} d")
    fig.savefig(path, dpi=110)
    plt.close(fig)


def plot_series(jsonl_path, path) -> None:
    rows = []
    with open(jsonl_path) as f:
        for line in f:
            try:
                d = json.loads(line)
            except json.JSONDecodeError:
                continue
            if d.get("kind") == "diag":
                rows.append(d)
    if not rows:
        raise ValueError(f"no diag records in {jsonl_path}")
    t = np.asarray([r["t"] for r in rows]) / 86400.0
    fig, axes = plt.subplots(2, 2, figsize=(10, 7), constrained_layout=True)
    for ax, key, label in [
            (axes[0, 0], "ke", "kinetic energy [J]"),
            (axes[0, 1], "max_speed", "max |u| [m/s]"),
            (axes[1, 0], "eta_rms", "rms eta [m]"),
            (axes[1, 1], "cfl", "CFL")]:
        ax.plot(t, [r[key] for r in rows])
        ax.set_xlabel("t [days]")
        ax.set_title(label)
        ax.grid(alpha=0.3)
    fig.savefig(path, dpi=110)
    plt.close(fig)
