"""Snapshot and restart I/O: the port's twin of beom_tpu/io/snapshots.py.

The npz layout is the reference's (h, u, v, t, n and, for the projection
schemes, phi and phi_prev), with n stored as int32, so a snapshot moves
between the two packages both ways.  A snapshot is a restart file.

Directory layout: <run_dir>/snap_<step:09d>.npz, plus last_good.npz kept
for failure recovery.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from beom_tpu_torch.core.state import State


def _np(a: torch.Tensor) -> np.ndarray:
    return a.detach().cpu().numpy()


def save_state(path, state: State) -> None:
    extra = {} if state.phi is None else {"phi": _np(state.phi)}
    if state.phi_prev is not None:
        extra["phi_prev"] = _np(state.phi_prev)
    np.savez_compressed(
        path, h=_np(state.h), u=_np(state.u), v=_np(state.v),
        t=np.asarray(state.t), n=np.asarray(state.n, np.int32), **extra)


def load_state(path, *, device) -> State:
    """The State saved at `path`, its fields on `device`.

    A snapshot that has phi but no phi_prev (written before the
    reference carried phi_prev) resumes with phi_prev = phi.
    """
    def t(a):
        return torch.tensor(a, device=device)

    with np.load(path) as z:
        phi = t(z["phi"]) if "phi" in z.files else None
        phi_prev = t(z["phi_prev"]) if "phi_prev" in z.files else phi
        return State(h=t(z["h"]), u=t(z["u"]), v=t(z["v"]),
                     t=z["t"][()], n=int(z["n"]), phi=phi,
                     phi_prev=phi_prev)


def snap_path(run_dir, step: int) -> str:
    return os.path.join(run_dir, f"snap_{step:09d}.npz")


def write_snapshot(run_dir, state: State, last_good: bool = True) -> str:
    """Write snap_<n>.npz (+ refresh last_good.npz) and return its path."""
    os.makedirs(run_dir, exist_ok=True)
    path = snap_path(run_dir, state.n)
    save_state(path, state)
    if last_good:
        save_state(os.path.join(run_dir, "last_good.npz"), state)
    return path


def latest_snapshot(run_dir) -> Optional[str]:
    if not os.path.isdir(run_dir):
        return None
    snaps = sorted(f for f in os.listdir(run_dir)
                   if f.startswith("snap_") and f.endswith(".npz"))
    return os.path.join(run_dir, snaps[-1]) if snaps else None
