"""Snapshot and restart I/O: the port's twin of beom_tpu/io/snapshots.py.

The npz layout is the reference's (h, u, v, t, n and, for the projection
schemes, phi and phi_prev), with n stored as int32, so a snapshot moves
between the two packages both ways.  A snapshot is a restart file.

A sharded State (parallel/mesh.py) is written as the same global npz.

Raw mode: `save_raw` / `load_raw` keep the reference's headerless binary
(h, u, v concatenated in C order, native float32 / float64 per
cfg.dtype) byte for byte, so a raw file written by either package loads
in the other.  `save_raw` takes an io/native.py AsyncWriter to hand the
buffer to the background C++ writer thread instead of blocking on disk.

Directory layout: <run_dir>/snap_<step:09d>.npz, plus last_good.npz kept
for failure recovery.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from beom_tpu_torch.core.config import Config
from beom_tpu_torch.core.state import State
from beom_tpu_torch.parallel.mesh import host_array


def save_state(path, state: State) -> None:
    extra = {} if state.phi is None else {"phi": host_array(state.phi)}
    if state.phi_prev is not None:
        extra["phi_prev"] = host_array(state.phi_prev)
    np.savez_compressed(
        path, h=host_array(state.h), u=host_array(state.u), v=host_array(state.v),
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


def save_raw(path, state: State, cfg: Config, writer=None) -> None:
    """Reference-style headerless binary: h, u, v concatenated, native
    float32 / float64 per cfg.dtype, C order (k, j, i).

    Pass an io.native.AsyncWriter as `writer` to hand the buffer to its
    background thread (which copies it, so the buffer may be freed at
    once); without one the write is synchronous.
    """
    dt = cfg.npdtype
    buf = np.concatenate([host_array(a).astype(dt, copy=False).ravel()
                          for a in (state.h, state.u, state.v)])
    if writer is not None:
        writer.submit(os.fspath(path), buf)
        return
    with open(path, "wb") as f:
        buf.tofile(f)


def load_raw(path, cfg: Config, *, device) -> State:
    """The State of a raw file on `device`, with t = 0 and n = 0 (the
    layout carries no time)."""
    dt = cfg.npdtype
    shape = (cfg.nz, cfg.ny, cfg.nx)
    count = int(np.prod(shape))
    raw = np.fromfile(path, dtype=dt, count=3 * count)
    if raw.size != 3 * count:
        raise ValueError(f"{path}: expected {3*count} values, got {raw.size}")
    h, u, v = (torch.tensor(raw[i * count:(i + 1) * count].reshape(shape),
                            device=device) for i in range(3))
    return State(h=h, u=u, v=v, t=dt.type(0), n=0)
