"""Experiment driver: the port's twin of beom_tpu/run.py.

    main -> build case -> chunked time loop:
        state = advance(state)     # chunk steps, on the device
        diagnostics -> JSONL; NaN guard; snapshots at cadence

Each chunk runs `chunk // steps_per_pass` passes of make_stepper's step
plus single-step calls for the remainder; the host sees a handful of
diagnostic scalars per chunk, plus snapshot fields at cfg.snap_every.  On
a non-finite state the run aborts, keeping last_good.npz for restart.

With cfg.mesh_y * cfg.mesh_x > 1 the state is sharded over a mesh
(parallel/mesh.py) and stepped by parallel/dist.make_dist_stepper; every
shard lies on the grid's device unless `--devices` spreads them (`all`:
the visible cards, entry.card_placement's equal rectangles; or a list of
devices, one per shard or one for all).  Diagnostics and snapshots are those of
the gathered state, as the reference takes them of the global array (so
they equal the single-device run's bit for bit; parallel/diag.py has the
per-shard reductions for a caller that must not gather), and the sharded
state is returned.

    python -m beom_tpu_torch.run double_gyre -n 400 --set steps_per_pass=4
    python -m beom_tpu_torch.run double_gyre -n 400 --set backend=fused \
        --set mesh_y=2 --set mesh_x=4 --set nx=2048 --set ny=2048
    python -m beom_tpu_torch.run double_gyre -n 400 --set backend=fused \
        --set mesh_y=2 --set mesh_x=4 --set nx=2048 --set ny=2048 \
        --devices all
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from typing import Optional

import torch

from beom_tpu_torch.core.config import Config
from beom_tpu_torch.core.grid import Grid, Forcing
from beom_tpu_torch.core.state import State
from beom_tpu_torch.diag import diagnostics
from beom_tpu_torch.io import snapshots
from beom_tpu_torch.stepping import make_stepper, prepare_state


class InstabilityError(RuntimeError):
    pass


def run(cfg: Config, grid: Grid, forcing: Forcing, state: State,
        n_steps: int, run_dir: Optional[str] = None,
        log=None, chunk: Optional[int] = None, devices=None,
        cards=None) -> State:
    """Advance `n_steps`, chunked for I/O; returns the final state.

    Diagnostics go to `log` (default: sys.stdout at call time); chunk
    defaults to the diagnostics/snapshot cadence (or 100).  A mesh run
    (mesh_y * mesh_x > 1) puts its shards on `devices` (one per shard, or
    one for all; default the grid's device): on several cards the fused
    backend launches its kernels once per card.  `cards` is for the tests
    and the chip check: the fused kernels' cards (dist_band.MeshKernels).
    """
    log = sys.stdout if log is None else log
    cadences = [c for c in (cfg.diag_every, cfg.snap_every) if c > 0]
    if chunk is None:
        chunk = min(cadences) if cadences else 100
    chunk = max(1, min(chunk, n_steps))

    if run_dir:
        os.makedirs(run_dir, exist_ok=True)
        if resume := snapshots.latest_snapshot(run_dir):
            state = snapshots.load_state(resume, device=grid.H.device)
            print(f"# resumed from {resume} at step {state.n}", file=log)
    # resume before sharding, so a mesh run steps properly placed shards
    state = prepare_state(state, cfg)

    spp = cfg.steps_per_pass
    cfg1 = dataclasses.replace(cfg, steps_per_pass=1)
    if cfg.mesh_x * cfg.mesh_y > 1:
        from beom_tpu_torch.parallel.dist import make_dist_stepper
        from beom_tpu_torch.parallel.mesh import (gather_state, make_mesh,
                                                  shard_state)
        mesh = make_mesh(cfg.mesh_y, cfg.mesh_x,
                         devices=devices or [grid.H.device])
        state = shard_state(state, mesh)
        pstep = make_dist_stepper(grid, forcing, cfg, mesh, cards=cards)
        pstep1 = pstep if spp == 1 else make_dist_stepper(
            grid, forcing, cfg1, mesh, cards=cards)
    else:
        def gather_state(s):
            return s
        pstep = make_stepper(grid, forcing, cfg)   # advances spp steps
        pstep1 = pstep if spp == 1 else make_stepper(grid, forcing, cfg1)

    def advance(s, k):
        # k model steps = k // spp passes + a 1-step tail per remainder
        n_pass, rem = divmod(k, spp)
        for _ in range(n_pass):
            s = pstep(s)
        for _ in range(rem):
            s = pstep1(s)
        return s

    done = 0
    while done < n_steps:
        k = min(chunk, n_steps - done)
        state = advance(state, k)
        done += k
        d = diagnostics(gather_state(state), grid, cfg)
        if cfg.diag_every > 0:
            print(json.dumps({"kind": "diag", **d}), file=log, flush=True)
        if d["finite"] != 1.0:
            raise InstabilityError(
                f"non-finite state at step {state.n}"
                + (f"; restart from {run_dir}/last_good.npz" if run_dir
                   else ""))
        if run_dir and cfg.snap_every > 0 and \
                state.n % cfg.snap_every < chunk:
            snapshots.write_snapshot(run_dir, state)
    if run_dir:
        snapshots.write_snapshot(run_dir, state)
    return state


def device_of(device=None) -> torch.device:
    """The device an entry point of the port runs on: the card unless the
    caller names another (device=None means cuda).  Raises when that is
    cuda and no card is present: nothing falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev}: torch.cuda.is_available() is false (pass "
            "device='cpu' to run the kernels' plain versions)")
    return dev


def mesh_devices(spec: Optional[str], mesh_y: int, mesh_x: int):
    """The devices of a mesh run's shards from `--devices`: None (every
    shard on the grid's device), `all` (every visible card, the mesh cut
    into entry.card_placement's equal rectangles, one per card), or a
    comma-separated list of devices, one per shard or one for all.  A list
    whose cards are not equal rectangles of the mesh raises
    parallel/mesh.py card_groups' ValueError."""
    from beom_tpu_torch.parallel.mesh import card_groups

    if spec is None:
        return None
    n = mesh_y * mesh_x
    if spec == "all":
        from beom_tpu_torch.entry import card_placement

        count = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if count < 1:
            raise ValueError("--devices all: no CUDA card is visible")
        return card_placement(mesh_y, mesh_x, [
            torch.device("cuda", i) for i in range(count)])
    devices = [torch.device(d.strip()) for d in spec.split(",")]
    if len(devices) not in (1, n):
        raise ValueError(f"--devices names {len(devices)} devices for a "
                         f"mesh of {n} shards: give one per shard or one")
    if len(devices) == n:
        card_groups(devices, mesh_y, mesh_x)
    return devices


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        prog="beom-tpu-torch",
        description="layered shallow-water run on PyTorch")
    p.add_argument("case", help="canonical case name or a config .toml")
    p.add_argument("-n", "--steps", type=int, default=1000)
    p.add_argument("-o", "--out", default=None, help="run directory")
    p.add_argument("--set", action="append", default=[], metavar="K=V",
                   help="Config override (repeatable)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    p.add_argument("--devices", default=None, metavar="all|D[,D...]",
                   help="a mesh run's shards: 'all' spreads them over the "
                   "visible cards, a list names one device per shard or "
                   "one for all (default: every shard on --device)")
    args = p.parse_args(argv)

    device = device_of(args.device)

    from beom_tpu_torch.io import config as ioconfig
    if args.case.endswith(".toml"):
        cfg, grid, forcing, state = ioconfig.load_toml_case(
            args.case, args.set, device=device)
    else:
        from beom_tpu_torch.cases import make_case
        # overrides feed the factory so grid-shaping keys (nx, ny, ...)
        # stay consistent with the built arrays
        cfg, grid, forcing, state = make_case(
            args.case, device=device, **ioconfig.parse_overrides(args.set))
    devices = mesh_devices(args.devices, cfg.mesh_y, cfg.mesh_x) \
        if cfg.mesh_y * cfg.mesh_x > 1 else None
    run(cfg, grid, forcing, state, args.steps, run_dir=args.out,
        devices=devices)


if __name__ == "__main__":
    main()
