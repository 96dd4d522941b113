"""Experiment driver: the port's twin of beom_tpu/run.py.

    main -> build case -> chunked time loop:
        state = advance(state)     # chunk steps, on the device
        diagnostics -> JSONL; NaN guard; snapshots at cadence

Each chunk runs `chunk // steps_per_pass` passes of make_stepper's step
plus single-step calls for the remainder; the host sees a handful of
diagnostic scalars per chunk, plus snapshot fields at cfg.snap_every.  On
a non-finite state the run aborts, keeping last_good.npz for restart.

    python -m beom_tpu_torch.run double_gyre -n 400 --set steps_per_pass=4
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
        log=None, chunk: Optional[int] = None) -> State:
    """Advance `n_steps`, chunked for I/O; returns the final state.

    Diagnostics go to `log` (default: sys.stdout at call time); chunk
    defaults to the diagnostics/snapshot cadence (or 100).
    """
    log = sys.stdout if log is None else log
    if cfg.mesh_x * cfg.mesh_y > 1:
        raise NotImplementedError(
            "a device mesh (mesh_x * mesh_y > 1) is not ported to "
            "beom_tpu_torch yet: ROADMAP queue 1 item 14 (slice 5)")
    cadences = [c for c in (cfg.diag_every, cfg.snap_every) if c > 0]
    if chunk is None:
        chunk = min(cadences) if cadences else 100
    chunk = max(1, min(chunk, n_steps))

    if run_dir:
        os.makedirs(run_dir, exist_ok=True)
        if resume := snapshots.latest_snapshot(run_dir):
            state = snapshots.load_state(resume, device=grid.H.device)
            print(f"# resumed from {resume} at step {state.n}", file=log)
    state = prepare_state(state, cfg)

    spp = cfg.steps_per_pass
    pstep = make_stepper(grid, forcing, cfg)       # advances spp steps
    pstep1 = pstep if spp == 1 else make_stepper(
        grid, forcing, dataclasses.replace(cfg, steps_per_pass=1))

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
        d = diagnostics(state, grid, cfg)
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
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {args.device}: torch.cuda.is_available() is false")

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
    run(cfg, grid, forcing, state, args.steps, run_dir=args.out)


if __name__ == "__main__":
    main()
