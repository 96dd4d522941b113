#!/usr/bin/env python3
"""Path (b), the rigid-lid double gyre with solver='redblack', through
run() with the eager backend on one NVIDIA GPU: the step at which it goes
non-finite and the relative residual of each solve.

    python3 tools/rigid_budget.py [N [STEPS [BUDGET [DTYPE,...]]]]

By default 2048^2, to step 110, a budget of 480 sweeps (chip_smoke.py's
RB_MAXITER), at float32 and float64, from the case's state with
diagnostics every step.  Every pressure solve (elliptic.redblack_solve)
is wrapped to record |b - A x|^2 / |b|^2 on the wet cells.  For each type
it prints the step run() raised InstabilityError at (None if it did not),
the last finite residual and the residual at the first, tenth and last
solves.  The last line is one JSON object.
"""

from __future__ import annotations

import io
import json
import math
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def one(n: int, steps: int, budget: int, dtype: str,
        device: str = "cuda") -> dict:
    import torch

    from beom_tpu_torch.cases import make_case
    from beom_tpu_torch.run import InstabilityError, run
    from beom_tpu_torch.solvers import elliptic

    dev = torch.device(device)
    cfg, grid, forcing, st = make_case(
        "rigid_lid", nx=n, ny=n, device=dev, dtype=dtype,
        solver="redblack", solver_maxiter=budget, backend="eager",
        diag_every=1)
    residuals = []
    solve = elliptic.redblack_solve

    def logged(b, grid_, cfg_, x0=None, lam=0.0, **kw):
        x = solve(b, grid_, cfg_, x0=x0, lam=lam, **kw)
        Hu, Hv = elliptic.face_depths(grid_)
        bm = b * grid_.mask
        r = bm - elliptic.laplacian_H(x, Hu, Hv, grid_, cfg_, lam=lam)
        residuals.append(float(torch.sum(r * r)) / float(torch.sum(bm * bm)))
        return x

    elliptic.redblack_solve = logged
    log = io.StringIO()
    raised = None
    t0 = time.perf_counter()
    try:
        run(cfg, grid, forcing, st, steps, log=log)
    except InstabilityError as e:
        raised = str(e)
    finally:
        elliptic.redblack_solve = solve
    diags = [json.loads(line) for line in log.getvalue().splitlines()
             if line.startswith("{")]
    finite = [r for r in residuals if math.isfinite(r)]
    return {"dtype": dtype, "n": n, "budget": budget, "steps": steps,
            "raised": raised,
            "nonfinite_step": (int(diags[-1]["n"]) if raised else None),
            "solves": len(residuals),
            "last_finite_r2_over_b2": finite[-1] if finite else None,
            "r2_over_b2_first_tenth_last": [
                residuals[i] for i in (0, min(9, len(residuals) - 1), -1)],
            "ke_first_last_finite": [diags[0]["ke"], next(
                (d["ke"] for d in reversed(diags) if d["finite"] == 1.0),
                None)],
            "seconds": time.perf_counter() - t0}


def main(n: int = 2048, steps: int = 110, budget: int = 480,
         dtypes: str = "float32,float64") -> dict:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: no CUDA card")
    out = {"runs": []}
    for dtype in dtypes.split(","):
        r = one(n, steps, budget, dtype)
        print(json.dumps(r), flush=True)
        out["runs"].append(r)
    out["device"] = torch.cuda.get_device_name(0)
    out["power"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    return out


if __name__ == "__main__":
    args = sys.argv[1:]
    print(json.dumps(main(*(int(a) for a in args[:3]), *args[3:4])))
