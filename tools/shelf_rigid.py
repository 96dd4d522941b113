#!/usr/bin/env python3
"""The shelf under the rigid lid through the fused backend on one NVIDIA
GPU: the iterations and the final residual of every pressure solve.

    python3 tools/shelf_rigid.py [STEPS [N [DTYPE]]]

shelf_forced with scheme='rigid_lid' and backend='fused' (K3a, K6 with the
multigrid preconditioner behind the stall guard, K3b), by default 4 steps
at 2048^2 float64.  For each solve it prints K6's iterations and |r|^2 /
|b|^2 beside the guard's limit (100 tol^2), and, where the guard redid the
solve with the W-cycle (K4a, K5 and the eager CG), that solve's
iterations and |r|^2 / |b|^2.  The last line is one JSON object.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(n_steps: int = 4, n: int = 2048, dtype: str = "float64") -> dict:
    import torch

    from beom_tpu_torch.cases import make_case
    from beom_tpu_torch.solvers import elliptic
    from beom_tpu_torch.stencils import cg_fused
    from beom_tpu_torch.stencils import fused_projection as fp
    from beom_tpu_torch.stepping import make_stepper, prepare_state

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: no CUDA card")
    dev = torch.device("cuda")
    cfg, grid, forcing, st = make_case("shelf_forced", nx=n, ny=n,
                                       device=dev, dtype=dtype,
                                       scheme="rigid_lid", backend="fused")
    tol = max(cfg.solver_tol,
              30.0 * float(torch.finfo(grid.mask.dtype).eps))
    solves, redone = [], []

    def b2_of(b):
        return float(torch.sum((b * grid.mask) ** 2))

    make_fused = cg_fused.make_cg_solve

    def make_logged(*args, **kw):
        solve = make_fused(*args, **kw)

        def logged(b, x0=None):
            res = solve(b, x0=x0)
            solves.append({"k6_iters": res.iters,
                           "k6_r2_over_b2": float(res.resnorm) / b2_of(b)})
            return res
        logged.steps = solve.steps
        return logged

    eager_cg = elliptic.cg_solve

    def guard_logged(b, *args, **kw):
        res = eager_cg(b, *args, **kw)
        redone.append({"guard_iters": res.iters,
                       "guard_r2_over_b2": float(res.resnorm) / b2_of(b)})
        return res

    cg_fused.make_cg_solve = make_logged
    elliptic.cg_solve = guard_logged
    try:
        step = make_stepper(grid, forcing, cfg)
        st = prepare_state(st, cfg)
        stalled0 = fp.COUNTS["stalled"]
        t0 = time.perf_counter()
        for i in range(n_steps):
            n_redone = len(redone)
            st = step(st)
            torch.cuda.synchronize()
            if len(redone) > n_redone:
                solves[-1].update(redone[-1])
            print(f"step {i + 1}: {json.dumps(solves[-1])} "
                  f"({time.perf_counter() - t0:.1f} s in)", flush=True)
    finally:
        cg_fused.make_cg_solve = make_fused
        elliptic.cg_solve = eager_cg
    column = float(((st.h.sum(0) - grid.H) * grid.mask).abs().max())
    return {"case": "shelf_forced", "scheme": "rigid_lid", "n": n,
            "dtype": dtype, "steps": n_steps, "maxiter": cfg.solver_maxiter,
            "guard_limit_r2_over_b2": 100.0 * tol * tol,
            "stalled": fp.COUNTS["stalled"] - stalled0, "solves": solves,
            "finite": bool(torch.isfinite(st.h).all()),
            "max_abs_sum_h_minus_H": column,
            "seconds": time.perf_counter() - t0,
            "device": torch.cuda.get_device_name(0),
            "power": subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60).stdout.strip()}


if __name__ == "__main__":
    args = sys.argv[1:]
    print(json.dumps(main(*(int(a) for a in args[:2]), *args[2:3])))
