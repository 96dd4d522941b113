#!/usr/bin/env python3
"""Times of the parts of the in-kernel multigrid cycle (csrc/mg_cycle.cuh)
on one NVIDIA GPU, at 2048^2 f32 on the rigid lid's hierarchy.

    python3 tools/cycle_parts.py

Each part is a step list walked by one launch of K5's kernel
(csrc/mg_coarse.cu) on the K6 hierarchy's tables, the part repeated so
that the launch takes milliseconds: per step, the mean time between CUDA
events over the launches, less nothing (a step's time includes its grid
sync or block barrier).  Parts: a grid step that does nothing (the grid
sync), the tiled passes OP_PRE and OP_POST per level, the plain steps
(a half-sweep, the residual, the restriction, the prolongation) per
level as the whole grid runs them, a visit of the shared-memory tier
(OP_TIER_IN to OP_TIER_OUT as the K6 cycle makes it), the tier's load and
store alone, and a half-sweep in the tier per tier level, alone and in a
run of 48 (OP_SWEEPS).  One JSON line.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

N = 2048


def main() -> dict:
    import torch

    from beom_tpu_torch.cases import make_case
    from beom_tpu_torch.stencils import build, cg_fused
    from beom_tpu_torch.stencils import mg_coarse as mc

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: no CUDA card")
    dev = torch.device("cuda")
    cfg, grid, _, _ = make_case("rigid_lid", nx=N, ny=N, device=dev)
    levels, gamma = cg_fused.mg_levels(grid, cfg, 0.0)
    dtype = grid.mask.dtype
    tier, plan = mc.plan(levels, 0.0, 2, 24, gamma, False,
                         mc._query(dtype, "smem"))
    lib, fn = mc._entry(dtype)
    partials = torch.empty(2 * mc.NDOT * mc._query(dtype, "blocks"),
                           dtype=dtype, device=dev)
    g = torch.Generator(device="cpu").manual_seed(3)

    def launch_ms(steps, n_launch=5):
        tables = mc.CycleTables(levels, steps, 2, tier)
        for k, lv in enumerate(levels):
            for f in (mc.BC, mc.XC, mc.RC, mc.X, mc.R):
                tables.field(k, f).copy_(torch.randn(
                    tuple(lv.mask.shape), generator=g, dtype=dtype).to(dev)
                    * lv.mask)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def go():
            build.check(lib, fn(*tables.args(), 0.0, partials.data_ptr(),
                                partials.numel(), stream), "cycle part")
        go()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_launch):
            go()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n_launch / len(steps)

    out = {"device": torch.cuda.get_device_name(0), "tier": tier,
           "tier_shape": list(levels[tier].mask.shape),
           "ms_per_step": {}}
    ms = out["ms_per_step"]
    last = len(levels) - 1
    ms["grid sync (OP_ZERO on the coarsest level)"] = launch_ms(
        [(mc.OP_ZERO, last, mc.X, 0, 0, 0)] * 200)
    for k in range(tier):
        shape = "x".join(map(str, levels[k].mask.shape))
        ms[f"OP_PRE {shape}"] = launch_ms(
            [(mc.OP_PRE, k, mc.R, mc.BC, 0, 0)] * 20)
        ms[f"OP_PRE {shape}, gamma residual"] = launch_ms(
            [(mc.OP_PRE, k, mc.R, mc.RC, 1, 0)] * 20)
        ms[f"OP_POST {shape}"] = launch_ms(
            [(mc.OP_POST, k, mc.XC, mc.BC, 0, 0)] * 20)
        ms[f"plain half-sweep {shape}"] = launch_ms(
            [(mc.OP_SWEEP, k, mc.XC, mc.BC, mc.RED, 0)] * 20)
        ms[f"plain residual {shape}"] = launch_ms(
            [(mc.OP_RESID, k, mc.XC, mc.BC, mc.R, 0)] * 20)
        ms[f"plain restriction {shape}"] = launch_ms(
            [(mc.OP_RESTRICT, k, mc.R, mc.BC, 0, 0)] * 20)
        ms[f"plain prolongation {shape}"] = launch_ms(
            [(mc.OP_PROLONG, k, mc.XC, mc.XC, 0, 0)] * 20)
    first = next(i for i, st in enumerate(plan) if st[0] == mc.OP_TIER_IN)
    stop = next(i for i, st in enumerate(plan) if st[0] == mc.OP_TIER_OUT)
    visit = plan[first:stop + 1]
    out["tier_visit_steps"] = len(visit)
    ms["tier visit (per visit, not per step)"] = launch_ms(
        visit * 10) * len(visit)
    ms["tier load + store (per pair)"] = launch_ms(
        [plan[first], plan[stop]] * 50) * 2
    for k in range(tier, len(levels)):
        shape = "x".join(map(str, levels[k].mask.shape))
        ms[f"tier half-sweep {shape}"] = launch_ms(
            [plan[first]] + [(mc.OP_SWEEP, k, mc.XC, mc.BC, mc.RED, 1)] * 400
            + [plan[stop]]) * 402 / 400
        ms[f"tier half-sweep {shape} in a run of 48 (OP_SWEEPS)"] = launch_ms(
            [plan[first]] + [(mc.OP_SWEEPS, k, mc.XC, mc.BC, 48 << 2, 1)] * 20
            + [plan[stop]]) * 22 / 20 / 48
    out["power"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    return out


if __name__ == "__main__":
    print(json.dumps(main()))
