#!/usr/bin/env python3
"""Launch plans of the fb pass kernel (K1 with kb steps per launch), timed
on one NVIDIA GPU against the plan's cost model.

    python3 tools/k1_plans.py [CASE [DTYPE [N [DEFINE,...]]]]

For CASE (default double_gyre) at N^2 (default 2048) and DTYPE (default
float32), from chip_smoke.py's perturbed state: builds the pass kernel at
each candidate (kb, tile, threads) whose CTA fits one SM's shared memory,
all nvcc processes started together, and times a pass of 4 steps as
stencils/fused_fb.py's Plan.launches(4) runs it (ceil(4 / kb) launches,
the remainder through its own build), between CUDA events
(chip_smoke.py's time_ms), beside 4 launches of the single-step kernel;
checks each pass bitwise against the 4 single steps; prints each with its
plan_cost and the plan `fused_fb.plan` chooses.  DEFINEs (KEY=value) are
added to every pass build, and then each candidate runs with and without
them.  One JSON line last.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

# (kb, tile, threads) candidates beside the model's own per kb
CANDIDATES = (
    (2, (48, 40), 1024), (2, (64, 28), 1024), (2, (48, 40), 512),
    (2, (48, 40), 768), (2, (64, 28), 768), (2, (40, 48), 1024),
    (2, (48, 40), 896), (3, (32, 40), 1024), (4, (32, 24), 1024))


def smoke():
    spec = importlib.util.spec_from_file_location(
        "k1_plans_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(case="double_gyre", dtype="float32", n=2048, extra=()) -> dict:
    sys.path.insert(0, str(HERE))
    import torch

    from beom_tpu_torch.stencils import build, fused_fb as ff

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: no CUDA card")
    sm = smoke()
    dev = torch.device("cuda")
    cfg, grid, forcing, st = sm.perturbed_case(dev, 2, case, nx=n, ny=n,
                                               dtype=dtype)
    statics = (grid, forcing)
    elem = st.h.element_size()
    chosen = ff.plan(cfg, cfg.tdtype, 4)
    cands = set(CANDIDATES)
    for m in (2, 3, 4):
        pl = ff.launch_plan(cfg, cfg.tdtype, m)
        if pl is not None:
            cands.add((m, pl.tile, pl.threads))
    cands = sorted(c for c in cands
                   if ff.pass_smem(cfg, c[0], c[1], elem) <= ff._MAX_SMEM)

    def spec(kb, tile, threads, more=()):
        return ("fb_step", ff.term_defines(cfg, tile) + (
            f"BEOM_KB={kb}", f"BEOM_THREADS={threads}",
            f"BEOM_WIND={int(cfg.wind)}") + tuple(more))

    cands = [c + (more,) for c in cands for more in
             ([(), tuple(extra)] if extra else [()])]
    specs = [spec(*c) for c in cands] + [ff.build_spec(cfg, cfg.tdtype, 1)]
    for i in range(0, len(specs), 16):
        build.build_all(specs[i:i + 16])
    ts = ff._times(st.t, cfg, 4)

    def launch(lib, h, u, v, parity, times):
        outs = [torch.empty_like(h) for _ in range(3)]
        fn = getattr(lib, f"beom_fb_step_{ff._SUFFIX[h.dtype]}")
        fn.argtypes = [ff._P] * 7
        fn.restype = ff._I
        ints, dbls = ff._scalars(cfg, parity, times[0], ts=times,
                                 aligned=True)
        code = fn(ff._array(ff._P, [a.data_ptr() for a in [h, u, v]
                                    + ff._operands(statics)]), ints,
                  dbls, *[a.data_ptr() for a in outs],
                  torch.cuda.current_stream().cuda_stream)
        build.check(lib, code, "fb launch")
        return outs

    one = build.load(ff.build_spec(cfg, cfg.tdtype, 1))

    def singles():
        h, u, v = st.h, st.u, st.v
        for i in range(4):
            h, u, v = launch(one, h, u, v, i % 2, ts[i:i + 1])
        return h, u, v

    ref = singles()
    torch.cuda.synchronize()
    out = {"case": case, "dtype": dtype, "n": n,
           "chosen": chosen.describe(),
           "single x4": sm.time_ms(singles, 50)}
    print(f"   4 single steps: {out['single x4']!r} ms; plan: "
          f"{chosen.describe()}", flush=True)
    for kb, tile, threads, more in cands:
        lib = build.load(spec(kb, tile, threads, more))
        rest = 4 % kb
        tail = build.load(ff.build_spec(cfg, cfg.tdtype, rest)) \
            if rest > 1 else one

        def pass4():
            h, u, v = st.h, st.u, st.v
            done = 0
            for m in [kb] * (4 // kb) + ([rest] if rest else []):
                h, u, v = launch(lib if m == kb else tail, h, u, v,
                                 done % 2, ts[done:done + m])
                done += m
            return h, u, v

        got = pass4()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, ref))
        ms = sm.time_ms(pass4, 50)
        key = f"kb {kb} tile {tile[0]}x{tile[1]} threads {threads}" + \
            "".join(f" {d}" for d in more)
        out[key] = {"ms": ms, "bitwise": same,
                    "cost": ff.plan_cost(cfg, kb, tile),
                    "smem": ff.pass_smem(cfg, kb, tile, elem)}
        print(f"   {key}: {ms!r} ms per 4-step pass, bitwise {same}, cost "
              f"{out[key]['cost']:.2f}", flush=True)
    for label, (_, log) in build.BUILD_LOG.items():
        out.setdefault("ptxas", {})[label] = [
            line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line]
    out["power"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    return out


if __name__ == "__main__":
    args = sys.argv[1:]
    print(json.dumps(main(*args[:2], *[int(a) for a in args[2:3]],
                          *[a.split(",") for a in args[3:4]])))
