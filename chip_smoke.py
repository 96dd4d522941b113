#!/usr/bin/env python3
"""Smoke run of beom_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):
  1. device: a CUDA card must be present; prints its name and power limit
  2. build: compiles the fused fb step kernel (K1) from csrc/ with nvcc
  3. K1 against its plain PyTorch version on the card, from a perturbed
     rest state: 256^2 f64 (20 steps, <= 1e-12 x field scale), f32 at
     256^2 and 2048^2 (1 step <= 4 ulp of field scale, 100 steps
     <= 1e-5 relative), 200x136 f64 (sizes not multiples of the tile),
     linear / no-slip f64, and steps_per_pass=4 bitwise equal to 4
     single steps
  4. main path: beom_tpu_torch.run.run on the 2048^2 f32 double gyre,
     backend='fused', steps_per_pass=4, 400 steps, diagnostics every
     100: finite diagnostics, max_speed > 0, K1 launched once per step,
     and final fields within 1e-5 relative of 400 eager steps
  5. times of K1 and of its plain version at 2048^2 f32

The line before the last is the kernels' JSON record; the last is
{"ok": true, "device": {...}}.  It imports no jax.
"""

from __future__ import annotations

import dataclasses
import io
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BIG = 2048


def phase(name):
    print(f"== {name}", flush=True)


def perturbed_case(device, seed, **kw):
    """The double gyre plus a seeded perturbation of h, u and v (from
    rest, the first step leaves most terms at zero)."""
    import numpy as np
    import torch

    from beom_tpu_torch.cases import make_case

    cfg, grid, forcing, st = make_case("double_gyre", device=device, **kw)
    rng = np.random.default_rng(seed)

    def noise(amp, m):
        a = amp * rng.standard_normal((cfg.nz, cfg.ny, cfg.nx))
        return torch.tensor(a.astype(cfg.npdtype), device=device) * m

    st = st.replace(h=st.h + noise(0.5, grid.mask),
                    u=st.u + noise(0.05, grid.mask_u),
                    v=st.v + noise(0.05, grid.mask_v))
    return cfg, grid, forcing, st


def compare(label, device, n_steps, tol, seed=0, **kw):
    """K1 vs its plain version over n_steps; tol(ref_field) -> bound.
    Returns the largest absolute difference."""
    import torch

    from beom_tpu_torch.stencils import fused_fb

    variant = {k: kw.pop(k) for k in ("adv_scheme", "slip") if k in kw}
    cfg, grid, forcing, st = perturbed_case(device, seed, **kw)
    cfg = dataclasses.replace(cfg, **variant)
    args = (st.h, st.u, st.v, (grid, forcing), st.n, st.t, cfg, n_steps)
    out = fused_fb.fused_fb_step(*args)
    torch.cuda.synchronize()
    ref = fused_fb.fused_fb_step_plain(*args)
    worst = 0.0
    for f, a, b in zip("huv", out, ref):
        err = float((a - b).abs().max())
        bound = tol(b)
        print(f"   {label} {f}: max|K1 - plain| {err!r} "
              f"(bound {bound!r}, scale {float(b.abs().max())!r})")
        if not err <= bound:
            raise AssertionError(f"{label} {f}: {err!r} > {bound!r}")
        worst = max(worst, err)
    return worst


def time_ms(fn, n_iter):
    """Mean ms per call over n_iter calls, with CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_iter):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_iter


def main() -> dict:
    if not (ROOT / "beom_tpu_torch" / "csrc" / "fb_step.cu").is_file():
        raise SystemExit(f"beom_tpu_torch is not beside {__file__}")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    phase("1 device")
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: no CUDA card")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    from beom_tpu_torch.run import run
    from beom_tpu_torch.stencils import build, fused_fb
    from beom_tpu_torch.stepping import make_stepper

    phase("2 build")
    t0 = time.perf_counter()
    build.load("fb_step")
    print(f"   fb_step built and loaded in {time.perf_counter() - t0:.2f} s")
    if "fb_step" in build.BUILD_LOG:
        secs, log = build.BUILD_LOG["fb_step"]
        print(f"   nvcc {secs:.2f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print("   " + line.strip())

    phase("3 K1 against its plain version")

    def rel(r):
        return lambda ref: r * float(ref.abs().max())

    def ulps(k):
        return lambda ref: k * float(np.spacing(
            np.float32(ref.abs().max().item())))

    compare("256^2 f64 x20", dev, 20, rel(1e-12), nx=256, ny=256,
            dtype="float64")
    compare("256^2 f32 x1", dev, 1, ulps(4), nx=256, ny=256)
    compare("256^2 f32 x100", dev, 100, rel(1e-5), nx=256, ny=256)
    max_err = compare(f"{BIG}^2 f32 x1", dev, 1, ulps(4), nx=BIG, ny=BIG)
    compare(f"{BIG}^2 f32 x100", dev, 100, rel(1e-5), nx=BIG, ny=BIG)
    compare("200x136 f64 x20", dev, 20, rel(1e-12), nx=200, ny=136,
            dtype="float64")
    compare("200x136 f64 linear no-slip x20", dev, 20, rel(1e-12), nx=200,
            ny=136, dtype="float64", adv_scheme="linear", slip="no")

    cfg, grid, forcing, st = perturbed_case(dev, 1, nx=256, ny=256)
    four = make_stepper(grid, forcing, dataclasses.replace(
        cfg, backend="fused", steps_per_pass=4))(st)
    one = make_stepper(grid, forcing, dataclasses.replace(
        cfg, backend="fused"))
    single = st
    for _ in range(4):
        single = one(single)
    for f in "huv":
        if not torch.equal(getattr(four, f), getattr(single, f)):
            raise AssertionError(f"steps_per_pass=4 != 4 steps in {f}")
    print("   steps_per_pass=4 is bitwise equal to 4 single steps")

    phase(f"4 main path: run() on the {BIG}^2 f32 double gyre")
    from beom_tpu_torch.cases import make_case
    from beom_tpu_torch.diag import diagnostics

    cfg, grid, forcing, st = make_case(
        "double_gyre", nx=BIG, ny=BIG, device=dev, backend="fused",
        steps_per_pass=4, diag_every=100)
    n_steps = 400
    log = io.StringIO()
    torch.cuda.synchronize()
    fused_fb.LAUNCHES = 0
    t0 = time.perf_counter()
    out = run(cfg, grid, forcing, st, n_steps, log=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_fb.LAUNCHES
    diags = [json.loads(x) for x in log.getvalue().splitlines()]
    for d in diags:
        print("   " + json.dumps(d))
    if launches != n_steps:
        raise AssertionError(f"K1 launched {launches} times in {n_steps} "
                             "steps of the main path")
    if [d["n"] for d in diags] != [100, 200, 300, 400]:
        raise AssertionError("diagnostics missing")
    if not all(d["finite"] == 1.0 and all(np.isfinite(list(
            v for k, v in d.items() if k != "kind"))) for d in diags):
        raise AssertionError("non-finite diagnostics")
    if not diags[-1]["max_speed"] > 0:
        raise AssertionError("max_speed is 0: the run did nothing")
    if out.h.shape != (1, BIG, BIG) or out.n != n_steps:
        raise AssertionError("wrong final state")
    mass0 = diagnostics(st, grid, cfg)["mass"]
    drift = (diags[-1]["mass"] - mass0) / mass0
    sum0 = float(st.h.double().sum())
    drift64 = (float(out.h.double().sum()) - sum0) / sum0
    print(f"   K1 launches {launches}; relative mass drift {drift!r} "
          f"(diagnostic), {drift64!r} (f64 sum of h); {n_steps} steps in "
          f"{wall:.3f} s wall (diagnostics included)")
    eager = make_stepper(grid, forcing, dataclasses.replace(
        cfg, backend="eager", steps_per_pass=1))
    ref = st
    for _ in range(n_steps):
        ref = eager(ref)
    for f in "huv":
        a, b = getattr(out, f), getattr(ref, f)
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        print(f"   main path vs {n_steps} eager steps, {f}: max|diff| "
              f"{err!r} (scale {scale!r})")
        if not err <= 1e-5 * scale:
            raise AssertionError(f"main path {f} off the eager run")

    phase(f"5 times at {BIG}^2 f32")
    cfg, grid, forcing, st = perturbed_case(dev, 2, nx=BIG, ny=BIG)
    args = (st.h, st.u, st.v, (grid, forcing), st.n, st.t, cfg, 1)
    n_calls = fused_fb.LAUNCHES
    runs = []
    for which in ("plain", "K1", "K1", "plain"):
        fn = fused_fb.fused_fb_step_plain if which == "plain" \
            else fused_fb.fused_fb_step
        runs.append((which, time_ms(lambda: fn(*args),
                                    20 if which == "plain" else 200)))
    fused_fb.LAUNCHES = n_calls
    pts = cfg.nx * cfg.ny
    for which, ms in runs:
        print(f"   {which}: {ms!r} ms/step, {pts / ms * 1e3!r} points/s "
              f"({smi})")
    k1 = [ms for w, ms in runs if w == "K1"]
    plain = [ms for w, ms in runs if w == "plain"]
    return {"kernels": [{
        "name": "fb_step", "route": "cuda",
        "source": "beom_tpu_torch/csrc/fb_step.cu",
        "replaces": "beom_tpu/stencils/band.py:200",
        "launches": launches, "max_abs_err": max_err,
        "ms": sum(k1) / len(k1), "plain_ms": sum(plain) / len(plain)}]}


if __name__ == "__main__":
    record = main()
    import torch

    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
