#!/usr/bin/env python3
"""Smoke run of beom_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):
  1. device: a CUDA card must be present; prints its name and power limit
  2. build: compiles every kernel under beom_tpu_torch/csrc/ with nvcc,
     one process per source, all started together; K1's build lines
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
  6. build lines of the projection kernels: K3a/K3b (projection.cu),
     K4a (rb_sweep.cu), K6 (cg_fused.cu)
  7. the projection kernels against their plain versions on the card,
     on the perturbed rigid-lid gyre: K3a and K3b at 256^2 f64
     (<= 1e-12 x scale), 256^2 and 2048^2 f32 (<= 4 ulp of field scale),
     200x136 f64 and linear / no-slip, both sweep parities; one K4a pass
     (k = 8) at 256^2 f64 and 2048^2 f32, forward and reverse, lam = 0
     and > 0; K6 at 256^2 f64 and 2048^2 f32, lam = 0 and 1/(g dt^2),
     cold and warm: the true residual, x against the plain CG, the
     iteration counts, two launches bitwise equal
  8. the projection path: run() on the 2048^2 f32 rigid-lid gyre with
     backend='fused', (a) scheme='implicit_fs' (CG + Jacobi: K3a, K6,
     K3b), 20 steps, and (b) solver='redblack' (K3a, K4a, K3b), 10 steps:
     finite diagnostics, max_speed > 0, max|sum h - H| bounded, the
     launch counts, and 3 fused steps against 3 eager steps
  9. times at 2048^2 f32: K3a, K3b, a K4a pass and a K6 solve beside
     their plain versions, and ms/step of (a) and (b) through run()
 10. build lines of the multigrid kernels: K4a's residual mode and K4b
     (rb_sweep.cu), K5 (mg_coarse.cu), K6-mg (cg_fused.cu, both sharing
     mg_cycle.cuh)
 11. the multigrid kernels against their plain versions at 256^2 f64,
     2048^2 f32 and 200x136 f64, lam = 0 and > 0: K4a with its residual
     (forward and reverse) and K4b (both modes) bit for bit; K5 on the
     512^2 tail of the 2048^2 hierarchy and on the whole 200x136 one,
     de-mean off (bit for bit) and on (bounded), two launches equal; K6
     with the multigrid preconditioner against the plain PCG (iterations
     within 1, x bounded, bitwise reproducible, a warm start from the
     solution <= 1 iteration); the composed fused preconditioner against
     the eager cycle with the same gamma schedule
 12. the multigrid paths: run() on the 2048^2 f32 rigid lid with (c) its
     default solve (CG + multigrid: K3a, K6, K3b), 20 steps, and (d)
     solver='mg' (K3a, K4b, K4a on levels 0 and 1, K5, K3b), 10 steps:
     the launch counts against the cycles, finite diagnostics,
     max|sum h - H| bounded, 3 fused steps against 3 eager ones
 13. times at 2048^2 f32: K4a with its residual, K4b, K5 (with and
     without its one-CTA small levels), a K6-mg solve (per iteration), a
     solver='mg' solve (per cycle) beside their plain versions, (c) and
     (d) in ms/step through run(), and the grid syncs per cycle

 14. build lines of the fb and split builds of the other cases (fb_step.cu
     and split_step.cu, one library per combination of compile-time
     switches, all built in phase 2 beside the others)
 15. K1 on two_layer, coastal_wetdry and shelf_forced (both sweep parities,
     steps_per_pass 1 and 4) and K1s, as its three kernels and as the
     chained step, on double_gyre and two_layer (nsub 4 and 8) against
     their plain versions at 200x136 f64 (<= 1e-12 x scale) and 2048^2 f32
     (<= 4 ulp of scale), from a perturbed state with dry cells and the
     open boundary inside the compared region
 16. the other paths at full width: run() with backend='fused' at 2048^2
     f32, diagnostics on: two_layer fb; double_gyre split with nsub 4, 8
     and 12; two_layer split nsub 8; coastal_wetdry and shelf_forced fb:
     the launch counts, finite diagnostics, the mass drift of the closed
     basins, h >= 0 under wet/dry, 3 fused steps against 3 eager ones
 17. times at 2048^2 f32: K1 per case and K1s's three kernels beside their
     plain versions, the split step at nsub 4, 8, 12, and the device's
     busy share under torch.profiler for two_layer fb and split nsub 8

The line before the last is the kernels' JSON record, each kernel with its
time, its plain version's, and the least time the card could take for the
same work (`bound`); the last is {"ok": true, "device": {...}}.  It
imports no jax.
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
KERNELS = ("fb_step", "projection", "rb_sweep", "cg_fused", "mg_coarse")
# the H100 SXM data sheet: device memory, and float32 outside the tensor
# cores; a kernel's bound is the larger of its bytes and its operations
# over these
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# the paths of phase 16: (case, Config overrides, steps)
PATHS = (
    ("two_layer", {}, 40),
    ("double_gyre", dict(scheme="split", nsub=4), 20),
    ("double_gyre", dict(scheme="split", nsub=8), 20),
    ("double_gyre", dict(scheme="split", nsub=12), 20),
    ("two_layer", dict(scheme="split", nsub=8), 20),
    ("coastal_wetdry", {}, 20),
    ("shelf_forced", {}, 20),
)
# the (case, nsub) pairs phase 15 holds K1s against its plain version on
AGREE_SPLIT = (("double_gyre", 4), ("double_gyre", 8), ("two_layer", 4),
               ("two_layer", 8))
# (b)'s sweep budget: a multiple of the 8 sweeps per K4a pass, so that
# the fused solve's passes do the eager solve's sweeps when neither
# converges early
RB_MAXITER = 480


def phase(name):
    print(f"== {name}", flush=True)


def kernel_entry(name, src, site, launches, err, ms, n_bytes, n_ops):
    """One kernel of the JSON record.  ms = (kernel, plain).  bound_ms is
    the larger of n_bytes (each input read once, each output written once)
    over the memory rate and n_ops over the float32 rate.  None of these
    kernels has a single PyTorch call that computes the same function."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / F32_OPS_PER_S * 1e3
    return {"name": name, "route": "cuda",
            "source": f"beom_tpu_torch/csrc/{src}",
            "replaces": f"beom_tpu/stencils/{site}", "launches": launches,
            "max_abs_err": err, "ms": ms[0], "plain_ms": ms[1],
            "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": None}


def step_fields(cfg):
    """Fields one fb or split step must move: h, u, v in and out, the
    grid's six, and the forcing fields of the switches that are on."""
    n = 6 * cfg.nz + 6 + 2 * cfg.wind + cfg.sponge
    n += cfg.nz * (cfg.sponge or cfg.obc)
    return n + cfg.obc * (3 + 2 * len(cfg.tides))


def cycle_ops(steps, levels):
    """Operations of one walk of a multigrid cycle's step list: about 10
    per point of each step's level."""
    return 10 * sum(levels[st[1]].mask.numel() for st in steps)


def perturbed_case(device, seed, case="double_gyre", **kw):
    """A case plus a seeded perturbation of h, u and v (from rest, the
    first step leaves most terms at zero)."""
    import numpy as np
    import torch

    from beom_tpu_torch.cases import make_case

    cfg, grid, forcing, st = make_case(case, device=device, **kw)
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


def print_build(build, name):
    """nvcc's time and the register and spill lines of one source."""
    if name not in build.BUILD_LOG:
        print(f"   {name}: loaded from the build cache")
        return
    secs, log = build.BUILD_LOG[name]
    print(f"   {name}: nvcc {secs:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("   " + line.strip())


def compare_fields(label, names, outs, refs, tol):
    """max|kernel - plain| of each field against tol(plain field).
    Returns the largest."""
    worst = 0.0
    for f, a, b in zip(names, outs, refs):
        err = float((a - b).abs().max())
        bound = tol(b)
        print(f"   {label} {f}: max|kernel - plain| {err!r} "
              f"(bound {bound!r}, scale {float(b.abs().max())!r})")
        if not err <= bound:
            raise AssertionError(f"{label} {f}: {err!r} > {bound!r}")
        worst = max(worst, err)
    return worst


def check_phases(label, device, tol, seed, **kw):
    """K3a and K3b against their plain versions at both sweep parities.
    Returns (worst K3a, worst K3b) differences."""
    import numpy as np
    import torch

    from beom_tpu_torch.stencils import fused_projection as fp

    variant = {k: kw.pop(k) for k in ("adv_scheme", "slip") if k in kw}
    cfg, grid, forcing, st = perturbed_case(device, seed, "rigid_lid", **kw)
    cfg = dataclasses.replace(cfg, **variant)
    statics = (grid, forcing)
    rng = np.random.default_rng(seed + 100)
    p = torch.tensor((0.1 * rng.standard_normal((cfg.ny, cfg.nx))).astype(
        cfg.npdtype), device=device) * grid.mask
    worst_a = worst_b = 0.0
    for n in (0, 1):
        a = fp.proj_a(st.h, st.u, st.v, statics, n, cfg)
        torch.cuda.synchronize()
        a_ref = fp.proj_a_plain(st.h, st.u, st.v, statics, n, cfg)
        worst_a = max(worst_a, compare_fields(
            f"{label} {cfg.scheme} n={n} K3a", ("u*", "v*", "div"), a,
            a_ref, tol))
        b = fp.proj_b(st.h, a_ref[0], a_ref[1], p, statics, st.t, cfg)
        torch.cuda.synchronize()
        b_ref = fp.proj_b_plain(st.h, a_ref[0], a_ref[1], p, statics, st.t,
                                cfg)
        worst_b = max(worst_b, compare_fields(
            f"{label} {cfg.scheme} n={n} K3b", ("h1", "u1", "v1"), b,
            b_ref, tol))
    return worst_a, worst_b


def check_rb(label, device, tol, seed, **kw):
    """One k = 8 K4a pass against 8 plain sweeps, forward and reverse,
    lam = 0 and 1/(g dt^2).  Returns the largest difference."""
    import numpy as np
    import torch

    from beom_tpu_torch.solvers import elliptic
    from beom_tpu_torch.stencils import redblack

    cfg, grid, _, _ = perturbed_case(device, seed, "rigid_lid", **kw)
    Hu, Hv = elliptic.face_depths(grid)
    rng = np.random.default_rng(seed)

    def field(amp):
        a = amp * rng.standard_normal((cfg.ny, cfg.nx))
        return torch.tensor(a.astype(cfg.npdtype), device=device) * grid.mask

    x, b = field(1.0), field(1e-6)
    worst = 0.0
    for lam in (0.0, 1.0 / (cfg.g * cfg.dt ** 2)):
        for reverse in (False, True):
            kw_s = dict(lam=lam, k=8, omega=cfg.sor_omega, reverse=reverse)
            out = redblack.rb_sweep(x, b, Hu, Hv, grid.mask, cfg.dx, cfg.dy,
                                    **kw_s)
            torch.cuda.synchronize()
            ref = redblack.rb_sweep_plain(x, b, Hu, Hv, grid.mask, cfg.dx,
                                          cfg.dy, **kw_s)
            worst = max(worst, compare_fields(
                f"{label} lam={lam:.4g} "
                f"{'reverse' if reverse else 'forward'} K4a", ("x",),
                [out], [ref], tol))
    return worst


def check_cg(label, device, x_rel, seed, precond="jacobi", **kw):
    """K6 against the plain CG on the two solves of a projection step
    from a perturbed state, cold and warm (from the cold solution).
    x_rel(lam) bounds |x - x_plain| / scale.  The true residual is
    recomputed in f64 with the plain laplacian_H; it is held to
    20 tol_eff |b|, or to twice the plain CG's own where the plain CG
    itself stops above that (f32 recurrences drift from the true
    residual over thousands of iterations).  With precond='mg' the
    iteration counts must agree within 1 and the warm start take at most
    1 iteration.  Returns the largest difference."""
    import torch

    from beom_tpu_torch.core.grid import Grid
    from beom_tpu_torch.solvers import elliptic
    from beom_tpu_torch.stencils import cg_fused
    from beom_tpu_torch.stencils import fused_projection as fp
    from beom_tpu_torch.stepping import projection

    cfg, grid, forcing, st = perturbed_case(
        device, seed, "rigid_lid", solver_maxiter=20000, **kw)
    _, _, div = fp.proj_a_plain(st.h, st.u, st.v, (grid, forcing), 0, cfg)
    lam_h = 1.0 / (cfg.g * cfg.dt ** 2)
    problems = [(0.0, projection.rigid_rhs(st.h, div, grid, cfg)),
                (lam_h, projection.implicit_rhs(st.h, div, grid, cfg,
                                                lam_h)[0])]
    g64 = Grid(**{f: getattr(grid, f).double()
                  for f in ("H", "mask", "mask_u", "mask_v", "mask_q",
                            "f_q")})
    cfg64 = dataclasses.replace(cfg, dtype="float64")
    Hu64, Hv64 = elliptic.face_depths(g64)
    m64 = g64.mask
    tol_eff = max(cfg.solver_tol, 30.0 * float(torch.finfo(cfg.tdtype).eps))

    def true_res(x, b64, lam):
        r = (b64 - elliptic.laplacian_H(x.double(), Hu64, Hv64, g64, cfg64,
                                        lam=lam)) * m64
        return float(r.norm())

    worst = 0.0
    for lam, b in problems:
        b64 = b.double() * m64
        if lam == 0.0:      # the compatible system the solve deflates to
            b64 = (b64 - m64 * (b64.sum() / m64.sum())) * m64
        solve = cg_fused.make_cg_solve(grid, cfg, lam=lam, precond=precond)
        x0 = None
        for start in ("cold", "warm"):
            res = solve(b, x0)
            again = solve(b, x0)
            ref = cg_fused.cg_solve_plain(b, grid, cfg, x0=x0, lam=lam,
                                          precond=precond)
            tag = f"{label} lam={lam:.4g} {start} K6 {precond}"
            if not torch.equal(res.x, again.x):
                raise AssertionError(f"{tag}: two launches differ")
            rk, rp = true_res(res.x, b64, lam), true_res(ref.x, b64, lam)
            bn = float(b64.norm())
            bound = max(20.0 * tol_eff * bn, 2.0 * rp)
            err = float((res.x - ref.x).abs().max())
            scale = float(ref.x.abs().max())
            print(f"   {tag}: iterations {res.iters} (plain {ref.iters}); "
                  f"true residual {rk / bn!r} |b| (plain {rp / bn!r}, "
                  f"bound {bound / bn!r}); max|x - plain| {err!r} = "
                  f"{err / scale!r} x scale (bound {x_rel(lam)!r}); "
                  "two launches bitwise equal")
            if not rk <= bound:
                raise AssertionError(f"{tag}: residual {rk!r} > {bound!r}")
            if not err <= x_rel(lam) * scale:
                raise AssertionError(f"{tag}: x off the plain CG")
            if precond == "mg" and abs(res.iters - ref.iters) > 1:
                raise AssertionError(f"{tag}: iterations off the plain CG")
            if start == "cold":
                cold_iters = res.iters
            elif precond == "mg" and res.iters > 1:
                raise AssertionError(f"{tag}: the warm start took "
                                     f"{res.iters} iterations")
            elif not (res.iters < cold_iters or res.iters == 0):
                raise AssertionError(f"{tag}: the warm start did not cut "
                                     "the iterations")
            worst = max(worst, err)
            x0 = res.x
    return worst


def run_projection(label, device, n_steps, diag_every, **kw):
    """run() on the 2048^2 f32 rigid-lid gyre with backend='fused', with
    every kernel count set to 0 just before and read just after.
    Returns (case, final state, counts, wall seconds)."""
    import numpy as np
    import torch

    from beom_tpu_torch.cases import make_case
    from beom_tpu_torch.run import run
    from beom_tpu_torch.solvers import multigrid
    from beom_tpu_torch.stencils import cg_fused, mg_coarse, redblack
    from beom_tpu_torch.stencils import fused_projection as fp

    case = make_case("rigid_lid", nx=BIG, ny=BIG, device=device,
                     backend="fused", diag_every=diag_every, **kw)
    cfg, grid, forcing, st = case
    log = io.StringIO()
    torch.cuda.synchronize()
    fp.LAUNCHES.update(proj_a=0, proj_b=0)
    cg_fused.LAUNCHES = redblack.LAUNCHES = redblack.PASSES = 0
    redblack.APPLY_LAUNCHES = mg_coarse.LAUNCHES = multigrid.CYCLES = 0
    t0 = time.perf_counter()
    out = run(cfg, grid, forcing, st, n_steps, log=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(fp.LAUNCHES, cg_fused=cg_fused.LAUNCHES,
                  rb_sweep=redblack.LAUNCHES, passes=redblack.PASSES,
                  apply_op=redblack.APPLY_LAUNCHES,
                  mg_coarse=mg_coarse.LAUNCHES, cycles=multigrid.CYCLES)
    diags = [json.loads(x) for x in log.getvalue().splitlines()]
    for d in diags:
        print("   " + json.dumps(d))
    steps = list(range(diag_every, n_steps + 1, diag_every))
    if [d["n"] for d in diags] != steps:
        raise AssertionError(f"{label}: diagnostics missing")
    if not all(d["finite"] == 1.0 and all(np.isfinite(list(
            v for k, v in d.items() if k != "kind"))) for d in diags):
        raise AssertionError(f"{label}: non-finite diagnostics")
    if not diags[-1]["max_speed"] > 0:
        raise AssertionError(f"{label}: max_speed is 0: the run did nothing")
    if out.h.shape != (1, BIG, BIG) or out.n != n_steps \
            or out.phi is None:
        raise AssertionError(f"{label}: wrong final state")
    column = float(((out.h.sum(0) - grid.H) * grid.mask).abs().max())
    print(f"   {label}: launches {counts}; max|sum h - H| {column!r} m; "
          f"{n_steps} steps in {wall:.3f} s wall (first run, diagnostics "
          "included)")
    return case, out, counts, column


def versus_eager(label, case, n_steps, atol_ulp):
    """n_steps of the fused stepper against n_steps of the eager one,
    within tests/unit/test_pallas.py's envelope atol_ulp x max(scale, 1).
    Returns the eager ms/step."""
    import torch

    from beom_tpu_torch.stepping import make_stepper, prepare_state

    cfg, grid, forcing, st = case
    st = prepare_state(st, cfg)
    fused = make_stepper(grid, forcing, cfg)
    eager = make_stepper(grid, forcing, dataclasses.replace(
        cfg, backend="eager"))
    a = b = st
    for _ in range(n_steps):
        a = fused(a)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        b = eager(b)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) / n_steps * 1e3
    for f in "huv":
        x, y = getattr(a, f), getattr(b, f)
        err = float((x - y).abs().max())
        scale = float(y.abs().max())
        print(f"   {label} vs {n_steps} eager steps, {f}: max|diff| {err!r} "
              f"= {err / max(scale, 1e-30)!r} x scale (scale {scale!r}, "
              f"bound {atol_ulp!r} x max(scale, 1))")
        if not err <= atol_ulp * max(scale, 1.0):
            raise AssertionError(f"{label} {f} off the eager path")
    return eager_ms


def time_pair(label, plain, kernel, n_plain, n_kernel, unit="call"):
    """Times in the order plain, kernel, kernel, plain; returns the means
    (kernel ms, plain ms)."""
    runs = []
    for which in ("plain", "kernel", "kernel", "plain"):
        fn, n = (plain, n_plain) if which == "plain" else (kernel, n_kernel)
        runs.append((which, time_ms(fn, n)))
    for which, ms in runs:
        print(f"   {label} {which}: {ms!r} ms/{unit}")
    k = [ms for w, ms in runs if w == "kernel"]
    p = [ms for w, ms in runs if w == "plain"]
    return sum(k) / len(k), sum(p) / len(p)


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
    from beom_tpu_torch.cases import make_case
    specs = {fused_fb.build_spec(make_case(
        name, nx=16, ny=16, device="cpu", dtype=dtype, **kw)[0])
        for name, kw in [(n, k) for n, k, _ in PATHS]
        + [("double_gyre", {})]
        + [(n, dict(scheme="split", nsub=k)) for n, k in AGREE_SPLIT]
        for dtype in ("float32", "float64")}
    todo = [k for k in KERNELS if k != "fb_step"] + sorted(specs)
    build.build_all(todo)
    for item in todo:
        build.load(item)
    print(f"   {', '.join(KERNELS)} and split_step ({len(todo)} libraries) "
          f"built and loaded in {time.perf_counter() - t0:.2f} s")
    print_build(build, build.label(fused_fb.build_spec(make_case(
        "double_gyre", nx=16, ny=16, device="cpu")[0])))

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
    kernels = [kernel_entry(
        "fb_step", "fb_step.cu", "band.py:200", launches, max_err,
        (sum(k1) / len(k1), sum(plain) / len(plain)),
        step_fields(cfg) * pts * 4, 150 * pts)]
    kernels += projection_phases(dev, smi, rel, ulps)
    kernels += multigrid_phases(dev, smi, rel, ulps)
    kernels += case_phases(dev, smi, rel, ulps)
    return {"kernels": kernels}


def projection_phases(dev, smi, rel, ulps):
    """Phases 6 to 9; returns the kernels' JSON entries."""
    import torch

    from beom_tpu_torch.run import run
    from beom_tpu_torch.solvers import elliptic
    from beom_tpu_torch.stencils import build, cg_fused, redblack
    from beom_tpu_torch.stencils import fused_projection as fp
    from beom_tpu_torch.stepping import projection

    phase("6 build: the projection kernels")
    for name in ("projection", "rb_sweep", "cg_fused"):
        print_build(build, name)

    phase("7 the projection kernels against their plain versions")
    err = {}
    check_phases("256^2 f64", dev, rel(1e-12), 20, nx=256, ny=256,
                 dtype="float64")
    check_phases("256^2 f32", dev, ulps(4), 21, nx=256, ny=256,
                 scheme="implicit_fs")
    err["proj_a"], err["proj_b"] = check_phases(
        f"{BIG}^2 f32", dev, ulps(4), 22, nx=BIG, ny=BIG)
    worst = check_phases(f"{BIG}^2 f32", dev, ulps(4), 23, nx=BIG, ny=BIG,
                         scheme="implicit_fs")
    err["proj_a"] = max(err["proj_a"], worst[0])
    err["proj_b"] = max(err["proj_b"], worst[1])
    check_phases("200x136 f64", dev, rel(1e-12), 24, nx=200, ny=136,
                 dtype="float64", scheme="implicit_fs")
    check_phases("200x136 f64 linear no-slip", dev, rel(1e-12), 25, nx=200,
                 ny=136, dtype="float64", adv_scheme="linear", slip="no")
    check_rb("256^2 f64", dev, rel(1e-12), 26, nx=256, ny=256,
             dtype="float64")
    err["rb_sweep"] = check_rb(f"{BIG}^2 f32", dev, ulps(4), 27, nx=BIG,
                               ny=BIG)
    check_cg("256^2 f64", dev, lambda lam: 1e-6, 28, nx=256, ny=256,
             dtype="float64")
    # f32 bounds (PERF.md): 1e-3 x scale for the lam = 0 solve,
    # 1e-4 x scale for the Helmholtz one
    err["cg_fused"] = check_cg(f"{BIG}^2 f32", dev,
                               lambda lam: 1e-3 if lam == 0.0 else 1e-4,
                               29, nx=BIG, ny=BIG)

    phase(f"8 the projection path: run() on the {BIG}^2 f32 rigid-lid gyre")
    case_a, _, counts_a, col_a = run_projection(
        "(a) implicit_fs, CG + Jacobi", dev, 20, 10, scheme="implicit_fs")
    if not (counts_a["proj_a"] == counts_a["proj_b"] == counts_a["cg_fused"]
            == 20 and counts_a["rb_sweep"] == 0):
        raise AssertionError(f"(a) launch counts {counts_a}")
    if not col_a < 1.0:          # the free surface: wind set-up, mm to cm
        raise AssertionError(f"(a) max|sum h - H| {col_a!r} m")
    eager_a = versus_eager("(a) 3 fused steps", case_a, 3, 1e-5)
    case_b, _, counts_b, col_b = run_projection(
        "(b) rigid_lid, red-black", dev, 10, 5, solver="redblack",
        solver_maxiter=RB_MAXITER)
    if not (counts_b["proj_a"] == counts_b["proj_b"] == 10
            and counts_b["rb_sweep"] == counts_b["passes"] > 0
            and counts_b["cg_fused"] == 0):
        raise AssertionError(f"(b) launch counts {counts_b}")
    if not col_b < 0.1:          # the rigid lid holds sum h = H
        raise AssertionError(f"(b) max|sum h - H| {col_b!r} m")
    eager_b = versus_eager("(b) 3 fused steps", case_b, 3, 1e-4)

    phase(f"9 times at {BIG}^2 f32 ({smi})")
    cfg, grid, forcing, st = perturbed_case(dev, 2, "rigid_lid", nx=BIG,
                                            ny=BIG, scheme="implicit_fs")
    statics = (grid, forcing)
    saved = (dict(fp.LAUNCHES), cg_fused.LAUNCHES, redblack.LAUNCHES)
    ms = {}
    u_s, v_s, div = fp.proj_a(st.h, st.u, st.v, statics, 0, cfg)
    ms["proj_a"] = time_pair(
        "K3a", lambda: fp.proj_a_plain(st.h, st.u, st.v, statics, 0, cfg),
        lambda: fp.proj_a(st.h, st.u, st.v, statics, 0, cfg), 10, 100)
    lam = projection.solve_lam(cfg)
    b, eta_n = projection.implicit_rhs(st.h, div, grid, cfg, lam)
    solve = cg_fused.make_cg_solve(grid, cfg, lam=lam)
    p = solve(b, eta_n).x
    ms["proj_b"] = time_pair(
        "K3b", lambda: fp.proj_b_plain(st.h, u_s, v_s, p, statics, st.t,
                                       cfg),
        lambda: fp.proj_b(st.h, u_s, v_s, p, statics, st.t, cfg), 10, 100)
    Hu, Hv = elliptic.face_depths(grid)
    rhs = projection.rigid_rhs(st.h, div, grid, cfg)
    kw = dict(k=8, omega=cfg.sor_omega)
    ms["rb_sweep"] = time_pair(
        "K4a pass (8 sweeps)",
        lambda: redblack.rb_sweep_plain(p, rhs, Hu, Hv, grid.mask, cfg.dx,
                                        cfg.dy, **kw),
        lambda: redblack.rb_sweep(p, rhs, Hu, Hv, grid.mask, cfg.dx, cfg.dy,
                                  **kw), 5, 50, unit="pass")
    res = solve(b, eta_n)
    ref = cg_fused.cg_solve_plain(b, grid, cfg, x0=eta_n, lam=lam)
    print(f"   K6 solve of an implicit-FS step from eta^n: {res.iters} "
          f"iterations (plain {ref.iters})")
    ms["cg_fused"] = time_pair(
        "K6 solve", lambda: cg_fused.cg_solve_plain(b, grid, cfg, x0=eta_n,
                                                    lam=lam),
        lambda: solve(b, eta_n), 3, 10, unit="solve")
    fp.LAUNCHES.update(saved[0])
    cg_fused.LAUNCHES, redblack.LAUNCHES = saved[1], saved[2]
    for label, (cfg, grid, forcing, st), n_steps, eager_ms in (
            ("(a) implicit_fs", case_a, 20, eager_a),
            ("(b) rigid_lid red-black", case_b, 10, eager_b)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(cfg, grid, forcing, st, n_steps, log=io.StringIO())
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n_steps * 1e3
        print(f"   {label}: run() {wall!r} ms/step over {n_steps} steps "
              f"(diagnostics included); eager stepper {eager_ms!r} "
              "ms/step over 3 steps")

    # fields moved per point (the kernels' pointer operands) and a count
    # of operations per point: K3a one momentum evaluation and the
    # divergence, K3b the correction and the continuity, a K4a pass 8
    # sweeps of ~12, K6 ~30 per iteration of this run's solve
    pts = cfg.nx * cfg.ny
    sources = {
        "proj_a": ("projection.cu", "band.py:200", 13, 150),
        "proj_b": ("projection.cu", "band.py:200", 10, 40),
        "rb_sweep": ("rb_sweep.cu", "redblack_pallas.py:39", 6, 8 * 12),
        "cg_fused": ("cg_fused.cu", "cg_vmem.py:61", 7, 30 * res.iters)}
    launches = {name: counts_a[name] + counts_b[name] for name in sources}
    return [kernel_entry(name, src, site, launches[name], err[name],
                         ms[name], fields * pts * 4, ops * pts)
            for name, (src, site, fields, ops) in sources.items()]


def field_on(mask, rng, amp=1.0):
    """A seeded wet field on the card, shaped and typed as mask."""
    import torch

    a = amp * rng.standard_normal(tuple(mask.shape))
    return torch.tensor(a, dtype=mask.dtype, device=mask.device) * mask


def check_level_kernels(label, device, tol, seed, **kw):
    """K4a with its residual (k = 2, omega = 1, forward and reverse) and
    K4b (both modes) on the model grid against their plain versions,
    lam = 0 and 1/(g dt^2).  Returns the largest differences."""
    import numpy as np
    import torch

    from beom_tpu_torch.solvers import multigrid as mg
    from beom_tpu_torch.stencils import redblack

    cfg, grid, _, _ = perturbed_case(device, seed, "rigid_lid", **kw)
    rng = np.random.default_rng(seed)
    worst_r = worst_b = 0.0
    for lam in (0.0, 1.0 / (cfg.g * cfg.dt ** 2)):
        lv = mg.build_levels(grid, cfg, lam, min_size=max(cfg.nx, cfg.ny))[0]
        args = (lv.Hu, lv.Hv, lv.mask, lv.dx, lv.dy)
        x, b = field_on(lv.mask, rng), field_on(lv.mask, rng, 1e-6)
        for reverse in (False, True):
            kw_s = dict(lam=lam, k=2, omega=1.0, reverse=reverse,
                        residual=True)
            out = redblack.rb_sweep(x, b, *args, **kw_s)
            torch.cuda.synchronize()
            ref = redblack.rb_sweep_plain(x, b, *args, **kw_s)
            worst_r = max(worst_r, compare_fields(
                f"{label} lam={lam:.4g} {'reverse' if reverse else 'forward'}"
                " K4a+residual", ("x", "r"), out, ref, tol))
        for mode in ("residual", "matvec"):
            out = redblack.apply_op(x, b, *args, lam=lam, mode=mode)
            torch.cuda.synchronize()
            ref = redblack.apply_op_plain(x, b, *args, lam=lam, mode=mode)
            worst_b = max(worst_b, compare_fields(
                f"{label} lam={lam:.4g} K4b", (mode,), [out], [ref], tol))
    return worst_r, worst_b


def check_coarse(label, device, demean_rel, seed, **kw):
    """K5 on the tail of the hierarchy that the fused tier gives it (the
    first level <= 512^2 and below) against the eager cycle on that tail,
    lam = 0 and 1/(g dt^2), de-mean off and on: 0.0 without the de-mean
    (it is off, or lam > 0), demean_rel x scale with it; two launches
    bitwise equal.  Returns the largest difference."""
    import numpy as np
    import torch

    from beom_tpu_torch.solvers import multigrid as mg
    from beom_tpu_torch.stencils import mg_coarse

    cfg, grid, _, _ = perturbed_case(device, seed, "rigid_lid", **kw)
    rng = np.random.default_rng(seed)
    worst = 0.0
    for lam in (0.0, 1.0 / (cfg.g * cfg.dt ** 2)):
        levels = mg.build_levels(grid, cfg, lam)
        gamma = mg.fused_gamma_schedule(levels, 2)
        for demean in (False, True):
            j0, call = mg.make_fused_coarse(levels, lam, 2, 24, demean,
                                            gamma=gamma)
            tail = levels[j0:]
            g_tail = gamma[j0:] or 1 if isinstance(gamma, tuple) else gamma
            b = field_on(tail[0].mask, rng)
            out, again = call(b), call(b)
            torch.cuda.synchronize()
            ref = mg_coarse.coarse_stack_plain(tail, b, lam, 2, 24, g_tail,
                                               demean)
            tag = (f"{label} lam={lam:.4g} demean={demean} K5 on levels "
                   f"{j0}..{len(levels) - 1} {tuple(tail[0].mask.shape)}")
            if not torch.equal(out, again):
                raise AssertionError(f"{tag}: two launches differ")
            rel_bound = demean_rel if (demean and lam == 0.0) else 0.0
            worst = max(worst, compare_fields(
                tag, ("x",), [out], [ref],
                lambda r: rel_bound * float(r.abs().max())))
    return worst


def check_composed(label, device, tol, seed, **kw):
    """make_mg_precond(smoother='fused') (K4a on the levels >= 256 rows
    above the tail, K5 on the tail) against the eager cycle with the same
    gamma schedule.  Returns the difference."""
    import numpy as np
    import torch

    from beom_tpu_torch.solvers import multigrid as mg

    cfg, grid, _, _ = perturbed_case(device, seed, "rigid_lid", **kw)
    levels = mg.build_levels(grid, cfg, 0.0)
    gamma = mg.fused_gamma_schedule(levels, 2)
    fused = mg.make_mg_precond(grid, cfg, smoother="fused")
    eager = mg.cycle_precond(levels, 0.0, 2, 24, gamma)
    r = field_on(grid.mask, np.random.default_rng(seed))
    out = fused(r)
    torch.cuda.synchronize()
    return compare_fields(f"{label} composed fused preconditioner",
                          ("z",), [out], [eager(r)], tol)


def multigrid_phases(dev, smi, rel, ulps):
    """Phases 10 to 13; returns the kernels' JSON entries."""
    import torch

    from beom_tpu_torch.run import run
    from beom_tpu_torch.solvers import multigrid as mg
    from beom_tpu_torch.stencils import build, cg_fused, mg_coarse, redblack
    from beom_tpu_torch.stencils import fused_projection as fp
    from beom_tpu_torch.stepping import projection

    phase("10 build: the multigrid kernels")
    for name in ("rb_sweep", "mg_coarse", "cg_fused"):
        print_build(build, name)

    phase("11 the multigrid kernels against their plain versions")
    err = {}
    check_level_kernels("256^2 f64", dev, rel(1e-12), 30, nx=256, ny=256,
                        dtype="float64")
    check_level_kernels("200x136 f64", dev, rel(1e-12), 31, nx=200, ny=136,
                        dtype="float64")
    err["rb_sweep_residual"], err["apply_op"] = check_level_kernels(
        f"{BIG}^2 f32", dev, ulps(4), 32, nx=BIG, ny=BIG)
    # de-mean bounds (PERF.md): 1e-12 x scale at f64, 1e-4 at f32
    check_coarse("256^2 f64", dev, 1e-12, 33, nx=256, ny=256,
                 dtype="float64")
    check_coarse("200x136 f64", dev, 1e-12, 34, nx=200, ny=136,
                 dtype="float64")
    err["mg_coarse"] = check_coarse(f"{BIG}^2 f32", dev, 1e-4, 35, nx=BIG,
                                    ny=BIG)
    check_cg("256^2 f64", dev, lambda lam: 1e-6, 36, precond="mg", nx=256,
             ny=256, dtype="float64")
    check_cg("200x136 f64", dev, lambda lam: 1e-6, 37, precond="mg", nx=200,
             ny=136, dtype="float64")
    # f32 bounds (PERF.md): 1e-3 x scale for lam = 0, 1e-4 for lam > 0
    err["cg_fused_mg"] = check_cg(f"{BIG}^2 f32", dev,
                                  lambda lam: 1e-3 if lam == 0.0 else 1e-4,
                                  38, precond="mg", nx=BIG, ny=BIG)
    check_composed("256^2 f64", dev, rel(1e-12), 39, nx=256, ny=256,
                   dtype="float64")
    check_composed(f"{BIG}^2 f32", dev, rel(1e-5), 40, nx=BIG, ny=BIG)

    phase(f"12 the multigrid paths: run() on the {BIG}^2 f32 rigid lid")
    case_c, _, counts_c, col_c = run_projection(
        "(c) rigid_lid, CG + multigrid (the default)", dev, 20, 10)
    if not (counts_c["proj_a"] == counts_c["proj_b"] == counts_c["cg_fused"]
            == 20 and counts_c["rb_sweep"] == counts_c["apply_op"]
            == counts_c["mg_coarse"] == 0):
        raise AssertionError(f"(c) launch counts {counts_c}")
    if not col_c < 0.1:
        raise AssertionError(f"(c) max|sum h - H| {col_c!r} m")
    eager_c = versus_eager("(c) 3 fused steps", case_c, 3, 1e-5)
    case_d, _, counts_d, col_d = run_projection(
        "(d) rigid_lid, solver='mg'", dev, 10, 5, solver="mg")
    n_cyc = counts_d["cycles"]
    # per cycle: K4a forward + reverse on level 0 once and on level 1 in
    # both K-cycle visits; K5 twice per level-1 visit (gamma_1 = 2); K4b
    # once, plus once per solve for the initial residual
    if not (counts_d["proj_a"] == counts_d["proj_b"] == 10 and n_cyc > 0
            and counts_d["rb_sweep"] == 6 * n_cyc
            and counts_d["mg_coarse"] == 4 * n_cyc
            and counts_d["apply_op"] == n_cyc + 10
            and counts_d["cg_fused"] == 0):
        raise AssertionError(f"(d) launch counts {counts_d}")
    if not col_d < 0.1:
        raise AssertionError(f"(d) max|sum h - H| {col_d!r} m")
    eager_d = versus_eager("(d) 3 fused steps", case_d, 3, 1e-4)

    phase(f"13 times at {BIG}^2 f32 ({smi})")
    cfg, grid, forcing, st = perturbed_case(dev, 2, "rigid_lid", nx=BIG,
                                            ny=BIG)
    saved = (dict(fp.LAUNCHES), cg_fused.LAUNCHES, redblack.LAUNCHES,
             redblack.APPLY_LAUNCHES, mg_coarse.LAUNCHES, mg.CYCLES)
    _, _, div = fp.proj_a(st.h, st.u, st.v, (grid, forcing), 0, cfg)
    rhs = projection.rigid_rhs(st.h, div, grid, cfg)
    levels = mg.build_levels(grid, cfg, 0.0)
    gamma = mg.fused_gamma_schedule(levels, 2)
    lv = levels[0]
    args = (lv.Hu, lv.Hv, lv.mask, lv.dx, lv.dy)
    x = torch.zeros_like(rhs)
    kw = dict(k=2, omega=1.0, residual=True)
    ms = {}
    ms["rb_sweep_residual"] = time_pair(
        "K4a pass (2 sweeps + residual)",
        lambda: redblack.rb_sweep_plain(x, rhs, *args, **kw),
        lambda: redblack.rb_sweep(x, rhs, *args, **kw), 10, 100,
        unit="pass")
    ms["apply_op"] = time_pair(
        "K4b residual", lambda: redblack.apply_op_plain(x, rhs, *args),
        lambda: redblack.apply_op(x, rhs, *args), 10, 100, unit="pass")
    j0, call = mg.make_fused_coarse(levels, 0.0, 2, 24, True, gamma=gamma)
    tail = levels[j0:]
    b_tail = rhs
    for coarser in levels[1:j0 + 1]:
        b_tail = mg._restrict2(b_tail) * coarser.mask
    ms["mg_coarse"] = time_pair(
        f"K5 on the {tuple(tail[0].mask.shape)} tail",
        lambda: mg_coarse.coarse_stack_plain(tail, b_tail, 0.0, 2, 24,
                                             gamma[j0:], True),
        lambda: call(b_tail), 3, 30, unit="visit")
    no_solo = mg_coarse.make_coarse_stack_call(tail, 0.0, gamma=gamma[j0:],
                                               demean=True, solo_points=0)
    print(f"   K5 with every level on the whole grid (no one-CTA levels): "
          f"{time_ms(lambda: no_solo(b_tail), 30)!r} ms/visit")
    solve = cg_fused.make_cg_solve(grid, cfg, lam=0.0)
    res = solve(rhs)
    ref = cg_fused.cg_solve_plain(rhs, grid, cfg, lam=0.0, precond="mg")
    ms["cg_fused_mg"] = time_pair(
        "K6-mg cold solve",
        lambda: cg_fused.cg_solve_plain(rhs, grid, cfg, lam=0.0,
                                        precond="mg"),
        lambda: solve(rhs), 1, 5, unit="solve")
    k_ms, p_ms = ms["cg_fused_mg"]
    print(f"   K6-mg: {res.iters} iterations (plain {ref.iters}); "
          f"{k_ms / max(res.iters, 1)!r} ms/iteration (plain "
          f"{p_ms / max(ref.iters, 1)!r})")
    for tag, steps in (
            ("K6-mg cycle", solve.steps),
            ("K6-mg cycle without one-CTA levels",
             mg_coarse.cycle_steps(levels, 0.0, 2, 24, gamma, False, 0)),
            ("K5 visit", call.steps),
            ("K5 visit without one-CTA levels", no_solo.steps)):
        print(f"   {tag}: {len(steps)} steps, "
              f"{mg_coarse.grid_syncs(steps)} grid syncs")
    for smoother in ("eager", "fused"):
        mg_solve = mg.make_mg_solver(grid, cfg, smoother=smoother)
        c0 = mg.CYCLES
        mg_solve(rhs)
        n_c = mg.CYCLES - c0
        t = time_ms(lambda: mg_solve(rhs), 1 if smoother == "eager" else 3)
        print(f"   solver='mg' cold solve, smoother={smoother}: {n_c} cycles, "
              f"{t!r} ms/solve, {t / max(n_c, 1)!r} ms/cycle")
    fp.LAUNCHES.update(saved[0])
    (cg_fused.LAUNCHES, redblack.LAUNCHES, redblack.APPLY_LAUNCHES,
     mg_coarse.LAUNCHES, mg.CYCLES) = saved[1:]
    for label, (cfg, grid, forcing, st), n_steps, eager_ms in (
            ("(c) rigid_lid CG + multigrid", case_c, 20, eager_c),
            ("(d) rigid_lid solver='mg'", case_d, 10, eager_d)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(cfg, grid, forcing, st, n_steps, log=io.StringIO())
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n_steps * 1e3
        print(f"   {label}: run() {wall!r} ms/step over {n_steps} steps "
              f"(diagnostics included); eager stepper {eager_ms!r} "
              "ms/step over 3 steps")

    # bytes: the operands of the call, each once (for the cycle kernels
    # the six level fields of every level they walk, b and x); operations:
    # ~12 per point and sweep, and the steps of this run's cycles
    pts = cfg.nx * cfg.ny
    tables = 6 * sum(lv.mask.numel() for lv in levels)
    tail_tables = 6 * sum(lv.mask.numel() for lv in tail)
    entries = {
        "rb_sweep_residual": ("rb_sweep.cu", "redblack_pallas.py:39",
                              counts_d["rb_sweep"], 7 * pts, 3 * 12 * pts),
        "apply_op": ("rb_sweep.cu", "redblack_pallas.py:217",
                     counts_d["apply_op"], 6 * pts, 12 * pts),
        "mg_coarse": ("mg_coarse.cu", "mg_pallas.py:55",
                      counts_d["mg_coarse"],
                      tail_tables + 2 * tail[0].mask.numel(),
                      cycle_ops(call.steps, tail)),
        "cg_fused_mg": ("cg_fused.cu", "cg_vmem.py:61",
                        counts_c["cg_fused"], tables + 3 * pts,
                        res.iters * (cycle_ops(solve.steps, levels)
                                     + 30 * pts))}
    return [kernel_entry(name, src, site, n, err[name], ms[name],
                         fields * 4, ops)
            for name, (src, site, n, fields, ops) in entries.items()]


def split_phases_compare(label, device, tol, seed, case, **kw):
    """K1s on one perturbed case: each of the three kernels against its
    eager phase from the same inputs, then the chained step over 3 steps
    against 3 eager split_steps.  Returns the largest differences by
    kernel."""
    import torch

    from beom_tpu_torch.core.state import State
    from beom_tpu_torch.stencils import fused_fb
    from beom_tpu_torch.stepping import fb, split

    cfg, grid, forcing, st = perturbed_case(device, seed, case,
                                            scheme="split", **kw)
    statics = (grid, forcing)
    tag = f"{label} {case} nsub={cfg.nsub}"
    sp_ref = split.slow_phase(st, grid, forcing, cfg)
    sp = fused_fb.split_slow(st.h, st.u, st.v, statics, cfg)
    torch.cuda.synchronize()
    worst = {"slow": compare_fields(f"{tag} slow", sp_ref._fields, sp,
                                    sp_ref, tol)}
    sub_ref = split.subcycle_phase(sp_ref, grid, cfg)
    sub = fused_fb.split_subcycle(sp_ref, st.h, st.u, st.v, statics, cfg)
    torch.cuda.synchronize()
    worst["subcycle"] = compare_fields(
        f"{tag} subcycle", ("eta_f", "ubar_f", "vbar_f", "ubar_avg",
                            "vbar_avg"), sub, sub_ref, tol)
    out = fused_fb.split_recompose(sp_ref, sub_ref, st.h, st.u, st.v,
                                   statics, st.t, cfg)
    torch.cuda.synchronize()
    h1, u1, v1 = split.recompose(sp_ref, *sub_ref, st.h, grid, cfg)
    ref = fb.finalize(h1, u1, v1, State(h=st.h, u=st.u, v=st.v, t=st.t, n=0),
                      grid, forcing, cfg)
    worst["recompose"] = compare_fields(f"{tag} recompose", "huv", out,
                                        (ref.h, ref.u, ref.v), tol)
    args = (st.h, st.u, st.v, statics, st.n, st.t, cfg, 3)
    out = fused_fb.fused_fb_step(*args)
    torch.cuda.synchronize()
    chained = compare_fields(f"{tag} 3 steps", "huv", out,
                             fused_fb.fused_fb_step_plain(*args), tol)
    return {k: max(v, chained) for k, v in worst.items()}


def fb_case_compare(label, device, tol, seed, case, **kw):
    """K1 on one perturbed case: one step at each sweep parity and a
    4-step pass against the plain version, and steps_per_pass = 4 bitwise
    equal to 4 single steps.  Returns the largest difference."""
    import torch

    from beom_tpu_torch.stencils import fused_fb
    from beom_tpu_torch.stepping import make_stepper

    cfg, grid, forcing, st = perturbed_case(device, seed, case, **kw)
    statics = (grid, forcing)
    if case == "coastal_wetdry" and not bool((st.h < cfg.h_dry).logical_and(
            grid.mask > 0).any()):
        raise AssertionError(f"{label} {case}: no dry cell in the state")
    if cfg.obc and not bool((forcing.obc_v != 0).any()):
        raise AssertionError(f"{label} {case}: no open face in the state")
    worst = 0.0
    for n, k in ((0, 1), (1, 1), (0, 4)):
        args = (st.h, st.u, st.v, statics, n, st.t, cfg, k)
        out = fused_fb.fused_fb_step(*args)
        torch.cuda.synchronize()
        worst = max(worst, compare_fields(
            f"{label} {case} n={n} k={k}", "huv", out,
            fused_fb.fused_fb_step_plain(*args), tol))
    four = make_stepper(grid, forcing, dataclasses.replace(
        cfg, backend="fused", steps_per_pass=4))(st)
    one = make_stepper(grid, forcing, dataclasses.replace(
        cfg, backend="fused"))
    single = st
    for _ in range(4):
        single = one(single)
    for f in "huv":
        if not torch.equal(getattr(four, f), getattr(single, f)):
            raise AssertionError(f"{label} {case}: steps_per_pass=4 != 4 "
                                 f"steps in {f}")
    return worst


def run_path(device, case, kw, n_steps):
    """run() on one case at 2048^2 f32 with backend='fused', the step
    kernels' counts set to 0 just before and read just after; checks the
    counts, the diagnostics, the mass of a closed basin, h >= 0 under
    wet/dry, and 3 fused steps against 3 eager ones.  Returns the case and
    the counts."""
    import numpy as np
    import torch

    from beom_tpu_torch.cases import make_case
    from beom_tpu_torch.run import run
    from beom_tpu_torch.stencils import fused_fb

    label = f"{case} {kw.get('scheme', 'fb')}" + (
        f" nsub={kw['nsub']}" if "nsub" in kw else "")
    every = n_steps // 2
    built = make_case(case, nx=BIG, ny=BIG, device=device, backend="fused",
                      diag_every=every, **kw)
    cfg, grid, forcing, st = built
    log = io.StringIO()
    torch.cuda.synchronize()
    fused_fb.LAUNCHES = 0
    fused_fb.SPLIT_LAUNCHES.update(slow=0, subcycle=0, recompose=0)
    t0 = time.perf_counter()
    out = run(cfg, grid, forcing, st, n_steps, log=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(fused_fb.SPLIT_LAUNCHES, fb_step=fused_fb.LAUNCHES)
    diags = [json.loads(x) for x in log.getvalue().splitlines()]
    for d in diags:
        print("   " + json.dumps(d))
    split = cfg.scheme == "split"
    want = dict(slow=n_steps * split, subcycle=n_steps * split,
                recompose=n_steps * split, fb_step=n_steps * (not split))
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, not {want}")
    if [d["n"] for d in diags] != [every, 2 * every]:
        raise AssertionError(f"{label}: diagnostics missing")
    if not all(d["finite"] == 1.0 and all(np.isfinite(list(
            v for k, v in d.items() if k != "kind"))) for d in diags):
        raise AssertionError(f"{label}: non-finite diagnostics")
    if not diags[-1]["max_speed"] > 0:
        raise AssertionError(f"{label}: max_speed is 0: the run did nothing")
    if out.h.shape != (cfg.nz, BIG, BIG) or out.n != n_steps \
            or not bool(torch.isfinite(out.h).all()):
        raise AssertionError(f"{label}: wrong final state")
    sum0 = float(st.h.double().sum())
    drift = (float(out.h.double().sum()) - sum0) / sum0
    eta = float(((out.h.sum(0) - grid.H) * grid.mask).abs().max())
    h_min = float(out.h.min())
    print(f"   {label}: launches {counts}; relative mass drift {drift!r} "
          f"(f64 sum of h); max|sum h - H| {eta!r} m; min h {h_min!r} m; "
          f"{n_steps} steps in {wall:.3f} s wall (first run, diagnostics "
          "included)")
    if not cfg.obc and not abs(drift) < 1e-6:
        raise AssertionError(f"{label}: mass drift {drift!r}")
    if not eta < 10.0:
        raise AssertionError(f"{label}: max|sum h - H| {eta!r} m")
    if cfg.wetdry and not h_min >= 0.0:
        raise AssertionError(f"{label}: min h {h_min!r} < 0 under wet/dry")
    eager_ms = versus_eager(f"{label}, 3 fused steps", built, 3, 1e-5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(cfg, grid, forcing, st, n_steps, log=io.StringIO())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n_steps * 1e3
    print(f"   {label}: run() {ms!r} ms/step over {n_steps} steps "
          f"(diagnostics included); eager stepper {eager_ms!r} ms/step over "
          "3 steps")
    return built, counts


def busy_share(label, fn, n_steps):
    """The device's busy share over one call of fn() under torch.profiler:
    the kernels' device time over the wall time, and the largest rows."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(getattr(r, "self_device_time_total", 0)
             or getattr(r, "self_cuda_time_total", 0), r.count, r.key)
            for r in prof.key_averages()
            if getattr(r, "device_type", None) == DeviceType.CUDA]
    busy = sum(r[0] for r in rows)
    if busy <= 0:
        print(f"   {label}: the profiler saw no device time; the idle share "
              "is not measured")
        return
    print(f"   {label}: {wall_us / n_steps / 1e3!r} ms/step under the "
          f"profiler, device busy {busy / wall_us:.3f} of wall, idle "
          f"{1 - busy / wall_us:.3f}")
    for us, count, key in sorted(rows, reverse=True)[:5]:
        print(f"      {us / 1e3:.3f} ms in {count} launches "
              f"({us / busy:.3f} of device time): {key[:70]}")


def case_phases(dev, smi, rel, ulps):
    """Phases 14 to 17; returns the kernels' JSON entries."""
    import torch

    from beom_tpu_torch.cases import make_case
    from beom_tpu_torch.run import run
    from beom_tpu_torch.stencils import build, fused_fb
    from beom_tpu_torch.stepping import split

    phase("14 build: the fb and split builds of the other cases")
    for item in sorted(k for k in build.BUILD_LOG if "[" in k):
        print_build(build, item)

    phase("15 K1 per case and K1s against their plain versions")
    err = {}
    for case in ("two_layer", "coastal_wetdry", "shelf_forced"):
        fb_case_compare("200x136 f64", dev, rel(1e-12), 41, case, nx=200,
                        ny=136, dtype="float64")
        err[case, "fb"] = fb_case_compare(f"{BIG}^2 f32", dev, ulps(4), 42,
                                          case, nx=BIG, ny=BIG)
    for case, nsub in AGREE_SPLIT:
        split_phases_compare("200x136 f64", dev, rel(1e-12), 43, case,
                             nx=200, ny=136, dtype="float64", nsub=nsub)
        worst = split_phases_compare(f"{BIG}^2 f32", dev, ulps(4), 44, case,
                                     nx=BIG, ny=BIG, nsub=nsub)
        for k, v in worst.items():
            err[case, k] = max(err.get((case, k), 0.0), v)

    phase(f"16 the other paths at full width: run() at {BIG}^2 f32")
    launches = {}
    for case, kw, n_steps in PATHS:
        _, counts = run_path(dev, case, kw, n_steps)
        for k, v in counts.items():
            launches[case, k] = launches.get((case, k), 0) + v

    phase(f"17 times at {BIG}^2 f32 ({smi})")
    saved = (fused_fb.LAUNCHES, dict(fused_fb.SPLIT_LAUNCHES))
    entries = []
    pts = BIG * BIG
    for case in ("two_layer", "coastal_wetdry", "shelf_forced"):
        cfg, grid, forcing, st = perturbed_case(dev, 2, case, nx=BIG, ny=BIG)
        args = (st.h, st.u, st.v, (grid, forcing), st.n, st.t, cfg, 1)
        ms = time_pair(f"K1 {case}",
                       lambda: fused_fb.fused_fb_step_plain(*args),
                       lambda: fused_fb.fused_fb_step(*args), 10, 100,
                       unit="step")
        entries.append(kernel_entry(
            f"fb_step_{case}", "fb_step.cu", "band.py:200",
            launches[case, "fb_step"], err[case, "fb"], ms,
            step_fields(cfg) * pts * 4, 150 * cfg.nz * pts))
    for case in ("double_gyre", "two_layer"):
        cfg, grid, forcing, st = perturbed_case(
            dev, 2, case, nx=BIG, ny=BIG, scheme="split", nsub=8)
        statics = (grid, forcing)
        sp = split.slow_phase(st, grid, forcing, cfg)
        sub = split.subcycle_phase(sp, grid, cfg)
        slow_f = fused_fb._launch_slow(st.h, st.u, st.v, statics, cfg)
        sub_f = fused_fb._launch_subcycle(slow_f, st.h, st.u, st.v, statics,
                                          cfg)
        nz = cfg.nz
        # fields moved and operations per point of each kernel: the slow
        # phase reads the step's operands and writes SlowPhase (4 nz + 9);
        # the subcycle reads 7 of them and 3 masks and writes 5; the
        # recomposition reads 4 nz + 2 of SlowPhase, the 5, h, H and 3
        # masks and writes h, u, v
        timed = {
            "slow": (lambda: split.slow_phase(st, grid, forcing, cfg),
                     lambda: fused_fb._launch_slow(st.h, st.u, st.v,
                                                   statics, cfg),
                     step_fields(cfg) - 3 * nz + 4 * nz + 9, 150 * nz),
            "subcycle": (lambda: split.subcycle_phase(sp, grid, cfg),
                         lambda: fused_fb._launch_subcycle(
                             slow_f, st.h, st.u, st.v, statics, cfg),
                         15, 20 * cfg.nsub),
            "recompose": (lambda: _recompose_plain(sp, sub, st, grid,
                                                   forcing, cfg),
                          lambda: fused_fb._launch_recompose(
                              slow_f, sub_f, st.h, st.u, st.v, statics,
                              st.t, cfg),
                          8 * nz + 11, 40 * nz)}
        for k, (plain, kernel, fields, ops) in timed.items():
            ms = time_pair(f"K1s {k} {case} nsub=8", plain, kernel, 10, 100)
            suffix = "" if case == "double_gyre" else f"_{case}"
            entries.append(kernel_entry(
                f"split_{k}{suffix}", "split_step.cu", "band.py:200",
                launches[case, k], err[case, k], ms, fields * pts * 4,
                ops * pts))
    for nsub in (4, 8, 12):
        cfg, grid, forcing, st = perturbed_case(
            dev, 2, "double_gyre", nx=BIG, ny=BIG, scheme="split", nsub=nsub)
        args = (st.h, st.u, st.v, (grid, forcing), st.n, st.t, cfg, 1)
        time_pair(f"split step double_gyre nsub={nsub}",
                  lambda: fused_fb.fused_fb_step_plain(*args),
                  lambda: fused_fb.fused_fb_step(*args), 5, 50, unit="step")
    for case, kw in (("two_layer", {}),
                     ("two_layer", dict(scheme="split", nsub=8))):
        cfg, grid, forcing, st = make_case(
            case, nx=BIG, ny=BIG, device=dev, backend="fused", diag_every=20,
            **kw)
        busy_share(f"{case} {cfg.scheme} through run()",
                   lambda: run(cfg, grid, forcing, st, 40, log=io.StringIO()),
                   40)
    fused_fb.LAUNCHES = saved[0]
    fused_fb.SPLIT_LAUNCHES.update(saved[1])
    return entries


def _recompose_plain(sp, sub, st, grid, forcing, cfg):
    """split.recompose followed by fb.finalize, eager."""
    from beom_tpu_torch.stepping import fb, split

    h1, u1, v1 = split.recompose(sp, *sub, st.h, grid, cfg)
    return fb.finalize(h1, u1, v1, st, grid, forcing, cfg)


if __name__ == "__main__":
    record = main()
    import torch

    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
