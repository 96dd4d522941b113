#!/usr/bin/env python3
"""Times and code of the single-device stencil kernels and of the fb shard
step on one NVIDIA GPU, for the checkout of beom_tpu_torch at ROOT.

    python3 tools/kernel_times.py ROOT [--split]

At 2048^2 f32 from chip_smoke.py's perturbed state: K1 (the fb step,
double gyre; one step on each of the four fb cases; the double gyre's
4-step pass as the checkout runs it: four launches, or its plan's launches
of the pass kernel, each launch of K1 counted under the key "fb_"),
K1s's three kernels (split, nsub 8), K3a / K3b (implicit FS
on the rigid-lid gyre), K7 (the fb shard step on a 2 x 4 mesh of shards
on the card), K5 (a visit of the 512^2 tail, de-mean on, as solver='mg'
runs it), K6 with multigrid (a cold solve of the rigid lid's first
pressure equation), K6 with Jacobi (an implicit-FS solve from eta^n), K4a
as an 8-sweep pass, as the k = 2 pass with the residual on the 2048^2
level (the multigrid pre-smoother) and, where the checkout has it, as the
blocked solve's pass (8 sweeps, the residual and its sum), each as the
mean time per call between CUDA events and as the device time of the
kernel, named by the key `record` gives it, under torch.profiler (for K7
the sum over its 16 launches, which overlap on the card), both through
chip_smoke.py's `time_ms` and `device_ms`; for K5 and K6 also the
device time of every row the call puts on the card over their count (the
key "" of device_ms, which averages the kernel with the call's fills,
copies and read-back) and, where the checkout has the launch's timing
mode (stencils/stamps.py), the kernel's own span from its %globaltimer
stamps (the median of five launches); a digest of K5's output and of
K6-mg's x and resnorm (equal digests: bitwise equal results); K6 with
Jacobi also at 2048^2 f64 and on the 200x136 coastal_wetdry at f32 and
f64; and the ms per step of run() on the 2048^2 f32 rigid lid with
implicit FS (CG + Jacobi), path (a), the red-black solve, path (b), its
default solve, path (c), and solver='mg', path (d), after one step not
timed; and of the main path, run() on the 2048^2 f32 double gyre with
steps_per_pass = 4, 400 steps, diagnostics every 100, after one run not
timed, in ms per step and grid-points/s.  Then, for every library the run built, each kernel's registers
and spill bytes (nvcc's -Xptxas -v lines) and its count of SASS
instructions (cuobjdump -sass).  It prints one
JSON line.  To compare two commits, unpack both and run this for each,
alternating (a, b, b, a) in one session on one card: the kernels are built
from each checkout's sources into its own build/kernels/, and the helpers
are always this checkout's chip_smoke.py.

K1s's split step is timed as each checkout runs it, one step at 2048^2
f32 through fused_fb_step (the three kernels, or the two launches of the
checkout's split plan, each launch counted under the key "split_") on the
double gyre at nsub 4, 8 and 12 and on two_layer at nsub 8, with digests
of each step's h, u, v (equal digests: bitwise equal results across the
trees), and where the checkout has them the two-launch step's kernels
alone.  With --split only K1s is timed, and the code report.

    python3 tools/kernel_times.py ROOT --projection

times only the projection step's phase kernels and paths, as the checkout
runs them: K3a and K3b (as its stepper launches them, so the single-step
kernels or the plan's staged ones; chip_smoke.phase_launchers) on the
rigid-lid gyre, two_layer, coastal_wetdry and shelf_forced with the
implicit free surface at 2048^2 f32 and f64, between CUDA events and on
the device (keys "proj_a", "proj_b": either kernel of each phase), with
digests of their outputs (equal digests: bitwise equal results across the
trees) and the host's time per launch; and paths (a) (implicit FS, CG +
Jacobi, 20 steps with diagnostics every 10) and (b) (red-black, 10 steps,
every 5) through run() after a run not timed, in ms per step, with the
device's idle share and the step by part under torch.profiler
(chip_smoke.step_parts); then (a) at a steady state, 400 steps with
diagnostics every 100, where run()'s set-up is a small share of the
window ((b) is not: at 2048^2 f32 its sweep budget lets the state go
non-finite by step 102); the host's ms for that set-up (make_stepper),
and where the checkout caches the Jacobi tile plan also with that cache
emptied ahead of each; and the code report.

    python3 tools/kernel_times.py ROOT --mesh

times only the mesh's shard kernels, as the checkout launches them on a
2 x 4 mesh of the 2048^2 f32 grid on the card (mesh_report): K7-fb's step
and 4-step pass, K7-split's step at nsub 8, K7-proj's phases A and B and
K8's pad2d of w = 5, between CUDA events and on the device (every launch
of the call), with their launches and digests of the gathered outputs;
beside them the single-device kernels whose stage bodies they share (K1's
4-step pass, K1s's step at nsub 8, K3a, K3b) with digests;
and run() of the mesh's fb and split paths and of the eager fb tier
through K8, in ms per step with the device's busy share; and the code
report.

    python3 tools/kernel_times.py ROOT --mesh solve

times only the projection schemes on a mesh of shards of the card
through run(), as the checkout solves their pressure equation there
(mesh_solve_report): the implicit free surface on the shelf at 2048^2
f32 with 32 layers and 13 constituents on 2 x 2 shards (CG + Jacobi, 10
steps) and on the 2048^2 f32 rigid-lid gyre on 2 x 4 shards (10 steps),
and the rigid lid's default solve (CG + multigrid) at 512^2 f32 on 2 x 2
shards (2 steps), each in ms per step after one step not timed, with
digests of the final h, u, v; where the checkout has the mesh's solve on
the card (stencils/mesh_solve.py), also K6's device time per step under
torch.profiler (every kernel whose name holds "cg_", over 3 steps).

    python3 tools/kernel_times.py ROOT --layers

times only what phase 28 of chip_smoke.py runs at many layers, as the
checkout runs it (layers_report): K1's step and K3b's phase on the shelf
at 2048^2 f32 with 32 layers and 13 constituents (the route the
checkout's plans take there: the spill route before the layer-streamed
one), and at nz 2, 4 and 8 on the shared-memory route and on the route
the plans' `spill` forces, and K3a at nz 32, each between CUDA events and
on the device (the sum over the route's kernels, each named by its key,
with how many of its launches torch.profiler saw; a kernel it saw none
of is null, not measured), with digests of the outputs (equal digests:
bitwise equal results across the trees); run() at nz 32, fb (20 steps)
and implicit FS (3 steps), in ms per step after a run not timed; the
split leg (split_report); the projection leg (projection_report); and the
code report.

    python3 tools/kernel_times.py ROOT --layers split

times only the split leg of --layers (split_report): K1s on the shelf at
2048^2 with 13 constituents and nsub 8, f32 at nz 2, 4, 8, 16 and 32 and
f64 at nz 2, 4, 8 and 16, on the route its plan takes and on the other
route of the checkout (the layer-streamed and the shared-memory routes
where both exist; before them the spill route the plan's own parameter
forces): the slow phase, the subcycle and the recomposition each between
CUDA events and on the device (summed over the route's kernels), with
digests of their outputs (equal digests: the routes agree bit for bit),
and run()'s split ms per step at each f32 nz (10 steps after a run not
timed); and the code report.

    python3 tools/kernel_times.py ROOT --layers projection

times only the projection leg of --layers (projection_report): K3a and
K3b on the shelf at 2048^2 under the implicit free surface with 13
constituents, f32 at nz 2, 4, 8, 16 and 32 and f64 at nz 2, 4, 8 and
16, on the route the plan takes and on the checkout's other route (the
layer-streamed and the shared-memory routes where both build; before
the streamed K3a, the route the plan's own parameter forces), each
between CUDA events and on the device, with digests of their outputs;
K7-proj's phases on 2 x 2 shards at f32 nz 8 on both routes (all of
each call's launches on the device, key "shard_p"); and run()'s
implicit-FS ms per step at f32 nz 32 on one device and on 2 x 2 shards
(10 steps after a run not timed); and the code report.  Its times set
fused_projection._STREAM_FROM.

    python3 tools/kernel_times.py ROOT --layers mesh

times K7's fb and split bodies on 2 x 2 shards of the card
(mesh_layers_report): on the shelf at 2048^2 with 13 constituents (split
at nsub 8), f32 at nz 8, 16 and 32 and f64 at nz 8 and 16, on each route
the checkout has there: the plan's, the one its plans' own parameter
forces (the layer-streamed kernels, or in a checkout whose shard bodies
do not stream, the spill route), and shared memory where a tile fits
but the plan streams (the split step's `_STREAM_FROM` lifted): K7-fb's
step and K7-split's slow phase,
subcycle and recomposition, each between CUDA events and on the device
(each kernel of the call by its key, summed), with digests of the
gathered outputs (equal digests: the routes and the trees agree bit for
bit); and run()'s fb and split ms per step at f32 nz 32 on 2 x 2 shards
(10 steps after one not timed); and the code report.

    python3 tools/kernel_times.py ROOT --layers tiles

times the layer-streamed K3a and K3b (one build, one tile) of a checkout
that streams them, on the shelf at 2048^2 under the implicit free
surface, f32 nz 32 and f64 nz 16, at each tile of TILES with 256 threads
per CTA (tiles_report), each phase between CUDA events and on the device,
with digests (equal digests: the tiles agree bit for bit); and the code
report.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import io
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

N = 2048
HERE = Path(__file__).resolve().parents[1]


def smoke():
    """This checkout's chip_smoke.py, whatever ROOT holds."""
    spec = importlib.util.spec_from_file_location(
        "kernel_times_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def demangle(names):
    tool = shutil.which("c++filt")
    if not tool or not names:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, timeout=60).stdout.splitlines()
    return out if len(out) == len(names) else list(names)


def ptxas_usage(log):
    """{kernel: [registers, spill stores, spill loads]} from nvcc's
    -Xptxas -v output."""
    usage, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            usage[name] = [None, None, None]
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            usage[name][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            usage[name][0] = int(m.group(1))
    return usage


def sass_counts(lib):
    """{kernel: SASS instructions} of a built library, or {} without
    cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).is_file():
        return {}
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300).stdout
    counts, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            counts[name] += 1
    return counts


def code_report(build):
    """Per library built in this process: its kernels' registers, spills
    and SASS instructions, by demangled name."""
    report = {}
    for label, (_, log) in build.BUILD_LOG.items():
        usage = ptxas_usage(log)
        name, _, defines = label.partition("[")
        spec = (name, tuple(defines.rstrip("]").split()))
        sass = sass_counts(build._lib_path(spec))
        keys = sorted(set(usage) | set(sass))
        report[label] = {
            pretty: usage.get(k, [None] * 3) + [sass.get(k)]
            for k, pretty in zip(keys, demangle(keys))}
    return report


def projection_report(sm, dev, out, digest, record) -> None:
    """The --projection report of the checkout imported."""
    import torch

    from beom_tpu_torch.cases import make_case
    from beom_tpu_torch.run import run
    from beom_tpu_torch.stencils import build, cg_fused
    from beom_tpu_torch.stencils import fused_projection as fp

    cases = ("rigid_lid", "two_layer", "coastal_wetdry", "shelf_forced")
    # every projection build the report launches, built at once
    specs = []
    for dtype in ("float32", "float64"):
        for case in cases:
            cfg = make_case(case, nx=16, ny=16, device="cpu", dtype=dtype,
                            scheme="implicit_fs")[0]
            specs.append(fp.build_spec(cfg, cfg.tdtype, fp.plan(
                cfg, cfg.tdtype), True) if hasattr(fp, "plan")
                else fp.build_spec(cfg, cfg.tdtype))
    build.build_all(specs + ["cg_jacobi", "rb_sweep"])
    for dtype in ("float32", "float64"):
        for case in cases:
            cfg, grid, forcing, st = sm.perturbed_case(
                dev, 2, case, nx=N, ny=N, scheme="implicit_fs", dtype=dtype)
            st = st.replace(t=cfg.npdtype.type(7 * cfg.dt))
            p = (st.h.sum(0) - grid.H) * grid.mask
            pa, pb = sm.phase_launchers(fp, grid, forcing, cfg)
            a = pa(st.h, st.u, st.v, 0)
            b = pb(st.h, a[0], a[1], p, st.t)
            name = f"{case} {dtype}"
            out[f"K3a {name} digest"] = digest(*a)
            out[f"K3b {name} digest"] = digest(*b)
            if hasattr(fp, "plan"):
                out[f"{name} plan"] = fp.plan(cfg, cfg.tdtype).describe()
            record(f"K3a {name}", lambda: pa(st.h, st.u, st.v, 0), 100,
                   "proj_a")
            record(f"K3b {name}", lambda: pb(st.h, a[0], a[1], p, st.t),
                   100, "proj_b")
            if case == "rigid_lid" and dtype == "float32":
                out["host us proj_a"] = sm.host_us(
                    lambda: pa(st.h, st.u, st.v, 0))
                out["host us proj_b"] = sm.host_us(
                    lambda: pb(st.h, a[0], a[1], p, st.t))
            del a, b, pa, pb
            torch.cuda.empty_cache()
    for name, kw, n_steps, diag, n_long, diag_long, keys in (
            ("(a)", {"scheme": "implicit_fs"}, 20, 10, 400, 100, ("cg_",)),
            ("(b)", dict(solver="redblack", solver_maxiter=sm.RB_MAXITER),
             10, 5, None, None, ("rb_",))):
        cfg, grid, forcing, st = make_case("rigid_lid", nx=N, ny=N,
                                           device=dev, backend="fused",
                                           diag_every=diag, **kw)
        st = run(cfg, grid, forcing, st, 2, log=io.StringIO())
        out[f"{name} set-up ms"] = setup_ms(grid, forcing, cfg)
        clear = getattr(cg_fused.tile_plan, "cache_clear", None)
        if clear is not None:
            out[f"{name} set-up ms, tile plan not cached"] = setup_ms(
                grid, forcing, cfg, clear)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last = run(cfg, grid, forcing, st, n_steps, log=io.StringIO())
        torch.cuda.synchronize()
        out[f"{name} run() ms/step"] = \
            (time.perf_counter() - t0) / n_steps * 1e3
        out[f"{name} digest"] = digest(last.h, last.u, last.v)
        parts = sm.step_parts(f"{name} by part", lambda: run(
            cfg, grid, forcing, st, n_steps, log=io.StringIO()), n_steps,
            keys)
        out[f"{name} idle share"] = parts.get("idle share")
        out[f"{name} parts us/step"] = {k: v for k, v in parts.items()
                                        if k != "idle share"}
        if n_long is None:
            continue
        # the steady state: a window long enough that the call's set-up
        # is a small share of it, diagnostics as on the main path
        cfg = dataclasses.replace(cfg, diag_every=diag_long)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last = run(cfg, grid, forcing, st, n_long, log=io.StringIO())
        torch.cuda.synchronize()
        out[f"{name} run() {n_long} steps ms/step"] = \
            (time.perf_counter() - t0) / n_long * 1e3
        out[f"{name} {n_long} steps digest"] = digest(last.h, last.u, last.v)
        parts = sm.step_parts(f"{name} by part, {n_long} steps", lambda: run(
            cfg, grid, forcing, st, n_long, log=io.StringIO()), n_long, keys)
        out[f"{name} {n_long} steps idle share"] = parts.get("idle share")
        out[f"{name} {n_long} steps parts us/step"] = {
            k: v for k, v in parts.items() if k != "idle share"}


def seen_ms(sm, label, fn, n_calls, keys) -> dict:
    """{key: [ms per call, launches seen, launches made]} of the kernels
    whose names hold each key, launched once per call of fn(), under
    torch.profiler (up to three windows, until each key is seen; ms None
    where none was: not measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n_calls):
                fn()
            torch.cuda.synchronize()
        rows = sm.device_rows(prof)
        if all(any(k in r[2] and r[1] for r in rows) for k in keys):
            break
    out = {}
    for k in keys:
        us = sum(r[0] for r in rows if k in r[2])
        n = sum(r[1] for r in rows if k in r[2])
        out[k] = [us / n / 1e3 if n else None, n, n_calls]
        print(f"   {label}: {k} {out[k][0]!r} ms on the device, "
              f"torch.profiler saw {n} of {n_calls} launches")
    return out


def split_report(sm, dev, out, digest, kernels) -> None:
    """The split leg of --layers: K1s's three phases on the shelf at
    2048^2 (13 constituents, nsub 8), f32 at nz 2, 4, 8, 16 and 32 and f64
    at nz 2, 4, 8 and 16, on the plan's route and on the other route the
    checkout has: where its SplitPlan has `stream`, the same plan with
    `stream` flipped (where the shared-memory route fits), else the spill
    route its plan's parameter forces; run()'s split ms/step at each f32
    nz.  `kernels(keys, fn, label, n)` times a call (layers_report's)."""
    import torch

    from beom_tpu_torch.run import run
    from beom_tpu_torch.stencils import build, fused_fb
    from beom_tpu_torch.stepping import split as split_mod

    def plans(cfg):
        sp = fused_fb.split_plan(cfg, cfg.tdtype)
        if not hasattr(sp, "stream"):
            return sp, fused_fb.split_plan(cfg, cfg.tdtype, True)
        if sp.stream and fused_fb.single_tile(cfg, cfg.tdtype)[1]:
            return sp, None
        return sp, dataclasses.replace(sp, stream=not sp.stream)

    def spec(cfg, sp, other):
        # positional: the parameters differ between checkouts
        if other and not hasattr(sp, "stream"):
            return fused_fb.build_spec(cfg, cfg.tdtype, 1, None, True)
        return fused_fb.build_spec(cfg, cfg.tdtype, 1, sp if other else None)

    def streams(sp):
        return getattr(sp, "stream", False)

    legs = [(nz, "float32") for nz in (2, 4, 8, 16, 32)] \
        + [(nz, "float64") for nz in (2, 4, 8, 16)]
    specs = []
    for nz, dtype in legs:
        cfg = sm.layers_case("cpu", 0, nz, dtype, 64, scheme="split",
                             nsub=8)[0]
        sp, alt = plans(cfg)
        specs.append(spec(cfg, sp, False))
        if alt is not None:
            specs.append(spec(cfg, alt, True))
    build.build_all(sorted(set(specs)))
    for nz, dtype in legs:
        cfg, grid, forcing, st = sm.layers_case(dev, 29, nz, dtype, N,
                                                scheme="split", nsub=8)
        statics = (grid, forcing)
        slow_ref = split_mod.slow_phase(st, grid, forcing, cfg)
        sub_ref = split_mod.subcycle_phase(slow_ref, grid, cfg)
        sp, alt = plans(cfg)
        for other, pl in ((False, sp), (True, alt)):
            if pl is None:
                continue
            tag = ("" if dtype == "float32" else "f64 ") + f"nz {nz}" \
                + (", other route" if other else "")
            out[f"K1s {tag} plan"] = pl.describe()
            slow = lambda: fused_fb.split_slow(st.h, st.u, st.v, statics,
                                               cfg, pl)
            sub = lambda: fused_fb.split_subcycle(slow_ref, st.h, st.u,
                                                  st.v, statics, cfg, pl)
            rec = lambda: fused_fb.split_recompose(slow_ref, sub_ref, st.h,
                                                   st.u, st.v, statics,
                                                   st.t, cfg, pl)
            out[f"K1s slow {tag} digest"] = digest(*slow())
            out[f"K1s recompose {tag} digest"] = digest(*rec())
            n = 10 if nz > 8 else 20
            kernels(("split_slow_layers_kernel",) if streams(pl)
                    else ("split_slow_kernel",), slow, f"K1s slow {tag}", n)
            kernels(("split_sub_kernel",), sub, f"K1s subcycle {tag}", n)
            kernels(("split_rec_h_layers_kernel",
                     "split_rec_uv_layers_kernel") if streams(pl)
                    else ("split_rec_kernel",), rec, f"K1s recompose {tag}",
                    n)
        del cfg, grid, forcing, st, statics, slow_ref, sub_ref
        torch.cuda.empty_cache()
        if dtype != "float32":
            continue
        cfg, grid, forcing, st = sm.layers_case(
            dev, 34, nz, "float32", N, scheme="split", nsub=8,
            backend="fused", diag_every=10)
        st = run(cfg, grid, forcing, st, 1, log=io.StringIO())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last = run(cfg, grid, forcing, st, 10, log=io.StringIO())
        torch.cuda.synchronize()
        out[f"run() split nz {nz} ms/step"] = \
            (time.perf_counter() - t0) / 10 * 1e3
        out[f"run() split nz {nz} digest"] = digest(last.h, last.u, last.v)
        del cfg, grid, forcing, st, last
        torch.cuda.empty_cache()


def projection_report(sm, dev, out, digest, kernels) -> None:
    """The projection leg of --layers: K3a and K3b on phase 28's shelf at
    2048^2 under the implicit free surface (13 constituents), f32 at nz 2,
    4, 8, 16 and 32 and f64 at nz 2, 4, 8 and 16, on the route the plan
    takes and on the checkout's other route (streamed against shared
    memory where both build; before the streamed K3a, the route the
    plan's own parameter forces, K3a on the spill route), each phase
    between CUDA events and on the device, with digests (equal digests:
    the routes agree bit for bit); K7-proj's phases on 2 x 2 shards at f32
    nz 8 on both routes; run()'s implicit-FS ms/step at f32 nz 32 on one
    device and on 2 x 2 shards (10 steps after one not timed).
    `kernels(keys, fn, label, n)` times a call (layers_report's)."""
    import contextlib

    import torch

    from beom_tpu_torch.parallel import mesh as pmesh
    from beom_tpu_torch.run import run
    from beom_tpu_torch.stencils import build, dist_band
    from beom_tpu_torch.stencils import fused_projection as fp

    # the change's plan streams from a layer count: with it lifted the
    # plans take shared memory wherever a tile fits
    streams = hasattr(fp, "_STREAM_FROM")

    def clear():
        fp.plan.cache_clear()
        dist_band._mesh_plan.cache_clear()
        dist_band._entry.cache_clear()

    @contextlib.contextmanager
    def in_smem():
        saved = fp._STREAM_FROM
        fp._STREAM_FROM = 1 << 30
        clear()
        try:
            yield
        finally:
            fp._STREAM_FROM = saved
            clear()

    def routes(cfg):
        # [(route, PhasePlan)]: the plan's, then the other where it builds
        pl = fp.plan(cfg, cfg.tdtype)
        if not streams:
            return [("plan", pl)] + ([] if pl.spill else [
                ("forced", fp.plan(cfg, cfg.tdtype, True))])
        streamed = ("streamed", fp.plan(cfg, cfg.tdtype, True))
        if fp.single_tile(cfg, cfg.tdtype)[1]:
            return [streamed]
        with in_smem():
            shared = ("shared memory", fp.plan(cfg, cfg.tdtype))
        return [shared, streamed]

    m = pmesh.make_mesh(2, 2, devices=["cpu"])
    legs = [(nz, "float32") for nz in (2, 4, 8, 16, 32)] \
        + [(nz, "float64") for nz in (2, 4, 8, 16)]
    specs = []
    for nz, dtype in legs:
        cfg, grid = sm.layers_case("cpu", 0, nz, dtype, 64,
                                   scheme="implicit_fs",
                                   precond="jacobi")[:2]
        dm = fp.derived_masks(grid)
        specs += [fp.build_spec(cfg, cfg.tdtype, pl, dm)
                  for _, pl in routes(cfg)]
        if (nz, dtype) in ((8, "float32"), (32, "float32")):
            specs += sorted(dist_band.build_specs(cfg, cfg.tdtype, m, dm))
            if streams and nz == 8:
                with in_smem():
                    specs += sorted(dist_band.build_specs(cfg, cfg.tdtype,
                                                          m, dm))
    build.build_all(["cg_jacobi"] + sorted(set(specs)))

    for nz, dtype in legs:
        cfg, grid, forcing, st = sm.layers_case(
            dev, 30, nz, dtype, N, scheme="implicit_fs", precond="jacobi")
        statics = (grid, forcing)
        gen = torch.Generator(device=dev).manual_seed(30)
        p = torch.randn(cfg.ny, cfg.nx, dtype=st.h.dtype, device=dev,
                        generator=gen) * grid.mask
        us, vs, _ = fp.proj_a_plain(st.h, st.u, st.v, statics, 0, cfg)
        n = 10 if nz > 8 else 20
        for route, pl in routes(cfg):
            tag = ("" if dtype == "float32" else "f64 ") + f"nz {nz}, {route}"
            ph = fp.Phases(grid, forcing, cfg, phase_plan=pl)
            out[f"K3 {tag} plan"] = pl.describe()
            key_a, key_b = ph.kernel_keys()
            phase_a = lambda: ph.a(st.h, st.u, st.v, 0)
            phase_b = lambda: ph.b(st.h, us, vs, p, st.t)
            out[f"K3a {tag} digest"] = digest(*phase_a())
            out[f"K3b {tag} digest"] = digest(*phase_b())
            kernels((key_a,), phase_a, f"K3a {tag}", n)
            kernels((key_b,), phase_b, f"K3b {tag}", n)
            del ph
        if (nz, dtype) == (8, "float32"):
            mesh = pmesh.make_mesh(2, 2, devices=[dev])
            f = [dist_band.stack_global(a, mesh) for a in (st.h, st.u, st.v)]
            ps = dist_band.stack_global(p, mesh)
            for route in ("shared memory", "streamed") if streams \
                    else ("plan",):
                ctx = in_smem() if route == "shared memory" \
                    else contextlib.nullcontext()
                with ctx:
                    K = dist_band.MeshKernels(statics, cfg, mesh)
                    tag = f"nz {nz}, {route}"
                    out[f"K7-proj {tag} plan"] = K.plan.describe()
                    a7 = K.proj_a(*f, 0)
                    phase_a = lambda: K.proj_a(*f, 0)
                    phase_b = lambda: K.proj_b(f[0], a7[0], a7[1], ps, st.t)
                    out[f"K7-proj A {tag} digest"] = digest(*[
                        pmesh.gather(dist_band.unstack(a, mesh))
                        for a in phase_a()])
                    out[f"K7-proj B {tag} digest"] = digest(*[
                        pmesh.gather(dist_band.unstack(a, mesh))
                        for a in phase_b()])
                    kernels(("shard_p",), phase_a, f"K7-proj A {tag}", n)
                    kernels(("shard_p",), phase_b, f"K7-proj B {tag}", n)
                    del K, a7
            del f, ps
        del cfg, grid, forcing, st, statics, us, vs, p
        torch.cuda.empty_cache()

    for label, kw in (("one device", {}),
                      ("2 x 2 shards", dict(mesh_y=2, mesh_x=2))):
        cfg, grid, forcing, st = sm.layers_case(
            dev, 34, sm.LAYERS28, "float32", N, scheme="implicit_fs",
            precond="jacobi", backend="fused", diag_every=10, **kw)
        st = run(cfg, grid, forcing, st, 1, log=io.StringIO())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last = run(cfg, grid, forcing, st, 10, log=io.StringIO())
        torch.cuda.synchronize()
        out[f"run() implicit_fs nz {sm.LAYERS28} {label} ms/step"] = \
            (time.perf_counter() - t0) / 10 * 1e3
        out[f"run() implicit_fs nz {sm.LAYERS28} {label} digest"] = digest(
            last.h, last.u, last.v)
        del cfg, grid, forcing, st, last
        torch.cuda.empty_cache()


def tiles_report(sm, dev, out, digest, kernels) -> None:
    """The tiles leg of --layers: the layer-streamed K3a and K3b (one
    build, one tile) on phase 28's shelf at 2048^2 under the implicit free
    surface, f32 nz 32 and f64 nz 16, at each tile of TILES (256 threads
    per CTA), each phase between CUDA events and on the device, with
    digests (equal digests: the tiles agree bit for bit)."""
    import torch

    from beom_tpu_torch.stencils import build
    from beom_tpu_torch.stencils import fused_projection as fp

    plan_tile = fp.single_tile

    def at(tile):
        # the streamed build's tile taken as `tile`
        fp.single_tile = lambda cfg, dtype=None, off_smem=False: \
            (tile, True) if off_smem else plan_tile(cfg, dtype, off_smem)
        fp._entries.cache_clear()

    legs = ((32, "float32"), (16, "float64"))
    specs = []
    for tile in TILES:
        at(tile)
        for nz, dtype in legs:
            cfg, grid = sm.layers_case("cpu", 0, nz, dtype, 64,
                                       scheme="implicit_fs",
                                       precond="jacobi")[:2]
            specs.append(fp.build_spec(cfg, cfg.tdtype,
                                       fp.plan(cfg, cfg.tdtype, True),
                                       fp.derived_masks(grid)))
    build.build_all(sorted(set(specs)))
    for nz, dtype in legs:
        cfg, grid, forcing, st = sm.layers_case(
            dev, 30, nz, dtype, N, scheme="implicit_fs", precond="jacobi")
        statics = (grid, forcing)
        gen = torch.Generator(device=dev).manual_seed(30)
        p = torch.randn(cfg.ny, cfg.nx, dtype=st.h.dtype, device=dev,
                        generator=gen) * grid.mask
        us, vs, _ = fp.proj_a_plain(st.h, st.u, st.v, statics, 0, cfg)
        for tile in TILES:
            at(tile)
            tag = f"{dtype} nz {nz}, tile {tile[0]} x {tile[1]}"
            ph = fp.Phases(grid, forcing, cfg,
                           phase_plan=fp.plan(cfg, cfg.tdtype, True))
            phase_a = lambda: ph.a(st.h, st.u, st.v, 0)
            phase_b = lambda: ph.b(st.h, us, vs, p, st.t)
            out[f"K3a {tag} digest"] = digest(*phase_a())
            out[f"K3b {tag} digest"] = digest(*phase_b())
            kernels(("proj_a_layers_kernel",), phase_a, f"K3a {tag}", 10)
            kernels(("proj_b_layers_kernel",), phase_b, f"K3b {tag}", 10)
            del ph
        del cfg, grid, forcing, st, statics, us, vs, p
        torch.cuda.empty_cache()
    fp.single_tile = plan_tile
    fp._entries.cache_clear()


def mesh_layers_report(sm, dev, out, digest, kernels) -> None:
    """The mesh leg of --layers: K7-fb and K7-split on 2 x 2 shards of the
    card on phase 28's shelf at 2048^2 (13 constituents, split at nsub 8),
    f32 at nz 8, 16 and 32 and f64 at nz 8 and 16, on every route the
    checkout has there (the plan's; the one the plans' own parameter
    forces; shared memory where a tile fits but the plan streams), each
    call between CUDA events and on the device (the sum over the call's
    kernels, one key each), with digests of the gathered outputs; and
    run()'s fb and split ms/step at f32 nz 32 on 2 x 2 shards.
    `kernels(keys, fn, label, n)` times a call (layers_report's)."""
    import contextlib

    import torch

    from beom_tpu_torch.core.state import advance_time
    from beom_tpu_torch.parallel import mesh as pmesh
    from beom_tpu_torch.run import run
    from beom_tpu_torch.stencils import build, dist_band, fused_fb

    def clear():
        for fn in (fused_fb.split_plan, fused_fb.launch_plan, fused_fb.plan,
                   fused_fb._entries, dist_band._mesh_plan,
                   dist_band._entry):
            fn.cache_clear()

    @contextlib.contextmanager
    def in_smem():
        # the split step's plan with its layer count to stream from lifted
        saved = fused_fb._STREAM_FROM
        fused_fb._STREAM_FROM = 1 << 30
        clear()
        try:
            yield
        finally:
            fused_fb._STREAM_FROM = saved
            clear()

    routes = (("plan", False, contextlib.nullcontext),
              ("forced", True, contextlib.nullcontext),
              ("shared memory", False, in_smem))
    m = pmesh.make_mesh(2, 2, devices=["cpu"])
    legs = [(nz, "float32") for nz in (8, 16, 32)] \
        + [(nz, "float64") for nz in (8, 16)]
    specs = set()
    for nz, dtype in legs:
        for scheme in ("fb", "split"):
            cfg = sm.layers_case("cpu", 0, nz, dtype, 64, scheme=scheme,
                                 nsub=8)[0]
            for _, off, ctx in routes:
                with ctx():
                    specs |= dist_band.build_specs(cfg, cfg.tdtype, m,
                                                   off_smem=off)
    build.build_all(sorted(specs))

    mesh = pmesh.make_mesh(2, 2, devices=[dev])
    gather = lambda outs: [pmesh.gather(dist_band.unstack(a, mesh))
                           for a in outs]
    for nz, dtype in legs:
        n = 10 if nz > 8 else 20
        for scheme in ("fb", "split"):
            cfg, grid, forcing, st = sm.layers_case(dev, 31, nz, dtype, N,
                                                    scheme=scheme, nsub=8)
            statics = (grid, forcing)
            f = [dist_band.stack_global(a, mesh) for a in (st.h, st.u, st.v)]
            t1 = advance_time(st.t, cfg.dt, cfg.npdtype)
            seen = set()
            for route, off, ctx in routes:
                with ctx():
                    pl = dist_band.mesh_plan(cfg, cfg.tdtype, mesh, off)
                    if pl.describe() in seen:
                        continue
                    seen.add(pl.describe())
                    K = dist_band.MeshKernels(statics, cfg, mesh, pl=pl)
                    tag = ("" if dtype == "float32" else "f64 ") \
                        + f"nz {nz}, {route}"
                    out[f"K7-{scheme} {tag} plan"] = pl.describe()
                    # the layer-streamed kernels: two launches per call
                    # where the route has them
                    streamed = getattr(pl, "streamed", False)
                    if scheme == "fb":
                        step = lambda: K.step(*f, 1, st.t, 1)
                        out[f"K7-fb {tag} digest"] = digest(*gather(step()))
                        kernels(("shard_cont", "shard_mom") if streamed
                                else ("shard_step",), step, f"K7-fb {tag}",
                                n)
                    else:
                        slow7 = K.slow(*f)
                        sub7 = K.subcycle(slow7, *f)
                        slow = lambda: K.slow(*f)
                        sub = lambda: K.subcycle(slow7, *f)
                        rec = lambda: K.recompose(slow7, sub7, *f, t1)
                        out[f"K7-split {tag} digest"] = digest(
                            *gather(K.step(*f, 1, st.t, 1)))
                        kernels(("shard_slow",), slow,
                                f"K7-split slow {tag}", n)
                        kernels(("shard_sub",), sub,
                                f"K7-split subcycle {tag}", n)
                        kernels(("shard_rec_h", "shard_rec_uv") if streamed
                                else ("shard_rec_kernel",), rec,
                                f"K7-split recompose {tag}", n)
                        del slow7, sub7
                    del K
            del cfg, grid, forcing, st, statics, f
            torch.cuda.empty_cache()

    for scheme in ("fb", "split"):
        cfg, grid, forcing, st = sm.layers_case(
            dev, 34, sm.LAYERS28, "float32", N, scheme=scheme, nsub=8,
            backend="fused", diag_every=10, mesh_y=2, mesh_x=2)
        st = run(cfg, grid, forcing, st, 1, log=io.StringIO())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last = run(cfg, grid, forcing, st, 10, log=io.StringIO())
        torch.cuda.synchronize()
        out[f"run() {scheme} nz {sm.LAYERS28} 2 x 2 shards ms/step"] = \
            (time.perf_counter() - t0) / 10 * 1e3
        out[f"run() {scheme} nz {sm.LAYERS28} 2 x 2 shards digest"] = \
            digest(*[pmesh.gather(a) for a in (last.h, last.u, last.v)])
        del cfg, grid, forcing, st, last
        torch.cuda.empty_cache()


# the streamed projection build's tiles the tiles leg times (the plan's
# first)
TILES = ((32, 16), (32, 8), (64, 8), (48, 16), (32, 32))


def layers_report(sm, dev, out, digest, only_split: bool = False,
                  only_projection: bool = False, only_tiles: bool = False,
                  only_mesh: bool = False) -> None:
    """The --layers report of the checkout imported: K1, K3b and K3a on
    phase 28's shelf at 2048^2 f32, as each checkout runs them."""
    import torch

    from beom_tpu_torch.run import run
    from beom_tpu_torch.stencils import build, fused_fb
    from beom_tpu_torch.stencils import fused_projection as fp

    legs = [(sm.LAYERS28, False)] + [(nz, forced) for nz in (2, 4, 8)
                                     for forced in (False, True)]

    def kernels(keys, fn, label, n):
        # events around the call, and the device time summed over keys
        ms = sm.time_ms(fn, n)
        seen = seen_ms(sm, label, fn, 5, keys)
        times = [v[0] for v in seen.values()]
        total = None if None in times else sum(times)
        out[label] = {"events ms": ms, "device ms": total,
                      "by kernel": seen}

    if only_split:
        split_report(sm, dev, out, digest, kernels)
        return
    if only_projection:
        projection_report(sm, dev, out, digest, kernels)
        return
    if only_tiles:
        tiles_report(sm, dev, out, digest, kernels)
        return
    if only_mesh:
        mesh_layers_report(sm, dev, out, digest, kernels)
        return
    specs = []
    for nz, forced in legs:
        cfg = sm.layers_case("cpu", 0, nz, "float32", 64)[0]
        # positional: the flag's name differs between checkouts
        specs.append(fused_fb.build_spec(cfg, cfg.tdtype, 1, None, forced))
        cfg = sm.layers_case("cpu", 0, nz, "float32", 64,
                             scheme="implicit_fs", precond="jacobi")[0]
        specs.append(fp.build_spec(cfg, cfg.tdtype,
                                   fp.plan(cfg, cfg.tdtype, forced), True))
    build.build_all(specs + ["cg_jacobi"])

    for nz, forced in legs:
        tag = f"nz {nz}" + (", forced" if forced else "")
        cfg, grid, forcing, st = sm.layers_case(dev, 28, nz, "float32", N)
        statics = (grid, forcing)
        pl = fused_fb.plan(cfg, cfg.tdtype, 1, forced)
        out[f"K1 {tag} plan"] = pl.describe()
        args = (st.h, st.u, st.v, statics, 0, st.t, cfg, 1)
        step = lambda: fused_fb.fused_fb_step(*args, pl=pl)
        out[f"K1 {tag} digest"] = digest(*step())
        keys = ("fb_cont_kernel", "fb_mom_kernel") \
            if getattr(pl, "stream", False) else ("fb_step_kernel",)
        kernels(keys, step, f"K1 {tag}", 10 if nz > 8 else 20)
        del cfg, grid, forcing, st, statics, args
        torch.cuda.empty_cache()

        cfg, grid, forcing, st = sm.layers_case(
            dev, 30, nz, "float32", N, scheme="implicit_fs",
            precond="jacobi")
        statics = (grid, forcing)
        ph = fp.Phases(grid, forcing, cfg,
                       phase_plan=fp.plan(cfg, cfg.tdtype, forced))
        out[f"K3 {tag} plan"] = ph.plan.describe()
        gen = torch.Generator(device=dev).manual_seed(30)
        p = torch.randn(cfg.ny, cfg.nx, dtype=st.h.dtype, device=dev,
                        generator=gen) * grid.mask
        us, vs, _ = fp.proj_a_plain(st.h, st.u, st.v, statics, 0, cfg)
        phase_b = lambda: ph.b(st.h, us, vs, p, st.t)
        out[f"K3b {tag} digest"] = digest(*phase_b())
        key_a, key_b = ph.kernel_keys()
        kernels((key_b,), phase_b, f"K3b {tag}", 10 if nz > 8 else 20)
        if nz == sm.LAYERS28:
            phase_a = lambda: ph.a(st.h, st.u, st.v, 0)
            out[f"K3a {tag} digest"] = digest(*phase_a())
            kernels((key_a,), phase_a, f"K3a {tag}", 10)
        del cfg, grid, forcing, st, statics, ph, us, vs, p
        torch.cuda.empty_cache()

    for scheme, kw, n_steps in (("fb", {}, 20),
                                ("implicit_fs", dict(precond="jacobi"), 3)):
        cfg, grid, forcing, st = sm.layers_case(
            dev, 34, sm.LAYERS28, "float32", N, scheme=scheme,
            backend="fused", diag_every=n_steps, **kw)
        st = run(cfg, grid, forcing, st, 1, log=io.StringIO())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last = run(cfg, grid, forcing, st, n_steps, log=io.StringIO())
        torch.cuda.synchronize()
        out[f"run() {scheme} nz {sm.LAYERS28} ms/step"] = \
            (time.perf_counter() - t0) / n_steps * 1e3
        out[f"run() {scheme} nz {sm.LAYERS28} digest"] = digest(
            last.h, last.u, last.v)
        del cfg, grid, forcing, st, last
        torch.cuda.empty_cache()
    split_report(sm, dev, out, digest, kernels)
    projection_report(sm, dev, out, digest, kernels)


def mesh_report(sm, dev, out, digest, record) -> None:
    """The --mesh report of the checkout imported: the shard kernels on a
    2 x 4 mesh of the 2048^2 f32 grid on the one card, as each checkout
    launches them, each call's device time summed over its launches (key
    "shard_" or "halo_pad_kernel", launches per call from the checkout's
    counters), with digests of the gathered outputs; the mesh paths
    through run() in ms per step with the device's busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from beom_tpu_torch.cases import make_case
    from beom_tpu_torch.parallel import mesh as pmesh
    from beom_tpu_torch.run import run
    from beom_tpu_torch.stencils import dist_band, halo_pad

    from beom_tpu_torch.stencils import fused_fb
    from beom_tpu_torch.stencils import fused_projection as fp

    m = pmesh.make_mesh(2, 4, devices=[dev])
    new = hasattr(dist_band, "MeshKernels")

    def kernels(statics, cfg):
        # what a stepper keeps across calls: the change's MeshKernels, the
        # parent's contiguous padded statics
        if new:
            return {"kernels": dist_band.MeshKernels(statics, cfg, m)}
        pstat = dist_band.pad_statics(*statics, cfg, m)
        return {"static_blocks": dist_band._static_blocks(pstat, m)}

    def sharded(*tensors):
        # the fields as each checkout's stepper hands them to its kernels:
        # views of the stacked layout on the change
        fields = [pmesh.shard(a, m) for a in tensors]
        if new:
            fields = [dist_band.unstack(dist_band.stack(a), m)
                      for a in fields]
        return fields

    def count():
        # every launch once (the change's "fb_pass" counts a subset of "fb")
        return sum(v for k, v in dist_band.LAUNCHES.items()
                   if k != "fb_pass") + halo_pad.LAUNCHES

    def launches_of(fn):
        before = count()
        fn()
        torch.cuda.synchronize()
        return count() - before

    def timed(name, fn, n, key):
        n_launch = launches_of(fn)
        out[name + " launches"] = n_launch
        out[name + " digest"] = digest(*[pmesh.gather(a) for a in fn()])
        record(name, fn, n, key, n_launch)

    cfg, grid, forcing, st = sm.perturbed_case(dev, 2, nx=N, ny=N,
                                               steps_per_pass=4)
    st = st.replace(t=cfg.npdtype.type(7 * cfg.dt))
    kw = kernels((grid, forcing), cfg)
    pstat = dist_band.pad_statics(grid, forcing, cfg, m)
    f = sharded(st.h, st.u, st.v)
    # the single-device kernels the shard kernels share their bodies
    # with, beside them: K1's 4-step pass, K1s's step, K3a / K3b
    statics = (grid, forcing)
    one = lambda k: fused_fb.fused_fb_step(st.h, st.u, st.v, statics, 0,
                                           st.t, cfg, k)
    n1 = len(fused_fb.plan(cfg, cfg.tdtype, 4).launches(4))
    out["K1 4-step pass digest"] = digest(*one(4))
    record("K1 4-step pass", lambda: one(4), 100, "fb_", n1)
    timed("K7-fb step", lambda: dist_band.shard_step(
        *f, pstat, 0, st.t, cfg, 1, **kw), 100, "shard_")
    timed("K7-fb 4-step pass", lambda: dist_band.shard_step(
        *f, pstat, 0, st.t, cfg, 4, **kw), 30, "shard_")
    timed("K8 pad2d w=5", lambda: [halo_pad.halo_pad(f[0], 5)], 200,
          "halo_pad_kernel")
    del kw, pstat, f

    cfg, grid, forcing, st = sm.perturbed_case(dev, 2, nx=N, ny=N,
                                               scheme="split", nsub=8)
    kw = kernels((grid, forcing), cfg)
    pstat = dist_band.pad_statics(grid, forcing, cfg, m)
    f = sharded(st.h, st.u, st.v)
    timed("K7-split step nsub 8", lambda: dist_band.shard_step(
        *f, pstat, 0, st.t, cfg, 1, **kw), 50, "shard_")
    step = lambda: fused_fb.fused_fb_step(st.h, st.u, st.v, (grid, forcing),
                                          0, st.t, cfg, 1)
    out["K1s step nsub 8 digest"] = digest(*step())
    record("K1s step nsub 8", step, 100, "split_",
           fused_fb.split_plan(cfg).launches())
    del kw, pstat, f

    cfg, grid, forcing, st = sm.perturbed_case(dev, 2, "rigid_lid", nx=N,
                                               ny=N, scheme="implicit_fs")
    kw = kernels((grid, forcing), cfg)
    pstat = dist_band.pad_statics(grid, forcing, cfg, m)
    f = sharded(st.h, st.u, st.v)
    p = sharded((st.h.sum(0) - grid.H) * grid.mask)[0]
    a = dist_band.shard_proj_a(*f, pstat, 0, cfg, **kw)
    timed("K7-proj A", lambda: dist_band.shard_proj_a(
        *f, pstat, 0, cfg, **kw), 100, "shard_pa")
    timed("K7-proj B", lambda: dist_band.shard_proj_b(
        f[0], a[0], a[1], p, pstat, st.t, cfg, **kw), 100, "shard_pb")
    pa, pb = sm.phase_launchers(fp, grid, forcing, cfg)
    u_s, v_s, _ = pa(st.h, st.u, st.v, 0)
    p1 = (st.h.sum(0) - grid.H) * grid.mask
    out["K3a digest"] = digest(*pa(st.h, st.u, st.v, 0))
    out["K3b digest"] = digest(*pb(st.h, u_s, v_s, p1, st.t))
    record("K3a", lambda: pa(st.h, st.u, st.v, 0), 100, "proj_a")
    record("K3b", lambda: pb(st.h, u_s, v_s, p1, st.t), 100, "proj_b")
    del kw, pstat, f, a, p
    torch.cuda.empty_cache()

    def busy(fn):
        # the device's busy share over one call of fn() (after one not
        # profiled): kernel time over wall time
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return sum(r[0] for r in sm.device_rows(prof)) / 1e6 / wall

    for name, kw, n_steps in (
            ("mesh fb run() ms/step", dict(steps_per_pass=4), 200),
            ("mesh split nsub 8 run() ms/step", dict(scheme="split",
                                                     nsub=8), 100),
            ("mesh eager fb rdma run() ms/step", dict(backend="eager",
                                                      halo_impl="rdma"),
             20)):
        cfg, grid, forcing, st = make_case(
            "double_gyre", nx=N, ny=N, device=dev,
            **dict(dict(backend="fused", mesh_y=2, mesh_x=4,
                        diag_every=n_steps // 2), **kw))
        go = lambda: run(cfg, grid, forcing, st, n_steps, log=io.StringIO())
        go()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        go()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / n_steps * 1e3
        out[name.replace("ms/step", "busy share")] = busy(go)


def mesh_solve_report(sm, dev, out, digest) -> None:
    """The --mesh solve report of the checkout imported."""
    import importlib.util

    import torch

    from beom_tpu_torch.cases import make_case
    from beom_tpu_torch.run import run

    on_card = importlib.util.find_spec(
        "beom_tpu_torch.stencils.mesh_solve") is not None
    legs = (
        (f"implicit_fs nz {sm.LAYERS28} 2 x 2 shards", 10,
         lambda n: sm.layers_case(
             dev, 34, sm.LAYERS28, "float32", N, scheme="implicit_fs",
             precond="jacobi", backend="fused", diag_every=n, mesh_y=2,
             mesh_x=2)),
        ("implicit_fs rigid-lid gyre 2 x 4 shards", 10,
         lambda n: make_case("rigid_lid", nx=N, ny=N, device=dev,
                             scheme="implicit_fs", backend="fused",
                             diag_every=n, mesh_y=2, mesh_x=4)),
        (f"rigid_lid CG + multigrid {sm.MG_MESH_N}^2 2 x 2 shards", 2,
         lambda n: make_case("rigid_lid", nx=sm.MG_MESH_N, ny=sm.MG_MESH_N,
                             device=dev, backend="fused", diag_every=n,
                             mesh_y=2, mesh_x=2)))
    for label, n_steps, make in legs:
        cfg, grid, forcing, st = make(n_steps)
        st = run(cfg, grid, forcing, st, 1, log=io.StringIO())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last = run(cfg, grid, forcing, st, n_steps, log=io.StringIO())
        torch.cuda.synchronize()
        out[f"run() {label} ms/step"] = \
            (time.perf_counter() - t0) / n_steps * 1e3
        out[f"run() {label} digest"] = digest(last.h, last.u, last.v)
        if on_card:
            one = lambda: run(cfg, grid, forcing, st, 1, log=io.StringIO())
            out[f"run() {label} K6 device ms/step"] = sm.device_ms(
                label, one, 3, {"cg_": 1})["cg_"]
        del cfg, grid, forcing, st, last
        torch.cuda.empty_cache()


def setup_ms(grid, forcing, cfg, before=None) -> float:
    """The host's ms for what run() makes once per call, its stepper
    (make_stepper), the median of three; before() runs ahead of each."""
    import torch

    from beom_tpu_torch.stepping import make_stepper

    times = []
    for _ in range(3):
        if before is not None:
            before()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        make_stepper(grid, forcing, cfg)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main(root: str, only_split: bool = False,
         only_projection: bool = False, only_mesh: bool = False,
         only_layers: bool = False, layers_split: bool = False,
         layers_projection: bool = False, layers_tiles: bool = False,
         layers_mesh: bool = False, mesh_solve: bool = False) -> dict:
    root = str(Path(root).resolve())
    sys.path.insert(0, root)
    import torch

    import beom_tpu_torch
    from beom_tpu_torch.cases import make_case
    from beom_tpu_torch.parallel import mesh as pmesh
    from beom_tpu_torch.run import run
    from beom_tpu_torch.solvers import multigrid as mg
    from beom_tpu_torch.solvers import elliptic
    from beom_tpu_torch.stencils import (build, cg_fused, dist_band,
                                         fused_fb, redblack)
    from beom_tpu_torch.stencils import fused_projection as fp
    from beom_tpu_torch.stepping import projection

    if not beom_tpu_torch.__file__.startswith(root):
        raise SystemExit(f"imported {beom_tpu_torch.__file__}, not {root}")
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: no CUDA card")
    sm = smoke()
    dev = torch.device("cuda")
    out = {"root": root, "device": torch.cuda.get_device_name(0)}

    def record(name, fn, n, key, launches=1):
        # the device time of the kernels whose name holds `key`, not of
        # the call's other device work (a fill, a copy, a read-back)
        out[name] = [sm.time_ms(fn, n),
                     sm.device_ms(name, fn, 20, {key: launches})[key]]

    def stamped(name, fn):
        # the kernel's span by its stamps, the median of five launches in
        # the timing mode, where the checkout has it
        try:
            from beom_tpu_torch.stencils.stamps import Stamps
        except ImportError:
            return
        out[name + " span"] = statistics.median(
            fn(Stamps()).span for _ in range(5))

    def all_rows(name, fn):
        # the device time of every row the call puts on the card (the
        # kernel, its fills, copies and read-back) over their count: what
        # the key "" of device_ms gave before each kernel was named
        out[name + " all rows"] = sm.device_ms(name, fn, 20, {"": 1})[""]

    def digest(*tensors):
        # a hash of the tensors' bytes: equal digests, bitwise equal
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    def jacobi_times(name, n, case="rigid_lid", **kw):
        # K6 with Jacobi on an implicit-FS solve from eta^n of `case`
        cfg, grid, forcing, st = sm.perturbed_case(
            dev, 2, case, scheme="implicit_fs", **kw)
        _, _, div = fp.proj_a_plain(st.h, st.u, st.v, (grid, forcing), 0,
                                    cfg)
        lam = projection.solve_lam(cfg)
        b, eta_n = projection.implicit_rhs(st.h, div, grid, cfg, lam)
        jacobi = cg_fused.make_cg_solve(grid, cfg, lam=lam)
        out[name + " iterations"] = jacobi(b, eta_n).iters
        record(name, lambda: jacobi(b, eta_n), n, "cg_")
        stamped(name, lambda s: (jacobi(b, eta_n, stamps=s), s)[1])
        return jacobi, b, eta_n

    if only_layers or layers_split or layers_projection or layers_tiles \
            or layers_mesh:
        layers_report(sm, dev, out, digest, layers_split, layers_projection,
                      layers_tiles, layers_mesh)
        out["code"] = code_report(build)
        out["power"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        return out

    if mesh_solve:
        mesh_solve_report(sm, dev, out, digest)
        out["power"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        return out

    if only_mesh:
        mesh_report(sm, dev, out, digest, record)
        out["code"] = code_report(build)
        out["power"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        return out

    if only_projection:
        projection_report(sm, dev, out, digest, record)
        out["code"] = code_report(build)
        out["power"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        return out

    for case, nsub in (("double_gyre", 4), ("double_gyre", 8),
                       ("double_gyre", 12), ("two_layer", 8)):
        cfg, grid, forcing, st = sm.perturbed_case(
            dev, 2, case, nx=N, ny=N, scheme="split", nsub=nsub)
        statics = (grid, forcing)
        step = lambda: fused_fb.fused_fb_step(st.h, st.u, st.v, statics, 0,
                                              st.t, cfg, 1)
        name = f"K1s step {case} nsub {nsub}"
        launches = fused_fb.split_plan(cfg).launches() \
            if hasattr(fused_fb, "split_plan") else 3
        out[name + " launches"] = launches
        out[name + " digest"] = digest(*step())
        record(name, step, 100, "split_", launches)
        if case == "double_gyre" and nsub == 8 \
                and hasattr(fused_fb, "_launch_tail"):
            tend = fused_fb._launch_tend(st.h, st.u, st.v, statics, cfg)
            t1 = st.t + cfg.npdtype.type(cfg.dt)
            record("K1s tend", lambda: fused_fb._launch_tend(
                st.h, st.u, st.v, statics, cfg), 100, "split_tend_kernel")
            record("K1s tail", lambda: fused_fb._launch_tail(
                tend, st.h, st.u, st.v, statics, t1, cfg), 100,
                "split_tail_kernel")
    if only_split:
        out["code"] = code_report(build)
        out["power"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        return out

    cfg, grid, forcing, st = sm.perturbed_case(dev, 2, nx=N, ny=N)
    statics = (grid, forcing)
    record("K1", lambda: fused_fb.fused_fb_step(
        st.h, st.u, st.v, statics, 0, st.t, cfg, 1), 200, "fb_step_kernel")
    # the 4-step pass: the launches it takes on this checkout
    per_pass = len(fused_fb.plan(cfg, cfg.tdtype, 4).launches(4)) \
        if hasattr(fused_fb, "plan") else 4
    out["K1 4-step pass launches"] = per_pass
    record("K1 4-step pass", lambda: fused_fb.fused_fb_step(
        st.h, st.u, st.v, statics, 0, st.t, cfg, 4), 100, "fb_", per_pass)
    for case in ("two_layer", "coastal_wetdry", "shelf_forced"):
        c_cfg, c_grid, c_forcing, c_st = sm.perturbed_case(dev, 2, case,
                                                           nx=N, ny=N)
        record(f"K1 {case}", lambda: fused_fb.fused_fb_step(
            c_st.h, c_st.u, c_st.v, (c_grid, c_forcing), 0, c_st.t, c_cfg,
            1), 100, "fb_step_kernel")

    cfg, grid, forcing, st = sm.perturbed_case(dev, 2, nx=N, ny=N,
                                               scheme="split", nsub=8)
    statics = (grid, forcing)
    slow = fused_fb._launch_slow(st.h, st.u, st.v, statics, cfg)
    sub = fused_fb._launch_subcycle(slow, st.h, st.u, st.v, statics, cfg)
    t1 = st.t + cfg.npdtype.type(cfg.dt)
    record("K1s slow", lambda: fused_fb._launch_slow(
        st.h, st.u, st.v, statics, cfg), 100, "split_slow_kernel")
    record("K1s subcycle", lambda: fused_fb._launch_subcycle(
        slow, st.h, st.u, st.v, statics, cfg), 100, "split_sub_kernel")
    record("K1s recompose", lambda: fused_fb._launch_recompose(
        slow, sub, st.h, st.u, st.v, statics, t1, cfg), 100,
        "split_rec_kernel")

    cfg, grid, forcing, st = sm.perturbed_case(dev, 2, "rigid_lid", nx=N,
                                               ny=N, scheme="implicit_fs")
    pa, pb = sm.phase_launchers(fp, grid, forcing, cfg)
    u_s, v_s, _ = pa(st.h, st.u, st.v, 0)
    p = (st.h.sum(0) - grid.H) * grid.mask
    record("K3a", lambda: pa(st.h, st.u, st.v, 0), 100, "proj_a")
    record("K3b", lambda: pb(st.h, u_s, v_s, p, st.t), 100, "proj_b")

    cfg, grid, forcing, st = sm.perturbed_case(dev, 2, nx=N, ny=N)
    m = pmesh.make_mesh(2, 4, devices=[dev])
    pstat = dist_band.pad_statics(grid, forcing, cfg, m)
    fields = [pmesh.shard(a, m) for a in (st.h, st.u, st.v)]
    if hasattr(dist_band, "MeshKernels"):
        kw = {"kernels": dist_band.MeshKernels((grid, forcing), cfg, m)}
        n7 = 1
    else:
        kw = {"static_blocks": dist_band._static_blocks(pstat, m)}
        n7 = 16
    record("K7 fb step (2, 4)", lambda: dist_band.shard_step(
        *fields, pstat, 0, st.t, cfg, 1, **kw), 100, "shard_step_kernel", n7)

    cfg, grid, forcing, st = sm.perturbed_case(dev, 2, "rigid_lid", nx=N,
                                               ny=N)
    _, _, div = fp.proj_a(st.h, st.u, st.v, (grid, forcing), 0, cfg)
    rhs = projection.rigid_rhs(st.h, div, grid, cfg)
    levels = mg.build_levels(grid, cfg, 0.0)
    gamma = mg.fused_gamma_schedule(levels, 2)
    j0, visit = mg.make_fused_coarse(levels, 0.0, 2, 24, True, gamma=gamma)
    b_tail = rhs
    for coarser in levels[1:j0 + 1]:
        b_tail = mg._restrict2(b_tail) * coarser.mask
    out["K5 visit digest"] = digest(visit(b_tail))
    record("K5 visit", lambda: visit(b_tail), 30, "coarse_kernel")
    all_rows("K5 visit", lambda: visit(b_tail))
    stamped("K5 visit", lambda s: (visit(b_tail, stamps=s), s)[1])
    solve = cg_fused.make_cg_solve(grid, cfg, lam=0.0)
    res = solve(rhs)
    out["K6-mg iterations"] = res.iters
    out["K6-mg cold solve digest"] = digest(res.x, res.resnorm)
    # "cg_": cg_kernel, and K6-Jacobi's cg_jacobi_kernel since it has one
    record("K6-mg cold solve", lambda: solve(rhs), 5, "cg_")
    all_rows("K6-mg cold solve", lambda: solve(rhs))
    stamped("K6-mg cold solve", lambda s: (solve(rhs, stamps=s), s)[1])

    # K4a: the 8-sweep pass on the rigid lid's pressure equation, the
    # pre-smoother's pass on level 0, the blocked solve's pass
    Hu, Hv = [a.contiguous() for a in elliptic.face_depths(grid)]
    rb_args = (Hu, Hv, grid.mask, cfg.dx, cfg.dy)
    p0 = torch.zeros_like(rhs)
    record("K4a 8-sweep pass", lambda: redblack.rb_sweep(
        p0, rhs, *rb_args, k=8, omega=cfg.sor_omega), 50, "rb_pass_kernel")
    lv = levels[0]
    lv_args = (lv.Hu.contiguous(), lv.Hv.contiguous(), lv.mask, lv.dx,
               lv.dy)
    record("K4a k=2 residual pass", lambda: redblack.rb_sweep(
        p0, rhs, *lv_args, k=2, omega=1.0, residual=True), 100,
        "rb_pass_kernel")
    if hasattr(redblack, "solve_pass"):
        solve_pass = sm.rb_solve_pass(rhs * grid.mask, rb_args, 8,
                                      cfg.sor_omega)
        record("K4a solve pass", lambda: solve_pass(p0), 50, "rb_pass_kernel")

    jacobi, b, eta_n = jacobi_times("K6-Jacobi solve", 10, nx=N, ny=N)
    all_rows("K6-Jacobi solve", lambda: jacobi(b, eta_n))
    jacobi_times("K6-Jacobi solve f64", 5, nx=N, ny=N, dtype="float64")
    for dtype in ("float32", "float64"):
        jacobi_times(f"K6-Jacobi solve 200x136 coastal_wetdry {dtype}", 50,
                     "coastal_wetdry", nx=200, ny=136, dtype=dtype)

    for name, kw, n_steps in (
            ("(a) run() ms/step", {"scheme": "implicit_fs"}, 10),
            ("(b) run() ms/step", dict(solver="redblack",
                                       solver_maxiter=sm.RB_MAXITER), 10),
            ("(c) run() ms/step", {}, 10),
            ("(d) run() ms/step", {"solver": "mg"}, 5)):
        cfg, grid, forcing, st = make_case("rigid_lid", nx=N, ny=N,
                                           device=dev, backend="fused",
                                           diag_every=n_steps, **kw)
        st = run(cfg, grid, forcing, st, 1, log=io.StringIO())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(cfg, grid, forcing, st, n_steps, log=io.StringIO())
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / n_steps * 1e3
    cfg, grid, forcing, st = make_case("double_gyre", nx=N, ny=N, device=dev,
                                       backend="fused", steps_per_pass=4,
                                       diag_every=100)
    run(cfg, grid, forcing, st, 400, log=io.StringIO())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(cfg, grid, forcing, st, 400, log=io.StringIO())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 400 * 1e3
    out["main path run() ms/step"] = ms
    out["main path run() grid-points/s"] = N * N / ms * 1e3
    out["code"] = code_report(build)
    out["power"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    return out


if __name__ == "__main__":
    if len(sys.argv) not in (2, 3, 4) or sys.argv[2:] not in (
            [], ["--split"], ["--projection"], ["--mesh"], ["--layers"],
            ["--layers", "split"], ["--layers", "projection"],
            ["--layers", "tiles"], ["--layers", "mesh"],
            ["--mesh", "solve"]):
        raise SystemExit(__doc__)
    print(json.dumps(main(sys.argv[1], sys.argv[2:] == ["--split"],
                          sys.argv[2:] == ["--projection"],
                          sys.argv[2:] == ["--mesh"],
                          sys.argv[2:] == ["--layers"],
                          sys.argv[2:] == ["--layers", "split"],
                          sys.argv[2:] == ["--layers", "projection"],
                          sys.argv[2:] == ["--layers", "tiles"],
                          sys.argv[2:] == ["--layers", "mesh"],
                          sys.argv[2:] == ["--mesh", "solve"])))
