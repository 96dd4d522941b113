#!/usr/bin/env python3
"""What holds the projection step's phase kernels K3a and K3b back, and
where a projection step's time goes, on one NVIDIA GPU.

    python3 tools/k3_probes.py ROOT

ROOT is a checkout whose `beom_tpu_torch/csrc/projection.cu` runs K3a and
K3b as `proj_a_kernel` and `proj_b_kernel` on the stage bodies of
`csrc/projection_body.cuh` (namespaces pa, pb; commit 49a6054 and later).
Its sources are copied into `build/probes/k3/<case>_<variant>/` of this
checkout, edited there, built with ROOT's nvcc flags and each case's
defines, and launched through ctypes at 2048^2 f32 from chip_smoke.py's
perturbed state (implicit FS on the rigid-lid gyre, two_layer,
coastal_wetdry, shelf_forced), each from the fields the unedited kernels
take:

  as_is     the two kernels as they are
  loads     their loads and stores alone: K3a without S1 to S3 (its
            divergence from the loaded u, v; the statics its stages gather,
            f and the wind, go with them), K3b without the correction, the
            continuity and finalize (h1 the loaded h)
  stages    their stages alone: the block's loads replaced by a formula,
            the statics read by constants; the stores stay

Each kernel: ms per launch between CUDA events and on the device under
torch.profiler (chip_smoke.py's time_ms and device_ms), whether its result
is bitwise the unedited kernel's, registers and spills (nvcc -Xptxas -v)
and CTAs per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor).  Then
ROOT's paths (a) (implicit FS, CG + Jacobi) and (b) (the rigid lid's
red-black solve) through run(), 20 and 10 steps at 2048^2 f32 with
diagnostics every 10 and 5 steps, by part (chip_smoke.step_parts: the
device time of K3a, K3b, the solve and each glue kernel per step, the idle
share, the idle gaps by the parts around them), and the host's time per
launch of ROOT's phase kernels as its stepper launches them (a held
Phases where ROOT has one, else proj_a and proj_b:
chip_smoke.phase_launchers).  One JSON line last.

    python3 tools/k3_probes.py --staged [CASE|all [DTYPE]]

the same probes of this checkout's staged kernels (proj_as, proj_bs:
namespaces pas, pbs) at each case's plan (default: every case at f32):
`as_is`; `loads` (K3a without S1 to S3, its divergence from the staged u,
v; K3b without the correction and the continuity, finalize's gates and
Flather still on); `stages` (the block's copies replaced by a formula,
the statics finalize reads and the tide's amplitude and phase by
constants).

    python3 tools/k3_probes.py --sweep [CASE|all [DTYPE]]

times this checkout's phase kernels at every geometry of
`fused_projection.candidates` (default: every case at f32), each bitwise
against the plain versions, beside the single-step kernels and the
plan's choice; one JSON line last.
"""

from __future__ import annotations

import ctypes
import importlib.util
import io
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

N = 2048
HERE = Path(__file__).resolve().parents[1]
CASES = ("rigid_lid", "two_layer", "coastal_wetdry", "shelf_forced")

OCCUPANCY = r"""
extern "C" int beom_probe_ctas(int which) {
  int n = 0;
  if (which == 0)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, proj_a_kernel<float>, THREADS, pa::smem_bytes<float>());
  else
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, proj_b_kernel<float>, THREADS, pb::smem_bytes<float>());
  return n;
}
"""

A_FILL = r"""    for (int k = 0; k < NZ; ++k) {
      h[k * NPT + s] = T(500) + T(s % 7);
      u[k * NPT + s] = T(0.01) * T(s % 5);
      v[k * NPT + s] = T(0.01) * T(s % 3);
    }
    mask[s] = T(1);
    mu[s] = T(1);
    mv[s] = T(1);
    mq[s] = T(1);
  }
"""

B_FILL = r"""    for (int k = 0; k < NZ; ++k) {
      h[k * NPT + s] = T(500) + T(s % 7);
      ua[k * NPT + s] = T(0.01) * T(s % 5);
      va[k * NPT + s] = T(0.01) * T(s % 3);
    }
    pr[s] = T(0.1) * T(s % 11);
    mask[s] = T(1);
    mu[s] = T(1);
    mv[s] = T(1);
  }
"""


def smoke():
    spec = importlib.util.spec_from_file_location(
        "k3_probes_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sub(text, old, new, count=1):
    if text.count(old) != count:
        raise SystemExit(f"probe edit: {old!r} found {text.count(old)} "
                         f"times, not {count}")
    return text.replace(old, new)


def between(text, begin, end, new):
    """text with what lies strictly between `begin` and `end` (the first
    `end` after `begin`) replaced by `new`."""
    i = text.index(begin) + len(begin)
    j = text.index(end, i)
    return text[:i] + new + text[j:]


def variant_sources(src: Path, variant: str) -> dict:
    """{file: text} of the edited copies for one variant."""
    body = (src / "projection_body.cuh").read_text()
    files = {"projection.cu": (src / "projection.cu").read_text()
             + OCCUPANCY}
    if variant == "loads":
        body = between(
            body, "                           phi, q, lu, lv, nullptr};\n",
            "  // S4: transport divergence",
            "\n  a1 = u;\n  a2 = v;\n  (void)c;\n\n")
        body = between(body, "  __syncthreads();\n\n  // S1: the barotropic "
                             "correction, the same in every layer, in "
                             "place\n", "  // S2: the layer continuity",
                       "  h1 = h;\n  (void)pr;\n\n")
        body = sub(body, "  continuity_stage<T, RX, RY>(c, h, ua, va, h1, "
                         "fx, fy, sc, false);\n", "")
        body = sub(body, "    finalize_point<T, RX, NPT>(c, h1, s, uo, "
                         "vo);\n", "")
    elif variant == "stages":
        i = body.index("namespace pa {")
        j = body.index("namespace pb {")
        a, b = body[i:j], body[j:]
        a = between(a, "    gidx[s] = l.stat;\n", "  __syncthreads();\n",
                    A_FILL)
        b = between(b, "    gidx[s] = l.stat;\n", "  // load_eta_ext",
                    B_FILL)
        body = body[:i] + a + b
        terms = (src / "fb_terms.cuh").read_text()
        terms = sub(terms, "    return p.in[i][gidx[s]];",
                    "    return T(1e-4) * T(i);")
        terms = sub(terms, "    return p.in[i][k * p.plane + gidx[s]];",
                    "    return T(1e-4) * T(i + k);")
        terms = sub(terms, "      e = e + p.in[I_TIDE_AMP][g] *\n"
                           "                  tcos(p.omega[c] * p.t1 - "
                           "p.in[I_TIDE_PHASE][g]);",
                    "      e = e + T(0.1) * tcos(p.omega[c] * p.t1 - "
                    "T(1e-3) * T(g & 7));")
        files["fb_terms.cuh"] = terms
    files["projection_body.cuh"] = body
    return files


STAGED_OCCUPANCY = r"""
extern "C" int beom_probe_ctas(int which) {
  int n = 0;
  if (which == 0)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, proj_as_kernel<float>, pas::THREADS, pas::smem_bytes<float>());
  else
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, proj_bs_kernel<float>, pbs::THREADS, pbs::smem_bytes<float>());
  return n;
}
"""

AS_FILL = r"""  for (int s = threadIdx.x; s < NPT; s += THREADS) {
    for (int k = 0; k < NZ; ++k) {
      in[(Q_H + k) * NPT + s] = T(500) + T(s % 7);
      in[(Q_U + k) * NPT + s] = T(0.01) * T(s % 5);
      in[(Q_V + k) * NPT + s] = T(0.01) * T(s % 3);
    }
    in[Q_M * NPT + s] = T(1);
    in[Q_MU * NPT + s] = T(1);
    in[Q_MV * NPT + s] = T(1);
    in[Q_MQ * NPT + s] = T(1);
    in[Q_FQ * NPT + s] = T(1e-4);
    if (WIND) {
      in[Q_TAUX * NPT + s] = T(1e-5);
      in[Q_TAUY * NPT + s] = T(2e-5);
    }
    if (SPONGE) in[Q_SPONGE * NPT + s] = T(1e-6);
  }
  fbp::cp_async_commit();
  fbp::cp_async_commit();
}

"""

BS_FILL = r"""  for (int s = tid; s < NPT; s += THREADS) {
    for (int k = 0; k < NZ; ++k) {
      h[k * NPT + s] = T(500) + T(s % 7);
      ua[k * NPT + s] = T(0.01) * T(s % 5);
      va[k * NPT + s] = T(0.01) * T(s % 3);
    }
    pr[s] = T(0.1) * T(s % 11);
    mask[s] = T(1);
    mu[s] = T(1);
    mv[s] = T(1);
  }
"""


def staged_sources(src: Path, variant: str) -> dict:
    """{file: text} of the edited copies of the staged kernels."""
    body = (src / "projection_body.cuh").read_text()
    files = {"projection.cu": (src / "projection.cu").read_text()
             + STAGED_OCCUPANCY}
    i = body.index("namespace pas {")
    j = body.index("namespace pbs {")
    head, a, b = body[:i], body[i:j], body[j:]
    if variant == "loads":
        a = between(a, "                phi, q, lu, lv, nullptr};\n",
                    "  // S4: the transport divergence",
                    "  const bool sad = p.sadourny;\n  const bool uf = "
                    "p.u_first;\n  a1 = u;\n  a2 = v;\n  t2 = h;\n  "
                    "(void)c;\n  (void)t1;\n  fbp::cp_async_wait<0>();\n"
                    "  __syncthreads();\n\n")
        b = between(b, "  // S1: the barotropic correction, the same in every "
                       "layer, in place\n", "  // S2: the layer continuity",
                    "  h1 = h;\n  (void)pr;\n\n")
        b = sub(b, "  continuity_stage<T, RX, RY, TileT, 0, THREADS>(c, h, "
                   "ua, va, h1, fx, fy,\n                                    "
                   "             sc, false);\n", "")
    elif variant == "stages":
        a = between(a, "    stg::stage<T, RX, RY, THREADS>(src, p.plane, nl, "
                       "dst, roff, coff, x0,\n                                   "
                       "vec);\n  };\n", "// S1 to S4 of the tile", AS_FILL)
        b = between(b, "  stage(p.in[I_H], NZ, h);\n",
                    "  fbp::cp_async_commit();\n  // obc", "")
        b = sub(b, "  stage(p.in[I_H], NZ, h);\n", BS_FILL)
        b = sub(b, "        e = e + p.in[I_TIDE_AMP][gc] *\n"
                   "                    tcos(p.omega[c] * p.t1 - "
                   "p.in[I_TIDE_PHASE][gc]);",
                "        e = e + T(0.1) * tcos(p.omega[c] * p.t1 - "
                "T(1e-3) * T(gc & 7));")
        b = sub(b, "    return p.in[i][roff[s / RX] + coff[s % RX]];",
                "    return T(1e-4) * T(i) + T(0 * roff[s / RX]);")
    files["projection_body.cuh"] = head + a + b
    return files


def staged_probes(sm, dev, cases, dtype) -> dict:
    """Probe builds of this checkout's staged kernels at each case's
    plan."""
    import torch

    from beom_tpu_torch.stencils import build
    from beom_tpu_torch.stencils import fused_projection as fp

    src = HERE / "beom_tpu_torch" / "csrc"
    nvcc = build.nvcc_path()
    jobs, states = [], {}
    for case in cases:
        cfg, grid, forcing, st = case_state(sm, dev, case, dtype=dtype)
        ph = fp.Phases(grid, forcing, cfg)
        states[case] = (cfg, grid, forcing, st, ph)
        _, defines = fp.build_spec(cfg, cfg.tdtype, ph.plan, ph.dmask)
        for variant in ("as_is", "loads", "stages"):
            out_dir = HERE / "build" / "probes" / "k3s" / f"{case}_{variant}"
            shutil.rmtree(out_dir, ignore_errors=True)
            shutil.copytree(src, out_dir)
            for f, text in staged_sources(src, variant).items():
                (out_dir / f).write_text(text)
            lib = out_dir / "libprobe.so"
            jobs.append((case, variant, lib, subprocess.Popen(
                [nvcc, *build.NVCC_FLAGS, *(f"-D{d}" for d in defines),
                 "-o", str(lib), str(out_dir / "projection.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    res = {}
    P, D = ctypes.c_void_p, ctypes.c_double
    suffix = "f32" if dtype == "float32" else "f64"
    for case, variant, lib_path, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {case} {variant}:\n{log}")
        cfg, grid, forcing, st, ph0 = states[case]
        statics = (grid, forcing)
        p = (st.h.sum(0) - grid.H) * grid.mask
        ref_a = fp.proj_a_plain(st.h, st.u, st.v, statics, 0, cfg)
        ref_b = fp.proj_b_plain(st.h, ref_a[0], ref_a[1], p, statics, st.t,
                                cfg)
        lib = ctypes.CDLL(str(lib_path))
        lib.beom_cuda_error_string.argtypes = [ctypes.c_int]
        lib.beom_cuda_error_string.restype = ctypes.c_char_p
        ph = fp.Phases(grid, forcing, cfg)
        ph.lib = lib
        for kernel, args in (("proj_as", [P] * 6 + [D, P]),
                             ("proj_bs", [P] * 4 + [D] + [P] * 4)):
            fn = getattr(lib, f"beom_{kernel}_{suffix}")
            fn.argtypes, fn.restype = args, ctypes.c_int
            ph.fn[kernel] = fn
        lib.beom_probe_ctas.argtypes = [ctypes.c_int]
        regs = usage(log)
        calls = {"K3a": (lambda: ph.a(st.h, st.u, st.v, 0), "proj_as_kernel",
                         ref_a),
                 "K3b": (lambda: ph.b(st.h, ref_a[0], ref_a[1], p, st.t),
                         "proj_bs_kernel", ref_b)}
        res.setdefault(case, {"plan": ph0.plan.describe()})
        for i, (k, (call, key, ref)) in enumerate(calls.items()):
            out = call()
            torch.cuda.synchronize()
            row = {"ms": sm.time_ms(call, 100),
                   "device_ms": sm.device_ms(f"{case} {variant} {k}", call,
                                             30, {key: 1})[key],
                   "equal": all(torch.equal(a, b) for a, b in zip(out, ref)),
                   "ctas_per_sm": lib.beom_probe_ctas(i),
                   "regs_spills": regs.get(key)}
            res[case][f"{k} {variant}"] = row
            print(f"   staged {case} {k} {variant}: {row['ms']!r} ms between"
                  f" events, {row['device_ms']!r} on the device, bitwise the"
                  f" plain phase: {row['equal']}, {row['ctas_per_sm']} "
                  f"CTAs/SM, registers / spill bytes {row['regs_spills']}",
                  flush=True)
    return res


def usage(log):
    """{kernel: (registers, spill stores, spill loads)} by short name."""
    found, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for \S*(proj_\w+?_kernel)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            found.setdefault(name, [None, 0, 0])[1:] = [int(m.group(1)),
                                                        int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            found.setdefault(name, [None, 0, 0])[0] = int(m.group(1))
    return found


def case_state(sm, dev, case, **kw):
    """chip_smoke's perturbed implicit-FS case at 2048^2, the tide on."""
    cfg, grid, forcing, st = sm.perturbed_case(dev, 2, case, nx=N, ny=N,
                                               scheme="implicit_fs", **kw)
    if case != "rigid_lid":
        st = st.replace(t=cfg.npdtype.type(7 * cfg.dt))
    return cfg, grid, forcing, st


def probes(root: Path, sm, dev) -> dict:
    import torch

    from beom_tpu_torch.cases import make_case
    from beom_tpu_torch.stencils import build, fused_fb
    from beom_tpu_torch.stencils import fused_projection as fp

    src = root / "beom_tpu_torch" / "csrc"
    nvcc = build.nvcc_path()
    jobs = []
    for case in CASES:
        cfg = make_case(case, nx=16, ny=16, device="cpu",
                        scheme="implicit_fs")[0]
        _, defines = fp.build_spec(cfg, torch.float32)
        for variant in ("as_is", "loads", "stages"):
            out_dir = HERE / "build" / "probes" / "k3" / f"{case}_{variant}"
            shutil.rmtree(out_dir, ignore_errors=True)
            shutil.copytree(src, out_dir)
            for f, text in variant_sources(src, variant).items():
                (out_dir / f).write_text(text)
            lib = out_dir / "libprobe.so"
            jobs.append((case, variant, lib, subprocess.Popen(
                [nvcc, *build.NVCC_FLAGS, *(f"-D{d}" for d in defines),
                 "-o", str(lib), str(out_dir / "projection.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    res = {}
    P, D = ctypes.c_void_p, ctypes.c_double
    by_case = {}
    for case, variant, lib_path, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {case} {variant}:\n{log}")
        if case not in by_case:
            cfg, grid, forcing, st = case_state(sm, dev, case)
            statics = (grid, forcing)
            pa, pb = sm.phase_launchers(fp, grid, forcing, cfg)
            ref_a = pa(st.h, st.u, st.v, 0)
            p = (st.h.sum(0) - grid.H) * grid.mask
            ref_b = pb(st.h, ref_a[0], ref_a[1], p, st.t)
            torch.cuda.synchronize()
            t1 = st.t + cfg.npdtype.type(cfg.dt)
            ops_a = fused_fb._array(fused_fb._P, [
                x.data_ptr() for x in [st.h, st.u, st.v]
                + fused_fb._operands(statics)])
            ops_b = fused_fb._array(fused_fb._P, [
                x.data_ptr() for x in [st.h, ref_a[0], ref_a[1]]
                + fused_fb._operands(statics)])
            by_case[case] = dict(
                cfg=cfg, st=st, statics=statics, p=p, ref_a=ref_a,
                ref_b=ref_b, ops_a=ops_a, ops_b=ops_b,
                sc_a=fused_fb._scalars(cfg, 0, 0.0),
                sc_b=fused_fb._scalars(cfg, 0, t1),
                out_a=[torch.empty_like(a) for a in ref_a],
                out_b=[torch.empty_like(a) for a in ref_b])
            res[case] = {"wrapper K3a": [sm.time_ms(
                lambda: pa(st.h, st.u, st.v, 0), 100)],
                "wrapper K3b": [sm.time_ms(
                    lambda: pb(st.h, ref_a[0], ref_a[1], p, st.t), 100)]}
        c = by_case[case]
        lib = ctypes.CDLL(str(lib_path))
        fa = lib.beom_proj_a_f32
        fa.argtypes, fa.restype = [P] * 7, ctypes.c_int
        fb_ = lib.beom_proj_b_f32
        fb_.argtypes, fb_.restype = [P] * 4 + [D] + [P] * 4, ctypes.c_int
        lib.beom_probe_ctas.argtypes = [ctypes.c_int]
        stream = torch.cuda.current_stream().cuda_stream
        corr = fp._corr(c["cfg"])
        calls = {
            "K3a": (lambda: fa(c["ops_a"], *c["sc_a"],
                               *[a.data_ptr() for a in c["out_a"]], stream),
                    "proj_a_kernel", c["out_a"], c["ref_a"]),
            "K3b": (lambda: fb_(c["ops_b"], *c["sc_b"], c["p"].data_ptr(),
                                corr, *[a.data_ptr() for a in c["out_b"]],
                                stream),
                    "proj_b_kernel", c["out_b"], c["ref_b"])}
        regs = usage(log)
        for i, (k, (call, key, outs, ref)) in enumerate(calls.items()):
            def launch():
                code = call()
                if code:
                    raise SystemExit(f"{case} {variant} {k}: CUDA error "
                                     f"{code}")

            launch()
            torch.cuda.synchronize()
            row = {"ms": sm.time_ms(launch, 100),
                   "device_ms": sm.device_ms(f"{case} {variant} {k}", launch,
                                             30, {key: 1})[key],
                   "equal": all(torch.equal(a, b)
                                for a, b in zip(outs, ref)),
                   "ctas_per_sm": lib.beom_probe_ctas(i),
                   "regs_spills": regs.get(key)}
            res[case][f"{k} {variant}"] = row
            print(f"   {case} {k} {variant}: {row['ms']!r} ms between "
                  f"events, {row['device_ms']!r} on the device, bitwise the "
                  f"kernel: {row['equal']}, {row['ctas_per_sm']} CTAs/SM, "
                  f"registers / spill bytes {row['regs_spills']}",
                  flush=True)
    return res


def parts(sm, dev) -> dict:
    """ROOT's paths (a) and (b) by part, and the host's time per launch of
    its phase kernels."""
    import torch

    from beom_tpu_torch.cases import make_case
    from beom_tpu_torch.run import run
    from beom_tpu_torch.stencils import fused_projection as fp

    res = {}
    for name, kw, n_steps, diag, keys in (
            ("(a)", {"scheme": "implicit_fs"}, 20, 10, ("cg_",)),
            ("(b)", dict(solver="redblack", solver_maxiter=sm.RB_MAXITER),
             10, 5, ("rb_",))):
        cfg, grid, forcing, st = make_case("rigid_lid", nx=N, ny=N,
                                           device=dev, backend="fused",
                                           diag_every=diag, **kw)
        st = run(cfg, grid, forcing, st, 2, log=io.StringIO())
        res[name] = sm.step_parts(
            f"{name} run() {n_steps} steps", lambda: run(
                cfg, grid, forcing, st, n_steps, log=io.StringIO()),
            n_steps, keys)
    cfg, grid, forcing, st = case_state(sm, dev, "rigid_lid")
    pa, pb = sm.phase_launchers(fp, grid, forcing, cfg)
    u_s, v_s, div = pa(st.h, st.u, st.v, 0)
    p = (st.h.sum(0) - grid.H) * grid.mask
    res["host us proj_a"] = sm.host_us(lambda: pa(st.h, st.u, st.v, 0))
    res["host us proj_b"] = sm.host_us(lambda: pb(st.h, u_s, v_s, p, st.t))
    print("   host us per launch: " + ", ".join(
        f"{k[8:]} {v:.1f}" for k, v in res.items()
        if k.startswith("host us")))
    return res


def sweep(sm, dev, cases, dtype) -> dict:
    """This checkout's phase kernels at every candidate geometry."""
    import torch

    from beom_tpu_torch.stencils import build
    from beom_tpu_torch.stencils import fused_projection as fp

    res = {}
    states, specs = {}, []
    for case in cases:
        cfg, grid, forcing, st = case_state(sm, dev, case, dtype=dtype)
        dmask = fp.derived_masks(grid)
        plans = [fp.PhasePlan(None, None, False)] \
            + fp.candidates(cfg, cfg.tdtype)
        specs += [fp.build_spec(cfg, cfg.tdtype, pl, dmask) for pl in plans]
        states[case] = (cfg, grid, forcing, st, plans)
    build.build_all(specs)
    for case, (cfg, grid, forcing, st, plans) in states.items():
        statics = (grid, forcing)
        p = (st.h.sum(0) - grid.H) * grid.mask
        ref_a = fp.proj_a_plain(st.h, st.u, st.v, statics, 0, cfg)
        ref_b = fp.proj_b_plain(st.h, ref_a[0], ref_a[1], p, statics, st.t,
                                cfg)
        best = fp.plan(cfg, cfg.tdtype)
        elem = st.h.element_size()
        row = {"plan": best.describe()}
        for pl in plans:
            ph = fp.Phases(grid, forcing, cfg, phase_plan=pl)
            tag = "single-step kernels" if pl.a is None else \
                f"A {pl.a.describe()}, B {pl.b.describe()}"
            a = ph.a(st.h, st.u, st.v, 0)
            b = ph.b(st.h, ref_a[0], ref_a[1], p, st.t)
            torch.cuda.synchronize()
            equal = all(torch.equal(x, y) for x, y in zip(a, ref_a)) \
                and all(torch.equal(x, y) for x, y in zip(b, ref_b))
            ka, kb = ph.kernel_keys()
            ms = [sm.time_ms(lambda: ph.a(st.h, st.u, st.v, 0), 50),
                  sm.time_ms(lambda: ph.b(st.h, ref_a[0], ref_a[1], p,
                                          st.t), 50)]
            dv = sm.device_ms(f"{case} {tag}", lambda: (
                ph.a(st.h, st.u, st.v, 0),
                ph.b(st.h, ref_a[0], ref_a[1], p, st.t)), 20,
                {ka: 1, kb: 1})
            row[tag] = {"K3a ms": ms[0], "K3b ms": ms[1],
                        "K3a device": dv[ka], "K3b device": dv[kb],
                        "bitwise": equal,
                        "cost": None if pl.a is None else [
                            fp.geometry_cost(cfg, pl.a, "proj_as", elem),
                            fp.geometry_cost(cfg, pl.b, "proj_bs", elem)]}
            print(f"   {case} {dtype} {tag}: K3a {ms[0]!r} / {dv[ka]!r}, "
                  f"K3b {ms[1]!r} / {dv[kb]!r} ms (events / device), "
                  f"bitwise the plain versions: {equal}", flush=True)
        print(f"   {case} {dtype} plan: {best.describe()}")
        res[case] = row
    return res


def main(argv) -> dict:
    sweeping = argv[:1] in (["--sweep"], ["--staged"])
    root = HERE if sweeping else Path(argv[0]).resolve()
    sys.path.insert(0, str(root))
    import torch

    import beom_tpu_torch

    if not beom_tpu_torch.__file__.startswith(str(root)):
        raise SystemExit(f"imported {beom_tpu_torch.__file__}, not {root}")
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: no CUDA card")
    sm = smoke()
    dev = torch.device("cuda")
    res = {"root": str(root), "device": torch.cuda.get_device_name(0)}
    if argv[:1] == ["--staged"]:
        cases = [c for c in argv[1:2] if c != "all"] or list(CASES)
        dtype = argv[2] if len(argv) > 2 else "float32"
        res["staged"] = staged_probes(sm, dev, cases, dtype)
    elif sweeping:
        cases = [c for c in argv[1:2] if c != "all"] or list(CASES)
        dtype = argv[2] if len(argv) > 2 else "float32"
        res["sweep"] = sweep(sm, dev, cases, dtype)
    else:
        res["probes"] = probes(root, sm, dev)
        res["parts"] = parts(sm, dev)
    res["power"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    return res


if __name__ == "__main__":
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    print(json.dumps(main(sys.argv[1:])))
