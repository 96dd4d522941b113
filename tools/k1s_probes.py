#!/usr/bin/env python3
"""What holds the split step's kernels K1s back: probe builds of its three
kernels (slow phase, subcycle, recomposition), timed on one NVIDIA GPU.

    python3 tools/k1s_probes.py ROOT

ROOT is a checkout whose `beom_tpu_torch/csrc/split_step.cu` runs the
split step as three kernels on the stage bodies of `csrc/split_body.cuh`
(commit 77eb875 and later).  Its sources are copied into
`build/probes/<variant>/` of this checkout, edited there, built with
ROOT's nvcc flags and the double gyre's defines at nsub 8, and launched
through ctypes on the 2048^2 f32 double gyre from chip_smoke.py's
perturbed state, each kernel from the fields the unedited kernels make:

  k1s           the three kernels as they are
  loads         each kernel with its stages removed: its loads and its
                stores only (the slow phase stores what it loaded; the
                subcycle runs no substep; the recomposition's continuity
                is a sum of its planes, its column rescale and its
                own-point reads stay)
  compute       the stages alone: each kernel's loads replaced by a
                formula, the statics reads by constants; the stores stay
  own           the subcycle with Hu, Hv, dub, dvb and the three masks
                held in registers at the thread's own points: only the
                three exchanged fields U, V, eta in shared memory
  own AxB/T     `own` at a subcycle tile of A x B points and T threads
  tile AxB      the three kernels as they are, the slow phase and the
                recomposition at a tile of A x B points

Each kernel: ms per launch between CUDA events and on the device under
torch.profiler (chip_smoke.py's time_ms and device_ms), whether its
result is bitwise the unedited kernel's, registers and spills (nvcc
-Xptxas -v) and CTAs per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
One JSON line last.

    python3 tools/k1s_probes.py --tail [CASE [DTYPE [NSUB,...]]]

times this checkout's two-launch split step at 2048^2 (default: the f32
double gyre at nsub 4, 8, 12): the slow phase's tendencies (split_tend)
once, and the tail (split_tail) at the best few geometries of each thread
count by fused_fb.tail_cost, each bitwise against the three-kernel step,
beside the three kernels and the step each route takes.

    python3 tools/k1s_probes.py --tail-probes [CASE [DTYPE [NSUB]]]

times probe builds of this checkout's tail at the plan's geometry (default:
the f32 double gyre at nsub 8): `tail` as it is, `nosub` without its
substeps, `noload` with every global read replaced by a formula, `norec`
with the recomposition's continuity replaced by a sum of its planes.

    python3 tools/k1s_probes.py --tend-probes [CASE [DTYPE [NSUB]]]

the same for the two-launch step's slow phase (split_tend): `tend` as it
is, `tend_cpasync` with its block staged by 4-byte cp.async copies,
`tend_loads` with its stages removed (the tendencies' stores read the
staged planes), `tend_compute` with its loads replaced by a formula and
the statics by constants.
"""

from __future__ import annotations

import ctypes
import dataclasses
import importlib.util
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

N = 2048
HERE = Path(__file__).resolve().parents[1]

OCCUPANCY = r"""
extern "C" int beom_probe_ctas(int which) {
  int n = 0;
  if (which == 0)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, split_slow_kernel<float>, THREADS, slow::smem_bytes<float>());
  else if (which == 1)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, split_sub_kernel<float>, sub::THREADS_SUB,
        sub::smem_bytes<float>());
  else
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, split_rec_kernel<float>, THREADS, rec::smem_bytes<float>());
  return n;
}
"""

SLOW_STORES = r"""  for (int k_ = tid; k_ < TX * TY; k_ += THREADS) {
    const int jj = k_ / TX;
    const int ii = k_ % TX;
    if (!o.valid(jj, ii)) continue;
    const int s = (W + jj) * RX + W + ii;
    const long g = o.at(jj, ii);
    const int gs = gidx[s];
    for (int k = 0; k < NZ; ++k) {
      const long gk = k * o.plane + g;
      out.p[S_UP][gk] = u[k * NPT + s];
      out.p[S_VP][gk] = v[k * NPT + s];
      out.p[S_DUP][gk] = h[k * NPT + s];
      out.p[S_DVP][gk] = h[k * NPT + s + RX] + u[k * NPT + s + 1];
    }
    out.p[S_DUBAR][g] = mu[s];
    out.p[S_DVBAR][g] = mv[s];
    out.p[S_UBAR][g] = mask[s];
    out.p[S_VBAR][g] = mq[s];
    out.p[S_HU][g] = p.in[I_HB][gs];
    out.p[S_HV][g] = p.in[I_FQ][gs];
    out.p[S_ETA0][g] = p.in[I_TAUX][gs];
    out.p[S_CU][g] = p.in[I_TAUY][gs];
    out.p[S_CV][g] = v[s + RX] + u[s - 1];
  }
}

"""

SLOW_FILL = r"""  for (int s = tid; s < NPT; s += THREADS) {
    for (int k = 0; k < NZ; ++k) {
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

SUB_READS = r"""#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int s = tid + i * THREADS_SUB;
    if (s >= NPT) continue;
    su[i] = Hu[s] + dub[s] + m[s] + U[s];
    sv[i] = Hv[s] + dvb[s] + mu[s] + mv[s] + V[s];
  }
"""

SUB_FILL = r"""#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int s = tid + i * THREADS_SUB;
    if (s >= NPT) continue;
    const T hu = T(500) + T(s % 7);
    const T hv = T(500) + T(s % 5);
    ub[i] = T(0.01) * T(s % 3);
    vb[i] = T(0.01) * T(s % 5);
    et[i] = T(0.1) * T(s % 7);
    su[i] = T(0);
    sv[i] = T(0);
    Uo[i] = hu * ub[i];
    Vo[i] = hv * vb[i];
    sm[P_HU * NPT + s] = hu;
    sm[P_HV * NPT + s] = hv;
    sm[P_DUB * NPT + s] = T(1e-6);
    sm[P_DVB * NPT + s] = T(2e-6);
    sm[P_M * NPT + s] = T(1);
    sm[P_MU * NPT + s] = T(1);
    sm[P_MV * NPT + s] = T(1);
    U[s] = Uo[i];
    V[s] = Vo[i];
  }
"""

REC_FILL = r"""  for (int s = tid; s < NPT; s += THREADS) {
    for (int k = 0; k < NZ; ++k) {
      h[k * NPT + s] = T(500) + T(s % 7);
      ua[k * NPT + s] = T(0.01) * T(s % 5);
      va[k * NPT + s] = T(0.01) * T(s % 3);
    }
    mask[s] = T(1);
    mu[s] = T(1);
    mv[s] = T(1);
  }
"""

REC_SUM = r"""  REGION(LO, LO, {
    for (int k = 0; k < NZ; ++k)
      h1[k * NPT + s] = h[k * NPT + s] + ua[k * NPT + s] +
                        va[k * NPT + s] + mask[s];
  })
"""


def smoke():
    spec = importlib.util.spec_from_file_location(
        "k1s_probes_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sub(text, old, new, count=1):
    if text.count(old) != count:
        raise SystemExit(f"probe edit: {old!r} found {text.count(old)} "
                         f"times, not {count}")
    return text.replace(old, new)


def section(text, begin, end):
    """(head, the text from `begin` up to `end`, tail)."""
    i = text.index(begin)
    j = text.index(end, i)
    return text[:i], text[i:j], text[j:]


def between(text, begin, end, new):
    """text with what lies strictly between `begin` and `end` (the first
    `end` after `begin`) replaced by `new`."""
    i = text.index(begin) + len(begin)
    j = text.index(end, i)
    return text[:i] + new + text[j:]


def const_statics(terms):
    terms = sub(terms, "    return p.in[i][gidx[s]];",
                "    return T(1e-4) * T(i);")
    return sub(terms, "    return p.in[i][k * p.plane + gidx[s]];",
               "    return T(1e-4) * T(i + k);")


def own_subcycle(body, threads):
    """The subcycle with its seven read-only fields in registers."""
    head, s, tail = section(body, "namespace sub {", "}  // namespace sub")
    s = sub(s, "constexpr int THREADS_SUB = 1024;",
            f"constexpr int THREADS_SUB = {threads};")
    s = sub(s, "enum Plane { P_HU, P_HV, P_DUB, P_DVB, P_M, P_MU, P_MV, P_U, "
               "P_V, P_ETA,\n             N_PLANES };",
            "enum Plane { P_U, P_V, P_ETA, N_PLANES, P_HU, P_HV, P_DUB, "
            "P_DVB, P_M,\n             P_MU, P_MV };")
    s = sub(s, "  T ub[PER], vb[PER], su[PER], sv[PER], et[PER], Uo[PER], "
               "Vo[PER];\n",
            "  T ub[PER], vb[PER], su[PER], sv[PER], et[PER], Uo[PER], "
            "Vo[PER];\n  T hu_r[PER], hv_r[PER], dub_r[PER], dvb_r[PER], "
            "m_r[PER], mu_r[PER],\n      mv_r[PER];\n")
    for old, new in (
            ("    sm[P_HU * NPT + s] = hu;\n", "    hu_r[i] = hu;\n"),
            ("    sm[P_HV * NPT + s] = hv;\n", "    hv_r[i] = hv;\n"),
            ("    sm[P_DUB * NPT + s] = src", "    dub_r[i] = src"),
            ("    sm[P_DVB * NPT + s] = src", "    dvb_r[i] = src"),
            ("    sm[P_M * NPT + s] = p", "    m_r[i] = p"),
            ("    sm[P_MU * NPT + s] = p", "    mu_r[i] = p"),
            ("    sm[P_MV * NPT + s] = p", "    mv_r[i] = p"),
            ("* m[s];", "* m_r[i];"), ("+ dub[s])) * mu[s];",
                                       "+ dub_r[i])) * mu_r[i];"),
            ("+ dvb[s])) * mv[s];", "+ dvb_r[i])) * mv_r[i];"),
            ("Uo[i] = Hu[s] * ub[i];", "Uo[i] = hu_r[i] * ub[i];"),
            ("Vo[i] = Hv[s] * vb[i];", "Vo[i] = hv_r[i] * vb[i];")):
        s = sub(s, old, new)
    return head + s + tail


def variant_sources(src: Path, name: str) -> dict:
    """{file: text} of the edited copies for one variant."""
    body = (src / "split_body.cuh").read_text()
    step = (src / "split_step.cu").read_text()
    files = {"split_step.cu": step + OCCUPANCY}
    kind = name.split()[0]
    if kind == "loads":
        body = between(body, "                           phi, q, lu, lv, "
                             "nullptr};\n", "}  // namespace slow",
                       "\n" + SLOW_STORES)
        body = body.replace("                           phi, q, lu, lv, "
                            "nullptr};\n", "                           "
                            "phi, q, lu, lv, nullptr};\n  (void)c;\n", 1)
        body = between(body, "  const T mg = -p.g;\n",
                       "\n#pragma unroll\n  for (int i = 0; i < PER; ++i) "
                       "{\n    const int s = tid + i * THREADS_SUB;\n    "
                       "const int jj", SUB_READS)
        body = sub(body, "  continuity_stage<T, RX, RY>(c, h, ua, va, h1, "
                         "fx, fy, sc, false);\n", REC_SUM)
        body = sub(body, "    finalize_point<T, RX, NPT>(c, h1, s, uo, "
                         "vo);\n", "")
    elif kind == "compute":
        head, s, tail = section(body, "namespace slow {",
                                "}  // namespace slow")
        s = between(s, "  const int y0 = o.y0 - W;\n",
                    "  __syncthreads();\n", SLOW_FILL)
        body = head + s + tail
        body = between(body, "  T ub[PER], vb[PER], su[PER], sv[PER], "
                             "et[PER], Uo[PER], Vo[PER];\n\n",
                       "  __syncthreads();\n\n  const T mg = -p.g;",
                       SUB_FILL)
        head, s, tail = section(body, "namespace rec {",
                                "}  // namespace rec")
        s = between(s, "  const int y0 = o.y0 - W;\n",
                    "  // load_eta_ext visits", REC_FILL)
        s = sub(s, "src.template get<R_SB + B_ETA>(0, l)", "T(0.1)")
        for old, new in (("sb_ub[g]", "T(0.1)"), ("sb_vb[g]", "T(0.1)"),
                         ("sp_up[gk]", "T(0.01)"), ("sp_vp[gk]", "T(0.02)"),
                         ("sp_dup[gk]", "T(1e-6)"),
                         ("sp_dvp[gk]", "T(2e-6)"),
                         ("sp_cu[g]", "T(1e-5)"), ("sp_cv[g]", "T(2e-5)")):
            s = sub(s, old, new)
        body = head + s + tail
        files["fb_terms.cuh"] = const_statics(
            (src / "fb_terms.cuh").read_text())
    elif kind == "own":
        threads = int(name.split("/")[1]) if "/" in name else 1024
        body = own_subcycle(body, threads)
    files["split_body.cuh"] = body
    return files


def variants(defines):
    """(name, defines) of every probe build."""
    base = [d for d in defines
            if not d.startswith(("BEOM_TX", "BEOM_TY", "BEOM_SX", "BEOM_SY"))]
    tile = [d for d in defines
            if d.startswith(("BEOM_TX", "BEOM_TY", "BEOM_SX", "BEOM_SY"))]
    tx = [d for d in tile if d.startswith(("BEOM_TX", "BEOM_TY"))]
    out = [(v, base + tile) for v in ("k1s", "loads", "compute", "own")]
    for sx, sy, threads in ((64, 64, 1024), (128, 32, 1024), (64, 32, 512),
                            (32, 32, 512), (128, 64, 1024)):
        out.append((f"own {sx}x{sy}/{threads}",
                    base + tx + [f"BEOM_SX={sx}", f"BEOM_SY={sy}"]))
    sxy = [d for d in tile if d.startswith(("BEOM_SX", "BEOM_SY"))]
    for a, b in ((32, 32), (64, 16)):
        out.append((f"tile {a}x{b}",
                    base + sxy + [f"BEOM_TX={a}", f"BEOM_TY={b}"]))
    return out


def usage(log):
    """{kernel: (registers, spill stores, spill loads)} by short name."""
    found, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for \S*(split_\w+?_kernel)", line)
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


def main(root: str) -> dict:
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    import torch

    import beom_tpu_torch
    from beom_tpu_torch.stencils import build, fused_fb

    if not beom_tpu_torch.__file__.startswith(str(root)):
        raise SystemExit(f"imported {beom_tpu_torch.__file__}, not {root}")
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: no CUDA card")
    sm = smoke()
    dev = torch.device("cuda")
    cfg, grid, forcing, st = sm.perturbed_case(dev, 2, nx=N, ny=N,
                                               scheme="split", nsub=8)
    statics = (grid, forcing)
    _, defines = fused_fb.build_spec(cfg)
    src = root / "beom_tpu_torch" / "csrc"
    nvcc = build.nvcc_path()
    jobs = []
    for name, defs in variants(defines):
        out_dir = HERE / "build" / "probes" / re.sub(r"\W", "_", name)
        shutil.rmtree(out_dir, ignore_errors=True)
        shutil.copytree(src, out_dir)
        for f, text in variant_sources(src, name).items():
            (out_dir / f).write_text(text)
        lib = out_dir / "libprobe.so"
        jobs.append((name, lib, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, *(f"-D{d}" for d in defs), "-o",
             str(lib), str(out_dir / "split_step.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))

    # the unedited kernels' fields: each probe kernel starts from them
    t1 = st.t + cfg.npdtype.type(cfg.dt)
    slow_ref = fused_fb._launch_slow(st.h, st.u, st.v, statics, cfg)
    sub_ref = fused_fb._launch_subcycle(slow_ref, st.h, st.u, st.v, statics,
                                        cfg)
    rec_ref = fused_fb._launch_recompose(slow_ref, sub_ref, st.h, st.u, st.v,
                                         statics, t1, cfg)
    ops = fused_fb._array(fused_fb._P, [a.data_ptr() for a in [
        st.h, st.u, st.v] + fused_fb._operands(statics)])
    ints, dbls = fused_fb._scalars(cfg, 0, 0.0)
    ints1, dbls1 = fused_fb._scalars(cfg, 0, t1)
    stream = torch.cuda.current_stream().cuda_stream
    slow_out = [torch.empty_like(a) for a in slow_ref]
    sub_out = [torch.empty_like(a) for a in sub_ref]
    rec_out = [torch.empty_like(a) for a in rec_ref]
    slow_p, sub_p = fused_fb._pointers(slow_ref), fused_fb._pointers(sub_ref)
    res = {"root": str(root), "device": torch.cuda.get_device_name(0),
           "defines": list(defines)}
    step = lambda: fused_fb.fused_fb_step(st.h, st.u, st.v, statics, 0,
                                          st.t, cfg, 1)
    res["k1s step"] = [sm.time_ms(step, 100), sm.device_ms(
        "k1s step", step, 20, {"split_": 3})["split_"]]
    for name, lib_path, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(str(lib_path))
        fns = {}
        for k, n_args in (("slow", 5), ("subcycle", 6), ("recompose", 9)):
            fn = getattr(lib, f"beom_split_{k}_f32")
            fn.argtypes = [ctypes.c_void_p] * n_args
            fn.restype = ctypes.c_int
            fns[k] = fn
        lib.beom_probe_ctas.argtypes = [ctypes.c_int]
        calls = {
            "slow": (lambda: fns["slow"](ops, ints, dbls,
                                         fused_fb._pointers(slow_out),
                                         stream),
                     "split_slow_kernel", slow_out, slow_ref),
            "subcycle": (lambda: fns["subcycle"](
                ops, ints, dbls, slow_p, fused_fb._pointers(sub_out), stream),
                "split_sub_kernel", sub_out, sub_ref),
            "recompose": (lambda: fns["recompose"](
                ops, ints1, dbls1, slow_p, sub_p,
                *[a.data_ptr() for a in rec_out], stream),
                "split_rec_kernel", rec_out, rec_ref)}
        regs = usage(log)
        row = {}
        for i, (k, (call, key, outs, ref)) in enumerate(calls.items()):
            def launch():
                code = call()
                if code:
                    raise SystemExit(f"{name} {k}: CUDA error {code}")

            launch()
            torch.cuda.synchronize()
            row[k] = {
                "ms": sm.time_ms(launch, 100),
                "device_ms": sm.device_ms(f"{name} {k}", launch, 30,
                                          {key: 1})[key],
                "equal": all(torch.equal(a, b) for a, b in zip(outs, ref)),
                "ctas_per_sm": lib.beom_probe_ctas(i),
                "regs_spills": regs.get(key)}
            print(f"   {name} {k}: {row[k]['ms']!r} ms between events, "
                  f"{row[k]['device_ms']!r} on the device, bitwise the "
                  f"kernel: {row[k]['equal']}, {row[k]['ctas_per_sm']} "
                  f"CTAs/SM, registers / spill bytes {row[k]['regs_spills']}",
                  flush=True)
        res[name] = row
    res["power"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    return res


def tail_variant(body, name):
    """split_body.cuh with the tail's probe edit `name`."""
    head, s, tail = section(body, "namespace tail {", "}  // namespace tail")
    if name == "nosub":
        s = sub(s, "  for (int it = 0; it < NSUB; ++it) {",
                "  for (int it = 0; it < 0; ++it) {")
    elif name == "noload":
        for pat, new in ((r"hin\[[^\]]+\]", "T(500)"),
                         (r"uin\[[^\]]+\]", "T(0.01)"),
                         (r"vin\[[^\]]+\]", "T(0.02)"),
                         (r"tend\.p\[T_D[UV]S\]\[[^\]]+\]", "T(1e-6)"),
                         (r"p\.in\[I_MASK(_U|_V)?\]\[g\]", "T(1)"),
                         (r"p\.in\[I_HB\]\[g\]", "T(499)"),
                         (r"p\.in\[i\]\[roff\[s / RX\] \+ coff\[s % RX\]\]",
                          "T(1e-4) * T(i)")):
            s = re.sub(pat, new, s)
    elif name == "norec":
        s = sub(s, "  continuity_stage<T, RX, RY, TileT, A, QT>(c, h, ua, va, "
                   "h1, fx, fy, sc,\n                                      "
                   "      false);\n", REC_SUM.replace("LO, LO", "A + LO, "
                                                       "A + LO"))
    return head + s + tail


CP_ASYNC = r"""
template <int BYTES>
__device__ __forceinline__ void probe_cp_async(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(BYTES) : "memory");
#else
  __builtin_memcpy(dst, src, BYTES);
#endif
}
"""

TEND_STORES = r"""    for (int k_ = tid; k_ < TX * TY; k_ += THREADS) {
      const int jj = k_ / TX;
      const int ii = k_ % TX;
      if (!o.valid(jj, ii)) continue;
      const int s = (W + jj) * RX + W + ii;
      const long g = o.at(jj, ii);
      const int gs = gidx[s];
      for (int k = 0; k < NZ; ++k) {
        out.p[T_DUS][k * o.plane + g] = u[k * NPT + s] + h[k * NPT + s + 1]
            + mask[s] + mu[s] + p.in[I_FQ][gs] + p.in[I_TAUX][gs];
        out.p[T_DVS][k * o.plane + g] = v[k * NPT + s] + h[k * NPT + s + RX]
            + mv[s] + mq[s] + p.in[I_TAUY][gs];
      }
    }
"""


def tend_variant(body, name):
    """split_body.cuh with the tend kernel's probe edit `name`."""
    head, s, tail = section(body, "namespace slow {", "}  // namespace slow")
    loop = s[s.index("  for (int s = tid; s < NPT; s += THREADS) {\n    "
                     "const Loc l"):s.index("  __syncthreads();\n\n  const "
                                            "Tile")]
    if name == "tend_cpasync":
        new = loop
        for f in ("h", "u", "v"):
            new = sub(new, f"      {f}[k * NPT + s] = {f}n[k * src.plane];",
                      f"      probe_cp_async<sizeof(T)>(&{f}[k * NPT + s], "
                      f"&{f}n[k * src.plane]);")
        for f, slot in (("mask", "I_MASK"), ("mu", "I_MASK_U"),
                        ("mv", "I_MASK_V"), ("mq", "I_MASK_Q")):
            new = sub(new, f"    {f}[s] = p.in[{slot}][l.stat];",
                      f"    probe_cp_async<sizeof(T)>(&{f}[s], "
                      f"&p.in[{slot}][l.stat]);")
        new += ('  asm volatile("cp.async.commit_group;\\n" ::: "memory");\n'
                '  asm volatile("cp.async.wait_group 0;\\n" ::: "memory");\n')
        s = s.replace(loop, new)
    elif name == "tend_compute":
        s = s.replace(loop, SLOW_FILL)
    elif name == "tend_loads":
        a = s.index("  if constexpr (NO == N_TEND) {\n")
        b = s.index("  } else {\n", a)
        s = s[:a] + "  if constexpr (NO == N_TEND) {\n" + TEND_STORES + s[b:]
        s = sub(s, "  REGION(1, 1, { c.phi_q(s, false, phi, q); })\n", "")
    return head.replace("namespace beom {", CP_ASYNC + "namespace beom {",
                        1) + s + tail


def main_tend_probes(case="double_gyre", dtype="float32", nsub="8") -> dict:
    sys.path.insert(0, str(HERE))
    import torch

    from beom_tpu_torch.stencils import build, fused_fb

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: no CUDA card")
    sm = smoke()
    dev = torch.device("cuda")
    cfg, grid, forcing, st = sm.perturbed_case(
        dev, 2, case, nx=N, ny=N, dtype=dtype, scheme="split", nsub=int(nsub))
    statics = (grid, forcing)
    _, defines = fused_fb.build_spec(cfg)
    src = HERE / "beom_tpu_torch" / "csrc"
    nvcc = build.nvcc_path()
    jobs = []
    for name in ("tend", "tend_cpasync", "tend_loads", "tend_compute"):
        out_dir = HERE / "build" / "probes" / name
        shutil.rmtree(out_dir, ignore_errors=True)
        shutil.copytree(src, out_dir)
        body = (src / "split_body.cuh").read_text()
        (out_dir / "split_body.cuh").write_text(tend_variant(body, name))
        if name == "tend_compute":
            (out_dir / "fb_terms.cuh").write_text(const_statics(
                (src / "fb_terms.cuh").read_text()))
        lib = out_dir / "libprobe.so"
        jobs.append((name, lib, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o",
             str(lib), str(out_dir / "split_step.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    ref = fused_fb._launch_tend(st.h, st.u, st.v, statics, cfg)
    ops = fused_fb._array(fused_fb._P, [a.data_ptr() for a in [
        st.h, st.u, st.v] + fused_fb._operands(statics)])
    ints, dbls = fused_fb._scalars(cfg, 0, 0.0)
    outs = [torch.empty_like(a) for a in ref]
    suffix = "f32" if dtype == "float32" else "f64"
    res = {"device": torch.cuda.get_device_name(0)}
    for name, lib_path, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        fn = getattr(ctypes.CDLL(str(lib_path)), f"beom_split_tend_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 5
        fn.restype = ctypes.c_int

        def launch():
            code = fn(ops, ints, dbls, fused_fb._pointers(outs),
                      torch.cuda.current_stream().cuda_stream)
            if code:
                raise SystemExit(f"{name}: CUDA error {code}")

        launch()
        torch.cuda.synchronize()
        res[name] = {"ms": sm.time_ms(launch, 100),
                     "device_ms": sm.device_ms(
                         name, launch, 30, {"split_tend_kernel": 1})[
                             "split_tend_kernel"],
                     "equal": all(torch.equal(a, b)
                                  for a, b in zip(outs, ref)),
                     "regs_spills": usage(log).get("split_tend_kernel")}
        print(f"   {name}: {res[name]}", flush=True)
    res["power"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    return res


def main_tail_probes(case="double_gyre", dtype="float32", nsub="8") -> dict:
    sys.path.insert(0, str(HERE))
    import torch

    from beom_tpu_torch.stencils import build, fused_fb

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: no CUDA card")
    sm = smoke()
    dev = torch.device("cuda")
    cfg, grid, forcing, st = sm.perturbed_case(
        dev, 2, case, nx=N, ny=N, dtype=dtype, scheme="split", nsub=int(nsub))
    statics = (grid, forcing)
    _, defines = fused_fb.build_spec(cfg)
    src = HERE / "beom_tpu_torch" / "csrc"
    nvcc = build.nvcc_path()
    jobs = []
    for name in ("tail", "nosub", "noload", "norec"):
        out_dir = HERE / "build" / "probes" / f"tail_{name}"
        shutil.rmtree(out_dir, ignore_errors=True)
        shutil.copytree(src, out_dir)
        body = (src / "split_body.cuh").read_text()
        (out_dir / "split_body.cuh").write_text(tail_variant(body, name))
        lib = out_dir / "libprobe.so"
        jobs.append((name, lib, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o",
             str(lib), str(out_dir / "split_step.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    t1 = st.t + cfg.npdtype.type(cfg.dt)
    tend = fused_fb._launch_tend(st.h, st.u, st.v, statics, cfg)
    ref = fused_fb._launch_tail(tend, st.h, st.u, st.v, statics, t1, cfg)
    ops = fused_fb._array(fused_fb._P, [a.data_ptr() for a in [
        st.h, st.u, st.v] + fused_fb._operands(statics)])
    ints, dbls = fused_fb._scalars(cfg, 0, t1)
    outs = [torch.empty_like(a) for a in ref]
    suffix = "f32" if dtype == "float32" else "f64"
    res = {"device": torch.cuda.get_device_name(0),
           "plan": fused_fb.split_plan(cfg).describe()}
    for name, lib_path, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        fn = getattr(ctypes.CDLL(str(lib_path)), f"beom_split_tail_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 8
        fn.restype = ctypes.c_int

        def launch():
            code = fn(ops, ints, dbls, fused_fb._pointers(tend),
                      *[a.data_ptr() for a in outs],
                      torch.cuda.current_stream().cuda_stream)
            if code:
                raise SystemExit(f"{name}: CUDA error {code}")

        launch()
        torch.cuda.synchronize()
        res[name] = {"ms": sm.time_ms(launch, 100),
                     "device_ms": sm.device_ms(
                         name, launch, 30, {"split_tail_kernel": 1})[
                             "split_tail_kernel"],
                     "equal": all(torch.equal(a, b)
                                  for a, b in zip(outs, ref)),
                     "regs_spills": usage(log).get("split_tail_kernel")}
        print(f"   {name}: {res[name]}", flush=True)
    res["power"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    return res


def main_tail(case="double_gyre", dtype="float32", nsubs="4,8,12") -> dict:
    sys.path.insert(0, str(HERE))
    import torch

    from beom_tpu_torch.stencils import build, fused_fb

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: no CUDA card")
    sm = smoke()
    dev = torch.device("cuda")
    res = {"device": torch.cuda.get_device_name(0), "case": case,
           "dtype": dtype}
    for nsub in map(int, nsubs.split(",")):
        cfg, grid, forcing, st = sm.perturbed_case(
            dev, 2, case, nx=N, ny=N, dtype=dtype, scheme="split", nsub=nsub)
        statics = (grid, forcing)
        fits = fused_fb.tail_geometries(cfg)
        best = []
        for threads in sorted({(g[0] + 2 * fused_fb.tail_halo(cfg)) * g[1]
                               for g in fits}):
            same = [g for g in fits if (g[0] + 2 * fused_fb.tail_halo(cfg))
                    * g[1] == threads]
            best += sorted(same, key=lambda g: fused_fb.tail_cost(cfg, g))[:3]
        # the split plan with the tail geometry g
        at = lambda g: dataclasses.replace(fused_fb.split_plan(cfg), qx=g[0],
                                           qs=g[1], qp=g[2])
        build.build_all([fused_fb.build_spec(cfg, cfg.tdtype, 1, at(g))
                         for g in best])
        t1 = st.t + cfg.npdtype.type(cfg.dt)
        args = (st.h, st.u, st.v, statics)

        def three():
            slow = fused_fb._launch_slow(*args, cfg)
            sub_ = fused_fb._launch_subcycle(slow, *args, cfg)
            return fused_fb._launch_recompose(slow, sub_, *args, t1, cfg)

        ref = three()
        row = {"plan": fused_fb.split_plan(cfg).describe(),
               "three kernels": [sm.time_ms(three, 50), sm.device_ms(
                   f"nsub {nsub} three kernels", three, 20,
                   {"split_": 3})["split_"]]}
        tend = fused_fb._launch_tend(*args, cfg, at(best[0]))
        tend_fn = lambda: fused_fb._launch_tend(*args, cfg, at(best[0]))
        row["tend"] = [sm.time_ms(tend_fn, 100), sm.device_ms(
            f"nsub {nsub} tend", tend_fn, 20,
            {"split_tend_kernel": 1})["split_tend_kernel"]]
        for g in best:
            fn = lambda: fused_fb._launch_tail(tend, *args, t1, cfg, at(g))
            out = fn()
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(out, ref))
            key = "tail {}x{}/{}".format(g[0], g[1] * g[2] - 2 *
                                         fused_fb.tail_halo(cfg),
                                         (g[0] + 2 * fused_fb.tail_halo(cfg))
                                         * g[1])
            row[key] = {"geometry": g, "cost": fused_fb.tail_cost(cfg, g),
                        "ms": sm.time_ms(fn, 100),
                        "device_ms": sm.device_ms(
                            f"nsub {nsub} {key}", fn, 20,
                            {"split_tail_kernel": 1})["split_tail_kernel"],
                        "bitwise_three_kernels": same}
            print(f"   nsub {nsub} {key} {g}: {row[key]['ms']!r} ms, "
                  f"bitwise the three kernels: {same}", flush=True)
        step = lambda: fused_fb.fused_fb_step(*args, 0, st.t, cfg, 1)
        row["step by the plan"] = [sm.time_ms(step, 100), sm.device_ms(
            f"nsub {nsub} step", step, 20, {"split_": 1})["split_"]]
        print(f"   nsub {nsub}: {json.dumps(row)}", flush=True)
        res[f"nsub {nsub}"] = row
    res["power"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    return res


if __name__ == "__main__":
    if len(sys.argv) >= 2 and sys.argv[1] == "--tail":
        print(json.dumps(main_tail(*sys.argv[2:])))
    elif len(sys.argv) >= 2 and sys.argv[1] == "--tail-probes":
        print(json.dumps(main_tail_probes(*sys.argv[2:])))
    elif len(sys.argv) >= 2 and sys.argv[1] == "--tend-probes":
        print(json.dumps(main_tend_probes(*sys.argv[2:])))
    elif len(sys.argv) == 2:
        print(json.dumps(main(sys.argv[1])))
    else:
        raise SystemExit(__doc__)
