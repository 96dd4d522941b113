#!/usr/bin/env python3
"""What holds the fb kernel K1 back: probe builds of it, timed on one
NVIDIA GPU.

    python3 tools/k1_probes.py ROOT
    python3 tools/k1_probes.py --pass

ROOT is a checkout whose `beom_tpu_torch/csrc/fb_step.cu` is the
single-step K1 with its per-point offset table (commit 8d5958c).  Its
sources are copied into `build/probes/<variant>/` of this checkout, edited
there, built with ROOT's nvcc flags and the double gyre's defines, and
launched through ctypes on the 2048^2 f32 double gyre from chip_smoke.py's
perturbed state:

  k1            K1 as it is
  loads         S0 (h, u, v and the four masks into shared memory, through
                the offset table) and the interior stores only: the load
                roof of the tile plan
  loads_all     as `loads`, and H, f_q, taux and tauy read at every block
                point too: every operand K1 reads
  direct        K1 without the offset table on tiles that cross no seam:
                direct addresses in S0 and in every statics read
  compute       the stages alone: S0 fills shared memory from a formula,
                statics reads return a constant, the stores stay
  tile AxB      K1 as it is at other tiles (defines only)

Each: ms per launch between CUDA events and on the device under
torch.profiler (chip_smoke.py's time_ms and device_ms), registers and
spills (nvcc -Xptxas -v) and CTAs per SM
(cudaOccupancyMaxActiveBlocksPerMultiprocessor).  One JSON line last.

With --pass, the same for this checkout's pass kernel (kb steps per
launch, BEOM_KB > 1) at the double gyre's plan, one launch of kb steps:

  pass          the pass kernel as it is
  pass_loads    S0 (both groups of copies) and the interior stores only
  pass_compute  the kb steps alone: S0 fills the planes from constants
  pass_nosync   as pass_compute without the barrier after each stage
                region (wrong results: what the barriers cost at most)
"""

from __future__ import annotations

import ctypes
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
extern "C" int beom_probe_ctas(int is_f64) {
  int n = 0;
  if (is_f64)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, fb_step_kernel<double>, THREADS, smem_bytes<double>());
  else
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, fb_step_kernel<float>, THREADS, smem_bytes<float>());
  return n;
}
"""

# the interior stores of the probes without stages: each output reads the
# planes S0 filled, so no load is dead
STORE_ONLY = r"""
  for (int k_ = tid; k_ < TX * TY; k_ += THREADS) {
    const int jj = k_ / TX, ii = k_ % TX;
    const Out o{int(blockIdx.y) * TY, int(blockIdx.x) * TX, p.ny, p.nx,
                p.plane};
    if (!o.valid(jj, ii)) continue;
    const int s = (W + jj) * RX + W + ii;
    T extra = sm[P_M * NPT + s] + sm[P_MQ * NPT + s];
    EXTRA_READS
    for (int k = 0; k < NZ; ++k) {
      const long g = k * o.plane + o.at(jj, ii);
      out_h[g] = h[k * NPT + s] + extra;
      out_u[g] = u[k * NPT + s] + sm[P_MU * NPT + s];
      out_v[g] = v[k * NPT + s] + sm[P_MV * NPT + s];
    }
  }
"""

# H, f_q, taux, tauy read at every block point (into the scratch planes)
ALL_STATICS = r"""
  for (int s = tid; s < NPT; s += THREADS) {
    const int g = gidx[s];
    sm[P_H1 * NPT + s] = p.in[I_HB][g] + p.in[I_FQ][g];
    sm[P_PHI * NPT + s] = p.in[I_TAUX][g] + p.in[I_TAUY][g];
  }
  __syncthreads();
"""

DIRECT_TEST = ("const int x0_ = int(blockIdx.x) * TX - W, "
               "y0_ = int(blockIdx.y) * TY - W; "
               "const bool direct_ = x0_ >= 0 && y0_ >= 0 && "
               "x0_ + RX <= p.nx && y0_ + RY <= p.ny;")


def smoke():
    spec = importlib.util.spec_from_file_location(
        "k1_probes_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sub(text, old, new, count=1):
    if text.count(old) != count:
        raise SystemExit(f"probe edit: {old!r} found {text.count(old)} "
                         f"times, not {count}")
    return text.replace(old, new)


def variant_sources(src: Path, name: str) -> dict:
    """{file: text} of the edited copies for one variant."""
    step = (src / "fb_step.cu").read_text()
    terms = (src / "fb_terms.cuh").read_text()
    launch = "  fb_stages<T>(p, sm, gidx,"
    head, tail = step.split(launch)
    tail = tail.split("}\n", 1)[1]          # the rest of the kernel
    if name in ("loads", "loads_all"):
        extra = ALL_STATICS if name == "loads_all" else ""
        reads = ("extra = extra + sm[P_H1 * NPT + s] + "
                 "sm[P_PHI * NPT + s];") if extra else ""
        step = head + extra + STORE_ONLY.replace("EXTRA_READS", reads) \
            + "}\n" + tail
    elif name == "direct":
        step = sub(step, "  load_offsets<T, RX, RY, W>(p, gidx);",
                   "  " + DIRECT_TEST
                   + "\n  if (!direct_) load_offsets<T, RX, RY, W>(p, gidx);")
        step = sub(step, "    const int g = gidx[s];",
                   "    const int g = direct_ ? (y0_ + s / RX) * p.nx + x0_ "
                   "+ s % RX : gidx[s];")
        glob = ("    constexpr int W_ = (RX - TX) / 2, RY_ = NPT / RX;\n"
                "    const int x0_ = int(blockIdx.x) * TX - W_, "
                "y0_ = int(blockIdx.y) * TY - W_;\n"
                "    const int g_ = (x0_ >= 0 && y0_ >= 0 && x0_ + RX <= p.nx"
                " && y0_ + RY_ <= p.ny) ? (y0_ + s / RX) * p.nx + x0_ + "
                "s % RX : gidx[s];\n")
        terms = sub(terms, "    return p.in[i][gidx[s]];",
                    glob + "    return p.in[i][g_];")
        terms = sub(terms, "    return p.in[i][k * p.plane + gidx[s]];",
                    glob + "    return p.in[i][k * p.plane + g_];")
    elif name == "compute":
        step = sub(step, "  load_offsets<T, RX, RY, W>(p, gidx);", "")
        body = re.search(r"  for \(int s = tid; s < NPT; s \+= THREADS\) "
                         r"\{\n    const int g = gidx\[s\];.*?\n  \}\n",
                         step, re.S).group(0)
        fill = (
            "  for (int s = tid; s < NPT; s += THREADS) {\n"
            "    for (int k = 0; k < NZ; ++k) {\n"
            "      h[k * NPT + s] = T(500) + T(s % 7);\n"
            "      u[k * NPT + s] = T(0.01) * T(s % 5);\n"
            "      v[k * NPT + s] = T(0.01) * T(s % 3);\n"
            "    }\n"
            "    sm[P_M * NPT + s] = T(1);\n"
            "    sm[P_MU * NPT + s] = T(1);\n"
            "    sm[P_MV * NPT + s] = T(1);\n"
            "    sm[P_MQ * NPT + s] = T(1);\n"
            "  }\n")
        step = sub(step, body, fill)
        terms = sub(terms, "    return p.in[i][gidx[s]];",
                    "    return T(1e-4) * T(i);")
        terms = sub(terms, "    return p.in[i][k * p.plane + gidx[s]];",
                    "    return T(1e-4) * T(i + k);")
    return {"fb_step.cu": step + OCCUPANCY, "fb_terms.cuh": terms}


PASS_STORES = r"""
  fbp::cp_async_wait<0>();
  __syncthreads();
  for (int k_ = threadIdx.x; k_ < TX * TY; k_ += THREADS) {
    const int jj = k_ / TX, ii = k_ % TX;
    const Out o{y0, x0, p.ny, p.nx, p.plane};
    if (!o.valid(jj, ii)) continue;
    const int s = (fbp::HALO + jj) * fbp::RX + fbp::HALO + ii;
    T extra = T(0);
    for (int q = 3 * NZ; q < fbp::N_PLANES; ++q)
      extra = extra + sm[q * fbp::NPT + s];
    for (int k = 0; k < NZ; ++k) {
      const long g = k * o.plane + o.at(jj, ii);
      out_h[g] = sm[k * fbp::NPT + s] + extra;
      out_u[g] = sm[(NZ + k) * fbp::NPT + s];
      out_v[g] = sm[(2 * NZ + k) * fbp::NPT + s];
    }
  }
}
"""

PASS_FILL = r"""
  for (int s = threadIdx.x; s < fbp::N_PLANES * fbp::NPT; s += THREADS)
    sm[s] = (s < NZ * fbp::NPT || (s >= fbp::Q_HB * fbp::NPT &&
                                   s < (fbp::Q_HB + 1) * fbp::NPT))
                ? T(500) : T(0.01);
  __syncthreads();
"""


def pass_sources(src: Path, name: str) -> dict:
    """{file: text} of the edited copies of the pass kernel's variant."""
    step = (src / "fb_step.cu").read_text()
    load = "  fbp::load_block<T>(p, sm, y0 - fbp::HALO, x0 - fbp::HALO);\n"
    if name in ("pass_compute", "pass_nosync"):
        step = sub(step, load, PASS_FILL)
    if name == "pass_nosync":
        terms = (src / "fb_terms.cuh").read_text()
        return {"fb_step.cu": step, "fb_terms.cuh": sub(
            terms, "  REGION_NS(lo, hi, __VA_ARGS__)  \\\n  __syncthreads();",
            "  REGION_NS(lo, hi, __VA_ARGS__)")}
    elif name == "pass_loads":
        head, tail = step.split("  fbp::pass_steps<T, 0, 0, 1, 2, 3, 4>(")
        tail = tail.split("}\n", 1)[1]
        step = head + PASS_STORES + tail
    return {"fb_step.cu": step}


def main_pass() -> dict:
    sys.path.insert(0, str(HERE))
    import torch

    from beom_tpu_torch.stencils import build, fused_fb

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: no CUDA card")
    sm = smoke()
    dev = torch.device("cuda")
    cfg, grid, forcing, st = sm.perturbed_case(dev, 2, nx=N, ny=N)
    statics = (grid, forcing)
    pl = fused_fb.plan(cfg, cfg.tdtype, 4)
    _, defines = fused_fb.build_spec(cfg, cfg.tdtype, pl.kb)
    src = HERE / "beom_tpu_torch" / "csrc"
    nvcc = build.nvcc_path()
    jobs = []
    for name in ("pass", "pass_loads", "pass_compute", "pass_nosync"):
        out_dir = HERE / "build" / "probes" / name
        shutil.rmtree(out_dir, ignore_errors=True)
        shutil.copytree(src, out_dir)
        for f, text in pass_sources(src, name).items():
            (out_dir / f).write_text(text)
        lib = out_dir / "libprobe.so"
        jobs.append((name, lib, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o",
             str(lib), str(out_dir / "fb_step.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    ts = fused_fb._times(st.t, cfg, pl.kb)
    ptrs = fused_fb._array(fused_fb._P, [a.data_ptr() for a in [
        st.h, st.u, st.v] + fused_fb._operands(statics)])
    ints, dbls = fused_fb._scalars(cfg, 0, ts[0], ts=ts, aligned=True)
    outs = [torch.empty_like(st.h) for _ in range(3)]
    ref = fused_fb._launch_fb(st.h, st.u, st.v, statics, 0, ts, cfg)
    res = {"plan": pl.describe(), "device": torch.cuda.get_device_name(0)}
    for name, lib_path, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(str(lib_path))
        fn = lib.beom_fb_step_f32
        fn.argtypes = [ctypes.c_void_p] * 7
        fn.restype = ctypes.c_int

        def launch():
            code = fn(ptrs, ints, dbls, *[a.data_ptr() for a in outs],
                      torch.cuda.current_stream().cuda_stream)
            if code:
                raise SystemExit(f"{name}: CUDA error {code}")

        launch()
        torch.cuda.synchronize()
        row = {"ms": sm.time_ms(launch, 100),
               "device_ms": sm.device_ms(name, launch, 50,
                                         {"fb_pass_kernel": 1})[
                                             "fb_pass_kernel"],
               "equal_to_pass": all(torch.equal(a, b)
                                    for a, b in zip(outs, ref)),
               "ptxas": [line.strip() for line in log.splitlines()
                         if "registers" in line or "spill" in line]}
        res[name] = row
        print(f"   {name}: {row['ms']!r} ms per launch of {pl.kb} steps "
              f"between events, {row['device_ms']!r} on the device, bitwise "
              f"the pass kernel: {row['equal_to_pass']}", flush=True)
    res["power"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    return res


def build_variant(root: Path, name: str, defines, nvcc_flags) -> Path:
    src = root / "beom_tpu_torch" / "csrc"
    out = HERE / "build" / "probes" / name.replace(" ", "_")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(src, out)
    for f, text in variant_sources(src, name.split()[0]).items():
        (out / f).write_text(text)
    lib = out / "libprobe.so"
    return out, lib, [*nvcc_flags, *(f"-D{d}" for d in defines), "-o",
                      str(lib), str(out / "fb_step.cu")]


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
    cfg, grid, forcing, st = sm.perturbed_case(dev, 2, nx=N, ny=N)
    statics = (grid, forcing)
    _, defines = fused_fb.build_spec(cfg)
    base = [d for d in defines if not d.startswith(("BEOM_TX", "BEOM_TY"))]
    tile = [d for d in defines if d.startswith(("BEOM_TX", "BEOM_TY"))]
    variants = [(v, base + tile) for v in
                ("k1", "loads", "loads_all", "direct", "compute")]
    variants += [(f"k1 tile {tx}x{ty}", base + [f"BEOM_TX={tx}",
                                               f"BEOM_TY={ty}"])
                 for tx, ty in ((64, 16), (32, 32), (64, 32), (128, 16))]
    nvcc = build.nvcc_path()
    jobs = []
    for name, defs in variants:
        _, lib, args = build_variant(root, name, defs, build.NVCC_FLAGS)
        jobs.append((name, lib, subprocess.Popen(
            [nvcc, *args], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    out = {"root": str(root), "device": torch.cuda.get_device_name(0),
           "defines": list(defines)}
    ptrs = fused_fb._array(fused_fb._P, [a.data_ptr() for a in [
        st.h, st.u, st.v] + fused_fb._operands(statics)])
    ints, dbls = fused_fb._scalars(cfg, 0, st.t + cfg.npdtype.type(cfg.dt))
    outs = [torch.empty_like(st.h) for _ in range(3)]
    ref = fused_fb.fused_fb_step(st.h, st.u, st.v, statics, 0, st.t, cfg, 1)
    for name, lib_path, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        usage = [line.strip() for line in log.splitlines()
                 if "fb_step_kernel" in line or "registers" in line
                 or "spill" in line]
        lib = ctypes.CDLL(str(lib_path))
        fn = lib.beom_fb_step_f32
        fn.argtypes = [ctypes.c_void_p] * 7
        fn.restype = ctypes.c_int
        lib.beom_probe_ctas.argtypes = [ctypes.c_int]

        def launch():
            code = fn(ptrs, ints, dbls, *[a.data_ptr() for a in outs],
                      torch.cuda.current_stream().cuda_stream)
            if code:
                raise SystemExit(f"{name}: CUDA error {code}")

        launch()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(outs, ref))
        row = {"ms": sm.time_ms(launch, 200),
               "device_ms": sm.device_ms(name, launch, 50,
                                         {"fb_step_kernel": 1})[
                                             "fb_step_kernel"],
               "ctas_per_sm": lib.beom_probe_ctas(0),
               "equal_to_k1": same, "ptxas": usage}
        out[name] = row
        print(f"   {name}: {row['ms']!r} ms between events, "
              f"{row['device_ms']!r} on the device, "
              f"{row['ctas_per_sm']} CTAs/SM, bitwise K1: {same}",
              flush=True)
    pass4 = lambda: fused_fb.fused_fb_step(st.h, st.u, st.v, statics, 0,
                                           st.t, cfg, 4)
    out["k1 4-step pass"] = [sm.time_ms(pass4, 50), sm.device_ms(
        "k1 4-step pass", pass4, 20, {"fb_step_kernel": 4})["fb_step_kernel"]]
    print(f"   K1 4-step pass: {out['k1 4-step pass']!r} ms", flush=True)
    out["power"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    return out


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    print(json.dumps(main_pass() if sys.argv[1] == "--pass"
                     else main(sys.argv[1])))
