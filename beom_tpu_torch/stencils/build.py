"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under `beom_tpu_torch/csrc/` is compiled on first use into a
shared library with a plain C interface, in `build/kernels/` at the root
of the checkout, named by the hash of the source, the shared headers
(`csrc/*.cuh`) and the flags, so an edited source or header is rebuilt.
A source whose switches are compile-time is built once per combination:
such a build is named by a spec `(name, defines)`, with `defines` a tuple
of `KEY=value` strings passed as `-D` flags and spelled out in the
library's file name.  Nothing is compiled when a module is imported, and a
CUDA build with no nvcc raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# sm_90a: Hopper; --fmad=false keeps each multiply and add rounded
# separately, as the eager port's op-by-op arithmetic is
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v")

_LOADED: dict = {}
BUILD_LOG: dict = {}     # source name -> (seconds to build, nvcc's output)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
        "the CUDA kernels cannot be built")


def _spec(item):
    """(name, defines) of a build named by a bare source name or a spec."""
    return (item, ()) if isinstance(item, str) else (item[0], tuple(item[1]))


def label(item) -> str:
    """The key of a build in BUILD_LOG: its name, then its defines."""
    name, defines = _spec(item)
    return name if not defines else f"{name}[{' '.join(defines)}]"


def _lib_path(item) -> Path:
    name, defines = _spec(item)
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS + defines).encode())
    key = h.hexdigest()[:16]
    tag = "".join("-" + d.removeprefix("BEOM_").replace("=", "").lower()
                  for d in defines)
    return BUILD_DIR / f"lib{name}{tag}-{key}.so"


def build_all(items) -> None:
    """Compile every build in `items` (source names or specs) not yet
    cached, one nvcc each, all running at once; raise if any fails."""
    todo = [i for i in dict.fromkeys(map(_spec, items))
            if not _lib_path(i).is_file()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    jobs = []
    for item in todo:
        name, defines = item
        tmp = _lib_path(item).with_suffix(f".{os.getpid()}.tmp")
        jobs.append((item, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", str(tmp),
             str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for item, tmp, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {label(item)} (exit "
                          f"{proc.returncode}):\n{out}")
            continue
        os.replace(tmp, _lib_path(item))
        BUILD_LOG[label(item)] = (time.perf_counter() - t0, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(item) -> ctypes.CDLL:
    """The library of a build (a source name or a spec), built if not yet
    cached."""
    item = _spec(item)
    if item in _LOADED:
        return _LOADED[item]
    build_all([item])
    lib = ctypes.CDLL(str(_lib_path(item)))
    lib.beom_cuda_error_string.argtypes = [ctypes.c_int]
    lib.beom_cuda_error_string.restype = ctypes.c_char_p
    _LOADED[item] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.beom_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def enable_peers(pairs) -> None:
    """Let each (reader, holder) pair of CUDA devices read the holder's
    memory in place (cudaDeviceEnablePeerAccess, csrc/peers.cu; access
    already on counts as success); raise on any other error."""
    import torch

    if not pairs:
        return
    lib = load("peers")
    for reader, holder in pairs:
        code = lib.beom_enable_peer(torch.device(reader).index,
                                    torch.device(holder).index)
        check(lib, code, f"peer access from {reader} to {holder}")


def on_device(dev):
    """A context in which the CUDA device `dev` is current, entered only
    where it is not: a launch goes to the current device and takes dev's
    stream, so a kernel of a mesh on another card needs the switch."""
    import contextlib

    import torch

    if torch.cuda.current_device() == dev.index:
        return contextlib.nullcontext()
    return torch.cuda.device(dev)
