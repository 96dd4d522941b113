"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under `beom_tpu_torch/csrc/` is compiled on first use into a
shared library with a plain C interface, in `build/kernels/` at the root
of the checkout, named by the hash of the source and the flags so an
edited source is rebuilt.  Nothing is compiled when a module is imported,
and a CUDA build with no nvcc raises.
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
BUILD_LOG: dict = {}     # source name -> (seconds, nvcc's output)


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


def load(name: str) -> ctypes.CDLL:
    """The library built from csrc/<name>.cu, built if not yet cached."""
    if name in _LOADED:
        return _LOADED[name]
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{name}-{key}.so"
    if not lib_path.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src} (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib_path)
        BUILD_LOG[name] = (time.perf_counter() - t0,
                           proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(lib_path))
    lib.beom_cuda_error_string.argtypes = [ctypes.c_int]
    lib.beom_cuda_error_string.restype = ctypes.c_char_p
    _LOADED[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.beom_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
