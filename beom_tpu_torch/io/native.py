"""ctypes bindings for the async snapshot writer: the port's twin of
beom_tpu/io/native.py, over the port's own copy of its C++ source
(beom_tpu_torch/csrc/snapwriter.cpp).

The shared library is built with g++ at first use, under a lock, into
build/native/ at the root of the checkout (beside stencils/build.py's
build/kernels/), and built again when the source is newer than the
library.  `available()` says whether it could be built and loaded;
`AsyncWriter()` raises RuntimeError where it could not.  Nothing falls
back on its own: io/snapshots.py's save_raw writes synchronously only
when it is given no writer.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "snapwriter.cpp"
_SO = Path(__file__).resolve().parents[2] / "build" / "native" / \
    "libsnapwriter.so"

_lock = threading.Lock()
_lib = None
_failed = False


def _build() -> bool:
    """Compile into a file of this process's own, then move it into place,
    so processes that build at once never load a half-written library."""
    _SO.parent.mkdir(parents=True, exist_ok=True)
    tmp = _SO.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-pthread",
             "-o", str(tmp), str(_SRC)],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def _load():
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        if not _SO.is_file() or (
                _SRC.is_file()
                and _SRC.stat().st_mtime > _SO.stat().st_mtime):
            if not _build():
                _failed = True
                return None
        try:
            lib = ctypes.CDLL(str(_SO))
        except OSError:
            _failed = True
            return None
        lib.sw_open.restype = ctypes.c_void_p
        lib.sw_open.argtypes = [ctypes.c_size_t]
        lib.sw_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_void_p, ctypes.c_size_t]
        lib.sw_flush.argtypes = [ctypes.c_void_p]
        lib.sw_errors.restype = ctypes.c_long
        lib.sw_errors.argtypes = [ctypes.c_void_p]
        lib.sw_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


class AsyncWriter:
    """Queue raw buffers for a background writer thread.

    submit() copies the buffer (the C++ job owns its copy) and returns at
    once, blocking only while the queue holds max_queued_bytes; flush()
    blocks until everything queued so far is written and closed.
    """

    def __init__(self, max_queued_bytes: int = 1 << 30):
        lib = _load()
        if lib is None:
            raise RuntimeError(
                f"native snapwriter unavailable (g++ build of {_SRC} "
                "failed)")
        self._lib = lib
        self._h = lib.sw_open(max_queued_bytes)

    def submit(self, path, arr: np.ndarray) -> None:
        a = np.ascontiguousarray(arr)
        self._lib.sw_submit(self._h, os.fspath(path).encode(),
                            a.ctypes.data_as(ctypes.c_void_p), a.nbytes)

    def flush(self) -> None:
        self._lib.sw_flush(self._h)

    @property
    def errors(self) -> int:
        return int(self._lib.sw_errors(self._h))

    def close(self) -> None:
        if self._h:
            self._lib.sw_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.flush()
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
