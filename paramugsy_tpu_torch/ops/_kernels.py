"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources have a plain C interface, so ``nvcc`` compiles them in
seconds into one shared library, loaded with ctypes.  The build runs on
first CUDA use, from the sources in the checkout, into
``paramugsy_tpu_torch/build/`` (listed in .gitignore), and again whenever
a source is newer than the library.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = [
    os.path.join(_PKG, "csrc", name) for name in ("wavefront.cu", "traceback.cu")
]
BUILD_DIR = os.path.join(_PKG, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libpm_kernels.so")
# The compiler's report (registers, shared memory, spills per kernel).
LOG_PATH = os.path.join(BUILD_DIR, "nvcc.log")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > built for s in SOURCES)


def build() -> str:
    """Compile the kernels (when stale) and return the library path."""
    if not _stale():
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [
        _nvcc(), ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-Xptxas", "-v", "-o", tmp, *SOURCES,
    ]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        with open(LOG_PATH, "w") as f:
            f.write(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{res.stdout}{res.stderr}"
            )
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return LIB_PATH


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp, i = ctypes.c_void_p, ctypes.c_int
            lib.pm_wavefront_dp.restype = i
            lib.pm_wavefront_dp.argtypes = [vp, vp, vp, vp] + [i] * 8 + [vp, vp, vp]
            lib.pm_wavefront_traceback.restype = i
            lib.pm_wavefront_traceback.argtypes = [vp, vp, vp] + [i] * 4 + [vp, vp]
            _lib = lib
    return _lib
