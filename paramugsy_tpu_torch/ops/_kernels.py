"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources have a plain C interface, so ``nvcc`` compiles them in
seconds (one compiler per source, in parallel) into one shared library,
loaded with ctypes.  The build runs on first CUDA use, from the sources in
the checkout, into ``paramugsy_tpu_torch/build/`` (listed in .gitignore),
and again whenever a source is newer than the library.  Processes that
start together (the ranks of ``align -distributed``) build it once: the
staleness check and the build run under an exclusive ``flock`` on
``build/kernels.lock``, and the library is renamed into place whole.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = [
    os.path.join(_PKG, "csrc", name) for name in ("wavefront.cu", "traceback.cu", "banded.cu")
]
BUILD_DIR = os.path.join(_PKG, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libpm_kernels.so")
# The compiler's report (registers, shared memory, spills per kernel).
LOG_PATH = os.path.join(BUILD_DIR, "nvcc.log")
# Held across the staleness check and the build, between processes.
LOCK_PATH = os.path.join(BUILD_DIR, "kernels.lock")
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


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands in parallel; append their output to LOG_PATH and
    raise if any failed."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    failed = []
    try:
        with open(LOG_PATH, "a") as log:
            for c, p in zip(cmds, procs):
                out, _ = p.communicate(timeout=600)
                log.write(" ".join(c) + "\n" + out)
                if p.returncode != 0:
                    failed.append(f"{' '.join(c)} ({p.returncode}):\n{out}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))


def build() -> str:
    """Compile the kernels (when stale; one nvcc per source, all at once,
    then one link) and return the library path.  Another process that
    builds at the same time waits for this one and finds the library
    current."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(LOCK_PATH, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _stale():
            _build()
    return LIB_PATH


def _build() -> None:
    open(LOG_PATH, "w").close()
    tmpdir = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        objs = [
            os.path.join(tmpdir, os.path.basename(src) + ".o") for src in SOURCES
        ]
        _run_all([
            [_nvcc(), ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", "-c", "-o", obj, src]
            for src, obj in zip(SOURCES, objs)
        ])
        lib = os.path.join(tmpdir, "lib.so")
        _run_all([[_nvcc(), ARCH, "-shared", "-o", lib, *objs]])
        os.replace(lib, LIB_PATH)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp, i = ctypes.c_void_p, ctypes.c_int
            lib.pm_wavefront_dp.restype = i
            lib.pm_wavefront_dp.argtypes = [vp, vp] + [i] * 8 + [vp, vp]
            lib.pm_wavefront_dp_wide.restype = i
            lib.pm_wavefront_dp_wide.argtypes = [vp, vp, vp, vp] + [i] * 8 + [vp, vp, vp]
            lib.pm_wavefront_traceback.restype = i
            lib.pm_wavefront_traceback.argtypes = [vp, vp, vp] + [i] * 4 + [vp, vp]
            lib.pm_banded_dp.restype = i
            lib.pm_banded_dp.argtypes = [vp] * 4 + [i] * 8 + [vp, vp]
            _lib = lib
    return _lib
