"""ctypes bindings for the native runtime kernels (native/pm_native.cc).

Loaded lazily; callers fall back to the NumPy reference implementation when
the library is absent.  Built from ``native/`` on first use, once per
process: under an exclusive lock (``paramugsy_tpu_torch/build/native.lock``)
into a temporary name that one ``os.replace`` moves onto ``libpm_native.so``,
so no process, of this package or another, opens a half-written library.
"""
from __future__ import annotations

import ctypes
import fcntl
import logging
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(__file__))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libpm_native.so")
_LOCK_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build", "native.lock"
)

_lib: Optional[ctypes.CDLL] = None
_tried = False

# Expected ABI of native/pm_native.cc (keep in sync with pm_version()):
# a stale committed/cached .so below this version misses symbols, so the
# loader rebuilds or falls back instead of raising AttributeError later
# (ADVICE r3: a stale v2 .so crashed the mandatory _entries_of_chain path).
PM_VERSION_EXPECTED = 4

_log = logging.getLogger("paramugsy.engines")


def _version_of(lib: ctypes.CDLL) -> int:
    try:
        lib.pm_version.restype = ctypes.c_int
        return int(lib.pm_version())
    except AttributeError:
        return 0


def _build() -> Optional[ctypes.CDLL]:
    """Build the library into a temporary name in the native directory,
    load it from there (a fresh path: dlopen caches by pathname, so a stale
    library already loaded from _LIB_PATH cannot shadow it), then rename
    it onto _LIB_PATH.  None when the build fails or is stale itself."""
    if not os.path.exists(os.path.join(_NATIVE_DIR, "Makefile")):
        return None
    tmp = f".libpm_native.{os.getpid()}.tmp.so"
    tmp_path = os.path.join(_NATIVE_DIR, tmp)
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR, "-B", f"TARGET={tmp}"],
            check=True, capture_output=True, timeout=120,
        )
        lib = ctypes.CDLL(tmp_path)
        if _version_of(lib) < PM_VERSION_EXPECTED:
            _log.warning(
                "libpm_native.so version %d < expected %d even after rebuild; "
                "using host NumPy fallbacks", _version_of(lib), PM_VERSION_EXPECTED,
            )
            return None
        os.replace(tmp_path, _LIB_PATH)  # the mapping survives the rename
        return lib
    except (OSError, subprocess.SubprocessError):
        _log.warning("native build failed; using host NumPy fallbacks", exc_info=True)
        return None
    finally:
        if os.path.exists(tmp_path):
            os.unlink(tmp_path)


def _load_or_build() -> Optional[ctypes.CDLL]:
    """Under the lock: the library on disk when it loads and is current,
    else a fresh build.  A file that does not load is taken for one that
    a build without the lock (the reference's loader runs make in place)
    is still writing, and is rebuilt and replaced."""
    os.makedirs(os.path.dirname(_LOCK_PATH), exist_ok=True)
    with open(_LOCK_PATH, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(_LIB_PATH):
            try:
                lib = ctypes.CDLL(_LIB_PATH)
            except OSError:
                lib = None
            if lib is not None and _version_of(lib) >= PM_VERSION_EXPECTED:
                return lib
        return _build()


def load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    lib = _load_or_build()
    if lib is None:
        return None
    lib.pm_nw_align_batch.restype = ctypes.c_int
    lib.pm_nw_align_batch.argtypes = [
        ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
    ]
    _lib = lib
    return _lib


def _ptr(arr: np.ndarray, typ):
    return arr.ctypes.data_as(ctypes.POINTER(typ))


def nw_align_batch_native(
    a: np.ndarray,
    a_len: np.ndarray,
    b: np.ndarray,
    b_len: np.ndarray,
    match: int,
    mismatch: int,
    gap: int,
):
    """Returns (cols [B], nruns [B], runs [B, max_runs, 3]) or None."""
    lib = load()
    if lib is None:
        return None
    B, S = a.shape
    a = np.ascontiguousarray(a, dtype=np.int8)
    b = np.ascontiguousarray(b, dtype=np.int8)
    a_len = np.ascontiguousarray(a_len, dtype=np.int32)
    b_len = np.ascontiguousarray(b_len, dtype=np.int32)
    max_runs = S + 2
    cols = np.zeros(B, dtype=np.int32)
    runs = np.zeros((B, max_runs, 3), dtype=np.int32)
    nruns = np.zeros(B, dtype=np.int32)
    rc = lib.pm_nw_align_batch(
        _ptr(a, ctypes.c_int8),
        _ptr(a_len, ctypes.c_int32),
        _ptr(b, ctypes.c_int8),
        _ptr(b_len, ctypes.c_int32),
        B,
        S,
        match,
        mismatch,
        gap,
        _ptr(cols, ctypes.c_int32),
        _ptr(runs, ctypes.c_int32),
        _ptr(nruns, ctypes.c_int32),
        max_runs,
    )
    if rc != 0:
        return None
    return cols, nruns, runs


def nw_segments_native(
    ref: np.ndarray,
    qry: np.ndarray,
    r0: np.ndarray,
    r1: np.ndarray,
    q0: np.ndarray,
    q1: np.ndarray,
    match: int,
    mismatch: int,
    gap: int,
    cap: int = 4096,
    max_runs: int = 34,
):
    """Batched segment alignment from boundary arrays (no Python slicing).

    Returns (cols [n], nruns [n], runs [n, max_runs, 3], n_dp) or None
    when the native library is absent; n_dp counts segments that actually
    ran the DP (engine accounting excludes the degenerate shortcuts).
    Per-segment in-band markers in cols: -1 = longer than `cap` (route to
    the device engine), -2 = gap-run overflow (realign that one solo).
    """
    lib = load()
    if lib is None:
        return None
    if not hasattr(lib, "_segments_configured"):
        lib.pm_nw_segments.restype = ctypes.c_int
        lib.pm_nw_segments.argtypes = [
            ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_int8),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ]
        lib._segments_configured = True
    n = len(r0)
    ref = np.ascontiguousarray(ref, dtype=np.int8)
    qry = np.ascontiguousarray(qry, dtype=np.int8)
    r0 = np.ascontiguousarray(r0, dtype=np.int64)
    r1 = np.ascontiguousarray(r1, dtype=np.int64)
    q0 = np.ascontiguousarray(q0, dtype=np.int64)
    q1 = np.ascontiguousarray(q1, dtype=np.int64)
    cols = np.zeros(n, dtype=np.int32)
    runs = np.zeros((n, max_runs, 3), dtype=np.int32)
    nruns = np.zeros(n, dtype=np.int32)
    n_dp = lib.pm_nw_segments(
        _ptr(ref, ctypes.c_int8), _ptr(qry, ctypes.c_int8),
        _ptr(r0, ctypes.c_int64), _ptr(r1, ctypes.c_int64),
        _ptr(q0, ctypes.c_int64), _ptr(q1, ctypes.c_int64),
        n, cap, match, mismatch, gap,
        _ptr(cols, ctypes.c_int32), _ptr(runs, ctypes.c_int32),
        _ptr(nruns, ctypes.c_int32), max_runs,
    )
    return cols, nruns, runs, int(n_dp)


def banded_align_native(
    a: np.ndarray, b: np.ndarray, width: int, match: int, mismatch: int, gap: int
):
    """C++ banded alignment; returns (ref_runs, query_runs, n) or None."""
    lib = load()
    if lib is None:
        return None
    if not hasattr(lib, "_banded_configured"):
        lib.pm_banded_align.restype = ctypes.c_int32
        lib.pm_banded_align.argtypes = [
            ctypes.POINTER(ctypes.c_int8), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int8), ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib._banded_configured = True
    a = np.ascontiguousarray(a, dtype=np.int8)
    b = np.ascontiguousarray(b, dtype=np.int8)
    max_runs = len(a) + len(b) + 2
    runs = np.zeros((max_runs, 3), dtype=np.int32)
    n_runs = np.zeros(1, dtype=np.int32)
    n = lib.pm_banded_align(
        _ptr(a, ctypes.c_int8), len(a),
        _ptr(b, ctypes.c_int8), len(b),
        width, match, mismatch, gap,
        _ptr(runs, ctypes.c_int32), max_runs, _ptr(n_runs, ctypes.c_int32),
    )
    if n < 0:
        return None
    from paramugsy_tpu_torch.coords.range import Range

    rr = runs[: n_runs[0]]
    ref_runs = [Range(int(s), int(e)) for side, s, e in rr if side == 0]
    query_runs = [Range(int(s), int(e)) for side, s, e in rr if side == 1]
    return ref_runs, query_runs, int(n)


def chain_clusters_native(
    rs: np.ndarray,
    re_: np.ndarray,
    qs: np.ndarray,
    qe: np.ndarray,
    w: np.ndarray,
    max_join_gap: int,
    max_join_diagdiff: int,
):
    """Exact O(C^2) chaining DP in C; returns (score, parent) or None."""
    lib = load()
    if lib is None:
        return None
    if not hasattr(lib, "_chain_configured"):
        lib.pm_chain_clusters.restype = None
        lib.pm_chain_clusters.argtypes = [
            ctypes.POINTER(ctypes.c_int64)] * 5 + [
            ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        lib._chain_configured = True
    C = len(rs)
    rs = np.ascontiguousarray(rs, dtype=np.int64)
    re_ = np.ascontiguousarray(re_, dtype=np.int64)
    qs = np.ascontiguousarray(qs, dtype=np.int64)
    qe = np.ascontiguousarray(qe, dtype=np.int64)
    w = np.ascontiguousarray(w, dtype=np.int64)
    score = np.zeros(C, dtype=np.int64)
    parent = np.zeros(C, dtype=np.int64)
    lib.pm_chain_clusters(
        _ptr(rs, ctypes.c_int64), _ptr(re_, ctypes.c_int64),
        _ptr(qs, ctypes.c_int64), _ptr(qe, ctypes.c_int64),
        _ptr(w, ctypes.c_int64), C, max_join_gap, max_join_diagdiff,
        _ptr(score, ctypes.c_int64), _ptr(parent, ctypes.c_int64),
    )
    return score, parent


def wavefront_traceback_native(
    dirs_packed: np.ndarray,
    a_lens: np.ndarray,
    b_lens: np.ndarray,
    width: int,
):
    """Traceback of the packed wavefront dirs buffer for all pairs.

    dirs_packed: [steps16, batch, width] int32 from ops.pallas_extend.
    Returns a list of (ref_runs, query_runs, n_columns), or None when the
    native library is unavailable.
    """
    lib = load()
    if lib is None:
        return None
    if not hasattr(lib, "_wavefront_configured"):
        lib.pm_wavefront_traceback.restype = ctypes.c_int
        lib.pm_wavefront_traceback.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ]
        lib._wavefront_configured = True
    steps16, batch, w = dirs_packed.shape
    assert w == width
    n_pairs = len(a_lens)
    dirs_packed = np.ascontiguousarray(dirs_packed, dtype=np.int32)
    a_lens = np.ascontiguousarray(a_lens, dtype=np.int32)
    b_lens = np.ascontiguousarray(b_lens, dtype=np.int32)
    max_runs = int(a_lens.max(initial=0) + b_lens.max(initial=0) + 2)
    cols = np.zeros(n_pairs, dtype=np.int32)
    runs = np.zeros((n_pairs, max_runs, 3), dtype=np.int32)
    nruns = np.zeros(n_pairs, dtype=np.int32)
    rc = lib.pm_wavefront_traceback(
        _ptr(dirs_packed, ctypes.c_int32),
        steps16, batch, width,
        _ptr(a_lens, ctypes.c_int32), _ptr(b_lens, ctypes.c_int32), n_pairs,
        _ptr(cols, ctypes.c_int32), _ptr(runs, ctypes.c_int32),
        _ptr(nruns, ctypes.c_int32), max_runs,
    )
    if rc != 0:
        return None
    from paramugsy_tpu_torch.coords.range import Range

    out = []
    for p in range(n_pairs):
        rr = runs[p, : nruns[p]]
        out.append(
            (
                [Range(int(s), int(e)) for side, s, e in rr if side == 0],
                [Range(int(s), int(e)) for side, s, e in rr if side == 1],
                int(cols[p]),
            )
        )
    return out
