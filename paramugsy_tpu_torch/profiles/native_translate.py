"""ctypes binding for the native translate core (native/pm_translate.cc).

Marshals profile sets and delta streams into flat arrays, runs the C++
column-walk, and unmarshals delta entries.  Falls back to None when the
library is unavailable; `translate_deltas_fast` wraps the choice.
"""
from __future__ import annotations

import ctypes
from typing import Iterable, Iterator, Sequence

import numpy as np

from paramugsy_tpu_torch.coords.profile import Profile
from paramugsy_tpu_torch.coords.range import Range
from paramugsy_tpu_torch.formats.delta import DeltaEntry
from paramugsy_tpu_torch.ops.native import load, _ptr

_configured = False


def _configure(lib) -> None:
    global _configured
    if _configured:
        return
    I32P = ctypes.POINTER(ctypes.c_int32)
    lib.pm_translate.restype = ctypes.c_int32
    lib.pm_translate.argtypes = (
        [ctypes.c_int32] + [I32P] * 7
        + [ctypes.c_int32] + [I32P] * 7
        + [ctypes.c_int32] + [I32P] * 12
        + [I32P] * 11
        + [ctypes.c_int32, ctypes.c_int32]
    )
    _configured = True


def _marshal_profiles(profiles: Sequence[Profile], seq_ids: dict[str, int]):
    n = len(profiles)
    seq = np.array([seq_ids[p.seq_name] for p in profiles], dtype=np.int32)
    start = np.array([p.range.start for p in profiles], dtype=np.int32)
    end = np.array([p.range.end for p in profiles], dtype=np.int32)
    length = np.array([p.length for p in profiles], dtype=np.int32)
    goff = np.zeros(n + 1, dtype=np.int32)
    gs, ge = [], []
    for i, p in enumerate(profiles):
        for g in p.gaps:
            gs.append(g.start)
            ge.append(g.end)
        goff[i + 1] = len(gs)
    return seq, start, end, length, goff, np.array(gs, np.int32), np.array(ge, np.int32)


def _marshal_deltas(deltas: Sequence[DeltaEntry], seq_ids: dict[str, int]):
    m = len(deltas)
    rseq = np.array([seq_ids.get(d.ref_name, -1) for d in deltas], dtype=np.int32)
    qseq = np.array([seq_ids.get(d.query_name, -2) for d in deltas], dtype=np.int32)
    rs = np.array([d.ref_range.start for d in deltas], dtype=np.int32)
    re_ = np.array([d.ref_range.end for d in deltas], dtype=np.int32)
    qs = np.array([d.query_range.start for d in deltas], dtype=np.int32)
    qe = np.array([d.query_range.end for d in deltas], dtype=np.int32)
    rgoff = np.zeros(m + 1, dtype=np.int32)
    qgoff = np.zeros(m + 1, dtype=np.int32)
    rgs, rge, qgs, qge = [], [], [], []
    for i, d in enumerate(deltas):
        for g in d.ref_gaps:
            rgs.append(g.start)
            rge.append(g.end)
        for g in d.query_gaps:
            qgs.append(g.start)
            qge.append(g.end)
        rgoff[i + 1] = len(rgs)
        qgoff[i + 1] = len(qgs)
    return (
        rseq, qseq, rs, re_, qs, qe,
        rgoff, np.array(rgs, np.int32), np.array(rge, np.int32),
        qgoff, np.array(qgs, np.int32), np.array(qge, np.int32),
    )


def translate_deltas_native(
    left_profiles: Sequence[Profile],
    right_profiles: Sequence[Profile],
    deltas: Sequence[DeltaEntry],
):
    """Native translate; returns list[DeltaEntry] or None if unavailable."""
    lib = load()
    if lib is None:
        return None
    _configure(lib)

    # Separate id spaces per side, like the Python maps.
    l_ids: dict[str, int] = {}
    for p in left_profiles:
        l_ids.setdefault(p.seq_name, len(l_ids))
    r_ids: dict[str, int] = {}
    for p in right_profiles:
        r_ids.setdefault(p.seq_name, len(r_ids))

    L = _marshal_profiles(left_profiles, l_ids)
    R = _marshal_profiles(right_profiles, r_ids)
    D = _marshal_deltas(deltas, {**{k: v for k, v in l_ids.items()}})
    # query side ids come from the right map
    D = list(D)
    D[1] = np.array(
        [r_ids.get(d.query_name, -2) for d in deltas], dtype=np.int32
    )

    cap_entries = 1 << 16
    cap_gaps = 1 << 20
    I32 = ctypes.c_int32
    while True:
        o = {
            k: np.zeros(cap_entries, dtype=np.int32)
            for k in ("delta", "lp", "rp", "ref_start", "ref_end", "query_start", "query_end")
        }
        o["gap_off"] = np.zeros(cap_entries + 1, dtype=np.int32)
        og = {k: np.zeros(cap_gaps, dtype=np.int32) for k in ("side", "s", "e")}
        args = (
            [I32(len(left_profiles))] + [_ptr(x, ctypes.c_int32) for x in L]
            + [I32(len(right_profiles))] + [_ptr(x, ctypes.c_int32) for x in R]
            + [I32(len(deltas))] + [_ptr(np.ascontiguousarray(x, np.int32), ctypes.c_int32) for x in D]
            + [
                _ptr(o["delta"], ctypes.c_int32), _ptr(o["lp"], ctypes.c_int32),
                _ptr(o["rp"], ctypes.c_int32),
                _ptr(o["ref_start"], ctypes.c_int32), _ptr(o["ref_end"], ctypes.c_int32),
                _ptr(o["query_start"], ctypes.c_int32), _ptr(o["query_end"], ctypes.c_int32),
                _ptr(o["gap_off"], ctypes.c_int32), _ptr(og["side"], ctypes.c_int32),
                _ptr(og["s"], ctypes.c_int32), _ptr(og["e"], ctypes.c_int32),
            ]
            + [I32(cap_entries), I32(cap_gaps)]
        )
        n = lib.pm_translate(*args)
        if n >= 0:
            break
        cap_entries *= 4
        cap_gaps *= 4
        if cap_entries > 1 << 26:
            return None  # give up; caller falls back to Python

    out: list[DeltaEntry] = []
    for k in range(n):
        lp = left_profiles[o["lp"][k]]
        rp = right_profiles[o["rp"][k]]
        a, b = int(o["gap_off"][k]), int(o["gap_off"][k + 1])
        ref_gaps, query_gaps = [], []
        for gi in range(a, b):
            r = Range(int(og["s"][gi]), int(og["e"][gi]))
            (ref_gaps if og["side"][gi] == 0 else query_gaps).append(r)
        out.append(
            DeltaEntry(
                ref_name=lp.major_name,
                query_name=rp.major_name,
                ref_len=lp.length,
                query_len=rp.length,
                ref_range=Range(int(o["ref_start"][k]), int(o["ref_end"][k])),
                query_range=Range(int(o["query_start"][k]), int(o["query_end"][k])),
                ref_gaps=ref_gaps,
                query_gaps=query_gaps,
            )
        )
    return out


def translate_deltas_fast(
    left_profiles: Sequence[Profile],
    right_profiles: Sequence[Profile],
    deltas: Iterable[DeltaEntry],
) -> Iterator[DeltaEntry]:
    """Native translate with Python fallback (same output either way)."""
    deltas = list(deltas)
    left_profiles = list(left_profiles)
    right_profiles = list(right_profiles)
    try:
        out = translate_deltas_native(left_profiles, right_profiles, deltas)
    except Exception:
        out = None
    if out is not None:
        yield from out
        return
    from paramugsy_tpu_torch.profiles.translate import translate_deltas

    yield from translate_deltas(left_profiles, right_profiles, deltas)
