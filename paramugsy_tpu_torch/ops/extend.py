"""Inter-anchor gap alignment (counterpart of paramugsy_tpu.ops.extend).

Segments with both sides <= 4096 bp run on the native host NW engine (or
the NumPy NW `nw_align_batch` when the native library is absent).  Longer ones
go to the port's wavefront engine on a CUDA device; on the CPU they go
to the native banded engine (the plain row-banded DP without the native
library) unless PARAMUGSY_DEVICE_DP=1 (see `engines.device_dp_enabled`).
`Scoring`, `nw_align_batch` and `traceback_gaps` are copied from the
reference unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from paramugsy_tpu_torch.coords.range import Range
from paramugsy_tpu_torch.ops import engines

_BUCKETS = (16, 64, 256, 1024, 4096)

NEG = np.int32(-(10**8))

DIAG, UP, LEFT = 0, 1, 2  # UP consumes ref (gap in query), LEFT consumes query


@dataclass
class Scoring:
    match: int = 2
    mismatch: int = -3
    gap: int = -4


def nw_align_batch(
    a: np.ndarray, a_len: np.ndarray, b: np.ndarray, b_len: np.ndarray,
    scoring: Scoring = Scoring(),
):
    """Batched global alignment.

    a, b: [B, S] int8 code arrays (ref, query segments), padded.
    Returns (dirs [B, S+1, S+1] uint8, score [B]).
    """
    B, S = a.shape
    GAP = scoring.gap
    dp_prev = np.tile((np.arange(S + 1) * GAP).astype(np.int32), (B, 1))
    dirs = np.zeros((B, S + 1, S + 1), dtype=np.uint8)
    dirs[:, 0, 1:] = LEFT
    j_idx = np.arange(S + 1, dtype=np.int32)
    gap_j = (GAP * j_idx).astype(np.int32)

    for i in range(1, S + 1):
        sub = np.where(a[:, i - 1 : i] == b, scoring.match, scoring.mismatch)
        # mask out padded query columns (j-1 >= b_len) handled by final readout
        diag = dp_prev[:, :-1] + sub  # j = 1..S
        up = dp_prev[:, 1:] + GAP
        cand = np.maximum(diag, up)
        u = np.empty((B, S + 1), dtype=np.int32)
        u[:, 0] = np.int32(GAP * i)
        u[:, 1:] = cand - gap_j[1:]
        run = np.maximum.accumulate(u, axis=1)
        dp_cur = run + gap_j
        d = np.full((B, S + 1), LEFT, dtype=np.uint8)
        d[:, 0] = UP
        is_up = dp_cur[:, 1:] == up
        is_diag = dp_cur[:, 1:] == diag
        d[:, 1:][is_up] = UP
        d[:, 1:][is_diag] = DIAG  # prefer diag on ties
        dirs[:, i] = d
        dp_prev = dp_cur

    score = dp_prev[np.arange(B), b_len]  # only valid when a_len == S; fix below
    return dirs, score


def traceback_gaps(dirs_i: np.ndarray, a_len: int, b_len: int):
    """Walk one direction matrix back from (a_len, b_len).

    Returns (ref_gap_runs, query_gap_runs, n_columns): 1-indexed runs in
    alignment-column space, plus total columns.
    """
    i, j = a_len, b_len
    cols: list[int] = []  # 0=match col, 1=ref gap (LEFT), 2=query gap (UP)
    while i > 0 or j > 0:
        if i == 0:
            d = LEFT
        elif j == 0:
            d = UP
        else:
            d = dirs_i[i, j]
        if d == DIAG:
            cols.append(0)
            i -= 1
            j -= 1
        elif d == UP:
            cols.append(2)
            i -= 1
        else:
            cols.append(1)
            j -= 1
    cols.reverse()
    n = len(cols)
    ref_runs: list[Range] = []
    query_runs: list[Range] = []
    start = None
    kind = 0
    for idx, c in enumerate(cols + [0]):
        if c != kind:
            if kind == 1:
                ref_runs.append(Range(start + 1, idx))
            elif kind == 2:
                query_runs.append(Range(start + 1, idx))
            if c != 0:
                start = idx
            kind = c
    return ref_runs, query_runs, n


def _runs_of(rr) -> tuple[list[Range], list[Range]]:
    return (
        [Range(int(s), int(e)) for side, s, e in rr if side == 0],
        [Range(int(s), int(e)) for side, s, e in rr if side == 1],
    )


def align_segments(
    segs: list[tuple[np.ndarray, np.ndarray]],
    scoring: Scoring = Scoring(),
    *,
    device: torch.device,
):
    """Align (ref_codes, query_codes) segment pairs; returns per segment
    (ref_gap_runs, query_gap_runs, n_columns)."""
    from paramugsy_tpu_torch.ops.native import nw_align_batch_native

    results: list = [None] * len(segs)
    if not segs:
        return results
    la = np.fromiter((len(s[0]) for s in segs), dtype=np.int64, count=len(segs))
    lb = np.fromiter((len(s[1]) for s in segs), dtype=np.int64, count=len(segs))
    # Trivial cases need no DP: one side empty, or 1-vs-1 when a single
    # substitution beats two gaps (the DIAG tie preference makes >= exact).
    trivial = (la == 0) | (lb == 0)
    if scoring.mismatch >= 2 * scoring.gap:
        trivial |= (la == 1) & (lb == 1)
    for i in np.flatnonzero(trivial):
        a_n, b_n = int(la[i]), int(lb[i])
        if a_n == 0 and b_n == 0:
            results[i] = ([], [], 0)
        elif a_n == 0:
            results[i] = ([Range(1, b_n)], [], b_n)
        elif b_n == 0:
            results[i] = ([], [Range(1, a_n)], a_n)
        else:
            results[i] = ([], [], 1)
    batch = np.flatnonzero(np.array([r is None for r in results], dtype=bool))
    lmax = np.maximum(la, lb)
    for bucket in _BUCKETS:
        idxs = batch[lmax[batch] <= bucket]
        batch = batch[lmax[batch] > bucket]
        if len(idxs) == 0:
            continue
        B = len(idxs)
        a_len = la[idxs].astype(np.int32)
        b_len = lb[idxs].astype(np.int32)
        lane = np.arange(bucket)
        a = np.full((B, bucket), 4, dtype=np.int8)
        b = np.full((B, bucket), 4, dtype=np.int8)
        a[lane[None, :] < a_len[:, None]] = np.concatenate([segs[i][0] for i in idxs])
        b[lane[None, :] < b_len[:, None]] = np.concatenate([segs[i][1] for i in idxs])
        nat = nw_align_batch_native(
            a, a_len, b, b_len, scoring.match, scoring.mismatch, scoring.gap
        )
        if nat is not None:
            engines.record("native-nw", B)
            cols, nruns, runs = nat
            for bi, i in enumerate(idxs):
                results[i] = (*_runs_of(runs[bi, : nruns[bi]]), int(cols[bi]))
        else:
            engines.record("numpy-nw", B)
            dirs, _ = nw_align_batch(a, a_len, b, b_len, scoring)
            for bi, i in enumerate(idxs):
                results[i] = traceback_gaps(dirs[bi], int(a_len[bi]), int(b_len[bi]))
    long_idx = [i for i, r in enumerate(results) if r is None]
    if long_idx:
        long_segs = [
            (np.asarray(segs[i][0]), np.asarray(segs[i][1])) for i in long_idx
        ]
        if engines.device_dp_enabled(device):
            from paramugsy_tpu_torch.ops.wavefront import wavefront_align_many

            outs = wavefront_align_many(
                long_segs, device=device, match=scoring.match,
                mismatch=scoring.mismatch, gap=scoring.gap,
            )
            engines.record("device-wavefront", len(long_segs))
        else:
            outs = [align_long_segment(a, b, scoring) for a, b in long_segs]
        for i, o in zip(long_idx, outs):
            results[i] = o
    return results


def align_segments_spans(
    ref_np: np.ndarray,
    qry_np: np.ndarray,
    r0: np.ndarray,
    r1: np.ndarray,
    q0: np.ndarray,
    q1: np.ndarray,
    scoring: Scoring = Scoring(),
    *,
    device: torch.device,
):
    """Batched inter-anchor alignment from span arrays (0-based half-open).

    Returns (ncols [n] int64, gapped: dict seg_idx -> (ref_runs, q_runs)).
    The native engine reads straight from the genome arrays and marks
    segments over 4096 bp with -1 (and gap-run overflows with -2); those
    are redone through `align_segments`.
    """
    from paramugsy_tpu_torch.ops.native import nw_segments_native

    n = len(r0)
    if n == 0:
        return np.zeros(0, np.int64), {}
    nat = nw_segments_native(
        ref_np, qry_np, r0, r1, q0, q1,
        scoring.match, scoring.mismatch, scoring.gap,
    )
    if nat is None:  # no native library: slice + the generic path
        res = align_segments(
            [(ref_np[a:b], qry_np[c:d]) for a, b, c, d in zip(r0, r1, q0, q1)],
            scoring,
            device=device,
        )
        ncols = np.fromiter((r[2] for r in res), np.int64, count=n)
        gapped = {t: (rg, qg) for t, (rg, qg, _) in enumerate(res) if rg or qg}
        return ncols, gapped
    cols, nruns, runs, n_dp = nat
    redo = np.flatnonzero(cols < 0)
    if n_dp:
        engines.record("native-nw", n_dp)
    gapped: dict = {}
    for t in np.flatnonzero(nruns > 0):
        if cols[t] < 0:
            continue
        gapped[int(t)] = _runs_of(runs[t, : nruns[t]])
    ncols = cols.astype(np.int64)
    if len(redo):
        res = align_segments(
            [(ref_np[r0[t]:r1[t]], qry_np[q0[t]:q1[t]]) for t in redo],
            scoring,
            device=device,
        )
        for t, (rg, qg, nc) in zip(redo, res):
            ncols[t] = nc
            if rg or qg:
                gapped[int(t)] = (rg, qg)
            else:
                gapped.pop(int(t), None)
    return ncols, gapped


def align_long_segment(
    a: np.ndarray, b: np.ndarray, scoring: Scoring = Scoring(), width: int | None = None
):
    """One long segment on the host banded engines, at band `width` or,
    by default, the width doubling from 512 until the length difference
    fits: native C++ banded first, the plain row-banded DP on the CPU
    (`banded_align_plain`, the reference's NumPy mirror's counterpart)
    when the native library is absent."""
    from paramugsy_tpu_torch.ops.banded import banded_align_plain
    from paramugsy_tpu_torch.ops.native import banded_align_native

    if width is None:
        width = 512
        while abs(len(a) - len(b)) >= width // 2:
            width *= 2
    out = banded_align_native(
        np.asarray(a), np.asarray(b), width,
        scoring.match, scoring.mismatch, scoring.gap,
    )
    if out is not None:
        engines.record("native-banded")
        return out
    engines.record("numpy-banded")
    return banded_align_plain(
        np.asarray(a, np.int8), np.asarray(b, np.int8), width=width,
        match=scoring.match, mismatch=scoring.mismatch, gap=scoring.gap,
    )
