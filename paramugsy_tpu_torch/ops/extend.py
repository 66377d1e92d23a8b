"""Inter-anchor gap alignment (counterpart of paramugsy_tpu.ops.extend).

Segments with both sides <= 4096 bp run on the native host NW engine (or
the reference's NumPy NW when the native library is absent).  Longer ones
go to the port's wavefront engine on a CUDA device; on the CPU they go
to the native banded engine unless PARAMUGSY_DEVICE_DP=1 (see
`engines.device_dp_enabled`).  `Scoring`, `nw_align_batch` and `traceback_gaps` are the
reference's, which import no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from paramugsy_tpu.coords.range import Range
from paramugsy_tpu.ops.extend import Scoring, nw_align_batch, traceback_gaps
from paramugsy_tpu_torch.ops import engines

_BUCKETS = (16, 64, 256, 1024, 4096)


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
    from paramugsy_tpu.ops.native import nw_align_batch_native

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
    from paramugsy_tpu.ops.native import nw_segments_native

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
    """One long segment on the native host banded engine, at band `width`
    or, by default, the width doubling from 512 until the length
    difference fits."""
    from paramugsy_tpu.ops.native import banded_align_native

    if width is None:
        width = 512
        while abs(len(a) - len(b)) >= width // 2:
            width *= 2
    out = banded_align_native(
        np.asarray(a), np.asarray(b), width,
        scoring.match, scoring.mismatch, scoring.gap,
    )
    if out is None:
        raise RuntimeError(
            "native library unavailable (build it with `make -C native`); "
            "set PARAMUGSY_DEVICE_DP=1 to align long segments on the device"
        )
    engines.record("native-banded")
    return out
