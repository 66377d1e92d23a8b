"""Pairwise genome alignment (counterpart of paramugsy_tpu.ops.align_pair,
the ``mugsy_nucmer`` role).

ref/query codes -> seeds + clusters of both strands (one pass of torch ops
on the device, one transfer back) -> chains (host) -> inter-anchor gap
alignment (native NW; long segments on the device wavefront kernels) ->
delta entries.

Sequences longer than ``cfg.window`` are cut into a grid of overlapping
window pairs that run through `align_pairs_batch`, and the pieces are
stitched back into one entry list (`_align_pair_windowed`).

`align_self` is the genome-vs-self form (duplication detection): repeat
seeding pairs adjacent occurrences of each k-mer, and the same chaining
and gap extension turn them into entries; beyond ``cfg.window`` it runs
per window and per window pair (`_align_self_windowed`).

The host helpers (config, chains, entry assembly, windows, post-filters)
are copied from the reference, whose module imports JAX.
"""
from __future__ import annotations

import dataclasses
import logging
from bisect import bisect_left
from dataclasses import dataclass, field

import numpy as np
import torch

from paramugsy_tpu_torch.coords.range import Range
from paramugsy_tpu_torch.formats.delta import DeltaEntry, trim_entry_left
from paramugsy_tpu_torch.lcb.merge import _fuse_pair
from paramugsy_tpu_torch.ops import engines
from paramugsy_tpu_torch.ops.chaining import chain_clusters
from paramugsy_tpu_torch.ops.encode import (
    bucket_size,
    encode,
    revcomp_codes_np,
    upload_codes,
)
from paramugsy_tpu_torch.ops.extend import Scoring, align_segments, align_segments_spans
from paramugsy_tpu_torch.ops.seeding import (
    auto_sample_shift,
    repeat_cluster_packed,
    seed_cluster_both_packed,
    unpack_seed_clusters,
)
from paramugsy_tpu_torch.utils.platform import resolve_device

log = logging.getLogger("paramugsy.align")


@dataclass
class AlignConfig:
    """The reference's AlignConfig (same fields, same defaults)."""

    k: int = 15
    min_match: int = 20  # nucmer -l
    max_gap: int = 90  # nucmer -g
    band: int = 16
    min_cluster: int = 65  # nucmer -c
    break_len: int = 200  # nucmer -b
    max_seeds: int = 1 << 15
    max_seeds_cap: int = 1 << 18
    seed_sample_shift: int | None = None
    seed_merge_gap: int | None = None
    pin_max_seeds: int | None = None
    max_clusters: int = 4096
    unique_in_query: bool = False  # nucmer --mum vs --mumreference
    scoring: Scoring = field(default_factory=Scoring)
    post_filter: str | None = None  # None, "one_to_one" or "colinear"
    window: int = 1 << 22
    window_overlap: int = 1 << 17


@dataclass
class RawChain:
    """A chained set of anchors in (0-based, strand-local) coordinates."""

    seeds: np.ndarray  # [n, 3] rpos, qpos, len; sorted, non-overlapping
    reverse: bool
    break_len: int = 200


def effective_break(cfg: AlignConfig, shift: int) -> int:
    """Part-split / chain-join gap threshold, scaled by sample density."""
    return cfg.break_len << shift


def resolve_sample_shift(cfg: AlignConfig, n_ref: int, n_q: int) -> int:
    if cfg.seed_sample_shift is not None:
        return int(cfg.seed_sample_shift)
    return auto_sample_shift(n_ref + n_q)


def initial_max_seeds(cfg: AlignConfig, n_ref: int, n_q: int) -> int:
    """Seed-bucket start size, adapted to the pair's bucket."""
    if cfg.pin_max_seeds is not None:
        return int(cfg.pin_max_seeds)
    bucket = max(bucket_size(n_ref), bucket_size(n_q))
    if resolve_sample_shift(cfg, n_ref, n_q):
        return int(min(cfg.max_seeds, max(4096, bucket >> 9)))
    return int(min(cfg.max_seeds, max(4096, bucket >> 6)))


def transfer_slice(
    cfg: AlignConfig, shift: int, max_seeds: int
) -> tuple[int | None, int | None]:
    """(m_out, c_out) output-slice sizes: sampled seeding slices to 2048
    seeds + 512 cluster summaries; truncation is detected and refetched."""
    if not shift:
        return None, None
    return min(max_seeds, 2048), min(cfg.max_clusters, 512)


def _chain_seeds_all(
    ref_codes: torch.Tensor, q_codes: torch.Tensor, q_len: int, cfg: AlignConfig
) -> list[RawChain]:
    """Seeds of both strands -> chains per strand, with the reference's
    retry ladder: a sample-buffer overflow redoes the pair unsampled, a
    too-small output slice refetches full-size, and a seed-bucket
    overflow doubles the bucket up to `max_seeds_cap`."""
    device = ref_codes.device
    max_seeds = initial_max_seeds(cfg, ref_codes.shape[0], q_codes.shape[0])
    shift = resolve_sample_shift(cfg, ref_codes.shape[0], q_codes.shape[0])
    m_out, c_out = transfer_slice(cfg, shift, max_seeds)
    while True:
        engines.record_seedcluster(device)  # one count per actual dispatch
        packed = seed_cluster_both_packed(
            ref_codes,
            q_codes,
            q_len,
            k=cfg.k,
            max_seeds=max_seeds,
            unique_in_query=cfg.unique_in_query,
            min_match=cfg.min_match,
            band=cfg.band,
            max_gap=cfg.max_gap,
            max_clusters=cfg.max_clusters,
            sample_shift=shift,
            merge_gap=cfg.seed_merge_gap,
            m_out=m_out,
            c_out=c_out,
        ).cpu().numpy()
        _, n_runs, samp_over, m_compute, strands = unpack_seed_clusters(
            packed, max_seeds, cfg.max_clusters
        )
        if samp_over and shift:
            log.warning("sample buffer overflow; redoing pair unsampled")
            shift = 0
            m_out, c_out = transfer_slice(cfg, shift, max_seeds)
            continue
        if any(s.truncated for s in strands) and m_out is not None:
            log.warning(
                "sliced transfer overflow (m_out=%s); refetching full", m_out
            )
            m_out = c_out = None
            continue
        if n_runs <= m_compute or max_seeds >= cfg.max_seeds_cap:
            if any(s.truncated for s in strands):
                log.warning(
                    "cluster bucket overflow (max_clusters=%d); keeping "
                    "the first summaries", cfg.max_clusters,
                )
            break
        if cfg.pin_max_seeds is not None:
            log.warning(
                "seed bucket pinned at %d but %d merged runs; truncating",
                max_seeds, n_runs,
            )
            break
        max_seeds = min(
            cfg.max_seeds_cap, max(max_seeds * 2, 1 << (n_runs - 1).bit_length())
        )
        m_out, c_out = transfer_slice(cfg, shift, max_seeds)
    return _chains_of_strands(strands, cfg, effective_break(cfg, shift))


def _chains_of_strands(
    strands, cfg: AlignConfig, eff_break: int | None = None
) -> list[RawChain]:
    """Per-strand clustered seeds -> chained, monotone anchor sets."""
    if eff_break is None:
        eff_break = cfg.break_len
    out: list[RawChain] = []
    for reverse, cl in zip((False, True), strands):
        cmask = cl.c_mask.copy()
        cmask[cl.n_clusters :] = False
        idx = np.flatnonzero(cmask)
        chains_ids = chain_clusters(
            cl.c_rstart[idx],
            cl.c_rend[idx],
            cl.c_qstart[idx],
            cl.c_qend[idx],
            cl.c_weight[idx],
            max_join_gap=eff_break,
            min_chain_weight=cfg.min_cluster,
        )
        s_rpos, s_qpos, s_len = cl.seed_rpos, cl.seed_qpos, cl.seed_len
        # Members of cluster c are seeds [c_first[c], c_first[c] + c_nseeds[c]).
        first, nseeds = cl.c_first, cl.c_nseeds
        for chain in chains_ids:
            sel = (
                np.concatenate(
                    [
                        np.arange(
                            int(first[idx[c]]),
                            int(first[idx[c]]) + int(nseeds[idx[c]]),
                        )
                        for c in chain
                    ]
                )
                if chain
                else np.empty(0, np.int64)
            )
            rp, qp, ln = s_rpos[sel], s_qpos[sel], s_len[sel]
            order = np.lexsort((rp, qp))
            rows = _trim_monotone(rp[order], qp[order], ln[order])
            if len(rows):
                out.append(
                    RawChain(seeds=rows, reverse=reverse, break_len=eff_break)
                )
    return out


def _trim_monotone(rp: np.ndarray, qp: np.ndarray, ln: np.ndarray) -> np.ndarray:
    """Make seeds strictly monotone + non-overlapping on both axes."""
    rp = rp.astype(np.int64)
    qp = qp.astype(np.int64)
    ln = ln.astype(np.int64)
    n = len(rp)
    if n == 0:
        return np.empty((0, 3), dtype=np.int64)
    prev_rend = np.concatenate(([-1], rp[:-1] + ln[:-1] - 1))
    prev_qend = np.concatenate(([-1], qp[:-1] + ln[:-1] - 1))
    trim = np.maximum.reduce([prev_rend - rp + 1, prev_qend - qp + 1, np.zeros(n, np.int64)])
    r2, q2, l2 = rp + trim, qp + trim, ln - trim
    if (l2 > 0).all():
        return np.stack([r2, q2, l2], axis=1)
    # Exact sequential walk (rare: contained seeds present).
    rows = []
    prev_r = prev_q = -1
    for r, q, l in zip(rp, qp, ln):
        t = max(prev_r - r + 1, prev_q - q + 1, 0)
        r, q, l = r + t, q + t, l - t
        if l <= 0:
            continue
        rows.append((int(r), int(q), int(l)))
        prev_r, prev_q = r + l - 1, q + l - 1
    return np.array(rows, dtype=np.int64) if rows else np.empty((0, 3), dtype=np.int64)


def _extend_left(
    ref_np: np.ndarray, query_np: np.ndarray, r0: int, q0: int, cap: int = 4096
) -> int:
    """Bases to extend a match leftward from (r0, q0) exclusive."""
    m = min(r0, q0, cap)
    if m <= 0:
        return 0
    a = ref_np[r0 - m : r0]
    b = query_np[q0 - m : q0]
    rev = ((a == b) & (a < 4))[::-1]
    return int(np.argmin(rev)) if not rev.all() else m


def _extend_right(
    ref_np: np.ndarray, query_np: np.ndarray, r1: int, q1: int, cap: int = 4096
) -> int:
    """Bases to extend a match rightward from (r1, q1) inclusive ends."""
    m = min(len(ref_np) - r1 - 1, len(query_np) - q1 - 1, cap)
    if m <= 0:
        return 0
    a = ref_np[r1 + 1 : r1 + 1 + m]
    b = query_np[q1 + 1 : q1 + 1 + m]
    eq = (a == b) & (a < 4)
    return int(np.argmin(eq)) if not eq.all() else m


def _entries_of_chain(
    chain: RawChain,
    ref_np: np.ndarray,
    query_np: np.ndarray,  # strand-local codes (revcomp'd when reverse)
    ref_name: str,
    query_name: str,
    n_q: int,
    cfg: AlignConfig,
    device: torch.device,
) -> list[DeltaEntry]:
    """Assemble delta entries from a chain, aligning inter-anchor gaps."""
    seeds = chain.seeds.copy()
    n = len(seeds)
    rp, qp, ln = seeds[:, 0], seeds[:, 1], seeds[:, 2]
    rend, qend = rp + ln - 1, qp + ln - 1
    # brk[i] = True: a new part starts at seed i+1.
    if n > 1:
        gap_r = rp[1:] - rend[:-1] - 1
        gap_q = qp[1:] - qend[:-1] - 1
        brk = np.maximum(gap_r, gap_q) > chain.break_len
    else:
        brk = np.zeros(0, dtype=bool)
    starts = np.concatenate(([0], np.flatnonzero(brk) + 1))
    ends = np.concatenate((starts[1:], [n]))

    # Maximal end extension of each part, clamped at the neighbouring
    # part's nearest seed.
    for f, l in zip(starts.tolist(), (ends - 1).tolist()):
        cap = 4096
        if f > 0:
            cap = min(cap, int(rp[f] - rend[f - 1] - 1), int(qp[f] - qend[f - 1] - 1))
        t = _extend_left(ref_np, query_np, int(rp[f]), int(qp[f]), max(cap, 0))
        if t:
            rp[f] -= t
            qp[f] -= t
            ln[f] += t
        cap = 4096
        if l + 1 < n:
            cap = min(cap, int(rp[l + 1] - rend[l] - 1), int(qp[l + 1] - qend[l] - 1))
        t = _extend_right(ref_np, query_np, int(rend[l]), int(qend[l]), max(cap, 0))
        if t:
            ln[l] += t
            rend[l] += t
            qend[l] += t

    seg_idx = np.flatnonzero(~brk) + 1
    ncols, gapped = align_segments_spans(
        ref_np, query_np,
        rend[seg_idx - 1] + 1, rp[seg_idx],
        qend[seg_idx - 1] + 1, qp[seg_idx],
        cfg.scoring,
        device=device,
    )
    n_segs = len(seg_idx)

    # Column offset before each segment within its part.
    cln = np.concatenate(([0], np.cumsum(ln)))
    cnc = np.concatenate(([0], np.cumsum(ncols)))
    t0 = np.searchsorted(seg_idx, starts, side="left")
    pid = np.searchsorted(starts, seg_idx, side="right") - 1
    col_before = (cln[seg_idx] - cln[starts[pid]]) + (
        cnc[np.arange(n_segs)] - cnc[t0[pid]]
    )

    n_parts = len(starts)
    part_rgaps: list[list[Range]] = [[] for _ in range(n_parts)]
    part_qgaps: list[list[Range]] = [[] for _ in range(n_parts)]
    cb = col_before.tolist()
    pids = pid.tolist()
    for t in sorted(gapped):
        rg, qg = gapped[t]
        col = cb[t]
        p = pids[t]
        part_rgaps[p].extend(Range(g.start + col, g.end + col) for g in rg)
        part_qgaps[p].extend(Range(g.start + col, g.end + col) for g in qg)

    entries: list[DeltaEntry] = []
    firsts, lasts = starts.tolist(), (ends - 1).tolist()
    rp_l, qp_l = rp.tolist(), qp.tolist()
    rend_l, qend_l = rend.tolist(), qend.tolist()
    for p in range(n_parts):
        f, l = firsts[p], lasts[p]
        rs, re_ = rp_l[f], rend_l[l]
        qs, qe = qp_l[f], qend_l[l]
        if chain.reverse:
            q_range = Range(n_q - qs, n_q - qe)
        else:
            q_range = Range(qs + 1, qe + 1)
        entries.append(
            DeltaEntry(
                ref_name=ref_name,
                query_name=query_name,
                ref_len=len(ref_np),
                query_len=n_q,
                ref_range=Range(rs + 1, re_ + 1),
                query_range=q_range,
                ref_gaps=part_rgaps[p],
                query_gaps=part_qgaps[p],
            )
        )
    return entries


def device_codes(
    np_codes: np.ndarray,
    device: torch.device,
    cache: dict | None = None,
    key: str | None = None,
) -> torch.Tensor:
    """Padded device copy of a code array, memoized per (key, length)."""
    if cache is None or key is None:
        return upload_codes(np_codes, device)
    k = (key, len(np_codes))
    hit = cache.get(k)
    if hit is None:
        hit = upload_codes(np_codes, device)
        cache[k] = hit
    return hit


def _finish_pair(
    chains: list[RawChain],
    ref_np: np.ndarray,
    query_np: np.ndarray,
    ref_name: str,
    query_name: str,
    cfg: AlignConfig,
    device: torch.device,
) -> list[DeltaEntry]:
    """Chains -> sorted, post-filtered delta entries (host tail)."""
    n_q = len(query_np)
    query_rc_np = revcomp_codes_np(query_np)
    entries: list[DeltaEntry] = []
    for chain in chains:
        qn = query_rc_np if chain.reverse else query_np
        entries.extend(
            _entries_of_chain(
                chain, ref_np, qn, ref_name, query_name, n_q, cfg, device
            )
        )
    entries.sort(key=lambda e: (e.ref_range.abs().start, e.ref_range.abs().end))
    if cfg.post_filter == "one_to_one":
        entries = filter_one_to_one(entries)
    elif cfg.post_filter == "colinear":
        entries = filter_colinear(entries)
    elif cfg.post_filter:
        raise ValueError(f"unknown post_filter: {cfg.post_filter}")
    return entries


def align_pair(
    ref_seq: str | np.ndarray,
    query_seq: str | np.ndarray,
    ref_name: str = "ref",
    query_name: str = "query",
    cfg: AlignConfig | None = None,
    device_cache: dict | None = None,
    device: str | torch.device | None = None,
) -> list[DeltaEntry]:
    """Full pairwise alignment: sequences -> delta entries (both strands),
    computed on `device` (``cuda`` unless named)."""
    device = resolve_device(device)
    cfg = cfg or AlignConfig()
    ref_np = ref_seq if isinstance(ref_seq, np.ndarray) else encode(ref_seq)
    query_np = query_seq if isinstance(query_seq, np.ndarray) else encode(query_seq)
    n_q = len(query_np)
    if max(len(ref_np), n_q) > cfg.window:
        return _align_pair_windowed(
            ref_np, query_np, ref_name, query_name, cfg, device_cache, device=device
        )
    ref_d = device_codes(ref_np, device, device_cache, ref_name)
    query_d = device_codes(query_np, device, device_cache, query_name)
    chains = _chain_seeds_all(ref_d, query_d, n_q, cfg)
    return _finish_pair(chains, ref_np, query_np, ref_name, query_name, cfg, device)


def align_pairs_batch(
    jobs: list[tuple],
    cfg: AlignConfig | None = None,
    device_cache: dict | None = None,
    device: str | torch.device | None = None,
) -> list[list[DeltaEntry]]:
    """Align many (ref_seq, query_seq, ref_name, query_name) jobs on
    `device`, one `align_pair` each.

    The reference seeds each bucket group of jobs in one vmapped call; a
    row gives the same seeds either way, so the entries are the same.
    The grouped form waits for a cell where it moves the wall (ROADMAP
    queue B)."""
    device = resolve_device(device)
    return [
        align_pair(r, q, rn, qn, cfg, device_cache, device) for r, q, rn, qn in jobs
    ]


def _windows(n: int, cfg: AlignConfig):
    """(win_start, win_end, core_start, core_end) tiles over [0, n).

    Cores tile the sequence exactly; each window extends overlap/2 beyond
    its core on both sides so matches near core boundaries are seen whole
    by at least one window.
    """
    step = cfg.window - cfg.window_overlap
    assert step > 0, "window_overlap must be smaller than window"
    half = cfg.window_overlap // 2
    out = []
    i = 0
    while i * step < n:
        c0, c1 = i * step, min((i + 1) * step, n)
        out.append((max(0, c0 - half), min(n, c1 + half), c0, c1))
        i += 1
    return out


def _diag_break(a: DeltaEntry, b: DeltaEntry) -> int:
    """Diagonal drift between a's end junction and b's start junction
    (forward: q - r constant along an ungapped alignment; reverse:
    q + r constant)."""
    if a.query_range.is_forward:
        return abs(
            (b.query_range.start - b.ref_range.start)
            - (a.query_range.end - a.ref_range.end)
        )
    return abs(
        (b.query_range.start + b.ref_range.start)
        - (a.query_range.end + a.ref_range.end)
    )


def _try_fuse_pieces(
    a: DeltaEntry,
    b: DeltaEntry,
    ref_np: np.ndarray,
    query_np: np.ndarray,
    cfg: AlignConfig,
    *,
    device: torch.device,
) -> DeltaEntry | None:
    """Fuse two collinear window pieces (a before b on the ref axis).

    Overlapping spans are de-overlapped by trimming b's prefix in column
    space; the remaining junction gap (<= break_len) is aligned on
    `device`'s engines and concatenated.  Returns the fused entry, or None
    when the pieces are not two halves of one alignment.
    """
    if a.query_range.is_forward != b.query_range.is_forward:
        return None
    if _diag_break(a, b) > cfg.break_len:
        return None
    forward = a.query_range.is_forward
    gap_r = b.ref_range.start - a.ref_range.end - 1
    if gap_r < -2 * cfg.window_overlap or gap_r > cfg.break_len:
        return None
    if gap_r < 0:
        b = trim_entry_left(b, "ref", -gap_r)
        if b is None:
            return a  # b contained in a's ref span
    if forward:
        gap_q = b.query_range.start - a.query_range.end - 1
    else:
        gap_q = a.query_range.end - b.query_range.start - 1
    if gap_q < -2 * cfg.window_overlap:
        return None
    if gap_q < 0:
        b = trim_entry_left(b, "query", -gap_q)
        if b is None:
            return a
    gap_r = b.ref_range.start - a.ref_range.end - 1
    if forward:
        gap_q = b.query_range.start - a.query_range.end - 1
    else:
        gap_q = a.query_range.end - b.query_range.start - 1
    if not (0 <= gap_r <= cfg.break_len and 0 <= gap_q <= cfg.break_len):
        return None
    r_seg = ref_np[a.ref_range.end : a.ref_range.end + gap_r]
    if forward:
        q_seg = query_np[a.query_range.end : a.query_range.end + gap_q]
    else:
        q_seg = revcomp_codes_np(
            query_np[b.query_range.start : b.query_range.start + gap_q]
        )
    rg, qg, ncols = align_segments([(r_seg, q_seg)], cfg.scoring, device=device)[0]
    return _fuse_pair(a, b, rg, qg, ncols)


def _fuse_window_pieces(
    entries: list[DeltaEntry],
    ref_np: np.ndarray,
    query_np: np.ndarray,
    cfg: AlignConfig,
    *,
    device: torch.device,
) -> list[DeltaEntry]:
    """Stitch alignments that were split at window boundaries: a sweep in
    ref order per orientation fuses each run of collinear pieces back into
    one delta entry.  Only piece pairs that overlap on an axis, or whose
    junction lies within the overlap of a core boundary, are candidates
    (interior near-misses that the unwindowed path keeps apart stay
    apart)."""
    step = cfg.window - cfg.window_overlap
    half = cfg.window_overlap  # junction-to-boundary slack

    def near_boundary(pos: int) -> bool:
        r = pos % step
        return r <= half or r >= step - half

    by_orient: dict[bool, list[DeltaEntry]] = {True: [], False: []}
    for e in entries:
        by_orient[e.query_range.is_forward].append(e)
    out: list[DeltaEntry] = []
    for group in by_orient.values():
        group.sort(key=lambda e: (e.ref_range.abs().start, e.ref_range.abs().end))
        cur: DeltaEntry | None = None
        for e in group:
            if cur is None:
                cur = e
                continue
            overlaps = (
                e.ref_range.start <= cur.ref_range.end
                or (
                    e.query_range.abs().start <= cur.query_range.abs().end
                    and cur.query_range.abs().start <= e.query_range.abs().end
                )
            )
            fused = (
                _try_fuse_pieces(cur, e, ref_np, query_np, cfg, device=device)
                if overlaps or near_boundary(cur.ref_range.end)
                else None
            )
            if fused is None:
                out.append(cur)
                cur = e
            else:
                cur = fused
        if cur is not None:
            out.append(cur)
    return out


def window_pair_jobs(
    ref_np: np.ndarray,
    query_np: np.ndarray,
    ref_name: str,
    query_name: str,
    cfg: AlignConfig,
) -> tuple[list[tuple], list[tuple]]:
    """(jobs, meta) for the window-pair grid of one long pair.

    Each job is an ordinary (ref_slice, query_slice, name, name) pairwise
    job no longer than ``cfg.window``; ``assemble_windowed`` turns the
    per-job results back into one entry list."""
    r_wins = _windows(len(ref_np), cfg)
    q_wins = _windows(len(query_np), cfg)
    jobs: list[tuple] = []
    meta: list[tuple] = []
    for rw0, rw1, rc0, rc1 in r_wins:
        for qw0, qw1, qc0, qc1 in q_wins:
            jobs.append(
                (
                    ref_np[rw0:rw1], query_np[qw0:qw1],
                    f"{ref_name}@w{rw0}", f"{query_name}@w{qw0}",
                )
            )
            meta.append((rw0, rc0, rc1, qw0, qc0, qc1))
    return jobs, meta


def assemble_windowed(
    per_job: list[list[DeltaEntry]],
    meta: list[tuple],
    ref_np: np.ndarray,
    query_np: np.ndarray,
    ref_name: str,
    query_name: str,
    cfg: AlignConfig,
    *,
    device: torch.device,
) -> list[DeltaEntry]:
    """Window-pair results -> one pair's entries (midpoint dedup + fuse).

    An entry is kept iff both its midpoints fall in the window pair's
    cores, so every locus is reported by exactly one window pair; pieces
    of one alignment cut at window boundaries are stitched back into
    single entries by `_fuse_window_pieces`.  The post-filter runs here,
    once, on the whole list."""
    n_r, n_q = len(ref_np), len(query_np)
    entries: list[DeltaEntry] = []
    for (rw0, rc0, rc1, qw0, qc0, qc1), got in zip(meta, per_job):
        for e in got:
            rm = rw0 + (e.ref_range.abs().start + e.ref_range.abs().end) // 2
            qm = qw0 + (e.query_range.abs().start + e.query_range.abs().end) // 2
            # cores are 0-based [c0, c1); midpoints are 1-indexed
            if not (rc0 < rm <= rc1 and qc0 < qm <= qc1):
                continue
            entries.append(
                dataclasses.replace(
                    e,
                    ref_name=ref_name,
                    query_name=query_name,
                    ref_len=n_r,
                    query_len=n_q,
                    ref_range=Range(
                        e.ref_range.start + rw0, e.ref_range.end + rw0
                    ),
                    query_range=Range(
                        e.query_range.start + qw0, e.query_range.end + qw0
                    ),
                )
            )
    entries = _fuse_window_pieces(entries, ref_np, query_np, cfg, device=device)
    entries.sort(key=lambda e: (e.ref_range.abs().start, e.ref_range.abs().end))
    if cfg.post_filter == "one_to_one":
        entries = filter_one_to_one(entries)
    elif cfg.post_filter == "colinear":
        entries = filter_colinear(entries)
    return entries


def windowed_sub_config(cfg: AlignConfig) -> AlignConfig:
    """Config for window sub-jobs: never recurse, never post-filter
    (global filters need the full entry set)."""
    return dataclasses.replace(cfg, window=1 << 62, post_filter=None)


def _align_pair_windowed(
    ref_np: np.ndarray,
    query_np: np.ndarray,
    ref_name: str,
    query_name: str,
    cfg: AlignConfig,
    device_cache: dict | None = None,
    *,
    device: torch.device,
) -> list[DeltaEntry]:
    """Sequence-axis decomposition for contigs beyond the seeding window:
    the window-pair grid runs through `align_pairs_batch`.  Window slices
    are keyed by their offset, so each uploads once although it takes part
    in many window pairs."""
    cache = device_cache if device_cache is not None else {}
    jobs, meta = window_pair_jobs(ref_np, query_np, ref_name, query_name, cfg)
    per_job = align_pairs_batch(jobs, windowed_sub_config(cfg), cache, device)
    return assemble_windowed(
        per_job, meta, ref_np, query_np, ref_name, query_name, cfg, device=device
    )


def align_self(
    seq: str | np.ndarray,
    name: str = "ref",
    cfg: AlignConfig | None = None,
    device_cache: dict | None = None,
    device: str | torch.device | None = None,
) -> list[DeltaEntry]:
    """Genome-vs-self repeat alignment (the duplication-detection role),
    computed on `device` (``cuda`` unless named).

    Direct and inverted segmental duplications come from adjacent-
    occurrence repeat seeding (`repeat_cluster_packed`), then are chained
    and gap-extended like `align_pair`'s.  Entries are canonical (copy 1
    starts before copy 2) and never the identity.  The seed bucket starts
    at ``cfg.max_seeds`` and grows to fit the merged runs, up to
    ``max_seeds_cap``; the self path has no sampling and no pinned bucket.
    """
    device = resolve_device(device)
    cfg = cfg or AlignConfig()
    ref_np = seq if isinstance(seq, np.ndarray) else encode(seq)
    n = len(ref_np)

    if n > cfg.window:
        return _align_self_windowed(ref_np, name, cfg, device=device)

    ref_d = device_codes(ref_np, device, device_cache, name)
    ref_rc_np = revcomp_codes_np(ref_np)

    max_seeds = cfg.max_seeds
    while True:
        engines.record_repeatcluster(device)  # one count per actual dispatch
        packed = repeat_cluster_packed(
            ref_d,
            n,
            k=cfg.k,
            max_seeds=max_seeds,
            min_match=cfg.min_match,
            band=cfg.band,
            max_gap=cfg.max_gap,
            max_clusters=cfg.max_clusters,
        ).cpu().numpy()
        _, n_runs, _, m_compute, strands = unpack_seed_clusters(
            packed, max_seeds, cfg.max_clusters
        )
        if n_runs <= m_compute or max_seeds >= cfg.max_seeds_cap:
            break
        max_seeds = min(
            cfg.max_seeds_cap, max(max_seeds * 2, 1 << (n_runs - 1).bit_length())
        )

    entries: list[DeltaEntry] = []
    for chain in _chains_of_strands(strands, cfg):
        qn = ref_rc_np if chain.reverse else ref_np
        entries.extend(
            _entries_of_chain(chain, ref_np, qn, name, name, n, cfg, device)
        )
    out: list[DeltaEntry] = []
    for e in entries:
        r, q = e.ref_range.abs(), e.query_range.abs()
        if (r.start, r.end) == (q.start, q.end):
            continue  # palindromic self-match (identical interval)
        if r.start >= q.start:
            continue  # mirror of a pair already reported canonically
        out.append(e)
    out.sort(key=lambda e: (e.ref_range.abs().start, e.query_range.abs().start))
    return out


def _align_self_windowed(
    ref_np: np.ndarray, name: str, cfg: AlignConfig, *, device: torch.device
) -> list[DeltaEntry]:
    """Self-repeat detection beyond the seeding window.

    Within-window repeats come from `align_self` per window; repeats whose
    copies live in different windows are ordinary pairwise alignments
    between window i and window j (i < j), which also keeps the canonical
    copy1-before-copy2 orientation.  Each window keeps only the entries
    whose midpoints fall in its core (both cores for a window pair).
    """
    n = len(ref_np)
    sub = dataclasses.replace(cfg, window=1 << 62, post_filter=None)
    wins = _windows(n, cfg)
    # One cache for both the self and the cross-window alignments: window
    # slices key by (name@offset, length), so each uploads once.
    cache: dict = {}
    entries: list[DeltaEntry] = []
    for i, (rw0, rw1, rc0, rc1) in enumerate(wins):
        for e in align_self(
            ref_np[rw0:rw1], f"{name}@w{rw0}", sub, device_cache=cache, device=device
        ):
            rm = rw0 + (e.ref_range.abs().start + e.ref_range.abs().end) // 2
            qm = rw0 + (e.query_range.abs().start + e.query_range.abs().end) // 2
            if not (rc0 < rm <= rc1 and rc0 < qm <= rc1):
                continue
            entries.append(_shift_entry(e, rw0, rw0, n, name))
        for qw0, qw1, qc0, qc1 in wins[i + 1 :]:
            for e in align_pair(
                ref_np[rw0:rw1], ref_np[qw0:qw1],
                f"{name}@w{rw0}", f"{name}@w{qw0}", sub,
                device_cache=cache, device=device,
            ):
                rm = rw0 + (e.ref_range.abs().start + e.ref_range.abs().end) // 2
                qm = qw0 + (e.query_range.abs().start + e.query_range.abs().end) // 2
                if not (rc0 < rm <= rc1 and qc0 < qm <= qc1):
                    continue
                g = _shift_entry(e, rw0, qw0, n, name)
                r, q = g.ref_range.abs(), g.query_range.abs()
                if (r.start, r.end) == (q.start, q.end) or r.start >= q.start:
                    continue
                entries.append(g)
    entries.sort(key=lambda e: (e.ref_range.abs().start, e.query_range.abs().start))
    return entries


def _shift_entry(
    e: DeltaEntry, r_off: int, q_off: int, n: int, name: str
) -> DeltaEntry:
    """Window-local entry -> global coordinates (same sequence length n)."""
    return dataclasses.replace(
        e,
        ref_name=name,
        query_name=name,
        ref_len=n,
        query_len=n,
        ref_range=Range(e.ref_range.start + r_off, e.ref_range.end + r_off),
        query_range=Range(e.query_range.start + q_off, e.query_range.end + q_off),
    )


def _wis_filter(es: list[DeltaEntry], key) -> list[DeltaEntry]:
    """Optimal weighted interval scheduling on one axis, O(n log n)."""
    if not es:
        return es
    order = sorted(range(len(es)), key=lambda i: key(es[i]).abs().end)
    starts = [key(es[i]).abs().start for i in order]
    ends = [key(es[i]).abs().end for i in order]
    weights = [key(es[i]).length for i in order]
    n = len(order)
    dp = [0] * (n + 1)  # dp[t] = best weight among the first t intervals
    pred = [0] * n
    for t in range(n):
        p = bisect_left(ends, starts[t])  # ends[0..p-1] < starts[t]
        pred[t] = p
        dp[t + 1] = max(dp[t], weights[t] + dp[p])
    chosen: list[int] = []
    t = n - 1
    while t >= 0:
        if dp[t + 1] == dp[t]:
            t -= 1
        else:
            chosen.append(order[t])
            t = pred[t] - 1
    chosen.sort()
    return [es[i] for i in chosen]


def filter_one_to_one(entries: list[DeltaEntry]) -> list[DeltaEntry]:
    """delta-filter -1 role: optimal interval scheduling on the ref axis,
    then on the query axis."""
    es = _wis_filter(entries, lambda e: e.ref_range)
    es = _wis_filter(es, lambda e: e.query_range)
    return sorted(es, key=lambda e: e.ref_range.abs().start)


def filter_colinear(entries: list[DeltaEntry]) -> list[DeltaEntry]:
    """delta-filter -m role: one globally colinear chain (monotone on both
    axes, one orientation) of maximal ref length, by weighted LIS over a
    Fenwick max-tree."""
    if not entries:
        return entries

    def solve(cand, qkey):
        n = len(cand)
        order = sorted(range(n), key=lambda i: cand[i].ref_range.abs().start)
        qs = [qkey(cand[i])[0] for i in range(n)]
        qe = [qkey(cand[i])[1] for i in range(n)]
        coords = sorted(set(qe))
        pos = {v: t + 1 for t, v in enumerate(coords)}
        size = len(coords) + 1
        tree_score = [0] * (size + 1)
        tree_idx = [-1] * (size + 1)

        def update(t, sc, idx):
            while t <= size:
                if sc > tree_score[t]:
                    tree_score[t] = sc
                    tree_idx[t] = idx
                t += t & -t

        def query(t):
            sc, idx = 0, -1
            while t > 0:
                if tree_score[t] > sc:
                    sc, idx = tree_score[t], tree_idx[t]
                t -= t & -t
            return sc, idx

        import heapq

        score = [0] * n
        parent = [-1] * n
        pending: list[tuple[int, int]] = []  # (ref_end, entry) min-heap
        for i in order:
            rs = cand[i].ref_range.abs().start
            while pending and pending[0][0] < rs:
                _, j = heapq.heappop(pending)
                update(pos[qe[j]], score[j], j)
            t = bisect_left(coords, qs[i])  # coords[:t] < qs[i]
            best_sc, best_j = query(t)
            score[i] = cand[i].ref_range.length + best_sc
            parent[i] = best_j
            heapq.heappush(pending, (cand[i].ref_range.abs().end, i))
        if not n:
            return []
        i = max(range(n), key=lambda x: score[x])
        chain = []
        while i != -1:
            chain.append(cand[i])
            i = parent[i]
        chain.reverse()
        return chain

    best: list[DeltaEntry] = []
    for want_forward in (True, False):
        cand = [e for e in entries if e.query_range.is_forward == want_forward]
        if not cand:
            continue
        if want_forward:
            qkey = lambda e: (e.query_range.abs().start, e.query_range.abs().end)  # noqa: E731
        else:
            # Reverse chains run down the query axis: mirror the coordinates.
            qkey = lambda e: (-e.query_range.abs().end, -e.query_range.abs().start)  # noqa: E731
        chain = solve(cand, qkey)
        if sum(e.ref_range.length for e in chain) > sum(
            e.ref_range.length for e in best
        ):
            best = chain
    return best
