"""Both-strand exact-match seeding + clustering (counterpart of
paramugsy_tpu.ops.seeding).

`find_seeds_both` is the canonical-k-mer sort-join of the reference, as
plain torch ops on the codes' device: stable sorts on packed int64 keys,
cumsums, cummax and gathers.  Every size that changes output is computed
as the reference computes it, from padded lengths: the sample buffer B,
the match slice B2 and the output slices.  Of the reference's two
sampling-compaction forms (proven equal by its tests) this port keeps
scatter-then-sort, which sorts a 2^shift-times smaller buffer.

`find_repeat_seeds`, the self path's seeding, pairs adjacent occurrences
of each k-mer over the forward and reverse-complement streams of one
sequence.  Both seed sets are clustered per strand (or repeat type) and
packed in one layout (`_cluster_packed`); `seed_cluster_both_packed_batch`
packs a batch of pairs row by row (the sharded data plane's step).
`find_seeds` is the reference's forward-strand seeder, which its
single-pair compile check runs.

The values left in masked output slots are garbage that still reaches the
packed vector, so those are reproduced too (see `_carry_last_marked`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from paramugsy_tpu_torch.ops.encode import M32, kmer_canonical, kmer_codes

BIG = 2**31 - 1
M23 = (1 << 23) - 1
OFF = 1 << 23


class SeedMatches2(NamedTuple):
    """Both-strand maximal matches (device tensors, fixed size, masked)."""

    rpos: torch.Tensor
    qpos: torch.Tensor  # strand-local (revcomp coordinates for reverse runs)
    length: torch.Tensor
    reverse: torch.Tensor
    mask: torch.Tensor
    n_raw: torch.Tensor
    n_runs: torch.Tensor
    samp_over: torch.Tensor  # 1 = sample buffer overflowed, 2 = match slice


def _suffix_min(x):
    return torch.flip(torch.cummin(torch.flip(x, (0,)), 0).values, (0,))


def _carry_last_marked(mark: torch.Tensor, payload: torch.Tensor):
    """Per element: the payload at the most recent marked position
    (inclusive), and whether any marked position has been seen.

    The reference computes this with a log2(n) doubling scan whose zero
    padding leaves 0 before the first mark, except in one case: with no
    mark at all and n a power of two, its last element receives
    payload[0].  Unseen slots feed masked (but output-visible) values, so
    that case is reproduced.
    """
    n = mark.shape[0]
    idx = torch.arange(n, device=mark.device)
    last = torch.cummax(torch.where(mark, idx, -1), 0).values
    seen = last >= 0
    out = torch.where(seen, payload[torch.clamp(last, min=0)], 0)
    if n and n & (n - 1) == 0:
        out[-1] = torch.where(seen[-1], out[-1], payload[0])
    return seen, out


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to int32, as the reference's int32 arithmetic
    wraps them."""
    return ((x + 2**31) & M32) - 2**31


def _stable_order(*keys: torch.Tensor) -> torch.Tensor:
    """The permutation of a stable sort by `keys`, most significant first
    (one stable pass per key, least significant first)."""
    order = None
    for key in reversed(keys):
        k = key if order is None else key[order]
        _, o = torch.sort(k, stable=True)
        order = o if order is None else order[o]
    return order


class SeedMatches(NamedTuple):
    """Maximal unique exact matches of one strand (device tensors, fixed
    size, masked)."""

    rpos: torch.Tensor
    qpos: torch.Tensor
    length: torch.Tensor
    mask: torch.Tensor
    n_raw: torch.Tensor
    n_runs: torch.Tensor


def find_seeds(
    ref_codes: torch.Tensor,
    query_codes: torch.Tensor,
    *,
    k: int = 16,
    max_seeds: int = 1 << 16,
    unique_in_query: bool = False,
) -> SeedMatches:
    """Forward-strand maximal exact matches unique in the reference (and in
    the query with `unique_in_query`), the reference's first seeder (see
    paramugsy_tpu.ops.seeding.find_seeds).

    Its sorts are stable sorts of the same keys, and its int32 position
    sums wrap as the reference's do: the slots past the valid runs hold
    the reference's values too."""
    dev = ref_codes.device
    rk, rvalid = kmer_codes(ref_codes, k)
    qk, qvalid = kmer_codes(query_codes, k)
    n_r, n_q = rk.shape[0], qk.shape[0]
    n = n_r + n_q

    def arange(m):
        return torch.arange(m, device=dev, dtype=torch.int64)

    # One sort by (validity, code), refs before queries within a code.
    invalid = torch.cat([~rvalid, ~qvalid]).to(torch.int64)
    codes = torch.cat([rk, qk])
    order = _stable_order((invalid << 32) | codes)
    invalid, codes = invalid[order], codes[order]
    is_ref = (order < n_r).to(torch.int64)
    pos = torch.cat([arange(n_r), arange(n_q)])[order]
    valid = invalid == 0

    idx = arange(n)
    is_start = valid & ((codes != torch.roll(codes, 1)) | (idx == 0))
    seg_start = torch.cummax(torch.where(is_start, idx, -1), 0).values
    nxt = _suffix_min(torch.where(is_start, idx, BIG))
    nxt_after = torch.cat([nxt[1:], torch.full((1,), BIG, device=dev, dtype=torch.int64)])
    seg_end = torch.clamp(nxt_after - 1, max=n - 1)

    ref_in = (is_ref == 1) & valid
    query_in = (is_ref == 0) & valid

    def seg_sum(x):
        cum = torch.cumsum(x, 0)
        lo = torch.where(seg_start > 0, cum[torch.clamp(seg_start - 1, min=0)], 0)
        return cum[seg_end] - lo

    ref_count = seg_sum(ref_in.to(torch.int64))
    is_match = valid & query_in & (ref_count == 1)
    if unique_in_query:
        is_match = is_match & (seg_sum(query_in.to(torch.int64)) == 1)
    rpos = _wrap32(seg_sum(torch.where(ref_in, pos, 0)))
    qpos = pos
    n_raw = is_match.sum()

    # Every slot re-sorted by (match first, diagonal, rpos) for run merging.
    diag = _wrap32(rpos - qpos)
    order = _stable_order((~is_match).to(torch.int64), diag, rpos)
    diag_c, rpos_c, qpos_c, mask_c = diag[order], rpos[order], qpos[order], is_match[order]

    prev_mask = torch.roll(mask_c, 1) & (idx > 0)
    run_start = mask_c & (
        ~prev_mask
        | (diag_c != torch.roll(diag_c, 1))
        | (qpos_c != torch.roll(qpos_c, 1) + 1)
    )
    next_continues = (
        torch.roll(mask_c, -1)
        & (torch.roll(diag_c, -1) == diag_c)
        & (torch.roll(qpos_c, -1) == qpos_c + 1)
    )
    is_run_end = mask_c & ((idx == n - 1) | ~next_continues)
    run_start_idx = torch.cummax(torch.where(run_start, idx, -1), 0).values
    first = torch.clamp(run_start_idx, min=0)
    n_runs = is_run_end.sum()

    # Compaction: run ends first, each group in its order.
    _, order = torch.sort((~is_run_end).to(torch.int64), stable=True)
    order = order[: min(max_seeds, n)]
    return SeedMatches(
        rpos=rpos_c[first][order],
        qpos=qpos_c[first][order],
        length=(idx - run_start_idx + k)[order],
        mask=is_run_end[order],
        n_raw=n_raw,
        n_runs=n_runs,
    )


def auto_sample_shift(n_total: int) -> int:
    """Content-hash sampling policy: 1/4 density for joins >= 1M k-mers."""
    return 2 if n_total >= (1 << 20) else 0


def find_seeds_both(
    ref_codes: torch.Tensor,
    query_codes: torch.Tensor,
    q_len: int,
    *,
    k: int = 15,
    max_seeds: int = 1 << 16,
    unique_in_query: bool = False,
    sample_shift: int = 0,
    merge_gap: int | None = None,
) -> SeedMatches2:
    """Maximal unique matches of both strands via one canonical-k-mer join
    (see paramugsy_tpu.ops.seeding.find_seeds_both for the design)."""
    dev = ref_codes.device
    rk, rstrand, rvalid = kmer_canonical(ref_codes, k)
    qk, qstrand, qvalid = kmer_canonical(query_codes, k)
    n_r, n_q = rk.shape[0], qk.shape[0]
    n = n_r + n_q
    if max(n_r, n_q) >= 1 << 23:
        raise ValueError("sequence bucket exceeds 2^23; window the input")
    if k > 15:
        sample_shift = 0
    if merge_gap is None:
        merge_gap = 16 << sample_shift if sample_shift else 0

    def arange(m):
        return torch.arange(m, device=dev, dtype=torch.int64)

    # owner|strand|pos packed into 25 bits.
    packed = torch.cat(
        [
            (rstrand.to(torch.int64) << 23) | arange(n_r),
            (1 << 24) | (qstrand.to(torch.int64) << 23) | arange(n_q),
        ]
    )
    invalid_b = torch.cat([~rvalid, ~qvalid])
    samp_over = torch.zeros((), dtype=torch.int64, device=dev)

    if k <= 15:
        # Sort #1 key: [invalid(1)][canon(30)][owner(1)], refs first per code.
        canon_all = torch.cat([rk, qk])
        owner_key = torch.cat(
            [
                torch.zeros(n_r, dtype=torch.int64, device=dev),
                torch.ones(n_q, dtype=torch.int64, device=dev),
            ]
        )
        codes_all = (canon_all << 1) | owner_key
        key1 = codes_all | (invalid_b.to(torch.int64) << 31)
        if sample_shift:
            h = (canon_all * 2654435761) & M32
            keep = ((h >> (32 - sample_shift)) == 0) & ~invalid_b
            B = ((n >> sample_shift) + (n >> (sample_shift + 3)) + 1023) & ~1023
            B = min(B, n)
            samp_over = (keep.sum() > B).to(torch.int64)
            # Compact kept k-mers to the front of a B-sized buffer (slot B
            # collects the dropped and overflowing ones), then sort.
            dst = torch.where(keep, torch.cumsum(keep, 0) - 1, B).clamp(max=B)
            key1_c = torch.full((B + 1,), 1 << 31, dtype=torch.int64, device=dev)
            packed_c = torch.zeros(B + 1, dtype=torch.int64, device=dev)
            key1_c[dst] = key1
            packed_c[dst] = packed
            key1, packed = key1_c[:B], packed_c[:B]
            n = B
        key1, order = torch.sort(key1, stable=True)
        packed = packed[order]
        valid = key1 < (1 << 31)
        seg_key = key1 >> 1  # owner stripped: the segment id
        same_code = seg_key == torch.roll(seg_key, 1)
    else:
        # Keys (invalid, code, packed) in one int64: 1 + 32 + 25 bits.
        codes = torch.cat([rk, qk])
        key = (invalid_b.to(torch.int64) << 57) | (codes << 25) | packed
        key, _ = torch.sort(key)
        packed = key & ((1 << 25) - 1)
        codes = (key >> 25) & M32
        valid = (key >> 57) == 0
        same_code = codes == torch.roll(codes, 1)

    owner = packed >> 24
    strand = (packed >> 23) & 1
    pos = packed & M23

    idx = arange(n)
    is_start = valid & (~same_code | (idx == 0))
    ref_in = (owner == 0) & valid
    query_in = (owner > 0) & valid

    # Refs sort first within a segment: the segment has a unique ref iff
    # its first element is a ref and its second is not.
    false1 = torch.zeros(1, dtype=torch.bool, device=dev)
    nxt_ref = torch.cat([ref_in[1:], false1])
    nxt_same = torch.cat([same_code[1:], false1])
    two_refs = is_start & ref_in & nxt_same & nxt_ref
    seen, first_info = _carry_last_marked(
        is_start, packed | (two_refs.to(torch.int64) << 25)
    )
    first_packed = first_info & ((1 << 25) - 1)
    one_ref = ((first_packed >> 24) == 0) & (((first_info >> 25) & 1) == 0)
    rpos = first_packed & M23
    r_strand = (first_packed >> 23) & 1

    is_match = valid & query_in & seen & one_ref
    if unique_in_query:
        true1 = torch.ones(1, dtype=torch.bool, device=dev)
        nxt_invalid = torch.cat([~valid[1:], true1])
        nxt_start = torch.cat([is_start[1:], true1])
        is_end = valid & (nxt_start | nxt_invalid)
        q_in = query_in.to(torch.int64)
        cum_query = torch.cumsum(q_in, 0)
        before = torch.cummax(
            torch.where(is_start, cum_query - q_in, -1), 0
        ).values
        at_end = _suffix_min(torch.where(is_end, cum_query, BIG))
        is_match = is_match & ((at_end - before) == 1)

    n_raw = is_match.sum()

    # Strand-local query position: reverse matches anchor in revcomp
    # coordinates.
    rev = strand != r_strand
    qpos_local = torch.where(rev, q_len - pos - k, pos)
    owner2 = 1 + rev.to(torch.int64)  # 1 = forward, 2 = reverse

    # Sort #2 by (match flag | owner | diag+offset, rpos): key2 < 2^31 and
    # rpos is 23-bit, so both pack into one int64.
    diag = rpos - qpos_local + OFF
    key2 = torch.where(is_match, (owner2 << 24) | diag, 1 << 30)
    k2, _ = torch.sort((key2 << 23) | rpos)
    key2, rpos_c = k2 >> 23, k2 & M23
    if sample_shift and k <= 15:
        B2 = min(n, ((n * 5 // 8) + 1023) & ~1023)
        samp_over = samp_over | (2 * (n_raw > B2).to(torch.int64))
        key2, rpos_c = key2[:B2], rpos_c[:B2]
        n = B2
    mask_c = key2 < (1 << 30)
    owner_c = (key2 >> 24) & 3
    qpos_c = rpos_c - (key2 & (OFF * 2 - 1)) + OFF  # garbage when masked
    cidx = arange(n)

    # Masked, not assigned: storing a Python scalar into a CUDA tensor
    # waits for the host.
    prev_mask = torch.roll(mask_c, 1) & (cidx > 0)
    # Same-diagonal runs merge across ref steps of 1..merge_gap+1.
    dr_prev = rpos_c - torch.roll(rpos_c, 1)
    run_start = mask_c & (
        ~prev_mask
        | (key2 != torch.roll(key2, 1))
        | (dr_prev < 1)
        | (dr_prev > merge_gap + 1)
    )
    dr_next = torch.roll(rpos_c, -1) - rpos_c
    next_continues = (
        torch.roll(mask_c, -1)
        & (torch.roll(key2, -1) == key2)
        & (dr_next >= 1)
        & (dr_next <= merge_gap + 1)
    )
    is_run_end = mask_c & ((cidx == n - 1) | ~next_continues)
    _, rpos0 = _carry_last_marked(run_start, rpos_c)
    run_qpos = qpos_c - (rpos_c - rpos0)
    run_span = rpos_c - rpos0 + k

    n_runs = is_run_end.sum()

    # Sort #3 (compaction): run ends first, in (owner, run_rpos) order.
    key3 = torch.where(is_run_end, (owner_c << 24) | rpos0, 1 << 30)
    key3, order = torch.sort(key3, stable=True)
    take = min(max_seeds, n)
    key3_c = key3[:take]
    order = order[:take]
    return SeedMatches2(
        rpos=key3_c & (OFF * 2 - 1),
        qpos=run_qpos[order],
        length=run_span[order],
        reverse=((key3_c >> 24) & 3) == 2,
        mask=key3_c < (1 << 30),
        n_raw=n_raw,
        n_runs=n_runs,
        samp_over=samp_over,
    )


def revcomp_on_device(codes: torch.Tensor, n: int) -> torch.Tensor:
    """Reverse complement of the first ``n`` codes of a padded tensor,
    trailing padding rolled back to the end."""
    rc = torch.flip(torch.where(codes >= 4, codes, 3 - codes), (0,))
    return torch.roll(rc, n - codes.shape[0])


def seed_cluster_both_packed(
    ref_codes: torch.Tensor,
    query_codes: torch.Tensor,
    q_len: int,
    *,
    k: int = 15,
    max_seeds: int = 1 << 16,
    unique_in_query: bool = False,
    min_match: int = 20,
    band: int = 16,
    max_gap: int = 90,
    max_clusters: int = 4096,
    sample_shift: int = 0,
    merge_gap: int | None = None,
    m_out: int | None = None,
    c_out: int | None = None,
) -> torch.Tensor:
    """Seeding + both-strand clustering, every output packed into one
    int32 vector in the reference's layout (unpack with
    `unpack_seed_clusters`):

        [M, C, m_compute, n_raw, n_runs, samp_over]
        then per strand (forward, reverse):
          seed_rpos[M], seed_qpos[M], seed_len[M],
          c_first[C], c_rstart[C], c_rend[C], c_qstart[C], c_qend[C],
          c_weight[C], c_nseeds[C], c_mask[C], n_clusters[1], n_valid[1]
    """
    seeds = find_seeds_both(
        ref_codes, query_codes, q_len,
        k=k, max_seeds=max_seeds, unique_in_query=unique_in_query,
        sample_shift=sample_shift, merge_gap=merge_gap,
    )
    return _cluster_packed(
        seeds, min_match=min_match, band=band, max_gap=max_gap,
        max_clusters=max_clusters, m_out=m_out, c_out=c_out,
    )


def seed_cluster_both_packed_batch(
    ref_codes: torch.Tensor,
    query_codes: torch.Tensor,
    q_len: torch.Tensor,
    *,
    k: int = 15,
    max_seeds: int = 1 << 16,
    unique_in_query: bool = False,
    min_match: int = 20,
    band: int = 16,
    max_gap: int = 90,
    max_clusters: int = 4096,
    sample_shift: int = 0,
    merge_gap: int | None = None,
    compact_slice: bool | None = None,
    m_out: int | None = None,
    c_out: int | None = None,
) -> torch.Tensor:
    """`seed_cluster_both_packed` over a batch of pairs of one bucket
    shape: ``[B, N_r]`` / ``[B, N_q]`` codes and the rows' query lengths
    ``[B]`` -> packed int32 ``[B, L]``, row i being row i's own packed
    vector.  ``compact_slice`` picks between two forms of the reference's
    that give the same output; it is accepted and ignored."""
    del compact_slice
    return torch.stack(
        [
            seed_cluster_both_packed(
                ref_codes[i], query_codes[i], q_len[i],
                k=k, max_seeds=max_seeds, unique_in_query=unique_in_query,
                min_match=min_match, band=band, max_gap=max_gap,
                max_clusters=max_clusters, sample_shift=sample_shift,
                merge_gap=merge_gap, m_out=m_out, c_out=c_out,
            )
            for i in range(ref_codes.shape[0])
        ]
    )


def _cluster_packed(
    seeds: SeedMatches2,
    *,
    min_match: int,
    band: int,
    max_gap: int,
    max_clusters: int,
    m_out: int | None = None,
    c_out: int | None = None,
) -> torch.Tensor:
    """Cluster each strand's seeds (``reverse`` False, then True) and pack
    every output into one int32 vector (`seed_cluster_both_packed`'s
    layout), the seeds cut to `m_out` and the summaries to `c_out`."""
    from paramugsy_tpu_torch.ops.chaining import cluster_seeds

    base_keep = seeds.mask & (seeds.length >= min_match)
    m_eff = seeds.rpos.shape[0]
    c_eff = min(max_clusters, m_eff)
    m_o = m_eff if m_out is None else min(m_out, m_eff)
    c_o = c_eff if c_out is None else min(c_out, c_eff)
    dev = seeds.rpos.device
    # Filled on the device, not copied from the host: a host-to-device copy
    # would wait for the work already queued.
    parts = [
        *(torch.full((1,), v, dtype=torch.int64, device=dev) for v in (m_o, c_o, m_eff)),
        seeds.n_raw[None],
        seeds.n_runs[None],
        seeds.samp_over[None],
    ]
    for reverse in (False, True):
        keep = base_keep & (seeds.reverse == reverse)
        cl = cluster_seeds(
            seeds.rpos, seeds.qpos, seeds.length, keep,
            band=band, max_gap=max_gap, max_clusters=max_clusters,
        )
        parts.extend(
            [x[:m_o] for x in (cl.seed_rpos, cl.seed_qpos, cl.seed_len)]
            + [
                x[:c_o]
                for x in (
                    cl.c_first, cl.c_rstart, cl.c_rend, cl.c_qstart,
                    cl.c_qend, cl.c_weight, cl.c_nseeds, cl.c_mask,
                )
            ]
            + [cl.n_clusters[None], keep.sum()[None]]
        )
    return torch.cat([p.to(torch.int64) for p in parts]).to(torch.int32)


def find_repeat_seeds(
    ref_codes: torch.Tensor,
    ref_rc_codes: torch.Tensor,
    *,
    k: int = 16,
    max_seeds: int = 1 << 16,
) -> SeedMatches2:
    """Self-repeat seeding: adjacent occurrences of a k-mer in the sort
    over the forward + revcomp streams are paired, copy 1 always forward
    (see paramugsy_tpu.ops.seeding.find_repeat_seeds for the design).
    ``reverse`` marks inverted pairs, whose copy 2 is in revcomp-local
    coordinates.

    The reference's three sorts become stable sorts of packed int64 keys
    (the tie order of its masked slots reaches the output), and every
    roll keeps its wrap-around mask."""
    dev = ref_codes.device
    rk, rvalid = kmer_codes(ref_codes, k)
    ck, cvalid = kmer_codes(ref_rc_codes, k)
    n_f, n_c = rk.shape[0], ck.shape[0]
    n = n_f + n_c
    if max(n_f, n_c) >= 1 << 23:
        raise ValueError("sequence bucket exceeds 2^23; window the input")

    def arange(m):
        return torch.arange(m, device=dev, dtype=torch.int64)

    # Sort #1 over (invalid, code, owner|pos): 1 + 32 + 24 bits.  Every
    # key is distinct, so the order is the reference's.
    packed = torch.cat([arange(n_f), (1 << 23) | arange(n_c)])
    invalid = torch.cat([~rvalid, ~cvalid]).to(torch.int64)
    key, _ = torch.sort((invalid << 56) | (torch.cat([rk, ck]) << 24) | packed)
    valid = (key >> 56) == 0
    codes = (key >> 24) & M32
    owner = (key >> 23) & 1
    pos = key & M23

    idx = arange(n)
    p1 = torch.roll(pos, 1)
    is_match = (
        valid
        & torch.roll(valid, 1)
        & (codes == torch.roll(codes, 1))
        & (idx > 0)
        & (torch.roll(owner, 1) == 0)  # copy 1 always forward
    )
    n_raw = is_match.sum()

    # Sort #2 by (key2, p1), carrying pos: masked slots tie on (2^30, p1)
    # and keep their order, as XLA's sort keeps it.
    diag = p1 - pos + OFF
    key2 = torch.where(is_match, (owner << 24) | diag, 1 << 30)
    k2, order = torch.sort((key2 << 23) | p1, stable=True)
    key2, rpos_c, qpos_c = k2 >> 23, k2 & M23, pos[order]
    mask_c = key2 < (1 << 30)
    owner_c = (key2 >> 24) & 3

    next_continues = (
        torch.roll(mask_c, -1)
        & (torch.roll(key2, -1) == key2)
        & (torch.roll(qpos_c, -1) == qpos_c + 1)
    )
    prev_mask = torch.roll(mask_c, 1) & (idx > 0)
    run_start = mask_c & (
        ~prev_mask
        | (key2 != torch.roll(key2, 1))
        | (qpos_c != torch.roll(qpos_c, 1) + 1)
    )
    is_run_end = mask_c & ((idx == n - 1) | ~next_continues)
    # -1 before the first run start, as the reference's cummax leaves it.
    run_start_idx = torch.cummax(torch.where(run_start, idx, -1), 0).values
    run_len_kmers = idx - run_start_idx + 1
    run_rpos = rpos_c - run_len_kmers + 1
    run_qpos = qpos_c - run_len_kmers + 1
    n_runs = is_run_end.sum()

    # Sort #3 (compaction), stable on key3 alone.
    key3 = torch.where(is_run_end, (owner_c << 24) | run_rpos, 1 << 30)
    key3, order = torch.sort(key3, stable=True)
    take = min(max_seeds, n)
    key3_c = key3[:take]
    order = order[:take]
    return SeedMatches2(
        rpos=key3_c & (OFF * 2 - 1),
        qpos=run_qpos[order],
        length=run_len_kmers[order] + (k - 1),
        reverse=((key3_c >> 24) & 3) == 1,
        mask=key3_c < (1 << 30),
        n_raw=n_raw,
        n_runs=n_runs,
        samp_over=torch.zeros((), dtype=torch.int64, device=dev),
    )


def repeat_cluster_packed(
    ref_codes: torch.Tensor,
    r_len: int,
    *,
    k: int = 16,
    max_seeds: int = 1 << 16,
    min_match: int = 20,
    band: int = 16,
    max_gap: int = 90,
    max_clusters: int = 4096,
) -> torch.Tensor:
    """Self-repeat seeding + per-type clustering, packed in the layout of
    `seed_cluster_both_packed` with strand slot 0 = direct and 1 =
    inverted (unpack with `unpack_seed_clusters`).  The revcomp stream is
    made on the device from the first `r_len` codes of the padded
    `ref_codes`."""
    seeds = find_repeat_seeds(
        ref_codes, revcomp_on_device(ref_codes, r_len), k=k, max_seeds=max_seeds
    )
    return _cluster_packed(
        seeds, min_match=min_match, band=band, max_gap=max_gap, max_clusters=max_clusters
    )


class HostClusters(NamedTuple):
    """Host-side unpacked per-strand clustering results (NumPy arrays;
    copied from paramugsy_tpu.ops.seeding)."""

    seed_rpos: "object"
    seed_qpos: "object"
    seed_len: "object"
    c_first: "object"
    c_rstart: "object"
    c_rend: "object"
    c_qstart: "object"
    c_qend: "object"
    c_weight: "object"
    c_nseeds: "object"
    c_mask: "object"
    n_clusters: int
    n_valid: int  # valid (min_match-filtered) seeds of this strand

    @property
    def truncated(self) -> bool:
        """Did the m_out/c_out output slice cut off valid data?"""
        return (
            self.n_valid > len(self.seed_rpos)
            or self.n_clusters > len(self.c_first)
        )


def unpack_seed_clusters(packed, max_seeds: int, max_clusters: int):
    """Split `seed_cluster_both_packed` output:
    (n_raw, n_runs, samp_over, m_compute, [fwd, rev]) (copied from
    paramugsy_tpu.ops.seeding)."""
    buf = np.asarray(packed)
    M, C, m_compute = int(buf[0]), int(buf[1]), int(buf[2])
    assert M <= max_seeds and C <= max_clusters
    n_raw, n_runs, samp_over = int(buf[3]), int(buf[4]), int(buf[5])
    off = 6
    strands = []
    for _ in range(2):
        fields = []
        for size in (M, M, M, C, C, C, C, C, C, C, C):
            fields.append(buf[off : off + size])
            off += size
        n_clusters = int(buf[off])
        n_valid = int(buf[off + 1])
        off += 2
        fields[10] = fields[10] != 0  # c_mask back to bool
        strands.append(HostClusters(*fields, n_clusters, n_valid))
    return n_raw, n_runs, samp_over, m_compute, strands
