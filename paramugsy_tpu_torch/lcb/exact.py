"""Exact small-instance LCB selection (the optimality oracle).

`lcb.merge.select_consistent` is a greedy chain-first tiling of the
weighted non-overlap selection problem (the delta-filter / mugsyWGA LCB
role, lib/mugsy/mugsy_mugsy.ml:125-144).  This module solves the SAME
objective exactly on small instances by branch-and-bound, so the greedy's
optimality gap is *measured* instead of assumed (VERDICT r3 #7):

    maximize   sum over kept entries of alignment_length(e)
    subject to per-sequence intervals of kept entries being disjoint
               (both the ref row and the query row claim their spans).

Exponential in the worst case — intended for instances of ~<= 24 entries
(randomized audits and tests), not production selection.
"""
from __future__ import annotations

from typing import Sequence

from paramugsy_tpu_torch.formats.delta import DeltaEntry


def _spans(e: DeltaEntry) -> list[tuple[str, int, int]]:
    r, q = e.ref_range.abs(), e.query_range.abs()
    return [(e.ref_name, r.start, r.end), (e.query_name, q.start, q.end)]


def _conflicts(a: DeltaEntry, b: DeltaEntry) -> bool:
    for sa, lo_a, hi_a in _spans(a):
        for sb, lo_b, hi_b in _spans(b):
            if sa == sb and lo_a <= hi_b and lo_b <= hi_a:
                return True
    return False


def select_exact(
    entries: Sequence[DeltaEntry], min_length: int = 30
) -> tuple[list[DeltaEntry], int]:
    """Optimal non-overlapping subset; returns (kept, total_weight).

    Branch-and-bound over entries in decreasing weight order with a
    remaining-weight bound; exact for any input, practical to ~24
    entries.
    """
    usable = [
        e
        for e in entries
        if e.ref_range.length >= min_length
        and e.query_range.length >= min_length
    ]
    n = len(usable)
    if n > 26:
        raise ValueError(f"{n} entries: exact solver is for small instances")
    usable.sort(key=lambda e: -e.alignment_length())
    w = [e.alignment_length() for e in usable]
    conflict = [
        [(_conflicts(usable[i], usable[j])) for j in range(n)] for i in range(n)
    ]
    suffix = [0] * (n + 1)
    for i in range(n - 1, -1, -1):
        suffix[i] = suffix[i + 1] + w[i]

    best_w = 0
    best_set: list[int] = []

    def dfs(i: int, cur: list[int], cur_w: int) -> None:
        nonlocal best_w, best_set
        if cur_w + suffix[i] <= best_w:
            return
        if i == n:
            if cur_w > best_w:
                best_w, best_set = cur_w, list(cur)
            return
        if all(not conflict[i][j] for j in cur):
            cur.append(i)
            dfs(i + 1, cur, cur_w + w[i])
            cur.pop()
        dfs(i + 1, cur, cur_w)

    dfs(0, [], 0)
    return [usable[i] for i in best_set], best_w


def greedy_weight(entries: Sequence[DeltaEntry], min_length: int = 30) -> int:
    """Total kept weight of the production greedy on the same instance."""
    from paramugsy_tpu_torch.lcb.merge import select_consistent

    kept, _ = select_consistent(entries, min_length=min_length)
    return sum(e.alignment_length() for e in kept)
