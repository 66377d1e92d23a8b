"""Anchor clustering + chaining (counterpart of paramugsy_tpu.ops.chaining).

`cluster_seeds` runs on the seeds' device as torch ops; `chain_clusters`
is the reference's host code, copied because its module imports JAX.
Sorts are stable, as the reference's sorts are on the CPU, so even the
values in masked slots (which reach the packed output) agree bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

BIG = 2**31 - 1


class Clusters(NamedTuple):
    """Per-seed sorted seeds + per-cluster summaries (device tensors)."""

    seed_rpos: torch.Tensor
    seed_qpos: torch.Tensor
    seed_len: torch.Tensor
    c_rstart: torch.Tensor
    c_rend: torch.Tensor
    c_qstart: torch.Tensor
    c_qend: torch.Tensor
    c_weight: torch.Tensor
    c_nseeds: torch.Tensor
    c_first: torch.Tensor
    c_mask: torch.Tensor
    n_clusters: torch.Tensor


def _seg_sum(cum, lo, hi):
    lo_v = torch.where(lo > 0, cum[torch.clamp(lo - 1, min=0)], 0)
    return cum[hi] - lo_v


def cluster_seeds(
    rpos: torch.Tensor,
    qpos: torch.Tensor,
    length: torch.Tensor,
    mask: torch.Tensor,
    *,
    band: int = 16,
    max_gap: int = 90,
    max_clusters: int = 4096,
) -> Clusters:
    """Group seeds (int64 tensors holding int32 values) into
    near-collinear clusters: runs of the (band, qpos) order split where
    the query gap exceeds `max_gap` or the ref position stops rising."""
    m = rpos.shape[0]
    dev = rpos.device
    diag = rpos - qpos
    band_id = torch.where(mask, torch.div(diag, band, rounding_mode="floor"), BIG)

    # Sort by (band, qpos), invalid seeds last, as one int64 key: valid
    # band ids lie in (-2^24, 2^24) (positions are 23-bit), so they offset
    # below the 2^26 sentinel; qpos is an int32 value offset to unsigned.
    bkey = torch.where(mask, band_id + (1 << 25), 1 << 26)
    _, order = torch.sort((bkey << 32) | (qpos + 2**31), stable=True)
    band_id, qpos, rpos, length, mask = (
        band_id[order], qpos[order], rpos[order], length[order], mask[order]
    )

    idx = torch.arange(m, device=dev)
    new_cluster = mask & (
        (idx == 0)
        | (band_id != torch.roll(band_id, 1))
        | (qpos - torch.roll(qpos + length, 1) > max_gap)
        | (rpos <= torch.roll(rpos, 1))  # enforce monotonicity in ref
    )
    start_idx = torch.cummax(torch.where(new_cluster, idx, -1), 0).values
    cum_w = torch.cumsum(torch.where(mask, length, 0), 0)
    cum_n = torch.cumsum(mask.to(torch.int64), 0)
    is_end = mask & (
        (idx == m - 1) | torch.roll(new_cluster, -1) | ~torch.roll(mask, -1)
    )
    w = _seg_sum(cum_w, start_idx, idx)
    nseeds = _seg_sum(cum_n, start_idx, idx)
    first = torch.clamp(start_idx, min=0)
    rstart = rpos[first]
    qstart = qpos[first]
    rend = rpos + length - 1
    qend = qpos + length - 1

    # Compact summaries to [max_clusters]: cluster ends first, in index order.
    _, order = torch.sort(torch.where(is_end, 0, 1), stable=True)
    take = min(max_clusters, m)
    cut = lambda x: x[order[:take]]  # noqa: E731
    return Clusters(
        seed_rpos=rpos,
        seed_qpos=qpos,
        seed_len=length,
        c_rstart=cut(rstart),
        c_rend=cut(rend),
        c_qstart=cut(qstart),
        c_qend=cut(qend),
        c_weight=cut(w),
        c_nseeds=cut(nseeds),
        c_first=cut(first),
        c_mask=cut(is_end),
        n_clusters=is_end.sum(),
    )


def chain_clusters(
    c_rstart: np.ndarray,
    c_rend: np.ndarray,
    c_qstart: np.ndarray,
    c_qend: np.ndarray,
    c_weight: np.ndarray,
    *,
    max_join_gap: int = 200,
    max_join_diagdiff: int = 500,
    min_chain_weight: int = 65,
) -> list[list[int]]:
    """Exact O(C^2) chaining of cluster summaries (host; copied from
    paramugsy_tpu.ops.chaining).  Returns chains as lists of cluster
    indices, ordered along the ref."""
    C = len(c_rstart)
    if C == 0:
        return []
    order = np.lexsort((c_qstart, c_rstart))
    rs, re_, qs, qe, w = (
        c_rstart[order].astype(np.int64),
        c_rend[order].astype(np.int64),
        c_qstart[order].astype(np.int64),
        c_qend[order].astype(np.int64),
        c_weight[order].astype(np.int64),
    )
    from paramugsy_tpu_torch.ops.native import chain_clusters_native

    nat = chain_clusters_native(
        rs, re_, qs, qe, w, max_join_gap, max_join_diagdiff
    )
    if nat is not None:
        score, parent = nat
    else:
        score = w.copy()
        parent = np.full(C, -1, dtype=np.int64)
        for i in range(1, C):
            gap_r = rs[i] - re_[:i]
            gap_q = qs[i] - qe[:i]
            dd = np.abs(gap_r - gap_q)
            valid = (
                (re_[:i] < rs[i])
                & (qe[:i] < qs[i])
                & (np.maximum(gap_r, gap_q) <= max_join_gap)
                & (dd <= max_join_diagdiff)
            )
            if valid.any():
                cand = np.where(valid, score[:i] - dd, np.int64(-(10**12)))
                j = int(np.argmax(cand))
                if cand[j] > 0:
                    score[i] = w[i] + cand[j]
                    parent[i] = j

    used = np.zeros(C, dtype=bool)
    chains: list[list[int]] = []
    for i in np.argsort(-score):
        if used[i] or score[i] < min_chain_weight:
            continue
        chain = []
        j = int(i)
        while j != -1 and not used[j]:  # truncate at already-claimed clusters
            chain.append(j)
            j = int(parent[j])
        if not chain or w[chain].sum() < min_chain_weight:
            continue
        for j in chain:
            used[j] = True
        chains.append([int(order[j]) for j in reversed(chain)])
    return chains
