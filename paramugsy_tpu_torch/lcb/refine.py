"""Per-block MSA refinement, the mugsyWGA ``--refine`` role (counterpart of
paramugsy_tpu.lcb.refine, copied: the reference module imports JAX
through its encoder).

For each row of a block: remove it, collapse the columns of the remaining
rows, and globally re-align the row against the column consensus with the
port's segment engines (`ops.extend.align_segments` on `device`: native
NW up to 4096 bp, the wavefront kernels past that on CUDA).  The new
arrangement is kept only when it improves the sum-of-pairs score.
Refinement only moves gaps: every row's ungapped text, and so every
coordinate, is preserved.
"""
from __future__ import annotations

import numpy as np
import torch

from paramugsy_tpu_torch.formats.maf import MafBlock
from paramugsy_tpu_torch.ops.extend import Scoring, align_segments

GAP_CODE = 5  # A,C,G,T=0..3, N=4, '-'=5 in the column matrices below

_ENC_GAP = np.full(256, 4, dtype=np.int8)
for _i, _b in enumerate(b"ACGT"):
    _ENC_GAP[_b] = _i
    _ENC_GAP[_b + 32] = _i
_ENC_GAP[ord("-")] = GAP_CODE

_DEC_GAP = np.frombuffer(b"ACGTN-", dtype=np.uint8)


def rows_matrix(texts: list[str]) -> np.ndarray:
    """Gapped row texts -> [R, C] int8 codes (gap = GAP_CODE)."""
    if not texts:
        return np.zeros((0, 0), dtype=np.int8)
    buf = np.frombuffer("".join(texts).encode(), dtype=np.uint8)
    return _ENC_GAP[buf].reshape(len(texts), len(texts[0]))


def matrix_rows(m: np.ndarray) -> list[str]:
    return [_DEC_GAP[r].tobytes().decode() for r in m]


def sp_score(m: np.ndarray, scoring: Scoring = Scoring()) -> int:
    """Sum-of-pairs score of a column matrix: equal residues -> match,
    differing residues -> mismatch, residue/gap -> gap, gap/gap -> 0."""
    if m.size == 0:
        return 0
    counts = np.zeros((GAP_CODE + 1, m.shape[1]), dtype=np.int64)
    for sym in range(GAP_CODE + 1):
        counts[sym] = (m == sym).sum(axis=0)
    res = counts[:GAP_CODE]
    n_res = res.sum(axis=0)
    match_pairs = (res * (res - 1) // 2).sum()
    total_res_pairs = (n_res * (n_res - 1) // 2).sum()
    gap_pairs = (counts[GAP_CODE] * n_res).sum()
    return int(
        scoring.match * match_pairs
        + scoring.mismatch * (total_res_pairs - match_pairs)
        + scoring.gap * gap_pairs
    )


def consensus_codes(m: np.ndarray) -> np.ndarray:
    """Majority non-gap symbol per column (ties -> smaller code)."""
    counts = np.zeros((GAP_CODE, m.shape[1]), dtype=np.int32)
    for sym in range(GAP_CODE):
        counts[sym] = (m == sym).sum(axis=0)
    return counts.argmax(axis=0).astype(np.int8)


def _drop_all_gap_cols(m: np.ndarray) -> np.ndarray:
    return m[:, (m != GAP_CODE).any(axis=0)]


def _runs_to_mask(runs, n: int) -> np.ndarray:
    """1-indexed inclusive column runs -> boolean gap mask of length n."""
    mask = np.zeros(n, dtype=bool)
    for r in runs:
        ra = r.abs()
        mask[ra.start - 1 : ra.end] = True
    return mask


def _realign_row(
    others: np.ndarray, row_codes: np.ndarray, scoring: Scoring, device: torch.device
) -> np.ndarray | None:
    """Align ``row_codes`` against the consensus of ``others``: the refit
    [R, C'] matrix (others expanded + the row last), or None when the DP
    cannot run (empty inputs)."""
    others = _drop_all_gap_cols(others)
    if others.shape[1] == 0 or row_codes.size == 0:
        return None
    cons = consensus_codes(others)
    (res,) = align_segments([(cons, row_codes)], scoring, device=device)
    ref_gaps, query_gaps, n_cols = res
    ref_gap_mask = _runs_to_mask(ref_gaps, n_cols)
    row_gap_mask = _runs_to_mask(query_gaps, n_cols)
    out = np.full((others.shape[0] + 1, n_cols), GAP_CODE, dtype=np.int8)
    out[:-1, ~ref_gap_mask] = others
    out[-1, ~row_gap_mask] = row_codes
    return out


def refine_matrix(
    m: np.ndarray,
    scoring: Scoring = Scoring(),
    rounds: int = 1,
    *,
    device: torch.device,
) -> np.ndarray:
    """Iterative remove-and-realign refinement of a column matrix."""
    m = _drop_all_gap_cols(m)
    best = sp_score(m, scoring)
    n_rows = m.shape[0]
    for _ in range(rounds):
        improved = False
        for r in range(n_rows):
            others = np.delete(m, r, axis=0)
            row_codes = m[r][m[r] != GAP_CODE]
            cand = _realign_row(others, row_codes, scoring, device)
            if cand is None:
                continue
            # Restore the original row order: the realigned row is last.
            perm = np.empty(n_rows, dtype=np.int64)
            perm[[i for i in range(n_rows) if i != r]] = np.arange(n_rows - 1)
            perm[r] = n_rows - 1
            cand = _drop_all_gap_cols(cand[perm])
            s = sp_score(cand, scoring)
            if s > best:
                m, best, improved = cand, s, True
        if not improved:
            break
    return m


def refine_block(
    block: MafBlock,
    scoring: Scoring = Scoring(),
    rounds: int = 1,
    max_cols: int = 50_000,
    *,
    device: torch.device,
) -> MafBlock:
    """Refine one MAF block in place (gaps move; coordinates never change)."""
    if len(block.seqs) < 2 or not block.seqs[0].text:
        return block
    if len(block.seqs[0].text) > max_cols:
        return block
    m = rows_matrix([s.text.upper() for s in block.seqs])
    refined = refine_matrix(m, scoring, rounds=rounds, device=device)
    if refined.shape == m.shape and np.array_equal(refined, m):
        return block
    for seq, text in zip(block.seqs, matrix_rows(refined)):
        seq.text = text
    return block


def refine_blocks(
    blocks: list[MafBlock],
    scoring: Scoring = Scoring(),
    rounds: int = 1,
    max_cols: int = 50_000,
    *,
    device: torch.device,
) -> list[MafBlock]:
    for b in blocks:
        refine_block(b, scoring, rounds=rounds, max_cols=max_cols, device=device)
    return blocks
