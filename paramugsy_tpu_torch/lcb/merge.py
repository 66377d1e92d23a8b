"""Profile merge of two alignment levels (counterpart of
paramugsy_tpu.lcb.merge).

`bridge_adjacent` and `merge_blocks` are copied so that their gap
alignments run on the port's segment engines (`align_segments(...,
device=)`) and refinement on the port's `refine_blocks`; the reference's
copies import its JAX encoder and engine selection.  Everything else
(profiles, translation, LCB selection, untranslation) is host code
imported from the reference, whose modules import no JAX.
"""
from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

from paramugsy_tpu.coords.range import FORWARD, Range
from paramugsy_tpu.formats.delta import DeltaEntry
from paramugsy_tpu.formats.delta_maf import delta_to_maf_blocks
from paramugsy_tpu.formats.maf import MafBlock, MafSequence
from paramugsy_tpu.lcb.merge import (
    _fuse_pair,
    _Occupancy,
    make_profiles_mem,
    select_consistent,
)
from paramugsy_tpu.profiles.native_translate import translate_deltas_fast
from paramugsy_tpu.profiles.untranslate import untranslate_blocks
from paramugsy_tpu.utils.obs import METRICS
from paramugsy_tpu_torch.lcb.refine import refine_blocks
from paramugsy_tpu_torch.ops.encode import encode, revcomp_codes_np
from paramugsy_tpu_torch.ops.extend import align_segments


def bridge_adjacent(
    kept: list[DeltaEntry],
    occ: _Occupancy,
    lcons: dict[str, str],
    rcons: dict[str, str],
    max_gap: int = 1000,
    *,
    device: torch.device,
) -> list[DeltaEntry]:
    """Fuse kept collinear neighbours by aligning the gap between them
    against the consensus texts (all gaps in one `align_segments` batch)."""
    by_key: dict[tuple, list[DeltaEntry]] = {}
    for e in kept:
        key = (e.ref_name, e.query_name, e.query_range.is_forward)
        by_key.setdefault(key, []).append(e)
    out: list[DeltaEntry] = []
    plans = []  # (group, [(gap index, seg index)])
    seg_reqs: list[tuple[np.ndarray, np.ndarray]] = []

    for (rn, qn, forward), group in by_key.items():
        rtext = lcons.get(rn)
        qtext = rcons.get(qn)
        group.sort(key=lambda e: e.ref_range.abs().start)
        if rtext is None or qtext is None or not group[0].ref_range.is_forward:
            out.extend(group)
            continue
        fuses = []
        for i in range(len(group) - 1):
            a, b = group[i], group[i + 1]
            gr0, gr1 = a.ref_range.end + 1, b.ref_range.start - 1
            gap_r = gr1 - gr0 + 1
            if forward:
                gq0, gq1 = a.query_range.end + 1, b.query_range.start - 1
            else:
                gq0, gq1 = b.query_range.start + 1, a.query_range.end - 1
            gap_q = gq1 - gq0 + 1
            if not (0 <= gap_r <= max_gap and 0 <= gap_q <= max_gap):
                continue
            if gap_r and not occ.free(rn, Range(gr0, gr1)):
                continue
            if gap_q and not occ.free(qn, Range(gq0, gq1)):
                continue
            if gap_r:
                occ.claim(rn, Range(gr0, gr1))
            if gap_q:
                occ.claim(qn, Range(gq0, gq1))
            r_codes = encode(rtext[gr0 - 1 : gr1])
            q_codes = encode(qtext[gq0 - 1 : gq1])
            if not forward:
                q_codes = revcomp_codes_np(q_codes)
            fuses.append((i, len(seg_reqs)))
            seg_reqs.append((r_codes, q_codes))
        plans.append((group, fuses))
    seg_results = align_segments(seg_reqs, device=device)
    for group, fuses in plans:
        fused: list[DeltaEntry] = []
        cur = group[0]
        by_i = dict(fuses)
        for i in range(1, len(group)):
            t = by_i.get(i - 1)
            if t is not None:
                rg, qg, ncols = seg_results[t]
                cur = _fuse_pair(cur, group[i], rg, qg, ncols)
            else:
                fused.append(cur)
                cur = group[i]
        fused.append(cur)
        out.extend(fused)
    return out


def merge_blocks(
    left_blocks: Sequence[MafBlock],
    right_blocks: Sequence[MafBlock],
    genome_deltas: Iterable[DeltaEntry],
    *,
    basename_left: str = "l",
    basename_right: str = "r",
    min_length: int = 30,
    emit_unique: bool = True,
    refine: bool = False,
    refine_max_cols: int = 50_000,
    chain_gap: int = 1000,
    device: torch.device,
) -> list[MafBlock]:
    """Merge two alignment levels through genome-space pairwise deltas."""
    with METRICS.phase("merge.profiles", items=len(left_blocks) + len(right_blocks)):
        lps, lcons = make_profiles_mem(left_blocks, basename_left)
        rps, rcons = make_profiles_mem(right_blocks, basename_right)

    with METRICS.phase("merge.translate"):
        translated = list(translate_deltas_fast(lps, rps, genome_deltas))
    with METRICS.phase("merge.select", items=len(translated)):
        kept, occ = select_consistent(
            translated, min_length=min_length, chain_gap=chain_gap
        )
    with METRICS.phase("merge.bridge", items=len(kept)):
        kept = bridge_adjacent(kept, occ, lcons, rcons, max_gap=chain_gap, device=device)

    with METRICS.phase("merge.emit"):
        out = list(delta_to_maf_blocks(kept, lcons, rcons))
        if emit_unique:
            for cons in (lcons, rcons):
                for major, text in cons.items():
                    for s, e in occ.uncovered(major, len(text)):
                        out.append(
                            MafBlock(
                                seqs=[
                                    MafSequence(
                                        name=major,
                                        start=s - 1,
                                        size=e - s + 1,
                                        strand=FORWARD,
                                        src_size=len(text),
                                        text=text[s - 1 : e],
                                    )
                                ],
                                score=0,
                                attrs={"label": "1", "mult": "1"},
                            )
                        )

    with METRICS.phase("merge.untranslate", items=len(out)):
        merged = list(untranslate_blocks(lps + rps, out))
    if refine:
        with METRICS.phase("merge.refine", items=len(merged)):
            refine_blocks(merged, max_cols=refine_max_cols, device=device)
    for b in merged:
        b.attrs["mult"] = str(len(b.seqs))
        b.score = max(len(s.text) for s in b.seqs) if b.seqs else 0
    return merged
