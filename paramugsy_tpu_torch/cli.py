"""Command-line entry of the port (counterpart of paramugsy_tpu.cli).

Only the pairwise subcommand is ported so far:

    python -m paramugsy_tpu_torch.cli nucmer -ref_seq a.fa -query_seq b.fa \\
        -out_delta o.delta [-out_maf o.maf] [-device cuda|cpu]

Its flags and output are the reference's ``nucmer``; ``-device`` picks
the torch device (``cuda`` by default; ``cpu`` runs the plain versions of
the kernels).
"""
from __future__ import annotations

import io
import sys


def delta_text(entries, ref_path: str = "/dev/null", query_path: str = "/dev/null") -> str:
    """Entries as the text of a delta file (the nucmer output format)."""
    from paramugsy_tpu.formats.delta import DeltaWriter

    buf = io.StringIO()
    w = DeltaWriter(buf, ref_path, query_path)
    for e in entries:
        w.write(e)
    return buf.getvalue()


def _nucmer_main(argv: list[str]) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="paramugsy_tpu_torch nucmer")
    ap.add_argument("-ref_seq", required=True)
    ap.add_argument("-query_seq", required=True)
    ap.add_argument("-out_delta")
    ap.add_argument("-out_maf")
    ap.add_argument("-minlength", type=int, default=20)
    ap.add_argument("-one_to_one", action="store_true", help="delta-filter -1 role")
    ap.add_argument(
        "-colinear", action="store_true",
        help="keep a single colinear chain (delta-filter -m role)",
    )
    ap.add_argument("-device", default="cuda", help="torch device: cuda or cpu")
    args = ap.parse_args(argv)

    from paramugsy_tpu.formats.delta_maf import delta_to_maf_blocks
    from paramugsy_tpu.formats.maf import write_maf
    from paramugsy_tpu_torch.ops.align_pair import (
        AlignConfig,
        align_pair,
        filter_colinear,
        filter_one_to_one,
    )
    from paramugsy_tpu_torch.pipeline import load_genome
    from paramugsy_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    ref = load_genome(args.ref_seq)
    query = load_genome(args.query_seq)
    cfg = AlignConfig(min_match=args.minlength)
    entries = []
    for rn, rs in ref.seqs.items():
        for qn, qs in query.seqs.items():
            entries.extend(align_pair(rs, qs, rn, qn, cfg, device=device))
    if args.colinear:
        entries = filter_colinear(entries)
    elif args.one_to_one:
        entries = filter_one_to_one(entries)
    if args.out_delta:
        with open(args.out_delta, "w") as f:
            f.write(delta_text(entries, args.ref_seq, args.query_seq))
    if args.out_maf:
        write_maf(
            args.out_maf,
            delta_to_maf_blocks(entries, dict(ref.seqs), dict(query.seqs)),
        )
    print(f"{len(entries)} alignments", file=sys.stderr)
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "nucmer":
        return _nucmer_main(argv[1:])
    print(
        "usage: python -m paramugsy_tpu_torch.cli nucmer ... (the other "
        "subcommands are not ported yet; see ROADMAP.md queue A)",
        file=sys.stderr,
    )
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
