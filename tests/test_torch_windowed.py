"""The port's windowed pair path, `align_pairs_batch` and
`genome_pair_deltas_batch` against paramugsy_tpu on the CPU.

Contigs longer than ``cfg.window`` are cut into a grid of overlapping
window pairs that run through `align_pairs_batch`; the pieces are
deduplicated by midpoint and fused back.  The same numpy-seeded inputs go
through both packages (the reference under JAX_PLATFORMS=cpu, the port on
``device="cpu"``); entry lists must give the same delta text, and MAF
files must be byte-identical.
"""
import json

import numpy as np
import pytest
import torch

import chip_smoke
from bench import build_family, build_pair
from paramugsy_tpu import cli as ref_cli
from paramugsy_tpu import pipeline as ref_pipe
from paramugsy_tpu.coords.range import Range as RefRange
from paramugsy_tpu.formats.delta import DeltaEntry as RefEntry
from paramugsy_tpu.ops import align_pair as ref_ap
from paramugsy_tpu_torch import cli as port_cli
from paramugsy_tpu_torch import convert
from paramugsy_tpu_torch import pipeline as port_pipe
from paramugsy_tpu_torch.coords.range import Range
from paramugsy_tpu_torch.formats.delta import DeltaEntry
from paramugsy_tpu_torch.ops import align_pair as port_ap
from paramugsy_tpu_torch.ops import engines as port_engines

torch.set_num_threads(1)
WINDOW = dict(window=1 << 14, window_overlap=1 << 12)


def _text(entries) -> str:
    return port_cli.delta_text(entries)


def _indel_inversion_pair():
    """tests/test_ops.py's windowed pair: 60 kb, 1% substitutions, a 20 bp
    deletion and a 6 kb inversion (both strands)."""
    rng = np.random.default_rng(4)
    n = 60000
    ref = rng.integers(0, 4, size=n).astype(np.int8)
    q = ref.copy()
    m = rng.random(n) < 0.01
    q[m] = ((q[m] + 1) % 4).astype(np.int8)
    q = np.concatenate([q[:20000], q[20020:]])
    a, b = 35000, 41000
    q = np.concatenate([q[:a], (3 - q[a:b])[::-1], q[b:]])
    return ref, q


def _snp_pair():
    """tests/test_ops.py's SNP-only 60 kb pair: one alignment across four
    window boundaries."""
    rng = np.random.default_rng(9)
    n = 60000
    ref = rng.integers(0, 4, size=n).astype(np.int8)
    q = ref.copy()
    m = rng.random(n) < 0.01
    q[m] = ((q[m] + 1) % 4).astype(np.int8)
    return ref, q


@pytest.mark.parametrize(
    "pair, post_filter",
    [("indel_inversion", None), ("indel_inversion", "one_to_one"),
     ("indel_inversion", "colinear"), ("snp", None)],
)
def test_windowed_align_pair_equals_reference(pair, post_filter):
    ref, q = _indel_inversion_pair() if pair == "indel_inversion" else _snp_pair()
    cfg = ref_ap.AlignConfig(post_filter=post_filter, **WINDOW)
    want = ref_ap.align_pair(ref, q, "R.c", "Q.c", cfg)
    port_engines.reset_counts()
    got = port_ap.align_pair(ref, q, "R.c", "Q.c", convert.align_config(cfg), device="cpu")
    assert want and _text(got) == _text(want)
    # 5 x 5 window pairs, each seeded once on the device (no overflow here).
    assert port_engines.COUNTS["seedcluster-cpu"] == 25
    if pair == "snp":
        assert len(got) == 1 and got[0].ref_range.start <= 20
        assert got[0].ref_range.end >= len(ref) - 20
    elif post_filter is None:
        assert {e.query_range.is_forward for e in got} == {True, False}


@pytest.mark.parametrize("n", [1, 12287, 12288, 12289, 16384, 60000, 100003])
def test_windows_and_jobs_equal_reference(n):
    cfg = ref_ap.AlignConfig(**WINDOW)
    port_cfg = convert.align_config(cfg)
    assert port_ap._windows(n, port_cfg) == ref_ap._windows(n, cfg)
    codes = np.random.default_rng(n).integers(0, 4, n).astype(np.int8)
    want_jobs, want_meta = ref_ap.window_pair_jobs(codes, codes[: n // 2 + 1], "a", "b", cfg)
    got_jobs, got_meta = port_ap.window_pair_jobs(codes, codes[: n // 2 + 1], "a", "b", port_cfg)
    assert got_meta == want_meta
    assert [(len(r), len(q), rn, qn) for r, q, rn, qn in got_jobs] == [
        (len(r), len(q), rn, qn) for r, q, rn, qn in want_jobs
    ]
    sub = port_ap.windowed_sub_config(port_cfg)
    assert sub.window == 1 << 62 and sub.post_filter is None and port_cfg.window == 1 << 14


def test_assemble_windowed_midpoint_rule_equals_reference():
    """Entries whose midpoints sit one below, on and one above each core
    boundary: each must be kept by exactly the window pair whose cores
    hold both midpoints (cores are 0-based [c0, c1), midpoints
    1-indexed), as the reference keeps it."""
    n = 40000
    cfg = ref_ap.AlignConfig(**WINDOW)
    port_cfg = convert.align_config(cfg)
    rng = np.random.default_rng(5)
    ref = rng.integers(0, 4, n).astype(np.int8)
    query = rng.integers(0, 4, n).astype(np.int8)
    _, meta = ref_ap.window_pair_jobs(ref, query, "R.c", "Q.c", cfg)
    want_in, got_in = [], []
    for rw0, rc0, rc1, qw0, qc0, qc1 in meta:
        ref_es, port_es = [], []
        for d in (-1, 0, 1):
            # A 101-column ungapped piece, its ref midpoint at rc1 + d and
            # its query midpoint at qc0 + 1 + d (window-local coordinates).
            rs = rc1 + d - 50 - rw0
            qs = qc0 + 1 + d - 50 - qw0
            if rs < 1 or qs < 1:
                continue
            fields = ("r", "q", n, n)
            ref_es.append(RefEntry(*fields, RefRange(rs, rs + 100), RefRange(qs, qs + 100), [], []))
            port_es.append(DeltaEntry(*fields, Range(rs, rs + 100), Range(qs, qs + 100), [], []))
        want_in.append(ref_es)
        got_in.append(port_es)
    want = ref_ap.assemble_windowed(want_in, meta, ref, query, "R.c", "Q.c", cfg)
    got = port_ap.assemble_windowed(
        got_in, meta, ref, query, "R.c", "Q.c", port_cfg, device=torch.device("cpu")
    )
    assert want and _text(got) == _text(want)
    # Each (ref, query) locus is reported once.
    spans = [(e.ref_range, e.query_range) for e in got]
    assert len(spans) == len(set(spans))


def _batch_jobs(case: str):
    """(jobs, cfg) covering the routing rules of the reference's batch
    path (bucket groups, its single-pair path for the rest)."""
    rng = np.random.default_rng(17)
    if case == "groups":
        jobs = []
        for t in range(3):  # bucket pair (16384, 16384): a group of 3
            ref, q = build_pair(rng, 15_000)
            jobs.append((ref, q, f"a{t}", f"b{t}"))
        for t in range(2):  # (8192, 16384): a group of 2
            ref, q = build_pair(rng, 15_000)
            jobs.append((ref[5000:11000], q, f"c{t}", f"d{t}"))
        ref, q = build_pair(rng, 3000)  # (4096, 4096): a group of one
        jobs.append((ref, q, "e", "f"))
        ref, q = build_pair(rng, 40_000)  # longer than the window
        jobs.append((ref, q, "g", "h"))
        return jobs, ref_ap.AlignConfig(**WINDOW)
    # "overflow": four jobs of one bucket pair; the two similar ones have
    # more merged runs than a 64-seed bucket, so the reference retries them
    # on its single path.
    jobs = []
    for t in range(2):
        ref, q = build_pair(rng, 12_000)
        jobs.append((ref, q, f"s{t}", f"t{t}"))
        other = rng.integers(0, 4, 12_000).astype(np.int8)
        other[3000:4500] = ref[3000:4500]
        jobs.append((ref, other, f"u{t}", f"v{t}"))
    return jobs, ref_ap.AlignConfig(max_seeds=1 << 6)


@pytest.mark.parametrize("case", ["groups", "overflow"])
def test_align_pairs_batch_equals_reference(case):
    jobs, cfg = _batch_jobs(case)
    want = ref_ap.align_pairs_batch(jobs, cfg)
    port_engines.reset_counts()
    got = port_ap.align_pairs_batch(jobs, convert.align_config(cfg), device="cpu")
    assert len(got) == len(want) == len(jobs)
    for g, w in zip(got, want):
        assert _text(g) == _text(w)
    assert all(want)
    seeded = port_engines.COUNTS["seedcluster-cpu"]
    if case == "groups":
        # One dispatch per job, and the long job's 4 x 4 window grid: 22,
        # no overflow.
        assert seeded == 22
    else:
        # The similar jobs' retry ladders seed again.
        assert seeded > len(jobs)


def test_genome_pair_deltas_batch_equals_reference():
    """Three two-contig genomes, all three pairs in one chunk."""
    fams = build_family(np.random.default_rng(21), 22_000, count=3)
    ref_gs, port_gs = [], []
    for g in fams:
        (name, seq), = g.seqs.items()
        seqs = {f"{name}.1": seq[:7000], f"{name}.2": seq[7000:]}
        ref_gs.append(ref_pipe.Genome(name=g.name, seqs=seqs))
        port_gs.append(port_pipe.Genome(name=g.name, seqs=seqs))
    pairs = [(0, 1), (0, 2), (1, 2)]
    cfg = ref_ap.AlignConfig()
    want = ref_pipe.genome_pair_deltas_batch([(ref_gs[a], ref_gs[b]) for a, b in pairs], cfg)
    got = port_pipe.genome_pair_deltas_batch(
        [(port_gs[a], port_gs[b]) for a, b in pairs], convert.align_config(cfg),
        device=torch.device("cpu"),
    )
    assert [_text(g) for g in got] == [_text(w) for w in want]
    assert all(want)


def test_cli_align_sequential_windowed_config_equals_reference(tmp_path):
    paths = chip_smoke.family_fastas(str(tmp_path), 60_000, 3, seed=5)
    (tmp_path / "c.json").write_text(
        json.dumps({"align": {"window": 16384, "window_overlap": 4096}})
    )
    cfg = ["-config", str(tmp_path / "c.json")]
    assert ref_cli._align_main(
        ["-sequential", *paths, "-out_maf", str(tmp_path / "ref.maf"), *cfg]
    ) == 0
    port_engines.reset_counts()
    assert port_cli.main(
        ["align", "-sequential", *paths, "-out_maf", str(tmp_path / "port.maf"), *cfg,
         "-device", "cpu"]
    ) == 0
    text = (tmp_path / "port.maf").read_bytes()
    assert text == (tmp_path / "ref.maf").read_bytes()
    assert text.count(b"\na ") >= 1
    # Two pairwise steps of 5 x 5 window pairs each.
    assert port_engines.COUNTS["seedcluster-cpu"] >= 50
