#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paramugsy_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases; any failed check raises, so the script exits non-zero before the
result line:

1. Card and build: prints the card's name and power limit, builds the
   CUDA kernels from ``paramugsy_tpu_torch/csrc`` and, when missing, the
   native host library from ``native/``.
2. Kernels against their plain PyTorch versions, on the card: K1
   (wavefront DP) and K2 (traceback) at the long-segment engine's bench
   shape (64 pairs x 16 kb, W = 512) and at every wider band the width
   doubling reaches, W = 1024 ... 32768 (past 16384 the rows leave
   registers for device memory).  Buffers must be bit-identical; every
   pair must equal the native banded engine.
2a. K1 against its plain version: a short launch at every width of its
   register kernel (32 ... 16384), then the batch-1 refine shapes through
   K1 and K2: one pair of the median refine segment (11.75 kb a side, W =
   512), both buffers bit-identical to the plain versions', and one of the
   longest (46 kb a side, ~92 k steps) equal to the native banded engine.
   Both are timed with CUDA events: K1 in microseconds per anti-diagonal
   step, K2 in nanoseconds per move.  Then K2 on the edge batch
   (``traceback_edge_pairs``: a long DIAG run, indels in every slot of a
   word, a walk forced at both band edges, empty sides, unrelated
   sequences, a pair whose lengths do not fit) at W = 64 and 512,
   bit-identical to the plain version.
2b. K3 (``banded_dp``, one pair) and K4 (``banded_dp_batch``) against
   ``banded_dp_plain``: the edge batch (``banded_edge_pairs``) at every
   width 32 ... 32768 under two scorings (and a gap past the NEG margin
   refused with no launch counted), eight 0.6-1.3 kb pairs at each
   width not timed, then the timed shapes, one ~8 kb pair at W = 512 and
   eight pairs of 2-8 kb at W = 64, 256, 512, 1024, 4096 and 32768 (the
   widest band), one pair one base inside the band edge; dirs buffers
   must be equal.  Times are also given in us per row beside the one-SM
   bound (a pair's rows are sequential).  Then their path, the
   entry points ``banded_align`` and ``banded_align_batch`` on the same
   pairs, with the counts zeroed before and read after; every triple must
   equal the native banded engine at the same width.
3. Headline pair through the port's ``nucmer`` CLI: the 2 Mbp pair of
   ``build_pair`` (bench.py's recipe); the delta body must equal the JAX
   reference's, and the segments must have run on the native NW engine.
4. Island pair: a 2 Mbp pair with random 5 kb query windows, aligned
   with ``break_len=2048`` so that long segments reach K1 and K2; the
   entries must equal the JAX reference's.

5. The 8-genome family (``build_family``, seed 7, 8 x 2 Mbp, bench.py's
   recipe) through ``align -sequential`` twice (first, warm): the MAF must
   equal the JAX reference's sha256, and the seeding must have been
   dispatched on the card as often as the reference dispatched it.
6. The realistic fixture (``tests/data/realistic``, 5 genomes) through
   ``align -sequential -refine`` twice: the MAF must equal the reference's
   sha256, every long refine segment must have run on K1/K2 (as many as
   the reference sent to its host banded engine), and both kernels must
   have launched.
7. The windowed pair path: the 6,264,404 bp pair (``build_pair``; the
   length of P. aeruginosa PAO1's chromosome, over the 4 Mbp window)
   through the ``nucmer`` CLI twice (first, warm); the delta body must
   equal the JAX reference's, with its 2 x 2 grid of window pairs seeded
   once each (4 seeding dispatches) per run.
7b. The island pair with 1 Mbp windows through ``align_pair`` twice: the
   entries must equal the reference's, with 9 window pairs seeded and 4
   long segments on K1 and K2 per run.
8. The 4 x 2 Mbp family (seed 7) through ``align -sequential -config``
   with 1 Mbp windows twice: the MAF must equal the reference's sha256,
   with 54 window pairs seeded per run.

Launch counters are zeroed before each path (phases 3-4 together, 2b's
entry points, 5, 6, and 7-8 together) and read after it.  The script
imports only the port (``paramugsy_tpu_torch``), never JAX or the JAX
package directly.  Without
a CUDA device it exits 2.  ``python3 chip_smoke.py --wavefront`` runs
phases 1 and 2a only (a quick check after an edit of K1 or K2);
``--banded`` runs phases 1 and 2b only (after an edit of K3/K4);
``--profile`` runs phase 1 and traced runs of
phases 6, 5, 7 and 8 (device time per kernel, busy share).
None of them prints the result line.

Each kernel's ``bound_ms`` in the ``kernels`` line is the larger of its
bytes (inputs read once, output written once; for K2 only the distinct
dirs words that this run's walks read, ``k2_bound``) over 3.35 TB/s and its integer
operations over the card's 32-bit integer rate: 132 SMs x 128 lanes x
1.98 GHz = 33.5 T op/s.  Per SM and clock Hopper issues 64 lanes of
integer add, compare, select, min/max and logic on its ALU pipe and 64
more of IMAD on its FMA pipe, which the compiler also uses for integer
adds and moves (K1's SASS mix, ``--wavefront``, counts both), so 128 lanes is
the ceiling of a mixed integer stream: half the data sheet's 67 TFLOP/s
float32, which counts an FMA as two operations.  A DP cell counts 7
operations: character compare, score select, diag add, max(up, left),
max(diag, that), gap add, code update (one or of the 2-bit code that
the two maxima's a >= b predicates select).  DPX's ``__vibmax_s32``
gives a max and its predicate in one instruction, as counted;
``__viaddmax_s32`` would fuse the diag add into a max but gives no
predicate, which the code needs, so the count stays 7.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# sha256 of the delta bodies (everything after the two header lines) that
# the JAX reference (paramugsy_tpu, JAX_PLATFORMS=cpu) produces from the
# same inputs: its nucmer CLI on the headline FASTA files, and its
# align_pair + DeltaWriter on the island pair.  Computed at commit a259b7f;
# paramugsy_tpu is unchanged since.
HEADLINE_DELTA_SHA256 = (
    "6300135616f5c9d89e045b6830371461b89f1b5d4df0506c99fe7ad75028f86c"
)
ISLAND_DELTA_SHA256 = (
    "2b0f4368f681e34baae1efc82ed970c88203947476889c1837cd5cc7ca10dfab"
)
# Long segments (> 4096 bp) per island-pair run in the reference.
ISLAND_LONG_SEGMENTS = 4

HEADLINE_BP = 2_000_000
ISLAND_BREAK_LEN = 2048

# sha256 of the MAF files that the JAX reference's ``align -sequential``
# (JAX_PLATFORMS=cpu) writes from the same inputs, with its engine counts:
# the 8 x 2 Mbp family (``family_fastas``) and the realistic fixture with
# -refine.  Computed at commit 197a49f; paramugsy_tpu is unchanged since.
FAMILY_MAF_SHA256 = (
    "9aa5c55b2add9cc03d3d17e41c1498fc729cdfa41116e9d8f7ea572c8f416e77"
)
FAMILY_BP = 2_000_000
FAMILY_COUNT = 8
FAMILY_SEEDCLUSTER = 28  # the reference's seed-cluster dispatches per run
REALISTIC_MAF_SHA256 = (
    "59470c2c6569bb99db6ef25e4b8509929f7be4d20db6a75cd50034cb38f4bf05"
)
REALISTIC_LONG_SEGMENTS = 151  # the reference's native-banded segments per run

# The windowed pair path (contigs longer than AlignConfig.window =
# 4,194,304 bp), digests computed as above at commit 00263ef: the
# reference's nucmer CLI on the 6.26 Mbp pair, its align_pair + DeltaWriter
# on the island pair with 1 Mbp windows, and its ``align -sequential
# -config`` on the 4 x 2 Mbp family with 1 Mbp windows.  The port seeds
# each window pair once, so its dispatches per run count window pairs (the
# reference's batched count is the same here: every bucket group it forms
# is a power of two, so it adds no pad rows).
WINDOWED_BP = 6_264_404  # the length of P. aeruginosa PAO1's chromosome
WINDOWED_DELTA_SHA256 = (
    "bc97b90ed67d58241ff1fabbb984c3f84da63d1c2a7d842d98faf8d8922338af"
)
WINDOWED_SEEDCLUSTER = 4  # a 2 x 2 window grid
# The window of phases 7b and 8: 1 Mbp windows overlapping by 64 kb, cut
# from the default 4 Mbp so that 2 Mbp inputs take the windowed path (a
# check of coverage, not a setting users run).
MBP_WINDOW = {"window": 1 << 20, "window_overlap": 1 << 16}
# The same digest as ISLAND_DELTA_SHA256: windowing leaves this pair's
# entries unchanged.
WINDOWED_ISLAND_SHA256 = (
    "2b0f4368f681e34baae1efc82ed970c88203947476889c1837cd5cc7ca10dfab"
)
WINDOWED_ISLAND_SEEDCLUSTER = 9  # a 3 x 3 grid
WINDOWED_FAMILY_COUNT = 4
WINDOWED_FAMILY_MAF_SHA256 = (
    "042339122162e5bfb8269de720986226229924540ff9b95c697bce9837a5533e"
)
WINDOWED_FAMILY_SEEDCLUSTER = 54  # 6 pairs x 9 window pairs
BANDED_WIDTHS = (64, 256, 512, 1024, 4096, 32768)
BANDED_ALL_WIDTHS = tuple(32 << n for n in range(11))
# Scores under which a mismatch costs more than two gaps, so that an up move
# followed by a left move can beat the diag move (K3/K4's edge checks).
GAPPY_SCORES = {"match": 1, "mismatch": -9, "gap": -2}

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 128 * 1.98e9
OPS_PER_CELL = 7
# Refine segments of the realistic fixture reach K1 at batch 1, W 512:
# a sides of 5.0-46.0 kb, median 11.7 kb (anti-diagonal steps 9.9-92.0 k,
# median 23.5 k).
REFINE_MEDIAN_BP = 11_750
REFINE_LONGEST_BP = 46_000


def build_pair(rng, n):
    """bench.py's pair: `n` random bases, 1% substitutions, a 12 bp
    deletion, a 9 bp insertion and one 20 kb inversion."""
    ref = rng.integers(0, 4, size=n).astype(np.int8)
    q = ref.copy()
    subs = rng.random(n) < 0.01
    q[subs] = ((q[subs] + rng.integers(1, 4, size=int(subs.sum()))) % 4).astype(np.int8)
    q = np.concatenate([q[: n // 3], q[n // 3 + 12 :]])
    ins = rng.integers(0, 4, size=9).astype(np.int8)
    q = np.concatenate([q[: n // 2], ins, q[n // 2 :]])
    a, b = 2 * n // 3, 2 * n // 3 + 20000
    inv = (3 - q[a:b])[::-1].copy()
    q = np.concatenate([q[:a], inv, q[b:]])
    return ref, q


def build_family(rng, n, count=4, div=0.005):
    """bench.py's family: `count` genomes independently diverged from one
    ancestor (`div` substitutions, five 1 bp deletions each)."""
    from paramugsy_tpu_torch.pipeline import Genome

    bases = np.array(list("ACGT"))
    anc = rng.integers(0, 4, size=n).astype(np.int8)
    genomes = []
    for i in range(count):
        g = anc.copy()
        subs = rng.random(n) < div
        g[subs] = ((g[subs] + rng.integers(1, 4, size=int(subs.sum()))) % 4).astype(np.int8)
        g = np.delete(g, rng.integers(0, n, size=5))
        genomes.append(
            Genome(name=f"q{i}", seqs={f"q{i}.chr": "".join(bases[g])})
        )
    return genomes


def family_fastas(directory: str, n: int, count: int, seed: int = 7) -> list[str]:
    """Write `build_family` (np.random.default_rng(seed)) as one FASTA file
    per genome, ``q<i>.fa``; returns the paths in genome order."""
    paths = []
    for g in build_family(np.random.default_rng(seed), n, count=count):
        (name, seq), = g.seqs.items()
        path = os.path.join(directory, f"{g.name}.fa")
        with open(path, "w") as f:
            f.write(f">{name}\n{seq}\n")
        paths.append(path)
    return paths


def headline_fastas(directory: str, n: int = HEADLINE_BP) -> tuple[str, str]:
    """Write the bench pair (build_pair, seed 12345, `n` bp) as FASTA."""
    ref, query = build_pair(np.random.default_rng(12345), n)
    paths = []
    for name, codes in (("smoke_ref", ref), ("smoke_qry", query)):
        path = os.path.join(directory, f"{name}.fa")
        with open(path, "w") as f:
            f.write(f">{name}.chr\n")
            f.write(np.frombuffer(b"ACGT", np.uint8)[codes].tobytes().decode())
            f.write("\n")
        paths.append(path)
    return paths[0], paths[1]


def windowed_config(directory: str) -> str:
    """Write the ``-config`` file of the windowed family (1 Mbp windows,
    64 kb overlap); returns its path."""
    path = os.path.join(directory, "windowed.json")
    with open(path, "w") as f:
        json.dump({"align": MBP_WINDOW}, f)
    return path


def island_pair(n: int = HEADLINE_BP, n_islands: int = 4, length: int = 5000):
    """A bench-style pair whose query has `n_islands` windows of random
    sequence: each leaves an inter-anchor segment longer than 4096 bp."""
    rng = np.random.default_rng(2026)
    ref, query = build_pair(rng, n)
    query = query.copy()
    for s in np.linspace(n // 10, n - n // 10, n_islands).astype(int):
        query[s : s + length] = rng.integers(0, 4, length)
    return ref, query


def delta_body(text: str) -> str:
    """A delta file's text without its two header lines (input paths and
    program name)."""
    return text.split("\n", 2)[2]


def aligned_bp(text: str) -> int:
    """Alignment columns of a delta file: per entry the reference span
    plus one column per negative offset (a gap in the reference row)."""
    total = 0
    for line in delta_body(text).splitlines():
        fields = line.split()
        if len(fields) == 7:
            total += abs(int(fields[1]) - int(fields[0])) + 1
        elif len(fields) == 1 and int(fields[0]) < 0:
            total += 1
    return total


def sha256(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


def file_sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def kernel_pairs(rng, n_pairs: int, length: int, n_del: int, sub_rate: float = 0.02):
    """bench.py's long-segment shape: `length` bp, `n_del` deletions,
    `sub_rate` substitutions."""
    pairs = []
    for _ in range(n_pairs):
        a = rng.integers(0, 4, size=length).astype(np.int8)
        b = np.delete(a, rng.choice(length, n_del, replace=False)).copy()
        m = rng.random(len(b)) < sub_rate
        b[m] = ((b[m] + 1) % 4).astype(np.int8)
        pairs.append((a, b))
    return pairs


def traceback_edge_pairs(rng, length: int, width: int) -> list:
    """Pairs for one K2 launch at band `width` (>= 64) whose walks reach
    every branch of the CUDA kernel's jump logic:

    0. `length` bp with 1% substitutions: one DIAG run longer than 32
       word rows (length > 256), over several jump round trips when
       length > 1024;
    1. eight 2 bp deletions, 2. eight 2 bp insertions, 61 bp apart (their
       positions take every residue mod 8): indel moves in every slot of a
       word, the first and last of each parity included;
    3. a deletion of W/2 bp, an insertion of W - 1 bp and a deletion of
       W/2 - 1 bp: the alignment runs along lane 0 and then lane W - 1,
       the band's edges, where the walk is forced;
    4, 5. one side empty (the walk is all tail);
    6. two unrelated sequences: an event every few moves.

    The caller makes a pair get -1 by passing lengths that do not fit."""
    def seq(n):
        return rng.integers(0, 4, size=n).astype(np.int8)

    a = seq(length)
    b = a.copy()
    m = rng.random(length) < 0.01
    b[m] = ((b[m] + 1) % 4).astype(np.int8)
    pairs = [(a, b)]
    base = seq(700)
    cuts = [100 + 61 * t for t in range(8)]
    deleted = np.delete(base, [c + d for c in cuts for d in (0, 1)])
    pairs += [(base, deleted), (deleted, base)]
    x, y, z = seq(300), seq(300), seq(300)
    d, e, f = seq(width // 2), seq(width - 1), seq(width // 2 - 1)
    pairs.append((np.concatenate([x, d, y, z, f]), np.concatenate([x, y, e, z])))
    pairs += [(seq(90), seq(0)), (seq(0), seq(70)), (seq(260), seq(230))]
    return pairs


def _cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _once_ms(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(least ms, what bounds it) for moving `n_bytes` and doing `n_ops`
    int32 operations on one H100."""
    mem_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / INT32_OPS_PER_S * 1e3
    return (mem_ms, "bytes") if mem_ms >= ops_ms else (ops_ms, "operations")


def k2_bound(buf, a_len, b_len, width: int) -> tuple[float, str]:
    """K2's least time for one launch: the distinct dirs words its walks
    must read (one per word row and lane that a move inside the rectangle
    and the band reads), the lengths, and the whole output buffer; 7
    operations a move."""
    buf = buf.cpu().numpy()
    a_len, b_len = a_len.cpu().numpy(), b_len.cpu().numpy()
    words, moves = 0, 0
    for p in range(len(buf)):
        n = int(buf[p, 0])
        if n <= 0:
            continue
        k = np.arange(n)
        codes = (buf[p, 1 + k // 16].view(np.uint32) >> (2 * (k % 16)).astype(np.uint32)) & 3
        # Position before each move: DIAG and UP consume a, DIAG and LEFT b.
        i = int(a_len[p]) - np.concatenate(([0], np.cumsum(codes != 2)[:-1]))
        j = int(b_len[p]) - np.concatenate(([0], np.cumsum(codes != 1)[:-1]))
        w = j - i + width // 2
        read = (i > 0) & (j > 0) & (w > 0) & (w < width - 1)
        words += len(np.unique(((i + j - 1) >> 4)[read] * width + w[read]))
        moves += n
    return bound(4 * words + 8 * len(buf) + 4 * buf.size, OPS_PER_CELL * moves)


def check_kernels(pairs, device, reps: int) -> dict:
    """K1 and K2 against their plain versions on one launch of `pairs`,
    and every pair against the native banded engine."""
    import torch

    from paramugsy_tpu_torch.ops import wavefront as wf
    from paramugsy_tpu_torch.ops.extend import align_long_segment

    diff = max(abs(len(a) - len(b)) for a, b in pairs)
    width = 512
    while diff >= width // 2:
        width *= 2
    steps = -(-max(len(a) + len(b) for a, b in pairs) // 128) * 128
    A, B, al, bl = wf.pack_pairs(pairs, device)
    kw = dict(steps=steps, width=width)

    dirs = wf.wavefront_dp(A, B, al, bl, **kw)
    plain_dirs, k1_plain_ms = _once_ms(lambda: wf.wavefront_dp_plain(A, B, al, bl, **kw))
    k1_err = int((dirs.long() - plain_dirs.long()).abs().max())
    if not torch.equal(dirs, plain_dirs):
        raise AssertionError(f"K1 differs from its plain version at W={width}")
    k1_ms = _cuda_ms(lambda: wf.wavefront_dp(A, B, al, bl, **kw), reps)

    tb = wf.wavefront_traceback(dirs, al, bl, width=width)
    plain_tb, k2_plain_ms = _once_ms(
        lambda: wf.wavefront_traceback_plain(dirs, al, bl, width=width)
    )
    k2_err = int((tb.long() - plain_tb.long()).abs().max())
    if not torch.equal(tb, plain_tb):
        raise AssertionError(f"K2 differs from its plain version at W={width}")
    k2_ms = _cuda_ms(lambda: wf.wavefront_traceback(dirs, al, bl, width=width), reps)

    host = tb.cpu().numpy()
    for p, (a, b) in enumerate(pairs):
        got = wf._runs_of_path_words(host[p, 1:], int(host[p, 0]))
        if got != align_long_segment(a, b):
            raise AssertionError(f"pair {p} differs from native at W={width}")
    seq_bytes = A.numel() + B.numel() + 8 * len(pairs)
    k1_bound = bound(seq_bytes + 4 * dirs.numel(), OPS_PER_CELL * dirs.numel() * 16)
    k2_bnd = k2_bound(tb, al, bl, width)
    row = {
        "pairs": len(pairs), "length": len(pairs[0][0]), "width": width,
        "steps": steps, "k1_ms": k1_ms, "k1_plain_ms": k1_plain_ms,
        "k2_ms": k2_ms, "k2_plain_ms": k2_plain_ms,
        # Pairs walk side by side: per move of the longest walk.
        "k2_ns_per_move": k2_ms * 1e6 / int(host[:, 0].max()),
        "k1_max_abs_err": k1_err, "k2_max_abs_err": k2_err,
        "k1_bound_ms": k1_bound[0], "k1_bound_by": k1_bound[1],
        "k2_bound_ms": k2_bnd[0], "k2_bound_by": k2_bnd[1],
    }
    print("kernel_check", json.dumps(row), flush=True)
    return row


def _steps_of(pairs) -> int:
    return -(-max(len(a) + len(b) for a, b in pairs) // 128) * 128


def check_batch1(device) -> dict:
    """K1 against its plain version on a short launch of two pairs at every
    width of the register kernel; then the batch-1 refine shapes through K1
    and K2, timed with CUDA events: the median refine pair's buffers must
    be bit-identical to the plain versions'; the longest refine pair (plain
    K1 would take ~30 s) must give the native banded engine's alignment;
    then K2 on the edge batch (`traceback_edge_pairs`, its last pair given
    lengths that do not fit) at W 64 and 512, bit-identical to plain."""
    import torch

    from paramugsy_tpu_torch.ops import wavefront as wf
    from paramugsy_tpu_torch.ops.extend import align_long_segment

    rng = np.random.default_rng(11)
    widths = [32 << k for k in range(10)]
    for width in widths:
        pairs = kernel_pairs(rng, 2, 600, min(width // 4 - 1, 300))
        A, B, al, bl = wf.pack_pairs(pairs, device)
        kw = dict(steps=_steps_of(pairs), width=width)
        if not torch.equal(wf.wavefront_dp(A, B, al, bl, **kw), wf.wavefront_dp_plain(A, B, al, bl, **kw)):
            raise AssertionError(f"K1 differs from plain at W={width}")
    row = {"widths_checked": widths}

    median = kernel_pairs(rng, 1, REFINE_MEDIAN_BP, 40)
    longest = kernel_pairs(rng, 1, REFINE_LONGEST_BP, 40)
    for shape, pairs in (("median", median), ("longest", longest)):
        A, B, al, bl = wf.pack_pairs(pairs, device)
        kw = dict(steps=_steps_of(pairs), width=512)
        dirs = wf.wavefront_dp(A, B, al, bl, **kw)
        tb = wf.wavefront_traceback(dirs, al, bl, width=512)
        out = {"steps": kw["steps"], "moves": int(tb[0, 0])}
        if shape == "median":
            want, out["plain_ms"] = _once_ms(lambda: wf.wavefront_dp_plain(A, B, al, bl, **kw))
            if not torch.equal(dirs, want):
                raise AssertionError("K1 differs from plain at the median refine pair")
            cell_ops = OPS_PER_CELL * dirs.numel() * 16
            out["bound"] = bound(2 * REFINE_MEDIAN_BP + 8 + 4 * dirs.numel(), cell_ops)
            # One pair can use one SM: 1/132 of the card's integer rate.
            out["one_sm_bound_us_per_step"] = cell_ops / (INT32_OPS_PER_S / 132) * 1e6 / kw["steps"]
            want_tb, out["k2_plain_ms"] = _once_ms(
                lambda: wf.wavefront_traceback_plain(dirs, al, bl, width=512)
            )
            out["k2_max_abs_err"] = int((tb.long() - want_tb.long()).abs().max())
            if not torch.equal(tb, want_tb):
                raise AssertionError("K2 differs from plain at the median refine pair")
            out["k2_bound"] = k2_bound(tb, al, bl, 512)
        else:
            host = tb.cpu().numpy()
            a, b = pairs[0]
            if wf._runs_of_path_words(host[0, 1:], int(host[0, 0])) != align_long_segment(a, b):
                raise AssertionError("K1 + K2: longest refine pair differs from native")
        out["ms"] = _cuda_ms(lambda: wf.wavefront_dp(A, B, al, bl, **kw), 20)
        out["us_per_step"] = out["ms"] * 1e3 / kw["steps"]
        # K2's time includes the wrapper's zeroing of the output buffer.
        out["k2_ms"] = _cuda_ms(lambda: wf.wavefront_traceback(dirs, al, bl, width=512), 50)
        out["k2_ns_per_move"] = out["k2_ms"] * 1e6 / out["moves"]
        row[shape] = out

    row["edge"] = []
    for width in (64, 512):
        pairs = traceback_edge_pairs(rng, 5000, 64)
        pairs.append(pairs[-1])
        A, B, al, bl = wf.pack_pairs(pairs, device)
        steps = _steps_of(pairs)
        bl[-1] = steps  # does not fit: -1
        dirs = wf.wavefront_dp(A, B, al, bl, steps=steps, width=width)
        tb = wf.wavefront_traceback(dirs, al, bl, width=width)
        want = wf.wavefront_traceback_plain(dirs, al, bl, width=width)
        if not torch.equal(tb, want) or int(tb[-1, 0]) != -1:
            raise AssertionError(f"K2 differs from plain on the edge batch at W={width}")
        row["edge"].append({
            "width": width, "pairs": len(pairs), "moves": tb[:, 0].tolist(),
            "max_abs_err": int((tb.long() - want.long()).abs().max()),
            "k2_ms": _cuda_ms(lambda: wf.wavefront_traceback(dirs, al, bl, width=width), 20),
        })
    print("batch1", json.dumps(row), flush=True)
    return row


def banded_batch(rng, width: int) -> list:
    """Eight pairs of 2-8 kb for one K4 launch at `width`: the lengths
    differ per pair, and the last pair's length difference is W/2 - 1, one
    base inside the band edge (at most half its length: at W 32768 the
    pairs are too short to reach the edge)."""
    pairs = []
    for p in range(8):
        length = 2000 + 850 * p
        n_del = width // 2 - 1 if p == 7 else int(rng.integers(0, width // 4))
        pairs.extend(kernel_pairs(rng, 1, length, min(n_del, length // 2)))
    return pairs


def banded_edge_pairs() -> list:
    """Seven pairs for one K3/K4 launch of 128 rows (padded to eight with an
    empty pair by the caller): unequal lengths, empty sides, N codes, a pair
    at the W 128 band edge, one that fills every row, and one on which the
    reference's single-pair `banded_align` raises IndexError (a 100 bp, b =
    a less 38 bases: rows reach b_len + W/2 + 2).  tests/test_torch_banded.py
    holds K4's plain version against the reference on them."""
    rng = np.random.default_rng(5)

    def pair(la, n_del, sub_rate=0.03, n_rate=0.0):
        a = rng.integers(0, 4, size=la).astype(np.int8)
        a[rng.random(la) < n_rate] = 4
        b = np.delete(a, rng.choice(la, n_del, replace=False)) if la else a.copy()
        m = rng.random(len(b)) < sub_rate
        b[m] = ((b[m] + 1) % 4).astype(np.int8)
        return a, b

    return [
        pair(100, 6, n_rate=0.05),
        (np.zeros(0, np.int8), rng.integers(0, 4, 50).astype(np.int8)),
        (rng.integers(0, 4, 40).astype(np.int8), np.zeros(0, np.int8)),
        pair(120, 63),  # length difference at the W 128 band edge
        (rng.integers(0, 4, 20).astype(np.int8), rng.integers(0, 4, 80).astype(np.int8)),
        pair(100, 38, sub_rate=0.0),  # the reference's IndexError pair
        pair(128, 10, sub_rate=0.1),
    ]


def _dirs_err(got, want) -> int:
    import torch

    return int((got.to(torch.int16) - want.to(torch.int16)).abs().max())


def _per_row(row: dict, rows: int, width: int) -> dict:
    """us per row beside the one-SM bound: a pair's rows are sequential, so
    one pair has one SM's 128 integer lanes at 1.98 GHz."""
    row["us_per_row"] = row["ms"] * 1e3 / rows
    row["one_sm_bound_us_per_row"] = OPS_PER_CELL * width / (INT32_OPS_PER_S / 132) * 1e6
    return row


def check_banded(device, reps: int) -> dict:
    """K3 and K4 against banded_dp_plain on the card (direct wrapper
    calls): the edge batch (`banded_edge_pairs`) at every width 32 ...
    32768 under the default scores and under GAPPY_SCORES, a short launch
    of eight pairs at each width that is not timed, then the timed shapes
    (K3 one 8 kb pair at W 512, K4 at BANDED_WIDTHS).  Then their path:
    the entry points banded_align and banded_align_batch on the timed
    pairs, with the launch counts zeroed before and read after.  Every
    triple must equal the native banded engine at the same width."""
    import torch

    from paramugsy_tpu_torch.ops import banded as bd
    from paramugsy_tpu_torch.ops.extend import align_long_segment

    rng = np.random.default_rng(2024)
    k3_pair = kernel_pairs(rng, 1, 8192, 100)[0]
    batches = {w: banded_batch(rng, w) for w in BANDED_WIDTHS}

    edge = banded_edge_pairs() + [(np.zeros(0, np.int8),) * 2]
    A, B, al, bl = bd.pack_pairs(edge, device)
    for width in BANDED_ALL_WIDTHS:
        for scores in ({}, GAPPY_SCORES):
            kw = dict(rows=128, width=width, **scores)
            if not torch.equal(bd.banded_dp_batch(A, B, al, bl, **kw), bd.banded_dp_plain(A, B, al, bl, **kw)):
                raise AssertionError(f"K4 differs from plain on the edge batch at W={width} {scores}")
    # Past the NEG margin the card refuses, before any launch.
    launched = bd.banded_dp_batch.launches
    try:
        bd.banded_dp_batch(A, B, al, bl, rows=128, width=256, gap=-(10**6))
        raise AssertionError("K4 accepted a gap past the NEG margin")
    except ValueError:
        if bd.banded_dp_batch.launches != launched:
            raise AssertionError("K4 counted a refused launch") from None
    short = {}
    for width in BANDED_ALL_WIDTHS:
        if width in BANDED_WIDTHS:
            continue
        pairs = [kernel_pairs(rng, 1, 600 + 100 * p, min(width // 4, 300))[0] for p in range(8)]
        A, B, al, bl = bd.pack_pairs(pairs, device)
        kw = dict(rows=1337, width=width)  # ends inside a 16-row block
        dirs = bd.banded_dp_batch(A, B, al, bl, **kw)
        plain = bd.banded_dp_plain(A, B, al, bl, **kw)
        if not torch.equal(dirs, plain):
            raise AssertionError(f"K4 differs from plain at W={width} (short launch)")
        short[width] = _dirs_err(dirs, plain)
    row = {"edge_widths": list(BANDED_ALL_WIDTHS), "short": short}

    a, b = k3_pair
    A, B, al, bl = bd.pack_pairs([k3_pair], device)
    kw = dict(rows=bd.chunk_rows([len(a)], 128), width=512)
    dirs = bd.banded_dp(A, B, al, bl, **kw)
    plain, k3_plain_ms = _once_ms(lambda: bd.banded_dp_plain(A, B, al, bl, **kw))
    if not torch.equal(dirs, plain[:, 0]):
        raise AssertionError("K3 differs from its plain version at W=512")
    k3_bound = bound(A.numel() + B.numel() + 8 + dirs.numel(), OPS_PER_CELL * dirs.numel())
    ms = _cuda_ms(lambda: bd.banded_dp(A, B, al, bl, **kw), reps)
    row["k3"] = _per_row({
        "length": len(a), "rows": kw["rows"], "width": 512,
        "max_abs_err": _dirs_err(dirs, plain[:, 0]), "ms": ms, "plain_ms": k3_plain_ms,
        "bound_ms": k3_bound[0], "bound_by": k3_bound[1],
    }, kw["rows"], 512)
    row["k4"] = []
    for width, pairs in batches.items():
        A, B, al, bl = bd.pack_pairs(pairs, device)
        kw = dict(rows=bd.chunk_rows([len(x) for x, _ in pairs], 128), width=width)
        dirs = bd.banded_dp_batch(A, B, al, bl, **kw)
        plain, plain_ms = _once_ms(lambda: bd.banded_dp_plain(A, B, al, bl, **kw))
        if not torch.equal(dirs, plain):
            raise AssertionError(f"K4 differs from its plain version at W={width}")
        k4_bound = bound(
            A.numel() + B.numel() + 8 * len(pairs) + dirs.numel(),
            OPS_PER_CELL * dirs.numel(),
        )
        ms = _cuda_ms(lambda: bd.banded_dp_batch(A, B, al, bl, **kw), reps)
        row["k4"].append(_per_row({
            "pairs": len(pairs), "rows": kw["rows"], "width": width,
            "max_abs_err": _dirs_err(dirs, plain), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": k4_bound[0], "bound_by": k4_bound[1],
        }, kw["rows"], width))

    # The path: the two entry points, counted.
    bd.banded_dp.launches = 0
    bd.banded_dp_batch.launches = 0
    got = {("k3", 512): [bd.banded_align(a, b, width=512, device=device)]}
    for width, pairs in batches.items():
        got["k4", width] = bd.banded_align_batch(pairs, width=width, device=device)
    row["launches"] = {
        "banded_dp": bd.banded_dp.launches,
        "banded_dp_batch": bd.banded_dp_batch.launches,
    }
    for (kind, width), triples in got.items():
        pairs = [k3_pair] if kind == "k3" else batches[width]
        for p, ((x, y), t) in enumerate(zip(pairs, triples)):
            if t != align_long_segment(x, y, width=width):
                raise AssertionError(f"{kind} pair {p} differs from native at W={width}")
    print("banded_check", json.dumps(row), flush=True)
    return row


def build_native() -> None:
    """Build native/ (chaining, NW and banded engines) when it is missing.

    The compiler is named explicitly: an inherited $CXX can lack OpenMP,
    which the Makefile's -fopenmp needs, and the reference's own loader
    would then fall back to NumPy without a word."""
    native_dir = os.path.join(ROOT, "native")
    if os.path.exists(os.path.join(native_dir, "libpm_native.so")):
        return
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise AssertionError("no C++ compiler on PATH for native/")
    res = subprocess.run(
        ["make", "-C", native_dir, f"CXX={cxx}"],
        capture_output=True, text=True, timeout=600,
    )
    if res.returncode != 0:
        raise AssertionError(f"make -C native failed:\n{res.stdout}{res.stderr}")


def _engine_delta(before: dict) -> dict:
    from paramugsy_tpu_torch.ops import engines

    return {
        k: v - before.get(k, 0) for k, v in engines.COUNTS.items()
        if v != before.get(k, 0)
    }


def headline_phase(device) -> dict:
    """The bench pair through the nucmer CLI: one warm-up, best of 3."""
    import torch

    from paramugsy_tpu_torch import cli
    from paramugsy_tpu_torch.ops import engines

    before = dict(engines.COUNTS)
    with tempfile.TemporaryDirectory() as tmp:
        ref_fa, qry_fa = headline_fastas(tmp)
        out = os.path.join(tmp, "smoke.delta")
        argv = [
            "nucmer", "-ref_seq", ref_fa, "-query_seq", qry_fa,
            "-out_delta", out, "-device", device.type,
        ]
        walls = []
        for _ in range(4):
            t0 = time.perf_counter()
            if cli.main(argv) != 0:
                raise AssertionError("nucmer CLI failed")
            if device.type == "cuda":
                torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        with open(out) as f:
            text = f.read()
    if sha256(delta_body(text)) != HEADLINE_DELTA_SHA256:
        raise AssertionError("headline delta differs from the JAX reference")
    aligned = aligned_bp(text)
    used = _engine_delta(before)
    if not used.get(f"seedcluster-{device.type}"):
        raise AssertionError(f"seeding did not run on {device.type}")
    # The native library loaded: without it the segments would have run on
    # the reference's NumPy NW (``numpy-nw``).
    if not used.get("native-nw") or "numpy-nw" in used:
        raise AssertionError(f"segments did not run on native NW: {used}")
    best = min(walls[1:])
    row = {
        "first_s": walls[0], "warm_best_s": best, "aligned_bp": aligned,
        "aligned_mbp_per_s": aligned / 1e6 / best, "engines": used,
    }
    print("headline", json.dumps(row), flush=True)
    return row


def island_phase(device) -> dict:
    """The island pair through align_pair twice; long segments must go to
    the wavefront engine and the entries equal the reference's."""
    import torch

    from paramugsy_tpu_torch.cli import delta_text
    from paramugsy_tpu_torch.ops import engines
    from paramugsy_tpu_torch.ops.align_pair import AlignConfig, align_pair

    ref, query = island_pair()
    cfg = AlignConfig(break_len=ISLAND_BREAK_LEN)
    before = dict(engines.COUNTS)
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        entries = align_pair(ref, query, "island.r", "island.q", cfg, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if sha256(delta_body(delta_text(entries))) != ISLAND_DELTA_SHA256:
            raise AssertionError("island entries differ from the JAX reference")
    used = _engine_delta(before)
    if used.get("device-wavefront") != 2 * ISLAND_LONG_SEGMENTS:
        raise AssertionError(
            f"wavefront engine counted {used.get('device-wavefront')} long "
            f"segments over two runs, expected {2 * ISLAND_LONG_SEGMENTS}"
        )
    row = {
        "first_s": walls[0], "warm_s": walls[1], "entries": len(entries),
        "engines": used,
    }
    print("island", json.dumps(row), flush=True)
    return row


def _launch_counts() -> dict:
    from paramugsy_tpu_torch.ops import wavefront as wf

    return {
        "wavefront_dp": wf.wavefront_dp.launches,
        "wavefront_traceback": wf.wavefront_traceback.launches,
    }


def _zero_launches() -> None:
    from paramugsy_tpu_torch.ops import wavefront as wf

    wf.wavefront_dp.launches = 0
    wf.wavefront_traceback.launches = 0


def _align_runs(name: str, argv: list, out: str, digest: str) -> list:
    """`cli align` twice on the same inputs: per run the wall, the engine
    counts, the phase times and the MAF digest check."""
    import torch

    from paramugsy_tpu_torch import cli
    from paramugsy_tpu_torch.ops import engines
    from paramugsy_tpu_torch.pipeline import METRICS

    runs = []
    for _ in range(2):
        METRICS.phases.clear()
        before = dict(engines.COUNTS)
        t0 = time.perf_counter()
        if cli.main(argv) != 0:
            raise AssertionError(f"{name}: align CLI failed")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if file_sha256(out) != digest:
            raise AssertionError(f"{name}: MAF differs from the JAX reference")
        runs.append({
            "wall_s": wall,
            "engines": _engine_delta(before),
            "phases_s": {k: v.total_s for k, v in sorted(METRICS.phases.items())},
        })
        print(METRICS.report(), flush=True)
    return runs


def family_phase(device) -> dict:
    """The 8 x 2 Mbp family through ``align -sequential`` (first, warm)."""
    with tempfile.TemporaryDirectory() as tmp:
        paths = family_fastas(tmp, FAMILY_BP, FAMILY_COUNT)
        out = os.path.join(tmp, "family.maf")
        argv = ["align", "-sequential", *paths, "-out_maf", out, "-device", device.type]
        runs = _align_runs("family", argv, out, FAMILY_MAF_SHA256)
    for r in runs:
        if r["engines"].get(f"seedcluster-{device.type}") != FAMILY_SEEDCLUSTER:
            raise AssertionError(
                f"family: seeding dispatched {r['engines']} on {device.type}, "
                f"expected {FAMILY_SEEDCLUSTER} (the reference's count)"
            )
        if not r["engines"].get("native-nw") or "numpy-nw" in r["engines"]:
            raise AssertionError(f"family: segments did not run on native NW: {r}")
    row = {"genomes": FAMILY_COUNT, "bp": FAMILY_BP, "first": runs[0], "warm": runs[1]}
    print("family", json.dumps(row), flush=True)
    return row


def realistic_phase(device) -> dict:
    """The realistic fixture through ``align -sequential -refine`` (first,
    warm): every long refine segment on K1/K2."""
    import glob

    paths = sorted(glob.glob(os.path.join(ROOT, "tests", "data", "realistic", "*.fa")))
    if len(paths) != 5:
        raise AssertionError(f"realistic fixture: {len(paths)} FASTA files, expected 5")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "realistic.maf")
        argv = [
            "align", "-sequential", *paths, "-refine", "-out_maf", out,
            "-device", device.type,
        ]
        runs = _align_runs("realistic", argv, out, REALISTIC_MAF_SHA256)
    for r in runs:
        if r["engines"].get("device-wavefront") != REALISTIC_LONG_SEGMENTS:
            raise AssertionError(
                f"realistic: {r['engines']}; expected {REALISTIC_LONG_SEGMENTS} "
                "long segments on the wavefront kernels"
            )
    row = {"genomes": len(paths), "first": runs[0], "warm": runs[1]}
    print("realistic", json.dumps(row), flush=True)
    return row


def windowed_pair_phase(device) -> dict:
    """The 6.26 Mbp pair through the nucmer CLI twice (first, warm): both
    contigs exceed the 4 Mbp window, so the pair runs as a 2 x 2 grid of
    window pairs."""
    import torch

    from paramugsy_tpu_torch import cli
    from paramugsy_tpu_torch.ops import engines

    with tempfile.TemporaryDirectory() as tmp:
        ref_fa, qry_fa = headline_fastas(tmp, WINDOWED_BP)
        out = os.path.join(tmp, "windowed.delta")
        argv = [
            "nucmer", "-ref_seq", ref_fa, "-query_seq", qry_fa,
            "-out_delta", out, "-device", device.type,
        ]
        runs = []
        for _ in range(2):
            before = dict(engines.COUNTS)
            t0 = time.perf_counter()
            if cli.main(argv) != 0:
                raise AssertionError("windowed pair: nucmer CLI failed")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            with open(out) as f:
                text = f.read()
            if sha256(delta_body(text)) != WINDOWED_DELTA_SHA256:
                raise AssertionError("windowed pair: delta differs from the JAX reference")
            used = _engine_delta(before)
            if used.get(f"seedcluster-{device.type}") != WINDOWED_SEEDCLUSTER:
                raise AssertionError(
                    f"windowed pair: {used}; expected {WINDOWED_SEEDCLUSTER} "
                    f"seeding dispatches on {device.type}"
                )
            runs.append({"wall_s": wall, "engines": used})
    row = {
        "bp": WINDOWED_BP, "first_s": runs[0]["wall_s"], "warm_s": runs[1]["wall_s"],
        "aligned_bp": aligned_bp(text), "engines": runs[1]["engines"],
    }
    print("windowed_pair", json.dumps(row), flush=True)
    return row


def windowed_island_phase(device) -> dict:
    """The island pair with 1 Mbp windows through align_pair twice: a 3 x
    3 window grid whose long segments reach K1 and K2 inside window
    jobs."""
    import torch

    from paramugsy_tpu_torch.cli import delta_text
    from paramugsy_tpu_torch.ops import engines
    from paramugsy_tpu_torch.ops.align_pair import AlignConfig, align_pair

    ref, query = island_pair()
    cfg = AlignConfig(break_len=ISLAND_BREAK_LEN, **MBP_WINDOW)
    runs = []
    for _ in range(2):
        before, launched = dict(engines.COUNTS), _launch_counts()
        t0 = time.perf_counter()
        entries = align_pair(ref, query, "island.r", "island.q", cfg, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if sha256(delta_body(delta_text(entries))) != WINDOWED_ISLAND_SHA256:
            raise AssertionError("windowed island: entries differ from the JAX reference")
        used = _engine_delta(before)
        launches = {k: v - launched[k] for k, v in _launch_counts().items()}
        if (
            used.get("device-wavefront") != ISLAND_LONG_SEGMENTS
            or used.get(f"seedcluster-{device.type}") != WINDOWED_ISLAND_SEEDCLUSTER
            or min(launches.values()) <= 0
        ):
            raise AssertionError(
                f"windowed island: {used}, launches {launches}; expected "
                f"{ISLAND_LONG_SEGMENTS} long segments on K1/K2 and "
                f"{WINDOWED_ISLAND_SEEDCLUSTER} seeding dispatches"
            )
        runs.append({"wall_s": wall, "engines": used, "launches": launches})
    row = {
        "first_s": runs[0]["wall_s"], "warm_s": runs[1]["wall_s"],
        "entries": len(entries), "engines": runs[1]["engines"],
        "launches": runs[1]["launches"],
    }
    print("windowed_island", json.dumps(row), flush=True)
    return row


def windowed_family_phase(device) -> dict:
    """The 4 x 2 Mbp family through ``align -sequential -config`` with 1
    Mbp windows (first, warm): every pair runs as a 3 x 3 window grid."""
    with tempfile.TemporaryDirectory() as tmp:
        paths = family_fastas(tmp, FAMILY_BP, WINDOWED_FAMILY_COUNT)
        out = os.path.join(tmp, "windowed_family.maf")
        argv = [
            "align", "-sequential", *paths, "-config", windowed_config(tmp),
            "-out_maf", out, "-device", device.type,
        ]
        runs = _align_runs("windowed family", argv, out, WINDOWED_FAMILY_MAF_SHA256)
    for r in runs:
        if r["engines"].get(f"seedcluster-{device.type}") != WINDOWED_FAMILY_SEEDCLUSTER:
            raise AssertionError(
                f"windowed family: {r['engines']}; expected "
                f"{WINDOWED_FAMILY_SEEDCLUSTER} seeding dispatches on {device.type}"
            )
        if not r["engines"].get("native-nw") or "numpy-nw" in r["engines"]:
            raise AssertionError(f"windowed family: segments did not run on native NW: {r}")
    row = {
        "genomes": WINDOWED_FAMILY_COUNT, "bp": FAMILY_BP,
        "first": runs[0], "warm": runs[1],
    }
    print("windowed_family", json.dumps(row), flush=True)
    return row


def _profile_cli(name: str, argv: list, out: str, digest_of, digest: str) -> dict:
    """One CLI run traced: a warm-up run, two untraced runs, then one run
    under torch.profiler; device time per kernel (sum of CUDA self time)
    and the busy share of the traced wall.  ``digest_of(out)`` must equal
    `digest` after the traced run."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paramugsy_tpu_torch import cli

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        if cli.main(argv) != 0:
            raise AssertionError(f"{name}: CLI failed")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    _zero_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if cli.main(argv) != 0:
            raise AssertionError(f"{name}: CLI failed")
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    if digest_of(out) != digest:
        raise AssertionError(f"{name}: output differs from the JAX reference")
    kernels = {}
    for ev in prof.key_averages():
        # Device events only (kernels, copies): a CPU operator's self device
        # time is the time of the kernels it launched, counted again.
        if ev.device_type == DeviceType.CPU:
            continue
        ms = getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0)) / 1e3
        if ms > 0:
            kernels[ev.key] = (ms, ev.count)
    busy = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    row = {
        "untraced_warm_s": walls[1:], "traced_s": traced,
        "device_busy_ms": busy if busy else "not measured",
        "busy_share": busy / 1e3 / traced if busy else "not measured",
        "launches": _launch_counts(),
        "top_kernels_ms_count": {k: v for k, v in top},
        # K1 and K2 by name, wherever they rank.
        "wavefront_kernels_ms_count": {
            k: v for k, v in kernels.items()
            if "wavefront_reg_kernel" in k or "traceback_kernel" in k
        },
    }
    print(f"profile_{name}", json.dumps(row), flush=True)
    return row


def profile_realistic() -> dict:
    """The realistic fixture through ``align -sequential -refine``, traced."""
    import glob

    paths = sorted(glob.glob(os.path.join(ROOT, "tests", "data", "realistic", "*.fa")))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "realistic.maf")
        argv = ["align", "-sequential", *paths, "-refine", "-out_maf", out, "-device", "cuda"]
        return _profile_cli("realistic", argv, out, file_sha256, REALISTIC_MAF_SHA256)


def profile_family(windowed: bool) -> dict:
    """The 8 x 2 Mbp family (phase 5) or the windowed 4 x 2 Mbp family
    (phase 8) through ``align -sequential``, traced."""
    with tempfile.TemporaryDirectory() as tmp:
        count = WINDOWED_FAMILY_COUNT if windowed else FAMILY_COUNT
        paths = family_fastas(tmp, FAMILY_BP, count)
        out = os.path.join(tmp, "family.maf")
        argv = ["align", "-sequential", *paths, "-out_maf", out, "-device", "cuda"]
        if windowed:
            argv += ["-config", windowed_config(tmp)]
        return _profile_cli(
            "windowed_family" if windowed else "family", argv, out, file_sha256,
            WINDOWED_FAMILY_MAF_SHA256 if windowed else FAMILY_MAF_SHA256,
        )


def profile_windowed_pair() -> dict:
    """The 6.26 Mbp windowed pair (phase 7) through ``nucmer``, traced."""
    with tempfile.TemporaryDirectory() as tmp:
        ref_fa, qry_fa = headline_fastas(tmp, WINDOWED_BP)
        out = os.path.join(tmp, "windowed.delta")
        argv = ["nucmer", "-ref_seq", ref_fa, "-query_seq", qry_fa, "-out_delta", out,
                "-device", "cuda"]

        def digest_of(path):
            with open(path) as f:
                return sha256(delta_body(f.read()))

        return _profile_cli("windowed_pair", argv, out, digest_of, WINDOWED_DELTA_SHA256)


def print_sass_mix() -> None:
    """Per instantiation of K1's register kernel, the SASS instructions of
    the built library per DP cell of one 16-step block (all of the
    kernel's instructions over 16 * L lanes-steps) and the commonest
    opcodes: what the source note's issue-rate estimate counts."""
    import collections
    import re

    from paramugsy_tpu_torch.ops import _kernels

    tool = os.path.join(os.path.dirname(_kernels._nvcc()), "cuobjdump")
    sass = subprocess.run(
        [tool, "-sass", _kernels.LIB_PATH], capture_output=True, text=True, timeout=300
    ).stdout
    for chunk in sass.split("Function : ")[1:]:
        name = chunk.split("\n", 1)[0]
        found = re.search(r"wavefront_reg_kernelILi(\d+)ELi(\d+)E", name)
        if found:
            lanes = int(found.group(1))
            ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)", chunk)
            mix = collections.Counter(o.split(".")[0] for o in ops).most_common(14)
            print("sass", f"L={lanes} threads<={found.group(2)}", json.dumps({
                "instructions": len(ops), "per_cell": len(ops) / (16 * lanes), "top": mix,
            }), flush=True)


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")

    # Phase 1: card and build.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"card: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    from paramugsy_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    _kernels.library()
    build_s = time.perf_counter() - t0
    if os.path.exists(_kernels.LOG_PATH):
        with open(_kernels.LOG_PATH) as f:
            print(f.read().strip())
    print(f"kernel build: {build_s:.3f} s", flush=True)
    t0 = time.perf_counter()
    build_native()
    print(f"native build: {time.perf_counter() - t0:.3f} s", flush=True)

    if argv == ["--wavefront"]:
        print_sass_mix()
        check_batch1(device)
        return 0
    if argv == ["--banded"]:
        check_banded(device, reps=3)
        return 0
    if argv == ["--profile"]:
        profile_realistic()
        profile_family(windowed=False)
        profile_windowed_pair()
        profile_family(windowed=True)
        return 0
    if argv:
        raise SystemExit(f"usage: {sys.argv[0]} [--wavefront | --banded | --profile]")

    # Phase 2: kernels against their plain versions, at the bench shape
    # and at every band width up to one past the register kernel's.
    rng = np.random.default_rng(99)
    bench_shape = check_kernels(kernel_pairs(rng, 64, 16384, 20), device, reps=5)
    wide = [
        check_kernels(kernel_pairs(rng, n_pairs, length, n_del), device, reps=3)
        for n_pairs, length, n_del in (
            (8, 6000, 300), (8, 6000, 700),
            (2, 12000, 1500), (2, 12000, 3000), (2, 12000, 5000),
            (2, 20000, 9000),
        )
    ]
    widths = [bench_shape["width"]] + [r["width"] for r in wide]
    if widths != [512, 1024, 2048, 4096, 8192, 16384, 32768]:
        raise AssertionError(f"kernel checks reached widths {widths}")

    # Phase 2a: K1 at every register width, the batch-1 refine shapes
    # through K1 and K2, and K2 on the edge batch.
    batch1 = check_batch1(device)

    # Phase 2b: K3/K4 against their plain version, then their path.
    banded = check_banded(device, reps=3)
    if min(banded["launches"].values()) <= 0:
        raise AssertionError(f"a banded kernel never launched: {banded['launches']}")

    from paramugsy_tpu_torch.ops import engines

    # Each path from here on: counters zeroed just before, read just after.
    engines.reset_counts()
    _zero_launches()
    headline_phase(device)
    island_phase(device)
    pair_launches = _launch_counts()
    print("main_path_launches", json.dumps({"pairwise": pair_launches}), flush=True)
    if min(pair_launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {pair_launches}")

    _zero_launches()
    family_phase(device)
    family_launches = _launch_counts()
    print("main_path_launches", json.dumps({"family": family_launches}), flush=True)

    _zero_launches()
    realistic_phase(device)
    refine_launches = _launch_counts()
    print("main_path_launches", json.dumps({"realistic": refine_launches}), flush=True)
    if min(refine_launches.values()) <= 0:
        raise AssertionError(f"K1/K2 never launched under -refine: {refine_launches}")

    _zero_launches()
    windowed_pair_phase(device)
    windowed_island_phase(device)
    windowed_family_phase(device)
    windowed_launches = _launch_counts()
    print("main_path_launches", json.dumps({"windowed": windowed_launches}), flush=True)
    if min(windowed_launches.values()) <= 0:
        raise AssertionError(f"K1/K2 never launched in window jobs: {windowed_launches}")

    launches = {
        k: pair_launches[k] + family_launches[k] + refine_launches[k] + windowed_launches[k]
        for k in pair_launches
    }
    k4_main = next(r for r in banded["k4"] if r["width"] == 512)
    kernels = [
        {
            "name": "wavefront_dp",
            "route": "cuda",
            "source": "paramugsy_tpu_torch/csrc/wavefront.cu",
            "replaces": "paramugsy_tpu/ops/pallas_extend.py:503",
            "launches": launches["wavefront_dp"],
            "max_abs_err": max(r["k1_max_abs_err"] for r in [bench_shape, *wide]),
            "ms": bench_shape["k1_ms"],
            "plain_ms": bench_shape["k1_plain_ms"],
            "bound_ms": bench_shape["k1_bound_ms"],
            "bound_by": bench_shape["k1_bound_by"],
            "library_ms": None,
            "us_per_step_batch1": batch1["median"]["us_per_step"],
        },
        {
            "name": "wavefront_traceback",
            "route": "cuda",
            "source": "paramugsy_tpu_torch/csrc/traceback.cu",
            "replaces": "paramugsy_tpu/ops/pallas_extend.py:726",
            "launches": launches["wavefront_traceback"],
            "max_abs_err": max(
                [r["k2_max_abs_err"] for r in [bench_shape, *wide]]
                + [batch1["median"]["k2_max_abs_err"]]
                + [r["max_abs_err"] for r in batch1["edge"]]
            ),
            "ms": bench_shape["k2_ms"],
            "plain_ms": bench_shape["k2_plain_ms"],
            "bound_ms": bench_shape["k2_bound_ms"],
            "bound_by": bench_shape["k2_bound_by"],
            "library_ms": None,
            "ns_per_move_batch1": batch1["median"]["k2_ns_per_move"],
        },
        {
            "name": "banded_dp",
            "route": "cuda",
            "source": "paramugsy_tpu_torch/csrc/banded.cu",
            "replaces": "paramugsy_tpu/ops/pallas_extend.py:58",
            "launches": banded["launches"]["banded_dp"],
            "max_abs_err": banded["k3"]["max_abs_err"],
            "ms": banded["k3"]["ms"],
            "plain_ms": banded["k3"]["plain_ms"],
            "bound_ms": banded["k3"]["bound_ms"],
            "bound_by": banded["k3"]["bound_by"],
            "library_ms": None,
            "us_per_row": banded["k3"]["us_per_row"],
        },
        {
            "name": "banded_dp_batch",
            "route": "cuda",
            "source": "paramugsy_tpu_torch/csrc/banded.cu",
            "replaces": "paramugsy_tpu/ops/pallas_extend.py:296",
            "launches": banded["launches"]["banded_dp_batch"],
            "max_abs_err": max(r["max_abs_err"] for r in banded["k4"]),
            "ms": k4_main["ms"],
            "plain_ms": k4_main["plain_ms"],
            "bound_ms": k4_main["bound_ms"],
            "bound_by": k4_main["bound_by"],
            "library_ms": None,
            "us_per_row": k4_main["us_per_row"],
        },
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {smi}", flush=True)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
