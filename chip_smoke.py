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

9. The self-alignment path: the ``repeats`` CLI on a 2 Mbp genome with
   eight planted 5 kb duplications, half inverted (``repeats_genome``),
   twice (first, warm); delta body and MAF must equal the JAX
   reference's, with one repeat-seeding dispatch per run.
9b. The ``repeats`` CLI on a genome of E. coli K-12's length (4,641,652
   bp, over the 4 Mbp window; ``windowed_self_genome``) twice: two
   windows aligned with themselves and one window pair per run; the
   delta body must equal the reference's.
9c. ``align_self`` with break_len 8192 on a 1 Mbp genome whose four
   planted copies each hold a random 5 kb island (``self_island_genome``)
   twice: the entries must equal the reference's, with its 6 long
   segments per run on K1 and K2.
10. The realistic fixture through ``align -sequential -duplications``
   twice: the MAF, its 306 dup blocks included, must equal the
   reference's sha256.

11. The concurrent executor (``align`` without ``-sequential``, four
   worker threads sharing the card, pairs in chunks of 16):
11a. the family of phase 5 twice (first, warm): phase 5's digest, 28
   seeding dispatches a run on the card, native NW, no chunk degraded to
   the per-pair path;
11b. the realistic fixture with ``-refine`` twice: phase 6's digest, its
   151 long segments on K1/K2 with exactly 151 launches of each a run,
   launched from the merge workers;
11c. the realistic fixture with ``-refine -tmp_dir``: a first run, a
   resumed run (no seeding, no K1 or K2 launch) and a run after the store's
   ``nodes/`` is deleted (no seeding, 151 launches of each again), all
   at phase 6's digest.  Their walls print beside phases 5 and 6's.

12. ``mugsy -colinear`` on the realistic fixture over precomputed
   pairwise MAFs: the port's ``nucmer`` writes them on the card for 6 of
   its 10 genome pairs, then ``mugsy`` runs twice (first, warm): the
   reference's MAF digest, its seeding count for the 4 pairs not covered
   and its 151 long refine rows, each on K1 and K2.
13. ``align -distributed``: two ranks on this card, processes started
   with torchrun's environment (``RANK``, ``WORLD_SIZE``,
   ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and a timeout each,
   sharing a fresh ``-tmp_dir`` per run; each rank reports its own counts
   (`rank_main`).  Both ranks' MAFs must equal the reference's two-owner
   MAF (not phases 5 and 6's: ROADMAP queue C):
13a. the family of phase 5 at the executor's defaults, twice (first,
   warm): the store holds the 28 pairs once, with 28 seedings summed over
   the ranks;
13b. the realistic fixture with ``-refine``, twice: 151 K1 and 151 K2
   launches summed over the ranks;
13c. ``sge`` as one process on the realistic fixture with ``-refine
   -tmp_dir`` and the SGE-only flags: phase 6's digest.  Each rank's wall
   and the slower rank's print beside 11a's and 11b's.

14. The sharded data plane (``paramugsy_tpu_torch.parallel``) in a
   torch.distributed world of this process alone, NCCL on the card with
   a gloo side group (`one_rank_world`), each part at the digest of the
   reference's output:
14a. the multi-device dry run's pair step on 16 x 2048 pairs, gathered
   through the NCCL group, and its distance step on 8 x 1024 0/1
   sketches (an exact Jaccard matrix);
14b. ``align_fastas_sharded`` on the family of phase 5 twice (first,
   warm): phase 5's digest, its 28 rows seeded in one batch;
14c. the realistic fixture with refinement twice: phase 6's digest, the
   CPU rehearsal's 33 seedings, and 151 K1 and 151 K2 launches a run
   (printed as predicted before the runs);
14d. the windowed pair of phase 7 twice: its 4 window pairs as rows of
   one 4 Mbp bucket, with the reckoned and the measured peak device
   memory;
14e. the compile check's single-pair step (``find_seeds`` +
   ``cluster_seeds`` on a 2^15 pair).  14b's walls print beside 11a's
   and 13a's.

15. The host-only commands (``profiles`` and the MAF and delta tools:
   host code, as in the reference, with no kernel of their own), each
   step's exit codes, stdout and output files held against the
   reference's digest (`HOST_TOOLS_SHA256`):
15a. ``mafstat``, ``mafvalidate``, ``mafdefrag -synchain``, ``maffiller``
   (given the genomes' FASTA files), ``analyzer``, ``mafclean`` and
   ``profiles maf_to_xmfa`` on phase 5's family MAF and on phase 6's
   ``-refine`` MAF, then ``sortdelta`` on phase 3's delta and ``fastafmt``
   on its reference FASTA (`host_tool_steps`);
15b. the profile toolchain of a tree merge over the family's halves q0-q3
   and q4-q7 (`profile_chain_steps`): ``align -sequential`` of each on the
   card, ``profiles make`` of each MAF, ``nucmer`` on the card for the 16
   cross pairs, ``profiles translate`` of their deltas, the MAF of the
   translated entries as the merge step makes it, ``profiles
   untranslate`` of it and ``mafvalidate`` of the result.  The steps'
   host walls print beside the card's name and power limit.

Launch counters are zeroed before each path (phases 3-4 together, 2b's
entry points, 5, 6, 7-8 together, 9-10 together, 11, 12, 13, 14 and 15) and
read after it; phase 13 adds the launches that its ranks report.  The script
imports only the port (``paramugsy_tpu_torch``), never JAX or the JAX
package directly.  Without
a CUDA device it exits 2.  ``python3 chip_smoke.py --wavefront`` runs
phases 1 and 2a only (a quick check after an edit of K1 or K2);
``--banded`` runs phases 1 and 2b only (after an edit of K3/K4);
``--sharded`` runs phases 1 and 14 only; ``--sharded-ranks`` runs
phase 1, 14b in one process, and 14b by 2 and by 4 ranks of an NCCL
world, one card each (on a machine with four cards), with 14a's steps
gathered and all-reduced across them (`run_sharded_ranks`);
``--profile`` runs phase 1 and traced runs of
phases 6, 5, 11a, 13a (rank 0's second run), 14b, 7, 8, 9, 9b, 9c and 10
(device time per kernel, busy share).
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

# The self-alignment path (align_self), digests computed as above at
# commit edf32b7: the reference's ``repeats`` CLI on `repeats_genome`
# (phase 9; delta body and MAF) and on `windowed_self_genome` (9b, over
# the 4 Mbp window), its align_self + DeltaWriter on `self_island_genome`
# with break_len 8192 (9c), and its ``align -sequential -duplications`` on
# the realistic fixture (10).  The port counts one repeat-seeding dispatch
# per self alignment (a contig or a window); the reference counts none,
# and its pair-seeding counts are given beside.
REPEATS_BP = 2_000_000
REPEATS_DELTA_SHA256 = (
    "c489945a292cd9b10b2b6a8b33c1f6039db3fad1e4f462a008e326a6d589acce"
)
REPEATS_MAF_SHA256 = (
    "bf7074b19bc2ac6aa8dfbe9867badd52d729f3cef6aca34cfdea94c7c681ebaf"
)
REPEATS_ENTRIES = 8
WINDOWED_SELF_BP = 4_641_652  # the length of E. coli K-12 MG1655's chromosome
WINDOWED_SELF_DELTA_SHA256 = (
    "344c6d2eda01885a85688325a11e93bb4b369f5d18450dca302cdf33416456f9"
)
# Two windows aligned with themselves, one window pair; 4 of the 6
# planted pairs come out (`windowed_self_genome` says which are lost).
WINDOWED_SELF_ENGINES = {"repeatcluster": 2, "seedcluster": 1}
WINDOWED_SELF_ENTRIES = 4
SELF_ISLAND_BP = 1_000_000
# The self path seeds unsampled, so its parts split at cfg.break_len
# itself (the pair path's 2048 becomes 8192 through its sample shift):
# islands of 5 kb stay inside one chain only under a break_len above that.
SELF_ISLAND_BREAK_LEN = 8192
SELF_ISLAND_DELTA_SHA256 = (
    "7404265b716cb28d267acbcffca3127ca51a8a75b0ba6967a4c94f1653ab0f21"
)
SELF_ISLAND_LONG_SEGMENTS = 6  # the reference's native-banded segments per run
DUPLICATIONS_MAF_SHA256 = (
    "1fa608aaf2cac93b143d6f95e7488e085a6871dc6c0a761f2ac36bccbf9f228c"
)
DUPLICATIONS_ENGINES = {"repeatcluster": 8, "seedcluster": 29}  # 8 contigs
DUPLICATIONS_DUP_BLOCKS = 306
# Phase 12, ``mugsy -colinear`` on the realistic fixture over the
# pairwise MAFs of its first 6 genome pairs (``itertools.combinations``
# of the sorted paths, the reference's ``nucmer -out_maf`` on each): the
# reference's MAF digest, its seedings of the 4 pairs not covered (10
# contig pairs) and its native-banded refine rows, computed as above at
# commit 7130a24.  The pooled pairs give the deltas that ``align`` computes
# for them, so the MAF is phase 6's.
MUGSY_COVERED_PAIRS = 6
MUGSY_MAF_SHA256 = REALISTIC_MAF_SHA256
MUGSY_SEEDCLUSTER = 10
MUGSY_LONG_SEGMENTS = 151
# Phase 13, ``align -distributed`` by two ranks at the executor's defaults:
# sha256 of the MAF that the reference's executor writes as two owners of
# one store (`align_fastas_concurrent` with process_index 0 and 1 of 2, in
# two threads started together, JAX_PLATFORMS=cpu, commit 7130a24), on the
# family of phase 5 (13a) and the realistic fixture with -refine (13b).
# They are not phases 5 and 6's digests: a merge's pair deltas come owned
# pairs first, then the pairs waited for, and the merge depends on their
# order (ROADMAP queue C).  Summed over the owners the reference seeded
# the family's 28 pairs once each and sent 151 refine rows to its host
# banded engine.
DISTRIBUTED_FAMILY_MAF_SHA256 = (
    "682d27960b5822a08f0f2e1a2a4b98cbae294f3111affaa5318ea9dee79f451d"
)
DISTRIBUTED_REALISTIC_MAF_SHA256 = (
    "ab20be930bff05a07643803af320fb433ae9e3e798208a542aa203993d797d0c"
)
# Phase 14, the sharded data plane (paramugsy_tpu.parallel), digests of
# the reference's outputs on the CPU with eight forced host devices,
# computed at commit 3075b5b: its dry run's pair step on `graft_pair_batch`
# over an 8-device ``pairs`` mesh (the int32 fields of PAIR_FIELDS, in
# order; `arrays_sha256`) and its distance step over a 1 x 8 ``kdim`` mesh
# (the float32 matrix); its compile check's step on `graft_entry_pair`
# (14e); and the MAFs of its ``align_fastas_sharded`` on the family of
# phase 5 (14b), the realistic fixture with refine (14c: phase 6's digest
# and its 151 long refine segments) and the windowed pair of phase 7
# (14d).  14b's reference ran its batch two pairs at a time and 14d's on
# one device: every row of those inputs has one bucket, so a row's
# result does not depend on the rows beside it.  The seedings are the
# port's CPU rehearsal of the same runs (one per batch row, plus any
# single-pair retry).
SHARDED_PAIR_STEP_SHA256 = (
    "050844786ba4cac3c346e77c51bd2ef58741b99f50a973646e9f7e77bf4d5e4e"
)
SHARDED_DISTANCE_SHA256 = (
    "8e887dda6264e01d90ef82130717703917b5ac1124c618c3fc59a5b2927ed248"
)
GRAFT_ENTRY_SHA256 = (
    "122657be7006874370f4ff8cb981f1f1d690bc09ed9cce7c79d1f2aefd9ee8ca"
)
SHARDED_REALISTIC_MAF_SHA256 = REALISTIC_MAF_SHA256
SHARDED_REALISTIC_SEEDCLUSTER = 33
SHARDED_WINDOWED_MAF_SHA256 = (
    "05e431e2e80107a565e507c00e703492eacdc814305d9684a54d15b2c8771df4"
)
# Phase 15, the host-only commands: sha256 over each step's exit codes,
# stdout and output files (`_host_step`), as the reference's commands give
# them (JAX_PLATFORMS=cpu, commit 27e3f0c) on the reference's own outputs
# of phases 3, 5 and 6, which equal the port's (their digests above), and
# on the halves q0-q3 and q4-q7 of phase 5's family (`profile_chain_steps`:
# the reference's align and nucmer on the CPU).  Its family and -refine
# MAFs tile every genome, so mafvalidate finds no fault and maffiller adds
# no block; the merge step keeps 14 translated entries.
HOST_TOOLS_SHA256 = {
    "family/mafstat": "a8046cd108b5a7cbc1e862f83a67e2f238b5c308a587bccf1413cb705111cb04",
    "family/mafvalidate": "c14196f132c1e9be0508ae80ab52fcb3e1d3fc05880415f3dc980971df207c9e",
    "family/mafdefrag": "3f23f66307aab84b10b91aa503c524bda7357c49ab32e2a666a11a35c75532aa",
    "family/maffiller": "27fcf33b04ab67e3301ae1310c2826d1523cb78f81237e67e61253958e38ba31",
    "family/analyzer": "e83db9e959e3b910ffcb8b54feb4ce8abc9f55411a6d6b21925acf250c2b75d2",
    "family/mafclean": "27fcf33b04ab67e3301ae1310c2826d1523cb78f81237e67e61253958e38ba31",
    "family/maf_to_xmfa": "34a0adc314f8f0eba5412ea84b89297ac7e401002673be5f6d3cc06e71edfc30",
    "realistic/mafstat": "1f091ec2e39e9fb9ab807b27e6037c40e2dfbd91a416ed7f4e1fd1c99f318887",
    "realistic/mafvalidate": "c14196f132c1e9be0508ae80ab52fcb3e1d3fc05880415f3dc980971df207c9e",
    "realistic/mafdefrag": "967a3eed165e80aa8f8e509df318c06b25330b40431a22cdef40fd679ea5b88b",
    "realistic/maffiller": "71f65bcc027242dd98cea1272bc421736b9a7dfa61fa5d052251a86206e1e0fe",
    "realistic/analyzer": "e83db9e959e3b910ffcb8b54feb4ce8abc9f55411a6d6b21925acf250c2b75d2",
    "realistic/mafclean": "71f65bcc027242dd98cea1272bc421736b9a7dfa61fa5d052251a86206e1e0fe",
    "realistic/maf_to_xmfa": "24cd2a0eab1d35552802752cdeaab083fc8b7fc4affbdd677f1ef069e2bcbaaa",
    "headline/sortdelta": "e406ae9508f6a6c6bc57641dd950dd4d9b52fe2db53a90721df78426efde5d77",
    "headline/fastafmt": "78bc5499afcd5555a19fd06dbf478f7247563e64a1188ab202ed3381987d5ab6",
    "profiles/align_left": "4ffee67433293d9bf51fc8f2fdb5ee1b90c6b66ec3f4724da8c3552caef74595",
    "profiles/make_left": "cd1a4f637edb3c61fd61282a5edd00ccda2febc1d1841bd12610351003f0732b",
    "profiles/align_right": "1302ab20228f858aa98f3de3a0724a720798cb6f5d5440715ead53b6957116c9",
    "profiles/make_right": "2adfede7e2d4444778fa208e3469fad033f8132d8ec2ab811b76919e461d1e86",
    "profiles/nucmer": "793db7f08968b9f58b3a1c5e903811fee72574f6fb55c4eb53241d750b42d8bd",
    "profiles/translate": "9e15973f247314961ff6daae0eebb335eb5cdc89bd635e862d1bac4624a89722",
    "profiles/merge_maf": "e30ddc15ea1eb9b4d2cdbb5c03370f4bc32816a3bc72df3c4bf022104a6d303b",
    "profiles/untranslate": "3f511162eba2086135265138fea90fe3dcc213f6a2325fc1bbb685bcfa3196f9",
    "profiles/mafvalidate": "618f92a8f9501dfb5dff7c847d15d653771c868e2a44890c5129d16cd1c70d1e",
}
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
    return tuple(
        write_fasta(os.path.join(directory, f"{name}.fa"), f"{name}.chr", codes)
        for name, codes in (("smoke_ref", ref), ("smoke_qry", query))
    )


def windowed_config(directory: str) -> str:
    """Write the ``-config`` file of the windowed family (1 Mbp windows,
    64 kb overlap); returns its path."""
    path = os.path.join(directory, "windowed.json")
    with open(path, "w") as f:
        json.dump({"align": MBP_WINDOW}, f)
    return path


def graft_pair_batch(n_slots: int = 8):
    """The multi-device dry run's inputs (``__graft_entry__``'s
    ``dryrun_multichip`` recipe for `n_slots` devices): a pair batch of
    ``2 * n_slots`` random 2048 bp refs with their queries rotated by 256,
    and eight 0/1 sketches of ``128 * n_slots`` columns, from one
    ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    n = 2048
    refs = rng.integers(0, 4, size=(2 * n_slots, n)).astype(np.int8)
    queries = np.roll(refs, n // 8, axis=1)
    sketches = (rng.random((8, 128 * n_slots)) < 0.1).astype(np.float32)
    return refs, queries, sketches


def graft_entry_pair():
    """The single-pair compile check's input (``__graft_entry__``'s
    ``entry``): 2^15 random bases and the same rotated by a quarter."""
    n = 1 << 15
    ref = np.random.default_rng(0).integers(0, 4, size=n).astype(np.int8)
    return ref, np.concatenate([ref[n // 4 :], ref[: n // 4]])


def arrays_sha256(arrays, dtype=np.int32) -> str:
    """sha256 over the arrays' values as `dtype`, in order."""
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a).astype(dtype)).tobytes())
    return h.hexdigest()


def island_pair(n: int = HEADLINE_BP, n_islands: int = 4, length: int = 5000):
    """A bench-style pair whose query has `n_islands` windows of random
    sequence: each leaves an inter-anchor segment longer than 4096 bp."""
    rng = np.random.default_rng(2026)
    ref, query = build_pair(rng, n)
    query = query.copy()
    for s in np.linspace(n // 10, n - n // 10, n_islands).astype(int):
        query[s : s + length] = rng.integers(0, 4, length)
    return ref, query


def plant_copies(g: np.ndarray, plants) -> np.ndarray:
    """Copy ``g[src:src + length]`` onto ``dst`` for each (src, dst,
    length, inverted) in order; an inverted copy is the reverse
    complement."""
    g = g.copy()
    for src, dst, length, inverted in plants:
        piece = g[src : src + length]
        g[dst : dst + length] = (3 - piece)[::-1] if inverted else piece
    return g


def repeats_genome(n: int = REPEATS_BP) -> np.ndarray:
    """Phase 9's genome: `n` random bases (seed 31) with eight 5 kb
    segmental duplications, every other one inverted; sources in the
    first half, copies in the second."""
    g = np.random.default_rng(31).integers(0, 4, size=n).astype(np.int8)
    half = n // 2
    plants = [
        (half // 8 * i + 1000, half + half // 8 * i + 3000, 5000, i % 2 == 1)
        for i in range(8)
    ]
    return plant_copies(g, plants)


def windowed_self_genome(n: int = WINDOWED_SELF_BP) -> np.ndarray:
    """Phase 9b's genome, at E. coli K-12 MG1655's length: random bases
    (seed 32) with 5 kb duplications placed against the default windows
    (`AlignConfig.window` 4 Mbp, overlap 128 kb: window 0 is [0,
    4,128,768), window 1 [3,997,696, n), the core split 4,063,232):
    two pairs inside window 0's core (one inverted), two across the
    windows (one inverted), one copy straddling the core split, and a
    pair with both copies inside the overlap.

    The reference reports four of the six: the straddling copy's entry
    ends one base past the split, so window 0's self call drops it by its
    midpoint, and the window pair cannot seed it (its source recurs in
    window 0, so its k-mers are not unique in that window); the pair in
    the overlap falls outside one core in each self call and recurs in
    window 0 for the window pair."""
    g = np.random.default_rng(32).integers(0, 4, size=n).astype(np.int8)
    plants = [
        (500_000, 1_500_000, 5000, False),
        (800_000, 2_500_000, 5000, True),
        (1_000_000, 4_400_000, 5000, False),
        (2_000_000, 4_500_000, 5000, True),
        (3_000_000, 4_060_732, 5000, False),
        (4_000_000, 4_100_000, 5000, False),
    ]
    return plant_copies(g, plants)


def self_island_genome(
    n: int = SELF_ISLAND_BP, n_copies: int = 4, length: int = 20_000,
    island: int = 5000, seed: int = 33,
) -> np.ndarray:
    """Random bases with `n_copies` planted duplications of `length` bp
    (every other one inverted), each copy's middle `island` bp replaced
    by random bases: under a break_len over `island`, each leaves one
    inter-anchor segment of about `island` bp a side."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, size=n).astype(np.int8)
    step = n // (2 * n_copies)
    plants = [
        (step * i + 100, n // 2 + step * i + 200, length, i % 2 == 1)
        for i in range(n_copies)
    ]
    g = plant_copies(g, plants)
    for _, dst, _, _ in plants:
        mid = dst + (length - island) // 2
        g[mid : mid + island] = rng.integers(0, 4, size=island)
    return g


def write_fasta(path: str, name: str, codes: np.ndarray) -> str:
    """One record of int8 codes as FASTA; returns `path`."""
    with open(path, "w") as f:
        f.write(f">{name}\n")
        f.write(np.frombuffer(b"ACGT", np.uint8)[codes].tobytes().decode())
        f.write("\n")
    return path


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


def headline_phase(device, keep: str) -> dict:
    """The bench pair through the nucmer CLI: one warm-up, best of 3.  The
    delta and the reference FASTA are copied to `keep` for phase 15."""
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
        shutil.copy(out, os.path.join(keep, "headline.delta"))
        shutil.copy(ref_fa, os.path.join(keep, "smoke_ref.fa"))
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


def _align_run(name: str, argv: list, out: str, digest: str) -> dict:
    """One CLI run that writes a MAF (``align``, ``sge``, ``mugsy``): its
    wall, engine counts, K1/K2 launches, phase times and the MAF digest
    check."""
    import torch

    from paramugsy_tpu_torch import cli
    from paramugsy_tpu_torch.ops import engines
    from paramugsy_tpu_torch.pipeline import METRICS

    METRICS.phases.clear()
    before = dict(engines.COUNTS)
    launches = _launch_counts()
    t0 = time.perf_counter()
    if cli.main(argv) != 0:
        raise AssertionError(f"{name}: {argv[0]} CLI failed")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if file_sha256(out) != digest:
        raise AssertionError(f"{name}: MAF differs from the JAX reference")
    print(METRICS.report(), flush=True)
    return {
        "wall_s": wall,
        "engines": _engine_delta(before),
        "launches": {k: v - launches[k] for k, v in _launch_counts().items()},
        "phases_s": {k: v.total_s for k, v in sorted(METRICS.phases.items())},
    }


def _align_runs(name: str, argv: list, out: str, digest: str) -> list:
    """`cli align` twice on the same inputs (first, warm): `_align_run`'s
    row of each."""
    return [_align_run(name, argv, out, digest) for _ in range(2)]


def family_phase(device, keep: str) -> dict:
    """The 8 x 2 Mbp family through ``align -sequential`` (first, warm).
    Its FASTA files and MAF are copied to `keep` for phase 15."""
    with tempfile.TemporaryDirectory() as tmp:
        paths = family_fastas(tmp, FAMILY_BP, FAMILY_COUNT)
        out = os.path.join(tmp, "family.maf")
        argv = ["align", "-sequential", *paths, "-out_maf", out, "-device", device.type]
        runs = _align_runs("family", argv, out, FAMILY_MAF_SHA256)
        os.makedirs(os.path.join(keep, "family"))
        for path in paths:
            shutil.copy(path, os.path.join(keep, "family"))
        shutil.copy(out, os.path.join(keep, "family.maf"))
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


def _realistic_paths() -> list:
    import glob

    paths = sorted(glob.glob(os.path.join(ROOT, "tests", "data", "realistic", "*.fa")))
    if len(paths) != 5:
        raise AssertionError(f"realistic fixture: {len(paths)} FASTA files, expected 5")
    return paths


def realistic_phase(device, keep: str) -> dict:
    """The realistic fixture through ``align -sequential -refine`` (first,
    warm): every long refine segment on K1/K2.  The MAF is copied to
    `keep` for phase 15."""
    paths = _realistic_paths()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "realistic.maf")
        argv = [
            "align", "-sequential", *paths, "-refine", "-out_maf", out,
            "-device", device.type,
        ]
        runs = _align_runs("realistic", argv, out, REALISTIC_MAF_SHA256)
        shutil.copy(out, os.path.join(keep, "realistic.maf"))
    for r in runs:
        if r["engines"].get("device-wavefront") != REALISTIC_LONG_SEGMENTS:
            raise AssertionError(
                f"realistic: {r['engines']}; expected {REALISTIC_LONG_SEGMENTS} "
                "long segments on the wavefront kernels"
            )
    row = {"genomes": len(paths), "first": runs[0], "warm": runs[1]}
    print("realistic", json.dumps(row), flush=True)
    return row


def _executor_argv(paths: list, out: str, device) -> list:
    """``align`` on the concurrent executor at its defaults, spelled out."""
    return [
        "align", *paths, "-run_size", "4", "-nucmer_chunk_size", "16",
        "-out_maf", out, "-device", device.type,
    ]


def _check_no_degrade(name: str, runs: list) -> None:
    for r in runs:
        if "executor-degrade" in r["engines"]:
            raise AssertionError(f"{name}: a pair chunk degraded to per-pair: {r}")


def _check_refine_run(name: str, r: dict) -> None:
    """Every long refine segment on K1/K2, one K1 and one K2 launch each
    (refinement aligns them one at a time)."""
    want = {"wavefront_dp": REALISTIC_LONG_SEGMENTS,
            "wavefront_traceback": REALISTIC_LONG_SEGMENTS}
    if r["engines"].get("device-wavefront") != REALISTIC_LONG_SEGMENTS or r["launches"] != want:
        raise AssertionError(
            f"{name}: {r['engines']}, launches {r['launches']}; expected "
            f"{REALISTIC_LONG_SEGMENTS} long segments and launches of each kernel"
        )


def executor_family_phase(device) -> dict:
    """11a: the 8 x 2 Mbp family through ``align`` on the concurrent
    executor (first, warm): phase 5's digest and seeding count, from four
    worker threads."""
    with tempfile.TemporaryDirectory() as tmp:
        paths = family_fastas(tmp, FAMILY_BP, FAMILY_COUNT)
        out = os.path.join(tmp, "family.maf")
        runs = _align_runs("executor_family", _executor_argv(paths, out, device), out,
                           FAMILY_MAF_SHA256)
    for r in runs:
        if r["engines"].get(f"seedcluster-{device.type}") != FAMILY_SEEDCLUSTER:
            raise AssertionError(
                f"executor_family: seeding dispatched {r['engines']}, expected "
                f"{FAMILY_SEEDCLUSTER}"
            )
        if not r["engines"].get("native-nw") or "numpy-nw" in r["engines"]:
            raise AssertionError(f"executor_family: segments did not run on native NW: {r}")
    _check_no_degrade("executor_family", runs)
    row = {"genomes": FAMILY_COUNT, "bp": FAMILY_BP, "first": runs[0], "warm": runs[1]}
    print("executor_family", json.dumps(row), flush=True)
    return row


def executor_realistic_phase(device) -> dict:
    """11b: the realistic fixture through ``align -refine`` on the
    concurrent executor (first, warm): phase 6's digest, with the long
    refine segments on K1/K2 launched from the merge workers."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "realistic.maf")
        argv = _executor_argv(_realistic_paths(), out, device) + ["-refine"]
        runs = _align_runs("executor_realistic", argv, out, REALISTIC_MAF_SHA256)
    for r in runs:
        _check_refine_run("executor_realistic", r)
    _check_no_degrade("executor_realistic", runs)
    row = {"genomes": 5, "first": runs[0], "warm": runs[1]}
    print("executor_realistic", json.dumps(row), flush=True)
    return row


def executor_resume_phase(device) -> dict:
    """11c: the realistic fixture through ``align -refine -tmp_dir``: a
    first run, a resumed one (no seeding, no K1/K2: every merge loads from
    the store) and one after ``nodes/`` is deleted (no seeding; the merges,
    K1/K2 included, run again), all at phase 6's digest."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "realistic.maf")
        store = os.path.join(tmp, "store")
        argv = _executor_argv(_realistic_paths(), out, device) + ["-refine", "-tmp_dir", store]
        first = _align_run("executor_resume", argv, out, REALISTIC_MAF_SHA256)
        resumed = _align_run("executor_resume", argv, out, REALISTIC_MAF_SHA256)
        n_pairs = len(os.listdir(os.path.join(store, "pairs")))
        nodes = os.path.join(store, "nodes")
        n_nodes = len(os.listdir(nodes))
        for name in os.listdir(nodes):
            os.remove(os.path.join(nodes, name))
        remerged = _align_run("executor_resume", argv, out, REALISTIC_MAF_SHA256)
    _check_refine_run("executor_resume first", first)
    seeded = f"seedcluster-{device.type}"
    if seeded in resumed["engines"] or any(resumed["launches"].values()):
        raise AssertionError(f"executor_resume: the resumed run computed: {resumed}")
    if seeded in remerged["engines"]:
        raise AssertionError(f"executor_resume: pairs seeded again after nodes/ went: {remerged}")
    _check_refine_run("executor_resume remerged", remerged)
    _check_no_degrade("executor_resume", [first, resumed, remerged])
    row = {"pairs": n_pairs, "nodes": n_nodes, "first": first, "resumed": resumed,
           "remerged": remerged}
    print("executor_resume", json.dumps(row), flush=True)
    return row


def print_executor_walls(smi: str, family: dict, realistic: dict, executor: dict) -> None:
    """Phase 11's walls, first and warm in seconds, each path on its own
    line beside the sequential runs of the same inputs (phases 5 and 6)."""
    def walls(row):
        return [row["first"]["wall_s"], row["warm"]["wall_s"]]

    for name, row in (
        ("family", {"sequential": walls(family), "executor": walls(executor["family"])}),
        ("realistic_refine", {
            "sequential": walls(realistic), "executor": walls(executor["realistic"]),
        }),
        ("realistic_refine_tmp_dir", {
            "first_resumed_remerged": [
                executor["resume"][k]["wall_s"] for k in ("first", "resumed", "remerged")
            ],
        }),
    ):
        print("executor_walls", json.dumps({"path": name, "card": smi, **row}), flush=True)


def mugsy_phase(device) -> dict:
    """12: ``mugsy -colinear`` on the realistic fixture over pairwise MAFs
    that the port's ``nucmer`` writes on the card for the first
    MUGSY_COVERED_PAIRS of its 10 genome pairs (first, warm): the
    reference's MAF, the other 4 pairs seeded on the card as often as the
    reference seeded them, and every long refine row on K1/K2."""
    import itertools

    from paramugsy_tpu_torch import cli

    paths = _realistic_paths()
    with tempfile.TemporaryDirectory() as tmp:
        mafs = []
        for i, (a, b) in enumerate(itertools.combinations(paths, 2)):
            if i == MUGSY_COVERED_PAIRS:
                break
            mafs.append(os.path.join(tmp, f"pair{i}.maf"))
            argv = ["nucmer", "-ref_seq", a, "-query_seq", b, "-out_maf", mafs[-1],
                    "-device", device.type]
            if cli.main(argv) != 0:
                raise AssertionError(f"mugsy: nucmer of {a} and {b} failed")
        lists = {}
        for name, items in (("seqs", paths), ("mafs", mafs)):
            lists[name] = os.path.join(tmp, f"{name}.list")
            with open(lists[name], "w") as f:
                f.write("\n".join(items) + "\n")
        out_dir = os.path.join(tmp, "out")
        argv = ["mugsy", "-out_dir", out_dir, "-seq_list", lists["seqs"],
                "-maf_list", lists["mafs"], "-colinear", "-device", device.type]
        runs = _align_runs("mugsy", argv, os.path.join(out_dir, "mugsy.maf"),
                           MUGSY_MAF_SHA256)
    want = {"wavefront_dp": MUGSY_LONG_SEGMENTS, "wavefront_traceback": MUGSY_LONG_SEGMENTS}
    for r in runs:
        if (r["engines"].get(f"seedcluster-{device.type}") != MUGSY_SEEDCLUSTER
                or r["engines"].get("device-wavefront") != MUGSY_LONG_SEGMENTS
                or r["launches"] != want):
            raise AssertionError(
                f"mugsy: {r['engines']}, launches {r['launches']}; expected "
                f"{MUGSY_SEEDCLUSTER} seedings and {MUGSY_LONG_SEGMENTS} long rows "
                "on K1/K2 (the reference's counts)"
            )
    row = {"genomes": len(paths), "covered_pairs": MUGSY_COVERED_PAIRS,
           "first": runs[0], "warm": runs[1]}
    print("mugsy", json.dumps(row), flush=True)
    return row


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_main(spec_json: str) -> int:
    """One rank of phase 13, a process that `run_ranks` starts with
    torchrun's environment: after setting up the card and the libraries,
    each run of ``spec["runs"]`` is one ``cli.main(run["argv"])`` (a world
    of its own, rendezvoused on ``run["port"]``), traced when
    ``run["trace"]``.  Prints a ``rank_run`` JSON line per run: its wall
    and its own engine counts and K1/K2 launches."""
    import torch

    from paramugsy_tpu_torch import cli
    from paramugsy_tpu_torch.ops import _kernels, engines, native
    from paramugsy_tpu_torch.pipeline import METRICS

    spec = json.loads(spec_json)
    torch.zeros(1, device="cuda")
    _kernels.library()
    native.load()
    for i, run in enumerate(spec["runs"]):
        os.environ["MASTER_PORT"] = str(run["port"])
        METRICS.phases.clear()
        before = dict(engines.COUNTS)
        launches = _launch_counts()
        rc = []
        t0 = time.perf_counter()
        if run.get("trace"):
            traced = _traced(lambda: rc.append(cli.main(run["argv"])))
        else:
            rc.append(cli.main(run["argv"]))
            torch.cuda.synchronize()
            traced = None
        row = {
            "rank": int(os.environ["RANK"]), "run": i, "rc": rc[0],
            "wall_s": time.perf_counter() - t0,
            "engines": _engine_delta(before),
            "launches": {k: v - launches[k] for k, v in _launch_counts().items()},
            "phases_s": {k: v.total_s for k, v in sorted(METRICS.phases.items())},
            "profile": traced,
        }
        print("rank_run", json.dumps(row), flush=True)
        if rc[0] != 0:
            return rc[0]
    return 0


def run_ranks(runs_of: list, timeout: float) -> list:
    """Phase 13's world: one process per entry of `runs_of` (rank i runs
    ``runs_of[i]``, see `rank_main`), all on this card, each with
    torchrun's environment and `timeout` seconds.  A rank that exits
    non-zero or times out fails the phase, and every rank is stopped.
    Returns each rank's ``rank_run`` rows and its process wall."""
    procs = []
    try:
        for rank, runs in enumerate(runs_of):
            env = dict(
                os.environ, PYTHONPATH=ROOT, RANK=str(rank), LOCAL_RANK=str(rank),
                WORLD_SIZE=str(len(runs_of)), MASTER_ADDR="127.0.0.1",
            )
            cmd = [sys.executable, "-c",
                   "import sys, chip_smoke; sys.exit(chip_smoke.rank_main(sys.argv[1]))",
                   json.dumps({"runs": runs})]
            procs.append((time.perf_counter(), subprocess.Popen(
                cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True,
            )))
        results = []
        for rank, (t0, p) in enumerate(procs):
            try:
                out, err = p.communicate(timeout=max(1.0, t0 + timeout - time.perf_counter()))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"rank {rank} timed out after {timeout} s")
            wall = time.perf_counter() - t0
            if p.returncode != 0:
                raise AssertionError(f"rank {rank} exited {p.returncode}:\n{err[-4000:]}")
            rows = [json.loads(line.split(" ", 1)[1]) for line in out.splitlines()
                    if line.startswith("rank_run ")]
            if len(rows) != len(runs_of[rank]):
                raise AssertionError(f"rank {rank} reported {len(rows)} runs:\n{out[-4000:]}")
            results.append({"rows": rows, "process_wall_s": wall})
        return results
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _distributed_runs(name: str, argv_of, digest: str, n_runs: int = 2,
                      trace_rank0_last: bool = False) -> list:
    """`n_runs` runs of ``align -distributed`` by two ranks on this card,
    each run with a fresh shared ``-tmp_dir`` and its own port; both
    ranks' MAFs must be at `digest`.  ``argv_of(out, store)`` builds a
    rank's argv.  Returns per run: each rank's row, the summed counts, the
    slower rank's wall and the store's pairs."""
    with tempfile.TemporaryDirectory() as tmp:
        plan = []
        for i in range(n_runs):
            store = os.path.join(tmp, f"store{i}")
            outs = [os.path.join(tmp, f"rank{r}_run{i}.maf") for r in (0, 1)]
            plan.append((store, outs, _free_port()))
        results = run_ranks(
            [[{"argv": argv_of(outs[r], store), "port": port,
               "trace": trace_rank0_last and r == 0 and i == n_runs - 1}
              for i, (store, outs, port) in enumerate(plan)] for r in (0, 1)],
            timeout=300,
        )
        runs = []
        for i, (store, outs, _) in enumerate(plan):
            for r in (0, 1):
                if file_sha256(outs[r]) != digest:
                    raise AssertionError(f"{name}: rank {r}'s MAF of run {i} differs "
                                         "from the JAX reference")
            rows = [results[r]["rows"][i] for r in (0, 1)]
            summed = {}
            for key in ("engines", "launches"):
                summed[key] = {}
                for row in rows:
                    for k, v in row[key].items():
                        summed[key][k] = summed[key].get(k, 0) + v
            runs.append({
                "ranks": rows, "summed": summed,
                "slower_wall_s": max(row["wall_s"] for row in rows),
                "pairs": sorted(os.listdir(os.path.join(store, "pairs"))),
            })
    print(name, "process_walls_s", json.dumps([r["process_wall_s"] for r in results]),
          flush=True)
    return runs


def distributed_family_phase(device) -> dict:
    """13a: the 8 x 2 Mbp family through ``align -distributed`` at the
    executor's defaults, two ranks (first, warm): the reference's
    two-owner digest on both, the 28 pairs once in the store, 28 seedings
    summed over the ranks as they report them."""
    with tempfile.TemporaryDirectory() as tmp:
        paths = family_fastas(tmp, FAMILY_BP, FAMILY_COUNT)
        runs = _distributed_runs(
            "distributed_family",
            lambda out, store: _executor_argv(paths, out, device)
            + ["-distributed", "-tmp_dir", store],
            DISTRIBUTED_FAMILY_MAF_SHA256,
        )
    for r in runs:
        seeded = r["summed"]["engines"].get(f"seedcluster-{device.type}")
        if len(r["pairs"]) != FAMILY_SEEDCLUSTER or seeded != FAMILY_SEEDCLUSTER:
            raise AssertionError(
                f"distributed_family: {len(r['pairs'])} pairs in the store, {seeded} "
                f"seedings summed; expected {FAMILY_SEEDCLUSTER} of each"
            )
        _check_no_degrade("distributed_family", [r["summed"]])
    row = {"genomes": FAMILY_COUNT, "bp": FAMILY_BP, "first": runs[0], "warm": runs[1]}
    print("distributed_family", json.dumps(row), flush=True)
    return row


def distributed_realistic_phase(device) -> dict:
    """13b: the realistic fixture through ``align -distributed -refine``,
    two ranks (first, warm): the reference's two-owner digest on both, and
    151 K1 and 151 K2 launches summed over the ranks (each merge runs on
    its owner)."""
    paths = _realistic_paths()
    runs = _distributed_runs(
        "distributed_realistic",
        lambda out, store: _executor_argv(paths, out, device)
        + ["-refine", "-distributed", "-tmp_dir", store],
        DISTRIBUTED_REALISTIC_MAF_SHA256,
    )
    for r in runs:
        _check_refine_run("distributed_realistic", r["summed"])
        _check_no_degrade("distributed_realistic", [r["summed"]])
    row = {"genomes": len(paths), "first": runs[0], "warm": runs[1]}
    print("distributed_realistic", json.dumps(row), flush=True)
    return row


def sge_phase(device) -> dict:
    """13c: ``sge`` as one process on the realistic fixture with
    ``-refine -tmp_dir`` and the SGE-only flags: phase 6's digest."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "realistic.maf")
        argv = ["sge", *_realistic_paths(), "-refine", "-tmp_dir", os.path.join(tmp, "store"),
                "-template_file", "/dev/null", "-exec_q", "all.q", "-data_q", "all.q",
                "-out_maf", out, "-device", device.type]
        r = _align_run("sge", argv, out, REALISTIC_MAF_SHA256)
    _check_refine_run("sge", r)
    print("sge", json.dumps(r), flush=True)
    return r


def print_distributed_walls(smi: str, executor: dict, distributed: dict) -> None:
    """Phase 13's walls, first and warm in seconds: each rank's and the
    slower rank's, beside phase 11's one-process executor on the same
    inputs; 13c's beside 11c's first run."""
    def walls(row, key="wall_s"):
        return [row["first"][key], row["warm"][key]]

    for name, ex, dist in (
        ("family", executor["family"], distributed["family"]),
        ("realistic_refine", executor["realistic"], distributed["realistic"]),
    ):
        print("distributed_walls", json.dumps({
            "path": name, "card": smi, "executor": walls(ex),
            "rank_walls": [[dist[k]["ranks"][r]["wall_s"] for k in ("first", "warm")]
                           for r in (0, 1)],
            "slower_rank": walls(dist, "slower_wall_s"),
        }), flush=True)
    print("distributed_walls", json.dumps({
        "path": "realistic_refine_tmp_dir", "card": smi,
        "executor_first": executor["resume"]["first"]["wall_s"],
        "sge": distributed["sge"]["wall_s"],
    }), flush=True)


class one_rank_world:
    """A torch.distributed world of this process alone on the card (NCCL,
    with its gloo side group), formed on entry from torchrun's environment
    (``MASTER_ADDR=127.0.0.1``, ``WORLD_SIZE=1``) and left on exit, the
    environment restored."""

    _ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        from paramugsy_tpu_torch.runtime import dist

        self.saved = {k: os.environ.get(k) for k in self._ENV}
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                          RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
        self.ctx = dist.init_distributed(device=self.device)
        return self.ctx

    def __exit__(self, *exc):
        from paramugsy_tpu_torch.runtime import dist

        dist.shutdown_distributed(self.ctx)
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return False


def graft_steps_phase(device) -> dict:
    """14a: the multi-device dry run's checks through the one-rank world:
    `make_sharded_pair_step` on `graft_pair_batch` (k 16, 1 << 10 seeds,
    128 clusters; the gather goes through NCCL) and
    `make_sharded_distance_step` on its 0/1 sketches, each at the
    reference's digest.  14e: the compile check's single-pair step
    (`find_seeds` + `cluster_seeds` on `graft_entry_pair`)."""
    import torch

    from paramugsy_tpu_torch.ops.chaining import cluster_seeds
    from paramugsy_tpu_torch.ops.seeding import find_seeds
    from paramugsy_tpu_torch.parallel.mesh import make_mesh
    from paramugsy_tpu_torch.parallel.pair_shard import (
        PAIR_FIELDS,
        make_sharded_distance_step,
        make_sharded_pair_step,
    )

    refs, queries, sketches = graft_pair_batch(8)
    mesh = make_mesh(devices=[device])
    step = make_sharded_pair_step(mesh, k=16, max_seeds=1 << 10, max_clusters=128)
    args = [torch.from_numpy(x).to(device) for x in (refs, queries)]
    out, pair_ms = _once_ms(lambda: step(*args))
    _, pair_warm_ms = _once_ms(lambda: step(*args))
    if arrays_sha256([out[f].cpu().numpy() for f in PAIR_FIELDS]) != SHARDED_PAIR_STEP_SHA256:
        raise AssertionError("14a: sharded pair step differs from the JAX reference")
    dstep = make_sharded_distance_step(mesh)
    sk = torch.from_numpy(sketches).to(device)
    jac, dist_ms = _once_ms(lambda: dstep(sk))
    if arrays_sha256([jac.cpu().numpy()], np.float32) != SHARDED_DISTANCE_SHA256:
        raise AssertionError("14a: sharded distance step differs from the JAX reference")
    ref, query = (torch.from_numpy(x).to(device) for x in graft_entry_pair())

    def entry():
        s = find_seeds(ref, query, k=16, max_seeds=1 << 14)
        cl = cluster_seeds(s.rpos, s.qpos, s.length, s.mask & (s.length >= 20),
                           max_clusters=1024)
        return [cl.c_rstart, cl.c_rend, cl.c_qstart, cl.c_qend, cl.c_weight,
                cl.c_mask, cl.n_clusters]

    got, entry_ms = _once_ms(entry)
    _, entry_warm_ms = _once_ms(entry)
    if arrays_sha256([x.cpu().numpy() for x in got]) != GRAFT_ENTRY_SHA256:
        raise AssertionError("14e: find_seeds + cluster_seeds differ from the JAX reference")
    row = {
        "pair_step_ms": [pair_ms, pair_warm_ms],
        "clusters": int(out["n_clusters"].sum()), "distance_ms": dist_ms,
        "entry_ms": [entry_ms, entry_warm_ms], "entry_clusters": int(got[6]),
    }
    print("sharded_graft", json.dumps(row), flush=True)
    return row


def _sharded_runs(name: str, paths: list, digest: str, cfg=None) -> list:
    """`align_fastas_sharded` on `paths` twice (first, warm), on the card
    through the one-rank world: each run's wall, engine counts, K1/K2
    launches, phase times and peak device memory; the MAF must be at
    `digest`."""
    import torch

    from paramugsy_tpu_torch.ops import engines
    from paramugsy_tpu_torch.parallel.collective import align_fastas_sharded
    from paramugsy_tpu_torch.pipeline import METRICS

    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, f"{name}.maf")
        for _ in range(2):
            METRICS.phases.clear()
            before = dict(engines.COUNTS)
            launches = _launch_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            align_fastas_sharded(paths, out, cfg=cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if file_sha256(out) != digest:
                raise AssertionError(f"{name}: MAF differs from the JAX reference")
            runs.append({
                "wall_s": wall,
                "engines": _engine_delta(before),
                "launches": {k: v - launches[k] for k, v in _launch_counts().items()},
                "phases_s": {k: v.total_s for k, v in sorted(METRICS.phases.items())},
                "peak_device_mb": torch.cuda.max_memory_allocated() / 2**20,
            })
    return runs


def _check_seedings(name: str, runs: list, want: int) -> None:
    for r in runs:
        if r["engines"].get("seedcluster-cuda") != want:
            raise AssertionError(f"{name}: seedings {r['engines']}, expected {want}")


def sharded_family_phase() -> dict:
    """14b: the 8 x 2 Mbp family through `align_fastas_sharded` (28 rows
    of one 2 Mbp bucket in one batch) at phase 5's digest."""
    with tempfile.TemporaryDirectory() as tmp:
        paths = family_fastas(tmp, FAMILY_BP, FAMILY_COUNT)
        runs = _sharded_runs("sharded_family", paths, FAMILY_MAF_SHA256)
    _check_seedings("sharded_family", runs, FAMILY_SEEDCLUSTER)
    row = {"genomes": FAMILY_COUNT, "bp": FAMILY_BP, "first": runs[0], "warm": runs[1]}
    print("sharded_family", json.dumps(row), flush=True)
    return row


def sharded_realistic_phase() -> dict:
    """14c: the realistic fixture through `align_fastas_sharded` with
    refinement at phase 6's digest: the CPU rehearsal's seedings, and its
    long refine segments as K1 and K2 launches."""
    from paramugsy_tpu_torch.pipeline import PipelineConfig

    print("sharded_realistic predicted", json.dumps({
        "seedcluster": SHARDED_REALISTIC_SEEDCLUSTER,
        "wavefront_dp": REALISTIC_LONG_SEGMENTS,
        "wavefront_traceback": REALISTIC_LONG_SEGMENTS,
    }), flush=True)
    runs = _sharded_runs("sharded_realistic", _realistic_paths(), SHARDED_REALISTIC_MAF_SHA256,
                         PipelineConfig(refine=True))
    _check_seedings("sharded_realistic", runs, SHARDED_REALISTIC_SEEDCLUSTER)
    for r in runs:
        _check_refine_run("sharded_realistic", r)
    row = {"genomes": 5, "first": runs[0], "warm": runs[1]}
    print("sharded_realistic", json.dumps(row), flush=True)
    return row


def sharded_windowed_phase() -> dict:
    """14d: the 6,264,404 bp pair of phase 7 through `align_fastas_sharded`:
    its 2 x 2 window pairs ride the batch as rows of one 4 Mbp bucket,
    and every process assembles them after the exchange."""
    # A row seeds 2^23 k-mers (two 2^22 buckets): ~10 int64 arrays of that
    # length live at once in the first sort's stage, one row at a time.
    print("sharded_windowed reckoned_peak_device_mb",
          json.dumps(10 * 8 * (1 << 23) / 2**20), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        paths = list(headline_fastas(tmp, WINDOWED_BP))
        runs = _sharded_runs("sharded_windowed", paths, SHARDED_WINDOWED_MAF_SHA256)
    _check_seedings("sharded_windowed", runs, WINDOWED_SEEDCLUSTER)
    row = {"bp": WINDOWED_BP, "first": runs[0], "warm": runs[1]}
    print("sharded_windowed", json.dumps(row), flush=True)
    return row


def sharded_rank_main(spec_json: str) -> int:
    """One rank of `run_sharded_ranks`: joins the world of its environment
    on ``spec["device"]`` (NCCL on its own card, gloo on the CPU), then
    runs 14a's pair step over a mesh of every rank's slot (the gather
    crosses the ranks) and its distance step over a ``1 x ranks`` kdim
    mesh, each at the reference's digest, and `align_fastas_sharded` on
    ``spec["paths"]`` twice without a store (every rank merges the whole
    exchange, so each writes the one-process MAF, ``spec["digest"]``).
    Prints one ``sharded_rank`` JSON line."""
    import torch

    from paramugsy_tpu_torch.ops import engines
    from paramugsy_tpu_torch.parallel.collective import _phase_barrier, align_fastas_sharded
    from paramugsy_tpu_torch.parallel.mesh import make_mesh
    from paramugsy_tpu_torch.parallel.pair_shard import (
        PAIR_FIELDS,
        make_sharded_distance_step,
        make_sharded_pair_step,
    )
    from paramugsy_tpu_torch.runtime import dist

    spec = json.loads(spec_json)
    ctx = dist.init_distributed(device=spec["device"])
    dev = dist.rank_device(torch.device(spec["device"]))
    n = ctx.process_count
    refs, queries, sketches = graft_pair_batch(8)
    out = make_sharded_pair_step(make_mesh(devices=[dev]), k=16, max_seeds=1 << 10,
                                 max_clusters=128)(torch.from_numpy(refs).to(dev),
                                                   torch.from_numpy(queries).to(dev))
    if arrays_sha256([out[f].cpu().numpy() for f in PAIR_FIELDS]) != SHARDED_PAIR_STEP_SHA256:
        raise AssertionError(f"rank {ctx.process_index}: gathered pair step differs")
    jac = make_sharded_distance_step(make_mesh(n_pairs=1, n_kdim=n, devices=[dev]))(
        torch.from_numpy(sketches).to(dev))
    if arrays_sha256([jac.cpu().numpy()], np.float32) != SHARDED_DISTANCE_SHA256:
        raise AssertionError(f"rank {ctx.process_index}: all-reduced distances differ")
    walls = []
    for i in range(2):
        out_maf = os.path.join(spec["work"], f"rank{ctx.process_index}_run{i}.maf")
        _phase_barrier("smoke")
        before = dict(engines.COUNTS)
        t0 = time.perf_counter()
        align_fastas_sharded(spec["paths"], out_maf, devices=[dev])
        if dev.type == "cuda":
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if spec["digest"] and file_sha256(out_maf) != spec["digest"]:
            raise AssertionError(f"rank {ctx.process_index}: MAF of run {i} differs")
    print("sharded_rank", json.dumps({
        "rank": ctx.process_index, "ranks": n, "device": str(dev), "walls_s": walls,
        "engines": _engine_delta(before),
    }), flush=True)
    dist.shutdown_distributed(ctx)
    return 0


def run_sharded_ranks(n: int, device_type: str, paths: list, digest, work: str,
                      timeout: float = 600) -> list:
    """`n` processes of `sharded_rank_main`, rank i on ``cuda:i`` (one card
    each: NCCL refuses two ranks on one card) or on the CPU; a rank that
    fails or times out fails the run, and every rank is stopped.  Returns
    each rank's row with its process wall.  Every rank's MAF must be
    byte-identical to rank 0's."""
    port = _free_port()
    spec = json.dumps({"device": device_type, "paths": paths, "digest": digest, "work": work})
    procs = []
    try:
        for rank in range(n):
            env = dict(os.environ, PYTHONPATH=ROOT, RANK=str(rank), LOCAL_RANK=str(rank),
                       WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            cmd = [sys.executable, "-c",
                   "import sys, chip_smoke; sys.exit(chip_smoke.sharded_rank_main(sys.argv[1]))",
                   spec]
            procs.append((time.perf_counter(), subprocess.Popen(
                cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True,
            )))
        rows = []
        for rank, (t0, p) in enumerate(procs):
            try:
                out, err = p.communicate(timeout=max(1.0, t0 + timeout - time.perf_counter()))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"sharded rank {rank} timed out after {timeout} s")
            if p.returncode != 0:
                raise AssertionError(f"sharded rank {rank} exited {p.returncode}:\n{err[-4000:]}")
            row = next(json.loads(line.split(" ", 1)[1]) for line in out.splitlines()
                       if line.startswith("sharded_rank "))
            rows.append({**row, "process_wall_s": time.perf_counter() - t0})
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i in range(2):
        mafs = {file_sha256(os.path.join(work, f"rank{r}_run{i}.maf")) for r in range(n)}
        if len(mafs) != 1:
            raise AssertionError(f"{n} sharded ranks wrote {len(mafs)} different MAFs")
    return rows


def sharded_ranks_phase(smi: str) -> None:
    """14b across cards: the family through `align_fastas_sharded` in one
    process (the one-rank world), then by 2 and by 4 ranks, each on its
    own card, as many as there are cards; every rank's MAF at phase 5's
    digest.  Prints the walls side by side."""
    import torch

    device = torch.device("cuda")
    with one_rank_world(device):
        one = sharded_family_phase()
    with tempfile.TemporaryDirectory() as tmp:
        paths = family_fastas(tmp, FAMILY_BP, FAMILY_COUNT)
        for n in (2, 4):
            if torch.cuda.device_count() < n:
                continue
            rows = run_sharded_ranks(n, "cuda", paths, FAMILY_MAF_SHA256, tmp)
            seeded = sum(r["engines"].get("seedcluster-cuda", 0) for r in rows)
            if seeded != FAMILY_SEEDCLUSTER:
                raise AssertionError(f"{n} ranks seeded {seeded} rows in the last run")
            print("sharded_ranks_walls", json.dumps({
                "path": "family", "card": smi, "ranks": n,
                "one_process": [one[k]["wall_s"] for k in ("first", "warm")],
                "rank_walls": [r["walls_s"] for r in rows],
                "slower_rank": [max(r["walls_s"][i] for r in rows) for i in (0, 1)],
                "rank_process_walls_s": [r["process_wall_s"] for r in rows],
            }), flush=True)


def print_sharded_walls(smi: str, executor: dict, distributed: dict, sharded: dict) -> None:
    """Phase 14b's walls beside 11a's one-process executor and 13a's
    slower rank on the same family (first, warm, seconds)."""
    print("sharded_walls", json.dumps({
        "path": "family", "card": smi,
        "sharded": [sharded["family"][k]["wall_s"] for k in ("first", "warm")],
        "executor": [executor["family"][k]["wall_s"] for k in ("first", "warm")],
        "distributed_slower_rank": [distributed["family"][k]["slower_wall_s"]
                                    for k in ("first", "warm")],
    }), flush=True)


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


def _repeats_runs(name: str, genome: np.ndarray, device, delta_digest: str,
                  maf_digest: str | None, entries: int, engines_per_run: dict) -> dict:
    """The ``repeats`` CLI on `genome` twice (first, warm): per run the
    wall, the engine counts (each must equal `engines_per_run`, keyed by
    engine less its device suffix) and the digests of the delta body and,
    when given, of the MAF."""
    import torch

    from paramugsy_tpu_torch import cli
    from paramugsy_tpu_torch.ops import engines

    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        fa = write_fasta(os.path.join(tmp, f"{name}.fa"), f"{name}.chr", genome)
        delta, maf = os.path.join(tmp, "self.delta"), os.path.join(tmp, "self.maf")
        argv = ["repeats", "-seq", fa, "-out_delta", delta, "-device", device.type]
        if maf_digest:
            argv += ["-out_maf", maf]
        for _ in range(2):
            before = dict(engines.COUNTS)
            t0 = time.perf_counter()
            if cli.main(argv) != 0:
                raise AssertionError(f"{name}: repeats CLI failed")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            with open(delta) as f:
                body = delta_body(f.read())
            if sha256(body) != delta_digest:
                raise AssertionError(f"{name}: delta differs from the JAX reference")
            if maf_digest and file_sha256(maf) != maf_digest:
                raise AssertionError(f"{name}: MAF differs from the JAX reference")
            got = sum(1 for line in body.splitlines() if len(line.split()) == 7)
            used = _engine_delta(before)
            want = {f"{k}-{device.type}": v for k, v in engines_per_run.items()}
            if got != entries or any(used.get(k) != v for k, v in want.items()):
                raise AssertionError(
                    f"{name}: {got} entries, engines {used}; expected {entries} "
                    f"and {want}"
                )
            runs.append({"wall_s": wall, "engines": used})
    row = {
        "bp": len(genome), "entries": entries, "first_s": runs[0]["wall_s"],
        "warm_s": runs[1]["wall_s"], "engines": runs[1]["engines"],
    }
    print(name, json.dumps(row), flush=True)
    return row


def repeats_phase(device) -> dict:
    """Phase 9: the ``repeats`` CLI on the 2 Mbp `repeats_genome`."""
    return _repeats_runs(
        "repeats", repeats_genome(), device, REPEATS_DELTA_SHA256,
        REPEATS_MAF_SHA256, REPEATS_ENTRIES, {"repeatcluster": 1},
    )


def windowed_self_phase(device) -> dict:
    """Phase 9b: the ``repeats`` CLI on `windowed_self_genome` (4.64 Mbp,
    over the 4 Mbp window): two self calls and one window pair."""
    return _repeats_runs(
        "windowed_self", windowed_self_genome(), device, WINDOWED_SELF_DELTA_SHA256,
        None, WINDOWED_SELF_ENTRIES, WINDOWED_SELF_ENGINES,
    )


def self_island_phase(device) -> dict:
    """Phase 9c: `self_island_genome` through align_self with break_len
    8192 twice; each run's long segments must run on K1 and K2, as many
    as the reference sent to its host banded engine."""
    import torch

    from paramugsy_tpu_torch.cli import delta_text
    from paramugsy_tpu_torch.ops import engines
    from paramugsy_tpu_torch.ops.align_pair import AlignConfig, align_self

    g = self_island_genome()
    cfg = AlignConfig(break_len=SELF_ISLAND_BREAK_LEN)
    runs = []
    for _ in range(2):
        before, launched = dict(engines.COUNTS), _launch_counts()
        t0 = time.perf_counter()
        entries = align_self(g, "self_island.chr", cfg, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if sha256(delta_body(delta_text(entries))) != SELF_ISLAND_DELTA_SHA256:
            raise AssertionError("self island: entries differ from the JAX reference")
        used = _engine_delta(before)
        launches = {k: v - launched[k] for k, v in _launch_counts().items()}
        if (
            used.get("device-wavefront") != SELF_ISLAND_LONG_SEGMENTS
            or used.get(f"repeatcluster-{device.type}") != 1
            or min(launches.values()) <= 0
        ):
            raise AssertionError(
                f"self island: {used}, launches {launches}; expected "
                f"{SELF_ISLAND_LONG_SEGMENTS} long segments on K1/K2"
            )
        runs.append({"wall_s": wall, "engines": used, "launches": launches})
    row = {
        "bp": len(g), "first_s": runs[0]["wall_s"], "warm_s": runs[1]["wall_s"],
        "entries": len(entries), "engines": runs[1]["engines"],
        "launches": runs[1]["launches"],
    }
    print("self_island", json.dumps(row), flush=True)
    return row


def duplications_phase(device) -> dict:
    """Phase 10: the realistic fixture through ``align -sequential
    -duplications`` twice (first, warm): the MAF must equal the
    reference's, dup blocks included."""
    paths = _realistic_paths()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "duplications.maf")
        argv = [
            "align", "-sequential", *paths, "-duplications", "-out_maf", out,
            "-device", device.type,
        ]
        runs = _align_runs("duplications", argv, out, DUPLICATIONS_MAF_SHA256)
        with open(out) as f:
            dup_blocks = sum(1 for line in f if line.startswith("a ") and "label=dup" in line)
    want = {f"{k}-{device.type}": v for k, v in DUPLICATIONS_ENGINES.items()}
    for r in runs:
        if any(r["engines"].get(k) != v for k, v in want.items()):
            raise AssertionError(f"duplications: {r['engines']}; expected {want}")
    if dup_blocks != DUPLICATIONS_DUP_BLOCKS:
        raise AssertionError(f"duplications: {dup_blocks} dup blocks")
    row = {"genomes": len(paths), "dup_blocks": dup_blocks, "first": runs[0], "warm": runs[1]}
    print("duplications", json.dumps(row), flush=True)
    return row


def port_modules():
    """The port's functions that phase 15 drives (`host_tool_steps`,
    `profile_chain_steps`); the reference's namesakes give its digests."""
    from types import SimpleNamespace

    from paramugsy_tpu_torch import cli
    from paramugsy_tpu_torch.formats import read_delta, read_fasta, write_maf
    from paramugsy_tpu_torch.formats.delta_maf import delta_to_maf_blocks
    from paramugsy_tpu_torch.lcb.merge import select_consistent

    return SimpleNamespace(
        cli=cli, read_delta=read_delta, read_fasta=read_fasta, write_maf=write_maf,
        delta_to_maf_blocks=delta_to_maf_blocks, select_consistent=select_consistent,
    )


def _host_step(cli, step: str, argvs: list, outputs=()) -> dict:
    """Commands through ``cli.main`` with their stdout captured: the wall,
    the exit codes and one sha256 over the exit codes, the stdout and the
    `outputs` files (a ``.delta`` file without its two header lines, which
    name the input paths)."""
    import contextlib
    import io

    buf = io.StringIO()
    rcs = []
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        for argv in argvs:
            rcs.append(cli.main(argv))
    wall = time.perf_counter() - t0
    h = hashlib.sha256(f"{rcs}\n{buf.getvalue()}".encode())
    for path in outputs:
        with open(path) as f:
            text = f.read()
        h.update((delta_body(text) if path.endswith(".delta") else text).encode())
    return {"step": step, "wall_s": wall, "rcs": rcs, "sha256": h.hexdigest()}


def host_tool_steps(cli, mafs: dict, fastas: dict, delta: str, fasta: str,
                    work: str) -> list:
    """15a: every MAF tool on each MAF of `mafs` (name -> path, its
    genomes' FASTA files in `fastas[name]`), then ``sortdelta`` on `delta`
    and ``fastafmt`` on `fasta`, through ``cli.main``, writing under
    `work`; one `_host_step` row per command and input."""
    steps = []
    for name, maf in mafs.items():
        d = os.path.join(work, name)
        os.makedirs(d)
        stat, defrag, edges, filled, clean = (
            os.path.join(d, f) for f in ("stat", "defrag.maf", "edges", "filled.maf",
                                         "clean.maf")
        )
        for tool, argv, outputs in (
            ("mafstat", ["mafstat", maf, "-out_dir", stat],
             [os.path.join(stat, "core_genome"), os.path.join(stat, "missing")]),
            ("mafvalidate", ["mafvalidate", maf], []),
            ("mafdefrag", ["mafdefrag", maf, defrag, "-synchain", edges], [defrag, edges]),
            ("maffiller", ["maffiller", maf, *fastas[name], "-out_maf", filled], [filled]),
            ("analyzer", ["analyzer", maf], []),
            ("mafclean", ["mafclean", maf, clean], [clean]),
            ("maf_to_xmfa", ["profiles", "maf_to_xmfa", "-in_maf", maf], []),
        ):
            steps.append(_host_step(cli, f"{name}/{tool}", [argv], outputs))
    sorted_delta = os.path.join(work, "sorted.delta")
    steps.append(_host_step(cli, "headline/sortdelta", [["sortdelta", delta, sorted_delta]],
                            [sorted_delta]))
    steps.append(_host_step(cli, "headline/fastafmt", [["fastafmt", fasta]]))
    return steps


def profile_chain_steps(m, halves: list, work: str, device_args: list) -> list:
    """15b, the profile toolchain of a tree merge through ``m.cli.main``:
    ``align -sequential`` of each half of the genomes (`halves`, two lists
    of FASTA paths), ``profiles make`` of each MAF, ``nucmer`` of every
    cross pair (left genome as reference), ``profiles translate`` of those
    deltas into the two profile sets, the MAF of the translated entries
    as the merge step makes it (`select_consistent`, then
    `delta_to_maf_blocks` over the two ``sequences.fasta``), ``profiles
    untranslate`` of it back to genome coordinates and ``mafvalidate`` of
    the result.  `device_args` go to ``align`` and ``nucmer``."""
    cli = m.cli
    os.makedirs(work)
    steps, dirs = [], []
    for side, paths in zip(("left", "right"), halves):
        maf = os.path.join(work, f"{side}.maf")
        argv = ["align", "-sequential", *paths, "-out_maf", maf, *device_args]
        steps.append(_host_step(cli, f"profiles/align_{side}", [argv], [maf]))
        dirs.append(os.path.join(work, side))
        argv = ["profiles", "make", "-basename", side, "-out_dir", dirs[-1], "-in_maf", maf]
        steps.append(_host_step(cli, f"profiles/make_{side}", [argv], [
            os.path.join(dirs[-1], "profiles"), os.path.join(dirs[-1], "sequences.fasta")]))
    deltas, argvs = [], []
    for a in halves[0]:
        for b in halves[1]:
            deltas.append(os.path.join(
                work, f"{os.path.basename(a)}~{os.path.basename(b)}.delta"))
            argvs.append(["nucmer", "-ref_seq", a, "-query_seq", b,
                          "-out_delta", deltas[-1], *device_args])
    steps.append(_host_step(cli, "profiles/nucmer", argvs, deltas))
    nucmers = os.path.join(work, "nucmers.list")
    with open(nucmers, "w") as f:
        f.write("\n".join(deltas) + "\n")
    translated = os.path.join(work, "translated.delta")
    argv = ["profiles", "translate", *dirs, "-nucmer_list", nucmers, "-out_delta", translated]
    steps.append(_host_step(cli, "profiles/translate", [argv], [translated]))
    pseudo = os.path.join(work, "pseudo.maf")
    t0 = time.perf_counter()
    kept, _ = m.select_consistent(list(m.read_delta(translated)), min_length=10)
    cons = [dict(m.read_fasta(os.path.join(d, "sequences.fasta"))) for d in dirs]
    m.write_maf(pseudo, m.delta_to_maf_blocks(kept, *cons))
    steps.append({"step": "profiles/merge_maf", "wall_s": time.perf_counter() - t0,
                  "rcs": [], "sha256": file_sha256(pseudo), "entries": len(kept)})
    dir_list = os.path.join(work, "dirs.list")
    with open(dir_list, "w") as f:
        f.write("\n".join(dirs) + "\n")
    untranslated = os.path.join(work, "untranslated.maf")
    argv = ["profiles", "untranslate", "-profile_paths_list", dir_list,
            "-in_maf", pseudo, "-out_maf", untranslated]
    steps.append(_host_step(cli, "profiles/untranslate", [argv], [untranslated]))
    steps.append(_host_step(cli, "profiles/mafvalidate", [["mafvalidate", untranslated]]))
    return steps


def host_tools_phase(device, kept: str, smi: str) -> None:
    """15: the host-only commands on what phases 3, 5 and 6 wrote to
    `kept` (15a), then the profile toolchain over two halves of phase 5's
    family with ``align`` and ``nucmer`` on the card (15b); every step's
    digest must equal the reference's (`HOST_TOOLS_SHA256`)."""
    m = port_modules()
    family = sorted(os.path.join(kept, "family", f"q{i}.fa") for i in range(FAMILY_COUNT))
    with tempfile.TemporaryDirectory() as work:
        steps = host_tool_steps(
            m.cli,
            {"family": os.path.join(kept, "family.maf"),
             "realistic": os.path.join(kept, "realistic.maf")},
            {"family": family, "realistic": _realistic_paths()},
            os.path.join(kept, "headline.delta"), os.path.join(kept, "smoke_ref.fa"),
            work,
        )
        steps += profile_chain_steps(
            m, [family[:4], family[4:]], os.path.join(work, "profiles"),
            ["-device", device.type],
        )
    for s in steps:
        print("host_tool", json.dumps(s), flush=True)
    wrong = [s["step"] for s in steps if HOST_TOOLS_SHA256.get(s["step"]) != s["sha256"]]
    if wrong or set(HOST_TOOLS_SHA256) != {s["step"] for s in steps}:
        raise AssertionError(f"host tools: {wrong} differ from the JAX reference")
    walls = {s["step"]: s["wall_s"] for s in steps}
    print("host_tools_walls", json.dumps({
        "card": smi, "clock": "host wall on the card machine, one run each",
        "family_maf": {k.split("/")[1]: v for k, v in walls.items()
                       if k.startswith("family/")},
        "profiles": {k.split("/")[1]: v for k, v in walls.items()
                     if k.startswith("profiles/")},
        "total_s": sum(walls.values()),
    }), flush=True)


def _profile_cli(name: str, argv: list, out: str, digest_of, digest: str) -> dict:
    """One CLI run traced (`_profile_run`); ``digest_of(out)`` must equal
    `digest` after the traced run."""
    from paramugsy_tpu_torch import cli

    def run():
        if cli.main(argv) != 0:
            raise AssertionError(f"{name}: CLI failed")

    return _profile_run(name, run, lambda: digest_of(out) == digest)


def _profile_run(name: str, run, output_ok) -> dict:
    """`run()` traced: a warm-up run, two untraced runs, then one run
    under torch.profiler; device time per kernel (sum of CUDA self time)
    and the busy share of the traced wall.  ``output_ok()`` must hold
    after the traced run."""
    import torch

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    _zero_launches()
    row = {"untraced_warm_s": walls[1:], **_traced(run)}
    if not output_ok():
        raise AssertionError(f"{name}: output differs from the JAX reference")
    print(f"profile_{name}", json.dumps(row), flush=True)
    return row


def _traced(run) -> dict:
    """`run()` once under torch.profiler: the traced wall, device time per
    kernel (sum of CUDA self time), the busy share and K1/K2 launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
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
    return {
        "traced_s": traced,
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


def profile_realistic() -> dict:
    """The realistic fixture through ``align -sequential -refine``, traced."""
    paths = _realistic_paths()
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


def profile_executor_family() -> dict:
    """Phase 11a, the 8 x 2 Mbp family through ``align`` on the concurrent
    executor, traced (beside `profile_family`'s sequential run)."""
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        paths = family_fastas(tmp, FAMILY_BP, FAMILY_COUNT)
        out = os.path.join(tmp, "family.maf")
        argv = _executor_argv(paths, out, torch.device("cuda"))
        return _profile_cli("executor_family", argv, out, file_sha256, FAMILY_MAF_SHA256)


def profile_distributed_family() -> dict:
    """Phase 13a traced: two ranks run the 8 x 2 Mbp family through
    ``align -distributed`` twice; rank 0's second run is traced (its busy
    share beside `profile_executor_family`'s)."""
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        paths = family_fastas(tmp, FAMILY_BP, FAMILY_COUNT)
        runs = _distributed_runs(
            "profile_distributed_family",
            lambda out, store: _executor_argv(paths, out, torch.device("cuda"))
            + ["-distributed", "-tmp_dir", store],
            DISTRIBUTED_FAMILY_MAF_SHA256, trace_rank0_last=True,
        )
    row = {"untraced_first_s": runs[0]["ranks"][0]["wall_s"],
           "rank1_walls_s": [r["ranks"][1]["wall_s"] for r in runs],
           **runs[1]["ranks"][0]["profile"]}
    print("profile_distributed_family", json.dumps(row), flush=True)
    return row


def profile_sharded_family() -> dict:
    """Phase 14b traced: the 8 x 2 Mbp family through
    `align_fastas_sharded` in the one-rank world (beside
    `profile_executor_family`)."""
    import torch

    from paramugsy_tpu_torch.parallel.collective import align_fastas_sharded

    device = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp, one_rank_world(device):
        paths = family_fastas(tmp, FAMILY_BP, FAMILY_COUNT)
        out = os.path.join(tmp, "family.maf")
        return _profile_run(
            "sharded_family", lambda: align_fastas_sharded(paths, out),
            lambda: file_sha256(out) == FAMILY_MAF_SHA256,
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


def profile_repeats(windowed: bool) -> dict:
    """Phase 9's 2 Mbp genome or phase 9b's 4.64 Mbp windowed genome
    through ``repeats``, traced."""
    with tempfile.TemporaryDirectory() as tmp:
        name = "windowed_self" if windowed else "repeats"
        genome = windowed_self_genome() if windowed else repeats_genome()
        fa = write_fasta(os.path.join(tmp, f"{name}.fa"), f"{name}.chr", genome)
        out = os.path.join(tmp, "self.delta")
        argv = ["repeats", "-seq", fa, "-out_delta", out, "-device", "cuda"]

        def digest_of(path):
            with open(path) as f:
                return sha256(delta_body(f.read()))

        return _profile_cli(
            name, argv, out, digest_of,
            WINDOWED_SELF_DELTA_SHA256 if windowed else REPEATS_DELTA_SHA256,
        )


def profile_self_island() -> dict:
    """Phase 9c's align_self run (K1/K2 on its long segments), traced."""
    from paramugsy_tpu_torch.cli import delta_text
    from paramugsy_tpu_torch.ops.align_pair import AlignConfig, align_self

    g = self_island_genome()
    cfg = AlignConfig(break_len=SELF_ISLAND_BREAK_LEN)
    got = []

    def run():
        got[:] = align_self(g, "self_island.chr", cfg, device="cuda")

    return _profile_run(
        "self_island", run,
        lambda: sha256(delta_body(delta_text(got))) == SELF_ISLAND_DELTA_SHA256,
    )


def profile_duplications() -> dict:
    """Phase 10, the realistic fixture through ``align -sequential
    -duplications``, traced."""
    paths = _realistic_paths()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "duplications.maf")
        argv = ["align", "-sequential", *paths, "-duplications", "-out_maf", out,
                "-device", "cuda"]
        return _profile_cli("duplications", argv, out, file_sha256, DUPLICATIONS_MAF_SHA256)


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
    if argv == ["--sharded"]:
        _zero_launches()
        with one_rank_world(device):
            graft_steps_phase(device)
            sharded_family_phase()
            sharded_realistic_phase()
            sharded_windowed_phase()
        print("main_path_launches", json.dumps({"sharded": _launch_counts()}), flush=True)
        return 0
    if argv == ["--sharded-ranks"]:
        sharded_ranks_phase(smi)
        return 0
    if argv == ["--profile"]:
        profile_realistic()
        profile_family(windowed=False)
        profile_executor_family()
        profile_distributed_family()
        profile_sharded_family()
        profile_windowed_pair()
        profile_family(windowed=True)
        profile_repeats(windowed=False)
        profile_repeats(windowed=True)
        profile_self_island()
        profile_duplications()
        return 0
    if argv:
        raise SystemExit(
            f"usage: {sys.argv[0]} "
            "[--wavefront | --banded | --sharded | --sharded-ranks | --profile]"
        )

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
    # Phases 3, 5 and 6 leave their outputs in `kept` for phase 15.
    kept_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_kept_")
    kept = kept_dir.name
    engines.reset_counts()
    _zero_launches()
    headline_phase(device, kept)
    island_phase(device)
    pair_launches = _launch_counts()
    print("main_path_launches", json.dumps({"pairwise": pair_launches}), flush=True)
    if min(pair_launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {pair_launches}")

    _zero_launches()
    family_row = family_phase(device, kept)
    family_launches = _launch_counts()
    print("main_path_launches", json.dumps({"family": family_launches}), flush=True)

    _zero_launches()
    realistic_row = realistic_phase(device, kept)
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

    # The self-alignment path: phases 9, 9b, 9c and 10.
    _zero_launches()
    repeats_phase(device)
    windowed_self_phase(device)
    self_island_phase(device)
    duplications_phase(device)
    self_launches = _launch_counts()
    print("main_path_launches", json.dumps({"self": self_launches}), flush=True)
    if min(self_launches.values()) <= 0:
        raise AssertionError(f"K1/K2 never launched on the self path: {self_launches}")

    # Phase 11: the concurrent executor (align without -sequential).
    _zero_launches()
    executor_rows = {
        "family": executor_family_phase(device),
        "realistic": executor_realistic_phase(device),
        "resume": executor_resume_phase(device),
    }
    executor_launches = _launch_counts()
    print("main_path_launches", json.dumps({"executor": executor_launches}), flush=True)
    if min(executor_launches.values()) <= 0:
        raise AssertionError(f"K1/K2 never launched from the executor: {executor_launches}")
    print_executor_walls(smi, family_row, realistic_row, executor_rows)

    # Phase 12: mugsy over precomputed pairwise MAFs.
    _zero_launches()
    mugsy_phase(device)
    mugsy_launches = _launch_counts()
    print("main_path_launches", json.dumps({"mugsy": mugsy_launches}), flush=True)
    if min(mugsy_launches.values()) <= 0:
        raise AssertionError(f"K1/K2 never launched under mugsy -colinear: {mugsy_launches}")

    # Phase 13: align -distributed, two ranks on this card, and sge.  The
    # ranks' launches are their own processes' counts, as they report them.
    _zero_launches()
    distributed_rows = {
        "family": distributed_family_phase(device),
        "realistic": distributed_realistic_phase(device),
        "sge": sge_phase(device),
    }
    distributed_launches = _launch_counts()
    for k in distributed_launches:
        for name in ("family", "realistic"):
            for run in ("first", "warm"):
                distributed_launches[k] += distributed_rows[name][run]["summed"]["launches"][k]
    print("main_path_launches", json.dumps({"distributed": distributed_launches}), flush=True)
    if min(distributed_launches.values()) <= 0:
        raise AssertionError(f"K1/K2 never launched by the ranks: {distributed_launches}")
    print_distributed_walls(smi, executor_rows, distributed_rows)

    # Phase 14: the sharded data plane in a one-rank NCCL world on this card.
    _zero_launches()
    with one_rank_world(device):
        graft_steps_phase(device)
        sharded_rows = {
            "family": sharded_family_phase(),
            "realistic": sharded_realistic_phase(),
            "windowed": sharded_windowed_phase(),
        }
    sharded_launches = _launch_counts()
    print("main_path_launches", json.dumps({"sharded": sharded_launches}), flush=True)
    if min(sharded_launches.values()) <= 0:
        raise AssertionError(f"K1/K2 never launched on the sharded path: {sharded_launches}")
    print_sharded_walls(smi, executor_rows, distributed_rows, sharded_rows)

    # Phase 15: the host-only commands on the outputs of phases 3, 5 and 6,
    # and the profile toolchain with align and nucmer on the card.  No
    # kernel of their own; the counts say whether their device steps
    # launched K1/K2.
    _zero_launches()
    host_tools_phase(device, kept, smi)
    kept_dir.cleanup()
    host_launches = _launch_counts()
    print("main_path_launches", json.dumps({"host_tools": host_launches}), flush=True)

    launches = {
        k: pair_launches[k] + family_launches[k] + refine_launches[k]
        + windowed_launches[k] + self_launches[k] + executor_launches[k]
        + mugsy_launches[k] + distributed_launches[k] + sharded_launches[k]
        + host_launches[k]
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
