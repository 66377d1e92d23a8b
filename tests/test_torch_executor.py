"""The port's concurrent executor (``runtime/``: scheduler, backends,
artifact store, job executor) against the reference's, on the CPU, and
the thread safety of the shared state its worker threads reach.

The executor's outputs are compared as bytes: the MAF that
`align_fastas_concurrent` and the ``align`` / ``local`` CLI write, and the
files of the ``-tmp_dir`` artifact store.  The port's long-segment host
fallback (`ops.extend.align_long_segment` without the native library) is
held against the reference's on the input that showed it raising.
"""
import io
import os
import sys
import threading

import numpy as np
import pytest
import torch

import chip_smoke
import paramugsy_tpu.formats as ref_formats
import paramugsy_tpu_torch.formats as port_formats
from paramugsy_tpu import cli as ref_cli
from paramugsy_tpu.ops import extend as ref_extend
from paramugsy_tpu.ops import native as ref_native
from paramugsy_tpu.ops.extend import banded_align_np
from paramugsy_tpu.pipeline import Aligner as RefAligner
from paramugsy_tpu.pipeline import Genome as RefGenome
from paramugsy_tpu.pipeline import PipelineConfig as RefPipelineConfig
from paramugsy_tpu.runtime import backends as ref_backends
from paramugsy_tpu.runtime import executor as ref_executor
from paramugsy_tpu.runtime import scheduler as ref_scheduler
from paramugsy_tpu_torch import cli as port_cli
from paramugsy_tpu_torch.ops import banded as port_banded
from paramugsy_tpu_torch.ops import engines as port_engines
from paramugsy_tpu_torch.ops import extend as port_extend
from paramugsy_tpu_torch.ops import native as port_native
from paramugsy_tpu_torch.ops import wavefront as port_wavefront
from paramugsy_tpu_torch.pipeline import Aligner, Genome, PipelineConfig, align_fastas
from paramugsy_tpu_torch.runtime import backends as port_backends
from paramugsy_tpu_torch.runtime import executor as port_executor
from paramugsy_tpu_torch.runtime import scheduler as port_scheduler

torch.set_num_threads(1)
CPU = torch.device("cpu")
PACKAGES = {
    "ref": (ref_scheduler, ref_backends),
    "port": (port_scheduler, port_backends),
}


# --------------------------------------------------------------------------
# The long-segment host fallback and the thread-safe shared state
# --------------------------------------------------------------------------


def test_align_long_segment_without_native_equals_reference(monkeypatch):
    """600 random bases against a copy with one substitution and one
    deletion, with neither package's native library: the port returns the
    reference's alignment (it raised before) and records numpy-banded."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 4, 600).astype(np.int8)
    b = a.copy()
    b[100] = (b[100] + 1) % 4
    b = np.delete(b, 300)
    monkeypatch.setattr(ref_native, "load", lambda: None)
    monkeypatch.setattr(port_native, "load", lambda: None)
    want = ref_extend.align_long_segment(a, b)
    port_engines.reset_counts()
    got = port_extend.align_long_segment(a, b)
    assert got == want
    assert want[2] == 600 and (want[0] or want[1])
    assert port_engines.COUNTS == {"numpy-banded": 1}


def test_banded_align_plain_takes_widths_past_the_kernel_limit():
    """The fallback's plain DP runs at a width the CUDA kernel refuses (a
    length difference of 16384 or more doubles the band past MAX_WIDTH),
    and equals the reference's NumPy mirror there."""
    rng = np.random.default_rng(1)
    a = rng.integers(0, 4, 40).astype(np.int8)
    b = np.concatenate([a[:12], a[15:31]])
    width = 2 * port_banded.MAX_WIDTH
    assert port_banded.banded_align_plain(a, b, width=width) == banded_align_np(
        a, b, width=width
    )
    A, B, al, bl = port_wavefront.pack_pairs([(a, b)], CPU)
    with pytest.raises(ValueError, match="registers"):
        port_banded.banded_dp(A, B, al, bl, rows=128, width=width)


def _run_threads(n: int, target) -> list:
    """`target(i)` on n threads released together by a barrier, with a
    short switch interval; returns the results in thread order."""
    barrier = threading.Barrier(n)
    out = [None] * n
    errors = []

    def run(i):
        try:
            barrier.wait(timeout=30)
            out[i] = target(i)
        except BaseException as e:  # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    return out


def test_native_load_under_eight_threads(monkeypatch):
    """Eight threads call the first `load()` together: every one gets the
    same library (none sees the load half done and takes None)."""
    monkeypatch.setattr(port_native, "_lib", None)
    monkeypatch.setattr(port_native, "_tried", False)
    libs = _run_threads(8, lambda i: port_native.load())
    assert libs[0] is not None
    assert all(lib is libs[0] for lib in libs)


def test_engine_counts_under_eight_threads():
    """Eight threads record 10,000 times each, and count launches on one
    wrapper: no update is lost."""
    port_engines.reset_counts()

    def wrapper():
        pass

    wrapper.launches = 0

    def work(i):
        for _ in range(10_000):
            port_engines.record("stress")
            port_engines.count_launch(wrapper)

    _run_threads(8, work)
    assert port_engines.COUNTS["stress"] == 80_000
    assert wrapper.launches == 80_000
    port_engines.reset_counts()


# --------------------------------------------------------------------------
# Scheduler and backends, both packages' modules
# --------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
class TestScheduler:
    def test_basic(self, pkg):
        s = PACKAGES[pkg][0].PriorityScheduler(2)
        futs = [s.submit(lambda i=i: i * i, priority=0) for i in range(10)]
        assert [f.result(5) for f in futs] == [i * i for i in range(10)]
        s.stop()

    def test_priority_order(self, pkg):
        s = PACKAGES[pkg][0].PriorityScheduler(1)
        order = []
        gate = threading.Event()
        s.submit(lambda: gate.wait(5))  # occupy the only slot
        futs = [
            s.submit(lambda p=p: order.append(p), priority=p, name=str(p))
            for p in [1, 5, 3, 9, 2]
        ]
        gate.set()
        for f in futs:
            f.result(5)
        assert order == [9, 5, 3, 2, 1]
        s.stop()

    def test_exception_propagates(self, pkg):
        s = PACKAGES[pkg][0].PriorityScheduler(1)

        def boom():
            raise ValueError("x")

        with pytest.raises(ValueError):
            s.submit(boom).result(5)
        s.stop()

    def test_spawn(self, pkg):
        assert PACKAGES[pkg][0].spawn(lambda: 42).result(5) == 42


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
class TestBackends:
    def test_retry_eventually_succeeds(self, pkg):
        mod = PACKAGES[pkg][1]
        attempts = []

        def flaky():
            attempts.append(1)
            if len(attempts) < 3:
                raise RuntimeError("transient")
            return "ok"

        b = mod.RetryBackend(mod.LocalBackend(1), retries=5, backoff_s=0.01)
        assert b.submit(flaky).result(10) == "ok"
        assert len(attempts) == 3
        b.stop()

    def test_retry_exhausts(self, pkg):
        mod = PACKAGES[pkg][1]
        b = mod.RetryBackend(mod.LocalBackend(1), retries=2, backoff_s=0.01)

        def always():
            raise RuntimeError("permanent")

        with pytest.raises(RuntimeError):
            b.submit(always).result(10)
        b.stop()

    def test_recording(self, pkg):
        mod = PACKAGES[pkg][1]
        rec = mod.RecordingBackend(mod.LocalBackend(1))
        rec.submit(lambda: 1, name="a", priority=2).result(5)
        rec.submit(lambda: 2, name="b", priority=1).result(5)
        assert rec.submissions == [("a", 2), ("b", 1)]
        assert sorted(rec.completed) == ["a", "b"]
        rec.stop()


# --------------------------------------------------------------------------
# The executor against the reference
# --------------------------------------------------------------------------


def _mk_seqs(seed=11, n=3000, count=4):
    """tests/test_runtime.py's _mk_genomes recipe: name -> sequence."""
    rng = np.random.default_rng(seed)
    anc = "".join(np.array(list("ACGT"))[rng.integers(4, size=n)])
    out = {}
    for i in range(count):
        s = list(anc)
        for j in rng.choice(n, n // 50, replace=False):
            s[j] = "ACGT"[rng.integers(4)]
        out[f"g{i}"] = "".join(s)
    return out


def _genomes(cls, count=4):
    return [cls(name=n, seqs={f"{n}.chr": s}) for n, s in _mk_seqs(count=count).items()]


@pytest.fixture(scope="module")
def genome_files(tmp_path_factory):
    """The recipe's four genomes as FASTA files, and the reference's
    concurrent MAF of them (run_size 4, chunk_size 2) as bytes."""
    tmp = tmp_path_factory.mktemp("genomes")
    paths = []
    for name, seq in _mk_seqs().items():
        path = tmp / f"{name}.fa"
        path.write_text(f">chr\n{seq}\n")
        paths.append(str(path))
    ref_executor.align_fastas_concurrent(paths, str(tmp / "ref.maf"), run_size=4, chunk_size=2)
    return paths, (tmp / "ref.maf").read_bytes()


@pytest.mark.parametrize("chunk_size", [2, 16])
@pytest.mark.parametrize("run_size", [1, 4])
def test_concurrent_equals_reference_and_sequential(genome_files, tmp_path, run_size, chunk_size):
    paths, want = genome_files
    out = tmp_path / "port.maf"
    port_engines.reset_counts()
    port_executor.align_fastas_concurrent(
        paths, str(out), run_size=run_size, chunk_size=chunk_size, device="cpu"
    )
    assert out.read_bytes() == want
    # C(4, 2) pairs, each seeded once; no chunk degraded to the per-pair path.
    assert port_engines.COUNTS["seedcluster-cpu"] == 6
    assert "executor-degrade" not in port_engines.COUNTS
    align_fastas(paths, str(tmp_path / "seq.maf"), device="cpu")
    assert (tmp_path / "seq.maf").read_bytes() == want


def _store_tree(root) -> dict:
    """Relative path -> bytes of every file of an artifact store."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def test_tmp_dir_store_and_resume_equal_reference(genome_files, tmp_path, monkeypatch):
    """``-tmp_dir``: the port's store holds the reference's files, byte for
    byte; a second run computes no pair and loads the merges; a run after
    ``nodes/`` is deleted loads the pairs and merges again; every run
    writes the reference's MAF."""
    paths, want = genome_files
    ref_store = tmp_path / "ref_store"
    ref_executor.align_fastas_concurrent(
        paths, str(tmp_path / "ref.maf"), run_size=2, chunk_size=2, tmp_dir=str(ref_store)
    )
    assert (tmp_path / "ref.maf").read_bytes() == want

    events: list[str] = []

    class Recording(port_executor.JobExecutor):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, on_task=lambda ph, name: events.append(ph), **kwargs)

    monkeypatch.setattr(port_executor, "JobExecutor", Recording)
    store = tmp_path / "port_store"

    def run() -> list[str]:
        events.clear()
        out = tmp_path / "port.maf"
        port_executor.align_fastas_concurrent(
            paths, str(out), run_size=2, chunk_size=2, tmp_dir=str(store), device="cpu"
        )
        assert out.read_bytes() == want
        return list(events)

    first = run()
    assert first.count("nucmer") == 6 and "merge-cached" not in first
    tree = _store_tree(store)
    assert tree == _store_tree(ref_store)
    assert sum(k.startswith("pairs") for k in tree) == 6
    assert sum(k.startswith("nodes") for k in tree) == 3

    second = run()
    assert "nucmer" not in second and "merge-cached" in second

    for name in os.listdir(store / "nodes"):
        os.remove(store / "nodes" / name)
    third = run()
    assert "nucmer" not in third
    assert "nucmer-cached" in third and "merge" in third
    assert _store_tree(store) == tree


def test_failure_aborts():
    genomes = _genomes(Genome, count=2)
    cfg = PipelineConfig()
    ex = port_executor.JobExecutor(genomes, cfg, run_size=2, device="cpu")
    tree = Aligner(genomes, cfg, device="cpu").job_tree()

    def boom(*a, **k):
        raise RuntimeError("injected fault")

    ex._pair_chunk_task = boom
    with pytest.raises(RuntimeError, match="injected fault"):
        ex.execute(tree)
    assert not any(t.is_alive() for t in ex.sched._threads)


def test_executor_retries_transient_faults():
    rng = np.random.default_rng(3)
    s = "".join(np.array(list("ACGT"))[rng.integers(4, size=2000)])
    genomes = [Genome("a", {"a.c": s}), Genome("b", {"b.c": s})]
    cfg = PipelineConfig()
    ex = port_executor.JobExecutor(genomes, cfg, run_size=2, retries=3, device="cpu")
    fails = {"n": 0}
    orig = ex._pair_deltas

    def flaky(a, b):
        if fails["n"] < 2:
            fails["n"] += 1
            raise RuntimeError("transient device error")
        return orig(a, b)

    ex._pair_deltas = flaky
    blocks = ex.execute(Aligner(genomes, cfg, device="cpu").job_tree())
    assert blocks and fails["n"] == 2


def test_batched_chunk_failure_degrades_per_pair_and_counts(monkeypatch):
    """A chunk whose batched call fails is aligned pair by pair, and the
    pairs are counted as executor-degrade; the blocks stay the reference
    executor's."""
    cfg = PipelineConfig()
    genomes = _genomes(Genome)
    tree = Aligner(genomes, cfg, device="cpu").job_tree()
    ref_blocks = ref_executor.JobExecutor(
        _genomes(RefGenome), RefPipelineConfig(), run_size=2, chunk_size=4
    ).execute(RefAligner(_genomes(RefGenome), RefPipelineConfig()).job_tree())

    def broken(*args, **kwargs):
        raise RuntimeError("batched call failed")

    port_engines.reset_counts()
    monkeypatch.setattr(port_executor, "genome_pair_deltas_batch", broken)
    ex = port_executor.JobExecutor(genomes, cfg, run_size=2, chunk_size=4, device="cpu")
    blocks = ex.execute(tree)
    # The pairs of every merge that has more than one (at most 4 here, so
    # one chunk each).
    multi = sum(
        k for n in _profile_nodes(tree)
        if (k := len(n.left.to_list()) * len(n.right.to_list())) > 1
    )
    assert port_engines.COUNTS["executor-degrade"] == multi > 0
    assert maf_text(port_formats, blocks) == maf_text(ref_formats, ref_blocks)


def _profile_nodes(node):
    if node.kind != "profile":
        return []
    return [node, *_profile_nodes(node.left), *_profile_nodes(node.right)]


def maf_text(formats, blocks) -> str:
    buf = io.StringIO()
    formats.write_maf(buf, blocks)
    return buf.getvalue()


def test_two_processes_share_a_store(genome_files, tmp_path):
    """Two executors with disjoint PairOwnership (threads standing in for
    processes) converge through one store to the reference's MAF."""
    paths, want = genome_files
    _run_threads(2, lambda i: port_executor.align_fastas_concurrent(
        paths, str(tmp_path / f"p{i}.maf"), run_size=2, chunk_size=2,
        tmp_dir=str(tmp_path / "store"), process_index=i, process_count=2,
        device="cpu",
    ))
    # Process 1 owns no duplication blocks; with none asked for, the same MAF.
    assert (tmp_path / "p0.maf").read_bytes() == want
    assert (tmp_path / "p1.maf").read_bytes() == want
    tree = _store_tree(tmp_path / "store")
    assert sum(k.startswith("pairs") for k in tree) == 6
    assert sum(k.startswith("nodes") for k in tree) == 3


# --------------------------------------------------------------------------
# The CLI: align and local without -sequential
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def family(tmp_path_factory):
    """bench.build_family at 4 x 40 kb, written by the smoke's writer."""
    return chip_smoke.family_fastas(str(tmp_path_factory.mktemp("family")), 40_000, 4)


@pytest.mark.parametrize(
    "command, flags",
    [
        ("align", []),
        ("local", []),
        ("align", ["-run_size", "1", "-nucmer_chunk_size", "1"]),
        ("local", ["-seqs_per_mugsy", "3"]),
        ("align", ["-tmp_dir", "{side}_store"]),
    ],
)
def test_cli_concurrent_equals_reference(family, tmp_path, command, flags):
    def argv(side):
        out = str(tmp_path / f"{side}.maf")
        extra = [f.replace("{side}", str(tmp_path / side)) for f in flags]
        return [command, *family, "-out_maf", out, *extra]

    assert ref_cli.main(argv("ref")) == 0
    want = (tmp_path / "ref.maf").read_bytes()
    port_engines.reset_counts()
    assert port_cli.main([*argv("port"), "-device", "cpu"]) == 0
    assert (tmp_path / "port.maf").read_bytes() == want
    assert "executor-degrade" not in port_engines.COUNTS
    if "-tmp_dir" in flags:
        assert _store_tree(tmp_path / "port_store") == _store_tree(tmp_path / "ref_store")
        port_engines.reset_counts()
        assert port_cli.main([*argv("port"), "-device", "cpu"]) == 0  # resumed
        assert (tmp_path / "port.maf").read_bytes() == want
        assert "seedcluster-cpu" not in port_engines.COUNTS


def test_refine_long_rows_on_the_wavefront_path_from_workers(tmp_path, monkeypatch):
    """``align -refine`` without -sequential, with the long refine rows on
    the wavefront engine (the plain K1/K2 here, launched from the worker
    that runs the merge): the reference's MAF."""
    paths = chip_smoke.family_fastas(str(tmp_path), 5000, 2, seed=3)
    monkeypatch.delenv("PARAMUGSY_DEVICE_DP", raising=False)
    ref_out, port_out = tmp_path / "ref.maf", tmp_path / "port.maf"
    assert ref_cli.main(["align", *paths, "-refine", "-out_maf", str(ref_out)]) == 0
    monkeypatch.setenv("PARAMUGSY_DEVICE_DP", "1")
    port_engines.reset_counts()
    assert port_cli.main(
        ["align", *paths, "-refine", "-out_maf", str(port_out), "-device", "cpu"]
    ) == 0
    assert port_out.read_bytes() == ref_out.read_bytes()
    assert port_engines.COUNTS.get("device-wavefront", 0) > 0
