"""The port's last device commands against the reference's, on the CPU:
``mugsy`` over precomputed pairwise MAFs, ``sge``, and ``align
-distributed`` run by two real processes, ranks of one torch.distributed
(gloo) world that share a ``-tmp_dir`` store; then the kernel build that
such ranks share.

Every comparison is of bytes, with no tolerance: every algorithm is
integer.  Each subprocess has its own timeout, so a rendezvous that hangs
fails its test instead of the suite.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from paramugsy_tpu import cli as ref_cli
from paramugsy_tpu_torch import cli as port_cli

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STITCHABLE = os.path.join(ROOT, "tests", "data", "highly_stitchable.maf")
# No world is configured in this process: the reference's and the port's
# -distributed runs here are one process each.
_WORLD_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK",
              "JAX_COORDINATOR_ADDRESS")


@pytest.fixture(autouse=True)
def _no_world(monkeypatch):
    for name in _WORLD_ENV:
        monkeypatch.delenv(name, raising=False)


def _mutants(rng, n: int, names, n_subs: int, tmp) -> list[str]:
    """FASTA files of `names`, each a copy of one random ancestor of `n`
    bases with `n_subs` random substitutions (the recipe of
    tests/test_modes.py)."""
    bases = "ACGT"
    anc = "".join(bases[i] for i in rng.integers(4, size=n))
    paths = []
    for name in names:
        s = list(anc)
        for j in rng.choice(len(s), n_subs, replace=False):
            s[j] = bases[rng.integers(4)]
        (tmp / f"{name}.fa").write_text(f">chr\n{''.join(s)}\n")
        paths.append(str(tmp / f"{name}.fa"))
    return paths


def _store_tree(root) -> dict:
    """Relative path -> bytes of every file of an artifact store."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


# --------------------------------------------------------------------------
# mugsy: the merge over precomputed pairwise MAFs
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mugsy_inputs(tmp_path_factory):
    """TestMugsySubcommand's two 4 kb genomes (seed 23) and their
    pairwise MAF from the reference's nucmer; a third genome of the same
    ancestor."""
    tmp = tmp_path_factory.mktemp("mugsy")
    paths = _mutants(np.random.default_rng(23), 4000, ("p1", "p2", "p3"), 40, tmp)
    pair_maf = str(tmp / "pair.maf")
    assert ref_cli.main(
        ["nucmer", "-ref_seq", paths[0], "-query_seq", paths[1], "-out_maf", pair_maf]
    ) == 0
    return paths, pair_maf


def _mugsy_case(name, paths, pair_maf, tmp_path) -> list[str]:
    genomes = paths if name == "three_genomes_colinear" else paths[:2]
    (tmp_path / "seqs.list").write_text("\n".join(genomes) + "\n")
    (tmp_path / "mafs.list").write_text(pair_maf + "\n")
    argv = ["-out_dir", str(tmp_path / "out"), "-basename", "m",
            "-seq_list", str(tmp_path / "seqs.list")]
    if name != "no_maf_list":
        argv += ["-maf_list", str(tmp_path / "mafs.list")]
    if name == "dup_list":
        (tmp_path / "dups.list").write_text(STITCHABLE + "\n")
        argv += ["-dup_list", str(tmp_path / "dups.list")]
    if name == "skipunique":
        argv += ["-skipunique"]
    if name == "three_genomes_colinear":
        argv += ["-colinear"]
    return argv


@pytest.mark.parametrize(
    "name", ["plain", "dup_list", "skipunique", "three_genomes_colinear", "no_maf_list"]
)
def test_mugsy_equals_reference(mugsy_inputs, tmp_path, capsys, name):
    """The MAF's bytes and the path printed on stdout are the
    reference's.  With three genomes the pool covers one pair, and the
    other two are aligned on the device path; without a -maf_list every
    pair is."""
    from paramugsy_tpu_torch.ops import engines as port_engines

    argv = _mugsy_case(name, *mugsy_inputs, tmp_path)
    out = tmp_path / "out" / "m.maf"
    assert ref_cli.main(["mugsy", *argv]) == 0
    want_stdout = capsys.readouterr().out
    want = out.read_bytes()
    out.unlink()
    port_engines.reset_counts()
    assert port_cli.main(["mugsy", *argv, "-device", "cpu"]) == 0
    assert capsys.readouterr().out == want_stdout == f"{out}\n"
    assert out.read_bytes() == want
    seeded = {"three_genomes_colinear": 2, "no_maf_list": 1}.get(name, 0)
    assert port_engines.COUNTS.get("seedcluster-cpu", 0) == seeded, port_engines.COUNTS
    assert (b"label=dup1" in want) == (name == "dup_list")


# --------------------------------------------------------------------------
# sge: align -distributed, absorbing the SGE-only flags
# --------------------------------------------------------------------------


def test_sge_equals_reference(tmp_path, capsys):
    """TestGuideTreeAndSge's input through ``sge -template_file /dev/null
    -exec_q all.q -tmp_dir``: the reference's MAF and store, and a
    warning that names the absorbed flags."""
    paths = _mutants(np.random.default_rng(31), 3000, ("ga", "gb", "gc"), 30, tmp_path)

    def argv(side):
        return ["sge", *paths, "-out_maf", str(tmp_path / f"{side}.maf"),
                "-template_file", "/dev/null", "-exec_q", "all.q",
                "-tmp_dir", str(tmp_path / f"{side}_store")]

    assert ref_cli.main(argv("ref")) == 0
    capsys.readouterr()
    assert port_cli.main([*argv("port"), "-device", "cpu"]) == 0
    err = capsys.readouterr().err
    assert "superseded" in err and "-template_file" in err and "-exec_q" in err, err
    assert "torch.distributed" in err
    assert (tmp_path / "port.maf").read_bytes() == (tmp_path / "ref.maf").read_bytes()
    port_store = _store_tree(tmp_path / "port_store")
    assert port_store == _store_tree(tmp_path / "ref_store")
    assert sum(k.startswith("pairs") for k in port_store) == 3


# --------------------------------------------------------------------------
# align -distributed: two real processes
# --------------------------------------------------------------------------


def _rank_env(rank: int, world: int, port: int) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in _WORLD_ENV}
    env.update(
        PYTHONPATH=ROOT, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
        MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
    )
    return env


def _run_ranks(argvs: list[list[str]], timeout: float) -> list[str]:
    """One process per argv, rank i of a world of len(argvs); each must
    exit 0 within `timeout` seconds.  Returns their stderr."""
    port = chip_smoke._free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "paramugsy_tpu_torch.cli", *argv], cwd=ROOT,
            env=_rank_env(rank, len(argvs), port),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for rank, argv in enumerate(argvs)
    ]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, err) in enumerate(zip(procs, errs)):
        assert p.returncode == 0, (rank, err)
    return errs


def _phase_row(stats: str, phase: str) -> list[str]:
    """The ``-stats`` report's row of `phase` (count, total_s, mean_s,
    items), or zeros when the phase never ran."""
    for line in stats.splitlines():
        words = line.split()
        if words and words[0] == phase:
            return words[1:]
    return ["0", "0", "0", "0"]


def _phase_items(stats: str, phase: str) -> int:
    return int(_phase_row(stats, phase)[3])


def _phase_count(stats: str, phase: str) -> int:
    return int(_phase_row(stats, phase)[0])


@pytest.fixture(scope="module")
def family(tmp_path_factory):
    """bench.build_family at 4 x 40 kb, written by the smoke's writer."""
    return chip_smoke.family_fastas(str(tmp_path_factory.mktemp("family")), 40_000, 4)


@pytest.fixture(scope="module")
def dup_family(tmp_path_factory):
    """The family of `family` with a 2 kb direct duplication planted in
    each genome (bases 5000-7000 copied onto 30000-32000)."""
    tmp = str(tmp_path_factory.mktemp("dup_family"))
    lut = np.zeros(256, np.int8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    paths = []
    for g in chip_smoke.build_family(np.random.default_rng(7), 40_000, count=4):
        (name, seq), = g.seqs.items()
        codes = lut[np.frombuffer(seq.encode(), np.uint8)]
        codes = chip_smoke.plant_copies(codes, [(5000, 30_000, 2000, False)])
        paths.append(chip_smoke.write_fasta(os.path.join(tmp, f"{g.name}.fa"), name, codes))
    return paths


@pytest.mark.parametrize("flags", [[], ["-duplications"]], ids=["plain", "duplications"])
def test_two_ranks_equal_reference(family, dup_family, tmp_path, flags):
    """Two processes of ``align -distributed -tmp_dir <shared> -device
    cpu``, ranks 0 and 1 of a gloo world: both MAFs are the reference's
    single-process MAF (and its two owners'), and the shared store holds
    each of the 6 pairs once, as the reference's store does.  With -duplications (on the
    family with a planted duplication) only rank 0 adds the duplication
    blocks, the reference's rule, so rank 1's MAF is the reference's
    without them."""
    if flags:
        family = dup_family
    ref_argv = ["align", *family, "-tmp_dir", str(tmp_path / "ref_store")]
    assert ref_cli.main([*ref_argv, "-out_maf", str(tmp_path / "ref.maf")]) == 0
    want = {"": (tmp_path / "ref.maf").read_bytes()}
    if flags:
        assert ref_cli.main(["align", *family, *flags,
                             "-out_maf", str(tmp_path / "ref_dup.maf")]) == 0
        want["dup"] = (tmp_path / "ref_dup.maf").read_bytes()
        assert want["dup"] != want[""] and b"label=dup1" in want["dup"]
    # The reference's own two owners of one store give the same MAFs here
    # (not on every input: ROADMAP queue C).
    assert _ref_two_owners(family, tmp_path / "ref_owners", bool(flags)) == [
        want["dup" if flags else ""], want[""]
    ]
    store = str(tmp_path / "store")
    errs = _run_ranks(
        [["align", *family, "-distributed", "-tmp_dir", store, *flags, "-stats",
          "-out_maf", str(tmp_path / f"rank{r}.maf"), "-device", "cpu"] for r in (0, 1)],
        timeout=240,
    )
    # The ranks split the work: summed over them, each pair was computed
    # once and each of the 3 merges ran once (one process alone would
    # have computed all of it).
    assert sum(_phase_items(err, "pairwise") for err in errs) == 6, errs
    assert sum(_phase_count(err, "merge") for err in errs) == 3, errs
    assert (tmp_path / "rank0.maf").read_bytes() == want["dup" if flags else ""]
    assert (tmp_path / "rank1.maf").read_bytes() == want[""]
    tree = _store_tree(store)
    assert sorted(k for k in tree if k.startswith("pairs")) == sorted(
        k for k in _store_tree(tmp_path / "ref_store") if k.startswith("pairs")
    )
    assert sum(k.startswith("pairs") for k in tree) == 6


def _ref_two_owners(paths, tmp, duplications: bool) -> list[bytes]:
    """The MAFs of the reference's executor as process 0 and process 1 of
    two (threads standing in for processes) sharing one store."""
    import threading

    from paramugsy_tpu.pipeline import PipelineConfig as RefPipelineConfig
    from paramugsy_tpu.runtime import executor as ref_executor

    tmp.mkdir()
    errors = []

    def run(i):
        try:
            ref_executor.align_fastas_concurrent(
                paths, str(tmp / f"p{i}.maf"), RefPipelineConfig(duplications=duplications),
                tmp_dir=str(tmp / "store"), process_index=i, process_count=2,
            )
        except Exception as e:  # re-raised in the test's thread below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=240)
        assert not t.is_alive()
    if errors:
        raise errors[0]
    return [(tmp / f"p{i}.maf").read_bytes() for i in (0, 1)]


def test_two_ranks_keep_the_reference_pair_order(tmp_path):
    """On the realistic fixture's first four genomes the reference's two
    owners of one store write another MAF than its single process: a
    merge takes the deltas of its owned pairs first and of the pairs it
    waited for last, and its result depends on that order (ROADMAP queue
    C).  The port's two ranks write the reference's two-owner MAF."""
    import glob

    paths = sorted(glob.glob(os.path.join(ROOT, "tests", "data", "realistic", "*.fa")))[:4]
    assert ref_cli.main(["align", *paths, "-out_maf", str(tmp_path / "ref.maf")]) == 0
    want = _ref_two_owners(paths, tmp_path / "ref_owners", False)
    assert want[0] == want[1] != (tmp_path / "ref.maf").read_bytes()
    store = str(tmp_path / "store")
    _run_ranks(
        [["align", *paths, "-distributed", "-tmp_dir", store,
          "-out_maf", str(tmp_path / f"rank{r}.maf"), "-device", "cpu"] for r in (0, 1)],
        timeout=240,
    )
    assert [(tmp_path / f"rank{r}.maf").read_bytes() for r in (0, 1)] == want


_JOIN_ALONE = r"""
import datetime, sys, time
import torch.distributed as dist
from paramugsy_tpu_torch.runtime.dist import init_distributed
t0 = time.monotonic()
try:
    init_distributed(timeout=datetime.timedelta(seconds=float(sys.argv[1])))
except dist.DistError as e:
    print("raised", type(e).__name__, time.monotonic() - t0)
else:
    print("joined")
"""


@pytest.mark.parametrize("rank", [0, 1])
def test_world_that_cannot_form_raises(rank):
    """A world of two with only one rank started raises once its timeout
    runs out, whichever rank it is (0 serves the rendezvous, 1 connects
    to it); it never goes on as one process."""
    res = subprocess.run(
        [sys.executable, "-c", _JOIN_ALONE, "3"], cwd=ROOT,
        env=_rank_env(rank, 2, chip_smoke._free_port()), capture_output=True, text=True, timeout=60,
    )
    assert res.returncode == 0, res.stderr
    words = res.stdout.split()
    assert words[0] == "raised", res.stdout
    assert 3 <= float(words[2]) < 30, res.stdout


def test_one_process_world_and_rank_device(monkeypatch):
    """Without MASTER_ADDR the world is one process and is left alone;
    under a CUDA device a rank takes card LOCAL_RANK modulo the count,
    and the CPU stays the CPU."""
    import torch.distributed as dist

    from paramugsy_tpu_torch.runtime import dist as port_dist
    from paramugsy_tpu.runtime import dist as ref_dist

    ctx = port_dist.init_distributed()
    assert (ctx.initialized, ctx.process_index, ctx.process_count, ctx.is_primary) == (
        False, 0, 1, True
    )
    assert not dist.is_initialized()
    port_dist.shutdown_distributed(ctx)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert port_dist.rank_device(torch.device("cpu")) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert port_dist.rank_device(torch.device("cuda")) == torch.device("cuda", 1)
    for n, count in ((10, 3), (7, 2), (1, 4)):
        for i in range(count):
            got = port_dist.local_pair_slice(n, port_dist.DistContext(True, i, count, 1))
            want = ref_dist.local_pair_slice(n, ref_dist.DistContext(True, i, count, 1))
            assert got == want


def test_world_of_two_without_tmp_dir_raises(family, tmp_path, monkeypatch):
    """A rank of a world of two without -tmp_dir raises the reference's
    ValueError: the ranks have no store to meet in."""
    from paramugsy_tpu_torch.runtime import dist as port_dist

    monkeypatch.setattr(
        port_dist, "init_distributed", lambda: port_dist.DistContext(True, 0, 2, 0)
    )
    argv = ["align", *family[:2], "-distributed", "-out_maf", str(tmp_path / "o.maf"),
            "-device", "cpu"]
    with pytest.raises(ValueError, match="multi-host runs require a shared tmp_dir store"):
        port_cli.main(argv)
    assert not (tmp_path / "o.maf").exists()


# --------------------------------------------------------------------------
# The kernel build that ranks starting together share
# --------------------------------------------------------------------------


_STUB_NVCC = r"""#!{python}
import os, sys, time
with open(os.environ["STUB_NVCC_CALLS"], "a") as f:
    f.write(" ".join(sys.argv[1:]) + "\n")
time.sleep(0.5)
out = sys.argv[sys.argv.index("-o") + 1]
with open(out, "w") as f:
    f.write("stub output of " + " ".join(sys.argv[1:]))
print("stub report of " + os.path.basename(out))
"""

_BUILD_IN = r"""
import os, sys
from paramugsy_tpu_torch.ops import _kernels
d = sys.argv[1]
_kernels.BUILD_DIR = d
_kernels.LIB_PATH = os.path.join(d, "libpm_kernels.so")
_kernels.LOG_PATH = os.path.join(d, "nvcc.log")
_kernels.LOCK_PATH = os.path.join(d, "kernels.lock")
print(_kernels.build())
"""


def test_kernel_build_runs_once_across_processes(tmp_path):
    """Six processes call ``_kernels.build()`` at once on a build
    directory without the library, with a stub compiler on PATH that
    takes half a second a call: one process compiles (three sources, one
    link), the others wait on the lock and find the library current; the
    compiler's log holds that one build whole."""
    from paramugsy_tpu_torch.ops import _kernels

    bin_dir, build_dir = tmp_path / "bin", tmp_path / "build"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(_STUB_NVCC.replace("{python}", sys.executable))
    nvcc.chmod(0o755)
    calls = tmp_path / "calls.txt"
    env = dict(os.environ, PYTHONPATH=ROOT, STUB_NVCC_CALLS=str(calls),
               PATH=f"{bin_dir}{os.pathsep}{os.environ.get('PATH', '')}")
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _BUILD_IN, str(build_dir)], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for _ in range(6)
    ]
    outs = [p.communicate(timeout=120) for p in procs]
    lib = str(build_dir / "libpm_kernels.so")
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split() == [lib], (out, err)
    lines = calls.read_text().splitlines()
    assert sum(" -c " in line for line in lines) == len(_kernels.SOURCES)
    assert sum("-shared" in line for line in lines) == 1
    assert len(lines) == len(_kernels.SOURCES) + 1, lines
    log = (build_dir / "nvcc.log").read_text()
    for name in [os.path.basename(src) + ".o" for src in _kernels.SOURCES] + ["lib.so"]:
        assert log.count(f"stub report of {name}\n") == 1, log
    assert len(log.splitlines()) == 2 * len(lines), log
    assert (build_dir / "libpm_kernels.so").read_text().startswith("stub output of")
