"""The port's nucmer CLI against the reference's, and the port's import
boundary: no module of paramugsy_tpu_torch imports JAX or the JAX package
(paramugsy_tpu), neither on import nor while running ``nucmer``, a
windowed ``align_pair``, ``align -sequential -refine``, ``repeats``,
``align -sequential -duplications``, ``align`` on the concurrent
executor with ``-tmp_dir``, ``mugsy`` and ``align -distributed``, and no
import statement in its sources names them.  The host-only commands
(``mafstat``, ``profiles make``) do not even import torch."""
import io
import os
import subprocess
import sys

import numpy as np
import torch

from bench import build_pair
from paramugsy_tpu import cli as ref_cli
from paramugsy_tpu_torch import cli as port_cli

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_fastas(tmp_path):
    ref, q = build_pair(np.random.default_rng(4), 60_000)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    paths = []
    for name, records in (
        ("genome_a", [ref[:30_000], ref[30_000:]]),
        ("genome_b", [q]),
    ):
        path = tmp_path / f"{name}.fasta"
        with open(path, "w") as f:
            for i, codes in enumerate(records):
                f.write(f">{name}_contig{i}\n{acgt[codes].tobytes().decode()}\n")
        paths.append(str(path))
    return paths


def test_nucmer_cli_equals_reference(tmp_path):
    ref_fa, qry_fa = _write_fastas(tmp_path)
    for flags in ([], ["-one_to_one"], ["-colinear", "-minlength", "25"]):
        outs = {}
        for name, run in (
            ("ref", ref_cli._nucmer_main),
            ("port", lambda argv: port_cli.main(["nucmer", *argv, "-device", "cpu"])),
        ):
            delta = tmp_path / f"{name}.delta"
            maf = tmp_path / f"{name}.maf"
            argv = ["-ref_seq", ref_fa, "-query_seq", qry_fa,
                    "-out_delta", str(delta), "-out_maf", str(maf), *flags]
            assert run(argv) == 0
            outs[name] = (delta.read_text(), maf.read_text())
        assert outs["port"] == outs["ref"], flags
        assert outs["port"][0].count("\n") > 3


def test_smoke_inputs_and_delta_helpers_match_reference():
    """chip_smoke.py imports only the port: its copy of bench.build_pair
    and its delta parsing must agree with the reference's."""
    import chip_smoke
    from paramugsy_tpu.formats.delta import DeltaWriter
    from paramugsy_tpu.ops.align_pair import AlignConfig, align_pair

    want = build_pair(np.random.default_rng(12345), 60_000)
    got = chip_smoke.build_pair(np.random.default_rng(12345), 60_000)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    ref, q = want
    q = np.concatenate([q[:20_000], q[20_030:40_000], ref[39_000:39_025], q[40_000:]])
    entries = align_pair(ref, q, "r.c", "q.c", AlignConfig())
    assert any(e.ref_gaps for e in entries) and any(e.query_gaps for e in entries)
    text = port_cli.delta_text(entries, "a.fa", "b.fa")
    buf = io.StringIO()
    w = DeltaWriter(buf, "a.fa", "b.fa")
    for e in entries:
        w.write(e)
    assert text == buf.getvalue()
    assert chip_smoke.aligned_bp(text) == sum(e.alignment_length() for e in entries)


def _imported_tops(path: str) -> set:
    """Top-level names of every import statement in a source file, those
    inside functions included (relative imports count as the port)."""
    import ast

    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add("paramugsy_tpu_torch" if node.level else node.module)
    return {n.split(".")[0] for n in names}


def test_smoke_imports_only_the_port():
    """chip_smoke.py imports nothing of JAX, of the JAX package or of its
    bench script, directly: only the port and the standard library."""
    tops = _imported_tops(os.path.join(ROOT, "chip_smoke.py"))
    assert "paramugsy_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "paramugsy_tpu", "bench"}, tops


def test_port_sources_import_neither_jax_nor_the_reference():
    """No import statement anywhere in paramugsy_tpu_torch/, at module
    level or inside a function, names jax, jaxlib or paramugsy_tpu."""
    sources = []
    for dirpath, _, files in os.walk(os.path.join(ROOT, "paramugsy_tpu_torch")):
        sources += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    assert len(sources) >= 59
    assert os.path.join(ROOT, "paramugsy_tpu_torch", "runtime", "dist.py") in sources
    for name in ("wire", "mesh", "pair_shard", "collective"):
        assert os.path.join(ROOT, "paramugsy_tpu_torch", "parallel", f"{name}.py") in sources
    for name in ("__init__", "synchain", "mafvalidate", "stitch", "maffiller",
                 "maf_analyzer", "mafstat", "misc"):
        assert os.path.join(ROOT, "paramugsy_tpu_torch", "tools", f"{name}.py") in sources
    assert os.path.join(ROOT, "paramugsy_tpu_torch", "lcb", "exact.py") in sources
    for path in sources:
        bad = _imported_tops(path) & {"jax", "jaxlib", "paramugsy_tpu"}
        assert not bad, (os.path.relpath(path, ROOT), bad)


def test_cli_unknown_subcommand_returns_2(capsys):
    """A name that no command of the reference has, and no command: the
    usage line names every command, the reference's and ``sge``."""
    assert port_cli.main(["blastz"]) == 2
    assert port_cli.main([]) == 2
    err = capsys.readouterr().err
    assert "nucmer|align|local|sge|mugsy|repeats" in err
    usage = err.splitlines()[-1].split()[-2].split("|")
    assert sorted(usage) == sorted([
        "align", "local", "sge", "nucmer", "mugsy", "repeats", "profiles",
        "mafstat", "mafvalidate", "mafclean", "fastafmt", "mafdefrag",
        "maffiller", "analyzer", "sortdelta",
    ])


_NO_JAX = r"""
import importlib, pkgutil, runpy, sys
args = sys.argv[1:]

def reference_modules():
    return sorted(m for m in sys.modules if m == "paramugsy_tpu" or m.startswith("paramugsy_tpu."))

# The host-only commands first, in a process that has imported nothing of
# the port: they import neither jax, nor the reference, nor torch (so no
# kernel is built or loaded).
for argv in (["mafstat", "tests/data/highly_stitchable.maf", "-out_dir", args[18]],
             ["profiles", "make", "-basename", "p", "-out_dir", args[19],
              "-in_maf", "tests/data/highly_stitchable.maf"]):
    sys.argv = ["cli", *argv]
    try:
        runpy.run_module("paramugsy_tpu_torch.cli", run_name="__main__")
    except SystemExit as e:
        assert e.code == 0, e.code
    assert "jax" not in sys.modules, argv[0] + " pulled in jax"
    assert not reference_modules(), (argv[0], reference_modules())
    assert "paramugsy_tpu_torch.ops._kernels" not in sys.modules, argv[0]
    assert "torch" not in sys.modules, argv[0] + " imported torch"

import paramugsy_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    paramugsy_tpu_torch.__path__, "paramugsy_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert "jax" not in sys.modules, "importing the port pulled in jax"
assert not reference_modules(), reference_modules()
import torch
from paramugsy_tpu_torch.utils.platform import resolve_device
assert resolve_device("cpu").type == "cpu"
if not torch.cuda.is_available():
    try:
        resolve_device()
    except RuntimeError:
        pass
    else:
        raise AssertionError("cuda without a card must raise")
sys.argv = ["cli", "nucmer", "-ref_seq", args[0], "-query_seq", args[1],
            "-out_delta", args[2], "-out_maf", args[11], "-device", "cpu"]
try:
    runpy.run_module("paramugsy_tpu_torch.cli", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
assert "jax" not in sys.modules, "the nucmer CLI pulled in jax"
assert not reference_modules(), ("nucmer", reference_modules())
# The windowed pair path (a shrunk window: 3 x 3 window pairs).
import numpy as np
from paramugsy_tpu_torch.ops.align_pair import AlignConfig, align_pair
g = np.random.default_rng(1).integers(0, 4, 30000).astype(np.int8)
wcfg = AlignConfig(window=1 << 14, window_overlap=1 << 12)
windowed = align_pair(g, g.copy(), "a", "b", wcfg, device="cpu")
assert len(windowed) == 1 and windowed[0].ref_range.end == 30000, windowed
assert "jax" not in sys.modules, "the windowed path pulled in jax"
assert not reference_modules(), ("windowed", reference_modules())
# The multi-genome path with refinement and bridging: count the fused
# neighbours (bridge_adjacent) and the long refine segments.
import paramugsy_tpu_torch.lcb.merge as merge
from paramugsy_tpu_torch.ops import engines
fused = []
_fuse = merge._fuse_pair
merge._fuse_pair = lambda *a: fused.append(1) or _fuse(*a)
sys.argv = ["cli", "align", "-sequential", *args[3:6], "-refine",
            "-out_maf", args[6], "-device", "cpu"]
try:
    runpy.run_module("paramugsy_tpu_torch.cli", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
assert "jax" not in sys.modules, "align -sequential -refine pulled in jax"
assert not reference_modules(), ("align", reference_modules())
assert fused and engines.COUNTS.get("native-banded"), (len(fused), engines.COUNTS)
# The self-alignment path: the repeats command and align -duplications.
sys.argv = ["cli", "repeats", "-seq", args[0], "-out_delta", args[7], "-device", "cpu"]
try:
    runpy.run_module("paramugsy_tpu_torch.cli", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
sys.argv = ["cli", "align", "-sequential", "-duplications", args[0], args[1],
            "-out_maf", args[8], "-device", "cpu"]
try:
    runpy.run_module("paramugsy_tpu_torch.cli", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
assert "jax" not in sys.modules, "repeats / align -duplications pulled in jax"
assert not reference_modules(), ("self path", reference_modules())
# One dispatch per contig: 2 (repeats) + 2 + 1 (align).
assert engines.COUNTS.get("repeatcluster-cpu") == 5, engines.COUNTS
# The concurrent executor (align without -sequential) with its store.
sys.argv = ["cli", "align", args[0], args[1], "-tmp_dir", args[9],
            "-out_maf", args[10], "-device", "cpu"]
try:
    runpy.run_module("paramugsy_tpu_torch.cli", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
assert "jax" not in sys.modules, "align (concurrent, -tmp_dir) pulled in jax"
assert not reference_modules(), ("executor", reference_modules())
# mugsy over the nucmer MAF, and align -distributed as one process.
with open(args[12], "w") as f:
    f.write(args[0] + "\n" + args[1] + "\n")
with open(args[13], "w") as f:
    f.write(args[11] + "\n")
sys.argv = ["cli", "mugsy", "-out_dir", args[14], "-seq_list", args[12],
            "-maf_list", args[13], "-device", "cpu"]
try:
    runpy.run_module("paramugsy_tpu_torch.cli", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
sys.argv = ["cli", "align", "-distributed", args[0], args[1], "-tmp_dir", args[15],
            "-out_maf", args[16], "-device", "cpu"]
try:
    runpy.run_module("paramugsy_tpu_torch.cli", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
assert "torch.distributed" in sys.modules
assert "jax" not in sys.modules, "mugsy / align -distributed pulled in jax"
assert not reference_modules(), ("mugsy / distributed", reference_modules())
# The sharded data plane on two cpu slots, and the single-pair seeder.
from paramugsy_tpu_torch.parallel.collective import align_fastas_sharded
from paramugsy_tpu_torch.ops.seeding import find_seeds
align_fastas_sharded([args[0], args[1]], args[17], devices=["cpu", "cpu"])
find_seeds(torch.zeros(64, dtype=torch.int8), torch.zeros(64, dtype=torch.int8), k=16)
assert "jax" not in sys.modules, "the sharded plane pulled in jax"
assert not reference_modules(), ("sharded", reference_modules())
assert "paramugsy_tpu_torch.parallel.pair_shard" in names
print(len(names), "modules")
"""


def test_port_never_imports_jax(tmp_path):
    ref_fa, qry_fa = _write_fastas(tmp_path)
    genomes = sorted(
        os.path.join(ROOT, "tests", "data", "realistic", f) for f in ("g0.fa", "g1.fa", "g2.fa")
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    for name in ("PARAMUGSY_DEVICE_DP", "MASTER_ADDR"):
        env.pop(name, None)
    res = subprocess.run(
        [sys.executable, "-c", _NO_JAX, ref_fa, qry_fa, str(tmp_path / "o.delta"),
         *genomes, str(tmp_path / "o.maf"), str(tmp_path / "self.delta"),
         str(tmp_path / "dup.maf"), str(tmp_path / "store"), str(tmp_path / "conc.maf"),
         str(tmp_path / "pair.maf"), str(tmp_path / "seqs.list"),
         str(tmp_path / "mafs.list"), str(tmp_path / "mugsy"),
         str(tmp_path / "dist_store"), str(tmp_path / "dist.maf"),
         str(tmp_path / "sharded.maf"), str(tmp_path / "mafstat"),
         str(tmp_path / "profiles")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-2]) >= 20
    assert (tmp_path / "o.delta").read_text().startswith(ref_fa)
    assert (tmp_path / "o.maf").read_text().startswith("##maf")
    assert (tmp_path / "self.delta").read_text().startswith(f"{ref_fa} {ref_fa}")
    assert (tmp_path / "dup.maf").read_text().startswith("##maf")
    assert (tmp_path / "conc.maf").read_text().startswith("##maf")
    assert os.listdir(tmp_path / "store" / "pairs") == ["genome_a~genome_b.delta"]
    mugsy = (tmp_path / "mugsy" / "mugsy.maf").read_text()
    assert mugsy.startswith("##maf") and "mult=2" in mugsy
    assert res.stdout.splitlines()[:2] == [
        "num_genomes=4 core=80", str(tmp_path / "mugsy" / "mugsy.maf")]
    assert (tmp_path / "dist.maf").read_bytes() == (tmp_path / "conc.maf").read_bytes()
    assert (tmp_path / "sharded.maf").read_bytes() == (tmp_path / "conc.maf").read_bytes()
    assert "core\t80\n" in (tmp_path / "mafstat" / "core_genome").read_text()
    assert (tmp_path / "profiles" / "profiles").read_text()
    assert (tmp_path / "profiles" / "sequences.fasta").read_text().startswith(">p.p_0000\n")
