"""The port's host-only commands against the reference's: the eight MAF
and delta tools (`tools/`), the five ``profiles`` subcommands, and the
exact LCB selection oracle (`lcb.exact`); their sources are the
reference's but for the imports.

Three inputs go through both packages: the MAF fixture
``highly_stitchable.maf`` (4 genomes of 100 bp, end gaps and one overlap),
the realistic fixture of ``test_torch_host`` (the first 30 kb of g0-g2,
g0 aligned to each of the others on the port's CPU path: pairwise blocks
whose g0 rows overlap) and a 3-genome MAF written by the port's
``align -sequential -device cpu`` on the same 30 kb slices.  Each command
runs through both ``cli.main``s on the same input paths, writing into two
output directories; their exit codes, stdout, stderr and every output
file's bytes must be equal.  Dataclasses of the two packages are compared
as field tuples (``test_torch_host.fields``).
"""
import inspect
import io
import os

import numpy as np
import pytest
import torch

from paramugsy_tpu import cli as ref_cli
from paramugsy_tpu import formats as ref_formats
from paramugsy_tpu.coords import range as ref_range
from paramugsy_tpu.formats import delta_maf as ref_delta_maf
from paramugsy_tpu.lcb import exact as ref_exact
from paramugsy_tpu.tools import maf_analyzer as ref_analyzer
from paramugsy_tpu.tools import maffiller as ref_filler
from paramugsy_tpu.tools import mafstat as ref_mafstat
from paramugsy_tpu.tools import mafvalidate as ref_validate
from paramugsy_tpu.tools import misc as ref_misc
from paramugsy_tpu.tools import stitch as ref_stitch
from paramugsy_tpu.tools import synchain as ref_synchain
from paramugsy_tpu_torch import cli as port_cli
from paramugsy_tpu_torch import formats as port_formats
from paramugsy_tpu_torch.coords import range as port_range
from paramugsy_tpu_torch.formats import delta_maf as port_delta_maf
from paramugsy_tpu_torch.lcb import exact as port_exact
from paramugsy_tpu_torch.lcb.merge import select_consistent
from paramugsy_tpu_torch.pipeline import load_genome
from paramugsy_tpu_torch.profiles.translate import translate
from paramugsy_tpu_torch.tools import maf_analyzer as port_analyzer
from paramugsy_tpu_torch.tools import maffiller as port_filler
from paramugsy_tpu_torch.tools import mafstat as port_mafstat
from paramugsy_tpu_torch.tools import mafvalidate as port_validate
from paramugsy_tpu_torch.tools import misc as port_misc
from paramugsy_tpu_torch.tools import stitch as port_stitch
from paramugsy_tpu_torch.tools import synchain as port_synchain
from tests.test_torch_host import DATA, _realistic, fields

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = ("stitchable", "realistic", "aligned")
REF = dict(cli=ref_cli, formats=ref_formats, range=ref_range, delta_maf=ref_delta_maf,
           exact=ref_exact, analyzer=ref_analyzer, filler=ref_filler,
           mafstat=ref_mafstat, validate=ref_validate, misc=ref_misc,
           stitch=ref_stitch, synchain=ref_synchain)
PORT = dict(cli=port_cli, formats=port_formats, range=port_range, delta_maf=port_delta_maf,
            exact=port_exact, analyzer=port_analyzer, filler=port_filler,
            mafstat=port_mafstat, validate=port_validate, misc=port_misc,
            stitch=port_stitch, synchain=port_synchain)


def _write_fastas(d, seqs) -> list[str]:
    paths = []
    for name, seq in seqs.items():
        path = os.path.join(d, f"{name.split('.')[0]}.fa")
        with open(path, "w") as f:
            port_formats.write_fasta(f, [(name, seq)])
        paths.append(path)
    return paths


def _inputs(root: str) -> dict:
    """Per input: the MAF, its genomes' FASTAs (one file each, and all in
    one), a delta over its sequences, the profile dirs of the MAF (left)
    and of one single-row block per sequence (right), and a MAF over the
    two dirs' pseudo-sequences, built as the merge step builds it."""
    out = {}
    realistic_maf, realistic_delta, realistic_seqs = _realistic()
    for name in INPUTS:
        d = os.path.join(root, name)
        os.makedirs(d)
        maf = os.path.join(d, "in.maf")
        seqs, delta_text = dict(realistic_seqs), realistic_delta
        if name == "stitchable":
            maf = os.path.join(DATA, "highly_stitchable.maf")
            rng = np.random.default_rng(14)
            seqs = {s.name: "".join(rng.choice(list("ACGT"), s.src_size))
                    for b in port_formats.read_maf(maf) for s in b.seqs}
        elif name == "realistic":
            with open(maf, "w") as f:
                f.write(realistic_maf)
        else:
            os.makedirs(os.path.join(d, "genomes"))
            paths = _write_fastas(os.path.join(d, "genomes"), seqs)
            argv = ["align", "-sequential", *paths, "-out_maf", maf, "-device", "cpu"]
            assert port_cli.main(argv) == 0
            # The MAF names its rows "<genome>.<record>" (pipeline.load_genome).
            seqs = {}
            for path in paths:
                seqs.update(load_genome(path).seqs)
        if name != "realistic":
            # Its deltas: the first two rows of each block of several rows.
            blocks = port_formats.read_maf(maf)
            pairs = [type(b)(seqs=b.seqs[:2]) for b in blocks if len(b.seqs) > 1]
            buf = io.StringIO()
            w = port_formats.DeltaWriter(buf, "a.fa", "b.fa")
            for e in port_delta_maf.maf_blocks_to_deltas(pairs):
                w.write(e)
            delta_text = buf.getvalue()
        fastas = _write_fastas(d, seqs)
        all_fa = os.path.join(d, "all.fasta")
        with open(all_fa, "w") as f:
            port_formats.write_fasta(f, seqs.items())
        delta = os.path.join(d, "in.delta")
        with open(delta, "w") as f:
            f.write(delta_text)
        with open(os.path.join(d, "nucmers.list"), "w") as f:
            f.write(delta + "\n")
        singles = os.path.join(d, "singles.maf")
        with open(singles, "w") as f:
            port_formats.maf.fasta_to_maf(all_fa, f)
        left, right = os.path.join(d, "left"), os.path.join(d, "right")
        for path, src in ((left, maf), (right, singles)):
            argv = ["profiles", "make", "-basename", os.path.basename(path),
                    "-out_dir", path, "-in_maf", src]
            assert port_cli.main(argv) == 0
        with open(os.path.join(d, "dirs.list"), "w") as f:
            f.write(f"{left}\n{right}\n")
        translated = io.StringIO()
        translate(left, right, [delta], translated)
        entries = list(port_formats.read_delta(io.StringIO(translated.getvalue())))
        kept, _ = select_consistent(entries, min_length=10)
        cons = [dict(port_formats.read_fasta(os.path.join(p, "sequences.fasta")))
                for p in (left, right)]
        pseudo = os.path.join(d, "pseudo.maf")
        port_formats.write_maf(pseudo, port_delta_maf.delta_to_maf_blocks(kept, *cons))
        out[name] = dict(dir=d, maf=maf, fastas=fastas, all_fa=all_fa, delta=delta,
                         left=left, right=right, pseudo=pseudo, n_kept=len(kept))
    return out


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return _inputs(str(tmp_path_factory.mktemp("tools_inputs")))


# Each command's argv over one input (`i`) and an output directory (`o`).
COMMANDS = {
    "mafstat": lambda i, o: ["mafstat", i["maf"], "-out_dir", o],
    "mafvalidate": lambda i, o: ["mafvalidate", i["maf"]],
    "mafdefrag": lambda i, o: ["mafdefrag", i["maf"], f"{o}/out.maf",
                               "-synchain", f"{o}/edges"],
    "stitch": lambda i, o: ["stitch", i["maf"], f"{o}/out.maf"],
    "maffiller": lambda i, o: ["maffiller", i["maf"], *i["fastas"],
                               "-out_maf", f"{o}/out.maf"],
    "analyzer": lambda i, o: ["analyzer", i["maf"]],
    "mafclean": lambda i, o: ["mafclean", i["maf"]],
    "mafclean-file": lambda i, o: ["mafclean", i["maf"], f"{o}/out.maf"],
    "fastafmt": lambda i, o: ["fastafmt", i["all_fa"], "-width", "60"],
    "sortdelta": lambda i, o: ["sortdelta", i["delta"]],
    "sortdelta-file": lambda i, o: ["sortdelta", i["delta"], f"{o}/out.delta"],
    "profiles-make": lambda i, o: ["profiles", "make", "-basename", "p",
                                   "-out_dir", f"{o}/p", "-in_maf", i["maf"]],
    "profiles-translate": lambda i, o: [
        "profiles", "translate", i["left"], i["right"],
        "-nucmer_list", f"{i['dir']}/nucmers.list", "-out_delta", f"{o}/out.delta"],
    "profiles-untranslate": lambda i, o: [
        "profiles", "untranslate", "-profile_paths_list", f"{i['dir']}/dirs.list",
        "-in_maf", i["pseudo"], "-out_maf", f"{o}/out.maf"],
    "profiles-maf_to_xmfa": lambda i, o: ["profiles", "maf_to_xmfa", "-in_maf", i["maf"]],
    "profiles-fasta_to_maf": lambda i, o: ["profiles", "fasta_to_maf", "-in_fasta",
                                           i["all_fa"], "-out_maf", f"{o}/out.maf"],
}


COPIES = ("tools/__init__.py", "tools/synchain.py", "tools/mafvalidate.py", "tools/stitch.py",
          "tools/maffiller.py", "tools/maf_analyzer.py", "tools/mafstat.py", "tools/misc.py",
          "lcb/exact.py")


@pytest.mark.parametrize("path", COPIES)
def test_copies_differ_from_reference_only_in_imports(path):
    """Each copied module is the reference's with ``paramugsy_tpu``
    re-pointed to ``paramugsy_tpu_torch``."""
    with open(os.path.join(ROOT, "paramugsy_tpu", path)) as f:
        want = f.read()
    with open(os.path.join(ROOT, "paramugsy_tpu_torch", path)) as f:
        got = f.read()
    assert got.replace("paramugsy_tpu_torch", "paramugsy_tpu") == want


def test_profiles_main_differs_from_reference_only_in_imports():
    want, got = (inspect.getsource(c._profiles_main) for c in (ref_cli, port_cli))
    assert got.replace("paramugsy_tpu_torch", "paramugsy_tpu") == want


def _run(cli, argv, out_dir, capsys):
    """(exit code or the exception raised, stdout, stderr, {file: bytes})."""
    os.makedirs(out_dir)
    try:
        result = cli.main(argv)
    except Exception as e:  # maffiller on overlapping blocks
        result = (type(e).__name__, str(e))
    out, err = capsys.readouterr()
    files = {}
    for dirpath, _, names in os.walk(out_dir):
        for n in names:
            path = os.path.join(dirpath, n)
            with open(path, "rb") as f:
                files[os.path.relpath(path, out_dir)] = f.read()
    return result, out, err, files


@pytest.mark.parametrize("name", INPUTS)
@pytest.mark.parametrize("command", sorted(COMMANDS))
def test_command_equals_reference(command, name, inputs, tmp_path, capsys):
    i = inputs[name]
    want = _run(ref_cli, COMMANDS[command](i, str(tmp_path / "ref")), tmp_path / "ref", capsys)
    got = _run(port_cli, COMMANDS[command](i, str(tmp_path / "port")), tmp_path / "port", capsys)
    assert got == want
    result, out, _, files = got
    if command == "maffiller" and name != "aligned":  # overlapping blocks
        assert result[0] == "ValueError" and "overlaps" in result[1]
    elif command == "mafvalidate":
        assert result == (0 if name == "aligned" else 1) and bool(out) == bool(result)
    else:  # every other command succeeded and did real work on this input
        assert result == 0 and (out or files), command
    for data in files.values():
        assert data
    if command == "profiles-translate":
        assert files["out.delta"].count(b"\n>") >= 1
    if command == "profiles-untranslate":
        assert i["n_kept"] and files["out.maf"].count(b"\na ") >= i["n_kept"]


def test_inputs_reach_their_cases(inputs):
    """The aligned MAF tiles its genomes (no faults), the fixture has an
    overlap, and the realistic pairwise blocks overlap on g0."""
    faults = {n: port_validate.find_faults(i["maf"]) for n, i in inputs.items()}
    assert faults["aligned"] == []
    assert any(f.kind == "Overlap" for f in faults["stitchable"])
    assert any(f.kind == "Overlap" and f.seq.startswith("g0.") for f in faults["realistic"])
    assert len({s.name for b in port_formats.read_maf(inputs["aligned"]["maf"])
                for s in b.seqs}) == 3


def _module_results(m, i):
    """Every module function of tools/ on one input, as comparable values."""
    path = i["maf"]
    blocks = list(m["formats"].read_maf(path))
    seqs = {}
    for fa in i["fastas"]:
        seqs.update(m["formats"].read_fasta(fa))
    # Drop every third block so that a MAF without overlaps has gaps to fill.
    try:
        filled = fields(m["filler"].fill_blocks(blocks[::3] + blocks[1::3], seqs))
    except ValueError as e:
        filled = ("ValueError", str(e))
    edges = io.StringIO()
    m["synchain"].write_synchain(blocks, edges)
    # One chain per block: its rows in the chainer's "I seq dir start-stop ;" form.
    index = {n: k for k, n in enumerate(sorted({s.name for b in blocks for s in b.seqs}))}
    chained = "".join(
        "I " + " ".join(
            f"{index[s.name]} {s.strand_char} {s.forward_interval()[0]}-{s.forward_interval()[1] + 1}"
            for s in b.seqs
        ) + " ;\n"
        for b in blocks
    )
    chains = m["synchain"].read_chained(io.StringIO("V 1\n" + chained))
    with open(i["delta"]) as f:
        entries = list(m["formats"].read_delta(f))
    return dict(
        stats=fields(m["mafstat"].compute_stats(path)),
        sp_identity=m["mafstat"].compute_stats(blocks).sp_identity,
        faults=fields(m["validate"].find_faults(path)),
        faults_no_ends=fields(m["validate"].find_faults(blocks, check_ends=False)),
        stitched=fields(m["stitch"].stitch_blocks(blocks)),
        filled=filled,
        missing=m["analyzer"].missing_ranges(path),
        covered=m["analyzer"].covered_ranges(blocks),
        sorted_deltas=fields(m["misc"].sort_delta_entries(entries)),
        edges=edges.getvalue(),
        chains=fields(chains),
        chain_faults=fields(m["synchain"].verify_chains(chains)),
    )


@pytest.mark.parametrize("name", INPUTS)
def test_module_functions_equal_reference(name, inputs):
    want = _module_results(REF, inputs[name])
    got = _module_results(PORT, inputs[name])
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], key
    assert got["edges"] and got["chains"] and got["stitched"] and got["sorted_deltas"]
    if name == "aligned":
        assert got["filled"][0] != "ValueError"
        assert len(got["filled"]) > len(got["stitched"]) // 2


def _lcb_instance(m, rng, n_entries, n_seqs=2, span=8000):
    """Random delta entries, built as tests/test_profiles.py builds them."""
    Range = m["range"].Range
    out = []
    for _ in range(n_entries):
        rs = int(rng.integers(1, span))
        rl = int(rng.integers(60, 900))
        qs = int(rng.integers(1, span))
        ql = rl + int(rng.integers(-10, 11))
        fwd = bool(rng.integers(0, 2))
        q = Range(qs, qs + ql) if fwd else Range(qs + ql, qs)
        out.append(
            m["formats"].DeltaEntry(
                ref_name=f"r{int(rng.integers(n_seqs))}.c",
                query_name=f"q{int(rng.integers(n_seqs))}.c",
                ref_len=span + 1000, query_len=span + 1000,
                ref_range=Range(rs, rs + rl), query_range=q,
                ref_gaps=[], query_gaps=[],
            )
        )
    return out


@pytest.mark.parametrize("seed", range(20))
def test_exact_selection_equals_reference(seed):
    results = []
    for m in (REF, PORT):
        rng = np.random.default_rng(seed)
        inst = _lcb_instance(m, rng, int(rng.integers(4, 13)))
        kept, opt = m["exact"].select_exact(inst)
        results.append((fields(kept), opt, m["exact"].greedy_weight(inst),
                        m["exact"].select_exact(inst, min_length=400)[1]))
    assert results[1] == results[0]
    assert results[1][1] > 0


def test_error_paths_equal_reference(inputs, tmp_path, capsys):
    """A broken chain, faults, a bare or unknown ``profiles`` and an
    overlapping MAF: the same exit codes, messages and exceptions."""
    fixture = inputs["stitchable"]["maf"]
    bad = tmp_path / "bad_chain.txt"
    bad.write_text("I 0 + 10-20 0 + 25-30 ;\n")
    cases = [
        (["mafdefrag", fixture, "{o}/out.maf", "-chained", str(bad)], 1),
        (["mafvalidate", fixture], 1),
        (["mafvalidate", fixture, "--no-ends"], 1),
        (["profiles"], 2),
        (["profiles", "merge"], 2),
    ]
    outs = []
    for k, (argv, code) in enumerate(cases):
        runs = []
        for cli, side in ((ref_cli, "ref"), (port_cli, "port")):
            o = str(tmp_path / f"{side}{k}")
            os.makedirs(o)
            runs.append((cli.main([a.format(o=o) for a in argv]), capsys.readouterr()))
        assert runs[1] == runs[0], argv
        assert runs[1][0] == code, argv
        outs.append(runs[1][1])
    assert outs[0].out.startswith("chain fault: accession 0 ")
    assert "Overlap\tB\t" in outs[2].out or "Overlap\t" in outs[2].out
    assert outs[3].err.startswith("usage: paramugsy-tpu profiles ")
    assert outs[4].err == "unknown profiles subcommand: merge\n"
    messages = []
    for m in (REF, PORT):
        blocks = list(m["formats"].read_maf(fixture))
        with pytest.raises(ValueError) as info:
            m["filler"].fill_blocks(blocks, {})
        messages.append(str(info.value))
    assert messages[1] == messages[0] and "overlaps" in messages[0]


def test_smoke_phase15_steps_equal_reference(inputs, tmp_path):
    """chip_smoke's phase 15 at a small size through both packages: the
    tools on the aligned MAF (a tiling, as phase 15's inputs are) and on
    the realistic delta and FASTA, and the profile toolchain
    over two halves of a 4 x 20 kb family (build_family), ``align`` and
    ``nucmer`` on the port's CPU path.  Every step's exit codes and digest
    must equal the reference's."""
    from types import SimpleNamespace

    import chip_smoke
    from paramugsy_tpu.lcb import merge as ref_merge

    ref = SimpleNamespace(
        cli=ref_cli, read_delta=ref_formats.read_delta, read_fasta=ref_formats.read_fasta,
        write_maf=ref_formats.write_maf, delta_to_maf_blocks=ref_delta_maf.delta_to_maf_blocks,
        select_consistent=ref_merge.select_consistent,
    )
    os.makedirs(tmp_path / "family")
    family = chip_smoke.family_fastas(str(tmp_path / "family"), 20_000, 4)
    mafs = {"aligned": inputs["aligned"]["maf"]}
    fastas = {"aligned": inputs["aligned"]["fastas"]}
    runs = []
    for m, side, device_args in ((ref, "ref", []),
                                 (chip_smoke.port_modules(), "port", ["-device", "cpu"])):
        steps = chip_smoke.host_tool_steps(
            m.cli, mafs, fastas, inputs["realistic"]["delta"], inputs["realistic"]["all_fa"],
            str(tmp_path / side / "a"))
        steps += chip_smoke.profile_chain_steps(
            m, [family[:2], family[2:]], str(tmp_path / side / "b"), device_args)
        runs.append(steps)
    want, got = ([(s["step"], s["rcs"], s["sha256"]) for s in steps] for steps in runs)
    assert got == want
    by_step = {s["step"]: s for s in runs[1]}
    assert len(by_step) == 7 + 2 + 9
    assert by_step["profiles/nucmer"]["rcs"] == [0] * 4
    assert by_step["profiles/merge_maf"]["entries"] > 0
    assert by_step["aligned/mafvalidate"]["rcs"] == [0]
    assert by_step["profiles/translate"]["rcs"] == [0]
