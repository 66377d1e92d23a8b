"""The port's copies of the reference's host modules (coords, formats,
profiles, lcb.score, tree) against the originals.

Both packages get the same inputs from the fixtures in tests/data: the
MAF file ``highly_stitchable.maf``, and blocks aligned from the first
30 kb of three genomes of ``realistic/``.  Results are compared as text,
bytes or field tuples: a dataclass instance of one package never equals
one of the other (dataclasses compare their classes), while ``Range``, a
NamedTuple, compares as it is.
"""
import dataclasses
import functools
import importlib
import io
import os

import numpy as np
import pytest
import torch

import paramugsy_tpu.formats as ref_formats
import paramugsy_tpu_torch.formats as port_formats
from paramugsy_tpu.formats import delta_maf as ref_delta_maf
from paramugsy_tpu.lcb import merge as ref_merge
from paramugsy_tpu.lcb import score as ref_score
from paramugsy_tpu.profiles import native_translate as ref_native_translate
from paramugsy_tpu.tree import guide_tree as ref_tree
from paramugsy_tpu.tree import job_tree as ref_job
from paramugsy_tpu_torch.coords.range import FORWARD
from paramugsy_tpu_torch.formats import delta_maf as port_delta_maf
from paramugsy_tpu_torch.lcb import merge as port_merge
from paramugsy_tpu_torch.lcb import score as port_score
from paramugsy_tpu_torch.ops.align_pair import AlignConfig, align_pair
from paramugsy_tpu_torch.ops.encode import encode
from paramugsy_tpu_torch.profiles import native_translate as port_native_translate
from paramugsy_tpu_torch.tree import guide_tree as port_tree
from paramugsy_tpu_torch.tree import job_tree as port_job

# Both profiles packages export functions named like these modules.
ref_translate = importlib.import_module("paramugsy_tpu.profiles.translate")
ref_untranslate = importlib.import_module("paramugsy_tpu.profiles.untranslate")
port_translate = importlib.import_module("paramugsy_tpu_torch.profiles.translate")
port_untranslate = importlib.import_module("paramugsy_tpu_torch.profiles.untranslate")

torch.set_num_threads(1)
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FIXTURES = ("stitchable", "realistic")


def fields(x):
    """Field values of dataclasses (recursively), lists, dicts and arrays
    as tuples: what compares across the two packages."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            fields(getattr(x, f.name)) for f in dataclasses.fields(x)
        )
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.tolist())
    if isinstance(x, dict):
        return tuple((k, fields(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return tuple(fields(v) for v in x)
    return x


def maf_text(formats, blocks) -> str:
    buf = io.StringIO()
    formats.write_maf(buf, blocks)
    return buf.getvalue()


def delta_text(formats, entries) -> str:
    buf = io.StringIO()
    w = formats.DeltaWriter(buf, "a.fa", "b.fa")
    for e in entries:
        w.write(e)
    return buf.getvalue()


@functools.lru_cache(maxsize=None)
def _realistic():
    """(MAF text, delta text, sequences): the first 30 kb of the first
    record of g0, g1 and g2, g0 aligned to each of the others on the
    port's CPU path; the blocks are those alignments in MAF form."""
    seqs = {}
    for g in ("g0", "g1", "g2"):
        name, seq = next(port_formats.read_fasta(os.path.join(DATA, "realistic", f"{g}.fa")))
        seqs[f"{g}.{name.split()[0]}"] = seq[:30_000]
    (rn, rs), *others = seqs.items()
    entries = []
    for qn, qs in others:
        entries += align_pair(
            encode(rs), encode(qs), rn, qn, AlignConfig(), device=torch.device("cpu")
        )
    assert len(entries) >= 2 and any(e.ref_gaps or e.query_gaps for e in entries)
    blocks = list(port_delta_maf.delta_to_maf_blocks(entries, seqs, seqs))
    return maf_text(port_formats, blocks), delta_text(port_formats, entries), seqs


def fixture(name: str, formats):
    """(blocks, delta entries) of one fixture, read by `formats`."""
    if name == "stitchable":
        # Its deltas: the first two rows of each block of several rows.
        blocks = list(formats.read_maf(os.path.join(DATA, "highly_stitchable.maf")))
        delta_maf = ref_delta_maf if formats is ref_formats else port_delta_maf
        pairs = [type(b)(seqs=b.seqs[:2]) for b in blocks if len(b.seqs) > 1]
        return blocks, list(delta_maf.maf_blocks_to_deltas(pairs))
    maf, delta, _ = _realistic()
    return list(formats.read_maf(io.StringIO(maf))), list(formats.read_delta(io.StringIO(delta)))


@pytest.mark.parametrize("name", FIXTURES)
def test_maf_read_write_round_trip(name):
    ref_blocks, _ = fixture(name, ref_formats)
    port_blocks, _ = fixture(name, port_formats)
    assert len(port_blocks) >= 2
    assert fields(port_blocks) == fields(ref_blocks)
    text = maf_text(port_formats, port_blocks)
    assert text == maf_text(ref_formats, ref_blocks)
    if name == "stitchable":
        with open(os.path.join(DATA, "highly_stitchable.maf")) as f:
            assert text.rstrip("\n") == f.read().rstrip("\n")


@pytest.mark.parametrize("name", FIXTURES)
def test_delta_write_read(name):
    _, ref_entries = fixture(name, ref_formats)
    _, port_entries = fixture(name, port_formats)
    assert port_entries and fields(port_entries) == fields(ref_entries)
    text = delta_text(port_formats, port_entries)
    assert text == delta_text(ref_formats, ref_entries)
    back = list(port_formats.read_delta(io.StringIO(text)))
    assert fields(back) == fields(list(ref_formats.read_delta(io.StringIO(text))))
    assert fields(back) == fields(port_entries)


def _profile_pipeline(formats, merge, native_translate, translate, untranslate, name):
    """make (profiles + consensus of the fixture's blocks and of one
    single-row block per sequence), translate the fixture's deltas into
    profile space (native and NumPy), untranslate the blocks they give."""
    blocks, entries = fixture(name, formats)
    singles = []
    for b in blocks:
        for s in b.seqs:
            if s.name not in {x.seqs[0].name for x in singles}:
                text = s.text.replace("-", "") if s.strand == FORWARD else "N" * s.size
                singles.append(type(b)(seqs=[type(s)(s.name, 0, len(text), FORWARD, len(text), text)]))
    lps, lcons = merge.make_profiles_mem(blocks, "l")
    rps, rcons = merge.make_profiles_mem(singles, "r")
    fast = list(native_translate.translate_deltas_fast(lps, rps, entries))
    slow = list(translate.translate_deltas(lps, rps, entries))
    kept, _ = merge.select_consistent(fast, min_length=10)
    delta_maf = ref_delta_maf if formats is ref_formats else port_delta_maf
    out = list(delta_maf.delta_to_maf_blocks(kept, lcons, rcons))
    back = list(untranslate.untranslate_blocks(lps + rps, out))
    return lps + rps, (lcons, rcons), fast, slow, maf_text(formats, back)


@pytest.mark.parametrize("name", FIXTURES)
def test_profiles_make_translate_untranslate(name):
    want = _profile_pipeline(
        ref_formats, ref_merge, ref_native_translate, ref_translate, ref_untranslate, name
    )
    got = _profile_pipeline(
        port_formats, port_merge, port_native_translate, port_translate, port_untranslate, name
    )
    profiles, cons, fast, slow, text = got
    assert profiles and fields(profiles) == fields(want[0])
    assert cons == want[1]
    assert fast and fields(fast) == fields(want[2])
    assert fields(slow) == fields(want[3]) == fields(fast)
    assert text.count("\na ") >= 1 and text == want[4]


def _names_and_distances(name):
    blocks, _ = fixture(name, port_formats)
    names = sorted({s.name for b in blocks for s in b.seqs})
    names += [f"extra{i}" for i in range(6 - len(names))]
    rng = np.random.default_rng(len(names))
    d = rng.random((len(names), len(names)))
    return names, (d + d.T) * (1 - np.eye(len(names)))


@pytest.mark.parametrize("name", FIXTURES)
def test_upgma_and_newick(name):
    names, dist = _names_and_distances(name)
    got = port_tree.upgma(dist, names)
    want = ref_tree.upgma(dist, names)
    assert got.to_newick() == want.to_newick() and fields(got) == fields(want)
    multi = "(" + ",".join(names[:3]) + ",(" + ",".join(f"{n}:0.5" for n in names[3:]) + "));"
    for newick in (want.to_newick(), multi):
        got, want_t = port_tree.parse_newick(newick), ref_tree.parse_newick(newick)
        assert got.to_newick() == want_t.to_newick() and fields(got) == fields(want_t)
        assert sorted(got.leaves()) == sorted(names)


@pytest.mark.parametrize("name", FIXTURES)
def test_make_job_tree(name):
    names, _ = _names_and_distances(name)
    for max_seqs in (1, 2, 3, len(names)):
        got = port_job.make_job_tree(names, max_seqs)
        want = ref_job.make_job_tree(names, max_seqs)
        assert fields(got) == fields(want)
        assert got.all_pairwise() == want.all_pairwise() and got.pp() == want.pp()


@pytest.mark.parametrize("name", FIXTURES)
def test_score_blocks(name):
    port_blocks, _ = fixture(name, port_formats)
    ref_blocks, _ = fixture(name, ref_formats)
    port_score.score_blocks(port_blocks)
    ref_score.score_blocks(ref_blocks)
    scores = [b.score for b in port_blocks]
    assert scores == [b.score for b in ref_blocks]
    # The stitchable fixture's rows are all N, which score nothing.
    assert any(s != 0 for s in scores) == (name == "realistic")
