"""The port's sequential multi-genome path (FASTA list -> MAF) against
paramugsy_tpu.pipeline and the reference's ``align -sequential``.

Both packages run the same settings (`convert.pipeline_config`) on the
same FASTA files; the MAF files must be byte-identical.  The port runs on
the CPU, where its kernels are their plain PyTorch versions.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from bench import build_family
from paramugsy_tpu import cli as ref_cli
from paramugsy_tpu import pipeline as ref_pipe
from paramugsy_tpu.formats.maf import read_maf
from paramugsy_tpu.ops import engines as ref_engines
from paramugsy_tpu_torch import cli as port_cli
from paramugsy_tpu_torch import convert
from paramugsy_tpu_torch import pipeline as port_pipe
from paramugsy_tpu_torch.ops import engines as port_engines

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STITCHABLE = os.path.join(ROOT, "tests", "data", "highly_stitchable.maf")


@pytest.fixture(scope="module")
def family(tmp_path_factory):
    """bench.build_family at 4 x 40 kb, written by the smoke's writer."""
    return chip_smoke.family_fastas(str(tmp_path_factory.mktemp("family")), 40_000, 4)


def _read(path) -> str:
    with open(path) as f:
        return f.read()


def test_smoke_family_equals_bench_family(family):
    want = build_family(np.random.default_rng(7), 40_000, count=4)
    got = chip_smoke.build_family(np.random.default_rng(7), 40_000, count=4)
    assert [(g.name, g.seqs) for g in got] == [(g.name, g.seqs) for g in want]
    assert [port_pipe.load_genome(p).seqs for p in family] == [
        ref_pipe.load_genome(p).seqs for p in family
    ]
    g = port_pipe.load_genome(family[0])
    np.testing.assert_array_equal(
        g.concat_codes(), ref_pipe.load_genome(family[0]).concat_codes()
    )


def test_align_fastas_equals_reference(family, tmp_path):
    cfg = ref_pipe.PipelineConfig()
    ref_engines.reset_counts()
    ref_pipe.align_fastas(family, str(tmp_path / "ref.maf"), cfg)
    port_engines.reset_counts()
    blocks = port_pipe.align_fastas(
        family, str(tmp_path / "port.maf"), convert.pipeline_config(cfg), device="cpu"
    )
    assert _read(tmp_path / "port.maf") == _read(tmp_path / "ref.maf")
    assert len(blocks) > 1 and max(len(b.seqs) for b in blocks) == 4
    # The seeding ran once per reference dispatch, on the CPU here.
    assert port_engines.COUNTS["seedcluster-cpu"] == ref_engines.COUNTS["seedcluster-cpu"] > 0


def test_refine_long_blocks_on_the_wavefront_path(tmp_path, monkeypatch):
    """Blocks wider than 4096 columns send whole rows to the long-segment
    engine under refine: the port takes its wavefront path (the plain K1/K2
    on the CPU), the reference its native banded engine."""
    paths = chip_smoke.family_fastas(str(tmp_path), 5000, 2, seed=3)
    cfg = ref_pipe.PipelineConfig(refine=True)
    monkeypatch.delenv("PARAMUGSY_DEVICE_DP", raising=False)
    ref_engines.reset_counts()
    blocks = ref_pipe.align_fastas(paths, str(tmp_path / "ref.maf"), cfg)
    assert max(len(b.seqs[0].text) for b in blocks) > 4096
    monkeypatch.setenv("PARAMUGSY_DEVICE_DP", "1")
    port_engines.reset_counts()
    port_pipe.align_fastas(
        paths, str(tmp_path / "port.maf"), convert.pipeline_config(cfg), device="cpu"
    )
    assert _read(tmp_path / "port.maf") == _read(tmp_path / "ref.maf")
    long_ref = ref_engines.COUNTS.get("native-banded", 0) + ref_engines.COUNTS.get(
        "numpy-banded", 0
    )
    assert port_engines.COUNTS.get("device-wavefront") == long_ref > 0


def _cli_case(name, tmp_path):
    """Extra flags of one CLI case (files written to tmp_path)."""
    if name == "default":
        return []
    if name == "skipunique":
        return ["-skipunique", "-minlength", "50", "-distance", "300"]
    if name == "tree":
        (tmp_path / "t.nwk").write_text("((q3,q0),(q1,q2));\n")
        return ["-tree", str(tmp_path / "t.nwk"), "-seqs_per_mugsy", "3"]
    if name == "dup_list":
        (tmp_path / "dups.txt").write_text(STITCHABLE + "\n")
        return ["-dup_list", str(tmp_path / "dups.txt")]
    if name == "config":
        cfg = {"min_length": 40, "chain_gap": 500, "align": {"break_len": 150}}
        (tmp_path / "c.json").write_text(json.dumps(cfg))
        return ["-config", str(tmp_path / "c.json")]
    raise KeyError(name)


@pytest.mark.parametrize("name", ["default", "skipunique", "tree", "dup_list", "config"])
def test_cli_align_sequential_equals_reference(family, tmp_path, name):
    flags = _cli_case(name, tmp_path)
    (tmp_path / "list.txt").write_text("\n".join(family[1:]) + "\n")
    inputs = [family[0], "-seq_list", str(tmp_path / "list.txt")]
    ref_argv = ["-sequential", *inputs, "-out_maf", str(tmp_path / "ref.maf"), *flags]
    assert ref_cli._align_main(ref_argv) == 0
    port_argv = ["align", "-sequential", *inputs, "-out_maf", str(tmp_path / "port.maf"),
                 *flags, "-device", "cpu"]
    assert port_cli.main(port_argv) == 0
    text = _read(tmp_path / "port.maf")
    assert text == _read(tmp_path / "ref.maf")
    labels = [b.attrs["label"] for b in read_maf(str(tmp_path / "port.maf"))]
    assert ("dup1" in labels) == (name == "dup_list")
    if name == "skipunique":
        assert all(int(b.attrs["mult"]) > 1 for b in read_maf(str(tmp_path / "port.maf")))


_CFG = {
    "max_seqs": 3, "min_length": 45, "emit_unique": False, "refine": True,
    "refine_max_cols": 1234, "chain_gap": 700, "distance_k": 7,
    "dup_list": ["x.maf"], "guide_tree_newick": "(a,b);",
    "align": {"k": 13, "break_len": 321, "max_clusters": 2048,
              "scoring": {"match": 3, "mismatch": -2, "gap": -5}},
}


def test_config_from_dict_and_convert_round_trip(tmp_path):
    ref_cfg = ref_pipe.config_from_dict(_CFG)
    port_cfg = port_pipe.config_from_dict(_CFG)
    assert dataclasses.asdict(convert.pipeline_config(ref_cfg)) == dataclasses.asdict(port_cfg)
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(ref_cfg)
    assert port_cfg.align.scoring.gap == -5 and port_cfg.align.k == 13
    (tmp_path / "c.json").write_text(json.dumps(_CFG))
    assert port_pipe.load_config(str(tmp_path / "c.json")) == port_cfg
    assert dataclasses.asdict(convert.pipeline_config(ref_pipe.PipelineConfig())) == (
        dataclasses.asdict(port_pipe.PipelineConfig())
    )
    with pytest.raises(ValueError, match="unknown config keys"):
        port_pipe.config_from_dict({"bogus": 1})


@pytest.mark.parametrize(
    "flags",
    [["-sequential", "-distributed"], ["-distributed", "-tmp_dir", "{side}_store"]],
)
def test_unported_align_options_exit_2(family, tmp_path, monkeypatch, flags):
    """``-distributed``, once refused with exit 2, with no world
    configured: with -sequential it runs the sequential path and joins no
    world; without, one process of the executor over its -tmp_dir store.
    Either way the MAF (and store) are the reference's, byte for byte."""
    import torch.distributed as dist

    for name in ("MASTER_ADDR", "JAX_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(name, raising=False)

    def argv(side):
        extra = [f.replace("{side}", str(tmp_path / side)) for f in flags]
        return ["align", *family[:2], "-out_maf", str(tmp_path / f"{side}.maf"), *extra]

    assert ref_cli.main(argv("ref")) == 0
    assert port_cli.main([*argv("port"), "-device", "cpu"]) == 0
    assert not dist.is_initialized()
    assert (tmp_path / "port.maf").read_bytes() == (tmp_path / "ref.maf").read_bytes()
    if "-tmp_dir" in flags:
        stores = [sorted(os.listdir(tmp_path / f"{side}_store" / "pairs"))
                  for side in ("ref", "port")]
        assert stores[0] == stores[1] == ["q0~q1.delta"]


def test_align_duplications_cli_equals_reference(tmp_path):
    """``align -sequential -duplications`` (once refused with exit 2) on
    two 8.8 kb genomes that share a planted direct duplication: the
    reference's MAF, byte for byte, with its dup blocks."""
    rng = np.random.default_rng(9)
    anc = rng.integers(0, 4, 8000).astype(np.int8)
    anc = np.concatenate([anc[:6000], anc[1000:1800], anc[6000:]])
    paths = []
    for name in ("alpha", "beta"):
        g = anc.copy()
        m = rng.random(len(g)) < 0.02
        g[m] = (g[m] + 1) % 4
        paths.append(chip_smoke.write_fasta(str(tmp_path / f"{name}.fa"), "chr1", g))
    ref_out, port_out = tmp_path / "ref.maf", tmp_path / "port.maf"
    flags = ["-sequential", "-duplications"]
    assert ref_cli.main(["align", *paths, "-out_maf", str(ref_out), *flags]) == 0
    port_engines.reset_counts()
    assert port_cli.main(
        ["align", *paths, "-out_maf", str(port_out), *flags, "-device", "cpu"]
    ) == 0
    assert port_out.read_bytes() == ref_out.read_bytes()
    assert b"label=dup1" in port_out.read_bytes()
    assert port_engines.COUNTS["repeatcluster-cpu"] == 2


def test_duplications_config_raises_and_cuda_needs_a_card(family, tmp_path):
    """`duplications` in the config gives the reference's MAF (it raised
    NotImplementedError before align_self was ported); asking for the
    default cuda device without a card still raises."""
    ref_pipe.align_fastas(
        family[:2], str(tmp_path / "ref.maf"), ref_pipe.PipelineConfig(duplications=True)
    )
    cfg = port_pipe.PipelineConfig(duplications=True)
    port_pipe.align_fastas(family[:2], str(tmp_path / "o.maf"), cfg, device="cpu")
    assert (tmp_path / "o.maf").read_bytes() == (tmp_path / "ref.maf").read_bytes()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            port_cli.main(["align", "-sequential", *family[:2], "-out_maf",
                           str(tmp_path / "o.maf")])
        with pytest.raises(RuntimeError):
            port_cli.main(["align", "-sequential", "-duplications", *family[:2],
                           "-out_maf", str(tmp_path / "o.maf")])
