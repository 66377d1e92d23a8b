"""The port's sharded data plane (paramugsy_tpu_torch.parallel) against the
reference's (paramugsy_tpu.parallel), in one process on the CPU.

The reference runs on the eight forced host devices of tests/conftest.py;
the port on a mesh of eight ``cpu`` slots.  Every comparison is exact:
packed rows and cluster fields bit for bit, the Jaccard matrix of 0/1
sketches (integer dot products in float32) by its bits, delta entries as
field tuples, MAFs and wire blobs as bytes.  The single-pair seeder
`find_seeds` rides along: the reference's compile check
(``__graft_entry__.entry``) runs it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from paramugsy_tpu.ops import seeding as ref_seeding
from paramugsy_tpu.ops.align_pair import AlignConfig as RefAlignConfig
from paramugsy_tpu.ops.encode import pad_to
from paramugsy_tpu.parallel import collective as ref_collective
from paramugsy_tpu.parallel import mesh as ref_mesh
from paramugsy_tpu.parallel import pair_shard as ref_pair_shard
from paramugsy_tpu.parallel import wire as ref_wire
from paramugsy_tpu.pipeline import Aligner as RefAligner
from paramugsy_tpu.pipeline import PipelineConfig as RefPipelineConfig
from paramugsy_tpu_torch.ops import chaining as port_chaining
from paramugsy_tpu_torch.ops import seeding as port_seeding
from paramugsy_tpu_torch.ops.align_pair import AlignConfig
from paramugsy_tpu_torch.parallel import collective, mesh, pair_shard, wire
from paramugsy_tpu_torch.pipeline import PipelineConfig
from tests.test_shard import _mk_genomes

torch.set_num_threads(1)


def _ref_mesh(n_pairs=8, n_kdim=1):
    return ref_mesh.make_mesh(
        n_pairs=n_pairs, n_kdim=n_kdim, devices=jax.devices("cpu")[: n_pairs * n_kdim]
    )


def _port_mesh(n_pairs=8, n_kdim=1):
    return mesh.make_mesh(n_pairs=n_pairs, n_kdim=n_kdim, devices=["cpu"] * (n_pairs * n_kdim))


def _fields(entries):
    return [
        (e.ref_name, e.query_name, e.ref_len, e.query_len, tuple(e.ref_range),
         tuple(e.query_range), [tuple(g) for g in e.ref_gaps],
         [tuple(g) for g in e.query_gaps], tuple(e.errors))
        for e in entries
    ]


# --------------------------------------------------------------------------
# The mesh
# --------------------------------------------------------------------------


def test_mesh_grid_owners_and_blocks():
    """An 8-slot mesh as 8 x 1 and 2 x 4: the grid's shape and axis names,
    every slot owned by this process, and the pairs axis split into one
    block per grid row, each on its row's first slot."""
    m = _port_mesh()
    assert m.shape == {"pairs": 8, "kdim": 1} and m.size == 8
    assert m.local_slots() == [(i, 0) for i in range(8)]
    assert all(d == torch.device("cpu") for d in m.local_devices)
    m2 = _port_mesh(2, 4)
    assert m2.devices.shape == (2, 4) and int(m2.owners.max()) == 0
    assert mesh.pair_sharding(m2).blocks(6) == [(0, 3, (0, 0)), (3, 6, (1, 0))]
    x = torch.arange(12).reshape(6, 2)
    shards = mesh.pair_sharding(m2).shard(x)
    assert [(s.row0, s.slot) for s in shards] == [(0, (0, 0)), (3, (1, 0))]
    assert torch.equal(torch.cat([s.data for s in shards]), x)
    assert len(mesh.replicated(m2).shard(x)) == 8
    with pytest.raises(ValueError):
        mesh.pair_sharding(m2).blocks(5)
    with pytest.raises(ValueError):
        mesh.make_mesh(n_pairs=3, n_kdim=2, devices=["cpu"] * 8)


# --------------------------------------------------------------------------
# Seeding: the packed batch and find_seeds
# --------------------------------------------------------------------------


def _unequal_rows():
    """Three pairs of 3000, 5200 and 8000 bp (2% substitutions, an N run,
    the query's second half inverted) at one 8192 bucket."""
    refs, queries, q_lens = [], [], []
    for seed, n in ((5, 3000), (6, 5200), (7, 8000)):
        rng = np.random.default_rng(seed)
        ref = rng.integers(0, 4, n).astype(np.int8)
        q = ref.copy()
        m = rng.random(n) < 0.02
        q[m] = (q[m] + 1) % 4
        q[500:520] = 4
        q = np.concatenate([q[: n // 2], (3 - q[n // 2 :])[::-1]])
        refs.append(pad_to(ref, 8192))
        queries.append(pad_to(q, 8192))
        q_lens.append(n)
    return np.stack(refs), np.stack(queries), np.array(q_lens, np.int32)


BATCH_CASES = {
    "exact_k15": dict(k=15, sample_shift=0),
    "sampled_k15_sliced": dict(k=15, sample_shift=2, m_out=64, c_out=16),
}


@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_packed_batch_rows_equal_reference(case):
    """Rows of unequal length at one shared bucket: the port's [3, L]
    int32 buffer is the reference's vmapped batch bit for bit, masked
    slots included, and each row is the port's single-pair vector at the
    bucket shape with that row's q_len."""
    kw = dict(max_seeds=1 << 12, **BATCH_CASES[case])
    refs, queries, q_lens = _unequal_rows()
    want = np.asarray(
        ref_seeding.seed_cluster_both_packed_batch(
            jnp.asarray(refs), jnp.asarray(queries), jnp.asarray(q_lens),
            compact_slice=False, **kw,
        )
    )
    got = port_seeding.seed_cluster_both_packed_batch(
        torch.from_numpy(refs), torch.from_numpy(queries), torch.from_numpy(q_lens),
        compact_slice=True, **kw,
    )
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    for i in range(3):
        row = port_seeding.seed_cluster_both_packed(
            torch.from_numpy(refs[i]), torch.from_numpy(queries[i]), int(q_lens[i]), **kw
        )
        np.testing.assert_array_equal(row.numpy(), want[i])
    assert (want[:, 4] > 0).all()  # every row has merged runs


def _rand_dna(rng, n):
    return "".join(rng.choice(list("ACGT"), n))


def _find_seeds_case(name):
    """tests/test_ops.py's three find_seeds inputs (its brute-force case at
    each of its seeds), and a random 32 kb pair with N runs."""
    from paramugsy_tpu.ops.encode import encode

    if name == "planted_k16":
        rng = np.random.default_rng(0)
        ref = _rand_dna(rng, 300)
        q = _rand_dna(rng, 40) + ref[100:200] + _rand_dna(rng, 40)
        return encode(ref), encode(q), dict(k=16, max_seeds=128)
    if name.startswith("brute_force_k8_"):
        rng = np.random.default_rng(int(name[-1]))
        ref = _rand_dna(rng, 150)
        q = _rand_dna(rng, 60) + ref[30:80] + _rand_dna(rng, 20)
        return encode(ref), encode(q), dict(k=8, max_seeds=512)
    if name.startswith("exactness_k16"):
        rng = np.random.default_rng(9)
        ref = _rand_dna(rng, 400)
        q = _rand_dna(rng, 50) + ref[100:220] + _rand_dna(rng, 50)
        return encode(ref), encode(q), dict(
            k=16, max_seeds=256, unique_in_query=name.endswith("uniq_query")
        )
    rng = np.random.default_rng(3)
    ref = rng.integers(0, 4, 32768).astype(np.int8)
    q = ref.copy()
    m = rng.random(32768) < 0.02
    q[m] = (q[m] + 1) % 4
    ref[1000:1100] = 0
    q[5000:5300] = 4
    return ref, q, dict(k=12 if name.endswith("k12") else 16, max_seeds=1 << 12)


FIND_SEEDS_CASES = [
    "planted_k16", *(f"brute_force_k8_{s}" for s in range(4)), "exactness_k16",
    "exactness_k16_uniq_query", "random_32kb_k16", "random_32kb_k12",
]


@pytest.mark.parametrize("case", FIND_SEEDS_CASES)
def test_find_seeds_equals_reference(case):
    """Every SeedMatches field bit for bit, masked slots included."""
    ref, q, kw = _find_seeds_case(case)
    want = ref_seeding.find_seeds(jnp.asarray(ref), jnp.asarray(q), **kw)
    got = port_seeding.find_seeds(torch.from_numpy(ref), torch.from_numpy(q), **kw)
    assert got._fields == want._fields
    for f in want._fields:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert w.shape == g.shape, f
        np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64), err_msg=f)
    assert int(want.n_runs) > 0


def test_graft_entry_step_equals_reference():
    """``__graft_entry__.entry``'s step (find_seeds, then cluster_seeds of
    the seeds of >= 20 bp) on its 2^15 pair: the port's seven outputs
    are the reference's, whose digest chip_smoke phase 14e holds."""
    import __graft_entry__

    fn, args = __graft_entry__.entry()
    want = [np.asarray(x) for x in jax.jit(fn)(*args)]
    ref, q = chip_smoke.graft_entry_pair()
    np.testing.assert_array_equal(np.asarray(args[0]), ref)
    np.testing.assert_array_equal(np.asarray(args[1]), q)
    s = port_seeding.find_seeds(torch.from_numpy(ref), torch.from_numpy(q), k=16, max_seeds=1 << 14)
    cl = port_chaining.cluster_seeds(
        s.rpos, s.qpos, s.length, s.mask & (s.length >= 20), max_clusters=1024
    )
    got = [cl.c_rstart, cl.c_rend, cl.c_qstart, cl.c_qend, cl.c_weight, cl.c_mask, cl.n_clusters]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy().astype(np.int64), w.astype(np.int64))
    assert chip_smoke.arrays_sha256(want) == chip_smoke.GRAFT_ENTRY_SHA256
    assert int(want[6]) > 0


# --------------------------------------------------------------------------
# The sharded steps
# --------------------------------------------------------------------------


def test_sharded_pair_step_equals_reference():
    """The dry run's pair step (16 x 2048, k 16, 1 << 10 seeds, 128
    clusters) over eight slots: every gathered field equal, with the
    reference's dtypes, and the reference's digest is chip_smoke 14a's."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    refs, queries, _ = chip_smoke.graft_pair_batch(8)
    rm = _ref_mesh()
    sh = NamedSharding(rm, P("pairs"))
    want = ref_pair_shard.make_sharded_pair_step(rm, k=16, max_seeds=1 << 10, max_clusters=128)(
        jax.device_put(jnp.asarray(refs), sh), jax.device_put(jnp.asarray(queries), sh)
    )
    got = pair_shard.make_sharded_pair_step(
        _port_mesh(), k=16, max_seeds=1 << 10, max_clusters=128
    )(torch.from_numpy(refs), torch.from_numpy(queries))
    assert sorted(got) == sorted(want)
    for f in pair_shard.PAIR_FIELDS:
        w, g = np.asarray(want[f]), got[f].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert chip_smoke.arrays_sha256(
        [np.asarray(want[f]) for f in pair_shard.PAIR_FIELDS]
    ) == chip_smoke.SHARDED_PAIR_STEP_SHA256
    assert int(np.asarray(want["n_clusters"]).sum()) > 0


@pytest.mark.parametrize("shape", [(1, 8), (2, 4), (1, 1)], ids=["1x8", "2x4", "1x1"])
def test_sharded_distance_step_equals_reference(shape):
    """The dry run's 8 x 1024 0/1 sketches: the port's Jaccard matrix on a
    1 x 8, 2 x 4 or 1 x 1 mesh has the bits of the reference's on its
    1 x 8 ``kdim`` mesh (chip_smoke 14a's digest)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    _, _, sketches = chip_smoke.graft_pair_batch(8)
    rm = _ref_mesh(1, 8)
    want = np.asarray(
        ref_pair_shard.make_sharded_distance_step(rm)(
            jax.device_put(jnp.asarray(sketches), NamedSharding(rm, P(None, "kdim")))
        )
    )
    got = pair_shard.make_sharded_distance_step(_port_mesh(*shape))(torch.from_numpy(sketches))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    assert chip_smoke.arrays_sha256([want], np.float32) == chip_smoke.SHARDED_DISTANCE_SHA256
    assert np.allclose(np.diag(want), 1.0)


@pytest.mark.parametrize("gather", [False, True], ids=["own_rows", "gathered"])
def test_sharded_packed_step_rows_equal_reference(gather):
    """`make_sharded_packed_pair_step` over eight slots on 12 rows of the
    unequal batch (padded to 16 with N rows): this process's blocks, or
    the gathered [16, L], are the reference's sharded rows."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    refs, queries, q_lens = _unequal_rows()
    refs = np.concatenate([np.tile(refs, (4, 1)), np.full((4, 8192), 4, np.int8)])
    queries = np.concatenate([np.tile(queries, (4, 1)), np.full((4, 8192), 4, np.int8)])
    q_lens = np.concatenate([np.tile(q_lens, 4), np.zeros(4, np.int32)])
    kw = dict(k=15, max_seeds=1 << 12, max_clusters=512, sample_shift=2, m_out=64, c_out=16)
    rm = _ref_mesh()
    sh = NamedSharding(rm, P("pairs"))
    want = np.asarray(
        ref_pair_shard.make_sharded_packed_pair_step(rm, compact_slice=False, **kw)(
            *(jax.device_put(jnp.asarray(x), sh) for x in (refs, queries, q_lens))
        )
    )
    out = pair_shard.make_sharded_packed_pair_step(_port_mesh(), gather=gather, **kw)(
        torch.from_numpy(refs), torch.from_numpy(queries), torch.from_numpy(q_lens)
    )
    if gather:
        got = out.numpy()
    else:
        assert [(s.row0, s.slot) for s in out] == [(2 * i, (i, 0)) for i in range(8)]
        got = np.concatenate([s.data.numpy() for s in out])
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# sharded_genome_pair_deltas and align_fastas_sharded
# --------------------------------------------------------------------------


@pytest.mark.parametrize("count", [4, 3], ids=["6_pairs", "3_pairs_padded"])
def test_sharded_deltas_equal_reference(count):
    """tests/test_shard.py's genomes: all 6 pairs of four, or 3 pairs of
    three over 8 slots (5 padding rows): DeltaEntry fields equal."""
    genomes = _mk_genomes(count=count)
    pairs = [(genomes[i], genomes[j]) for i in range(count) for j in range(i + 1, count)]
    want = ref_collective.sharded_genome_pair_deltas(pairs, RefAlignConfig(), _ref_mesh())
    got = collective.sharded_genome_pair_deltas(pairs, AlignConfig(), _port_mesh())
    assert len(got) == len(pairs)
    assert [_fields(es) for es in got] == [_fields(es) for es in want]
    assert all(got)


def test_sharded_windowed_deltas_equal_reference():
    """tests/test_shard.py's mixed pair at window 2048 (overlap 512): a 6 kb
    contig pair in window sub-rows beside a 1.5 kb contig row of the same
    batch; the fused entries equal the reference's and span a window
    boundary."""
    rng = np.random.default_rng(91)
    bases = np.array(list("ACGT"))
    anc = rng.integers(0, 4, size=6000)
    seqs = []
    for _ in range(2):
        g = anc.copy()
        m = rng.random(len(g)) < 0.01
        g[m] = (g[m] + 1) % 4
        seqs.append("".join(bases[g]))
    short = "".join(bases[rng.integers(0, 4, size=1500)])
    from paramugsy_tpu.pipeline import Genome

    genomes = [
        Genome(name="gA", seqs={"gA.chr": seqs[0]}),
        Genome(name="gB", seqs={"gB.chr": seqs[1], "gB.p": short}),
    ]
    want = ref_collective.sharded_genome_pair_deltas(
        [(genomes[0], genomes[1])],
        dataclasses.replace(RefAlignConfig(), window=2048, window_overlap=512), _ref_mesh(),
    )
    got = collective.sharded_genome_pair_deltas(
        [(genomes[0], genomes[1])],
        dataclasses.replace(AlignConfig(), window=2048, window_overlap=512), _port_mesh(),
    )
    assert _fields(got[0]) == _fields(want[0])
    assert any(e.ref_range.length > 2048 for e in got[0] if e.query_name == "gB.chr")


def test_shared_bucket_samples_short_rows_as_reference():
    """A 270 kb contig pair beside a 3 kb one (8% substitutions): the
    batch's one bucket (2^19 a side) makes the short row seed sampled,
    as the reference's sharded plane does, so its entries differ from
    the single-pair path's (ROADMAP queue C); the port's sharded entries
    are the reference's sharded ones."""
    from paramugsy_tpu.pipeline import Genome
    from paramugsy_tpu_torch.pipeline import genome_pair_deltas

    rng = np.random.default_rng(1)
    bases = np.array(list("ACGT"))

    def mutant(anc, rate):
        g = anc.copy()
        m = rng.random(len(g)) < rate
        g[m] = (g[m] + rng.integers(1, 4, int(m.sum()))) % 4
        return "".join(bases[g])

    big, small = rng.integers(0, 4, 270_000), rng.integers(0, 4, 3000)
    ga = Genome("a", {"a.big": mutant(big, 0.01), "a.small": mutant(small, 0.08)})
    gb = Genome("b", {"b.big": mutant(big, 0.01), "b.small": mutant(small, 0.08)})
    want = ref_collective.sharded_genome_pair_deltas([(ga, gb)], RefAlignConfig(), _ref_mesh(1))
    got = collective.sharded_genome_pair_deltas([(ga, gb)], AlignConfig(), _port_mesh(1))
    assert _fields(got[0]) == _fields(want[0])
    single = genome_pair_deltas(ga, gb, AlignConfig(), device="cpu")

    def short(entries):
        return [f for f in _fields(entries) if f[0] == "a.small"]

    assert short(got[0]) != short(single)
    assert len(short(got[0])) == 1 and len(short(single)) == 2


def test_tree_pairs_equal_reference():
    """Five genomes: the deduped pair list of the job tree, in order."""
    genomes = _mk_genomes(count=5)
    want = ref_collective.tree_pairs(RefAligner(genomes, RefPipelineConfig()).job_tree())
    from paramugsy_tpu_torch.pipeline import Aligner

    got = collective.tree_pairs(Aligner(genomes, PipelineConfig(), device="cpu").job_tree())
    assert got == want and len(set(got)) == len(got)


def _four_genome_fastas(tmp_path):
    paths = []
    for g in _mk_genomes(seed=37):
        p = tmp_path / f"{g.name}.fa"
        p.write_text(f">{g.name}.chr\n" + "\n".join(g.seqs.values()) + "\n")
        paths.append(str(p))
    return paths


def test_align_fastas_sharded_equals_reference(tmp_path):
    """The MAF's bytes on tests/test_shard.py's four genomes (the realistic
    fixture's are held in tests/test_torch_shard_realistic.py)."""
    paths = _four_genome_fastas(tmp_path)
    want = tmp_path / "ref.maf"
    ref_collective.align_fastas_sharded(paths, str(want), mesh=_ref_mesh())
    got = tmp_path / "port.maf"
    blocks = collective.align_fastas_sharded(paths, str(got), devices=["cpu"] * 8)
    assert got.read_bytes() == want.read_bytes()
    assert len(blocks) == got.read_text().count("\na ")


# --------------------------------------------------------------------------
# The wire format and the fail-fast contract
# --------------------------------------------------------------------------


def test_wire_blobs_equal_reference():
    """The exchange blob of real entries (two rows, one empty) has the
    reference's bytes, decodes in either package to the same fields, and
    a wrong magic or version raises in both."""
    genomes = _mk_genomes(count=3)
    deltas = ref_collective.sharded_genome_pair_deltas(
        [(genomes[0], genomes[1]), (genomes[1], genomes[2])], RefAlignConfig(), _ref_mesh()
    )
    results = {7: deltas[0], 2: deltas[1], 4: []}
    blob = wire.encode_results(results)
    assert blob == ref_wire.encode_results(results)
    for decode in (wire.decode_results, ref_wire.decode_results):
        back = decode(blob)
        assert sorted(back) == [2, 4, 7]
        assert {k: _fields(v) for k, v in back.items()} == {
            k: _fields(v) for k, v in results.items()
        }
    for bad in (b"XXXX" + blob[4:], blob[:4] + b"\x02" + blob[5:], blob[:10]):
        for decode in (wire.decode_results, ref_wire.decode_results):
            with pytest.raises(RuntimeError):
                decode(bad)


def test_fail_fast_contract_names_peer_loss_only():
    """A peer-loss failure becomes DeadHostError; any other error passes
    through unchanged; one process needs no barrier."""
    with pytest.raises(collective.DeadHostError, match="fail-fast"):
        with collective.fail_fast_contract("t"):
            raise RuntimeError("[gloo/transport/tcp/pair.cc:537] Connection reset by peer")
    with pytest.raises(ValueError):
        with collective.fail_fast_contract("t"):
            raise ValueError("not a peer")
    collective._phase_barrier("t", timeout_s=0.01)
    assert collective._exchange_blobs(b"abc") == [b"abc"]
