"""paramugsy_tpu_torch seeding + clustering against paramugsy_tpu.

The packed seed/cluster vector must be bit-identical to the reference's,
including the values left in masked slots (they are part of the vector).
The reference runs its CPU default, the scatter compaction form.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paramugsy_tpu.ops import chaining as ref_chaining
from paramugsy_tpu.ops import encode as ref_encode
from paramugsy_tpu.ops import seeding as ref_seeding
from paramugsy_tpu_torch.ops import chaining as port_chaining
from paramugsy_tpu_torch.ops import seeding as port_seeding

torch.set_num_threads(1)


def _diverged_pair(seed: int, n: int):
    """Ref + 2%-substituted query with N runs and an inverted second half
    (so both strands seed)."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, n).astype(np.int8)
    q = ref.copy()
    m = rng.random(n) < 0.02
    q[m] = (q[m] + 1) % 4
    ref[100:130] = 4
    q[500:520] = 4
    q = np.concatenate([q[: n // 2], (3 - q[n // 2 :])[::-1]])
    return ref, q


def _tiled_pair(seed: int):
    """Short random ref, query = 20 copies of it: every sampled query k-mer
    matches a unique ref k-mer, overflowing the match slice (samp_over 2)."""
    ref = np.random.default_rng(seed).integers(0, 4, 3000).astype(np.int8)
    return ref, np.tile(ref, 20)


def _poly_a_pair(seed: int):
    """Poly-A in both: k-mer A^k hashes into every sample, overflowing the
    sample buffer (samp_over 1)."""
    rng = np.random.default_rng(seed)
    ref = np.concatenate([np.zeros(5000, np.int8), rng.integers(0, 4, 2000)])
    q = np.concatenate([rng.integers(0, 4, 1000), np.zeros(5000, np.int8)])
    return ref.astype(np.int8), q.astype(np.int8)


def _run_both(ref, q, **kw):
    rb = ref_encode.pad_to(ref, ref_encode.bucket_size(len(ref)))
    qb = ref_encode.pad_to(q, ref_encode.bucket_size(len(q)))
    want = ref_seeding.seed_cluster_both_packed(
        jnp.asarray(rb), jnp.asarray(qb), None, jnp.int32(len(q)),
        compact_slice=False, **kw,
    )
    got = port_seeding.seed_cluster_both_packed(
        torch.from_numpy(rb), torch.from_numpy(qb), len(q), **kw
    )
    return np.asarray(want), got.numpy()


CASES = {
    "exact_k15": dict(k=15, sample_shift=0),
    "sampled_k15_sliced": dict(k=15, sample_shift=2, m_out=64, c_out=16),
    "sampled_k15_uniq_query": dict(k=15, sample_shift=2, unique_in_query=True),
    "exact_k16_uniq_query": dict(k=16, sample_shift=0, unique_in_query=True),
    "k16_sampling_ignored_sliced": dict(k=16, sample_shift=2, m_out=128, c_out=32),
    "exact_k15_sliced_small_bucket": dict(k=15, max_seeds=256, m_out=100, c_out=8),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_packed_vector_equals_reference(case):
    kw = dict(max_seeds=1 << 12)
    kw.update(CASES[case])
    want, got = _run_both(*_diverged_pair(5, 20000), **kw)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert want[4] > 0  # merged runs exist


@pytest.mark.parametrize(
    "make, bit", [(_poly_a_pair, 1), (_tiled_pair, 2)], ids=["sample_buffer", "match_slice"]
)
def test_sample_overflow_flags_equal_reference(make, bit):
    want, got = _run_both(*make(3), k=15, sample_shift=2, max_seeds=1 << 12)
    assert want[5] & bit
    np.testing.assert_array_equal(got, want)


def test_carry_last_marked_equals_reference():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 8, 64, 100, 128):
        for density in (0.0, 0.05, 0.5):
            mark = rng.random(n) < density
            pay = rng.integers(-1000, 1000, n).astype(np.int32)
            ws, wp = ref_seeding._carry_last_marked(jnp.asarray(mark), jnp.asarray(pay))
            gs, gp = port_seeding._carry_last_marked(
                torch.from_numpy(mark), torch.from_numpy(pay.astype(np.int64))
            )
            np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
            np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))


def test_find_seeds_both_fields_equal_reference():
    ref, q = _diverged_pair(11, 6000)
    want = ref_seeding.find_seeds_both(
        jnp.asarray(ref), jnp.asarray(q), jnp.int32(len(q)),
        k=15, max_seeds=2048, compact_slice=False,
    )
    got = port_seeding.find_seeds_both(
        torch.from_numpy(ref), torch.from_numpy(q), len(q), k=15, max_seeds=2048
    )
    for name in want._fields:
        np.testing.assert_array_equal(
            getattr(got, name).numpy(),
            np.asarray(getattr(want, name)).astype(getattr(got, name).numpy().dtype),
            err_msg=name,
        )


def test_cluster_seeds_equals_reference():
    rng = np.random.default_rng(4)
    m = 512
    rpos = rng.integers(0, 50000, m).astype(np.int32)
    qpos = (rpos + rng.integers(-40, 40, m)).astype(np.int32)
    length = rng.integers(15, 60, m).astype(np.int32)
    mask = rng.random(m) < 0.8
    want = ref_chaining.cluster_seeds(
        *map(jnp.asarray, (rpos, qpos, length, mask)), band=16, max_gap=90,
        max_clusters=128,
    )
    got = port_chaining.cluster_seeds(
        *(torch.from_numpy(x.astype(np.int64)) for x in (rpos, qpos, length)),
        torch.from_numpy(mask), band=16, max_gap=90, max_clusters=128,
    )
    for name in got._fields:
        w = np.asarray(getattr(want, name))
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), w.astype(getattr(got, name).numpy().dtype),
            err_msg=name,
        )


def test_revcomp_on_device_equals_reference():
    codes = ref_encode.pad_to(_diverged_pair(1, 3000)[0], 4096)
    want = ref_seeding.revcomp_on_device(jnp.asarray(codes), 3000)
    got = port_seeding.revcomp_on_device(torch.from_numpy(codes), 3000)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
