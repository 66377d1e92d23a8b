"""The port's row-banded DP (K3 `banded_dp`, K4 `banded_dp_batch`) against
paramugsy_tpu.ops.pallas_extend.

On the CPU the wrappers run the plain PyTorch version; the reference's
Pallas kernels run in interpret mode (two launches in all: one per
kernel, of one 128-row chunk at W 128, since an interpreted launch takes
tens of seconds).  Buffers must be bit-identical, rows past a_len included, and
per-pair triples equal to the reference's NumPy mirror and the native
banded engine.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paramugsy_tpu.ops import native
from paramugsy_tpu.ops import pallas_extend as ref
from paramugsy_tpu.ops.extend import banded_align_np
from paramugsy_tpu_torch.ops import banded as port

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _pair(rng, la: int, n_del: int, sub_rate: float = 0.03, n_rate: float = 0.0):
    a = rng.integers(0, 4, size=la).astype(np.int8)
    a[rng.random(la) < n_rate] = 4
    b = np.delete(a, rng.choice(la, n_del, replace=False)) if la else a.copy()
    m = rng.random(len(b)) < sub_rate
    b[m] = ((b[m] + 1) % 4).astype(np.int8)
    return a, b


def _ref_batch_streams(pairs, rows: int, width: int):
    """The inputs the reference's `banded_align_batch` builds (its own
    padding code, including the clamp), for a direct `banded_dp_batch`."""
    half = width // 2
    A = np.full((ref.BATCH, rows), 4, np.int32)
    B_new = np.full((ref.BATCH, rows), 4, np.int32)
    B_init = np.full((ref.BATCH, width), 4, np.int32)
    B_len = np.zeros((ref.BATCH, 1), np.int32)
    for p, (a, b) in enumerate(pairs):
        A[p, : len(a)] = a
        b_pad = np.full(len(b) + 2 * width, 4, np.int32)
        b_pad[width : width + len(b)] = b
        idx_new = np.arange(1, rows + 1) + half - 2 + width
        B_new[p] = b_pad[np.minimum(idx_new, len(b_pad) - 1)]
        B_init[p] = b_pad[width - half - 1 : width + half - 1]
        B_len[p, 0] = len(b)
    return [jnp.asarray(x) for x in (A, B_new, B_init, B_len)]


def _batch_pairs():
    """Seven pairs for one K4 launch of 128 rows at W 128 (padded to eight
    with an empty pair): unequal lengths, empty sides, N codes, a pair at
    the band edge, one that fills every row, and one on which the
    reference's single-pair `banded_align` raises IndexError (a 100 bp,
    b = a less 38 bases: rows reach b_len + W/2 + 2)."""
    rng = np.random.default_rng(5)
    return [
        _pair(rng, 100, 6, n_rate=0.05),
        (np.zeros(0, np.int8), rng.integers(0, 4, 50).astype(np.int8)),
        (rng.integers(0, 4, 40).astype(np.int8), np.zeros(0, np.int8)),
        _pair(rng, 120, 63),  # length difference at the band edge
        (rng.integers(0, 4, 20).astype(np.int8), rng.integers(0, 4, 80).astype(np.int8)),
        _pair(rng, 100, 38, sub_rate=0.0),  # the reference's IndexError pair
        _pair(rng, 128, 10, sub_rate=0.1),
    ]


def test_k4_plain_equals_reference_full_buffer():
    pairs = _batch_pairs()
    rows, width = 128, 128
    want = np.asarray(
        ref.banded_dp_batch(
            *_ref_batch_streams(pairs, rows, width), width=width, chunk=128,
            interpret=True,
        )
    )
    padded = pairs + [(np.zeros(0, np.int8),) * 2] * (port.BATCH - len(pairs))
    A, B, al, bl = port.pack_pairs(padded, CPU)
    got = port.banded_dp_batch(A, B, al, bl, rows=rows, width=width)
    assert got.dtype == torch.uint8 and got.shape == want.shape == (rows, 8, width)
    np.testing.assert_array_equal(got.numpy(), want)
    assert port.banded_dp_batch.launches == 0  # the CPU runs the plain version
    # banded_align_batch is this launch plus the host traceback, so the
    # port's entry points give the reference's batch triples, the
    # IndexError pair included.
    want_triples = [
        ref.traceback_band(want[:, p, :], len(a), len(b), width)
        for p, (a, b) in enumerate(pairs)
    ]
    assert port.banded_align_batch(pairs, width=width, device=CPU) == want_triples
    a, b = pairs[5]
    with pytest.raises(IndexError):  # the reference-side fault, pinned
        ref.banded_align(a, b, width=width, chunk=128, interpret=True)
    assert port.banded_align(a, b, width=width, device=CPU) == want_triples[5]


def test_k3_plain_equals_reference_full_buffer():
    """One pair through the reference's `banded_align` streams and K3."""
    rng = np.random.default_rng(9)
    a, b = _pair(rng, 120, 9, n_rate=0.03)
    width, half, rows = 128, 64, 128
    a_in = np.full(rows, 4, np.int32)
    a_in[: len(a)] = a
    b_pad = np.full(len(b) + 2 * width, 4, np.int32)
    b_pad[width : width + len(b)] = b
    b_new = b_pad[np.arange(1, rows + 1) + half - 2 + width]
    b_init = b_pad[width - half - 1 : width + half - 1]
    want = np.asarray(
        ref.banded_dp(
            jnp.asarray(a_in[None]), jnp.asarray(b_new[None]), jnp.asarray(b_init[None]),
            jnp.asarray(np.array([len(a), len(b)], np.int32)),
            width=width, chunk=128, interpret=True,
        )
    )
    A, B, al, bl = port.pack_pairs([(a, b)], CPU)
    got = port.banded_dp(A, B, al, bl, rows=rows, width=width)
    assert got.shape == want.shape == (rows, width)
    np.testing.assert_array_equal(got.numpy(), want)
    assert port.banded_dp.launches == 0


_CASES = {
    "similar": (300, 8, 512),
    "band_edge_512": (600, 255, 512),
    "band_edge_256": (300, 127, 256),
    "chunk_plus_one": (129, 3, 256),
    "empty_b": (50, 50, 256),
    "empty_a": (0, 0, 256),
    "narrow": (90, 10, 32),
    "widest": (100, 40, port.MAX_WIDTH),
}


@pytest.mark.parametrize("name", sorted(_CASES))
def test_banded_align_equals_numpy_mirror_and_native(name):
    la, n_del, width = _CASES[name]
    rng = np.random.default_rng(len(name))
    a, b = _pair(rng, la, n_del, n_rate=0.02)
    if name == "empty_a":
        b = rng.integers(0, 4, 60).astype(np.int8)
    got = port.banded_align(a, b, width=width, device=CPU)
    assert got == banded_align_np(a, b, width=width)
    if native.load() is not None:
        assert got == native.banded_align_native(a, b, width, 2, -3, -4)
    assert port.banded_align_batch([(a, b)] * 3, width=width, device=CPU) == [got] * 3


def test_batch_with_mixed_lengths_equals_single_pairs():
    rng = np.random.default_rng(17)
    pairs = [_pair(rng, la, nd) for la, nd in ((700, 30), (64, 2), (1000, 200), (333, 0))]
    got = port.banded_align_batch(pairs, width=512, chunk=256, device=CPU)
    assert got == [port.banded_align(a, b, width=512, device=CPU) for a, b in pairs]
    assert got == [banded_align_np(a, b, width=512) for a, b in pairs]


def test_rows_follow_chunk_and_garbage_rows_are_kept():
    """`chunk` sets the buffer's rows: rows past a_len are computed (as in
    the reference) and do not change the triple."""
    rng = np.random.default_rng(3)
    a, b = _pair(rng, 130, 4)
    A, B, al, bl = port.pack_pairs([(a, b)], CPU)
    d128 = port.banded_dp(A, B, al, bl, rows=256, width=256)
    d512 = port.banded_dp(A, B, al, bl, rows=512, width=256)
    assert torch.equal(d512[:256], d128)
    assert port.banded_align(a, b, width=256, chunk=512, device=CPU) == port.banded_align(
        a, b, width=256, chunk=128, device=CPU
    )


def test_wrappers_reject_bad_inputs():
    rng = np.random.default_rng(1)
    pairs = [_pair(rng, 10, 1), _pair(rng, 12, 2)]
    A, B, al, bl = port.pack_pairs(pairs, CPU)
    kw = dict(rows=128)
    with pytest.raises(ValueError):
        port.banded_dp_batch(A, B, al, bl, width=300, **kw)  # not a power of 2
    with pytest.raises(ValueError, match="shared memory"):
        port.banded_dp_batch(A, B, al, bl, width=2 * port.MAX_WIDTH, **kw)
    with pytest.raises(ValueError):
        port.banded_dp_batch(A, B, al, bl, width=16, **kw)
    with pytest.raises(ValueError):
        port.banded_dp_batch(A, B, al, bl, width=256, rows=0)
    with pytest.raises(ValueError):
        port.banded_dp(A, B, al, bl, width=256, **kw)  # K3 takes one pair
    with pytest.raises(TypeError):
        port.banded_dp_batch(A.long(), B, al, bl, width=256, **kw)
    with pytest.raises(TypeError):
        port.banded_dp_batch(A, B, al.long(), bl, width=256, **kw)
    meta = [x.to("meta") for x in (A, B, al, bl)]
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent fallback
        port.banded_dp_batch(*meta, width=256, **kw)
    a, b = np.zeros(300, np.int8), np.zeros(10, np.int8)
    with pytest.raises(ValueError):
        port.banded_align(a, b, width=256, device=CPU)
    with pytest.raises(ValueError):
        port.banded_align_batch([(a, b)], width=256, device=CPU)
    with pytest.raises(ValueError):
        port.banded_align_batch([], device=CPU)
    with pytest.raises(ValueError):
        port.banded_align_batch(pairs * 5, device=CPU)
    assert port.banded_dp.launches == port.banded_dp_batch.launches == 0
