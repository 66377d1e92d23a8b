"""The port's long-segment engine against paramugsy_tpu.ops.pallas_extend.

On the CPU the wrappers run the plain PyTorch versions of K1 and K2; the
reference's Pallas kernels run in interpret mode.  Buffers must be
bit-identical (whole buffers, including lanes outside the DP rectangle),
and per-pair results equal to the reference and the native engine.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paramugsy_tpu.ops import native
from paramugsy_tpu.ops import pallas_extend as ref_wf
from paramugsy_tpu.ops.extend import align_long_segment
from paramugsy_tpu_torch.ops import wavefront as port_wf

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _pairs(seed: int, lengths, n_del: int = 2, sub_rate: float = 0.0):
    rng = np.random.default_rng(seed)
    pairs = []
    for la in lengths:
        a = rng.integers(0, 4, size=la).astype(np.int8)
        k = min(n_del, max(la - 1, 0))
        b = np.delete(a, rng.choice(la, k, replace=False)).copy() if la else a.copy()
        m = rng.random(len(b)) < sub_rate
        b[m] = ((b[m] + 1) % 4).astype(np.int8)
        pairs.append((a, b))
    return pairs


def _small_batch():
    """Eight pairs with empty sides, N codes and unequal lengths."""
    pairs = _pairs(8, (0, 7, 30, 90, 60, 15, 200), sub_rate=0.05)
    pairs[0] = (np.zeros(0, np.int8), np.array([1, 2, 3], np.int8))
    pairs.append((np.array([4, 4, 1], np.int8), np.array([4, 2, 1, 0, 0, 0], np.int8)))
    return pairs


def _ref_streams(pairs, steps, width):
    return [jnp.asarray(x) for x in ref_wf._wavefront_streams(pairs, steps, len(pairs), width)]


def _dp_tb(pairs, steps, width):
    """The port's K1 then K2 on the CPU: the move buffer [batch, 1 + cap16]."""
    A, B, al, bl = port_wf.pack_pairs(pairs, CPU)
    dirs = port_wf.wavefront_dp(A, B, al, bl, steps=steps, width=width)
    return port_wf.wavefront_traceback(dirs, al, bl, width=width)


def test_k1_plain_equals_reference_full_buffer():
    pairs = _small_batch()
    steps, width = 512, 256
    want = np.asarray(
        ref_wf.wavefront_dp(
            *_ref_streams(pairs, steps, width), width=width, chunk=16,
            batch=len(pairs), interpret=True,
        )
    )
    got = port_wf.wavefront_dp(*port_wf.pack_pairs(pairs, CPU), steps=steps, width=width)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert port_wf.wavefront_dp.launches == 0  # the CPU runs the plain version


def test_k2_plain_equals_reference_buffer():
    pairs = _small_batch()
    steps, width = 512, 256
    lens = np.array([(len(a), len(b)) for a, b in pairs], np.int32)
    want = np.asarray(
        ref_wf.wavefront_dp_device_tb(
            *_ref_streams(pairs, steps, width), jnp.asarray(lens), width=width,
            chunk=16, batch=len(pairs), interpret=True,
        )
    )
    got = _dp_tb(pairs, steps, width)
    np.testing.assert_array_equal(got.numpy(), want)
    assert port_wf.wavefront_traceback.launches == 0


def test_k2_plain_equals_reference_bitmap_path():
    """The reference's bitmap-jump traceback (steps16 % 256 == 0), as in
    tests/test_pallas.py::test_device_tb_bitmap_path_interpret.  The
    bitmaps depend on steps only; chunk 16 keeps the interpreted reference
    quick."""
    rng = np.random.default_rng(8)
    la = 2000
    a = rng.integers(0, 4, size=la).astype(np.int8)
    b = np.delete(a, rng.choice(la, 6, replace=False)).copy()
    m = rng.random(len(b)) < 0.02
    b[m] = ((b[m] + 1) % 4).astype(np.int8)
    pairs = [(a, b)] * 8
    steps, width = 4096, 256
    A8, B8, Aw, Bw = ref_wf._device_stream_inputs(pairs, steps, 8, width)
    args = ref_wf._expand_streams(*map(jnp.asarray, (A8, B8, Aw, Bw)), steps=steps, width=width)
    lens = jnp.asarray(np.array([(la, len(b))] * 8, np.int32))
    want = np.asarray(
        ref_wf.wavefront_dp_device_tb(*args, lens, width=width, chunk=16, batch=8, interpret=True)
    )
    np.testing.assert_array_equal(_dp_tb(pairs, steps, width).numpy(), want)


def test_dirs_layout_reads_with_native_traceback():
    """The dirs layout [steps/16, batch, W] is the one the native host
    traceback reads: its walk equals K2's."""
    if native.load() is None:
        pytest.skip("native library unavailable")
    pairs = _pairs(3, (300, 500, 41, 260), n_del=9, sub_rate=0.03)
    A, B, al, bl = port_wf.pack_pairs(pairs, CPU)
    dirs = port_wf.wavefront_dp(A, B, al, bl, steps=1024, width=512)
    tb = port_wf.wavefront_traceback(dirs, al, bl, width=512).numpy()
    host = native.wavefront_traceback_native(dirs.numpy(), al.numpy(), bl.numpy(), 512)
    for p in range(len(pairs)):
        assert port_wf._runs_of_path_words(tb[p, 1:], int(tb[p, 0])) == host[p]


def test_align_many_width_doubling_equals_reference_and_native():
    rng = np.random.default_rng(21)
    segs = _pairs(21, (0, 7, 60))
    # Length differences that force W = 512 -> 1024 and 2048 at base 256.
    for la, n_del in ((400, 150), (700, 300), (900, 600)):
        a = rng.integers(0, 4, size=la).astype(np.int8)
        segs.append((a, np.delete(a, rng.choice(la, n_del, replace=False)).copy()))
    want = ref_wf.wavefront_align_many(
        segs, batch=8, chunk=16, base_width=256, interpret=True
    )
    got = port_wf.wavefront_align_many(segs, device=CPU, batch=8, chunk=16, base_width=256)
    assert got == want
    assert got[0] == ([], [], 0)
    if native.load() is not None:
        for (a, b), g in zip(segs[-3:], got[-3:]):
            assert g == align_long_segment(a, b)


def test_align_many_default_shape_equals_native():
    """Default band (W = 512, chunk 128) against the native banded engine,
    in a part that mixes lengths in one launch."""
    if native.load() is None:
        pytest.skip("native library unavailable")
    segs = _pairs(5, (1500, 1700, 1800, 1650), n_del=20, sub_rate=0.02)
    got = port_wf.wavefront_align_many(segs, device=CPU)
    assert got == [align_long_segment(a, b) for a, b in segs]


def test_band_wider_than_shared_memory_equals_native():
    """W = 32768, the band a length difference of 8192 bp or more doubles
    to, is past the widest band whose rows fit the CUDA kernel's shared
    memory.  The plain versions at that width equal the native banded
    engine at the same width (on short pairs, so the test stays quick)."""
    if native.load() is None:
        pytest.skip("native library unavailable")
    width = 32768
    assert width > port_wf.MAX_SMEM_WIDTH
    pairs = _pairs(32, (200, 90, 160), n_del=40, sub_rate=0.03)
    pairs.append((pairs[1][1], pairs[1][0]))
    tb = _dp_tb(pairs, 384, width).numpy()
    for p, (a, b) in enumerate(pairs):
        want = native.banded_align_native(a, b, width, 2, -3, -4)
        assert port_wf._runs_of_path_words(tb[p, 1:], int(tb[p, 0])) == want


def test_wrappers_reject_bad_inputs():
    A, B, al, bl = port_wf.pack_pairs(_pairs(1, (10, 12)), CPU)
    with pytest.raises(ValueError):
        port_wf.wavefront_dp(A, B, al, bl, steps=40, width=256)  # steps % 16
    with pytest.raises(ValueError):
        port_wf.wavefront_dp(A, B, al, bl, steps=64, width=300)  # not a power of 2
    with pytest.raises(TypeError):
        port_wf.wavefront_dp(A.long(), B, al, bl, steps=64, width=256)
    meta = [x.to("meta") for x in (A, B, al, bl)]
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent fallback
        port_wf.wavefront_dp(*meta, steps=64, width=256)
    # Lengths that do not fit the buffer give n_moves -1, not a bad read.
    dirs = port_wf.wavefront_dp(A, B, al, bl, steps=32, width=256)
    out = port_wf.wavefront_traceback(dirs, al, bl + 100, width=256)
    assert out[:, 0].tolist() == [-1, -1] and not out[:, 1:].any()
