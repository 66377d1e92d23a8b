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
    to, is past the widest band whose rows the CUDA register kernel holds
    (the second kernel keeps them in device memory).  The plain versions at that width equal the native banded
    engine at the same width (on short pairs, so the test stays quick)."""
    if native.load() is None:
        pytest.skip("native library unavailable")
    width = 32768
    assert width > port_wf.MAX_REG_WIDTH
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


def _emulate_register_kernel(pairs, *, steps, width, lanes_per_thread, strip, seed=0):
    """A NumPy model of the schedule of csrc/wavefront.cu's
    `wavefront_reg_kernel`: per warp its lanes (owned strip plus halo, the
    range clamped into the band), each thread's 16-step windows of sequence
    bytes read from the padded rows at the kernel's offsets, and the swap
    of owned lanes every 32 steps.  The interior ends of each warp's lanes
    see random garbage where the kernel sees its own shuffled values: no
    owned lane may depend on them.  Returns the dirs buffer."""
    rng = np.random.default_rng(seed)
    L = lanes_per_thread
    A, B, al, bl = port_wf.pack_pairs(pairs, CPU)
    front, stride = port_wf.pad_geometry(steps, width)
    ap = port_wf.pad_rows(A, al, port_wf.PAD_A, front, stride).numpy().astype(np.int64)
    bp = port_wf.pad_rows(B, bl, port_wf.PAD_B, front, stride).numpy().astype(np.int64)
    half, n_win, neg, gap = width // 2, 8 + L // 2, port_wf.NEG, -4
    blocked = strip != width
    ext = 32 * L if blocked else width
    dirs = np.zeros((steps // 16, len(pairs), width), np.int64)
    for p in range(len(pairs)):
        warps = []
        for k in range(width // strip):
            e0 = min(max(k * strip - (ext - strip) // 2, 0), width - ext)
            lanes = e0 + np.arange(ext)
            w0 = e0 + (lanes - e0) // L * L
            warps.append({
                "lanes": lanes, "l": lanes - w0, "w0": w0,
                "own": (lanes >= k * strip) & (lanes < (k + 1) * strip),
                "g": np.where(lanes == half, 0, neg) + gap,
                "g2": np.full(ext, neg + gap),
            })
        for d0 in range(0, steps, 16):
            for wp in warps:
                lanes, l, g, g2 = wp["lanes"], wp["l"], wp["g"], wp["g2"]
                a0 = front + (d0 - wp["w0"] + half) // 2 - L // 2
                b0 = front + (d0 + wp["w0"] - half) // 2 - 1
                # This block's window and the next one (the prefetch) stay
                # inside the padded rows.
                assert a0.min() >= 0 and b0.min() >= 0
                assert a0.max() + 8 + n_win <= stride and b0.max() + 8 + n_win <= stride
                acc = np.zeros(ext, np.int64)
                for s in range(1, 17):
                    ja = (s - l) // 2 + L // 2 - 1
                    jb = (s + l) // 2
                    assert 0 <= ja.min() and ja.max() < n_win
                    assert 0 <= jb.min() and jb.max() < n_win
                    junk = rng.integers(-(10**6), 10**6, 2)
                    up = np.append(g[1:], neg if lanes[-1] == width - 1 else junk[0])
                    left = np.insert(g[:-1], 0, neg if lanes[0] == 0 else junk[1])
                    same = ap[p, a0 + ja] == bp[p, b0 + jb]
                    diag = g2 + np.where(same, 2 - gap, -3 - gap)
                    m1 = np.maximum(up, left)
                    dp = np.maximum(diag, m1)
                    code = np.where(diag >= m1, port_wf.DIAG,
                                    np.where(up >= left, port_wf.UP, port_wf.LEFT))
                    acc |= code << (2 * (s - 1))
                    g2, g = g, dp + gap
                wp["g"], wp["g2"] = g, g2
                dirs[d0 // 16, p, lanes[wp["own"]]] = acc[wp["own"]]
            if blocked and d0 & 16:
                rows = np.zeros((2, width), np.int64)
                for wp in warps:
                    rows[:, wp["lanes"][wp["own"]]] = (wp["g"][wp["own"]], wp["g2"][wp["own"]])
                for wp in warps:
                    halo = ~wp["own"]
                    wp["g"][halo], wp["g2"][halo] = rows[:, wp["lanes"][halo]]
    return dirs.astype(np.uint32).view(np.int32)


# (width, lanes per thread, strip) of every launch csrc/wavefront.cu's
# `pm_wavefront_dp` makes: one warp per pair (strip = width) below 256
# lanes, temporal blocking from 256 up.
_REG_GEOMETRIES = [
    (32, 2, 32), (64, 2, 64), (128, 4, 128), (256, 6, 128), (512, 6, 128),
    (1024, 6, 128), (2048, 6, 128), (4096, 6, 128), (8192, 10, 256),
    (16384, 18, 512),
]


@pytest.mark.parametrize("width,lanes_per_thread,strip", _REG_GEOMETRIES)
def test_k1_register_schedule_equals_plain(width, lanes_per_thread, strip):
    """The CUDA kernel's schedule (lane ownership, halos, padded windows)
    reproduces the plain version's whole buffer: a CPU rehearsal of the
    index arithmetic the card runs."""
    steps = 128 if width <= 1024 else 64
    pairs = _small_batch()[1:5] if width <= 1024 else _pairs(3, (40, 70), n_del=5)
    A, B, al, bl = port_wf.pack_pairs(pairs, CPU)
    want = port_wf.wavefront_dp_plain(A, B, al, bl, steps=steps, width=width).numpy()
    got = _emulate_register_kernel(
        pairs, steps=steps, width=width, lanes_per_thread=lanes_per_thread, strip=strip
    )
    np.testing.assert_array_equal(got, want)


def test_k1_padded_rows_hold_the_reference_characters():
    """`pad_rows` puts each sequence at [front, front + n) and the pad code
    (4 for a, 5 for b) everywhere else, also past a pair's length inside
    its row."""
    pairs = _small_batch()
    A, B, al, bl = port_wf.pack_pairs(pairs, CPU)
    B[:, :] = 3  # contents past each length must not survive
    B[:, : bl.max()] = port_wf.pack_pairs(pairs, CPU)[1]
    front, stride = port_wf.pad_geometry(64, 256)
    got = port_wf.pad_rows(B, bl, port_wf.PAD_B, front, stride).numpy()
    for p, (_, b) in enumerate(pairs):
        want = np.full(stride, port_wf.PAD_B, np.int8)
        n = min(len(b), stride - front)
        want[front : front + n] = b[:n]
        np.testing.assert_array_equal(got[p], want)


def _source_launches() -> dict:
    """width -> (lanes per thread, threads at most, strip) of each case of
    `pm_wavefront_dp`'s switch in csrc/wavefront.cu."""
    import pathlib
    import re

    src = pathlib.Path(port_wf.__file__).parent.parent / "csrc" / "wavefront.cu"
    cases = re.findall(
        r"case (\d+): PM_LAUNCH\((\d+), (\d+), (?:true|false), (\d+)\);", src.read_text()
    )
    return {int(w): (int(lanes), int(maxt), int(strip)) for w, lanes, maxt, strip in cases}


@pytest.mark.parametrize("width", [32 << k for k in range(10)])
def test_k1_design_must_serve_the_width(width):
    """The layout the CUDA kernel takes at `width` is one the schedule test
    above rehearses, and passes the launch's own checks: L even (windows
    start at exact halves), the computed lanes cover the band, the threads
    fit the block, and a strip leaves 32 halo lanes on each side."""
    launches = _source_launches()
    assert sorted(launches) == [32 << k for k in range(10)]
    assert max(launches) == port_wf.MAX_REG_WIDTH
    lanes, max_threads, strip = launches[width]
    assert (width, lanes, strip) in _REG_GEOMETRIES
    assert lanes % 2 == 0 and width % strip == 0
    if strip == width:  # one warp per pair
        assert width < 256 and width // lanes <= min(32, max_threads)
    else:
        assert width >= 256 and 32 * (width // strip) <= max_threads
        assert 32 * lanes - strip >= 64 and 32 * lanes <= width
