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

import chip_smoke
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
    b = a less 38 bases: rows reach b_len + W/2 + 2).  The smoke run puts
    the same batch through the CUDA kernel at every width."""
    return chip_smoke.banded_edge_pairs()


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
    with pytest.raises(ValueError, match="registers"):
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


_INT_MIN = -(2**31)


def _launch_table() -> dict:
    """width -> (lanes per thread, warps, rows per step, prefetch), read
    from the switch in csrc/banded.cu's `pm_banded_dp`."""
    import pathlib
    import re

    src = pathlib.Path(port.__file__).parents[1] / "csrc" / "banded.cu"
    rows = re.findall(
        r"case (\d+): PM_BANDED_LAUNCH\((\d+), (\d+), (\d+), (true|false)\);", src.read_text()
    )
    return {int(w): (int(l), int(nw), int(u), pf == "true") for w, l, nw, u, pf in rows}


def _shfl_up(x, d):
    """__shfl_up_sync over each warp (32 consecutive entries of the last
    axis): entry l gets entry l - d, or keeps its own where l % 32 < d."""
    w = x.reshape(*x.shape[:-1], -1, 32)
    return np.concatenate([w[..., :d], w[..., :-d]], axis=-1).reshape(x.shape)


def _warp_exclusive_max(run):
    """csrc/banded.cu's scan of the thread maxima: shifted up one lane (lane
    0 gets INT_MIN), two ladder steps (Q = max of lanes l-4 .. l-1), then Q
    of l, l-4, ..., l-28 at once; every shuffle unmasked (below lane 0 a
    lane gets its own value).  Returns each lane's max over the lanes
    before it in its warp (INT_MIN for lane 0)."""
    lane = np.arange(run.shape[-1]) % 32
    Q = np.where(lane == 0, _INT_MIN, _shfl_up(run, 1))
    for d in (1, 2):
        Q = np.maximum(Q, _shfl_up(Q, d))
    before = Q
    for d in range(4, 32, 4):
        before = np.maximum(before, _shfl_up(Q, d))
    return before


def _emulate_banded_kernel(pairs, *, rows, width, lanes_per_thread, warps, step, prefetch,
                           match=2, mismatch=-3, gap=-4):
    """A NumPy replay of csrc/banded.cu's `banded_kernel`, all pairs at
    once: T = 32 * warps threads of L lanes, scores in scan units (P = dp -
    gap*j); per 16-row block each thread's raw words of the padded b
    (realigned by w0 % 4 bytes) and of a, row r of each unrolled step of
    `step` rows reading bytes r ... of them, then the windows moving on;
    pass 1 with no checks and the warp's last lane holding
    back its up term; the warp scan (`_warp_exclusive_max`); the warp maxima
    in slots of the row's parity, published before the barrier, and after
    it the earlier warps' maxima (which leave the held-back terms out) and
    the last lane's own up term, from the next warp's first P written the
    row before; pass 2 giving lanes outside 0 <= j <= b_len their NEG,
    codes by comparing in scan units.  Returns the dirs buffer [rows,
    batch, W]."""
    L, NW = lanes_per_thread, warps
    T = 32 * NW
    assert T * L == width and L <= 32 and NW <= 32 and step in (1, 4)
    A, B, al, bl = port.pack_pairs(pairs, CPU)
    a_stride, b_front, b_stride = port.pad_geometry(rows, width)
    ap = port.pad_rows(A, al, port.PAD, 0, a_stride).numpy().astype(np.int64)
    bp = port.pad_rows(B, bl, port.PAD, b_front, b_stride).numpy().astype(np.int64)
    assert a_stride % 16 == 0 and b_stride % 16 == 0 and b_front == width // 2 + 16
    n_pairs, half, neg = len(pairs), width // 2, port.NEG
    nb_words = (L + 18) // 4
    assert 4 * nb_words >= L + 15
    lb = bl.numpy().astype(np.int64)[:, None, None]  # [P, 1, 1]
    t = np.arange(T)
    lane, warp = t % 32, t // 32
    w0 = t * L
    k = np.arange(L)
    band_end = t == T - 1
    deferred = (NW > 1) & (lane == 31) & ~band_end
    j0 = (w0[:, None] + k - half)[None]
    # Scores in scan units, P = dp - gap*j.
    P = np.where((j0 >= 0) & (j0 <= lb), 0, neg - gap * j0) * np.ones((n_pairs, 1, 1), np.int64)
    tot = np.full((2, n_pairs, NW), 12345)  # junk until written
    edge = np.full((2, n_pairs, NW), -12345)
    dirs = np.zeros((rows, n_pairs, width), np.uint8)

    def shfl_down1(x):
        x = x.reshape(n_pairs, NW, 32)
        return np.concatenate([x[..., 1:], x[..., -1:]], axis=2).reshape(n_pairs, T)

    nb = shfl_down1(P[:, :, 0])
    if NW > 1:
        edge[1] = P[:, ::32, 0]
    for i0 in range(0, rows, 16):
        for blk in ([i0, i0 + 16] if prefetch else [i0]):  # the loads' bounds
            base = blk + w0 + 16
            assert (base // 4 * 4).min() >= 0 and (base // 4 * 4 + 4 * (nb_words + 1)).max() <= b_stride
            assert blk + 16 <= a_stride
        # Each thread's raw words from its word-aligned start, realigned by
        # w0 % 4 bytes.
        word0 = (i0 + w0 + 16) // 4
        win = bp[:, (4 * word0 + w0 % 4)[:, None] + np.arange(4 * nb_words)]
        av = ap[:, i0: i0 + 16].copy()
        for s in range(16):
            if i0 + s >= rows:
                break
            i = i0 + s + 1
            par = i & 1
            r = s % step  # the row within its unrolled step
            ca = av[:, r][:, None, None]
            jt = (i + w0 - half)[None, :, None]
            j = jt + k  # [1, T, L]
            # Pass 1 without checks; the warp's last lane holds its up back.
            cu_last = np.where(
                deferred, _INT_MIN, np.where(band_end, neg - gap * j[:, :, -1], nb + gap)
            )
            cd = P + np.where(win[:, :, r:r + L] == ca, match - gap, mismatch - gap)
            cu = np.concatenate([P[:, :, 1:] + gap, cu_last[:, :, None]], 2)
            pm = np.maximum.accumulate(np.maximum(cd, cu), axis=2)
            run = pm[:, :, -1]
            before = _warp_exclusive_max(run)
            if NW > 1:
                tot[par] = np.maximum(before, run)[:, 31::32]
                # -- barrier --
                for q in range(NW - 1):  # totals without the held-back terms
                    later = warp > q
                    before = np.where(later, np.maximum(before, tot[par][:, q:q + 1]), before)
                up_held = edge[par][:, np.minimum(warp + 1, NW - 1)] + gap
                cu[:, :, -1] = np.where(deferred, up_held, cu[:, :, -1])
                pm[:, :, -1] = np.where(deferred, np.maximum(pm[:, :, -1], up_held), pm[:, :, -1])
            # Pass 2: lanes outside 0 <= j <= b_len take NEG.
            cell = (j >= 0) & (j <= lb)
            x = np.where(cell, np.maximum(before[:, :, None], pm), neg - gap * j)
            code = np.where(x == cd, port.DIAG, np.where(x == cu, port.UP, port.LEFT))
            for v in (x, cd, cu):
                assert v.min() >= _INT_MIN and v.max() < 2**31  # int32 arithmetic
            dirs[i - 1] = code.reshape(n_pairs, width)
            P = x
            nb = shfl_down1(P[:, :, 0])
            if NW > 1:
                edge[par ^ 1] = P[:, ::32, 0]
            if r == step - 1:  # the windows move on by `step` bytes
                # (a whole word moves and the last stays; a shift brings zeros)
                top_w = win[:, :, -4:] if step == 4 else np.zeros_like(win[:, :, :1])
                top_a = av[:, -4:] if step == 4 else np.zeros_like(av[:, :1])
                win = np.concatenate([win[:, :, step:], top_w], 2)
                av = np.concatenate([av[:, step:], top_a], 1)
    return dirs


def test_banded_launch_table_covers_every_width():
    table = _launch_table()
    assert sorted(table) == [port.MIN_WIDTH << n for n in range(11)]
    assert max(table) == port.MAX_WIDTH
    for width, (lanes, warps, step, _) in table.items():
        assert 32 * warps * lanes == width and lanes <= 32 and warps <= 32
        assert step in (1, 4)
        # One warp below 256 lanes, four warps until L reaches 32.
        assert warps == (1 if width < 256 else max(4, width // 1024))


def test_warp_scan_is_the_exclusive_prefix_max():
    """The kernel's warp scan on arbitrary thread maxima, descending runs
    included: DP rows rarely put a lane's unique maximum 29 or more lanes
    back (a later lane's own operand is at most match - 2*gap below it), so
    the replay below seldom reaches the farthest window."""
    rng = np.random.default_rng(8)
    run = np.concatenate([
        rng.integers(-1000, 1000, (64, 32)),
        np.sort(rng.integers(-(10**8), 10**8, (64, 32)))[:, ::-1],
        np.full((1, 32), 7),
    ]).reshape(-1)
    want = np.maximum.accumulate(run.reshape(-1, 32), axis=1)
    want = np.concatenate([np.full((want.shape[0], 1), _INT_MIN), want[:, :-1]], 1)
    np.testing.assert_array_equal(_warp_exclusive_max(run), want.reshape(-1))


# (width, rows, (match, mismatch, gap)): every width of the launch table at
# 128 rows (64 from W 16384, to keep the file quick), row counts that end
# inside a 16-row block (and inside a four-row step, at W 128 and 256),
# and scores under which a mismatch costs more than two gaps, so that an up
# move followed by a left move can beat the diag move.
_DEFAULT = (2, -3, -4)
_GAPPY = (1, -9, -2)
_REPLAY = (
    [(32 << n, 128 if n < 9 else 64, _DEFAULT) for n in range(11)]
    + [(64, 61, _DEFAULT), (512, 77, _DEFAULT), (128, 61, _DEFAULT), (256, 77, _DEFAULT)]
    + [(w, 128, _GAPPY) for w in (64, 256, 512, 4096, 8192)]
)


@pytest.mark.parametrize("width,rows,scores", _REPLAY)
def test_k3k4_register_schedule_equals_plain(width, rows, scores):
    """The CUDA kernel's schedule (lane ownership, padded word windows, the
    two-level scan, the warp edge terms) reproduces the plain version's
    whole buffer on the edge batch: a CPU rehearsal of what the card runs."""
    pairs = _batch_pairs() + [(np.zeros(0, np.int8),) * 2]
    lanes, warps, step, prefetch = _launch_table()[width]
    kw = dict(zip(("match", "mismatch", "gap"), scores))
    A, B, al, bl = port.pack_pairs(pairs, CPU)
    want = port.banded_dp_plain(A, B, al, bl, rows=rows, width=width, **kw).numpy()
    got = _emulate_banded_kernel(
        pairs, rows=rows, width=width, lanes_per_thread=lanes, warps=warps,
        step=step, prefetch=prefetch, **kw,
    )
    np.testing.assert_array_equal(got, want)


def test_neg_margin_bounds_the_cuda_launch():
    """The kernel's unmasked first pass is exact while NEG stays below every
    score; the wrapper refuses a CUDA launch past that margin."""
    assert port.within_neg_margin(8192, 512, 2, -3, -4)
    assert port.within_neg_margin(4_000_000, port.MAX_WIDTH, 2, -3, -4)
    assert not port.within_neg_margin(30_000_000, 512, 2, -3, -4)
    assert not port.within_neg_margin(128, 512, 2, -3, -10**6)


@pytest.mark.cuda
def test_cuda_refuses_inputs_past_the_neg_margin_before_launching():
    """A contract of the CUDA path alone: the plain version (the CPU path)
    accepts a gap of -10^6 at 128 rows, the card's wrapper raises before it
    builds or launches anything, and neither launch count moves."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    rng = np.random.default_rng(4)
    pairs = [_pair(rng, 100, 3), _pair(rng, 90, 5)]
    kw = dict(rows=128, width=256, match=2, mismatch=-3, gap=-(10**6))
    assert not port.within_neg_margin(128, 256, 2, -3, -(10**6))
    port.banded_dp_batch(*port.pack_pairs(pairs, CPU), **kw)  # the CPU path accepts
    port.banded_dp.launches = port.banded_dp_batch.launches = 0
    cuda = port.pack_pairs(pairs, torch.device("cuda"))
    with pytest.raises(ValueError, match="NEG"):
        port.banded_dp_batch(*cuda, **kw)
    with pytest.raises(ValueError, match="NEG"):
        port.banded_dp(*port.pack_pairs(pairs[:1], torch.device("cuda")), **kw)
    assert port.banded_dp.launches == port.banded_dp_batch.launches == 0
