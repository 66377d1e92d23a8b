"""Row-banded global alignment (counterpart of the row-streamed half of
paramugsy_tpu.ops.pallas_extend: ``banded_dp``, ``banded_dp_batch``,
``banded_align``, ``banded_align_batch``).

The DP is streamed row by row over the band: row i (1-based) holds cells
j = i + w - W/2 for lane w in [0, W); diag comes from lane w of row i-1,
up from lane w+1, and the in-row left dependency is closed with an
inclusive prefix max over cand - gap*j.  Output: uint8 direction codes
(0 diag, 1 up, 2 left) [rows, batch, W], traced back on the host.

One hand-written CUDA kernel (``csrc/banded.cu``) computes both of the
reference's Pallas kernels, K3 `_band_kernel` (one pair) and K4
`_band_kernel_batch` (eight pairs); the two wrappers `banded_dp` and
`banded_dp_batch` launch it and count their launches separately.  Beside
it, `banded_dp_plain` is the plain PyTorch version: the CPU path and the
card's oracle.

The reference's rolled query window is replaced by direct reads: row i,
lane w reads b[i + w - W/2 - 1] and a[i - 1], code 4 outside [0, b_len)
and [0, a_len).  That equals `banded_align_batch`'s clamped padding and
`banded_align`'s padding wherever the latter does not raise, so whole
buffers, rows past a_len included, are bit-identical to the reference's.
The CUDA kernel reads them from copies of a and b padded with code 4
(`pad_geometry`), so it needs no bounds check.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.  The two paths differ in what they accept:
the CUDA kernel needs NEG to stay below every score (`within_neg_margin`),
so on the card the wrappers refuse, before any launch, scores and sizes
with |gap| * (rows + W) + |match| + |mismatch| >= 10^8 (a gap of -10^6 at
128 rows, say), which the plain version and the first CUDA kernel
computed.  Under the default scores the margin holds up to 25 million rows.
"""
from __future__ import annotations

import numpy as np
import torch

from paramugsy_tpu_torch.coords.range import Range
from paramugsy_tpu_torch.ops.engines import count_launch
from paramugsy_tpu_torch.ops.wavefront import _launch_stream, _ptr, pack_pairs, pad_rows

NEG = -(10**8)
DIAG, UP, LEFT = 0, 1, 2
PAD = 4
BATCH = 8
MIN_WIDTH = 32
# The kernel keeps at most 32 lanes of the dp row (and 32 scan operands) in
# each thread's registers, with at most 1024 threads a block.
MAX_WIDTH = 1 << 15
# Rows of characters compared per vectorized step of the plain version.
_PLAIN_ROWS = 64


def _check(a, b, a_len, b_len, rows: int, width: int, kernel_width: bool = True) -> int:
    """Validate the inputs; with `kernel_width`, also that the CUDA kernel
    takes the width (the wrappers hold that limit on both devices)."""
    batch = a.shape[0]
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError("sequences must be int8 code tensors")
    if a_len.dtype != torch.int32 or b_len.dtype != torch.int32:
        raise TypeError("lengths must be int32 tensors")
    if a.dim() != 2 or b.dim() != 2 or b.shape[0] != batch or batch == 0:
        raise ValueError("sequences must be [batch, length] tensors, batch >= 1")
    if a_len.shape != (batch,) or b_len.shape != (batch,):
        raise ValueError("lengths must be [batch] tensors")
    if len({a.device, b.device, a_len.device, b_len.device}) != 1:
        raise ValueError("all inputs must be on one device")
    if rows <= 0:
        raise ValueError("rows must be positive")
    if width & (width - 1) or width < MIN_WIDTH or (kernel_width and width > MAX_WIDTH):
        raise ValueError(
            f"width must be a power of two in [{MIN_WIDTH}, {MAX_WIDTH}]: the "
            f"kernel keeps the band's row in registers, 32 lanes to each of at "
            f"most 1024 threads"
        )
    return batch


def banded_dp_plain(
    a: torch.Tensor,
    b: torch.Tensor,
    a_len: torch.Tensor,
    b_len: torch.Tensor,
    *,
    rows: int,
    width: int,
    match: int = 2,
    mismatch: int = -3,
    gap: int = -4,
) -> torch.Tensor:
    """Plain PyTorch version of K3/K4: one vectorized update per row,
    `torch.cummax` for the prefix max.  Returns uint8 [rows, batch, W].
    Any power-of-two width from MIN_WIDTH up: MAX_WIDTH is the CUDA
    kernel's limit, which the wrappers check."""
    batch = _check(a, b, a_len, b_len, rows, width, kernel_width=False)
    dev = a.device
    i32 = torch.int32
    half = width // 2
    lanes = torch.arange(width, device=dev, dtype=i32)
    bl = b_len[:, None]

    def chars(seq, n, idx):
        # idx: positions shared by all pairs -> int8 [batch, *idx.shape],
        # code 4 outside [0, n).
        if seq.shape[1] == 0:
            return torch.full((batch, *idx.shape), PAD, dtype=torch.int8, device=dev)
        got = seq[:, idx.clamp(0, seq.shape[1] - 1)]
        ok = (idx >= 0) & (idx < n.view(batch, *[1] * idx.dim()))
        return torch.where(ok, got, PAD)

    j0 = lanes - half
    prev = torch.where((j0 >= 0) & (j0 <= bl), gap * j0, NEG).to(i32)
    neg_col = torch.full((batch, 1), NEG, dtype=i32, device=dev)
    dirs = torch.empty((rows, batch, width), dtype=torch.uint8, device=dev)
    for r0 in range(0, rows, _PLAIN_ROWS):
        r1 = min(rows, r0 + _PLAIN_ROWS)
        ia = torch.arange(r0, r1, device=dev)
        ca = chars(a, a_len, ia)  # [batch, R]
        cb = chars(b, b_len, ia[:, None] + lanes - half)  # [batch, R, W]
        for r in range(r1 - r0):
            i = r0 + r + 1
            j = i + lanes - half
            valid = (j >= 1) & (j <= bl)
            sub = torch.where(cb[:, r] == ca[:, r, None], match, mismatch).to(i32)
            diag = prev + sub
            up = torch.cat([prev[:, 1:] + gap, neg_col], 1)
            cand = torch.maximum(diag, up)
            cand = torch.where(j == 0, torch.clamp(cand, min=gap * i), cand)
            cand = torch.where(valid | (j == 0), cand, NEG)
            gj = gap * j
            run = torch.cummax(cand - gj, dim=1).values
            edge = torch.where(j == 0, gap * i, NEG).to(i32)
            dp = torch.where(valid, run + gj, edge)
            dirs[i - 1] = torch.where(
                dp == diag, DIAG, torch.where(dp == up, UP, LEFT)
            ).to(torch.uint8)
            prev = dp
    return dirs


def pad_geometry(rows: int, width: int) -> tuple[int, int, int]:
    """(a_stride, b_front, b_stride) of the padded rows the CUDA kernel
    reads.  Each thread loads, once per 16 rows, 4-byte words of a from
    byte i0 and of b from byte b_front - W/2 + i0 + w0 (rounded down to a
    word), the next block's as well: a up to byte rows16 + 15 (rows16 =
    rows rounded up to 16), b up to byte rows16 + W + 37.  Multiples of
    16, so every word is aligned."""
    rows16 = -(-rows // 16) * 16
    return rows16 + 16, width // 2 + 16, rows16 + width + 48


def within_neg_margin(rows: int, width: int, match: int, mismatch: int, gap: int) -> bool:
    """Whether NEG stays below every score the CUDA kernel computes: its
    first pass leaves the lanes outside the cells unmasked, which is exact
    only while |gap| * (rows + W) + |match| + |mismatch| < -NEG
    (csrc/banded.cu's header)."""
    return abs(gap) * (rows + width) + abs(match) + abs(mismatch) < -NEG


def _launch(a, b, a_len, b_len, rows, width, match, mismatch, gap) -> torch.Tensor:
    from paramugsy_tpu_torch.ops import _kernels

    if not within_neg_margin(rows, width, match, mismatch, gap):
        raise ValueError(
            f"rows {rows}, width {width} and scores ({match}, {mismatch}, {gap}) "
            f"reach NEG = {NEG}: the kernel needs |gap| * (rows + width) + "
            f"|match| + |mismatch| < {-NEG}"
        )
    batch = a.shape[0]
    a_stride, b_front, b_stride = pad_geometry(rows, width)
    # The padded copies (a few small device ops per launch of many
    # sequential rows) keep the wrapper's interface: rows of any width,
    # contents past each length ignored.
    a = pad_rows(a, a_len, PAD, 0, a_stride)
    b = pad_rows(b, b_len, PAD, b_front, b_stride)
    b_len = b_len.contiguous()
    dirs = torch.empty((rows, batch, width), dtype=torch.uint8, device=a.device)
    with torch.cuda.device(a.device):
        rc = _kernels.library().pm_banded_dp(
            _ptr(a), _ptr(b), _ptr(a_len), _ptr(b_len),
            a_stride, b_stride, rows, width, batch,
            match, mismatch, gap, _ptr(dirs), _launch_stream(a.device),
        )
    if rc != 0:
        raise RuntimeError(f"banded kernel launch failed: CUDA error {rc}")
    return dirs


def _run(a, b, a_len, b_len, rows, width, match, mismatch, gap):
    """(dirs [rows, batch, W], launched?) on the inputs' device."""
    _check(a, b, a_len, b_len, rows, width)
    if a.device.type == "cpu":
        return banded_dp_plain(
            a, b, a_len, b_len, rows=rows, width=width,
            match=match, mismatch=mismatch, gap=gap,
        ), False
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    return _launch(a, b, a_len, b_len, rows, width, match, mismatch, gap), True


def banded_dp(
    a: torch.Tensor,
    b: torch.Tensor,
    a_len: torch.Tensor,
    b_len: torch.Tensor,
    *,
    rows: int,
    width: int = 512,
    match: int = 2,
    mismatch: int = -3,
    gap: int = -4,
) -> torch.Tensor:
    """K3: direction codes of one pair, uint8 [rows, W].

    a, b: int8 [1, La], [1, Lb] code rows (contents past the lengths are
    not read); a_len, b_len: int32 [1].  On CUDA tensors, rows, width and
    scores past `within_neg_margin` raise ValueError before any launch; the
    CPU path has no such limit.
    """
    if a.shape[0] != 1:
        raise ValueError("banded_dp takes one pair; use banded_dp_batch")
    dirs, launched = _run(a, b, a_len, b_len, rows, width, match, mismatch, gap)
    count_launch(banded_dp, launched)
    return dirs[:, 0]


banded_dp.launches = 0


def banded_dp_batch(
    a: torch.Tensor,
    b: torch.Tensor,
    a_len: torch.Tensor,
    b_len: torch.Tensor,
    *,
    rows: int,
    width: int = 512,
    match: int = 2,
    mismatch: int = -3,
    gap: int = -4,
) -> torch.Tensor:
    """K4: direction codes of a batch of pairs, uint8 [rows, batch, W]
    (same inputs as `banded_dp`, batch rows each)."""
    dirs, launched = _run(a, b, a_len, b_len, rows, width, match, mismatch, gap)
    count_launch(banded_dp_batch, launched)
    return dirs


banded_dp_batch.launches = 0


def traceback_band(
    dirs: np.ndarray, a_len: int, b_len: int, width: int
) -> tuple[list[Range], list[Range], int]:
    """Host traceback over banded direction rows (copied from the
    reference, whose module imports JAX).

    Returns (ref_gap_runs, query_gap_runs, n_columns) in alignment-column
    space, like ops.extend.traceback_gaps.
    """
    half = width // 2
    i, j = a_len, b_len
    cols: list[int] = []
    while i > 0 or j > 0:
        if i == 0:
            d = LEFT
        elif j == 0:
            d = UP
        else:
            w = j - i + half
            if w < 0:
                d = UP
            elif w >= width:
                d = LEFT
            else:
                d = int(dirs[i - 1, w])
        if d == DIAG:
            cols.append(0)
            i -= 1
            j -= 1
        elif d == UP:
            cols.append(2)
            i -= 1
        else:
            cols.append(1)
            j -= 1
    cols.reverse()
    n = len(cols)
    ref_runs: list[Range] = []
    query_runs: list[Range] = []
    start = None
    kind = 0
    for idx, c in enumerate(cols + [0]):
        if c != kind:
            if kind == 1:
                ref_runs.append(Range(start + 1, idx))
            elif kind == 2:
                query_runs.append(Range(start + 1, idx))
            if c != 0:
                start = idx
            kind = c
    return ref_runs, query_runs, n


def chunk_rows(a_lens, chunk: int) -> int:
    """The dirs buffer's first dimension: the longest a, rounded up to
    `chunk` (at least one chunk), as in the reference."""
    return -(-max(max(a_lens), 1) // chunk) * chunk


def banded_align(
    a_codes: np.ndarray,
    b_codes: np.ndarray,
    *,
    width: int = 512,
    chunk: int = 128,
    match: int = 2,
    mismatch: int = -3,
    gap: int = -4,
    device: str | torch.device,
):
    """End-to-end banded alignment of one (long) segment pair on `device`:
    (ref_gap_runs, query_gap_runs, n_columns).

    Where the reference's `banded_align` raises IndexError (its padded
    query is too short once the chunk-rounded row count reaches
    b_len + W/2 + 2, e.g. a of 300 bp, b = a less 127 bases, W 256,
    chunk 128), this returns what the reference's `banded_align_batch`
    returns for the pair: past the query every lane reads code 4.
    """
    a_len, b_len = len(a_codes), len(b_codes)
    if abs(a_len - b_len) >= width // 2:
        raise ValueError(
            f"length difference {abs(a_len - b_len)} exceeds band {width//2}"
        )
    A, B, al, bl = pack_pairs([(a_codes, b_codes)], torch.device(device))
    dirs = banded_dp(
        A, B, al, bl, rows=chunk_rows([a_len], chunk), width=width,
        match=match, mismatch=mismatch, gap=gap,
    )
    return traceback_band(dirs.cpu().numpy(), a_len, b_len, width)


def banded_align_plain(
    a_codes: np.ndarray,
    b_codes: np.ndarray,
    *,
    width: int,
    chunk: int = 128,
    match: int = 2,
    mismatch: int = -3,
    gap: int = -4,
):
    """`banded_align` on the CPU through `banded_dp_plain` alone, at any
    power-of-two width: the host fallback of
    `ops.extend.align_long_segment` without the native library, whose
    width passes MAX_WIDTH once the length difference reaches 16384."""
    A, B, al, bl = pack_pairs([(a_codes, b_codes)], torch.device("cpu"))
    dirs = banded_dp_plain(
        A, B, al, bl, rows=chunk_rows([len(a_codes)], chunk), width=width,
        match=match, mismatch=mismatch, gap=gap,
    )
    return traceback_band(dirs[:, 0].numpy(), len(a_codes), len(b_codes), width)


def banded_align_batch(
    pairs: list[tuple[np.ndarray, np.ndarray]],
    *,
    width: int = 512,
    chunk: int = 128,
    match: int = 2,
    mismatch: int = -3,
    gap: int = -4,
    device: str | torch.device,
):
    """Align up to BATCH (a, b) pairs in one launch on `device`.

    The batch is padded to BATCH pairs with empty ones, as in the
    reference.  Returns a list of (ref_gap_runs, query_gap_runs, n_columns).
    """
    if not 1 <= len(pairs) <= BATCH:
        raise ValueError(f"1..{BATCH} pairs per launch")
    for a, b in pairs:
        if abs(len(a) - len(b)) >= width // 2:
            raise ValueError("length difference exceeds band")
    empty = np.zeros(0, np.int8)
    padded = list(pairs) + [(empty, empty)] * (BATCH - len(pairs))
    A, B, al, bl = pack_pairs(padded, torch.device(device))
    dirs = banded_dp_batch(
        A, B, al, bl, rows=chunk_rows([len(a) for a, _ in pairs], chunk), width=width,
        match=match, mismatch=mismatch, gap=gap,
    ).cpu().numpy()
    return [
        traceback_band(dirs[:, p, :], len(a), len(b), width)
        for p, (a, b) in enumerate(pairs)
    ]
