"""Banded global alignment over anti-diagonals: the long-segment engine
(counterpart of the wavefront half of paramugsy_tpu.ops.pallas_extend).

Two kernels, each a hand-written CUDA kernel (``csrc/``) with a plain
PyTorch version beside it:

* K1 `wavefront_dp` (replaces the Pallas ``_wavefront_kernel``): banded
  Needleman-Wunsch of a batch of independent pairs.  Cell (i, j) sits at
  step d = i + j, lane w = j - i + W/2; diag comes from step d-2 in the
  same lane, up from d-1 lane w+1, left from d-1 lane w-1.  Ties go
  DIAG > UP > LEFT.  Output: int32 [steps/16, batch, W], step d's 2-bit
  code in bits 2*((d-1) % 16) of word (d-1) // 16.
* K2 `wavefront_traceback` (replaces the Pallas ``_traceback_kernel``):
  per pair, the walk from (a_len, b_len) to (0, 0) over those codes.
  Output: int32 [batch, 1 + cap16], column 0 = number of moves, then the
  moves in walk order, move m in bits 2*(m % 16) of word m // 16.

Nothing is masked, as in the reference: off-parity and out-of-rectangle
lanes compute values that never flow into real cells (sequence pads 4
for a and 5 for b never match; rows start at NEG), and both versions
compute every lane exactly like the reference, so whole buffers are
bit-identical.  The reference's rolled character windows equal direct
reads a[floor((d - w + W/2) / 2) - 1] and b[floor((d + w - W/2) / 2) - 1]
(pad outside the sequence), which both versions use; K1's CUDA kernel
reads them from copies of the rows padded on both sides (`pad_rows`), so
it needs no bounds check.

A wrapper given CPU tensors runs the plain version; given CUDA tensors
it launches the kernel or raises.  Each wrapper counts its launches in
its ``launches`` attribute.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from paramugsy_tpu_torch.coords.range import Range

NEG = -(10**8)
DIAG, UP, LEFT = 0, 1, 2
PAD_A, PAD_B = 4, 5
# Widest band whose rows the CUDA kernel keeps in registers; wider bands
# get a second kernel with a device scratch buffer for the rows.
MAX_REG_WIDTH = 1 << 14


def _check_pairs(a, b, a_len, b_len, steps: int, width: int) -> int:
    batch = a.shape[0]
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError("sequences must be int8 code tensors")
    if a_len.dtype != torch.int32 or b_len.dtype != torch.int32:
        raise TypeError("lengths must be int32 tensors")
    if a.dim() != 2 or b.dim() != 2 or b.shape[0] != batch:
        raise ValueError("sequences must be [batch, length] tensors")
    if a_len.shape != (batch,) or b_len.shape != (batch,):
        raise ValueError("lengths must be [batch] tensors")
    if len({a.device, b.device, a_len.device, b_len.device}) != 1:
        raise ValueError("all inputs must be on one device")
    if steps <= 0 or steps % 16:
        raise ValueError("steps must be a positive multiple of 16")
    if width < 2 or width & (width - 1):
        raise ValueError("width must be a power of two")
    return batch


def _launch_stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


# --------------------------------------------------------------------------
# K1: forward DP
# --------------------------------------------------------------------------


def _pack_words(codes: list[torch.Tensor]) -> torch.Tensor:
    """16 code planes -> one int32 word plane (code 2 in slot 15 sets bit
    31: shifts run in int64 and wrap to int32 only at the end)."""
    acc = torch.zeros_like(codes[0], dtype=torch.int64)
    for s, c in enumerate(codes):
        acc |= c.to(torch.int64) << (2 * s)
    return torch.where(acc >= 1 << 31, acc - (1 << 32), acc).to(torch.int32)


def wavefront_dp_plain(
    a: torch.Tensor,
    b: torch.Tensor,
    a_len: torch.Tensor,
    b_len: torch.Tensor,
    *,
    steps: int,
    width: int,
    match: int = 2,
    mismatch: int = -3,
    gap: int = -4,
) -> torch.Tensor:
    """Plain PyTorch version of K1 (one vectorized update per step)."""
    batch = _check_pairs(a, b, a_len, b_len, steps, width)
    dev = a.device
    half = width // 2
    lanes = torch.arange(width, device=dev)
    al = a_len.to(torch.int64)[:, None]
    bl = b_len.to(torch.int64)[:, None]
    a64 = a.to(torch.int64)
    b64 = b.to(torch.int64)

    def chars(seq, n, idx, pad):
        # idx: [16, W] sequence positions of one word's 16 steps.
        if seq.shape[1] == 0:
            return torch.full((batch, 16, width), pad, dtype=torch.int64, device=dev)
        flat = torch.clamp(idx, 0, seq.shape[1] - 1).reshape(1, -1)
        got = torch.gather(seq, 1, flat.expand(batch, -1)).view(batch, 16, width)
        ok = (idx >= 0) & (idx < n[:, :, None])
        return torch.where(ok, got, pad)

    prev1 = torch.where(lanes == half, 0, NEG).to(torch.int32).expand(batch, width)
    prev2 = torch.full((batch, width), NEG, dtype=torch.int32, device=dev)
    neg_col = torch.full((batch, 1), NEG, dtype=torch.int32, device=dev)
    words = []
    for d0 in range(0, steps, 16):
        d = torch.arange(d0 + 1, d0 + 17, device=dev)[:, None]
        ia = torch.div(d - lanes + half, 2, rounding_mode="floor") - 1
        ib = torch.div(d + lanes - half, 2, rounding_mode="floor") - 1
        sub = torch.where(
            chars(a64, al, ia, PAD_A) == chars(b64, bl, ib, PAD_B), match, mismatch
        ).to(torch.int32)
        codes = []
        for s in range(16):
            diag = prev2 + sub[:, s]
            up = torch.cat([prev1[:, 1:] + gap, neg_col], 1)
            left = torch.cat([neg_col, prev1[:, :-1] + gap], 1)
            dp = torch.maximum(torch.maximum(diag, up), left)
            codes.append(
                torch.where(dp == diag, DIAG, torch.where(dp == up, UP, LEFT))
            )
            prev2, prev1 = prev1, dp
        words.append(_pack_words(codes))
    return torch.stack(words)


def pad_geometry(steps: int, width: int) -> tuple[int, int]:
    """(front, stride) of the padded rows K1's register kernel reads: it
    reads a from index -W/4 to steps/2 + W/4 + 7 and b from -W/4 - 1 to
    steps/2 + W/4 + 6 (its 16-step windows and the prefetch of the next
    one), so these bounds leave a margin on both sides."""
    front = width // 4 + 16
    return front, front + steps // 2 + width // 4 + 16


def pad_rows(
    seq: torch.Tensor, n_len: torch.Tensor, pad: int, front: int, stride: int
) -> torch.Tensor:
    """int8 [batch, L] rows -> int8 [batch, stride] rows holding each
    sequence at [front, front + n_len) and `pad` everywhere else, so that
    the kernel reads the reference's characters without a bounds check.

    The copy is made per launch, inside `wavefront_dp`, so that K1 keeps
    the reference's interface (rows of any width, contents past each
    length ignored), the one its plain version and the wide kernel take
    too; it costs a few small device ops beside a launch of many thousand
    sequential steps."""
    batch = seq.shape[0]
    out = torch.full((batch, stride), pad, dtype=torch.int8, device=seq.device)
    k = min(seq.shape[1], stride - front)
    keep = torch.arange(k, device=seq.device) < n_len[:, None]
    out[:, front : front + k] = torch.where(keep, seq[:, :k], pad)
    return out


def wavefront_dp(
    a: torch.Tensor,
    b: torch.Tensor,
    a_len: torch.Tensor,
    b_len: torch.Tensor,
    *,
    steps: int,
    width: int,
    match: int = 2,
    mismatch: int = -3,
    gap: int = -4,
) -> torch.Tensor:
    """K1: packed anti-diagonal direction codes, int32 [steps/16, batch, W].

    a, b: int8 [batch, La], [batch, Lb] code rows (contents past each
    pair's length are not read; lengths must not exceed the rows);
    a_len, b_len: int32 [batch].  The CUDA kernel picks its layout from
    the width alone (csrc/wavefront.cu).
    """
    batch = _check_pairs(a, b, a_len, b_len, steps, width)
    if a.device.type == "cpu":
        return wavefront_dp_plain(
            a, b, a_len, b_len, steps=steps, width=width,
            match=match, mismatch=mismatch, gap=gap,
        )
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    from paramugsy_tpu_torch.ops import _kernels

    a_len = a_len.contiguous()
    b_len = b_len.contiguous()
    dirs = torch.empty((steps // 16, batch, width), dtype=torch.int32, device=a.device)
    if batch == 0:
        return dirs
    lib = _kernels.library()
    with torch.cuda.device(a.device):
        if width > MAX_REG_WIDTH:
            a = a.contiguous()
            b = b.contiguous()
            scratch = torch.empty((batch, 2, width), dtype=torch.int32, device=a.device)
            rc = lib.pm_wavefront_dp_wide(
                _ptr(a), _ptr(b), _ptr(a_len), _ptr(b_len),
                a.shape[1], b.shape[1], steps, width, batch,
                match, mismatch, gap, _ptr(dirs), _ptr(scratch),
                _launch_stream(a.device),
            )
        else:
            front, stride = pad_geometry(steps, width)
            ap = pad_rows(a, a_len, PAD_A, front, stride)
            bp = pad_rows(b, b_len, PAD_B, front, stride)
            rc = lib.pm_wavefront_dp(
                _ptr(ap), _ptr(bp), stride, front, steps, width, batch,
                match, mismatch, gap, _ptr(dirs),
                _launch_stream(a.device),
            )
    if rc != 0:
        raise RuntimeError(f"wavefront kernel launch failed: CUDA error {rc}")
    wavefront_dp.launches += 1
    return dirs


wavefront_dp.launches = 0


# --------------------------------------------------------------------------
# K2: traceback
# --------------------------------------------------------------------------


def path_words(steps: int) -> int:
    """cap16: words per pair of the traceback output (moves <= steps),
    rounded up to 128 as in the reference's buffer."""
    return ((steps // 16 + 1 + 127) // 128) * 128


def wavefront_traceback_plain(
    dirs: torch.Tensor, a_len: torch.Tensor, b_len: torch.Tensor, *, width: int
) -> torch.Tensor:
    """Plain PyTorch version of K2: all pairs walk in lockstep, one move
    per iteration; the moves are packed into words at the end."""
    steps16, batch, _ = dirs.shape
    dev = dirs.device
    cap16 = path_words(steps16 * 16)
    half = width // 2
    i = a_len.to(torch.int64).clone()
    j = b_len.to(torch.int64).clone()
    bad = (i < 0) | (j < 0) | (i + j > steps16 * 16)
    i = torch.where(bad, 0, i)
    j = torch.where(bad, 0, j)
    n_iter = int((i + j).max()) if batch else 0
    moves = torch.zeros((-(-n_iter // 16) * 16, batch), dtype=torch.int64, device=dev)
    m = torch.zeros(batch, dtype=torch.int64, device=dev)
    lane0 = torch.arange(batch, device=dev) * width
    flat = dirs.reshape(-1).to(torch.int64)
    for t in range(n_iter):
        # A finished pair (i = j = 0) yields LEFT and stays at (0, 0): the
        # clamps below undo its j decrement, and its moves are masked.
        s = i + j - 1
        w = j - i + half
        word = flat[(s.clamp(min=0) >> 4) * (batch * width) + lane0 + w.clamp(0, width - 1)]
        code = (word >> ((s & 15) << 1)) & 3
        code = torch.where(w >= width - 1, LEFT, code)
        code = torch.where(w <= 0, UP, code)
        code = torch.where(j == 0, UP, code)
        code = torch.where(i == 0, LEFT, code)
        moves[t] = code
        m += s >= 0
        # DIAG and UP consume a, DIAG and LEFT consume b (codes 0, 1, 2).
        i = (i + (code >> 1) - 1).clamp_(min=0)
        j = (j + (code & 1) - 1).clamp_(min=0)
    live = torch.arange(len(moves), device=dev)[:, None] < m
    moves = torch.where(live, moves, 0).view(len(moves) // 16, 16, batch)
    shifts = 2 * torch.arange(16, device=dev)[None, :, None]
    words = torch.zeros((batch, cap16 + 1), dtype=torch.int64, device=dev)
    words[:, 1 : 1 + moves.shape[0]] = (moves << shifts).sum(1).T
    words[:, 0] = torch.where(bad, -1, m)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.to(torch.int32)


def wavefront_traceback(
    dirs: torch.Tensor, a_len: torch.Tensor, b_len: torch.Tensor, *, width: int
) -> torch.Tensor:
    """K2: walk-order move codes, int32 [batch, 1 + cap16] (column 0 =
    number of moves, -1 for a pair whose lengths do not fit the buffer;
    every word past the last one used is zero).  The CUDA kernel walks
    each pair with one warp (csrc/traceback.cu) and writes only the words
    that hold an UP or LEFT move, so the buffer is zeroed here."""
    if dirs.dtype != torch.int32 or dirs.dim() != 3 or dirs.shape[2] != width:
        raise ValueError("dirs must be int32 [steps/16, batch, width]")
    steps16, batch, _ = dirs.shape
    if a_len.shape != (batch,) or b_len.shape != (batch,):
        raise ValueError("lengths must be [batch] tensors")
    if a_len.dtype != torch.int32 or b_len.dtype != torch.int32:
        raise TypeError("lengths must be int32 tensors")
    if dirs.device.type == "cpu":
        return wavefront_traceback_plain(dirs, a_len, b_len, width=width)
    if dirs.device.type != "cuda":
        raise ValueError(f"unsupported device {dirs.device}")
    from paramugsy_tpu_torch.ops import _kernels

    dirs = dirs.contiguous()
    a_len = a_len.contiguous()
    b_len = b_len.contiguous()
    cap16 = path_words(steps16 * 16)
    out = torch.zeros((batch, 1 + cap16), dtype=torch.int32, device=dirs.device)
    if batch == 0:
        return out
    with torch.cuda.device(dirs.device):
        rc = _kernels.library().pm_wavefront_traceback(
            _ptr(dirs), _ptr(a_len), _ptr(b_len), steps16, batch, width,
            cap16, _ptr(out), _launch_stream(dirs.device),
        )
    if rc != 0:
        raise RuntimeError(f"traceback kernel launch failed: CUDA error {rc}")
    wavefront_traceback.launches += 1
    return out


wavefront_traceback.launches = 0


# --------------------------------------------------------------------------
# Host side
# --------------------------------------------------------------------------


def _runs_of_path_words(words: np.ndarray, n_moves: int):
    """Packed walk-order move codes -> (ref_runs, query_runs, n_columns)
    (copied from paramugsy_tpu.ops.pallas_extend)."""
    if n_moves == 0:
        return [], [], 0
    n_words = (n_moves + 15) >> 4
    shifts = 2 * np.arange(16, dtype=np.int32)
    codes = (words[:n_words, None] >> shifts[None, :]) & 3
    codes = codes.reshape(-1)[:n_moves][::-1]
    n = int(n_moves)
    change = np.flatnonzero(np.diff(codes)) + 1
    starts = np.concatenate(([0], change))
    ends = np.concatenate((change, [n]))
    ref_runs: list[Range] = []
    query_runs: list[Range] = []
    for s, e, c in zip(starts, ends, codes[starts]):
        if c == LEFT:
            ref_runs.append(Range(int(s) + 1, int(e)))
        elif c == UP:
            query_runs.append(Range(int(s) + 1, int(e)))
    return ref_runs, query_runs, n


def pack_pairs(pairs: list[tuple[np.ndarray, np.ndarray]], device: torch.device):
    """(a, b) int8 arrays -> padded [batch, L] int8 rows + int32 lengths
    on `device` (padding is never read)."""
    a_lens = np.fromiter((len(a) for a, _ in pairs), np.int32, len(pairs))
    b_lens = np.fromiter((len(b) for _, b in pairs), np.int32, len(pairs))
    A = np.zeros((len(pairs), max(1, int(a_lens.max(initial=0)))), np.int8)
    B = np.zeros((len(pairs), max(1, int(b_lens.max(initial=0)))), np.int8)
    for p, (a, b) in enumerate(pairs):
        A[p, : len(a)] = a
        B[p, : len(b)] = b
    return tuple(
        torch.from_numpy(x).to(device) for x in (A, B, a_lens, b_lens)
    )


def wavefront_align_many(
    segs: list[tuple[np.ndarray, np.ndarray]],
    *,
    device: torch.device,
    match: int = 2,
    mismatch: int = -3,
    gap: int = -4,
    batch: int = 64,
    chunk: int = 128,
    base_width: int = 512,
):
    """Align any number of segment pairs on `device`.

    Pairs are grouped as in the reference: by band width (doubling from
    `base_width` until the length difference fits: the width changes the
    banded optimum) and by power-of-two step bucket.  A launch takes up
    to `batch` real pairs and runs the steps its longest pair needs,
    rounded up to `chunk` (the reference padded batch and steps to bound
    XLA compiles; neither changes a pair's result).  Returns (ref_runs,
    query_runs, n_columns) per pair, in input order.
    """
    results: list = [None] * len(segs)
    groups: dict[tuple[int, int], list[int]] = {}
    for i, (a, b) in enumerate(segs):
        if len(a) + len(b) == 0:
            results[i] = ([], [], 0)
            continue
        width = base_width
        while abs(len(a) - len(b)) >= width // 2:
            width *= 2
        steps = -(-(len(a) + len(b)) // chunk) * chunk
        bucket = chunk
        while bucket < steps:
            bucket *= 2
        groups.setdefault((width, bucket), []).append(i)
    for (width, _), idxs in sorted(groups.items()):
        for lo in range(0, len(idxs), batch):
            part = idxs[lo : lo + batch]
            pairs = [segs[i] for i in part]
            steps = max(len(a) + len(b) for a, b in pairs)
            A, B, a_len, b_len = pack_pairs(pairs, device)
            dirs = wavefront_dp(
                A, B, a_len, b_len, steps=-(-steps // chunk) * chunk, width=width,
                match=match, mismatch=mismatch, gap=gap,
            )
            # Only the move buffer leaves the device.
            buf = wavefront_traceback(dirs, a_len, b_len, width=width).cpu().numpy()
            for p, i in enumerate(part):
                results[i] = _runs_of_path_words(buf[p, 1:], int(buf[p, 0]))
    return results
