// K3 + K4: row-banded global alignment, one pair or a batch of pairs.
//
// Replaces the Pallas kernels `_band_kernel` (one pair, launched by
// `banded_dp`, paramugsy_tpu/ops/pallas_extend.py:58) and
// `_band_kernel_batch` (eight pairs in the sublanes, launched by
// `banded_dp_batch`, :296).  Both compute the same recurrence, so one
// kernel serves both: one block per pair.  Row i (1-based) holds cells
// j = i + w - W/2 for lane w; diag comes from lane w of row i-1, up from
// lane w+1 of row i-1, and the in-row left dependency is closed by an
// inclusive prefix max over cand - gap*j:
//
//     dp[w] = gap*j(w) + max_{v <= w} (cand[v] - gap*j(v))
//
// The lane values, the j == 0 boundary column, NEG = -10^8, the int32
// arithmetic and the tie order (DIAG > UP > LEFT, written 0/1/2 as uint8
// into dirs[row][pair][w]) are the reference's, lane for lane, so whole
// buffers (rows past a_len included) are bit-identical.  The reference's
// rolled query window is replaced by direct reads: row i, lane w reads
// b[i + w - W/2 - 1] and a[i - 1], code 4 outside [0, b_len) and
// [0, a_len).  The wrapper hands the kernel copies of a and b padded with
// code 4 (`ops/banded.pad_geometry`), so no read needs a bounds check.
//
// What bounds it on the card.  The rows of one pair are strictly
// sequential, so one pair is one block on one SM.  A row is W cells of
// ~7 integer operations plus the scan that closes the left dependency:
// at W 512, 28 cycles of one SM's 128 integer lanes, against ~910 cycles
// a row that the first kernel (one lane per thread, 16 warps, two
// 512-thread barriers, two shuffle ladders, a global load per cell and a
// second pass that recomputed the first from shared memory) spent.  So
// the time is what one row's chain of dependent instructions costs: one
// warp per SM sub-partition, with little else to issue while it waits.
// The design keeps that chain short:
//  * scan units: each thread owns L contiguous lanes and keeps their scores
//    as P = dp - gap*j in registers, so diag is P[k] + (sub - gap), up is
//    P[k+1] + gap, and the new P is the closed scan value itself, with no
//    per-lane gap*j;
//  * pass 1 checks nothing.  Outside the cells it can skip NEG: lanes with
//    j > b_len feed only lanes with j > b_len, and lanes with j < 0 stay
//    within |gap|*W/2 + max(match, mismatch, gap) of NEG, below the j == 0
//    lane, whose up is exactly gap*i (its diag source is a NEG lane, so the
//    reference's max with gap*i is implied).  That holds while |gap|*(rows +
//    W) + |match| + |mismatch| < 10^8, which the launch checks.  Pass 2
//    gives the lanes outside 0 <= j <= b_len their NEG;
//  * below 256 lanes one warp holds the band (no barrier at all); from 256
//    up, four warps (one per SM sub-partition), and more warps only where L
//    would pass 32 (W 8192 ... 32768, 8 ... 32 warps);
//  * the up term of a thread's last lane is the next thread's first lane:
//    one __shfl_down_sync, sent as soon as that lane is done.  A warp's
//    last lane X reads the next warp's first P (`edge`, written the row
//    before) after the barrier, and adds its up term to its own scan
//    operand only then.  The warp's total, which later warps read, may
//    leave that term out: c(X+1) >= up(X+1) - gap*j(X+1) = dp(i-1, j(X)+1)
//    - gap*j(X), and row i-1's left closure gives dp(i-1, j(X)+1) >=
//    dp(i-1, j(X)) + gap, so c(X+1) >= up(X) - gap*j(X) wherever X + 1 is
//    a cell (where it is not, X holds back a NEG term or no cell follows);
//  * the left closure is two levels: each thread's running max over its
//    lanes, then the warp's exclusive scan (a shift and two ladder steps,
//    then seven windows at once: four rounds of shuffles, each a shuffle
//    and a max with no lane test), while the warp's total, taken first by
//    one __reduce_max_sync, crosses to the later warps through a shared
//    slot double-buffered by row parity: one barrier a row over the
//    block's (four, at W <= 4096) warps;
//  * each thread keeps the L + 15 bytes of b its lanes read in 16 rows,
//    and the 16 bytes of a, as register words loaded once per 16 rows
//    (the next block's prefetched where registers allow).  At some widths
//    up to L = 4 (the launch table's) the rows are unrolled four at a time,
//    so a lane's byte sits at a known place and the windows move by whole
//    words (and the row parity is known); elsewhere a thread takes a row
//    at a time and shifts by a byte;
//  * a code is two compares in scan units; the codes leave as one store
//    per thread per row: a byte, a 16-bit word, 32-bit words or 16-byte
//    vectors, coalesced across the warp.
// Measured against the first kernel in one call, and what was tried and
// dropped, in PERF.md (Findings).
// At W 32768 a thread's arrays (4 x 32 words) exceed the 64 registers that
// 1024 threads leave each, so that instance spills (build/nvcc.log).
#include <climits>
#include <cstdint>
#include <cstdlib>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -100000000;
constexpr uint32_t kDiag = 0, kUp = 1, kLeft = 2;
constexpr int kMinWidth = 32;
constexpr int kMaxWidth = 32768;
constexpr unsigned kFull = 0xffffffffu;
// b's copy starts W/2 + kFront bytes into its row, so that lane 0's first
// read (b[-W/2]) sits kFront bytes in.
constexpr int kFront = 16;

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// NEG stays below every real score (pass 1's premise, see the header).
inline bool within_neg_margin(int rows, int width, int match, int mismatch, int gap) {
  const long long margin = static_cast<long long>(std::abs(gap)) * (rows + width) +
                           std::abs(match) + std::abs(mismatch);
  return margin < -static_cast<long long>(kNeg);
}

// Register words of b a thread reads in one 16-row block: bytes [0, L + 15).
template <int L>
constexpr int kWindowWords = (L + 18) / 4;

// The raw words of the block starting after row i0 (a multiple of 16):
// b from byte i0 + w0 + kFront of the padded row (rounded down to a word;
// `align` shifts the rest out), a from byte i0.
template <int L>
__device__ __forceinline__ void load_block(const uint32_t* aw,
                                           const uint32_t* bw, int i0, int w0,
                                           uint32_t (&rb)[kWindowWords<L> + 1],
                                           uint32_t (&ra)[4]) {
  const uint32_t* pb = bw + ((i0 + w0 + kFront) >> 2);
#pragma unroll
  for (int q = 0; q <= kWindowWords<L>; ++q) rb[q] = pb[q];
#pragma unroll
  for (int q = 0; q < 4; ++q) ra[q] = aw[(i0 >> 2) + q];
}

// Shift a little-endian byte window right by `bits` (0, 8, 16 or 24).
template <int N, int M>
__device__ __forceinline__ void shift_window(const uint32_t (&in)[M],
                                             uint32_t (&out)[N], int bits) {
#pragma unroll
  for (int q = 0; q < N; ++q)
    out[q] = q + 1 < M ? __funnelshift_r(in[q], in[q + 1], bits) : in[q] >> bits;
}

// a: int8 [batch][a_stride], a's codes at [0, a_len), 4 after; b: int8
// [batch][b_stride], b's codes at [W/2 + kFront, ... + b_len), 4 elsewhere
// (the wrapper's copies).  One block of 32 * NW threads per pair, L lanes a
// thread, W = 32 * NW * L.  Scores are kept in scan units, P = dp - gap*j.
template <int L, int NW, int U, bool PREFETCH>
__global__ void __launch_bounds__(32 * NW) banded_kernel(
    const int8_t* __restrict__ a, const int8_t* __restrict__ b,
    const int32_t* __restrict__ b_len, int a_stride, int b_stride, int rows,
    int width, int batch, int match, int mismatch, int gap,
    uint8_t* __restrict__ dirs) {
  static_assert(U == 1 || U == 4, "a step is one row or four");
  constexpr int T = 32 * NW;
  constexpr int NB = kWindowWords<L>;
  constexpr int NC = (L + 3) / 4;  // code words a thread stores per row
  __shared__ int tot[2 * NW];   // [row parity][warp]: warp maxima of the scan
  __shared__ int edge[2 * NW];  // [row parity][warp]: first lane's P, row before
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int p = blockIdx.x;
  const int half = width >> 1;
  const int w0 = t * L;
  const uint32_t* aw =
      reinterpret_cast<const uint32_t*>(a + static_cast<size_t>(p) * a_stride);
  const uint32_t* bw =
      reinterpret_cast<const uint32_t*>(b + static_cast<size_t>(p) * b_stride);
  const unsigned lb = static_cast<unsigned>(b_len[p]);
  const int align = 8 * (w0 & 3);
  const bool band_end = t == T - 1;
  // The last lane of a warp (not the band's): its up term crosses warps.
  const bool deferred = NW > 1 && lane == 31 && !band_end;
  const int next_warp = min(warp + 1, NW - 1);
  const int sub_match = match - gap, sub_mismatch = mismatch - gap;
  uint8_t* drow = dirs + static_cast<size_t>(p) * width + w0;
  const size_t row_step = static_cast<size_t>(batch) * width;

  int P[L], cd[L], cu[L], pm[L];
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int j0 = w0 + k - half;
    P[k] = (j0 >= 0 && j0 <= static_cast<int>(lb)) ? 0 : kNeg - gap * j0;
  }
  // The next thread's first P (the last lane's up source) and, per warp,
  // the first lane's: row i's are sent as soon as row i-1's lane 0 is done.
  int nb = __shfl_down_sync(kFull, P[0], 1);
  if (NW > 1 && lane == 0) edge[NW + warp] = P[0];

  uint32_t rb[NB + 1], ra[4], nrb[NB + 1], nra[4];
  if constexpr (PREFETCH) load_block<L>(aw, bw, 0, w0, rb, ra);
  for (int i0 = 0; i0 < rows; i0 += 16) {
    if constexpr (PREFETCH) {
      load_block<L>(aw, bw, i0 + 16, w0, nrb, nra);
    } else {
      load_block<L>(aw, bw, i0, w0, rb, ra);
    }
    uint32_t win[NB], av[4];
    shift_window(rb, win, align);
#pragma unroll
    for (int q = 0; q < 4; ++q) av[q] = ra[q];

    // U rows per step, unrolled: row r of a step reads byte r (a) and
    // bytes r .. r + L - 1 (b) of the windows (with U = 4, the row parity
    // is known too), then the windows move on by U bytes.
#pragma unroll 1
    for (int su = 0; su < 16 && i0 + su < rows; su += U) {
#pragma unroll
      for (int r = 0; r < U; ++r) {
        if (i0 + su + r >= rows) break;
        const int i = i0 + su + r + 1;
        const int par = (U == 4 ? (r + 1) & 1 : i & 1) * NW;
        const uint32_t ca = (av[0] >> (8 * r)) & 0xff;
        const int jt = i + w0 - half;  // j of the thread's first lane

        // Pass 1, no checks (see the header): diag and up in scan units, the
        // scan operand and its running max.  The warp's last lane holds its
        // up term back (INT_MIN) until the barrier.
        const int cu_edge = band_end ? kNeg - gap * (jt + L - 1) : nb + gap;
        const int cu_last = deferred ? INT_MIN : cu_edge;
        int run = INT_MIN;
#pragma unroll
        for (int k = 0; k < L; ++k) {
          const uint32_t cb = (win[(k + r) >> 2] >> (8 * ((k + r) & 3))) & 0xff;
          cd[k] = P[k] + (cb == ca ? sub_match : sub_mismatch);
          cu[k] = k + 1 < L ? P[k + 1] + gap : cu_last;
          run = max(run, max(cd[k], cu[k]));
          pm[k] = run;
        }

        if constexpr (NW > 1) {
          // The warp's total goes out first, so the barrier overlaps the scan.
          const int total = __reduce_max_sync(kFull, run);
          if (lane == 31) tot[par + warp] = total;
        }
        // The warp's exclusive scan of the thread maxima: shifted up by one
        // lane, two ladder steps (Q = max of lanes t-4 .. t-1), then the
        // seven windows below at once (Q of t-4, t-8, ..., t-28).  A shuffle
        // from below lane 0 returns the lane's own value, which the max
        // already holds, so no step needs a lane test.
        int Q = __shfl_up_sync(kFull, run, 1);
        if (lane == 0) Q = INT_MIN;
        Q = max(Q, __shfl_up_sync(kFull, Q, 1));
        Q = max(Q, __shfl_up_sync(kFull, Q, 2));
        int below[8];
        below[0] = Q;
#pragma unroll
        for (int q = 1; q < 8; ++q) below[q] = __shfl_up_sync(kFull, Q, 4 * q);
        int before = max(max(max(below[0], below[1]), max(below[2], below[3])),
                         max(max(below[4], below[5]), max(below[6], below[7])));
        if constexpr (NW > 1) {
          __syncthreads();
          if constexpr (NW <= 4) {
#pragma unroll
            for (int q = 0; q + 1 < NW; ++q)
              before = max(before, q < warp ? tot[par + q] : INT_MIN);
          } else {
            int v = lane < warp ? tot[par + min(lane, NW - 1)] : INT_MIN;
#pragma unroll
            for (int d = 16; d > 0; d >>= 1) v = max(v, __shfl_xor_sync(kFull, v, d));
            before = max(before, v);
          }
          const int up_held = edge[par + next_warp] + gap;
          if (deferred) {
            cu[L - 1] = up_held;
            pm[L - 1] = max(pm[L - 1], up_held);
          }
        }

        // Pass 2: close the left dependency; lanes outside the cells (j < 0
        // or j > b_len) take NEG.  Codes compare in scan units (DIAG > UP >
        // LEFT).  Lane 0's P goes out first, for the next row.
        uint32_t code_words[NC];
#pragma unroll
        for (int q = 0; q < NC; ++q) code_words[q] = 0;
        const int neg_t = kNeg - gap * jt;
#pragma unroll
        for (int k = 0; k < L; ++k) {
          const bool cell = static_cast<unsigned>(jt + k) <= lb;  // 0 <= j <= b_len
          const int x = cell ? max(before, pm[k]) : neg_t - gap * k;
          code_words[k >> 2] |= (x == cd[k] ? kDiag : (x == cu[k] ? kUp : kLeft)) << (8 * (k & 3));
          P[k] = x;
          if (k == 0) {
            nb = __shfl_down_sync(kFull, x, 1);
            if (NW > 1 && lane == 0) edge[(NW - par) + warp] = x;
          }
        }

        if constexpr (L == 1) {
          *drow = static_cast<uint8_t>(code_words[0]);
        } else if constexpr (L == 2) {
          *reinterpret_cast<uint16_t*>(drow) = static_cast<uint16_t>(code_words[0]);
        } else if constexpr (L < 16) {
#pragma unroll
          for (int q = 0; q < NC; ++q) reinterpret_cast<uint32_t*>(drow)[q] = code_words[q];
        } else {
#pragma unroll
          for (int q = 0; q < NC; q += 4)
            reinterpret_cast<uint4*>(drow)[q / 4] = make_uint4(
                code_words[q], code_words[q + 1], code_words[q + 2], code_words[q + 3]);
        }
        drow += row_step;
      }
      if constexpr (U == 4) {
#pragma unroll
        for (int q = 0; q + 1 < NB; ++q) win[q] = win[q + 1];
#pragma unroll
        for (int q = 0; q < 3; ++q) av[q] = av[q + 1];
      } else {
        shift_window(win, win, 8);
        shift_window(av, av, 8);
      }
    }
    if constexpr (PREFETCH) {
#pragma unroll
      for (int q = 0; q <= NB; ++q) rb[q] = nrb[q];
#pragma unroll
      for (int q = 0; q < 4; ++q) ra[q] = nra[q];
    }
  }
}

template <int L, int NW, int U, bool PREFETCH>
cudaError_t launch(const int8_t* a, const int8_t* b, const int32_t* b_len,
                   int a_stride, int b_stride, int rows, int width, int batch,
                   int match, int mismatch, int gap, uint8_t* dirs,
                   cudaStream_t stream) {
  if (32 * NW * L != width) return cudaErrorInvalidConfiguration;
  banded_kernel<L, NW, U, PREFETCH><<<batch, 32 * NW, 0, stream>>>(
      a, b, b_len, a_stride, b_stride, rows, width, batch, match, mismatch,
      gap, dirs);
  return cudaGetLastError();
}

}  // namespace

// a: int8 [batch, a_stride], a's codes at [0, a_len) and code 4 after;
// b: int8 [batch, b_stride], b's codes at [W/2 + 16, W/2 + 16 + b_len) and
// code 4 elsewhere (`ops/banded.pad_geometry`: a_stride >= round16(rows) +
// 16, b_stride >= round16(rows) + W + 48, both multiples of 16, rows
// 4-byte aligned); a_len is not read (a's pad marks its end); b_len: int32
// [batch]; dirs: uint8 [rows, batch, width].  width is a power of two in
// [32, 32768]; rows >= 1.  Returns a cudaError_t.
extern "C" int pm_banded_dp(const void* a, const void* b, const void* a_len,
                            const void* b_len, int a_stride, int b_stride,
                            int rows, int width, int batch, int match,
                            int mismatch, int gap, void* dirs, void* stream) {
  (void)a_len;
  if (width < kMinWidth || width > kMaxWidth || (width & (width - 1)) ||
      rows <= 0 || batch <= 0 || a_stride % 16 || b_stride % 16 ||
      a_stride < round16(rows) + 16 || b_stride < round16(rows) + width + 48 ||
      (reinterpret_cast<uintptr_t>(a) & 3) || (reinterpret_cast<uintptr_t>(b) & 3) ||
      !within_neg_margin(rows, width, match, mismatch, gap))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto pa = static_cast<const int8_t*>(a);
  auto pb = static_cast<const int8_t*>(b);
  auto plb = static_cast<const int32_t*>(b_len);
  auto pd = static_cast<uint8_t*>(dirs);
#define PM_BANDED_LAUNCH(L, NW, U, PF)                                          \
  return launch<L, NW, U, PF>(pa, pb, plb, a_stride, b_stride, rows, width,   \
                              batch, match, mismatch, gap, pd, s)
  // (lanes per thread, warps, rows unrolled per step, prefetch): one warp
  // below 256 lanes, four warps up to L = 32, then more warps; rows a step
  // as measured faster at each width up to L = 4 (no rule: W 32, 128 and
  // 256 take four, W 64 and 512 one), one from L = 8; no prefetch where
  // the threads leave 128 registers or fewer each.  PERF.md (Findings,
  // K3/K4) lists the readings behind each choice.
  switch (width) {
    case 32: PM_BANDED_LAUNCH(1, 1, 4, true);
    case 64: PM_BANDED_LAUNCH(2, 1, 1, true);
    case 128: PM_BANDED_LAUNCH(4, 1, 4, true);
    case 256: PM_BANDED_LAUNCH(2, 4, 4, true);
    case 512: PM_BANDED_LAUNCH(4, 4, 1, true);
    case 1024: PM_BANDED_LAUNCH(8, 4, 1, true);
    case 2048: PM_BANDED_LAUNCH(16, 4, 1, true);
    case 4096: PM_BANDED_LAUNCH(32, 4, 1, true);
    case 8192: PM_BANDED_LAUNCH(32, 8, 1, true);
    case 16384: PM_BANDED_LAUNCH(32, 16, 1, false);
    case 32768: PM_BANDED_LAUNCH(32, 32, 1, false);
    default: return cudaErrorInvalidValue;
  }
#undef PM_BANDED_LAUNCH
}
