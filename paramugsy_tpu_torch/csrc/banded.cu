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
// [0, a_len).
//
// What bounds it on the card: the rows of one pair are strictly
// sequential, and each row costs two block-wide barriers plus the scan's
// log2(32) warp-shuffle steps twice (within and across warps); per cell
// there are a handful of integer ops, one L1-cached sequence byte and one
// coalesced output byte.  Latency per row, not bandwidth or ALU
// throughput, sets the time, as for K1.  The design keeps the row short:
// each thread owns L = W / min(W, 1024) contiguous lanes (a thread-local
// running max first, so the block scan has one value per thread), the
// previous dp row sits in shared memory in a lane-interleaved layout
// (slot k * T + t holds thread t's k-th lane, so reads and writes are
// free of bank conflicts), a row's match bits stay in one register
// between the scan's two passes, and the codes leave as 32-bit words once
// L >= 4.  The shared row bounds the band: W = 32768 (128 KiB) is the
// widest power of two that fits the 227 KiB a block may use.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -100000000;
constexpr int kDiag = 0, kUp = 1, kLeft = 2;
constexpr int kPad = 4;
constexpr int kMinWidth = 32;
constexpr int kMaxWidth = 32768;
constexpr unsigned kFull = 0xffffffffu;

// One cell's candidate before the left closure, and its diag/up terms.
struct Cell {
  int diag, up, cand;
  bool valid;
};

__device__ __forceinline__ Cell cell(int p_here, int p_next, bool is_match,
                                     int i, int j, int w, int width, int lb,
                                     int match, int mismatch, int gap) {
  Cell c;
  c.diag = p_here + (is_match ? match : mismatch);
  c.up = (w < width - 1) ? p_next + gap : kNeg;
  c.valid = j >= 1 && j <= lb;
  int cand = max(c.diag, c.up);
  if (j == 0) cand = max(cand, gap * i);  // dp[i][0] seeds the left chain
  c.cand = (c.valid || j == 0) ? cand : kNeg;
  return c;
}

template <int L>
__global__ void __launch_bounds__(1024) banded_kernel(
    const int8_t* __restrict__ a, const int8_t* __restrict__ b,
    const int32_t* __restrict__ a_len, const int32_t* __restrict__ b_len,
    int a_stride, int b_stride, int rows, int width, int batch, int match,
    int mismatch, int gap, uint8_t* __restrict__ dirs) {
  extern __shared__ int smem[];
  int* prev = smem;          // [L][T]: lane t*L + k at slot k*T + t
  int* wtot = smem + width;  // [32]: warp maxima of the row's scan
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int p = blockIdx.x;
  const int half = width >> 1;
  const int8_t* ap = a + static_cast<size_t>(p) * a_stride;
  const int8_t* bp = b + static_cast<size_t>(p) * b_stride;
  const int la = a_len[p];
  const int lb = b_len[p];
  const int w0 = t * L;

#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int j0 = w0 + k - half;
    prev[k * T + t] = (j0 >= 0 && j0 <= lb) ? gap * j0 : kNeg;
  }
  __syncthreads();

  for (int i = 1; i <= rows; ++i) {
    const int ca = (i - 1 < la) ? ap[i - 1] : kPad;
    // Pass 1: the thread's running max and the row's match bits.  The
    // next thread's first lane (its up source) is read now, before any
    // thread overwrites its slots.
    const int nb = (t + 1 < T) ? prev[t + 1] : kNeg;
    uint32_t match_bits = 0;
    int run = INT_MIN;
    int p_here = prev[t];
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int w = w0 + k;
      const int j = i + w - half;
      const int ib = j - 1;
      const int cb = (ib >= 0 && ib < lb) ? bp[ib] : kPad;
      const bool is_match = cb == ca;
      match_bits |= static_cast<uint32_t>(is_match) << k;
      const int p_next = (k + 1 < L) ? prev[(k + 1) * T + t] : nb;
      const Cell c = cell(p_here, p_next, is_match, i, j, w, width, lb, match,
                          mismatch, gap);
      run = max(run, c.cand - gap * j);
      p_here = p_next;
    }
    // Block-wide exclusive prefix max of the thread maxima.
    int incl = run;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, s);
      if (lane >= s) incl = max(incl, o);
    }
    if (lane == 31) wtot[warp] = incl;
    int prefix = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) prefix = INT_MIN;
    __syncthreads();
    int before = (lane < warp) ? wtot[lane] : INT_MIN;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      before = max(before, __shfl_xor_sync(kFull, before, s));
    run = max(prefix, before);

    // Pass 2: close the left dependency, write codes and the new row in
    // place (each thread rewrites only its own slots).
    uint8_t* drow = dirs + (static_cast<size_t>(i - 1) * batch + p) * width + w0;
    uint32_t word = 0;
    p_here = prev[t];
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int w = w0 + k;
      const int j = i + w - half;
      const int p_next = (k + 1 < L) ? prev[(k + 1) * T + t] : nb;
      const Cell c = cell(p_here, p_next, (match_bits >> k) & 1u, i, j, w,
                          width, lb, match, mismatch, gap);
      run = max(run, c.cand - gap * j);
      const int dp = c.valid ? run + gap * j : (j == 0 ? gap * i : kNeg);
      const uint32_t code = dp == c.diag ? kDiag : (dp == c.up ? kUp : kLeft);
      prev[k * T + t] = dp;
      p_here = p_next;
      if (L >= 4) {
        word |= code << (8 * (k & 3));
        if ((k & 3) == 3) {
          reinterpret_cast<uint32_t*>(drow)[k >> 2] = word;
          word = 0;
        }
      } else {
        drow[k] = static_cast<uint8_t>(code);
      }
    }
    __syncthreads();
  }
}

template <int L>
cudaError_t launch(const int8_t* a, const int8_t* b, const int32_t* a_len,
                   const int32_t* b_len, int a_stride, int b_stride, int rows,
                   int width, int batch, int match, int mismatch, int gap,
                   uint8_t* dirs, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(width) + 32) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        banded_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  banded_kernel<L><<<batch, width / L, smem, stream>>>(
      a, b, a_len, b_len, a_stride, b_stride, rows, width, batch, match,
      mismatch, gap, dirs);
  return cudaGetLastError();
}

}  // namespace

// a: int8 [batch, a_stride]; b: int8 [batch, b_stride]; a_len, b_len:
// int32 [batch]; dirs: uint8 [rows, batch, width].  width is a power of
// two in [32, 32768]; rows >= 1.  Returns a cudaError_t.
extern "C" int pm_banded_dp(const void* a, const void* b, const void* a_len,
                            const void* b_len, int a_stride, int b_stride,
                            int rows, int width, int batch, int match,
                            int mismatch, int gap, void* dirs, void* stream) {
  if (width < kMinWidth || width > kMaxWidth || (width & (width - 1)) ||
      rows <= 0 || batch <= 0)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto pa = static_cast<const int8_t*>(a);
  auto pb = static_cast<const int8_t*>(b);
  auto pla = static_cast<const int32_t*>(a_len);
  auto plb = static_cast<const int32_t*>(b_len);
  auto pd = static_cast<uint8_t*>(dirs);
#define PM_BANDED_LAUNCH(L)                                                  \
  return launch<L>(pa, pb, pla, plb, a_stride, b_stride, rows, width, batch, \
                   match, mismatch, gap, pd, s)
  switch (width > 1024 ? width / 1024 : 1) {
    case 1:
      PM_BANDED_LAUNCH(1);
    case 2:
      PM_BANDED_LAUNCH(2);
    case 4:
      PM_BANDED_LAUNCH(4);
    case 8:
      PM_BANDED_LAUNCH(8);
    case 16:
      PM_BANDED_LAUNCH(16);
    default:
      PM_BANDED_LAUNCH(32);
  }
#undef PM_BANDED_LAUNCH
}
