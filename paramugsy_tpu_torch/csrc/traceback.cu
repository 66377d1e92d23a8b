// K2: traceback of the packed anti-diagonal direction codes of K1.
//
// Replaces the Pallas kernel `_traceback_kernel` launched by
// `wavefront_dp_device_tb` in paramugsy_tpu/ops/pallas_extend.py.  Per
// pair it walks from (a_len, b_len) to (0, 0) and emits 2-bit moves in
// walk order, 16 per int32 word, into a zeroed [batch, 1 + cap16] buffer
// whose column 0 receives the number of moves (-1 when a length is
// negative or i + j > 16 * steps16).  The band-edge rules are the
// reference's: inside the rectangle, lane w >= W-1 forces LEFT and then
// w <= 0 forces UP; once i or j reaches 0 the rest is LEFT x j or UP x i
// without reading the codes.
//
// What bounds it on the card: the walk is one chain of dependent reads
// (where to read next follows from what was read), so its time is the
// number of round trips to L2 or device memory, not bytes: the moves a
// run reads are a few kilobytes.  Refinement walks one pair per launch,
// ~15 k moves, of which ~0.03% are indels; one load per move (the first
// design of this kernel) made that ~15 k round trips.
//
// The design: one warp per pair, all 32 lanes holding the same walk
// state, so that every branch is warp-uniform.  A DIAG move keeps lane w
// and lowers the step s = i + j - 1 by 2, so a DIAG run reads the
// parity-(s & 1) codes of one lane, row after row; DIAG is code 0 and the
// buffer is zeroed, so a DIAG run writes nothing.
//  * Within a word: one mask of the parity's codes at or below s and one
//    __clz find the next non-DIAG code: up to 8 moves per word.
//  * Across rows: lane t loads word row r - 1 - t - 32u of lane w for
//    u < kGroups, 32 * kGroups independent loads in one round trip (only
//    rows the walk can reach before min(i, j) runs out);
//    __ballot_sync on "a non-DIAG code of this parity", then __ffs, finds
//    the first such row: up to 8 * 32 * kGroups moves per round trip.
//    This is the reference's all-DIAG bitmap, computed on the fly.
//  * Events (UP, LEFT: w moves by 1 and the parity flips) read from a
//    tile of two word rows x 32 lanes around w, loaded coalesced in one
//    round trip and read by __shfl_sync; a gap run stays inside it for up
//    to ~16 moves.
//  * A DIAG run is clipped at min(i, j); band-edge moves read nothing.
// Writes: only words that hold an event (and the tail's LEFT x j or UP x
// i, whose whole words the lanes store together), plus column 0.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kUp = 1, kLeft = 2;  // DIAG is 0
constexpr unsigned kFull = 0xffffffffu;
// The codes of even and of odd steps in a word (step s in slot s & 15).
constexpr uint32_t kEven = 0x33333333u, kOdd = 0xccccccccu;
// Word rows per lane in one jump round trip.
constexpr int kGroups = 4;

__device__ __forceinline__ uint32_t load(const int32_t* p) {
  return static_cast<uint32_t>(__ldg(p));
}

// The pair's output row and its pending word: the last word an event
// touched, written once the walk has left it.
struct Path {
  int32_t* row;
  int pw = -1;
  uint32_t pend = 0;

  // n >= 1 moves of `code` (UP or LEFT) at walk positions m .. m + n - 1.
  __device__ void emit(int m, int n, uint32_t code, int lane) {
    const uint32_t pattern = code * 0x55555555u;
    const int f = m >> 4, l = (m + n - 1) >> 4;
    if (f != pw) {
      if (pw >= 0 && lane == 0) row[1 + pw] = static_cast<int32_t>(pend);
      pw = f;
      pend = 0;
    }
    const uint32_t from_m = pattern << (2 * (m & 15));
    const uint32_t to_end = (4u << (2 * ((m + n - 1) & 15))) - 1u;  // wraps at slot 15
    if (f == l) {
      pend |= from_m & to_end;
      return;
    }
    if (lane == 0) row[1 + f] = static_cast<int32_t>(pend | from_m);
    for (int x = f + 1 + lane; x < l; x += 32) row[1 + x] = static_cast<int32_t>(pattern);
    pw = l;
    pend = pattern & to_end;
  }
};

__global__ void __launch_bounds__(32)
traceback_kernel(const int32_t* __restrict__ dirs,
                 const int32_t* __restrict__ a_len,
                 const int32_t* __restrict__ b_len, int steps16, int batch,
                 int width, int cap16, int32_t* __restrict__ out) {
  const int p = blockIdx.x;
  const int lane = threadIdx.x;
  Path path{out + static_cast<size_t>(p) * (1 + cap16)};
  int i = a_len[p];
  int j = b_len[p];
  if (i < 0 || j < 0 || i + j > 16 * steps16) {
    if (lane == 0) path.row[0] = -1;
    return;
  }
  const int half = width >> 1;
  const size_t stride = static_cast<size_t>(batch) * width;  // one word row
  const int32_t* col = dirs + static_cast<size_t>(p) * width;
  // The tile: word rows tr (top) and tr - 1 (low) at lanes t0 + lane;
  // none yet (the walk's row only falls).
  int tr = -1, t0 = 0;
  uint32_t top = 0, low = 0;
  int m = 0;
  while (i > 0 && j > 0) {
    const int w = j - i + half;
    if (w <= 0 || w >= width - 1) {
      const uint32_t code = w <= 0 ? kUp : kLeft;
      path.emit(m++, 1, code, lane);
      if (code == kUp) --i; else --j;
      continue;
    }
    const int s = i + j - 1, r = s >> 4, k = s & 15;
    if (r > tr || r < tr - 1 || w < t0 || w >= t0 + 32) {
      tr = r;
      t0 = max(min(w - 16, width - 32), 0);
      const int c = t0 + lane;
      top = c < width ? load(col + r * stride + c) : 0u;
      low = c < width && r > 0 ? load(col + (r - 1) * stride + c) : 0u;
    }
    const uint32_t par = s & 1 ? kOdd : kEven;
    const int lim = min(i, j);
    uint32_t ev = __shfl_sync(kFull, r == tr ? top : low, w - t0);
    uint32_t x = ev & par & ((4u << (2 * k)) - 1u);  // this parity, slots <= k
    int run;  // DIAG moves before the event in `ev`
    if (x != 0) {
      run = (k - ((31 - __clz(x)) >> 1)) >> 1;
    } else {
      run = (k >> 1) + 1;  // the rest of row r; then rows from r - 1 down
      int next = r - 1;
      if (r == tr && run < lim) {  // row r - 1 is the tile's low row
        ev = __shfl_sync(kFull, low, w - t0);
        x = ev & par;
        if (x == 0) {
          run += 8;
          --next;
        }
      }
      while (x == 0 && run < lim) {
        uint32_t v[kGroups];
#pragma unroll
        for (int u = 0; u < kGroups; ++u) {
          // Rows the walk reaches within lim moves lie at or above step 1.
          const bool need = run + 8 * (lane + 32 * u) < lim;
          v[u] = need ? load(col + (next - lane - 32 * u) * stride + w) : 0u;
        }
#pragma unroll
        for (int u = 0; u < kGroups; ++u) {
          const unsigned hit = __ballot_sync(kFull, (v[u] & par) != 0);
          if (x == 0 && hit != 0) {
            const int t = __ffs(hit) - 1;
            ev = __shfl_sync(kFull, v[u], t);
            x = ev & par;
            run += 8 * (t + 32 * u);
          }
        }
        if (x == 0) {
          run += 8 * 32 * kGroups;
          next -= 32 * kGroups;
        }
      }
      // The event row is entered at slot 14 + parity.
      if (x != 0) run += (14 + (s & 1) - ((31 - __clz(x)) >> 1)) >> 1;
    }
    if (run >= lim) {  // i or j reaches 0 first: lim DIAG moves
      m += lim;
      i -= lim;
      j -= lim;
      break;
    }
    m += run;
    i -= run;
    j -= run;
    const uint32_t code = (ev >> (2 * ((31 - __clz(x)) >> 1))) & 3u;
    path.emit(m++, 1, code, lane);
    if (code == kUp) --i; else --j;
  }
  if (i > 0) path.emit(m, i, kUp, lane);
  if (j > 0) path.emit(m, j, kLeft, lane);
  m += i + j;
  if (lane == 0) {
    if (path.pw >= 0) path.row[1 + path.pw] = static_cast<int32_t>(path.pend);
    path.row[0] = m;
  }
}

}  // namespace

// dirs: int32 [steps16, batch, width] from pm_wavefront_dp; a_len, b_len:
// int32 [batch]; out: int32 [batch, 1 + cap16], zeroed by the caller.
// One 32-thread block (one warp) per pair.  Returns a cudaError_t.
extern "C" int pm_wavefront_traceback(const void* dirs, const void* a_len,
                                      const void* b_len, int steps16,
                                      int batch, int width, int cap16,
                                      void* out, void* stream) {
  if (batch <= 0 || cap16 < steps16 + 1) return cudaErrorInvalidValue;
  traceback_kernel<<<batch, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(dirs), static_cast<const int32_t*>(a_len),
      static_cast<const int32_t*>(b_len), steps16, batch, width, cap16,
      static_cast<int32_t*>(out));
  return cudaGetLastError();
}
