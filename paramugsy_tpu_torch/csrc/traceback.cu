// K2: traceback of the packed anti-diagonal direction codes of K1.
//
// Replaces the Pallas kernel `_traceback_kernel` launched by
// `wavefront_dp_device_tb` in paramugsy_tpu/ops/pallas_extend.py.  Per
// pair it walks from (a_len, b_len) to (0, 0) and emits 2-bit moves in
// walk order, 16 per int32 word, into a zeroed [batch, 1 + cap16] buffer
// whose column 0 receives the number of moves.  The band-edge rules are
// the reference's: inside the rectangle, lane w >= W-1 forces LEFT and
// then w <= 0 forces UP; once i or j reaches 0 the rest is LEFT x j or
// UP x i without reading the codes.
//
// What bounds it on the card: the walk of one pair is a chain of
// dependent loads (each move's address follows from the previous move),
// so its time is the load latency times the number of moves; a launch
// holds one pair per thread and has far fewer threads than the card can
// run.  The design stays simple: one thread per pair, reading the codes
// straight from device memory through L1/L2.  The TPU kernel's SMEM
// windows, all-DIAG bitmaps and its 2^16-step cap existed for the TPU's
// scalar core and SMEM and are dropped; a pair whose lengths do not fit
// the buffer gets n_moves = -1 instead of an out-of-bounds read.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kUp = 1, kLeft = 2;  // DIAG is 0

__global__ void traceback_kernel(const int32_t* __restrict__ dirs,
                                 const int32_t* __restrict__ a_len,
                                 const int32_t* __restrict__ b_len,
                                 int steps16, int batch, int width,
                                 int cap16, int32_t* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= batch) return;
  int32_t* row = out + static_cast<size_t>(p) * (1 + cap16);
  int i = a_len[p];
  int j = b_len[p];
  if (i < 0 || j < 0 || i + j > 16 * steps16) {
    row[0] = -1;
    return;
  }
  const int half = width >> 1;
  int m = 0;
  uint32_t word = 0;
  while (i > 0 || j > 0) {
    uint32_t code;
    if (i == 0) {
      code = kLeft;
    } else if (j == 0) {
      code = kUp;
    } else {
      const int w = j - i + half;
      if (w <= 0) {
        code = kUp;
      } else if (w >= width - 1) {
        code = kLeft;
      } else {
        const int s = i + j - 1;
        const uint32_t dword = static_cast<uint32_t>(
            dirs[(static_cast<size_t>(s >> 4) * batch + p) * width + w]);
        code = (dword >> (2 * (s & 15))) & 3u;
      }
    }
    word |= code << (2 * (m & 15));
    if ((m & 15) == 15) {
      row[1 + (m >> 4)] = static_cast<int32_t>(word);
      word = 0;
    }
    if (code != kLeft) --i;  // DIAG and UP consume a
    if (code != kUp) --j;    // DIAG and LEFT consume b
    ++m;
  }
  if (m & 15) row[1 + (m >> 4)] = static_cast<int32_t>(word);
  row[0] = m;
}

}  // namespace

// dirs: int32 [steps16, batch, width] from pm_wavefront_dp; a_len, b_len:
// int32 [batch]; out: int32 [batch, 1 + cap16], zeroed by the caller.
// Returns a cudaError_t.
extern "C" int pm_wavefront_traceback(const void* dirs, const void* a_len,
                                      const void* b_len, int steps16,
                                      int batch, int width, int cap16,
                                      void* out, void* stream) {
  if (batch <= 0 || cap16 < steps16 + 1) return cudaErrorInvalidValue;
  constexpr int kThreads = 64;
  traceback_kernel<<<(batch + kThreads - 1) / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(dirs), static_cast<const int32_t*>(a_len),
      static_cast<const int32_t*>(b_len), steps16, batch, width, cap16,
      static_cast<int32_t*>(out));
  return cudaGetLastError();
}
