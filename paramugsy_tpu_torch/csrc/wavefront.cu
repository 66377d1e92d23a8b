// K1: banded global alignment over anti-diagonals, for a batch of pairs.
//
// Replaces the Pallas kernel `_wavefront_kernel` launched by
// `wavefront_dp` in paramugsy_tpu/ops/pallas_extend.py.  The recurrence,
// tie order and output layout are the reference's: cell (i, j) sits at
// step d = i + j, lane w = j - i + W/2; diag comes from step d-2 in the
// same lane, up from step d-1 lane w+1, left from step d-1 lane w-1; ties
// go DIAG > UP > LEFT; step d's 2-bit code lands in bits 2*((d-1) % 16)
// of dirs[(d-1) / 16][pair][w].  Nothing is masked: every lane computes
// exactly what the reference computes, so whole buffers are bit-identical.
//
// What bounds it on the card: the anti-diagonals of one pair are strictly
// sequential, so each step costs one block-wide barrier plus a shared-
// memory round trip; the arithmetic per cell is a handful of integer ops,
// and device memory sees one coalesced int32 store per lane per 16 steps
// plus L1-cached sequence bytes.  Latency per step, not bandwidth or ALU
// throughput, sets the time.  The design keeps that step short: one block
// per pair (the batch fills the SMs), each thread owns LPT lanes and keeps
// its two previous scores and its code word in registers, and only the
// previous row travels through shared memory (double-buffered, so one
// __syncthreads per step suffices).  The reference's rolled character
// windows are replaced by direct reads of the int8 sequences:
// a[floor((d - w + W/2) / 2) - 1] and b[floor((d + w - W/2) / 2) - 1],
// pad 4 (a) and 5 (b) outside the sequence.
//
// Two shared-memory rows fit up to W = 16384 (16 lanes per thread of a
// 1024-thread block).  The band doubles without bound, so wider bands take
// a second kernel that keeps both rows in a device scratch buffer (row d-2
// is overwritten in place by row d, lane by lane, by the thread that owns
// the lane) and accumulates the code words in dirs itself.  Each step then
// costs global-memory round trips, mostly L2 hits; such bands are rare
// (a length difference of 8192 bp or more inside one segment).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -100000000;
constexpr int kDiag = 0, kUp = 1, kLeft = 2;
constexpr int kPadA = 4, kPadB = 5;
// Widest band whose two rows fit shared memory (2 x 64 KiB).
constexpr int kMaxSmemWidth = 16384;

// floor(x / 2) for negative x as well (arithmetic shift).
__device__ __forceinline__ int floor_half(int x) { return x >> 1; }

// Blocks of up to 1024 threads: the bound caps registers at 64 per thread,
// so a full block fits the SM's register file for every LPT.
template <int LPT>
__global__ void __launch_bounds__(1024) wavefront_kernel(const int8_t* __restrict__ a,
                                 const int8_t* __restrict__ b,
                                 const int32_t* __restrict__ a_len,
                                 const int32_t* __restrict__ b_len,
                                 int a_stride, int b_stride, int steps,
                                 int width, int batch, int match,
                                 int mismatch, int gap,
                                 int32_t* __restrict__ dirs) {
  extern __shared__ int rows[];  // [2][width]: rows d-1 and d, alternating
  const int p = blockIdx.x;
  const int half = width >> 1;
  const int8_t* ap = a + static_cast<size_t>(p) * a_stride;
  const int8_t* bp = b + static_cast<size_t>(p) * b_stride;
  const int la = a_len[p];
  const int lb = b_len[p];

  int prev1[LPT], prev2[LPT];
  uint32_t acc[LPT];
#pragma unroll
  for (int l = 0; l < LPT; ++l) {
    const int w = threadIdx.x + l * blockDim.x;
    prev1[l] = (w == half) ? 0 : kNeg;  // step 0: only cell (0, 0)
    prev2[l] = kNeg;
    acc[l] = 0;
    rows[w] = prev1[l];
  }
  __syncthreads();

  for (int d = 1; d <= steps; ++d) {
    const int* r1 = rows + ((d - 1) & 1) * width;
    int* r0 = rows + (d & 1) * width;
    const int slot = (d - 1) & 15;
#pragma unroll
    for (int l = 0; l < LPT; ++l) {
      const int w = threadIdx.x + l * blockDim.x;
      const int ia = floor_half(d - w + half) - 1;
      const int ib = floor_half(d + w - half) - 1;
      const int ca = (ia >= 0 && ia < la) ? ap[ia] : kPadA;
      const int cb = (ib >= 0 && ib < lb) ? bp[ib] : kPadB;
      const int diag = prev2[l] + (ca == cb ? match : mismatch);
      const int up = (w < width - 1) ? r1[w + 1] + gap : kNeg;
      const int left = (w > 0) ? r1[w - 1] + gap : kNeg;
      const int dp = max(max(diag, up), left);
      const uint32_t code = dp == diag ? kDiag : (dp == up ? kUp : kLeft);
      acc[l] |= code << (2 * slot);
      r0[w] = dp;
      prev2[l] = prev1[l];
      prev1[l] = dp;
      if (slot == 15) {
        dirs[(static_cast<size_t>((d - 1) >> 4) * batch + p) * width + w] =
            static_cast<int32_t>(acc[l]);
        acc[l] = 0;
      }
    }
    __syncthreads();
  }
}

template <int LPT>
cudaError_t launch(const int8_t* a, const int8_t* b, const int32_t* a_len,
                   const int32_t* b_len, int a_stride, int b_stride,
                   int steps, int width, int batch, int match, int mismatch,
                   int gap, int32_t* dirs, cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(width) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        wavefront_kernel<LPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  wavefront_kernel<LPT><<<batch, width / LPT, smem, stream>>>(
      a, b, a_len, b_len, a_stride, b_stride, steps, width, batch, match,
      mismatch, gap, dirs);
  return cudaGetLastError();
}

// Bands wider than kMaxSmemWidth.  rows: [batch][2][width] scratch; row d
// lives at rows[(d & 1) * width]: before lane w is overwritten it still
// holds row d-2, the lane's diag source.
__global__ void __launch_bounds__(1024) wavefront_kernel_wide(
    const int8_t* __restrict__ a, const int8_t* __restrict__ b,
    const int32_t* __restrict__ a_len, const int32_t* __restrict__ b_len,
    int a_stride, int b_stride, int steps, int width, int batch, int match,
    int mismatch, int gap, int* scratch, int32_t* __restrict__ dirs) {
  const int p = blockIdx.x;
  const int half = width >> 1;
  const int8_t* ap = a + static_cast<size_t>(p) * a_stride;
  const int8_t* bp = b + static_cast<size_t>(p) * b_stride;
  const int la = a_len[p];
  const int lb = b_len[p];
  int* rows = scratch + static_cast<size_t>(p) * 2 * width;
  for (int w = threadIdx.x; w < width; w += blockDim.x) {
    rows[w] = (w == half) ? 0 : kNeg;  // step 0: only cell (0, 0)
    rows[width + w] = kNeg;            // step -1
  }
  __syncthreads();

  for (int d = 1; d <= steps; ++d) {
    const int* r1 = rows + ((d - 1) & 1) * width;
    int* r0 = rows + (d & 1) * width;
    const int slot = (d - 1) & 15;
    int32_t* drow = dirs + (static_cast<size_t>((d - 1) >> 4) * batch + p) * width;
    for (int w = threadIdx.x; w < width; w += blockDim.x) {
      const int ia = floor_half(d - w + half) - 1;
      const int ib = floor_half(d + w - half) - 1;
      const int ca = (ia >= 0 && ia < la) ? ap[ia] : kPadA;
      const int cb = (ib >= 0 && ib < lb) ? bp[ib] : kPadB;
      const int diag = r0[w] + (ca == cb ? match : mismatch);
      const int up = (w < width - 1) ? r1[w + 1] + gap : kNeg;
      const int left = (w > 0) ? r1[w - 1] + gap : kNeg;
      const int dp = max(max(diag, up), left);
      const uint32_t code = dp == diag ? kDiag : (dp == up ? kUp : kLeft);
      const uint32_t prev = slot ? static_cast<uint32_t>(drow[w]) : 0u;
      drow[w] = static_cast<int32_t>(prev | (code << (2 * slot)));
      r0[w] = dp;
    }
    __syncthreads();
  }
}

}  // namespace

// a: int8 [batch, a_stride]; b: int8 [batch, b_stride]; a_len, b_len:
// int32 [batch]; dirs: int32 [steps/16, batch, width]; scratch: int32
// [batch, 2, width] when width > 16384, else unused.  width is a power of
// two >= 32; steps a multiple of 16.  Returns a cudaError_t.
extern "C" int pm_wavefront_dp(const void* a, const void* b,
                               const void* a_len, const void* b_len,
                               int a_stride, int b_stride, int steps,
                               int width, int batch, int match, int mismatch,
                               int gap, void* dirs, void* scratch,
                               void* stream) {
  if (width < 32 || (width & (width - 1)) || steps % 16 || batch <= 0)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto pa = static_cast<const int8_t*>(a);
  auto pb = static_cast<const int8_t*>(b);
  auto pla = static_cast<const int32_t*>(a_len);
  auto plb = static_cast<const int32_t*>(b_len);
  auto pd = static_cast<int32_t*>(dirs);
  if (width > kMaxSmemWidth) {
    if (scratch == nullptr) return cudaErrorInvalidValue;
    wavefront_kernel_wide<<<batch, 1024, 0, s>>>(
        pa, pb, pla, plb, a_stride, b_stride, steps, width, batch, match,
        mismatch, gap, static_cast<int*>(scratch), pd);
    return cudaGetLastError();
  }
  switch (width > 1024 ? width / 1024 : 1) {
    case 1:
      return launch<1>(pa, pb, pla, plb, a_stride, b_stride, steps, width,
                       batch, match, mismatch, gap, pd, s);
    case 2:
      return launch<2>(pa, pb, pla, plb, a_stride, b_stride, steps, width,
                       batch, match, mismatch, gap, pd, s);
    case 4:
      return launch<4>(pa, pb, pla, plb, a_stride, b_stride, steps, width,
                       batch, match, mismatch, gap, pd, s);
    case 8:
      return launch<8>(pa, pb, pla, plb, a_stride, b_stride, steps, width,
                       batch, match, mismatch, gap, pd, s);
    default:
      return launch<16>(pa, pb, pla, plb, a_stride, b_stride, steps, width,
                        batch, match, mismatch, gap, pd, s);
  }
}
