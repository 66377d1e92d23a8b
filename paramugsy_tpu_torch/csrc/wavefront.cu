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
// The reference's rolled character windows are direct reads
// a[floor((d - w + W/2) / 2) - 1] and b[floor((d + w - W/2) / 2) - 1],
// pad 4 (a) and 5 (b) outside the sequence.
//
// What bounds it on the card.  The anti-diagonals of one pair are
// strictly sequential, and refinement sends its long segments one at a
// time, so a launch is often one pair on one SM.  The work of a step is
// W cells of a handful of integer operations: at W = 512 and 7 operations
// per cell, 3.6 k lane-operations, 28 cycles of one SM's 128 integer lanes
// per clock (64 on the ALU pipe, 64 more for the adds the FMA pipe takes
// as IMAD).  The memory traffic (one int32 word per lane per 16 steps)
// is far below the card's rate.  So the time per step is the SM's issue
// rate plus whatever latency each step exposes.  The first kernel (one
// lane per thread, rows in shared memory, one __syncthreads() and two
// bounds-checked global byte loads per cell per step) spent ~400 cycles a
// step, mostly exposed load and barrier latency.
//
// The design here (`wavefront_reg_kernel`) keeps everything a step needs
// in registers:
//  * each thread owns L contiguous lanes and keeps, per lane, its score at
//    steps d-1 and d-2 (plus the gap, so up/left/diag each take one add)
//    and its code word;
//  * neighbour lanes of other threads come through __shfl_up_sync /
//    __shfl_down_sync, two per step, no barrier;
//  * for a fixed lane, the a and b indices each advance by one every two
//    steps, so the 8 + L/2 bytes of a and of b that a thread's lanes read
//    in 16 steps sit in registers, loaded once per 16 steps (prefetched a
//    block ahead where registers allow).  The wrapper pads both sequences
//    on both sides, so no load needs a bounds check;
//  * the cell is two maxima, each with its (a >= b) predicate, which give
//    the code in the reference's tie order.  Plain max + compare compiles
//    to two VIMNMX per cell; Hopper's DPX __vibmax_s32 (the same max and
//    predicate, a >= b in crt/device_functions.h) compiled to more
//    instructions and measured slower (PERF.md).
// The layout depends only on the band width:
//  * below 256 lanes, one warp per pair (L = W/32 or 2): no barrier at
//    all.  The warp's halo scheme below needs 64 halo lanes, more than
//    such a band has to spare;
//  * from 256 lanes up, temporal blocking: the band is cut into strips of
//    S lanes, one warp per strip, and each warp also computes 32 halo
//    lanes on each side (the dependency cone widens by one lane per step,
//    so 32 steps use them up).  Halo lanes compute the same values as
//    their owners; only owned lanes store.  Every 32 steps the warps swap
//    their owned lanes' two rows through shared memory (two
//    __syncthreads()).  At W 512: four warps of 192 lanes (L = 6), one per
//    scheduler.  One warp per pair at W 512 (16 cells per thread on one
//    scheduler) measured 3x slower (PERF.md).
// What bounds it at W 512: its loop compiles to ~13.9 SASS instructions
// per cell (two VIMNMX, three ISETP, three SEL, the adds), 6 cells per
// thread, one warp per scheduler: ~83 warp instructions a step, mostly on
// the 16-lane integer pipe (2 cycles each), against ~136 cycles measured
// per step (0.069 us on an H100 SXM at 700 W).  So it is issue-bound.
// The function's own 7 operations per cell on 512 lanes, over one SM's
// 128 integer lanes per clock (ALU and FMA pipes together), take 21% of
// that time; the halo (768 cells for 512 lanes) and the instructions
// above 7 per cell are the gap.
//
// Bands wider than 16384 lanes (a length difference of 8192 bp or more
// inside one segment) take `wavefront_kernel_wide`, which keeps both rows
// in a device scratch buffer (row d-2 is overwritten in place by row d,
// lane by lane, by the thread that owns the lane) and accumulates the code
// words in dirs itself.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -100000000;
constexpr int kDiag = 0, kUp = 1, kLeft = 2;
constexpr int kPadA = 4, kPadB = 5;
// Widest band of the register kernel.
constexpr int kMaxRegWidth = 16384;

// floor(x / 2) for negative x as well (arithmetic shift).
__host__ __device__ constexpr int floor_half(int x) { return x >> 1; }

// gl, gr = g of lanes w0 - 1 and w0 + L from the neighbour threads, or
// kNeg past the band's edges (the reference's up/left there).
template <int L>
__device__ __forceinline__ void neighbours(const int (&g)[L], unsigned mask,
                                           bool at_left, bool at_right,
                                           int& gl, int& gr) {
  gl = __shfl_up_sync(mask, g[L - 1], 1);
  gr = __shfl_down_sync(mask, g[0], 1);
  if (at_left) gl = kNeg;
  if (at_right) gr = kNeg;
}

// The sequence bytes of 16 steps from d0 on: xa[j] = a[(d0 - w0 + W/2) / 2
// - L/2 + j], xb[j] = b[(d0 + w0 - W/2) / 2 - 1 + j].  Cell (d0 + s,
// w0 + l), s in 1..16, reads xa[floor((s - l) / 2) + L/2 - 1] and
// xb[floor((s + l) / 2)].
template <int L, int N>
__device__ __forceinline__ void load(const int8_t* ap, const int8_t* bp,
                                     int d0, int w0, int half, int (&xa)[N],
                                     int (&xb)[N]) {
  const int8_t* pa = ap + floor_half(d0 - w0 + half) - L / 2;
  const int8_t* pb = bp + floor_half(d0 + w0 - half) - 1;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    xa[j] = pa[j];
    xb[j] = pb[j];
  }
}

// a, b: padded code rows, [batch][stride], the sequence at [front, ...),
// pads everywhere else (the wrapper's `pad_rows`).  One block per pair;
// blockDim.x = 32 * (W / strip) threads with temporal blocking, W / L for
// one warp per pair (strip = W).  L even, so every thread's first lane w0 is even and the
// windows below start at exact halves.
template <int L, int MAXT, bool PREFETCH>
__global__ void __launch_bounds__(MAXT) wavefront_reg_kernel(
    const int8_t* __restrict__ a, const int8_t* __restrict__ b, int stride,
    int front, int steps, int width, int strip, int batch, int match,
    int mismatch, int gap, int32_t* __restrict__ dirs) {
  constexpr int N = 8 + L / 2;  // bytes of a and of b read per 16 steps
  extern __shared__ int rows[];  // [2][width]: g and g2 of owned lanes
  const int p = blockIdx.x;
  const int half = width >> 1;
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const bool blocked = blockDim.x > 32;
  const int ext = blocked ? 32 * L : width;  // lanes one warp computes
  const int own_lo = warp * strip;
  const int own_hi = own_lo + strip;
  const int e0 = min(max(own_lo - (ext - strip) / 2, 0), width - ext);
  const int w0 = e0 + t * L;
  const bool at_left = w0 == 0;
  const bool at_right = w0 + L == width;
  const unsigned mask = blockDim.x >= 32 ? 0xffffffffu : (1u << blockDim.x) - 1u;
  const int8_t* ap = a + static_cast<size_t>(p) * stride + front;
  const int8_t* bp = b + static_cast<size_t>(p) * stride + front;
  const int mg = match - gap;
  const int xg = mismatch - gap;

  // g = score at step d-1 plus gap (the up/left operand); g2 = score at
  // step d-2 plus gap, so diag = g2 + (sub - gap).
  int g[L], g2[L];
  uint32_t acc[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    g[l] = (w0 + l == half ? 0 : kNeg) + gap;  // step 0: only cell (0, 0)
    g2[l] = kNeg + gap;                        // step -1
    acc[l] = 0;
  }
  int gl, gr;  // g of lanes w0 - 1 and w0 + L (kNeg past the band)
  neighbours<L>(g, mask, at_left, at_right, gl, gr);

  // This block's bytes (ca, cb) and, with PREFETCH, the next block's.
  int ca[N], cb[N], na[N], nb[N];
  if constexpr (PREFETCH) load<L, N>(ap, bp, 0, w0, half, ca, cb);

  for (int d0 = 0; d0 < steps; d0 += 16) {
    if constexpr (PREFETCH) {
      load<L, N>(ap, bp, d0 + 16, w0, half, na, nb);
    } else {
      load<L, N>(ap, bp, d0, w0, half, ca, cb);
    }
#pragma unroll
    for (int s = 1; s <= 16; ++s) {
      int nd[L];
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const int up = l + 1 < L ? g[l + 1] : gr;
        const int left = l > 0 ? g[l - 1] : gl;
        const int diag =
            g2[l] + (ca[floor_half(s - l) + L / 2 - 1] == cb[floor_half(s + l)] ? mg : xg);
        const bool up_ge = up >= left;
        const int m1 = max(up, left);
        const bool diag_ge = diag >= m1;
        const int dp = max(diag, m1);
        if (!diag_ge) acc[l] |= (up_ge ? uint32_t{kUp} : uint32_t{kLeft}) << (2 * (s - 1));
        nd[l] = dp + gap;
      }
#pragma unroll
      for (int l = 0; l < L; ++l) {
        g2[l] = g[l];
        g[l] = nd[l];
      }
      neighbours<L>(g, mask, at_left, at_right, gl, gr);
    }
    int32_t* drow = dirs + (static_cast<size_t>(d0 >> 4) * batch + p) * width;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int w = w0 + l;
      if (w >= own_lo && w < own_hi) drow[w] = static_cast<int32_t>(acc[l]);
      acc[l] = 0;
    }
    if (blocked && (d0 & 16)) {
      // Every 32 steps, owned lanes out and halo lanes in: the halo is
      // valid again.
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const int w = w0 + l;
        if (w >= own_lo && w < own_hi) {
          rows[w] = g[l];
          rows[width + w] = g2[l];
        }
      }
      __syncthreads();
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const int w = w0 + l;
        if (w < own_lo || w >= own_hi) {
          g[l] = rows[w];
          g2[l] = rows[width + w];
        }
      }
      __syncthreads();
      neighbours<L>(g, mask, at_left, at_right, gl, gr);
    }
    if constexpr (PREFETCH) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        ca[j] = na[j];
        cb[j] = nb[j];
      }
    }
  }
}

template <int L, int MAXT, bool PREFETCH>
cudaError_t launch(const int8_t* a, const int8_t* b, int stride, int front,
                   int steps, int width, int strip, int batch, int match,
                   int mismatch, int gap, int32_t* dirs, cudaStream_t stream) {
  const int threads = strip == width ? width / L : 32 * (width / strip);
  if (threads > MAXT || (strip != width && 32 * L - strip < 64))
    return cudaErrorInvalidConfiguration;
  const size_t smem = threads > 32 ? 2 * static_cast<size_t>(width) * sizeof(int) : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        wavefront_reg_kernel<L, MAXT, PREFETCH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  wavefront_reg_kernel<L, MAXT, PREFETCH><<<batch, threads, smem, stream>>>(
      a, b, stride, front, steps, width, strip, batch, match, mismatch, gap,
      dirs);
  return cudaGetLastError();
}

// Bands wider than kMaxRegWidth.  rows: [batch][2][width] scratch; row d
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

// a, b: int8 [batch, stride] padded code rows (the sequence at [front,
// ...), pad 4 in a and 5 in b elsewhere); front >= W/4 + 8 and stride >=
// front + steps/2 + W/4 + 16, so every read is inside the row.  dirs: int32
// [steps/16, batch, width].  width is a power of two in [32, 16384];
// steps a multiple of 16.  Returns a cudaError_t.
extern "C" int pm_wavefront_dp(const void* a, const void* b, int stride,
                               int front, int steps, int width, int batch,
                               int match, int mismatch, int gap, void* dirs,
                               void* stream) {
  if (width < 32 || width > kMaxRegWidth || (width & (width - 1)) ||
      steps % 16 || batch <= 0 || front < width / 4 + 8 ||
      stride < front + steps / 2 + width / 4 + 16)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto pa = static_cast<const int8_t*>(a);
  auto pb = static_cast<const int8_t*>(b);
  auto pd = static_cast<int32_t*>(dirs);
#define PM_LAUNCH(L, MAXT, PF, STRIP)                                           \
  return launch<L, MAXT, PF>(pa, pb, stride, front, steps, width, STRIP,       \
                             batch, match, mismatch, gap, pd, s)
  // (lanes per thread, threads at most, prefetch, strip): one warp per pair
  // below 256 lanes (strip = width); from 256 up, strips of 128 lanes (192
  // computed, L = 6) up to 32 warps, and wider strips past that.
  switch (width) {
    case 32: PM_LAUNCH(2, 32, true, 32);
    case 64: PM_LAUNCH(2, 32, true, 64);
    case 128: PM_LAUNCH(4, 32, true, 128);
    case 256: PM_LAUNCH(6, 64, true, 128);
    case 512: PM_LAUNCH(6, 128, true, 128);
    case 1024: PM_LAUNCH(6, 256, true, 128);
    case 2048: PM_LAUNCH(6, 512, true, 128);
    case 4096: PM_LAUNCH(6, 1024, false, 128);
    case 8192: PM_LAUNCH(10, 1024, false, 256);
    case 16384: PM_LAUNCH(18, 1024, false, 512);
    default: return cudaErrorInvalidValue;
  }
#undef PM_LAUNCH
}

// Bands wider than 16384 lanes.  a: int8 [batch, a_stride]; b: int8
// [batch, b_stride] (unpadded; contents past each pair's length are not
// read); a_len, b_len: int32 [batch]; dirs: int32 [steps/16, batch,
// width]; scratch: int32 [batch, 2, width].  width a power of two; steps
// a multiple of 16.  Returns a cudaError_t.
extern "C" int pm_wavefront_dp_wide(const void* a, const void* b,
                                    const void* a_len, const void* b_len,
                                    int a_stride, int b_stride, int steps,
                                    int width, int batch, int match,
                                    int mismatch, int gap, void* dirs,
                                    void* scratch, void* stream) {
  if (width <= kMaxRegWidth || (width & (width - 1)) || steps % 16 ||
      batch <= 0 || scratch == nullptr)
    return cudaErrorInvalidValue;
  wavefront_kernel_wide<<<batch, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<const int32_t*>(a_len), static_cast<const int32_t*>(b_len),
      a_stride, b_stride, steps, width, batch, match, mismatch, gap,
      static_cast<int*>(scratch), static_cast<int32_t*>(dirs));
  return cudaGetLastError();
}
