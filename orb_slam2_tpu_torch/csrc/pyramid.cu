// K1: the ORB image pyramid in one launch. Levels 1..L-1, each a separable
// 2-tap bilinear resize of the level before it (OpenCV pixel-centre rule,
// cv::resize INTER_LINEAR).
//
// Replaces: orb_slam2_tpu/ops/pallas_extract.py `pyramid_pallas` /
// `_pyramid_kernel`, which ran the whole cascade as bf16 MXU matmuls
// (Ry @ img @ Rx^T) because the TPU has no cheap gather. The spec here is the
// reference's exact float32 path, `image.resize_bilinear(fast=False)`: each
// output is w0*a + w1*b over rows, then over columns, with the tap tables of
// `image._resize_taps` (where both taps clamp to one pixel, tap 0 carries the
// merged weight and tap 1 weighs 0).
//
// What bounds it on the card: memory traffic, launch latency and the chain
// between levels. The 7 output levels of a 640x480 frame are ~0.64 M pixels
// reading ~4 source pixels each, a few MB that sit in L2, with no arithmetic
// to speak of (~1.2 us of bytes at 3.35 TB/s). A launch per level paid 7
// launch gaps and 7 argument checks on the host for that; one launch keeps
// the chain: a pixel of level 7 depends on 7 levels in turn.
// Design: one launch over the rows of all levels, a block per row. A block
// takes its row from a global ticket, not from blockIdx: rows are numbered
// level by level, so every row a block waits on has a lower ticket, was
// taken by a block that is already running, and the launch cannot deadlock
// however the grid is scheduled. A row of level 2.. reads its row taps,
// then waits for the two rows of the level before that they name: a flag
// per row, set once the row is written (waiting for the whole level before,
// or for bands of 2 or 4 rows, measured slower on the H100: PERF.md). The
// producer stores its row, synchronises, and thread 0 adds to its flag after
// a release fence (CUTLASS's generic barrier); the consumer spins on an
// acquire load and synchronises, then reads the level before through
// __ldcg (L2): the read-only path (__ldg) must never see data that other
// blocks of this launch write. Level 0 and the tap tables are read through
// __ldg. The last block to arrive sets the flags, the ticket and the arrival
// count back to 0 for the next launch; the wrapper keeps one counter buffer
// per (device, stream) (`launch.counters`). The levels' sizes, tap tables
// and outputs are passed by value (`__grid_constant__`). Products and sums
// use __fmul_rn/__fadd_rn so nvcc cannot contract them into FMAs: the
// result is bit-identical to the PyTorch twin (`cuda_extract.pyramid_plain`).
// Every index is clamped into the source.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 16;   // output levels (level 0, the input, not counted)
constexpr int kThreads = 256;

struct Level {
  const float* src;              // the level before (level 1: the input image)
  float* dst;
  const int* iy;                 // (2, h) row taps into src
  const int* ix;                 // (2, w) column taps into src
  const float* wy;               // (2, h)
  const float* wx;               // (2, w)
  int src_h, src_w, h, w;
  int row0;                      // the level's first row (ticket)
};

struct Levels {                  // passed by value: kMaxLevels * 72 + 8 bytes
  Level lv[kMaxLevels];
  int n;                         // output levels
  int rows;                      // rows of all levels
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// counters: [0, rows) a flag per row (1 once written), [rows] the next
// ticket, [rows + 1] the blocks that have finished; all 0 between launches
__global__ void __launch_bounds__(kThreads)
pyramid_kernel(const __grid_constant__ Levels L, unsigned* __restrict__ counters) {
  __shared__ int s_ticket;
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  if (tid == 0) s_ticket = static_cast<int>(atomicAdd(counters + L.rows, 1u));
  __syncthreads();
  const int ticket = s_ticket;
  int l = 0;
  while (l + 1 < L.n && ticket >= L.lv[l + 1].row0) ++l;
  const Level& lv = L.lv[l];
  const int h = lv.h, w = lv.w, sh = lv.src_h, sw = lv.src_w, r = ticket - lv.row0;

  // the row taps, then the wait for the two source rows they name
  const int y0 = clampi(__ldg(lv.iy + r), 0, sh - 1);
  const int y1 = clampi(__ldg(lv.iy + h + r), 0, sh - 1);
  const float wy0 = __ldg(lv.wy + r), wy1 = __ldg(lv.wy + h + r);
  if (l > 0) {
    const unsigned* flags = counters + L.lv[l - 1].row0;
    if (tid < 2) {
      const unsigned* f = flags + (tid == 0 ? y0 : y1);
      while (load_acquire(f) == 0u) {
      }
    }
    __syncthreads();
  }

  const bool input = l == 0;
  const float* __restrict__ row0 = lv.src + static_cast<size_t>(y0) * sw;
  const float* __restrict__ row1 = lv.src + static_cast<size_t>(y1) * sw;
  float* __restrict__ dst = lv.dst + static_cast<size_t>(r) * w;
  for (int c = tid; c < w; c += kThreads) {
    const int x0 = clampi(__ldg(lv.ix + c), 0, sw - 1);
    const int x1 = clampi(__ldg(lv.ix + w + c), 0, sw - 1);
    const float wx0 = __ldg(lv.wx + c), wx1 = __ldg(lv.wx + w + c);
    float a0, a1, b0, b1;        // (y0, x0), (y1, x0), (y0, x1), (y1, x1)
    if (input) {
      a0 = __ldg(row0 + x0), a1 = __ldg(row1 + x0), b0 = __ldg(row0 + x1), b1 = __ldg(row1 + x1);
    } else {
      a0 = __ldcg(row0 + x0), a1 = __ldcg(row1 + x0), b0 = __ldcg(row0 + x1),
      b1 = __ldcg(row1 + x1);
    }
    // rows first (Ry @ img) at the two source columns this output needs
    const float t0 = __fadd_rn(__fmul_rn(wy0, a0), __fmul_rn(wy1, a1));
    const float t1 = __fadd_rn(__fmul_rn(wy0, b0), __fmul_rn(wy1, b1));
    // then columns (@ Rx^T)
    dst[c] = __fadd_rn(__fmul_rn(wx0, t0), __fmul_rn(wx1, t1));
  }

  // publish the row (CUTLASS's generic barrier: the block's stores, a
  // barrier, then one release-ordered add), then count this block's arrival
  __syncthreads();
  if (tid == 0) {
    asm volatile("fence.acq_rel.gpu;\n red.relaxed.gpu.global.add.u32 [%0], 1;"
                 ::"l"(counters + ticket) : "memory");
    s_last = atomicAdd(counters + L.rows + 1, 1u) == static_cast<unsigned>(L.rows - 1);
  }
  __syncthreads();
  if (s_last) {                  // every block is past its waits
    for (int i = tid; i < L.rows + 2; i += kThreads) counters[i] = 0u;
  }
}

}  // namespace

// n output levels; dims: (h, w) of levels 0..n (host ints); img (h0, w0)
// float32; out: the n levels row-major one after another (sum h*w float32);
// itaps: per level its iy (2, h) then ix (2, w) int32, ftaps its wy then wx
// float32, the levels one after another; counters: sum(h) + 2 uint32 (the
// output levels' rows), 0 at rest.
extern "C" int orb_pyramid(int n, const int* dims, const float* img, float* out,
                           const int* itaps, const float* ftaps, unsigned* counters,
                           void* stream) {
  if (n < 1 || n > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  Levels L{};
  L.n = n;
  const float* src = img;
  size_t out_off = 0, tap_off = 0;
  for (int l = 0; l < n; ++l) {
    Level& lv = L.lv[l];
    lv.src_h = dims[2 * l], lv.src_w = dims[2 * l + 1];
    lv.h = dims[2 * l + 2], lv.w = dims[2 * l + 3];
    if (lv.src_h < 1 || lv.src_w < 1 || lv.h < 1 || lv.w < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    lv.src = src;
    lv.dst = out + out_off;
    lv.iy = itaps + tap_off, lv.ix = itaps + tap_off + 2 * lv.h;
    lv.wy = ftaps + tap_off, lv.wx = ftaps + tap_off + 2 * lv.h;
    lv.row0 = L.rows;
    L.rows += lv.h;
    src = lv.dst;
    out_off += static_cast<size_t>(lv.h) * lv.w;
    tap_off += 2 * static_cast<size_t>(lv.h + lv.w);
  }
  pyramid_kernel<<<L.rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(L, counters);
  return static_cast<int>(cudaGetLastError());
}
