// K5: local-map projection search (replaces
// orb_slam2_tpu/ops/pallas_kernels.py `projection_best_two_pallas`,
// `_proj_match_kernel`).
//
// For each projected map point: the candidate gate (square window of radius
// r around its projection, keypoint octave in [pred - 1, pred], stereo
// right-x within r where both sides have one, both sides valid), the
// Hamming distance to each candidate, the best distance and column (the
// lowest column wins a tie), then the second best among candidates at the
// best's octave with the best column excluded. A row with no candidate gives
// BIG / 0 / BIG.
//
// Bound: the gate is needed only on pairs of a valid point and a valid
// keypoint (on the main path's first frame ~0.7 M of the 16.8 M slots of
// P = 8192 x N = 2048), ~8 M operations, ~0.12 us; the kernel is bound by
// latency, not by either.
// Design: persistent CTAs, one per SM. Each stages the keypoint geometry
// (xy, level, right x, validity: 17 bytes a keypoint) into shared memory
// with 1-D bulk copies (TMA) completing on an mbarrier, then buckets the
// valid keypoints by (level, cell) with one counting sort (shared atomics,
// a scan, a scatter of column indices). Warps take rows in a grid-stride
// loop. A row visits only the buckets its window covers at octaves pred - 1
// and pred, widened by one cell on each side so float rounding of u +- r
// never drops a candidate, and decides every pair by the twin's exact float
// compares; a row whose window is not finite (or too far out for a
// one-cell margin) tests every column. Each column lies in one bucket, so a
// row tests it once, and the order of visits (which the atomics vary) does
// not reach the outputs: the key dist * N + col is unique per column.
// One pass: a candidate's octave is pred - 1 or pred, so each lane keeps,
// per octave, its least key and the second-least distance among its own
// candidates of that octave; the second best is then one warp minimum (the
// best's lane gives its second-least distance, every other lane the
// distance of its least key at the best's octave). Descriptors stay in
// global memory and are read only for candidates.
// Any number of keypoints: each CTA walks them in tiles of kTile (the most
// its shared memory stages and a uint16 column sorts), staging, bucketing
// and sorting each tile in turn, its warps on the same rows in every tile.
// The key stays dist * N + column over all N, so ties go to the lowest
// column across tiles. With more than one tile, each row reduces its lanes
// to one (least key, second-least distance) pair per octave at the end of a
// tile and merges it with the pair carried from the earlier tiles: the
// least of the two keys, and the least of the two distances and the larger
// key's distance. The carried pairs (4 int32 a row) live in a (P, 4)
// scratch that only the row's own warp (its lane 0) reads and writes, so no
// CTA waits on another. With one tile (N <= kTile) the kernel's untiled
// instance runs: no scratch, no merge.
#include <cuda_runtime.h>
#include <algorithm>
#include <climits>
#include <cstdint>

namespace {

constexpr int kBig = 512;
constexpr int kWarps = 16;              // warps per CTA, each on its own rows
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxLevels = 16;          // octaves above this share the last bucket row
constexpr int kMaxBuckets = 4096;       // levels x cells
constexpr float kCell = 32.f;           // the smallest cell, px (power of two)
constexpr float kFarOut = 1048576.f;    // 2^20: a float ulp there is 1/8 px
constexpr int kTile = 8192;             // keypoints staged at once (uint16 columns)

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int hamming(const uint4& a0, const uint4& a1,
                                       const uint4* __restrict__ b) {
  const uint4 b0 = __ldg(b), b1 = __ldg(b + 1);
  return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) +
         __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
         __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
}

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared memory: the staged keypoint arrays, the sorted columns and the
// bucket offsets. Each staged array starts (src & 15) bytes into a region
// with 16 bytes of slack, so its 16-byte-aligned middle can be a bulk copy
// whatever the tensor's alignment; the head and tail bytes are copied by
// threads.
struct Layout {
  int xy, level, ur, valid, cols, off, total;
  __host__ __device__ explicit Layout(int n) {
    auto region = [](int bytes) { return (bytes + 15) / 16 * 16 + 16; };
    xy = 16;                                      // bytes 0-7: the mbarrier
    level = xy + region(8 * n);
    ur = level + region(4 * n);
    valid = ur + region(4 * n);
    cols = valid + region(n);
    off = cols + (2 * n + 15) / 16 * 16;
    total = off + 4 * (kMaxBuckets + 1);
  }
};

// The 16-byte-aligned middle of `bytes` at src: its start and length (0
// when there is none), the part a bulk copy can move.
__device__ __forceinline__ int bulk_part(const void* src, int bytes, uintptr_t& lo) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  lo = (s + 15) & ~uintptr_t(15);
  const uintptr_t hi = (s + bytes) & ~uintptr_t(15);
  return hi > lo ? static_cast<int>(hi - lo) : 0;
}

// Stage `bytes` of src into the region at dst_region: returns where src[0]
// landed. Thread 0 issues the bulk copy of the aligned middle, completing on
// bar; every thread copies its share of the unaligned head and tail.
__device__ __forceinline__ char* stage(char* dst_region, const void* src, int bytes,
                                       uint64_t* bar) {
  uintptr_t lo;
  const int mid = bulk_part(src, bytes, lo);
  const int head = mid > 0 ? static_cast<int>(lo - reinterpret_cast<uintptr_t>(src)) : bytes;
  char* dst = dst_region + (reinterpret_cast<uintptr_t>(src) & 15);
  if (threadIdx.x == 0 && mid > 0) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(smem(dst + head)), "l"(lo), "r"(mid), "r"(smem(bar)) : "memory");
  }
  const char* in = static_cast<const char*>(src);
  for (int i = threadIdx.x; i < bytes - mid; i += blockDim.x) {
    const int at = i < head ? i : i + mid;
    dst[at] = in[at];
  }
  return dst;
}

struct Grid {
  float inv_cs;
  int gx, gy, nl;
  __device__ int cell(float x, int g) const {
    return static_cast<int>(fminf(fmaxf(floorf(x * inv_cs), 0.f), static_cast<float>(g - 1)));
  }
  __device__ int level(long long l) const {
    return static_cast<int>(l < 0 ? 0 : l >= nl ? nl - 1 : l);
  }
  __device__ int bucket(int l, float x, float y) const {
    return (level(l) * gy + cell(y, gy)) * gx + cell(x, gx);
  }
};

// One candidate into a lane's state for its octave: the least key and the
// second-least distance among the lane's other candidates.
__device__ __forceinline__ void take(int& k1, int& d2, int key, int d, int n) {
  if (key < k1) {
    if (k1 != INT_MAX) d2 = min(d2, k1 / n);
    k1 = key;
  } else {
    d2 = min(d2, d);
  }
}

// The distance of a key (BIG for no candidate).
__device__ __forceinline__ int key_dist(int key, int n) {
  return key == INT_MAX ? kBig : key / n;
}

// One octave's pair of the earlier tiles (k1, d2) merged into this tile's.
__device__ __forceinline__ void merge(int& k1, int& d2, int k1c, int d2c, int n) {
  d2 = min(min(d2, d2c), key_dist(max(k1, k1c), n));
  k1 = min(k1, k1c);
}

template <bool kTiled>
__global__ void __launch_bounds__(kThreads)
proj_match_kernel(const float2* __restrict__ uv, const float* __restrict__ radius,
                  const int* __restrict__ pred_level, const float* __restrict__ p_ur,
                  const uint8_t* __restrict__ p_valid, const uint4* __restrict__ p_desc,
                  int p, const float2* __restrict__ kp_xy, const int* __restrict__ kp_level,
                  const float* __restrict__ kp_ur, const uint8_t* __restrict__ kp_valid,
                  const uint4* __restrict__ kp_desc, int n, int* __restrict__ best,
                  int* __restrict__ idx, int* __restrict__ second, int4* __restrict__ carry) {
  extern __shared__ __align__(16) char sm[];
  __shared__ unsigned max_bits[2];
  __shared__ int max_level, part[kWarps];
  __shared__ Grid grid;
  const int tiles = kTiled ? (n + kTile - 1) / kTile : 1;
  const Layout lay(kTiled ? kTile : n);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  for (int t = 0; t < tiles; ++t) {
    const int c0 = t * kTile, nt = min(kTile, n - c0);
    const bool last = t == tiles - 1;
    const float2* t_xy = kp_xy + c0;
    const int* t_level = kp_level + c0;
    const float* t_ur = kp_ur + c0;
    const uint8_t* t_valid = kp_valid + c0;

    // 1. stage the tile's keypoint geometry
    if (tid == 0) {
      // order the earlier tile's generic-proxy accesses before the copies
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      // arrive once, expecting the bytes of the four bulk copies below
      uintptr_t lo;
      const uint32_t tx = bulk_part(t_xy, 8 * nt, lo) + bulk_part(t_level, 4 * nt, lo) +
                          bulk_part(t_ur, 4 * nt, lo) + bulk_part(t_valid, nt, lo);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(smem(bar)), "r"(tx) : "memory");
      max_bits[0] = max_bits[1] = 0u;
      max_level = 0;
    }
    __syncthreads();
    const float2* s_xy = reinterpret_cast<const float2*>(stage(sm + lay.xy, t_xy, 8 * nt, bar));
    const int* s_level = reinterpret_cast<const int*>(stage(sm + lay.level, t_level, 4 * nt, bar));
    const float* s_ur = reinterpret_cast<const float*>(stage(sm + lay.ur, t_ur, 4 * nt, bar));
    const uint8_t* s_valid = reinterpret_cast<const uint8_t*>(stage(sm + lay.valid, t_valid, nt,
                                                                    bar));
    uint16_t* cols = reinterpret_cast<uint16_t*>(sm + lay.cols);
    int* off = reinterpret_cast<int*>(sm + lay.off);  // off[b + 1]: bucket b's count, start, end
    uint32_t done = 0;
    const uint32_t parity = t & 1;                   // the barrier's phase of this tile
    while (!done) {
      asm volatile(
          "{\n .reg .pred q;\n mbarrier.try_wait.parity.shared::cta.b64 q, [%1], %2;\n"
          " selp.u32 %0, 1, 0, q;\n}\n" : "=r"(done) : "r"(smem(bar)), "r"(parity) : "memory");
    }
    __syncthreads();                               // the threads' head and tail bytes

    // 2. the bucket grid: cells of 32 px << s from x = y = 0 out to the valid
    // keypoints' largest finite coordinates (coordinates beyond fall into the
    // edge cells), s the least that keeps levels x cells <= kMaxBuckets
    {
      float mx = 0.f, my = 0.f;
      int ml = 0;
      for (int c = tid; c < nt; c += kThreads) {
        const float2 k = s_xy[c];
        if (s_valid[c] && isfinite(k.x) && isfinite(k.y)) {
          mx = fmaxf(mx, k.x), my = fmaxf(my, k.y), ml = max(ml, s_level[c]);
        }
      }
      // non-negative floats order as their bits
      const unsigned bx = __reduce_max_sync(0xffffffffu, __float_as_uint(mx));
      const unsigned by = __reduce_max_sync(0xffffffffu, __float_as_uint(my));
      ml = __reduce_max_sync(0xffffffffu, ml);
      if (lane == 0) {
        atomicMax(&max_bits[0], bx), atomicMax(&max_bits[1], by), atomicMax(&max_level, ml);
      }
      for (int b = tid; b <= kMaxBuckets; b += kThreads) off[b] = 0;
      __syncthreads();
      if (tid == 0) {
        const float ex = __uint_as_float(max_bits[0]), ey = __uint_as_float(max_bits[1]);
        const int nl = min(max_level + 1, kMaxLevels);
        float inv = 1.f / kCell, fx, fy;
        for (;;) {
          fx = floorf(ex * inv) + 1.f, fy = floorf(ey * inv) + 1.f;
          if (fx * fy * nl <= kMaxBuckets) break;
          inv *= 0.5f;
        }
        grid = Grid{inv, static_cast<int>(fx), static_cast<int>(fy), nl};
      }
      __syncthreads();
    }
    const Grid g = grid;

    // 3. counting sort of the valid finite keypoints by bucket
    for (int c = tid; c < nt; c += kThreads) {
      const float2 k = s_xy[c];
      if (s_valid[c] && isfinite(k.x) && isfinite(k.y))
        atomicAdd(&off[1 + g.bucket(s_level[c], k.x, k.y)], 1);
    }
    __syncthreads();
    {
      // exclusive scan of off[1 .. kMaxBuckets]: each thread a run of 8
      constexpr int kRun = kMaxBuckets / kThreads;
      int* run = off + 1 + tid * kRun;
      int sum = 0;
#pragma unroll
      for (int i = 0; i < kRun; ++i) sum += run[i];
      int incl = sum;                              // inclusive scan of the runs' sums
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      if (lane == 31) part[warp] = incl;
      __syncthreads();
      int base = incl - sum;
      for (int w = 0; w < warp; ++w) base += part[w];
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
        const int c = run[i];
        run[i] = base;
        base += c;
      }
    }
    __syncthreads();
    for (int c = tid; c < nt; c += kThreads) {
      const float2 k = s_xy[c];
      if (s_valid[c] && isfinite(k.x) && isfinite(k.y))
        cols[atomicAdd(&off[1 + g.bucket(s_level[c], k.x, k.y)], 1)] = static_cast<uint16_t>(c);
    }
    __syncthreads();                               // off[b + 1] is now bucket b's end

    // 4. rows, one warp each, the same rows in every tile
    for (int row = blockIdx.x * kWarps + warp; row < p; row += gridDim.x * kWarps) {
      if (!p_valid[row]) {
        if (last && lane == 0) best[row] = kBig, idx[row] = 0, second[row] = kBig;
        continue;
      }
      const float2 puv = uv[row];
      const float u = puv.x, v = puv.y, r = radius[row], pur = p_ur[row];
      const int pred = pred_level[row];
      const uint4 a0 = __ldg(p_desc + 2 * row), a1 = __ldg(p_desc + 2 * row + 1);
      int k1a = INT_MAX, d2a = kBig, k1b = INT_MAX, d2b = kBig;   // octaves pred - 1, pred
      // the gate of projection_candidates (ops/cuda_match.py), then the state;
      // col is the tile's column, c0 + col the keypoint's
      auto visit = [&](int col) {
        if (!s_valid[col]) return;
        const float2 k = s_xy[col];
        if (!(fabsf(u - k.x) < r) || !(fabsf(v - k.y) < r)) return;
        const int kl = s_level[col];
        if (kl < pred - 1 || kl > pred) return;
        const float kur = s_ur[col];
        if ((pur >= 0.f && kur >= 0.f) && !(fabsf(pur - kur) < r)) return;
        const int d = hamming(a0, a1, kp_desc + 2 * (c0 + col));
        if (kl == pred) take(k1b, d2b, d * n + c0 + col, d, n);
        else take(k1a, d2a, d * n + c0 + col, d, n);
      };
      // no candidate unless r > 0 (|x| < r fails for r <= 0 and NaN)
      const bool near = isfinite(r) && fabsf(u) + r < kFarOut && fabsf(v) + r < kFarOut;
      if (r > 0.f && !near) {
        for (int col = lane; col < nt; col += 32) visit(col);
      } else if (r > 0.f) {
        const int cx0 = max(g.cell(u - r, g.gx) - 1, 0), cx1 = min(g.cell(u + r, g.gx) + 1, g.gx - 1);
        const int cy0 = max(g.cell(v - r, g.gy) - 1, 0), cy1 = min(g.cell(v + r, g.gy) + 1, g.gy - 1);
        const int l0 = g.level(static_cast<long long>(pred) - 1), l1 = g.level(pred);
        const int ny = cy1 - cy0 + 1, spans = (l1 - l0 + 1) * ny;
        // a lane per (octave, cell row): its buckets cx0..cx1 are one run
        for (int sp = lane; sp < spans; sp += 32) {
          const int b0 = ((l0 + sp / ny) * g.gy + cy0 + sp % ny) * g.gx + cx0;
          const int end = off[b0 + cx1 - cx0 + 1];
          for (int i = off[b0]; i < end; ++i) visit(cols[i]);
        }
      }
      if (!kTiled) {
        const int kmin = warp_min(min(k1a, k1b));
        int b = kBig, bidx = 0, s2 = kBig;
        if (kmin != INT_MAX) {
          b = kmin / n;
          bidx = kmin - b * n;
          const bool at_pred = s_level[bidx] == pred;
          const int k1 = at_pred ? k1b : k1a, d2 = at_pred ? d2b : d2a;
          s2 = warp_min(k1 == kmin ? d2 : k1 == INT_MAX ? kBig : k1 / n);
        }
        if (lane == 0) best[row] = b, idx[row] = bidx, second[row] = s2;
        continue;
      }
      // this tile's pair per octave, merged with the earlier tiles'
      const int K1a = warp_min(k1a), K1b = warp_min(k1b);
      int D2a = warp_min(k1a == K1a ? d2a : key_dist(k1a, n));
      int D2b = warp_min(k1b == K1b ? d2b : key_dist(k1b, n));
      if (lane == 0) {
        int ka = K1a, kb = K1b;
        if (t > 0) {
          const int4 c = carry[row];
          merge(ka, D2a, c.x, c.y, n);
          merge(kb, D2b, c.z, c.w, n);
        }
        if (!last) {
          carry[row] = make_int4(ka, D2a, kb, D2b);
        } else {
          const int kmin = min(ka, kb);
          if (kmin == INT_MAX) {
            best[row] = kBig, idx[row] = 0, second[row] = kBig;
          } else {
            const int b = kmin / n;
            best[row] = b, idx[row] = kmin - b * n, second[row] = kmin == kb ? D2b : D2a;
          }
        }
      }
    }
    __syncthreads();                               // the tile's shared memory is free
  }
}

}  // namespace

extern "C" int orb_proj_match(const void* uv, const void* radius, const void* pred_level,
                              const void* p_ur, const void* p_valid, const void* p_desc,
                              int p, const void* kp_xy, const void* kp_level,
                              const void* kp_ur, const void* kp_valid, const void* kp_desc,
                              int n, void* best, void* idx, void* second, void* carry,
                              void* stream) {
  // carry: (p, 4) int32 scratch, needed (and touched) only when n > kTile
  if (n < 1 || (n > kTile && carry == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const bool tiled = n > kTile;
  const auto kernel = tiled ? proj_match_kernel<true> : proj_match_kernel<false>;
  const int bytes = Layout(std::min(n, kTile)).total;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(std::min(sms, (p + kWarps - 1) / kWarps));
  kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(uv), static_cast<const float*>(radius),
      static_cast<const int*>(pred_level), static_cast<const float*>(p_ur),
      static_cast<const uint8_t*>(p_valid), static_cast<const uint4*>(p_desc), p,
      static_cast<const float2*>(kp_xy), static_cast<const int*>(kp_level),
      static_cast<const float*>(kp_ur), static_cast<const uint8_t*>(kp_valid),
      static_cast<const uint4*>(kp_desc), n, static_cast<int*>(best),
      static_cast<int*>(idx), static_cast<int*>(second), static_cast<int4*>(carry));
  return static_cast<int>(cudaGetLastError());
}
