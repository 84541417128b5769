// The bucketed window search shared by K5 (proj_match.cu, the local-map
// search) and K4's window form (best_two.cu, the motion-model search): both
// gate a (source, target) pair by a square window of radius r around the
// source's projection, an octave range, the stereo right-x test and both
// validity flags, then take Hamming distances of the candidates. Only the
// octave range and what a row keeps differ, so the target side lives here:
//
// - `stage_tile`: persistent CTAs stage a tile of the targets' geometry (xy,
//   level, right x, validity: 17 bytes a target) into shared memory with 1-D
//   bulk copies (TMA) completing on an mbarrier, then bucket the valid
//   finite targets by (level, 32 px cell) with one counting sort (shared
//   atomics, a scan, a scatter of column indices);
// - `visit_window`: a warp's row visits only the buckets its window covers
//   at its octave range, widened by one cell on each side so float rounding
//   of u +- r never drops a candidate; a row whose window is not finite (or
//   too far out for a one-cell margin) visits every column. Each column lies
//   in one bucket, so a row visits it once; the order of visits (which the
//   atomics vary) does not reach the outputs, since each kernel's key
//   dist * N + col is unique per column;
// - a lane's state (`take`, `key_dist`, `merge`): its least key and the
//   second-least distance among its other candidates, and the merge of two
//   such pairs (the lesser key; the least of the two distances and the
//   larger key's distance), which carries a row across tiles of kTile
//   targets (the most the shared memory stages and a uint16 column sorts).
#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace bucket {

constexpr int kBig = 512;
constexpr int kWarps = 16;              // warps per CTA, each on its own rows
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxLevels = 16;          // octaves above this share the last bucket row
constexpr int kMaxBuckets = 4096;       // levels x cells
constexpr float kCell = 32.f;           // the smallest cell, px (power of two)
constexpr float kFarOut = 1048576.f;    // 2^20: a float ulp there is 1/8 px
constexpr int kTile = 8192;             // targets staged at once (uint16 columns)

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

// Shared memory: the staged target arrays, the sorted columns and the
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

// The CTA's small shared state of a tile's sort (one per kernel).
struct TileShared {
  unsigned max_bits[2];
  int max_level, part[kWarps];
  Grid grid;
};

// A staged and bucketed tile: the targets' geometry at the tile's columns,
// the columns sorted by bucket and off (off[b] .. off[b + 1]: bucket b's).
struct Tile {
  const float2* xy;
  const int* level;
  const float* ur;
  const uint8_t* valid;
  const uint16_t* cols;
  const int* off;
  Grid g;
};

// Initialise the CTA's mbarrier (thread 0), before the first tile.
__device__ __forceinline__ uint64_t* init_barrier(char* sm) {
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  return bar;
}

// Stage and bucket tile t: the nt targets from the tile's first column (the
// pointers are already offset to it). Every thread of the CTA calls it; it
// returns after the CTA's barrier, the tile ready. The caller ends the tile
// with __syncthreads() before the next call reuses the shared memory.
__device__ __forceinline__ Tile stage_tile(char* sm, const Layout& lay, uint64_t* bar,
                                           TileShared& sh, int t, int nt,
                                           const float2* __restrict__ t_xy,
                                           const int* __restrict__ t_level,
                                           const float* __restrict__ t_ur,
                                           const uint8_t* __restrict__ t_valid) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // 1. stage the tile's target geometry
  if (tid == 0) {
    // order the earlier tile's generic-proxy accesses before the copies
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    // arrive once, expecting the bytes of the four bulk copies below
    uintptr_t lo;
    const uint32_t tx = bulk_part(t_xy, 8 * nt, lo) + bulk_part(t_level, 4 * nt, lo) +
                        bulk_part(t_ur, 4 * nt, lo) + bulk_part(t_valid, nt, lo);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(smem(bar)), "r"(tx) : "memory");
    sh.max_bits[0] = sh.max_bits[1] = 0u;
    sh.max_level = 0;
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
  __syncthreads();                                 // the threads' head and tail bytes

  // 2. the bucket grid: cells of 32 px << s from x = y = 0 out to the valid
  // targets' largest finite coordinates (coordinates beyond fall into the
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
      atomicMax(&sh.max_bits[0], bx), atomicMax(&sh.max_bits[1], by);
      atomicMax(&sh.max_level, ml);
    }
    for (int b = tid; b <= kMaxBuckets; b += kThreads) off[b] = 0;
    __syncthreads();
    if (tid == 0) {
      const float ex = __uint_as_float(sh.max_bits[0]), ey = __uint_as_float(sh.max_bits[1]);
      const int nl = min(sh.max_level + 1, kMaxLevels);
      float inv = 1.f / kCell, fx, fy;
      for (;;) {
        fx = floorf(ex * inv) + 1.f, fy = floorf(ey * inv) + 1.f;
        if (fx * fy * nl <= kMaxBuckets) break;
        inv *= 0.5f;
      }
      sh.grid = Grid{inv, static_cast<int>(fx), static_cast<int>(fy), nl};
    }
    __syncthreads();
  }
  const Grid g = sh.grid;

  // 3. counting sort of the valid finite targets by bucket
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
    int incl = sum;                                // inclusive scan of the runs' sums
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) sh.part[warp] = incl;
    __syncthreads();
    int base = incl - sum;
    for (int w = 0; w < warp; ++w) base += sh.part[w];
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
  __syncthreads();                                 // off[b + 1] is now bucket b's end
  return Tile{s_xy, s_level, s_ur, s_valid, cols, off, g};
}

// The columns of the tile a row's window (u, v, r) may hold at octaves
// lo..hi, each visited once by one of the warp's lanes: visit(col) with
// col the tile's column. No column unless r > 0 (|x| < r fails for r <= 0
// and NaN).
template <class Visit>
__device__ __forceinline__ void visit_window(const Tile& T, int lane, int nt, float u, float v,
                                             float r, long long lo, long long hi, Visit&& visit) {
  const bool near = isfinite(r) && fabsf(u) + r < kFarOut && fabsf(v) + r < kFarOut;
  if (r > 0.f && !near) {
    for (int col = lane; col < nt; col += 32) visit(col);
  } else if (r > 0.f) {
    const Grid& g = T.g;
    const int cx0 = max(g.cell(u - r, g.gx) - 1, 0), cx1 = min(g.cell(u + r, g.gx) + 1, g.gx - 1);
    const int cy0 = max(g.cell(v - r, g.gy) - 1, 0), cy1 = min(g.cell(v + r, g.gy) + 1, g.gy - 1);
    const int l0 = g.level(lo), l1 = g.level(hi);
    const int ny = cy1 - cy0 + 1, spans = (l1 - l0 + 1) * ny;
    // a lane per (octave, cell row): its buckets cx0..cx1 are one run
    for (int sp = lane; sp < spans; sp += 32) {
      const int b0 = ((l0 + sp / ny) * g.gy + cy0 + sp % ny) * g.gx + cx0;
      const int end = T.off[b0 + cx1 - cx0 + 1];
      for (int i = T.off[b0]; i < end; ++i) visit(T.cols[i]);
    }
  }
}

// One candidate into a lane's state: the least key and the second-least
// distance among the lane's other candidates.
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

// A pair of the earlier tiles (k1c, d2c) merged into this tile's (k1, d2).
__device__ __forceinline__ void merge(int& k1, int& d2, int k1c, int d2c, int n) {
  d2 = min(min(d2, d2c), key_dist(max(k1, k1c), n));
  k1 = min(k1, k1c);
}

// The number of CTAs of a search over p rows and the dynamic shared memory
// of a tile of min(n, kTile) targets, set on `kernel` (at most one CTA per
// SM: each stages its own copy of the tile). Returns cudaSuccess or the
// error.
template <class Kernel>
inline cudaError_t launch_shape(Kernel kernel, int p, int n, dim3& grid, int& bytes) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  bytes = Layout(n < kTile ? n : kTile).total;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  const int ctas = (p + kWarps - 1) / kWarps;
  grid = dim3(sms < ctas ? sms : ctas);
  return err;
}

}  // namespace bucket
