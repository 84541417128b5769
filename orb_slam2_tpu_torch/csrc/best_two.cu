// K4: masked Hamming best / second best, with the mask's gate computed in
// the launch (replaces orb_slam2_tpu/ops/pallas_kernels.py
// `masked_best_two_pallas`, `_best_two_kernel`, composed with the (N, M)
// candidate masks its callers build: orb_slam2_tpu/ops/matching.py
// `search_by_projection_frame` and `search_by_node`).
//
// For each source row: the Hamming distance (8-word XOR + popcount) to each
// candidate target, the best distance, the best column (the lowest wins a
// tie) and the second best with the best column excluded, over every
// candidate. A row with no candidate gives BIG = 512 / 0 / BIG. Two gates:
//
// - the window form (`orb_window_best_two`, the motion-model search): a
//   pair is a candidate under the float32 compares of ops/matching.py's
//   window mask: |du| < r, |dv| < r, the target's octave in
//   [src + dlo, src + dhi] (either side may be open: the forward and
//   backward rules), the stereo right-x test where both sides have one,
//   both valid. It is the bucketed window search of bucket_search.cuh, which
//   K5 runs at octaves [pred - 1, pred]: persistent CTAs stage the targets
//   by TMA and bucket them by (octave, 32 px cell), and a row visits only
//   its window's buckets in its octave range. Each lane keeps its least key
//   dist * M + col (unique per column, so the key order is the reference's
//   tie rule) and the second-least distance among its other candidates, of
//   any octave; two warp minimums give best, column and second. Targets come
//   in tiles of kTile with the row's pair carried between tiles in an
//   (N, 2) scratch, so any M whose key fits in int32 is taken.
// - the node form (`orb_node_best_two`, BoW-bucket matching): a pair is a
//   candidate iff node_a == node_b, node_a >= 0 and both are valid. A CTA's
//   warps take one row each; the CTA stages tiles of kNodeTile targets'
//   node ids (-1 where the target is invalid, which no live row matches)
//   and descriptors (words 0-3 and 4-7 in two arrays, so a warp's 16-byte
//   reads are conflict-free) in shared memory, and each lane walks its
//   columns with no global load, testing the node before the XOR and
//   popcount. The row's state stays in registers across tiles.
//
// Bound (the motion-model search at N = M = 2048): the sources' and
// targets' geometry and the candidates' descriptors, ~0.1 MB; the kernel
// is bound by latency (staging, sort, a row's few buckets). The node form
// on the tracking fallback (every node 0) is a dense compare of the valid
// features: 8 popcounts a pair.
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "bucket_search.cuh"

namespace {

using namespace bucket;

template <bool kTiled>
__global__ void __launch_bounds__(kThreads)
window_best_two_kernel(const float2* __restrict__ uv, const float* __restrict__ radius,
                       const int* __restrict__ src_level, const float* __restrict__ src_ur,
                       const uint8_t* __restrict__ src_valid, const uint4* __restrict__ src_desc,
                       int n, const float2* __restrict__ kp_xy, const int* __restrict__ kp_level,
                       const float* __restrict__ kp_ur, const uint8_t* __restrict__ kp_valid,
                       const uint4* __restrict__ kp_desc, int m, long long dlo, long long dhi,
                       int* __restrict__ best, int* __restrict__ idx, int* __restrict__ second,
                       int2* __restrict__ carry) {
  extern __shared__ __align__(16) char sm[];
  __shared__ TileShared sh;
  const int tiles = kTiled ? (m + kTile - 1) / kTile : 1;
  const Layout lay(kTiled ? kTile : m);
  uint64_t* bar = init_barrier(sm);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int t = 0; t < tiles; ++t) {
    const int c0 = t * kTile, nt = min(kTile, m - c0);
    const bool last = t == tiles - 1;
    const Tile T = stage_tile(sm, lay, bar, sh, t, nt, kp_xy + c0, kp_level + c0, kp_ur + c0,
                              kp_valid + c0);

    // rows, one warp each, the same rows in every tile
    for (int row = blockIdx.x * kWarps + warp; row < n; row += gridDim.x * kWarps) {
      if (!src_valid[row]) {
        if (last && lane == 0) best[row] = kBig, idx[row] = 0, second[row] = kBig;
        continue;
      }
      const float2 puv = uv[row];
      const float u = puv.x, v = puv.y, r = radius[row], sur = src_ur[row];
      const long long lo = src_level[row] + dlo, hi = src_level[row] + dhi;
      const uint4 a0 = __ldg(src_desc + 2 * row), a1 = __ldg(src_desc + 2 * row + 1);
      int k1 = INT_MAX, d2 = kBig;
      // the gate of window_candidates (ops/cuda_match.py), then the state;
      // col is the tile's column, c0 + col the target's
      visit_window(T, lane, nt, u, v, r, lo, hi, [&](int col) {
        if (!T.valid[col]) return;
        const float2 k = T.xy[col];
        if (!(fabsf(u - k.x) < r) || !(fabsf(v - k.y) < r)) return;
        const int kl = T.level[col];
        if (kl < lo || kl > hi) return;
        const float kur = T.ur[col];
        if ((sur >= 0.f && kur >= 0.f) && !(fabsf(sur - kur) < r)) return;
        const int d = hamming(a0, a1, kp_desc + 2 * (c0 + col));
        take(k1, d2, d * m + c0 + col, d, m);
      });
      const int K1 = warp_min(k1);
      // the best's lane offers its second-least distance, every other lane
      // the distance of its least key
      int D2 = warp_min(k1 == K1 ? d2 : key_dist(k1, m));
      if (lane != 0) continue;
      int key = K1;
      if (kTiled) {
        if (t > 0) {
          const int2 c = carry[row];
          merge(key, D2, c.x, c.y, m);
        }
        if (!last) {
          carry[row] = make_int2(key, D2);
          continue;
        }
      }
      if (key == INT_MAX) {
        best[row] = kBig, idx[row] = 0, second[row] = kBig;
      } else {
        const int b = key / m;
        best[row] = b, idx[row] = key - b * m, second[row] = D2;
      }
    }
    __syncthreads();                               // the tile's shared memory is free
  }
}

constexpr int kNodeWarps = 16;     // rows per CTA, one a warp
constexpr int kNodeTile = 2048;    // targets staged at once: 36 bytes each

__global__ void __launch_bounds__(32 * kNodeWarps)
node_best_two_kernel(const uint4* __restrict__ desc_a, const int* __restrict__ node_a,
                     const uint8_t* __restrict__ valid_a, int n,
                     const uint4* __restrict__ desc_b, const int* __restrict__ node_b,
                     const uint8_t* __restrict__ valid_b, int m, int* __restrict__ best,
                     int* __restrict__ idx, int* __restrict__ second) {
  extern __shared__ __align__(16) char sm[];
  uint4* s_lo = reinterpret_cast<uint4*>(sm);     // words 0-3 of each staged target
  uint4* s_hi = s_lo + kNodeTile;                 // words 4-7
  int* s_node = reinterpret_cast<int*>(s_hi + kNodeTile);
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kNodeWarps + (threadIdx.x >> 5);
  const bool live = row < n && valid_a[row] && node_a[row] >= 0;   // uniform across the warp
  const int na = live ? node_a[row] : -1;
  uint4 a0 = make_uint4(0u, 0u, 0u, 0u), a1 = a0;
  if (live) a0 = __ldg(desc_a + 2 * row), a1 = __ldg(desc_a + 2 * row + 1);
  int k1 = INT_MAX, d2 = kBig;
  if (__syncthreads_or(live)) {                   // no live row: nothing to stage
    for (int c0 = 0; c0 < m; c0 += kNodeTile) {
      const int nt = min(kNodeTile, m - c0);
      for (int c = threadIdx.x; c < nt; c += blockDim.x) {
        const int t = c0 + c;
        s_node[c] = valid_b[t] ? node_b[t] : -1;
        s_lo[c] = __ldg(desc_b + 2 * t);
        s_hi[c] = __ldg(desc_b + 2 * t + 1);
      }
      __syncthreads();
      if (live) {
        for (int c = lane; c < nt; c += 32) {
          if (s_node[c] != na) continue;
          const uint4 b0 = s_lo[c], b1 = s_hi[c];
          const int d = __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) +
                        __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
                        __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
          take(k1, d2, d * m + c0 + c, d, m);
        }
      }
      __syncthreads();                             // the tile's shared memory is free
    }
  }
  if (row >= n) return;
  const int K1 = warp_min(k1);
  const int D2 = warp_min(k1 == K1 ? d2 : key_dist(k1, m));
  if (lane == 0) {
    if (K1 == INT_MAX) {
      best[row] = kBig, idx[row] = 0, second[row] = kBig;
    } else {
      const int b = K1 / m;
      best[row] = b, idx[row] = K1 - b * m, second[row] = D2;
    }
  }
}

}  // namespace

// dlo, dhi: the octave offsets of the window form's range [src + dlo,
// src + dhi]; INT_MIN / INT_MAX leave that side open. carry: (n, 2) int32
// scratch, needed (and touched) only when m > kTile.
extern "C" int orb_window_best_two(const void* uv, const void* radius, const void* src_level,
                                   const void* src_ur, const void* src_valid,
                                   const void* src_desc, int n, const void* kp_xy,
                                   const void* kp_level, const void* kp_ur,
                                   const void* kp_valid, const void* kp_desc, int m, int dlo,
                                   int dhi, void* best, void* idx, void* second, void* carry,
                                   void* stream) {
  if (m < 1 || (m > kTile && carry == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = m > kTile ? window_best_two_kernel<true> : window_best_two_kernel<false>;
  dim3 grid;
  int bytes = 0;
  const cudaError_t err = launch_shape(kernel, n, m, grid, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // an open side: a bound past every int32 octave
  const long long lo = dlo == INT_MIN ? -(1LL << 40) : dlo;
  const long long hi = dhi == INT_MAX ? (1LL << 40) : dhi;
  kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(uv), static_cast<const float*>(radius),
      static_cast<const int*>(src_level), static_cast<const float*>(src_ur),
      static_cast<const uint8_t*>(src_valid), static_cast<const uint4*>(src_desc), n,
      static_cast<const float2*>(kp_xy), static_cast<const int*>(kp_level),
      static_cast<const float*>(kp_ur), static_cast<const uint8_t*>(kp_valid),
      static_cast<const uint4*>(kp_desc), m, lo, hi, static_cast<int*>(best),
      static_cast<int*>(idx), static_cast<int*>(second), static_cast<int2*>(carry));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int orb_node_best_two(const void* desc_a, const void* node_a, const void* valid_a,
                                 int n, const void* desc_b, const void* node_b,
                                 const void* valid_b, int m, void* best, void* idx,
                                 void* second, void* stream) {
  if (n < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int bytes = kNodeTile * (32 + 4);
  cudaError_t err = cudaFuncSetAttribute(node_best_two_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kNodeWarps - 1) / kNodeWarps);
  node_best_two_kernel<<<grid, 32 * kNodeWarps, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(desc_a), static_cast<const int*>(node_a),
      static_cast<const uint8_t*>(valid_a), n, static_cast<const uint4*>(desc_b),
      static_cast<const int*>(node_b), static_cast<const uint8_t*>(valid_b), m,
      static_cast<int*>(best), static_cast<int*>(idx), static_cast<int*>(second));
  return static_cast<int>(cudaGetLastError());
}
