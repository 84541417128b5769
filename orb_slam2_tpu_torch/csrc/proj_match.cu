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
// Design: the bucketed window search of bucket_search.cuh (persistent CTAs,
// one per SM, each staging the keypoints by TMA and bucketing them by
// (level, 32 px cell); a row visits only its window's buckets, here at
// octaves pred - 1 and pred, and decides every pair by the twin's exact
// float compares), with warps taking rows in a grid-stride loop.
// One pass: a candidate's octave is pred - 1 or pred, so each lane keeps,
// per octave, its least key and the second-least distance among its own
// candidates of that octave; the second best is then one warp minimum (the
// best's lane gives its second-least distance, every other lane the
// distance of its least key at the best's octave). Descriptors stay in
// global memory and are read only for candidates.
// Any number of keypoints: each CTA walks them in tiles of kTile, its warps
// on the same rows in every tile. The key stays dist * N + column over all
// N, so ties go to the lowest column across tiles. With more than one tile,
// each row reduces its lanes to one (least key, second-least distance) pair
// per octave at the end of a tile and merges it with the pair carried from
// the earlier tiles. The carried pairs (4 int32 a row) live in a (P, 4)
// scratch that only the row's own warp (its lane 0) reads and writes, so no
// CTA waits on another. With one tile (N <= kTile) the kernel's untiled
// instance runs: no scratch, no merge.
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "bucket_search.cuh"

namespace {

using namespace bucket;

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
  __shared__ TileShared sh;
  const int tiles = kTiled ? (n + kTile - 1) / kTile : 1;
  const Layout lay(kTiled ? kTile : n);
  uint64_t* bar = init_barrier(sm);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int t = 0; t < tiles; ++t) {
    const int c0 = t * kTile, nt = min(kTile, n - c0);
    const bool last = t == tiles - 1;
    const Tile T = stage_tile(sm, lay, bar, sh, t, nt, kp_xy + c0, kp_level + c0, kp_ur + c0,
                              kp_valid + c0);

    // rows, one warp each, the same rows in every tile
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
      visit_window(T, lane, nt, u, v, r, pred - 1LL, pred, [&](int col) {
        if (!T.valid[col]) return;
        const float2 k = T.xy[col];
        if (!(fabsf(u - k.x) < r) || !(fabsf(v - k.y) < r)) return;
        const int kl = T.level[col];
        if (kl < pred - 1 || kl > pred) return;
        const float kur = T.ur[col];
        if ((pur >= 0.f && kur >= 0.f) && !(fabsf(pur - kur) < r)) return;
        const int d = hamming(a0, a1, kp_desc + 2 * (c0 + col));
        if (kl == pred) take(k1b, d2b, d * n + c0 + col, d, n);
        else take(k1a, d2a, d * n + c0 + col, d, n);
      });
      if (!kTiled) {
        const int kmin = warp_min(min(k1a, k1b));
        int b = kBig, bidx = 0, s2 = kBig;
        if (kmin != INT_MAX) {
          b = kmin / n;
          bidx = kmin - b * n;
          const bool at_pred = T.level[bidx] == pred;
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
  const auto kernel = n > kTile ? proj_match_kernel<true> : proj_match_kernel<false>;
  dim3 grid;
  int bytes = 0;
  const cudaError_t err = launch_shape(kernel, p, n, grid, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
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
