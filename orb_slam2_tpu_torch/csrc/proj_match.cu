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
// P = 8192 x N = 2048), ~8 M operations, ~0.12 us, above the ~0.2 MB the
// function needs of the 0.6 MB it is handed; the targets (56 KB of
// coordinates, levels and flags, 64 KB of descriptors) stay in L2 and the
// (P, N) mask is never written.
// Design: one warp per map point, lanes striding over the keypoints, the
// gate computed from the inputs with the twin's exact float compares (no
// arithmetic besides subtraction, so bit-exact), a popcount only for
// candidates. Pass 1 reduces the key dist * N + col with warp shuffles;
// pass 2 revisits the best's octave for the second best.
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kBig = 512;
constexpr int kWarps = 8;   // map points per block

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

struct Source {
  float u, v, r, ur;
  int level;
};

// the candidate gate of projection_candidates (ops/cuda_match.py)
__device__ __forceinline__ bool candidate(const Source& s, const float2* __restrict__ kp_xy,
                                          const int* __restrict__ kp_level,
                                          const float* __restrict__ kp_ur,
                                          const uint8_t* __restrict__ kp_valid, int col) {
  if (!kp_valid[col]) return false;
  const float2 k = __ldg(kp_xy + col);
  if (!(fabsf(s.u - k.x) < s.r) || !(fabsf(s.v - k.y) < s.r)) return false;
  const int kl = __ldg(kp_level + col);
  if (kl < s.level - 1 || kl > s.level) return false;
  const float kur = __ldg(kp_ur + col);
  return !(s.ur >= 0.f && kur >= 0.f) || fabsf(s.ur - kur) < s.r;
}

__global__ void __launch_bounds__(32 * kWarps)
proj_match_kernel(const float2* __restrict__ uv, const float* __restrict__ radius,
                  const int* __restrict__ pred_level, const float* __restrict__ p_ur,
                  const uint8_t* __restrict__ p_valid, const uint4* __restrict__ p_desc,
                  int p, const float2* __restrict__ kp_xy, const int* __restrict__ kp_level,
                  const float* __restrict__ kp_ur, const uint8_t* __restrict__ kp_valid,
                  const uint4* __restrict__ kp_desc, int n, int* __restrict__ best,
                  int* __restrict__ idx, int* __restrict__ second) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= p) return;                      // uniform across the warp
  const float2 puv = uv[row];
  const Source s{puv.x, puv.y, radius[row], p_ur[row], pred_level[row]};
  const bool valid = p_valid[row] != 0;
  const uint4 a0 = __ldg(p_desc + 2 * row), a1 = __ldg(p_desc + 2 * row + 1);

  int k1 = INT_MAX;
  for (int col = lane; col < n; col += 32) {
    const bool c = valid && candidate(s, kp_xy, kp_level, kp_ur, kp_valid, col);
    const int d = c ? hamming(a0, a1, kp_desc + 2 * col) : kBig;
    k1 = min(k1, d * n + col);
  }
  const int kmin = warp_min(k1);
  const int b = kmin / n;
  const int bidx = kmin - b * n;
  const int best_level = __ldg(kp_level + bidx);

  int s2 = kBig;
  if (valid) {
    for (int col = lane; col < n; col += 32) {
      if (col == bidx || __ldg(kp_level + col) != best_level) continue;
      if (candidate(s, kp_xy, kp_level, kp_ur, kp_valid, col))
        s2 = min(s2, hamming(a0, a1, kp_desc + 2 * col));
    }
  }
  s2 = warp_min(s2);
  if (lane == 0) {
    best[row] = b;
    idx[row] = bidx;
    second[row] = s2;
  }
}

}  // namespace

extern "C" int orb_proj_match(const void* uv, const void* radius, const void* pred_level,
                              const void* p_ur, const void* p_valid, const void* p_desc,
                              int p, const void* kp_xy, const void* kp_level,
                              const void* kp_ur, const void* kp_valid, const void* kp_desc,
                              int n, void* best, void* idx, void* second, void* stream) {
  const dim3 grid((p + kWarps - 1) / kWarps);
  proj_match_kernel<<<grid, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(uv), static_cast<const float*>(radius),
      static_cast<const int*>(pred_level), static_cast<const float*>(p_ur),
      static_cast<const uint8_t*>(p_valid), static_cast<const uint4*>(p_desc), p,
      static_cast<const float2*>(kp_xy), static_cast<const int*>(kp_level),
      static_cast<const float*>(kp_ur), static_cast<const uint8_t*>(kp_valid),
      static_cast<const uint4*>(kp_desc), n, static_cast<int*>(best),
      static_cast<int*>(idx), static_cast<int*>(second));
  return static_cast<int>(cudaGetLastError());
}
