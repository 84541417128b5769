// K8: epipolar-gated Hamming argmin of triangulation (replaces
// orb_slam2_tpu/ops/pallas_kernels.py `epi_best_two_pallas`,
// `_epi_match_kernel`; SearchForTriangulation, src/ORBmatcher.cc:1006-1116).
//
// For each covisible neighbour b and each feature i of the new keyframe: the
// candidates j among the neighbour's N features are those unbound on both
// sides, far enough from the epipole, and within the epipolar band
//   num = la*x2 + lb*y2 + lc,  den = max(la*la + lb*lb, 1e-12),
//   num*num / den < sig          (sig = 3.84 sigma^2 of j's octave),
// and the output is the least Hamming distance among them and its column
// (the lowest wins a tie); a row with no candidate gives BIG = 512 and 0.
//
// The gate is the XLA path's (mapping_ops._triangulate_decide), not the
// Pallas kernel's `num*num < sig*den`, which flips at rounding boundaries.
// This file is built with -fmad=false (ops/_build.py SOURCE_FLAGS) and divides
// with IEEE division, so each float32 operation rounds as in the twin and the
// result is bit-exact.
//
// Bound: the gate is needed only on pairs unbound on both sides and far from
// the epipole. On a keyframe event of the main path (B = 10 neighbours,
// N = 2048) that is a few tens of kf1 features against a few hundred per
// neighbour, ~0.2M gates of ~9 float32 operations (~0.03 us), and ~0.3 MB
// that the function needs (the masks, those features' lines, positions and
// descriptors, the outputs; ~0.09 us at 3.35 TB/s) of the 1.4 MB it is
// handed. Design: one warp per (b, i) row, as K4; the row's
// line, descriptor and mask in registers, lanes striding over the N targets
// (coalesced reads of the neighbour's per-feature arrays, which stay in L2);
// the cheap byte masks first, the gate next, the 8-word XOR + popcount only
// for candidates. Each lane keeps its least key dist * N + col; a shuffle
// minimum gives best and column. No shared memory.
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kBig = 512;
constexpr int kWarps = 8;   // rows per block

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(32 * kWarps)
epi_match_kernel(const uint4* __restrict__ desc1, const uint8_t* __restrict__ un1,
                 const float* __restrict__ la, const float* __restrict__ lb,
                 const float* __restrict__ lc, const uint4* __restrict__ desc2,
                 const float2* __restrict__ xy2, const uint8_t* __restrict__ un2,
                 const float* __restrict__ sig, const uint8_t* __restrict__ far,
                 int n_nb, int n, int* __restrict__ best, int* __restrict__ idx) {
  const int lane = threadIdx.x & 31;
  const long row = static_cast<long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= static_cast<long>(n_nb) * n) return;          // uniform across the warp
  const int b = static_cast<int>(row / n), i = static_cast<int>(row - static_cast<long>(b) * n);
  int kmin = kBig * n;                                     // no candidate: BIG, column 0
  if (un1[i]) {                                            // uniform across the warp
    const uint4 a0 = __ldg(desc1 + 2 * i), a1 = __ldg(desc1 + 2 * i + 1);
    const float l_a = la[row], l_b = lb[row], l_c = lc[row];
    const float s = l_a * l_a + l_b * l_b;
    const float den = s < 1e-12f ? 1e-12f : s;             // max(s, 1e-12), NaN kept
    const size_t base = static_cast<size_t>(b) * n;
    int k1 = INT_MAX;
    for (int col = lane; col < n; col += 32) {
      const size_t t = base + col;
      int key = kBig * n + col;
      if (un2[t] && far[t]) {
        const float2 p = __ldg(xy2 + t);
        const float num = l_a * p.x + l_b * p.y + l_c;
        if (num * num / den < sig[t]) {
          const uint4 b0 = __ldg(desc2 + 2 * t), b1 = __ldg(desc2 + 2 * t + 1);
          const int d = __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) +
                        __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
                        __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
          key = d * n + col;
        }
      }
      k1 = min(k1, key);
    }
    kmin = warp_min(k1);
  }
  if (lane == 0) {
    const int d = kmin / n;
    best[row] = d;
    idx[row] = kmin - d * n;
  }
}

}  // namespace

extern "C" int orb_epi_match(const void* desc1, const void* un1, const void* la,
                             const void* lb, const void* lc, const void* desc2,
                             const void* xy2, const void* un2, const void* sig,
                             const void* far, int n_nb, int n, void* best, void* idx,
                             void* stream) {
  const long rows = static_cast<long>(n_nb) * n;
  const dim3 grid(static_cast<unsigned>((rows + kWarps - 1) / kWarps));
  epi_match_kernel<<<grid, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(desc1), static_cast<const uint8_t*>(un1),
      static_cast<const float*>(la), static_cast<const float*>(lb),
      static_cast<const float*>(lc), static_cast<const uint4*>(desc2),
      static_cast<const float2*>(xy2), static_cast<const uint8_t*>(un2),
      static_cast<const float*>(sig), static_cast<const uint8_t*>(far), n_nb, n,
      static_cast<int*>(best), static_cast<int*>(idx));
  return static_cast<int>(cudaGetLastError());
}
