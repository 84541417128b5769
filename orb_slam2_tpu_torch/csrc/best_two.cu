// K4: masked Hamming best / second best (replaces
// orb_slam2_tpu/ops/pallas_kernels.py `masked_best_two_pallas`,
// `_best_two_kernel`).
//
// For each source row: the Hamming distance (8-word XOR + popcount) to each
// of M targets where the (N, M) candidate mask allows it (BIG = 512
// elsewhere), then the best distance, the best column (the lowest wins a
// tie) and the second best with the best column excluded.
//
// Bound: at N = M = 2048 (the motion-model search) the mask is 4 MB and is
// read once; every warp reads the 64 KB target table, which stays in L2.
// Design: one warp per source row, lanes striding over the targets (mask
// reads coalesced), the source descriptor in registers. Each lane keeps its
// two least keys dist * M + col (unique per column, so the key order is the
// reference's tie rule; 512 * 8192 < 2^31); two warp-shuffle minimums give
// the best key and the least key of the rest. No shared memory.
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kBig = 512;
constexpr int kWarps = 8;   // source rows per block

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

__global__ void __launch_bounds__(32 * kWarps)
best_two_kernel(const uint4* __restrict__ desc_a, int n, const uint4* __restrict__ desc_b,
                int m, const uint8_t* __restrict__ mask, int* __restrict__ best,
                int* __restrict__ idx, int* __restrict__ second) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;                      // uniform across the warp
  const uint4 a0 = __ldg(desc_a + 2 * row), a1 = __ldg(desc_a + 2 * row + 1);
  const uint8_t* mrow = mask + static_cast<size_t>(row) * m;
  int k1 = INT_MAX, k2 = INT_MAX;            // this lane's least two keys
  for (int col = lane; col < m; col += 32) {
    const int d = mrow[col] ? hamming(a0, a1, desc_b + 2 * col) : kBig;
    const int key = d * m + col;
    if (key < k1) {
      k2 = k1;
      k1 = key;
    } else if (key < k2) {
      k2 = key;
    }
  }
  const int kmin = warp_min(k1);
  // the lane that holds the best offers its second key, every other its best
  const int kmin2 = warp_min(k1 == kmin ? k2 : k1);
  if (lane == 0) {
    const int b = kmin / m;
    best[row] = b;
    idx[row] = kmin - b * m;
    second[row] = kmin2 >= kBig * m ? kBig : kmin2 / m;
  }
}

}  // namespace

extern "C" int orb_best_two(const void* desc_a, int n, const void* desc_b, int m,
                            const void* mask, void* best, void* idx, void* second,
                            void* stream) {
  const dim3 grid((n + kWarps - 1) / kWarps);
  best_two_kernel<<<grid, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(desc_a), n, static_cast<const uint4*>(desc_b), m,
      static_cast<const uint8_t*>(mask), static_cast<int*>(best), static_cast<int*>(idx),
      static_cast<int*>(second));
  return static_cast<int>(cudaGetLastError());
}
