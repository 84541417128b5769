// K8: the epipolar search of a keyframe event, from the map's rows
// (replaces orb_slam2_tpu/ops/pallas_kernels.py `epi_best_two_pallas`,
// `_epi_match_kernel`, with the per-feature glue of
// orb_slam2_tpu/pipeline/mapping_ops.py `_epi_match_batch`;
// SearchForTriangulation, src/ORBmatcher.cc:1006-1116).
//
// For each covisible neighbour b (map row kf2[b]) and each feature i of the
// new keyframe (row kf1): the candidates j among the neighbour's N features
// are those unbound on both sides (kf_obs < 0 and valid), far enough from
// the epipole e_b, dx*dx + dy*dy >= 100 * scale_factor[lvl_j], and within
// the epipolar band of i's line in the neighbour, (la, lb, lc) = F_b [x1; 1]:
//   num = la*x2 + lb*y2 + lc,  den = max(la*la + lb*lb, 1e-12),
//   num*num / den < sig_j       (sig_j = 3.84 sigma2[lvl_j]),
// with lvl_j the octave clamped to [0, levels - 1]. The output is the least
// Hamming distance among them and its column (the lowest wins a tie); a row
// with no candidate gives BIG = 512 and 0. Torch computes only F (B, 3, 3),
// the epipoles (B, 2) and the neighbour rows; everything per feature is
// computed here, from the map's arrays.
//
// The gate is the XLA path's (mapping_ops._triangulate_decide), not the
// Pallas kernel's `num*num < sig*den`, which flips at rounding boundaries.
// This file is built with -fmad=false (ops/_build.py SOURCE_FLAGS) and divides
// with IEEE division, so each float32 operation rounds as in the twin
// (cuda_match.epi_match_keyframes_plain) and the result is bit-exact.
//
// Bound: on a keyframe event of the main path (B = 10 neighbours, N = 2048)
// a few tens of kf1 features are unbound against a few hundred unbound, far
// features per neighbour; the function needs the two masks' rows, those
// features' positions, octaves and descriptors and the outputs (~0.3 MB,
// ~0.1 us at 3.35 TB/s), and ~0.2 M gates. It is bound by latency.
// Design: a CTA per (neighbour, chunk of kRows kf1 features).
// 1. It compacts its chunk's unbound rows, with their positions and
//    descriptors, into shared memory (block ballot and prefix sum); a chunk
//    with none writes BIG / 0 and exits.
// 2. It compacts the neighbour's unbound, far columns in column order, with
//    their position, sig and descriptor (words 0-3 and 4-7 in two arrays),
//    in chunks of kCols columns: the flags, positions and octaves of a
//    chunk's four passes are loaded before the passes' ranks, and the
//    descriptors after them, so a chunk waits on three loads in a row, not
//    twelve (the kernel is bound by such chains, not by bytes).
// 3. Warps take rows: the row's line from F and its position, then the
//    compacted columns, with no global load. Each lane keeps its least key
//    dist * N + col (the original column, so the lowest column wins a tie);
//    a shuffle minimum gives the row's key for the chunk, carried in shared
//    memory to the next column chunk.
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kBig = 512;
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 128;           // kf1 features per CTA
constexpr int kCols = 2048;          // neighbour features compacted at once: 48 bytes each
constexpr int kMaxLevels = 32;

struct Levels {                      // passed by value: the octave tables
  float sigma2[kMaxLevels], scale[kMaxLevels];
  int n;
};

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// An ordered compaction step of the block: each thread's flag, its position
// among the flagged threads before it, and the block's count (in *total).
__device__ __forceinline__ int block_rank(bool flag, int* warp_counts, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned bits = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) warp_counts[warp] = __popc(bits);
  __syncthreads();
  int base = 0, sum = 0;
  for (int w = 0; w < kWarps; ++w) {
    base += w < warp ? warp_counts[w] : 0;
    sum += warp_counts[w];
  }
  *total = sum;
  __syncthreads();                   // warp_counts may be reused
  return base + __popc(bits & ((1u << lane) - 1u));
}

__global__ void __launch_bounds__(kThreads)
epi_match_kernel(const __grid_constant__ Levels L, const int* __restrict__ kf_obs,
                 const uint8_t* __restrict__ kf_valid, const float2* __restrict__ kf_xy,
                 const uint4* __restrict__ kf_desc, const int* __restrict__ kf_level,
                 const long long* __restrict__ kf1_at, const long long* __restrict__ kf2,
                 const float* __restrict__ F, const float2* __restrict__ epi, int n,
                 int* __restrict__ best, int* __restrict__ idx) {
  extern __shared__ __align__(16) char sm[];
  uint4* s_lo = reinterpret_cast<uint4*>(sm);             // descriptor words 0-3
  uint4* s_hi = s_lo + kCols;                             // words 4-7
  float2* s_xy = reinterpret_cast<float2*>(s_hi + kCols);
  float* s_sig = reinterpret_cast<float*>(s_xy + kCols);
  int* s_col = reinterpret_cast<int*>(s_sig + kCols);
  __shared__ uint4 s_d1[2 * kRows];                       // the unbound rows' descriptors
  __shared__ float2 s_x1[kRows];                          // and positions
  __shared__ int s_rows[kRows], s_key[kRows], s_warp[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, r0 = blockIdx.x * kRows;
  const size_t base1 = static_cast<size_t>(*kf1_at) * n, base2 = static_cast<size_t>(kf2[b]) * n;
  int* out_best = best + static_cast<size_t>(b) * n;
  int* out_idx = idx + static_cast<size_t>(b) * n;
  float f[9];                                             // loads in flight with the rows'
#pragma unroll
  for (int k = 0; k < 9; ++k) f[k] = F[9 * b + k];
  const float2 e = epi[b];

  // 1. the chunk's unbound kf1 features, in order, with their position and
  // descriptor (loaded with the flags, so no later load waits on them)
  const int i = r0 + tid;
  const bool in = tid < kRows && i < n;
  float2 x1 = make_float2(0.f, 0.f);
  uint4 d0 = make_uint4(0u, 0u, 0u, 0u), d1 = d0;
  bool un = false;
  if (in) {
    x1 = kf_xy[base1 + i];
    d0 = __ldg(kf_desc + 2 * (base1 + i)), d1 = __ldg(kf_desc + 2 * (base1 + i) + 1);
    const int obs = kf_obs[base1 + i];
    un = (obs < 0) & (kf_valid[base1 + i] != 0);
    if (!un) out_best[i] = kBig, out_idx[i] = 0;
  }
  int nr;
  const int rank = block_rank(un, s_warp, &nr);
  if (un) {
    s_rows[rank] = i, s_key[rank] = INT_MAX, s_x1[rank] = x1;
    s_d1[2 * rank] = d0, s_d1[2 * rank + 1] = d1;
  }
  if (nr == 0) return;                                    // uniform across the block

  for (int c0 = 0; c0 < n; c0 += kCols) {
    // 2. the neighbour's unbound far features of this chunk, in column
    // order: every pass's flags, positions and octaves loaded first, then
    // the passes' ranks, then the kept features' descriptors
    constexpr int kPass = kCols / kThreads;
    const int c1 = min(c0 + kCols, n);
    bool keep[kPass];
    float2 p[kPass];
    float sg[kPass];
#pragma unroll
    for (int k = 0; k < kPass; ++k) {
      const int c = c0 + k * kThreads + tid;
      keep[k] = false, p[k] = make_float2(0.f, 0.f), sg[k] = 0.f;
      if (c < c1) {                                       // four loads issued together
        const int obs = kf_obs[base2 + c], lvl = kf_level[base2 + c];
        const bool valid = kf_valid[base2 + c] != 0;
        p[k] = kf_xy[base2 + c];
        if (obs < 0 && valid) {
          const int l = min(max(lvl, 0), L.n - 1);
          const float dx = p[k].x - e.x, dy = p[k].y - e.y;
          keep[k] = dx * dx + dy * dy >= 100.f * L.scale[l];
          sg[k] = 3.84f * L.sigma2[l];
        }
      }
    }
    int at[kPass], nc = 0;
#pragma unroll
    for (int k = 0; k < kPass; ++k) {
      int count;
      at[k] = nc + block_rank(keep[k], s_warp, &count);
      nc += count;
    }
#pragma unroll
    for (int k = 0; k < kPass; ++k) {
      if (!keep[k]) continue;
      const size_t t = base2 + c0 + k * kThreads + tid;
      s_lo[at[k]] = __ldg(kf_desc + 2 * t), s_hi[at[k]] = __ldg(kf_desc + 2 * t + 1);
      s_xy[at[k]] = p[k], s_sig[at[k]] = sg[k];
      s_col[at[k]] = c0 + k * kThreads + tid;
    }
    __syncthreads();

    // 3. rows, one warp each, against the compacted columns: no global load
    for (int j = warp; j < nr; j += kWarps) {
      const float2 q1 = s_x1[j];
      // the line F [x1; 1] in the twin's order: (x1*f0 + y1*f1) + f2
      const float la = q1.x * f[0] + q1.y * f[1] + f[2];
      const float lb = q1.x * f[3] + q1.y * f[4] + f[5];
      const float lc = q1.x * f[6] + q1.y * f[7] + f[8];
      const float ss = la * la + lb * lb;
      const float den = ss < 1e-12f ? 1e-12f : ss;        // max(ss, 1e-12), NaN kept
      const uint4 a0 = s_d1[2 * j], a1 = s_d1[2 * j + 1];
      int k1 = INT_MAX;
      for (int q = lane; q < nc; q += 32) {
        const float2 xy = s_xy[q];
        const float num = la * xy.x + lb * xy.y + lc;
        if (num * num / den < s_sig[q]) {
          const uint4 b0 = s_lo[q], b1 = s_hi[q];
          const int d = __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) +
                        __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
                        __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
          k1 = min(k1, d * n + s_col[q]);
        }
      }
      k1 = warp_min(k1);
      if (lane == 0) s_key[j] = min(s_key[j], k1);
    }
    __syncthreads();                                      // the chunk's shared memory is free
  }

  for (int j = tid; j < nr; j += kThreads) {
    const int key = s_key[j], row = s_rows[j];
    const int d = key == INT_MAX ? kBig : key / n;
    out_best[row] = d;
    out_idx[row] = key == INT_MAX ? 0 : key - d * n;
  }
}

}  // namespace

// kf_*: the map's (K, n, ...) keyframe arrays; kf1: a device int64, the new
// keyframe's row; kf2: (n_nb,) device int64 rows of the neighbours; F:
// (n_nb, 3, 3) float32; epi: (n_nb, 2) float32 epipoles; sigma2, scale:
// host float32 tables of `levels` octaves.
extern "C" int orb_epi_match(const float* sigma2, const float* scale, int levels,
                             const void* kf_obs, const void* kf_valid, const void* kf_xy,
                             const void* kf_desc, const void* kf_level, const void* kf1,
                             const void* kf2, const void* F, const void* epi, int n_nb, int n,
                             void* best, void* idx, void* stream) {
  if (levels < 1 || levels > kMaxLevels || n < 1 || n_nb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels L;
  for (int l = 0; l < levels; ++l) L.sigma2[l] = sigma2[l], L.scale[l] = scale[l];
  L.n = levels;
  constexpr int bytes = kCols * (32 + 8 + 4 + 4);
  cudaError_t err = cudaFuncSetAttribute(epi_match_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kRows - 1) / kRows, n_nb);
  epi_match_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      L, static_cast<const int*>(kf_obs), static_cast<const uint8_t*>(kf_valid),
      static_cast<const float2*>(kf_xy), static_cast<const uint4*>(kf_desc),
      static_cast<const int*>(kf_level), static_cast<const long long*>(kf1),
      static_cast<const long long*>(kf2), static_cast<const float*>(F),
      static_cast<const float2*>(epi), n, static_cast<int*>(best), static_cast<int*>(idx));
  return static_cast<int>(cudaGetLastError());
}
