// K3: steered BRIEF for every pyramid level of a frame in one launch: for
// each keypoint, rotate the 512 pattern points by its angle, sample the
// blurred level at them, compare the 256 pairs and pack the bits into 8
// 32-bit words.
//
// Replaces: orb_slam2_tpu/ops/pallas_extract.py `brief_sample_pallas` /
// `_brief_kernel` (aligned patch windows + exact one-hot MXU selection,
// because the TPU has no vector gather) together with the pattern rotation
// before it and the compare-and-pack after it in `orient_brief.steered_brief`.
// The spec is the reference's XLA path: offsets rint(px*cos - py*sin) and
// rint(px*sin + py*cos), a flat gather of the clamped sample points, then
// bit b of word w = (sample[w*32+b] < sample[256+w*32+b]).
//
// What bounds it on the card: scattered 4-byte reads (512 per keypoint, all
// within +-19 px of the keypoint, so they hit L1/L2), ~16 bytes in and 32 out
// per keypoint; no arithmetic to speak of. A launch per level paid 8 launches
// a frame, and the (N, 512) offset tables the rotation wrote and the sampler
// read back (4 KB a keypoint) with ~12 small kernels a level to build them.
// Design: one flat grid of warps over the keypoints of all levels, one warp
// per keypoint; each warp finds its level in a table of keypoint ranges
// passed by value with the levels' pointers and sizes (`__grid_constant__`).
// Each block stages the (2, 512) pattern in shared memory (4 KB). For each
// word, lane b rotates pattern pair w*32+b itself and __ballot_sync
// assembles the word in one instruction, so neither offsets nor samples
// leave registers and the output is the packed (N, 8) words. The cosine and
// sine of each angle come in from the caller (`torch.cos`/`torch.sin`, one
// kernel each per frame), as the twin computes them. The rotation is written
// with __fmul_rn/__fsub_rn/__fadd_rn, so nvcc cannot contract it into FMAs,
// and rounded by __float2int_rn (half to even, as torch.round): the offsets
// equal `orient_brief.rotated_offsets` bit for bit. Every sample coordinate
// is clamped into its level, as in the twin, so no level size (however
// narrow) and no keypoint position can read out of bounds.
#include <cuda_runtime.h>

namespace {

constexpr int kPairs = 256;
constexpr int kWarpsPerBlock = 8;
constexpr int kMaxLevels = 16;

struct BriefLevel {
  const float* blur;             // (h, w) float32
  int h, w;
  int kp0;                       // the level's first keypoint
};

struct BriefLevels {             // passed by value: kMaxLevels * 24 + 4 bytes
  BriefLevel lv[kMaxLevels];
  int n;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
brief_kernel(const __grid_constant__ BriefLevels L, const int* __restrict__ ys,
             const int* __restrict__ xs, const float* __restrict__ ca,
             const float* __restrict__ sa, const float* __restrict__ points, int n_kp,
             int* __restrict__ out) {
  __shared__ float s_px[2 * kPairs], s_py[2 * kPairs];
  for (int i = threadIdx.x; i < 2 * kPairs; i += blockDim.x) {
    s_px[i] = __ldg(points + i);
    s_py[i] = __ldg(points + 2 * kPairs + i);
  }
  __syncthreads();
  const int kp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (kp >= n_kp) return;        // uniform across the warp: the ballot stays full
  int l = 0;
  while (l + 1 < L.n && kp >= L.lv[l + 1].kp0) ++l;
  const BriefLevel& lv = L.lv[l];
  const float* __restrict__ blur = lv.blur;
  const int h = lv.h, w = lv.w;
  const int y = __ldg(ys + kp), x = __ldg(xs + kp);
  const float c = __ldg(ca + kp), s = __ldg(sa + kp);
  // the blurred level at pattern point p rotated by the keypoint's angle
  auto sample = [&](int p) {
    const float px = s_px[p], py = s_py[p];
    const int dx = __float2int_rn(__fsub_rn(__fmul_rn(px, c), __fmul_rn(py, s)));
    const int dy = __float2int_rn(__fadd_rn(__fmul_rn(px, s), __fmul_rn(py, c)));
    const int yy = clampi(y + dy, 0, h - 1), xx = clampi(x + dx, 0, w - 1);
    return __ldg(blur + static_cast<size_t>(yy) * w + xx);
  };
#pragma unroll
  for (int wd = 0; wd < 8; ++wd) {
    const int p = wd * 32 + lane;
    const bool bit = sample(p) < sample(kPairs + p);
    const unsigned word = __ballot_sync(0xffffffffu, bit);
    if (lane == 0) out[static_cast<size_t>(kp) * 8 + wd] = static_cast<int>(word);
  }
}

}  // namespace

// n levels; blurs: n host pointers to (h, w) float32 levels; dims: (h, w,
// keypoints) per level (host ints); ys, xs (N,) int32, ca, sa (N,) float32
// for the levels' keypoints one level after another (N = the sum of the
// counts, N > 0); points (2, 512) float32; out (N, 8) int32 (the bits of the
// uint32 descriptor words).
extern "C" int orb_brief_levels(int n, const unsigned long long* blurs, const int* dims,
                                const int* ys, const int* xs, const float* ca,
                                const float* sa, const float* points, int* out, void* stream) {
  if (n < 1 || n > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  BriefLevels L{};
  L.n = n;
  int n_kp = 0;
  for (int l = 0; l < n; ++l) {
    BriefLevel& lv = L.lv[l];
    lv.blur = reinterpret_cast<const float*>(blurs[l]);
    lv.h = dims[3 * l], lv.w = dims[3 * l + 1];
    lv.kp0 = n_kp;
    if (lv.h < 1 || lv.w < 1 || dims[3 * l + 2] < 0) return static_cast<int>(cudaErrorInvalidValue);
    n_kp += dims[3 * l + 2];
  }
  if (n_kp < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((n_kp + kWarpsPerBlock - 1) / kWarpsPerBlock);
  brief_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(L, ys, xs, ca, sa, points,
                                                                      n_kp, out);
  return static_cast<int>(cudaGetLastError());
}
