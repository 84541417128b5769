// K2: the dense stage of ORB extraction for every pyramid level of a frame in
// one launch: per level the FAST-9-16 corner score, the low-threshold corner
// mask inside the detection region, 3x3 non-max suppression of the masked
// score (ties kept), the high-threshold flag, and the 9x9 sigma=2 Gaussian
// blur with BORDER_REFLECT_101 that BRIEF samples.
//
// Replaces: orb_slam2_tpu/ops/pallas_extract.py `dense_stage_pallas` /
// `_dense_kernel` (row strips resident in VMEM, lane rolls for the shifts,
// the FAST score in a doubling form over the circle). The spec is the
// reference's XLA path: `fast.fast_score_map` + `fast.compute_candidates`
// (before the per-cell fallback, which stays in PyTorch as
// `candidates_from_dense`) + `image.gaussian_blur`.
//
// What bounds it on the card: it is a stencil, so memory traffic (one f32
// read, three f32 writes per pixel: ~16 MB over the 8 levels of a 640x480
// frame, ~4.5 us at 3.35 TB/s). A launch per level left the seven small
// levels to launch latency and an idle card (level 7 is 54 tiles on 132
// SMs), and the per-arc score spent ~290 min/max per pixel.
// Design: one flat grid over the tiles of all levels. Each block finds its
// level in a prefix table of tile counts passed by value with the levels'
// pointers, sizes and regions (`Levels`, ~1 KB of the 4 KB parameter space;
// `__grid_constant__`, so indexing it by level reads the parameter bank and
// copies nothing to local memory). The block loads its tile plus a 5-pixel
// reflect-101 halo once into shared memory (blur reach 4, FAST circle 3 plus
// 1 for the NMS ring), computes the FAST score on the tile plus a 1-pixel
// ring, the masked score for NMS and the blur's vertical pass into shared
// memory, then writes each pixel's three outputs. The score is the
// reference kernel's doubling form (m2, m4, m8, m9 over the circle, then the
// max over k, for each sign: ~160 min/max), on 32x32 tiles (the 1-px ring
// recomputes 13 % more scores, 32x16 tiles 20 %). Timed on the H100 and
// dropped as slower there (PERF.md): the per-arc score (16 arcs x 16
// min/max), 32x16 and 64x16 tiles, and a segment pre-test that skips the
// score where no adjacent pair of compass points lies beyond +-min_th (a
// warp pays for its slowest pixel on textured frames).
//
// Exactness: subtraction, min and max are exact, so scores equal the twin's
// bit for bit. The blur is the reference's left fold, 9
// vertical taps from tap 0 and then 9 horizontal taps, with
// __fmul_rn/__fadd_rn so nvcc cannot contract to FMA: bit-identical to
// `cuda_extract.dense_stage_plain`. Inside the detection region (>= 19 px
// from every border) the reflected halo and the twin's wrapped rolls read
// the same pixels; outside it the outputs are -inf / 0, as in the twin.
#include <cuda_runtime.h>

namespace {

constexpr int PAD = 5;          // input halo
constexpr int NT = 256;         // threads per block
constexpr int TW = 32, TH = 32; // tile
constexpr int kMaxLevels = 16;

struct Level {
  const float* img;
  float* score_nms;
  float* hi;
  float* blur;
  int h, w;
  int rx0, rx1, ry0, ry1;       // detection region [rx0, rx1) x [ry0, ry1)
  int tiles_x;
  int tile0;                    // the level's first block in the flat grid
};

struct Levels {                 // passed by value: kMaxLevels * 64 + 4 bytes
  Level lv[kMaxLevels];
  int n;
};

// FAST circle of radius 3 in OpenCV order (fast.CIRCLE), (dx, dy)
__constant__ int kCX[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int kCY[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  // halo cells past a tile that overhangs the image are never output; keep
  // their loads in bounds
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// the FAST score, the max over the 16 arcs of 9 of max(min(d), min(-d)), in
// the reference kernel's doubling form: per k, the min of d[k..k+8] as m9 = min(m8[k], d[k+8]) from m2, m4, m8; the dark side from
// the max of d (min9(-d) = -max9(d))
__device__ __forceinline__ float score_doubling(const float (&d)[16]) {
  float m2[16], M2[16], m4[16], M4[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    m2[k] = fminf(d[k], d[(k + 1) & 15]);
    M2[k] = fmaxf(d[k], d[(k + 1) & 15]);
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    m4[k] = fminf(m2[k], m2[(k + 2) & 15]);
    M4[k] = fmaxf(M2[k], M2[(k + 2) & 15]);
  }
  float bright = -INFINITY, dark = INFINITY;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float m8 = fminf(m4[k], m4[(k + 4) & 15]);
    const float M8 = fmaxf(M4[k], M4[(k + 4) & 15]);
    bright = fmaxf(bright, fminf(m8, d[(k + 8) & 15]));
    dark = fminf(dark, fmaxf(M8, d[(k + 8) & 15]));
  }
  return fmaxf(bright, -dark);
}

__global__ void __launch_bounds__(NT)
dense_stage_kernel(const __grid_constant__ Levels L, const float* __restrict__ taps,
                   float ini_th, float min_th) {
  constexpr int IW = TW + 2 * PAD, IH = TH + 2 * PAD;
  constexpr int EW = TW + 2, EH = TH + 2;   // score ring for the 3x3 NMS
  constexpr int BW = TW + 8;                // vertical blur pass width
  __shared__ float s_in[IH][IW];
  __shared__ float s_score[EH][EW];
  __shared__ float s_t[EH][EW];
  __shared__ float s_rows[TH][BW];

  int l = 0;
  while (l + 1 < L.n && static_cast<int>(blockIdx.x) >= L.lv[l + 1].tile0) ++l;
  const Level& lv = L.lv[l];
  const float* __restrict__ img = lv.img;
  const int h = lv.h, w = lv.w;
  const int tile = blockIdx.x - lv.tile0;
  const int y0 = (tile / lv.tiles_x) * TH, x0 = (tile % lv.tiles_x) * TW;
  const int rx0 = lv.rx0, rx1 = lv.rx1, ry0 = lv.ry0, ry1 = lv.ry1;
  const int tid = threadIdx.x;

  float k[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) k[j] = __ldg(taps + j);

  // 1. tile + halo, reflect-101 at the image border
  for (int i = tid; i < IH * IW; i += NT) {
    const int ly = i / IW, lx = i - ly * IW;
    const int gy = reflect101(y0 - PAD + ly, h);
    const int gx = reflect101(x0 - PAD + lx, w);
    s_in[ly][lx] = __ldg(img + static_cast<size_t>(gy) * w + gx);
  }
  __syncthreads();

  // 2a. FAST score on the tile plus a 1-px ring; ring cell (ey, ex) is image
  //     pixel (y0 - 1 + ey, x0 - 1 + ex) = s_in[ey + PAD - 1][ex + PAD - 1]
  for (int i = tid; i < EH * EW; i += NT) {
    const int ey = i / EW, ex = i - ey * EW;
    const int sy = ey + PAD - 1, sx = ex + PAD - 1;
    const int gy = y0 - 1 + ey, gx = x0 - 1 + ex;
    const bool in_reg = gy >= ry0 && gy < ry1 && gx >= rx0 && gx < rx1;
    const float p = s_in[sy][sx];
    float d[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) d[j] = __fsub_rn(s_in[sy + kCY[j]][sx + kCX[j]], p);
    const float score = score_doubling(d);
    s_score[ey][ex] = score;
    s_t[ey][ex] = (in_reg && score > min_th) ? score : 0.0f;
  }

  // 2b. vertical blur pass over the tile rows and 4 columns either side:
  //     s_rows[r][c] at image (y0 + r, x0 - 4 + c)
  for (int i = tid; i < TH * BW; i += NT) {
    const int r = i / BW, c = i - r * BW;
    float acc = __fmul_rn(k[0], s_in[r + PAD - 4][c + PAD - 4]);
#pragma unroll
    for (int j = 1; j < 9; ++j)
      acc = __fadd_rn(acc, __fmul_rn(k[j], s_in[r + PAD - 4 + j][c + PAD - 4]));
    s_rows[r][c] = acc;
  }
  __syncthreads();

  for (int i = tid; i < TW * TH; i += NT) {
    const int ty = i / TW, tx = i - ty * TW;
    const int gy = y0 + ty, gx = x0 + tx;
    if (gy >= h || gx >= w) continue;

    // 3. masked 3x3 NMS (ties kept), thresholds
    const float tc = s_t[ty + 1][tx + 1];
    float neigh = tc;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) neigh = fmaxf(neigh, s_t[ty + dy][tx + dx]);
    const float sc = s_score[ty + 1][tx + 1];
    const bool in_reg = gy >= ry0 && gy < ry1 && gx >= rx0 && gx < rx1;
    const bool lo = in_reg && sc > min_th;
    const size_t o = static_cast<size_t>(gy) * w + gx;
    lv.score_nms[o] = (lo && tc >= neigh) ? sc : -INFINITY;
    lv.hi[o] = (in_reg && sc > ini_th) ? 1.0f : 0.0f;

    // 4. horizontal blur pass
    float acc = __fmul_rn(k[0], s_rows[ty][tx]);
#pragma unroll
    for (int j = 1; j < 9; ++j) acc = __fadd_rn(acc, __fmul_rn(k[j], s_rows[ty][tx + j]));
    lv.blur[o] = acc;
  }
}

}  // namespace

// n levels; per level ptrs[4l..4l+3] = img, score_nms, hi, blur ((h, w)
// float32 each, device) and dims[6l..6l+5] = h, w, min_bx, max_bx, min_by,
// max_by (host arrays); h and w > 5. taps: 9 float32 on the device.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for arguments the
// kernel does not take.
extern "C" int orb_dense_stage_levels(int n, const unsigned long long* ptrs, const int* dims,
                                      const float* taps, float ini_th, float min_th,
                                      void* stream) {
  if (n < 1 || n > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  Levels L{};
  L.n = n;
  int tiles = 0;                // the flat grid: the levels' tiles in order
  for (int l = 0; l < n; ++l) {
    Level& lv = L.lv[l];
    lv.img = reinterpret_cast<const float*>(ptrs[4 * l]);
    lv.score_nms = reinterpret_cast<float*>(ptrs[4 * l + 1]);
    lv.hi = reinterpret_cast<float*>(ptrs[4 * l + 2]);
    lv.blur = reinterpret_cast<float*>(ptrs[4 * l + 3]);
    lv.h = dims[6 * l];
    lv.w = dims[6 * l + 1];
    if (lv.h <= PAD || lv.w <= PAD) return static_cast<int>(cudaErrorInvalidValue);
    // the detection region: [min_b + 3, max_b - 3) in both axes
    lv.rx0 = dims[6 * l + 2] + 3;
    lv.rx1 = dims[6 * l + 3] - 3;
    lv.ry0 = dims[6 * l + 4] + 3;
    lv.ry1 = dims[6 * l + 5] - 3;
    lv.tiles_x = (lv.w + TW - 1) / TW;
    lv.tile0 = tiles;
    tiles += lv.tiles_x * ((lv.h + TH - 1) / TH);
  }
  dense_stage_kernel<<<tiles, NT, 0, static_cast<cudaStream_t>(stream)>>>(L, taps, ini_th,
                                                                         min_th);
  return static_cast<int>(cudaGetLastError());
}
