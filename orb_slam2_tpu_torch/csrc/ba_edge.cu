// K9: per-edge terms of the local-BA normal equations (replaces
// orb_slam2_tpu/ops/pallas_kernels.py `ba_edge_terms_pallas`,
// `_ba_edge_kernel`; the linearization of g2o's EdgeSE3ProjectXYZ and
// EdgeStereoSE3ProjectXYZ, src/Optimizer.cc:646-1067).
//
// For each binary pose-point edge e: the residual of the unified (u, v, uR)
// observation, chi2, the Huber weight, the pose and point Jacobians and the
// weighted block products, written as the 64 rows of column e of a (64, E)
// float32 matrix in the reference's row layout (pallas_kernels.BA_ROW_*):
//   0-20 Hcc upper triangle, 21-38 W 6x3 row-major, 39-44 Hpp upper triangle,
//   45-50 bc, 51-53 bp, 54 chi2 * mask, 55 chi2, 56 depth_ok, 57-63 zero.
//
// Traps kept from the reference:
// - chi2 is in penalty form (z clamped to 1e-9: a point pushed behind the
//   camera scores a huge error and LM rejects the step); the Jacobians use
//   the guarded invz (0 behind the camera), so no product overflows and
//   0 * inf never puts a NaN into the sums;
// - row 54 is chi2 * mask without depth_ok (the XLA path's err), while the
//   weight w carries depth_ok; the uR terms carry w * stereo;
// - no edge is skipped and every max() keeps a NaN: a NaN point or pose
//   makes chi2, and so err, NaN, and LM's err_new < err rejects the step.
//
// Precision: float32, each term in the twin's operation order
// (ops/cuda_ba.ba_edge_terms_plain); built with -fmad=false, so nothing is
// contracted into an FMA.
//
// Bound: at E = 4096 points x 12 observations = 49,152 edges the function
// needs per edge 24 bytes of observation, weight and masks and a 4-byte
// camera index in and its 57 rows out (228 bytes), plus each camera's pose
// and each point's position once: ~12.6 MB, ~3.8 us at 3.35 TB/s, above
// ~600 float32 operations per edge (~0.5 us). This kernel moves 340 bytes
// per edge (16.7 MB): its interface repeats the pose (48 bytes) and the
// point (12 bytes) per edge and writes 7 padding rows. Design: one thread
// per edge, row-major (64, E) stores so a warp's 32 stores of one row
// coalesce. Folding the per-camera and per-point reductions into the
// kernel, which removes the output's bytes, is later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;

// par: fx fy cx cy bf, chi2 thresholds mono and stereo
__global__ void __launch_bounds__(kThreads)
ba_edge_kernel(const float* __restrict__ par, const float* __restrict__ T,
               const float* __restrict__ xw, const float* __restrict__ obs,
               const float* __restrict__ inv_s2_in, const float* __restrict__ st_in,
               const float* __restrict__ mask_in, int n, int robust,
               float* __restrict__ out) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  const float fx = par[0], fy = par[1], cx = par[2], cy = par[3], bf = par[4];
  const float d2m = par[5], d2s = par[6];
  float r[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) r[k] = T[static_cast<size_t>(k) * n + e];
  const float x = xw[e], y = xw[n + e], z = xw[2 * static_cast<size_t>(n) + e];
  const float pcx = r[0] * x + r[1] * y + r[2] * z + r[9];
  const float pcy = r[3] * x + r[4] * y + r[5] * z + r[10];
  const float pcz = r[6] * x + r[7] * y + r[8] * z + r[11];

  // penalty-form chi2 (max(pcz, 1e-9) that keeps a NaN)
  const float invz_p = 1.f / (pcz < 1e-9f ? 1e-9f : pcz);
  const float u_p = fx * pcx * invz_p + cx;
  const float v_p = fy * pcy * invz_p + cy;
  const float ur_p = u_p - bf * invz_p;
  const float eu = obs[e] - u_p;
  const float ev = obs[n + e] - v_p;
  const float eur = obs[2 * static_cast<size_t>(n) + e] - ur_p;
  const float st = st_in[e], inv_s2 = inv_s2_in[e], mask = mask_in[e];
  const float chi2 = inv_s2 * (eu * eu + ev * ev + st * eur * eur);
  const float delta2 = d2m + st * (d2s - d2m);
  float w_rob = 1.f;
  if (robust && !(chi2 <= delta2)) w_rob = sqrtf(delta2 / (chi2 < 1e-12f ? 1e-12f : chi2));
  const bool front = pcz > 1e-6f;
  const float depth_ok = front ? 1.f : 0.f;
  const float w = w_rob * inv_s2 * mask * depth_ok;

  // Jacobians: invz guarded to 0 behind the camera
  const float invz = front ? invz_p : 0.f;
  const float invz2 = invz * invz;
  const float a = fx * invz, b = fy * invz;
  const float c = -fx * pcx * invz2, d = -fy * pcy * invz2;
  const float cr = c + bf * invz2;
  const float Ju[6] = {-a, 0.f, -c, -(c * pcy), -(a * pcz - c * pcx), a * pcy};
  const float Jv[6] = {0.f, -b, -d, -(-b * pcz + d * pcy), d * pcx, -b * pcx};
  const float Jr[6] = {-a, 0.f, -cr, -(cr * pcy), -(a * pcz - cr * pcx), a * pcy};
  float Jlu[3], Jlv[3], Jlr[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    Jlu[k] = -(a * r[k] + c * r[6 + k]);
    Jlv[k] = -(b * r[3 + k] + d * r[6 + k]);
    Jlr[k] = -(a * r[k] + cr * r[6 + k]);
  }
  const float wst = w * st;
  float wJu[6], wJv[6], wJr[6], wJlu[3], wJlv[3], wJlr[3];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    wJu[i] = w * Ju[i];
    wJv[i] = w * Jv[i];
    wJr[i] = wst * Jr[i];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    wJlu[k] = w * Jlu[k];
    wJlv[k] = w * Jlv[k];
    wJlr[k] = wst * Jlr[k];
  }

  float* col = out + e;
  int row = 0;
  auto put = [&](float v) { col[static_cast<size_t>(row++) * n] = v; };
#pragma unroll
  for (int i = 0; i < 6; ++i)                 // Hcc upper triangle (21)
#pragma unroll
    for (int j = i; j < 6; ++j) put(wJu[i] * Ju[j] + wJv[i] * Jv[j] + wJr[i] * Jr[j]);
#pragma unroll
  for (int i = 0; i < 6; ++i)                 // W 6x3 row-major (18)
#pragma unroll
    for (int k = 0; k < 3; ++k) put(wJu[i] * Jlu[k] + wJv[i] * Jlv[k] + wJr[i] * Jlr[k]);
#pragma unroll
  for (int i = 0; i < 3; ++i)                 // Hpp upper triangle (6)
#pragma unroll
    for (int j = i; j < 3; ++j) put(wJlu[i] * Jlu[j] + wJlv[i] * Jlv[j] + wJlr[i] * Jlr[j]);
#pragma unroll
  for (int i = 0; i < 6; ++i) put(-(wJu[i] * eu + wJv[i] * ev + wJr[i] * eur));      // bc
#pragma unroll
  for (int k = 0; k < 3; ++k) put(-(wJlu[k] * eu + wJlv[k] * ev + wJlr[k] * eur));   // bp
  put(chi2 * mask);
  put(chi2);
  put(depth_ok);
  while (row < kRows) put(0.f);
}

}  // namespace

extern "C" int orb_ba_edge(const void* par, const void* pose_rows, const void* xw,
                           const void* obs, const void* inv_s2, const void* stereo,
                           const void* mask, int n, int robust, void* out, void* stream) {
  const dim3 grid((n + kThreads - 1) / kThreads);
  ba_edge_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(par), static_cast<const float*>(pose_rows),
      static_cast<const float*>(xw), static_cast<const float*>(obs),
      static_cast<const float*>(inv_s2), static_cast<const float*>(stereo),
      static_cast<const float*>(mask), n, robust, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
