// The per-edge terms of the motion-only BA sweep shared by K6 (pose_lm.cu,
// `orb_pose_lm`) and K7 (pose_lm.cu, `orb_pose_normal_eqs`): one
// linearization of an edge at a pose (`edge_terms`), which both kernels
// reduce to the 6x6 normal equations over one cluster through pose_lm.cu's
// `cluster_sweep`.
//
// It is the per-edge body of orb_slam2_tpu/ops/pallas_kernels.py
// `_pose_sweep` / `_pose_hbe_kernel` (= solvers/pose_opt.py
// `_build_normal_eqs`): residuals of the unified (u, v, uR) edge, pose
// Jacobians for the left-multiplicative update xi = (rho, phi), Huber weights
// on robust rounds, and the sums H (upper triangle, 21), b (6) and err.
//
// Traps kept from the reference:
// - behind the camera (z <= 1e-6) invz is 0, not 1/1e-9, so no Jacobian
//   product overflows to inf and 0 * inf never puts a NaN into H;
// - an edge masked out or behind the camera still adds chi2 * 0, and its
//   products unless they are all exactly 0, so a NaN in any edge (a NaN
//   pose from a non-SPD solve, above all) makes err NaN, as 0 * NaN does in
//   the reference, and K6's accept test rejects the step.
//
// Precision: float32 throughout, per edge in exactly the twin's operation
// order (`pose_opt.normal_eq_terms`; pose_lm.cu is built with -fmad=false,
// so nothing is contracted into an FMA), so the kernels and their twins
// differ only in the order of the float32 sums over the edges.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace pose {

constexpr int kSums = 28;                // H upper triangle 21, b 6, err 1

struct Camera {
  float fx, fy, cx, cy, bf, d2_mono, d2_stereo;
};

// The pose and camera as the wrappers hand them over, with no packing on
// the card: Tcw (4x4 row-major) and fx fy cx cy bf (0-d tensors) in device
// memory, the chi2 thresholds mono and stereo by value.
struct Params {
  const float *Tcw, *fx, *fy, *cx, *cy, *bf;
  float d2_mono, d2_stereo;
};

__device__ __forceinline__ Camera load_camera(const Params& p) {
  return Camera{*p.fx, *p.fy, *p.cx, *p.cy, *p.bf, p.d2_mono, p.d2_stereo};
}

// Entry k of the 12-float pose (R row-major, then t) from a 4x4 Tcw.
__device__ __forceinline__ float pose_entry(const float* __restrict__ Tcw, int k) {
  return k < 9 ? Tcw[4 * (k / 3) + k % 3] : Tcw[4 * (k - 9) + 3];
}

// One edge's inputs: the world point, the observation (u, v, uR), its
// inverse sigma^2 and its stereo flag (1 or 0; a bool byte in memory).
struct Edge {
  float x, y, z, ou, ov, our, inv_s2, st;
};

__device__ __forceinline__ Edge load_edge(const float* __restrict__ xw,
                                          const float* __restrict__ obs,
                                          const float* __restrict__ inv_s2,
                                          const uint8_t* __restrict__ stereo, int e) {
  return Edge{xw[3 * e], xw[3 * e + 1], xw[3 * e + 2], obs[3 * e], obs[3 * e + 1],
              obs[3 * e + 2], inv_s2[e], stereo[e] ? 1.f : 0.f};
}

// Accumulate one edge's terms into acc at pose T (12 floats: R row-major, t).
__device__ __forceinline__ void edge_terms(const float* T, const Camera& c, const Edge& g,
                                           float mask, bool robust, float acc[kSums]) {
  const float x = g.x, y = g.y, z = g.z, inv_s2 = g.inv_s2, st = g.st;
  const float pcx = T[0] * x + T[1] * y + T[2] * z + T[9];
  const float pcy = T[3] * x + T[4] * y + T[5] * z + T[10];
  const float pcz = T[6] * x + T[7] * y + T[8] * z + T[11];
  const bool depth_ok = pcz > 1e-6f;                 // false for NaN
  const float invz = depth_ok ? 1.f / fmaxf(pcz, 1e-9f) : 0.f;
  const float invz2 = invz * invz;
  const float u = c.fx * pcx * invz + c.cx;
  const float v = c.fy * pcy * invz + c.cy;
  const float ur = u - c.bf * invz;
  const float eu = g.ou - u, ev = g.ov - v, eur = g.our - ur;
  const float chi2 = inv_s2 * (eu * eu + ev * ev + st * eur * eur);
  const float delta2 = st > 0.f ? c.d2_stereo : c.d2_mono;
  float w_rob = 1.f;
  // max(chi2, 1e-12) that keeps a NaN, as the reference's does (fmaxf drops it)
  if (robust && !(chi2 <= delta2)) w_rob = sqrtf(delta2 / (chi2 < 1e-12f ? 1e-12f : chi2));
  const float m = mask * (depth_ok ? 1.f : 0.f);
  const float w = w_rob * inv_s2 * m;

  const float a = c.fx * invz, b = c.fy * invz;
  const float cu = -c.fx * pcx * invz2, d = -c.fy * pcy * invz2;
  const float cr = cu + c.bf * invz2;
  const float Ju[6] = {-a, 0.f, -cu, -(cu * pcy), -(a * pcz - cu * pcx), a * pcy};
  const float Jv[6] = {0.f, -b, -d, -(-b * pcz + d * pcy), d * pcx, -b * pcx};
  const float Jr[6] = {-a, 0.f, -cr, -(cr * pcy), -(a * pcz - cr * pcx), a * pcy};
  acc[27] += chi2 * m;
  // weight 0 and every factor finite: each product below is +-0 and leaves
  // the sums as they are, so skip them (most edges of a frame are unmatched)
  float mag = fabsf(eu) + fabsf(ev) + fabsf(eur);
#pragma unroll
  for (int i = 0; i < 6; ++i) mag += fabsf(Ju[i]) + fabsf(Jv[i]) + fabsf(Jr[i]);
  if (w == 0.f && isfinite(mag)) return;
  const float wst = w * st;
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    // the weight multiplies each factor before any Jacobian product forms
    const float wu = w * Ju[i], wv = w * Jv[i], wr = wst * Jr[i];
#pragma unroll
    for (int j = i; j < 6; ++j) acc[k++] += wu * Ju[j] + wv * Jv[j] + wr * Jr[j];
    acc[21 + i] -= wu * eu + wv * ev + wr * eur;
  }
}

}  // namespace pose
