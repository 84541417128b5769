// K6: the whole motion-only BA in one launch (replaces
// orb_slam2_tpu/ops/pallas_kernels.py `pose_lm_pallas`, `_pose_lm_kernel`),
// and K7: one normal-equation sweep (replaces `pose_normal_eqs_pallas`,
// `_pose_hbe_kernel`). Both run the sweep of pose_sweep.cuh.
//
// K6 is `Optimizer::PoseOptimization` (src/Optimizer.cc:375-622) as the
// reference schedules it: n_rounds rounds of n_iters Levenberg-Marquardt
// steps, Huber on the first two rounds, and between rounds every valid edge
// reclassified by chi2 (penalty form, z clamped to 1e-9) and depth. Each
// step solves the damped 6x6 system by Cholesky, retracts the pose, and
// accepts it only if the error drops (a NaN from a non-SPD system fails
// err_new < err and is rejected), halving or quadrupling lambda.
//
// Bound: latency. E <= 2048 edges, 44 sweeps of ~200 flops per edge and a
// 28-value block reduction each, with serial 6x6 work between them: one
// persistent CTA of 512 threads holds the whole schedule, so the per-step
// host graph (solve, retract, accept) never exists. Thread 0 does the
// scalar work; the pose reaches the block through shared memory.
#include "pose_sweep.cuh"

namespace {

using pose::kSums;
using pose::kThreads;
using pose::kWarps;

// Damped Cholesky solve of (H + lam diag(H) + 1e-10 I) dx = b, H given as
// its upper triangle (row-major, 21).
__device__ void chol6_solve(const float* Hu, const float* b, float lam, float* dx) {
  float A[6][6], L[6][6], y[6];
  int k = 0;
  for (int i = 0; i < 6; ++i)
    for (int j = i; j < 6; ++j) A[i][j] = A[j][i] = Hu[k++];
  for (int i = 0; i < 6; ++i) A[i][i] = A[i][i] * (1.f + lam) + 1e-10f;
  for (int i = 0; i < 6; ++i) {
    float s = A[i][i];
    for (int k2 = 0; k2 < i; ++k2) s -= L[i][k2] * L[i][k2];
    L[i][i] = sqrtf(s);
    const float inv_d = 1.f / L[i][i];
    for (int j = i + 1; j < 6; ++j) {
      float t = A[j][i];
      for (int k2 = 0; k2 < i; ++k2) t -= L[j][k2] * L[i][k2];
      L[j][i] = t * inv_d;
    }
  }
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
    for (int k2 = 0; k2 < i; ++k2) s -= L[i][k2] * y[k2];
    y[i] = s / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int k2 = i + 1; k2 < 6; ++k2) s -= L[k2][i] * dx[k2];
    dx[i] = s / L[i][i];
  }
}

// Tn = exp(dx) * T on 12 floats (R row-major, t); dx = (rho, phi).
__device__ void retract(const float* T, const float* dx, float* Tn) {
  const float w0 = dx[3], w1 = dx[4], w2 = dx[5];
  const float th2 = w0 * w0 + w1 * w1 + w2 * w2;
  const float th = sqrtf(fmaxf(th2, 0.f));
  const bool small = th2 < 1e-12f;
  const float safe = small ? 1.f : th2;
  const float A = small ? 1.f - th2 / 6.f : sinf(th) / sqrtf(safe);
  const float B = small ? 0.5f - th2 / 24.f : (1.f - cosf(th)) / safe;
  const float C = small ? 1.f / 6.f - th2 / 120.f : (th - sinf(th)) / (safe * sqrtf(safe));
  const float W[3][3] = {{0.f, -w2, w1}, {w2, 0.f, -w0}, {-w1, w0, 0.f}};
  float Re[3][3], V[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const float w2ij = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
      const float eye = i == j ? 1.f : 0.f;
      Re[i][j] = eye + A * W[i][j] + B * w2ij;
      V[i][j] = eye + B * W[i][j] + C * w2ij;
    }
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j)
      Tn[3 * i + j] = Re[i][0] * T[j] + Re[i][1] * T[3 + j] + Re[i][2] * T[6 + j];
    Tn[9 + i] = Re[i][0] * T[9] + Re[i][1] * T[10] + Re[i][2] * T[11] +
                V[i][0] * dx[0] + V[i][1] * dx[1] + V[i][2] * dx[2];
  }
}

__global__ void __launch_bounds__(kThreads)
pose_lm_kernel(const float* __restrict__ par, const float* __restrict__ xw,
               const float* __restrict__ obs, const float* __restrict__ inv_s2,
               const float* __restrict__ stereo, const float* __restrict__ valid,
               int n_edges, int n_rounds, int n_iters, float* __restrict__ pose_out,
               uint8_t* __restrict__ inliers, int* __restrict__ n_inl,
               float* __restrict__ chi2_out) {
  __shared__ float T[12], Tn[12], vec[kSums];
  __shared__ float red[kWarps * kSums];
  __shared__ int count[kWarps];
  const pose::Camera c = pose::load_camera(par);
  const int tid = threadIdx.x;
  if (tid < 12) T[tid] = par[tid];
  // each thread owns edges tid, tid + kThreads, ...: it alone reads and
  // writes their inlier flags, so they need no barrier between phases
  for (int e = tid; e < n_edges; e += kThreads) {
    inliers[e] = valid[e] > 0.f;
    chi2_out[e] = 0.f;
  }
  __syncthreads();

  float H[21], b[6], err = 0.f, lam = 0.f;     // live in thread 0 only
  for (int r = 0; r < n_rounds; ++r) {
    const bool robust = r < 2;
    pose::sweep(T, c, xw, obs, inv_s2, stereo, inliers, n_edges, robust, red, vec);
    if (tid == 0) {
      for (int k = 0; k < 21; ++k) H[k] = vec[k];
      for (int k = 0; k < 6; ++k) b[k] = vec[21 + k];
      err = vec[27];
      lam = 1e-4f;
    }
    for (int it = 0; it < n_iters; ++it) {
      if (tid == 0) {
        float dx[6];
        chol6_solve(H, b, lam, dx);
        retract(T, dx, Tn);
      }
      __syncthreads();
      pose::sweep(Tn, c, xw, obs, inv_s2, stereo, inliers, n_edges, robust, red, vec);
      if (tid == 0) {
        if (vec[27] < err) {                  // false for NaN: rejected
          for (int k = 0; k < 12; ++k) T[k] = Tn[k];
          for (int k = 0; k < 21; ++k) H[k] = vec[k];
          for (int k = 0; k < 6; ++k) b[k] = vec[21 + k];
          err = vec[27];
          lam = fmaxf(lam * 0.5f, 1e-9f);
        } else {
          lam = fminf(lam * 4.f, 1e6f);
        }
      }
      __syncthreads();
    }
    // reclassify every valid edge at the round's pose (penalty-form chi2)
    for (int e = tid; e < n_edges; e += kThreads) {
      const float x = xw[3 * e], y = xw[3 * e + 1], z = xw[3 * e + 2];
      const float pcx = T[0] * x + T[1] * y + T[2] * z + T[9];
      const float pcy = T[3] * x + T[4] * y + T[5] * z + T[10];
      const float pcz = T[6] * x + T[7] * y + T[8] * z + T[11];
      const float invz = 1.f / fmaxf(pcz, 1e-9f);
      const float u = c.fx * pcx * invz + c.cx;
      const float v = c.fy * pcy * invz + c.cy;
      const float ur = u - c.bf * invz;
      const float eu = obs[3 * e] - u, ev = obs[3 * e + 1] - v, eur = obs[3 * e + 2] - ur;
      const float st = stereo[e];
      const float chi2 = inv_s2[e] * (eu * eu + ev * ev + st * eur * eur);
      const float delta2 = st > 0.f ? c.d2_stereo : c.d2_mono;
      inliers[e] = valid[e] > 0.f && chi2 <= delta2 && pcz > 0.f;
      chi2_out[e] = chi2;
    }
    __syncthreads();
  }

  int mine = 0;
  for (int e = tid; e < n_edges; e += kThreads) mine += inliers[e];
  for (int o = 16; o > 0; o >>= 1) mine += __shfl_xor_sync(0xffffffffu, mine, o);
  if ((tid & 31) == 0) count[tid >> 5] = mine;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += count[w];
    *n_inl = total;
  }
  if (tid < 12) pose_out[tid] = T[tid];
}

__global__ void __launch_bounds__(kThreads)
pose_normal_eqs_kernel(const float* __restrict__ par, const float* __restrict__ xw,
                       const float* __restrict__ obs, const float* __restrict__ inv_s2,
                       const float* __restrict__ stereo, const float* __restrict__ mask,
                       int n_edges, int robust, float* __restrict__ out) {
  __shared__ float T[12], vec[kSums];
  __shared__ float red[kWarps * kSums];
  if (threadIdx.x < 12) T[threadIdx.x] = par[threadIdx.x];
  __syncthreads();
  pose::sweep(T, pose::load_camera(par), xw, obs, inv_s2, stereo, mask, n_edges,
              robust != 0, red, vec);
  if (threadIdx.x < kSums) out[threadIdx.x] = vec[threadIdx.x];
}

}  // namespace

extern "C" int orb_pose_lm(const void* par, const void* xw, const void* obs,
                           const void* inv_s2, const void* stereo, const void* valid,
                           int n_edges, int n_rounds, int n_iters, void* pose_out,
                           void* inliers, void* n_inl, void* chi2, void* stream) {
  pose_lm_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(par), static_cast<const float*>(xw),
      static_cast<const float*>(obs), static_cast<const float*>(inv_s2),
      static_cast<const float*>(stereo), static_cast<const float*>(valid), n_edges,
      n_rounds, n_iters, static_cast<float*>(pose_out), static_cast<uint8_t*>(inliers),
      static_cast<int*>(n_inl), static_cast<float*>(chi2));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int orb_pose_normal_eqs(const void* par, const void* xw, const void* obs,
                                   const void* inv_s2, const void* stereo,
                                   const void* mask, int n_edges, int robust, void* out,
                                   void* stream) {
  pose_normal_eqs_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(par), static_cast<const float*>(xw),
      static_cast<const float*>(obs), static_cast<const float*>(inv_s2),
      static_cast<const float*>(stereo), static_cast<const float*>(mask), n_edges, robust,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
