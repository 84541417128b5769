// K6: the whole motion-only BA in one launch (replaces
// orb_slam2_tpu/ops/pallas_kernels.py `pose_lm_pallas`, `_pose_lm_kernel`),
// and K7: one normal-equation sweep (replaces `pose_normal_eqs_pallas`,
// `_pose_hbe_kernel`). Both run the per-edge terms of pose_sweep.cuh.
//
// K6 is `Optimizer::PoseOptimization` (src/Optimizer.cc:375-622) as the
// reference schedules it: n_rounds rounds of n_iters Levenberg-Marquardt
// steps, Huber on the first two rounds, and between rounds every valid edge
// reclassified by chi2 (penalty form, z clamped to 1e-9) and depth. Each
// step solves the damped 6x6 system by Cholesky, retracts the pose, and
// accepts it only if the error drops (a NaN from a non-SPD system fails
// err_new < err and is rejected), halving or quadrupling lambda.
//
// Bound: latency. E <= 2048 edges, 44 sweeps of ~250 operations per edge and
// a 28-value reduction each, with serial 6x6 work between them. Design: one
// thread-block cluster of 8 CTAs x 256 threads on 8 SMs, one edge per
// thread, loaded once into registers (an E above 2048 loops over the rest
// from global memory). Per sweep: a warp reduce-scatter, one CTA barrier,
// each CTA's partial written into slot [rank] of every CTA's shared memory
// (distributed shared memory, slots double-buffered by sweep parity so a
// CTA that runs ahead never overwrites a slot still to be read), one
// cluster barrier, the 8 partials summed in rank order, and a second CTA
// barrier to share the sum. Every thread then runs the accept test, the
// Cholesky solve and the retract itself on sums that are equal bit for bit
// everywhere, so no barrier broadcasts a pose. The sums run in a fixed
// order with no atomics: two launches give the same bits. Needs sm_90.
//
// K7 is one such sweep on the same cluster (8 CTAs x 256 threads, edges
// beyond 2048 looped) through the same `cluster_sweep`, with the caller's
// float weight per edge in place of K6's inlier flags: its 28 sums run in
// K6's fixed order, and rank 0 writes H (both triangles), b and err.
#include <cooperative_groups.h>

#include "pose_sweep.cuh"

namespace cg = cooperative_groups;

namespace {

using pose::kSums;

constexpr int kCtas = 8;                          // K6: one cluster of 8 CTAs, on 8 SMs
constexpr int kCtaThreads = 256;                  // one edge per thread at E <= 2048
constexpr int kCtaWarps = kCtaThreads / 32;
constexpr int kEdgesInRegisters = kCtas * kCtaThreads;
constexpr int kPad = 32;                          // the 28 sums padded to a warp
constexpr int kOut = 43;                          // K7's output: H 36, b 6, err 1

// Damped Cholesky solve of (H + lam diag(H) + 1e-10 I) dx = b, H given as
// its upper triangle (row-major, 21). Inlined and unrolled: its arrays are
// registers. Each pivot's reciprocal comes from one rsqrt and multiplies
// every later use, so the critical path holds no IEEE division (the twin
// solves by LU: the two agree to rounding, not bit for bit). A non-SPD
// system gives a NaN pivot and a NaN step, which the accept test rejects.
__device__ __forceinline__ void chol6_solve(const float* Hu, const float* b, float lam,
                                            float* dx) {
  float A[6][6], L[6][6], inv[6], y[6];
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j) A[i][j] = A[j][i] = Hu[k++];
#pragma unroll
  for (int i = 0; i < 6; ++i) A[i][i] = A[i][i] * (1.f + lam) + 1e-10f;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = A[i][i];
#pragma unroll
    for (int k2 = 0; k2 < i; ++k2) s -= L[i][k2] * L[i][k2];
    inv[i] = rsqrtf(s);
#pragma unroll
    for (int j = i + 1; j < 6; ++j) {
      float t = A[j][i];
#pragma unroll
      for (int k2 = 0; k2 < i; ++k2) t -= L[j][k2] * L[i][k2];
      L[j][i] = t * inv[i];
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
#pragma unroll
    for (int k2 = 0; k2 < i; ++k2) s -= L[i][k2] * y[k2];
    y[i] = s * inv[i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k2 = i + 1; k2 < 6; ++k2) s -= L[k2][i] * dx[k2];
    dx[i] = s * inv[i];
  }
}

// Tn = exp(dx) * T on 12 floats (R row-major, t); dx = (rho, phi).
__device__ __forceinline__ void retract(const float* T, const float* dx, float* Tn) {
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

// Warp reduce-scatter: 32 values per lane in, lane k out with the warp's
// sum of value k. Each step halves the values a lane holds: it keeps the half
// its lane bit selects and adds the partner's copy of that half, so 31
// shuffles replace 28 butterflies of 5, in a fixed order.
template <int O>
__device__ __forceinline__ void scatter_step(float* v, bool hi) {
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float keep = hi ? v[i + O] : v[i];
    const float send = hi ? v[i] : v[i + O];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

__device__ __forceinline__ float warp_scatter_sum(float* v, int lane) {
  scatter_step<16>(v, lane & 16);
  scatter_step<8>(v, lane & 8);
  scatter_step<4>(v, lane & 4);
  scatter_step<2>(v, lane & 2);
  scatter_step<1>(v, lane & 1);
  return v[0];
}

struct LmShared {
  float red[kCtaWarps * kSums];        // the warps' sums of this CTA
  float slot[2][kCtas * kSums];        // every CTA's partial, by sweep parity
  __align__(16) float vec[kPad];       // the cluster's sums of this sweep
  int count[kCtaWarps];
  int cluster_count[kCtas];            // rank 0 only: each CTA's inliers
};

// One sweep over the cluster's edges at pose P (registers, the same in every
// thread of the cluster): out = [H upper triangle, b, err], equal bit for
// bit in every thread. A thread's first edge eg, with its mask m_g, is in
// registers; edges beyond the cluster's width are read from global memory
// with their mask (K6: its 0/1 inlier bytes; K7: the caller's float
// weights). robust applies the Huber weights.
template <typename MaskT>
__device__ __forceinline__ void cluster_sweep(
    cg::cluster_group& cluster, LmShared& sh, int& parity, const float* P,
    const pose::Camera& c, bool mine, const pose::Edge& eg, float m_g, int g,
    const float* __restrict__ xw, const float* __restrict__ obs,
    const float* __restrict__ inv_s2, const uint8_t* __restrict__ stereo,
    const MaskT* mask, int n_edges, bool robust, float out[kSums]) {
  const int tid = threadIdx.x, lane = tid & 31, rank = static_cast<int>(cluster.block_rank());
  float acc[kPad];
#pragma unroll
  for (int k = 0; k < kPad; ++k) acc[k] = 0.f;
  if (mine) pose::edge_terms(P, c, eg, m_g, robust, acc);
  for (int e = g + kEdgesInRegisters; e < n_edges; e += kEdgesInRegisters)
    pose::edge_terms(P, c, pose::load_edge(xw, obs, inv_s2, stereo, e),
                     static_cast<float>(mask[e]), robust, acc);
  const float wsum = warp_scatter_sum(acc, lane);
  if (lane < kSums) sh.red[(tid >> 5) * kSums + lane] = wsum;
  __syncthreads();
  // the CTA's partial of value k, written into slot [rank] of CTA dst
  if (tid < kCtas * kSums) {
    const int dst = tid / kSums, k = tid - dst * kSums;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kCtaWarps; ++w) s += sh.red[w * kSums + k];
    *cluster.map_shared_rank(&sh.slot[parity][rank * kSums + k], dst) = s;
  }
  cluster.sync();
  if (tid < kSums) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < kCtas; ++r) s += sh.slot[parity][r * kSums + tid];
    sh.vec[tid] = s;
  }
  parity ^= 1;
  __syncthreads();
  const float4* v4 = reinterpret_cast<const float4*>(sh.vec);
#pragma unroll
  for (int q = 0; q < kSums / 4; ++q) {
    const float4 t = v4[q];
    out[4 * q] = t.x, out[4 * q + 1] = t.y, out[4 * q + 2] = t.z, out[4 * q + 3] = t.w;
  }
}

// An edge reclassified at pose T (penalty-form chi2, z clamped to 1e-9).
__device__ __forceinline__ bool classify(const float* T, const pose::Camera& c,
                                         const pose::Edge& g, bool valid, float& chi2) {
  const float pcx = T[0] * g.x + T[1] * g.y + T[2] * g.z + T[9];
  const float pcy = T[3] * g.x + T[4] * g.y + T[5] * g.z + T[10];
  const float pcz = T[6] * g.x + T[7] * g.y + T[8] * g.z + T[11];
  const float invz = 1.f / fmaxf(pcz, 1e-9f);
  const float u = c.fx * pcx * invz + c.cx;
  const float v = c.fy * pcy * invz + c.cy;
  const float ur = u - c.bf * invz;
  const float eu = g.ou - u, ev = g.ov - v, eur = g.our - ur;
  chi2 = g.inv_s2 * (eu * eu + ev * ev + g.st * eur * eur);
  const float delta2 = g.st > 0.f ? c.d2_stereo : c.d2_mono;
  return valid && chi2 <= delta2 && pcz > 0.f;
}

__global__ void __cluster_dims__(kCtas, 1, 1) __launch_bounds__(kCtaThreads, 1)
pose_lm_kernel(pose::Params par, const float* __restrict__ xw,
               const float* __restrict__ obs, const float* __restrict__ inv_s2,
               const uint8_t* __restrict__ stereo, const uint8_t* __restrict__ valid,
               int n_edges, int n_rounds, int n_iters, float* __restrict__ pose_out,
               uint8_t* __restrict__ inliers, int* __restrict__ n_inl,
               float* __restrict__ chi2_out) {
  __shared__ LmShared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int g = rank * kCtaThreads + tid;            // this thread's first edge
  const pose::Camera c = pose::load_camera(par);
  float T[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) T[k] = pose::pose_entry(par.Tcw, k);
  // each thread owns edges g, g + 2048, ...: it alone reads and writes their
  // inlier flags, so they need no barrier between phases
  const bool mine = g < n_edges;
  const pose::Edge eg = mine ? pose::load_edge(xw, obs, inv_s2, stereo, g) : pose::Edge{};
  const bool valid_g = mine && valid[g];
  bool inl_g = valid_g;
  float chi2_g = 0.f;
  for (int e = g + kEdgesInRegisters; e < n_edges; e += kEdgesInRegisters) {
    inliers[e] = valid[e] != 0;
    chi2_out[e] = 0.f;
  }
  int parity = 0;
  cluster.sync();             // every CTA runs before any writes into its shared memory

  float cur[kSums], vec[kSums], Tn[12];
  for (int r = 0; r < n_rounds; ++r) {
    const bool robust = r < 2;
    cluster_sweep(cluster, sh, parity, T, c, mine, eg, inl_g ? 1.f : 0.f, g, xw, obs, inv_s2,
                  stereo, inliers, n_edges, robust, cur);
    float lam = 1e-4f;
    for (int it = 0; it < n_iters; ++it) {
      // every thread solves: the same code on the same sums gives the same
      // pose in every thread of the cluster, with no broadcast
      float dx[6];
      chol6_solve(cur, cur + 21, lam, dx);
      retract(T, dx, Tn);
      cluster_sweep(cluster, sh, parity, Tn, c, mine, eg, inl_g ? 1.f : 0.f, g, xw, obs,
                    inv_s2, stereo, inliers, n_edges, robust, vec);
      if (vec[27] < cur[27]) {                // false for NaN: rejected
#pragma unroll
        for (int k = 0; k < 12; ++k) T[k] = Tn[k];
#pragma unroll
        for (int k = 0; k < kSums; ++k) cur[k] = vec[k];
        lam = fmaxf(lam * 0.5f, 1e-9f);
      } else {
        lam = fminf(lam * 4.f, 1e6f);
      }
    }
    // reclassify every valid edge at the round's pose
    if (mine) inl_g = classify(T, c, eg, valid_g, chi2_g);
    for (int e = g + kEdgesInRegisters; e < n_edges; e += kEdgesInRegisters) {
      float chi2;
      inliers[e] = classify(T, c, pose::load_edge(xw, obs, inv_s2, stereo, e),
                            valid[e] != 0, chi2);
      chi2_out[e] = chi2;
    }
  }

  int own = inl_g;
  if (mine) {
    inliers[g] = inl_g;
    chi2_out[g] = chi2_g;
  }
  for (int e = g + kEdgesInRegisters; e < n_edges; e += kEdgesInRegisters) own += inliers[e];
  own = __reduce_add_sync(0xffffffffu, own);
  if ((tid & 31) == 0) sh.count[tid >> 5] = own;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < kCtaWarps; ++w) total += sh.count[w];
    *cluster.map_shared_rank(&sh.cluster_count[rank], 0) = total;
  }
  cluster.sync();             // also: no CTA exits while another writes into it
  if (rank == 0 && tid == 0) {
    int total = 0;
    for (int r2 = 0; r2 < kCtas; ++r2) total += sh.cluster_count[r2];
    *n_inl = total;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      pose_out[4 * i] = T[3 * i], pose_out[4 * i + 1] = T[3 * i + 1];
      pose_out[4 * i + 2] = T[3 * i + 2], pose_out[4 * i + 3] = T[9 + i];
    }
    pose_out[12] = pose_out[13] = pose_out[14] = 0.f;
    pose_out[15] = 1.f;
  }
}

// K7: one sweep at Tcw with a float weight per edge, on the same cluster
// and through the same cluster_sweep as K6's, so its sums run in K6's order.
__global__ void __cluster_dims__(kCtas, 1, 1) __launch_bounds__(kCtaThreads, 1)
pose_normal_eqs_kernel(pose::Params par, const float* __restrict__ xw,
                       const float* __restrict__ obs, const float* __restrict__ inv_s2,
                       const uint8_t* __restrict__ stereo, const float* __restrict__ mask,
                       int n_edges, int robust, float* __restrict__ out) {
  __shared__ LmShared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int g = rank * kCtaThreads + threadIdx.x;
  float T[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) T[k] = pose::pose_entry(par.Tcw, k);
  const bool mine = g < n_edges;
  const pose::Edge eg = mine ? pose::load_edge(xw, obs, inv_s2, stereo, g) : pose::Edge{};
  const float m_g = mine ? mask[g] : 0.f;
  int parity = 0;
  cluster.sync();             // every CTA runs before any writes into its shared memory
  float vec[kSums];
  // after its cluster barrier no CTA touches another's shared memory, so
  // the CTAs may exit in any order
  cluster_sweep(cluster, sh, parity, T, pose::load_camera(par), mine, eg, m_g, g, xw, obs,
                inv_s2, stereo, mask, n_edges, robust != 0, vec);
  // out = [H (6x6 row-major, both triangles from the upper), b, err]: the
  // wrapper returns views, no gather after the launch
  const int t = threadIdx.x;
  if (rank == 0 && t < kOut) {
    const int i = min(t / 6, t % 6), j = max(t / 6, t % 6);
    out[t] = t < 36 ? vec[i * 6 - i * (i - 1) / 2 + j - i] : vec[t - 15];
  }
}

}  // namespace

extern "C" int orb_pose_lm(const void* Tcw, const void* fx, const void* fy, const void* cx,
                           const void* cy, const void* bf, float d2_mono, float d2_stereo,
                           const void* xw, const void* obs, const void* inv_s2,
                           const void* stereo, const void* valid, int n_edges, int n_rounds,
                           int n_iters, void* pose_out, void* inliers, void* n_inl, void* chi2,
                           void* stream) {
  const pose::Params par{static_cast<const float*>(Tcw), static_cast<const float*>(fx),
                         static_cast<const float*>(fy), static_cast<const float*>(cx),
                         static_cast<const float*>(cy), static_cast<const float*>(bf),
                         d2_mono, d2_stereo};
  pose_lm_kernel<<<kCtas, kCtaThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      par, static_cast<const float*>(xw), static_cast<const float*>(obs),
      static_cast<const float*>(inv_s2), static_cast<const uint8_t*>(stereo),
      static_cast<const uint8_t*>(valid), n_edges, n_rounds, n_iters,
      static_cast<float*>(pose_out), static_cast<uint8_t*>(inliers), static_cast<int*>(n_inl),
      static_cast<float*>(chi2));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int orb_pose_normal_eqs(const void* Tcw, const void* fx, const void* fy,
                                   const void* cx, const void* cy, const void* bf,
                                   float d2_mono, float d2_stereo, const void* xw,
                                   const void* obs, const void* inv_s2, const void* stereo,
                                   const void* mask, int n_edges, int robust, void* out,
                                   void* stream) {
  const pose::Params par{static_cast<const float*>(Tcw), static_cast<const float*>(fx),
                         static_cast<const float*>(fy), static_cast<const float*>(cx),
                         static_cast<const float*>(cy), static_cast<const float*>(bf),
                         d2_mono, d2_stereo};
  pose_normal_eqs_kernel<<<kCtas, kCtaThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      par, static_cast<const float*>(xw), static_cast<const float*>(obs),
      static_cast<const float*>(inv_s2), static_cast<const uint8_t*>(stereo),
      static_cast<const float*>(mask), n_edges, robust, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
