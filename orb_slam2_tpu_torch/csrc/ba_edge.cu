// K9: the whole assembly of the local-BA normal equations in one launch
// (replaces orb_slam2_tpu/ops/pallas_kernels.py `ba_edge_terms_pallas`,
// `_ba_edge_kernel`, with the reductions the reference runs around it in
// `schur_ba._assemble_pallas`; the linearization of g2o's
// EdgeSE3ProjectXYZ and EdgeStereoSE3ProjectXYZ, src/Optimizer.cc:646-1067).
//
// Per binary pose-point edge e: the residual of the unified (u, v, uR)
// observation, chi2, the Huber weight, the pose and point Jacobians and the
// weighted block products (`edge_terms`, the spec `cuda_ba.ba_edge_terms_plain`
// in the same float32 operation order). Out of the launch come every field
// of `schur_ba.Lin`: Hcc (C,6,6) and bc (C,6) summed per camera, Hpp
// (Q,3,3) and bp (Q,3) summed per point, We (Q,O,6,3) per edge, pt_on (Q,),
// err = sum of chi2 * mask, chi2 (Q,O) and depth_ok (Q,O).
//
// Traps kept from the reference:
// - chi2 is in penalty form (z clamped to 1e-9: a point pushed behind the
//   camera scores a huge error and LM rejects the step); the Jacobians use
//   the guarded invz (0 behind the camera), so no product overflows and
//   0 * inf never puts a NaN into the sums;
// - err sums chi2 * mask without depth_ok (the XLA path's err), while the
//   weight w carries depth_ok; the uR terms carry w * stereo;
// - no edge is skipped and every max() keeps a NaN: a NaN point or pose
//   makes chi2, and so err, NaN, and LM's err_new < err rejects the step;
// - a padded edge (camera < 0) takes camera 0's pose for its chi2, We and
//   depth_ok (the caller clamps its index) but joins no camera's sums; a
//   camera with no edge gets exact zeros.
//
// Sums in a fixed order, no float atomics, so a solve repeats bit for bit
// and `cuda_ba.ba_assemble_plain` repeats the kernel bit for bit:
// - point role (blocks 0 .. n_pt_blocks-1): a block holds P_TILE = NT / O
//   points, one thread per edge; each point's O edges are summed in order
//   o = 0..O-1 from 0 (Hpp, bp and the point's share of err), and We goes
//   out through shared memory in coalesced rows;
// - camera role (the next G = ceil(E / K) + C blocks): the edges that join
//   camera c, in edge order (`order`, `cam_start`), are cut into chunks of
//   K; chunk j of camera c is block first(c) + j, first(c) the chunks of the
//   cameras before c (blocks past the last chunk do nothing). Each block
//   finds its camera by a scan of the chunk counts over the cameras, NT at
//   a time, so C has no limit. The block recomputes its edges' terms (~600
//   flops an edge, cheaper than writing 27 floats an edge and reading them
//   back);
//   thread t sums positions t, t + NT, ... in order from 0, then a halving
//   tree over the NT threads (x[u] += x[u + n] for n = NT/2 .. 1) gives the
//   chunk's partial;
// - combine: each chunk block counts its arrival on its camera's integer
//   counter, and the last of the camera's chunks to arrive sums the chunk
//   partials in chunk order from 0 (one thread per entry); a camera with no
//   chunk gets zeros from the camera-role block of its index. Each point
//   block counts its arrival on one more counter, and the last sums err as
//   thread t summing points t, t + NT, ... in order from 0, then the same
//   halving tree. The arrival order does not change the result; each last
//   block sets its counter back to 0 for the next launch on the stream
//   (`launch.counters` keeps a buffer per stream). (One counter for
//   the whole grid, with the last block combining every camera, was ~5 us
//   slower on the H100: serial work in one block, PERF.md.)
//
// Precision: float32, built with -fmad=false, so nothing is contracted into
// an FMA.
//
// Bound: at E = 4096 points x 12 observations = 49,152 edges and C = 64 the
// function moves per edge 28 bytes in (observation, inv_sigma2, stereo,
// mask, camera index) and We, chi2 and depth_ok out (77 bytes), per point
// 12 bytes in and Hpp, bp, pt_on out, per camera its pose in and Hcc, bc
// out: ~5.4 MB, ~1.6 us at 3.35 TB/s, above ~600 float32 operations per
// edge (~0.44 us).
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;             // threads per block, both roles
constexpr int K = 512;              // camera-role chunk (2 edges per thread)
constexpr int kPtVals = 10;         // per edge to the point sums: Hpp 6, bp 3, err
constexpr int kCamVals = 27;        // per edge to the camera sums: Hcc 21, bc 6
constexpr int kWarps = NT / 32;
// shared memory (floats): the point role's We, point values and flags, the
// camera role's tree and, past it, its scan (a total per warp and the hit)
constexpr int kSmem = NT * (18 + kPtVals + 1) > NT * kCamVals + kWarps + 3
                          ? NT * (18 + kPtVals + 1) : NT * kCamVals + kWarps + 3;

__constant__ int kTri6I[21] = {0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 4, 4, 5};
__constant__ int kTri6J[21] = {0, 1, 2, 3, 4, 5, 1, 2, 3, 4, 5, 2, 3, 4, 5, 3, 4, 5, 4, 5, 5};
__constant__ int kTri3I[6] = {0, 0, 0, 1, 1, 2};
__constant__ int kTri3J[6] = {0, 1, 2, 1, 2, 2};

struct Args {
  const float *fx, *fy, *cx, *cy, *bf;   // the camera's 0-d tensors
  float d2m, d2s;                        // chi2 thresholds mono, stereo
  int robust;
  const float* poses;                    // (C,4,4) Tcw
  const float* points;                   // (Q,3)
  const unsigned char* pt_valid;         // (Q,) bool
  const int* cam;                        // (E,) camera index clamped to [0, C)
  const float* obs;                      // (3,E): u, v, uR (-1 mono)
  const float* inv_s2;                   // (E,)
  const float* stereo;                   // (E,) 0/1
  const float* mask;                     // (E,)
  const int* order;                      // camera-major edge list
  const int* cam_start;                  // (C+1,) offsets into order
  int Q, O, C, E, n_pt_blocks, n_blocks;
  float *Hcc, *bc, *Hpp, *bp, *We, *chi2, *err;
  unsigned char *pt_on, *depth_ok;
  float *partial, *err_pt;               // scratch: (G, 27), (Q,)
  unsigned int* counters;                // C + 1 arrival counts, 0 between launches
};

struct Terms {
  float hcc[21], w[18], hpp[6], bc[6], bp[3];
  float err, chi2, depth;
};

// the per-edge terms in the operation order of cuda_ba.ba_edge_terms_plain
__device__ __forceinline__ void edge_terms(const Args& a, int e, Terms& out) {
  const float fx = *a.fx, fy = *a.fy, cx = *a.cx, cy = *a.cy, bf = *a.bf;
  const float* T = a.poses + 16 * a.cam[e];
  float r[12];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) r[3 * i + j] = T[4 * i + j];
    r[9 + i] = T[4 * i + 3];
  }
  const float* X = a.points + 3 * (e / a.O);
  const float x = X[0], y = X[1], z = X[2];
  const float pcx = r[0] * x + r[1] * y + r[2] * z + r[9];
  const float pcy = r[3] * x + r[4] * y + r[5] * z + r[10];
  const float pcz = r[6] * x + r[7] * y + r[8] * z + r[11];

  // penalty-form chi2 (max(pcz, 1e-9) that keeps a NaN)
  const float invz_p = 1.f / (pcz < 1e-9f ? 1e-9f : pcz);
  const float u_p = fx * pcx * invz_p + cx;
  const float v_p = fy * pcy * invz_p + cy;
  const float ur_p = u_p - bf * invz_p;
  const size_t E = a.E;
  const float eu = a.obs[e] - u_p;
  const float ev = a.obs[E + e] - v_p;
  const float eur = a.obs[2 * E + e] - ur_p;
  const float st = a.stereo[e], inv_s2 = a.inv_s2[e], mask = a.mask[e];
  const float chi2 = inv_s2 * (eu * eu + ev * ev + st * eur * eur);
  const float delta2 = a.d2m + st * (a.d2s - a.d2m);
  float w_rob = 1.f;
  if (a.robust && !(chi2 <= delta2)) w_rob = sqrtf(delta2 / (chi2 < 1e-12f ? 1e-12f : chi2));
  const bool front = pcz > 1e-6f;
  const float depth_ok = front ? 1.f : 0.f;
  const float w = w_rob * inv_s2 * mask * depth_ok;

  // Jacobians: invz guarded to 0 behind the camera
  const float invz = front ? invz_p : 0.f;
  const float invz2 = invz * invz;
  const float av = fx * invz, b = fy * invz;
  const float c = -fx * pcx * invz2, d = -fy * pcy * invz2;
  const float cr = c + bf * invz2;
  const float Ju[6] = {-av, 0.f, -c, -(c * pcy), -(av * pcz - c * pcx), av * pcy};
  const float Jv[6] = {0.f, -b, -d, -(-b * pcz + d * pcy), d * pcx, -b * pcx};
  const float Jr[6] = {-av, 0.f, -cr, -(cr * pcy), -(av * pcz - cr * pcx), av * pcy};
  float Jlu[3], Jlv[3], Jlr[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    Jlu[k] = -(av * r[k] + c * r[6 + k]);
    Jlv[k] = -(b * r[3 + k] + d * r[6 + k]);
    Jlr[k] = -(av * r[k] + cr * r[6 + k]);
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
  int n = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)                 // Hcc upper triangle, row-major
#pragma unroll
    for (int j = i; j < 6; ++j) out.hcc[n++] = wJu[i] * Ju[j] + wJv[i] * Jv[j] + wJr[i] * Jr[j];
#pragma unroll
  for (int i = 0; i < 6; ++i)                 // W 6x3 row-major
#pragma unroll
    for (int k = 0; k < 3; ++k)
      out.w[3 * i + k] = wJu[i] * Jlu[k] + wJv[i] * Jlv[k] + wJr[i] * Jlr[k];
  n = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i)                 // Hpp upper triangle
#pragma unroll
    for (int j = i; j < 3; ++j)
      out.hpp[n++] = wJlu[i] * Jlu[j] + wJlv[i] * Jlv[j] + wJlr[i] * Jlr[j];
#pragma unroll
  for (int i = 0; i < 6; ++i) out.bc[i] = -(wJu[i] * eu + wJv[i] * ev + wJr[i] * eur);
#pragma unroll
  for (int k = 0; k < 3; ++k) out.bp[k] = -(wJlu[k] * eu + wJlv[k] * ev + wJlr[k] * eur);
  out.err = chi2 * mask;
  out.chi2 = chi2;
  out.depth = depth_ok;
}

// x[k * NT + u] for k < nv: the halving tree over u, x[u] += x[u + n] for
// n = NT/2 .. 1; the sums end in x[k * NT]
__device__ __forceinline__ void tree(float* x, int nv) {
  for (int n = NT / 2; n > 0; n >>= 1) {
    __syncthreads();
    for (int i = threadIdx.x; i < nv * n; i += NT) {
      const int k = i / n, u = i - k * n;
      x[k * NT + u] = x[k * NT + u] + x[k * NT + u + n];
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void point_role(const Args& a, float* smem) {
  const int tid = threadIdx.x;
  const int O = a.O, p_tile = NT / O;
  const int q0 = blockIdx.x * p_tile;
  const int n_pts = min(p_tile, a.Q - q0);
  const int n_e = n_pts * O;                  // the block's edges: [q0*O, q0*O + n_e)
  float* s_we = smem;                         // (n_e, 18)
  float* s_pt = smem + NT * 18;               // (n_e, kPtVals)
  unsigned char* s_on = reinterpret_cast<unsigned char*>(smem + NT * (18 + kPtVals));
  if (tid < n_e) {
    const int e = q0 * O + tid;
    Terms t;
    edge_terms(a, e, t);
#pragma unroll
    for (int k = 0; k < 18; ++k) s_we[tid * 18 + k] = t.w[k];
#pragma unroll
    for (int k = 0; k < 6; ++k) s_pt[tid * kPtVals + k] = t.hpp[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) s_pt[tid * kPtVals + 6 + k] = t.bp[k];
    s_pt[tid * kPtVals + 9] = t.err;
    s_on[tid] = a.mask[e] > 0.f;
    a.chi2[e] = t.chi2;
    a.depth_ok[e] = t.depth > 0.f;
  }
  __syncthreads();
  float* we = a.We + static_cast<size_t>(q0) * O * 18;
  for (int i = tid; i < n_e * 18; i += NT) we[i] = s_we[i];
  if (tid < n_pts) {
    const int q = q0 + tid;
    float acc[kPtVals];
    bool on = false;
#pragma unroll
    for (int k = 0; k < kPtVals; ++k) acc[k] = 0.f;
    for (int o = 0; o < O; ++o) {
      const float* v = s_pt + (tid * O + o) * kPtVals;
#pragma unroll
      for (int k = 0; k < kPtVals; ++k) acc[k] = acc[k] + v[k];
      on = on || s_on[tid * O + o];
    }
    float* H = a.Hpp + 9 * static_cast<size_t>(q);
#pragma unroll
    for (int k = 0; k < 6; ++k) H[3 * kTri3I[k] + kTri3J[k]] = H[3 * kTri3J[k] + kTri3I[k]] = acc[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) a.bp[3 * q + k] = acc[6 + k];
    a.err_pt[q] = acc[9];
    a.pt_on[q] = a.pt_valid[q] && on;
  }
}

// camera c's chunks: ceil(its edges / K)
__device__ __forceinline__ int n_chunks(const Args& a, int c) {
  return (a.cam_start[c + 1] - a.cam_start[c] + K - 1) / K;
}

// the camera of chunk g, or -1 for a block past the last chunk, with its
// first chunk (the chunks of the cameras before it) in *first: an inclusive
// scan of the chunk counts over cameras c0 .. c0 + NT - 1 (warp shuffles,
// then the warps' totals), for c0 = 0, NT, ... until g falls inside
__device__ __forceinline__ int chunk_camera(const Args& a, int* s, int g, int* first) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* s_warp = s;                            // kWarps totals
  int* s_hit = s + kWarps;                    // camera, first chunk
  if (threadIdx.x == 0) s_hit[0] = -1;
  int base = 0;                               // chunks of the cameras before c0
  for (int c0 = 0; c0 < a.C; c0 += NT) {
    const int c = c0 + threadIdx.x;
    const int n = c < a.C ? n_chunks(a, c) : 0;
    int incl = n;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) incl += s_warp[w];
      total += s_warp[w];
    }
    incl += base;
    if (n > 0 && incl - n <= g && g < incl) {
      s_hit[0] = c;
      s_hit[1] = incl - n;
    }
    base += total;
    __syncthreads();                          // the hit, and s_warp free again
    if (s_hit[0] >= 0 || base > g) break;
  }
  *first = s_hit[1];
  return s_hit[0];
}

__device__ __forceinline__ void camera_role(const Args& a, float* smem, int c, int first, int g) {
  const int pos0 = a.cam_start[c] + (g - first) * K;
  const int pos1 = min(pos0 + K, a.cam_start[c + 1]);
  float acc[kCamVals];
#pragma unroll
  for (int k = 0; k < kCamVals; ++k) acc[k] = 0.f;
#pragma unroll
  for (int i = 0; i < K / NT; ++i) {          // unrolled: both edges' loads in flight
    const int pos = pos0 + threadIdx.x + i * NT;
    if (pos < pos1) {
      Terms t;
      edge_terms(a, a.order[pos], t);
#pragma unroll
      for (int k = 0; k < 21; ++k) acc[k] = acc[k] + t.hcc[k];
#pragma unroll
      for (int k = 0; k < 6; ++k) acc[21 + k] = acc[21 + k] + t.bc[k];
    }
  }
#pragma unroll
  for (int k = 0; k < kCamVals; ++k) smem[k * NT + threadIdx.x] = acc[k];
  tree(smem, kCamVals);
  if (threadIdx.x < kCamVals)
    a.partial[static_cast<size_t>(g) * kCamVals + threadIdx.x] = smem[threadIdx.x * NT];
}

// camera c's Hcc and bc from its n chunk partials from chunk g0 on, summed
// in chunk order from 0 (n = 0: zeros); one thread per entry of the upper
// triangle and of bc
__device__ __forceinline__ void camera_sums(const Args& a, int c, int g0, int n) {
  const int k = threadIdx.x;
  if (k >= kCamVals) return;
  float sum = 0.f;
  for (int g = g0; g < g0 + n; ++g)
    sum = sum + __ldcg(a.partial + static_cast<size_t>(g) * kCamVals + k);
  if (k < 21) {
    float* H = a.Hcc + 36 * c;
    H[6 * kTri6I[k] + kTri6J[k]] = H[6 * kTri6J[k] + kTri6I[k]] = sum;
  } else {
    a.bc[6 * c + k - 21] = sum;
  }
}

// err from the points' shares: thread t sums points t, t + NT, ... in
// order from 0, then the halving tree
__device__ __forceinline__ void err_sum(const Args& a, float* smem) {
  float acc = 0.f;
#pragma unroll 8
  for (int q = threadIdx.x; q < a.Q; q += NT) acc = acc + __ldcg(a.err_pt + q);
  smem[threadIdx.x] = acc;
  tree(smem, 1);
  if (threadIdx.x == 0) *a.err = smem[0];
}

// publish this block's writes and count its arrival on *counter; true in
// the last of `total` blocks to arrive, which sets the counter back to 0
__device__ __forceinline__ bool arrive_last(unsigned int* counter, int total, bool* s_last) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    *s_last = atomicAdd(counter, 1u) == static_cast<unsigned int>(total - 1);
    if (*s_last) *counter = 0u;
  }
  __syncthreads();
  if (*s_last) __threadfence();
  return *s_last;
}

__global__ void __launch_bounds__(NT)
ba_assemble_kernel(const __grid_constant__ Args a) {
  __shared__ float smem[kSmem];
  __shared__ bool s_last;
  if (static_cast<int>(blockIdx.x) < a.n_pt_blocks) {
    point_role(a, smem);
    if (arrive_last(a.counters + a.C, a.n_pt_blocks, &s_last)) err_sum(a, smem);
    return;
  }
  const int g = blockIdx.x - a.n_pt_blocks;
  if (g < a.C && a.cam_start[g] == a.cam_start[g + 1]) camera_sums(a, g, 0, 0);  // no edge
  int first;
  const int c = chunk_camera(a, reinterpret_cast<int*>(smem + NT * kCamVals), g, &first);
  if (c < 0) return;
  camera_role(a, smem, c, first, g);
  const int n = n_chunks(a, c);
  if (arrive_last(a.counters + c, n, &s_last)) camera_sums(a, c, first, n);
}

// cuda_ba.BA_CHUNK and BA_THREADS repeat K and NT for the twin; the GPU
// tests' bit-exact comparisons fail if they part
static_assert(K % NT == 0, "a chunk is whole strides of the block");
static_assert(NT % 32 == 0 && NT / 32 <= 32, "the scan's warp totals");

}  // namespace

// fx fy cx cy bf: 0-d float32 device tensors; poses (C,4,4), points (Q,3),
// pt_valid (Q,) bool, cam (E,) int32 clamped, obs (3,E), inv_s2, stereo,
// mask (E,) float32, order (E,) int32, cam_start (C+1,) int32; E = Q * O,
// 1 <= O <= NT, C >= 1. Outputs as named; partial (ceil(E/K)+C, 27) and
// err_pt (Q,) float32 scratch; counters: C + 1 uint32, 0 at rest, used by
// no launch that may overlap this one.
extern "C" int orb_ba_assemble(const void* fx, const void* fy, const void* cx, const void* cy,
                               const void* bf, float d2m, float d2s, int robust,
                               const void* poses, const void* points, const void* pt_valid,
                               const void* cam, const void* obs, const void* inv_s2,
                               const void* stereo, const void* mask, const void* order,
                               const void* cam_start, int Q, int O, int C, void* Hcc,
                               void* bc, void* Hpp, void* bp, void* We, void* pt_on, void* err, void* chi2, void* depth_ok,
                               void* partial, void* err_pt, void* counters, void* stream) {
  if (Q < 1 || O < 1 || O > NT || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.fx = static_cast<const float*>(fx);
  a.fy = static_cast<const float*>(fy);
  a.cx = static_cast<const float*>(cx);
  a.cy = static_cast<const float*>(cy);
  a.bf = static_cast<const float*>(bf);
  a.d2m = d2m;
  a.d2s = d2s;
  a.robust = robust;
  a.poses = static_cast<const float*>(poses);
  a.points = static_cast<const float*>(points);
  a.pt_valid = static_cast<const unsigned char*>(pt_valid);
  a.cam = static_cast<const int*>(cam);
  a.obs = static_cast<const float*>(obs);
  a.inv_s2 = static_cast<const float*>(inv_s2);
  a.stereo = static_cast<const float*>(stereo);
  a.mask = static_cast<const float*>(mask);
  a.order = static_cast<const int*>(order);
  a.cam_start = static_cast<const int*>(cam_start);
  a.Q = Q;
  a.O = O;
  a.C = C;
  a.E = Q * O;
  const int p_tile = NT / O;
  a.n_pt_blocks = (Q + p_tile - 1) / p_tile;
  a.n_blocks = a.n_pt_blocks + (a.E + K - 1) / K + C;
  a.Hcc = static_cast<float*>(Hcc);
  a.bc = static_cast<float*>(bc);
  a.Hpp = static_cast<float*>(Hpp);
  a.bp = static_cast<float*>(bp);
  a.We = static_cast<float*>(We);
  a.chi2 = static_cast<float*>(chi2);
  a.err = static_cast<float*>(err);
  a.pt_on = static_cast<unsigned char*>(pt_on);
  a.depth_ok = static_cast<unsigned char*>(depth_ok);
  a.partial = static_cast<float*>(partial);
  a.err_pt = static_cast<float*>(err_pt);
  a.counters = static_cast<unsigned int*>(counters);
  ba_assemble_kernel<<<a.n_blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
